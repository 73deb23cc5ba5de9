# copied from mxnet_tpu/test_utils.py (backend-free)
"""Testing utilities (reference: python/mxnet/test_utils.py, 905 LoC).

The reference's core oracles, reproduced:
  * ``check_numeric_gradient`` — central finite differences vs the executor's
    backward (reference test_utils.py check_numeric_gradient).
  * ``check_symbolic_forward`` / ``check_symbolic_backward`` — outputs/grads
    vs expected numpy arrays.
  * ``check_consistency`` — same graph at different dtypes (the reference
    compared cpu-vs-gpu; the JAX package, with one XLA backend, compares
    fp32 against bf16, and so does this copy).
"""
from __future__ import annotations

import numpy as np

from .context import cpu, current_context
from .ndarray import array, zeros

__all__ = [
    "default_context",
    "same",
    "reldiff",
    "assert_almost_equal",
    "rand_ndarray",
    "random_arrays",
    "numeric_grad",
    "check_numeric_gradient",
    "check_symbolic_forward",
    "check_symbolic_backward",
    "check_consistency",
]

_rng = np.random.RandomState(1234)


def default_context():
    return current_context()


def same(a, b):
    return np.array_equal(a, b)


def reldiff(a, b):
    diff = np.sum(np.abs(a - b))
    norm = np.sum(np.abs(a)) + np.sum(np.abs(b))
    if diff == 0:
        return 0
    return diff / norm


def assert_almost_equal(a, b, threshold=None, rtol=1e-5, atol=1e-20, names=("a", "b")):
    if threshold is not None:
        rd = reldiff(np.asarray(a), np.asarray(b))
        if rd > threshold:
            raise AssertionError("reldiff %g > %g between %s and %s" % (rd, threshold, *names))
        return
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def rand_ndarray(shape, dtype=np.float32, scale=1.0):
    return array(_rng.uniform(-scale, scale, shape).astype(dtype))


def random_arrays(*shapes):
    arrays = [_rng.randn(*s).astype(np.float32) for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def _as_location(sym, location):
    names = sym.list_arguments()
    if isinstance(location, dict):
        return {k: (v if isinstance(v, np.ndarray) else np.asarray(v)) for k, v in location.items()}
    return {n: (v if isinstance(v, np.ndarray) else np.asarray(v)) for n, v in zip(names, location)}


def _bind(sym, location, aux_states=None, grad_req="write", ctx=None):
    from . import executor

    ctx = ctx or current_context()
    args = {k: array(v) for k, v in location.items()}
    grads = {k: zeros(v.shape, dtype=np.asarray(v).dtype) for k, v in location.items()
             if grad_req != "null" and np.issubdtype(np.asarray(v).dtype, np.floating)}
    auxs = {k: array(v) for k, v in (aux_states or {}).items()}
    return executor.bind(sym, ctx, args, args_grad=grads or None,
                         grad_req=grad_req if grads else "null", aux_states=auxs)


def numeric_grad(executor, location, aux_states=None, eps=1e-4, use_forward_train=True):
    """Central finite differences over the executor's forward (reference:
    test_utils.py numeric_grad)."""
    approx_grads = {}
    for name, arr in location.items():
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        grad = np.zeros_like(arr, dtype=np.float64)
        flat = arr.reshape(-1)
        gflat = grad.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            executor.arg_dict[name][:] = arr
            fp = sum(o.asnumpy().astype(np.float64).sum()
                     for o in executor.forward(is_train=use_forward_train))
            flat[i] = orig - eps
            executor.arg_dict[name][:] = arr
            fm = sum(o.asnumpy().astype(np.float64).sum()
                     for o in executor.forward(is_train=use_forward_train))
            flat[i] = orig
            executor.arg_dict[name][:] = arr
            gflat[i] = (fp - fm) / (2 * eps)
        approx_grads[name] = grad.astype(arr.dtype)
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           check_eps=1e-2, grad_nodes=None, ctx=None):
    """Verify the executor's backward against finite differences
    (reference: test_utils.py check_numeric_gradient). The implicit head
    gradient is ones (total-sum objective)."""
    location = _as_location(sym, location)
    aux_states = {k: np.asarray(v) for k, v in (aux_states or {}).items()}
    exe = _bind(sym, location, aux_states, ctx=ctx)
    exe.forward(is_train=True)
    ones = [array(np.ones(o.shape, dtype="float32")) for o in exe.outputs]
    exe.backward(ones)
    symbolic = {k: (g.asnumpy() if g is not None else None)
                for k, g in exe.grad_dict.items()}

    fd_exe = _bind(sym, location, aux_states, grad_req="null", ctx=ctx)
    approx = numeric_grad(fd_exe, location, aux_states, eps=numeric_eps)

    names = grad_nodes if grad_nodes is not None else list(approx.keys())
    for name in names:
        if name not in approx or symbolic.get(name) is None:
            continue
        rd = reldiff(approx[name], symbolic[name])
        if rd > check_eps:
            raise AssertionError(
                "numeric gradient check failed for %r: reldiff %g > %g\nnumeric:\n%s\nsymbolic:\n%s"
                % (name, rd, check_eps, approx[name], symbolic[name]))


def check_symbolic_forward(sym, location, expected, check_eps=1e-4,
                           aux_states=None, ctx=None, is_train=False):
    """(reference: test_utils.py check_symbolic_forward)"""
    location = _as_location(sym, location)
    exe = _bind(sym, location, {k: np.asarray(v) for k, v in (aux_states or {}).items()},
                grad_req="null", ctx=ctx)
    outputs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
    if isinstance(expected, dict):
        expected = [expected[n] for n in sym.list_outputs()]
    for out, exp in zip(outputs, expected):
        if reldiff(out, np.asarray(exp)) > check_eps:
            raise AssertionError("forward check failed: reldiff %g > %g"
                                 % (reldiff(out, np.asarray(exp)), check_eps))
    return outputs


def check_symbolic_backward(sym, location, out_grads, expected, check_eps=1e-4,
                            aux_states=None, grad_req="write", ctx=None):
    """(reference: test_utils.py check_symbolic_backward)"""
    location = _as_location(sym, location)
    exe = _bind(sym, location, {k: np.asarray(v) for k, v in (aux_states or {}).items()},
                grad_req=grad_req, ctx=ctx)
    exe.forward(is_train=True)
    exe.backward([array(np.asarray(g)) for g in out_grads])
    grads = {k: (g.asnumpy() if g is not None else None) for k, g in exe.grad_dict.items()}
    if not isinstance(expected, dict):
        expected = dict(zip(sym.list_arguments(), expected))
    for name, exp in expected.items():
        if exp is None:
            continue
        rd = reldiff(grads[name], np.asarray(exp))
        if rd > check_eps:
            raise AssertionError("backward check failed for %r: reldiff %g > %g"
                                 % (name, rd, check_eps))
    return grads


def check_consistency(sym, location, dtypes=("float32", "bfloat16"),
                      tol=None, aux_states=None, ctx=None):
    """Run the same graph at several dtypes and compare (the reference's
    cpu-vs-gpu check_consistency re-aimed at the fp32-vs-bf16 axis)."""
    from .base import np_dtype

    tol = tol or {"float32": 1e-5, "float16": 1e-2, "bfloat16": 5e-2}
    location = _as_location(sym, location)
    baseline = None
    for dt in dtypes:
        cast_loc = {k: v.astype(np_dtype(dt)) if np.issubdtype(v.dtype, np.floating) else v
                    for k, v in location.items()}
        exe = _bind(sym, cast_loc,
                    {k: np.asarray(v) for k, v in (aux_states or {}).items()},
                    grad_req="null", ctx=ctx)
        outs = [np.asarray(o.asnumpy(), dtype=np.float64) for o in exe.forward(is_train=False)]
        if baseline is None:
            baseline = outs
        else:
            t = tol[dt] if isinstance(tol, dict) else tol
            for b, o in zip(baseline, outs):
                rd = reldiff(b, o)
                if rd > t:
                    raise AssertionError("consistency failed at dtype %s: reldiff %g > %g"
                                         % (dt, rd, t))
    return baseline
