"""The port's imperative NDArray against ``mxnet_tpu.nd``: creation, views
that write through and follow a ``_set_tensor`` swap, every operator and
method, the generated ``nd.<op>`` functions, and ``save``/``load`` in the
reference's ``.params`` layout in both directions. Inputs come from numpy
seeds and go to both packages; comparisons are exact (0/1 results), the rest
within rtol 1e-6 (float32 on both sides, elementwise or short sums)."""
import operator
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

CPU = pt.cpu()
RTOL = 1e-6


def _r(*shape, seed=0):
    return np.random.RandomState(seed + sum(shape)).randn(*shape).astype(np.float32)


def _q(*shape, seed=0):
    """Values on a grid of quarters, so that equal pairs occur."""
    return (np.round(_r(*shape, seed=seed) * 4) / 4).astype(np.float32)


def _both(x):
    return mx.nd.array(x), pt.nd.array(x, ctx=CPU)


def _same(got, want, exact=False):
    got, want = got.asnumpy(), want.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


# ------------------------------------------------------------------ creation
@pytest.mark.parametrize("make", [
    lambda nd, kw: nd.zeros((2, 3), **kw), lambda nd, kw: nd.zeros(4, **kw),
    lambda nd, kw: nd.ones((2, 3), dtype="int32", **kw), lambda nd, kw: nd.full((3,), 2.5, **kw),
    lambda nd, kw: nd.empty((2, 2), **kw) * 0, lambda nd, kw: nd.arange(5, **kw),
    lambda nd, kw: nd.arange(1, 7, 1.5, repeat=2, **kw),
    lambda nd, kw: nd.array([[1, 2], [3, 4]], **kw),
    lambda nd, kw: nd.array(np.arange(6, dtype=np.int32).reshape(2, 3), **kw),
    lambda nd, kw: nd.array(np.arange(3, dtype=np.float64), **kw),  # float64 -> float32
    lambda nd, kw: nd.array(nd.ones((2,), **kw), **kw),
    lambda nd, kw: nd.concatenate([nd.ones((2, 3), **kw), nd.zeros((1, 3), **kw)]),
    lambda nd, kw: nd.concatenate([nd.ones((2, 1), **kw), nd.zeros((2, 2), **kw)], axis=1),
    lambda nd, kw: nd.onehot_encode(nd.array([2, 0, 1], **kw), nd.zeros((3, 4), **kw)),
], ids=["zeros", "zeros_int_shape", "ones_int32", "full", "empty", "arange", "arange_repeat",
        "array_list", "array_int32", "array_float64", "array_of_ndarray", "concatenate",
        "concatenate_axis1", "onehot_encode"])
def test_creation_matches_the_reference(make):
    _same(make(pt.nd, {"ctx": CPU}), make(mx.nd, {}), exact=True)


def test_properties_and_conversion():
    x = _r(3, 4)
    j, p = _both(x)
    assert (p.shape, p.ndim, p.size, p.dtype, len(p)) == (j.shape, j.ndim, j.size, j.dtype, len(j))
    assert p.context == CPU and p.ctx == CPU and repr(p) == "<NDArray 3x4 @cpu(0)>"
    assert p.astype("int32").dtype == np.int32
    _same(p.astype("int32"), j.astype("int32"), exact=True)
    assert pt.nd.array([2.5], ctx=CPU).asscalar() == 2.5
    with pytest.raises(pt.MXNetError, match="not a scalar"):
        p.asscalar()
    with pytest.raises(TypeError):
        len(pt.nd.NDArray(torch.tensor(1.0), CPU))
    host = p.asnumpy()
    host[:] = 0  # asnumpy is a copy
    np.testing.assert_array_equal(p.asnumpy(), x)
    p.wait_to_read()
    pt.nd.waitall()


def test_hash_is_identity_because_eq_is_elementwise():
    a, b = pt.nd.ones((2,), ctx=CPU), pt.nd.ones((2,), ctx=CPU)
    assert isinstance(a == b, pt.nd.NDArray)
    assert hash(a) != hash(b) and len({a: 1, b: 2}) == 2 and {a: 1}[a] == 1


# --------------------------------------------------------------------- views
def test_views_write_through_like_the_reference():
    def drive(nd, a):
        a[1:3] = 7.0                          # slice view, scalar fill
        a[0] = np.arange(4, dtype=np.float32)  # row view, numpy
        v = a[2:4]
        v[1] = a[0]                           # a view of a view, from an NDArray
        r = a.reshape((2, 2, 4))
        r[1] = 5.0                            # a reshape view writes through too
        a[-1][:] = -1.0
        a[0, 1:3] = 9.0                       # multi-axis assignment
        w = a.slice(1, 3).reshape((8,))
        w[:] = w + 1.0
        return a, v, r, w

    for got, want in zip(drive(pt.nd, pt.nd.zeros((4, 4), ctx=CPU)),
                         drive(mx.nd, mx.nd.zeros((4, 4)))):
        _same(got, want, exact=True)


def test_views_follow_a_set_tensor_swap():
    a = pt.nd.array(_r(4, 3), ctx=CPU)
    row, tail, flat = a[1], a[2:], a.reshape((12,))
    new = torch.from_numpy(_r(4, 3, seed=1))
    a._set_tensor(new)  # the swap KVCacheDecoder makes: no copy
    assert a._tensor() is new
    np.testing.assert_array_equal(row.asnumpy(), new[1].numpy())
    np.testing.assert_array_equal(tail.asnumpy(), new[2:].numpy())
    np.testing.assert_array_equal(flat.asnumpy(), new.reshape(12).numpy())
    tail[:] = 0.0  # and a write through a view lands in the swapped-in tensor
    assert float(new[2:].abs().sum()) == 0.0
    row._set_tensor(torch.ones(3))  # a view copies into its part
    np.testing.assert_array_equal(a.asnumpy()[1], np.ones(3, np.float32))
    with pytest.raises(pt.MXNetError, match="cannot replace"):
        a._set_tensor(torch.zeros(3, 4))
    with pytest.raises(pt.MXNetError, match="cannot replace"):
        a._set_tensor(torch.zeros(4, 3, dtype=torch.float64))


def test_views_of_a_transposed_holder_and_view_errors():
    t = torch.from_numpy(_r(3, 4)).t()  # (4, 3), not contiguous
    a = pt.nd.NDArray(t, CPU)
    a[1] = 0.0
    assert float(a.asnumpy()[1].sum()) == 0.0 and a.reshape((2, 6)).shape == (2, 6)
    np.testing.assert_array_equal(a.reshape((12,)).asnumpy(), a.asnumpy().reshape(12))
    with pytest.raises(pt.MXNetError, match="size mismatch"):
        a.reshape((5, 2))
    assert a.reshape((-1, 2)).shape == (6, 2) and a.reshape(12).shape == (12,)
    with pytest.raises(pt.MXNetError, match="invalid slice"):
        a.slice(2, 9)
    with pytest.raises(pt.MXNetError, match="step=1"):
        a[::2]
    with pytest.raises(IndexError):
        a[4]
    assert [r.shape for r in a] == [(3,)] * 4  # the sequence protocol stops on IndexError
    with pytest.raises(pt.MXNetError, match="nested view"):
        a.reshape((6, 2))[0:1]


def test_advanced_indexing_copies():
    x = _r(4, 3)
    j, p = _both(x)
    _same(p[[0, 2]], j[np.array([0, 2])], exact=True)
    c = p[[0, 2]]
    c[:] = 0.0
    np.testing.assert_array_equal(p.asnumpy(), x)


def test_copy_copyto_as_in_context():
    x = _r(2, 3)
    p = pt.nd.array(x, ctx=CPU)
    c = p.copy()
    c[:] = 0.0
    np.testing.assert_array_equal(p.asnumpy(), x)
    dst = pt.nd.zeros((2, 3), ctx=CPU)
    assert p.copyto(dst) is dst
    np.testing.assert_array_equal(dst.asnumpy(), x)
    moved = p.copyto(pt.cpu(0))
    assert moved is not p and moved._tensor().data_ptr() != p._tensor().data_ptr()
    assert p.as_in_context(CPU) is p
    with pytest.raises(pt.MXNetError, match="same"):
        p.copyto(p[0:1].reshape((3,)))
    with pytest.raises(TypeError):
        p.copyto("cpu")


def test_ndarray_defaults_to_the_gpu(monkeypatch):
    # the default no variable names (tests/conftest.py sets one for JAX)
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: pt.nd.zeros((2,)), lambda: pt.nd.array([1.0]), lambda: pt.nd.arange(3),
                 lambda: pt.nd.NDArray(np.ones(2, np.float32))):
        with pytest.raises(pt.MXNetError, match="CUDA is not available"):
            make()


# ----------------------------------------------------------------- operators
_BINARY = [operator.add, operator.sub, operator.mul, operator.truediv, operator.pow,
           operator.mod]
_COMPARE = [operator.eq, operator.ne, operator.gt, operator.ge, operator.lt, operator.le]


# scalar-on-the-left forms exist for the arithmetic only: python reflects a
# comparison onto the other operand's, and NDArray has no __rmod__
_OPERATOR_CASES = [(op, other) for op in _BINARY + _COMPARE
                   for other in ("same", "broadcast", "scalar")] \
    + [(op, "reverse") for op in _BINARY if op is not operator.mod]


@pytest.mark.parametrize("op,other", _OPERATOR_CASES,
                         ids=["%s-%s" % (f.__name__, o) for f, o in _OPERATOR_CASES])
def test_operator_matches_the_reference(op, other):
    x = np.abs(_q(3, 4)) + 0.25  # positive: pow and mod of both packages agree there
    if op is operator.pow:
        x = x / 2
    (jx, px) = _both(x)
    if other == "scalar":
        got, want = op(px, 0.75), op(jx, 0.75)
    elif other == "reverse":
        got, want = op(1.5, px), op(1.5, jx)
    else:
        y = np.abs(_q(3, 4, seed=1) if other == "same" else _q(1, 4, seed=2)) + 0.25
        (jy, py) = _both(y)
        got, want = op(px, py), op(jx, jy)
    _same(got, want, exact=op in _COMPARE)


def test_unary_inplace_and_reductions_match_the_reference():
    x = _r(3, 4)
    j, p = _both(x)
    _same(-p, -j, exact=True)
    _same(p.T, j.T, exact=True)
    for name, kw in (("sum", {}), ("sum", {"axis": 1}), ("mean", {"axis": (0, 1)}),
                     ("mean", {"axis": 0, "keepdims": True}), ("max", {}), ("max", {"axis": 1}),
                     ("min", {"axis": 0}), ("min", {"keepdims": True})):
        _same(getattr(p, name)(**kw), getattr(j, name)(**kw))
    for nd, a in ((pt.nd, p), (mx.nd, j)):
        view = a[1]
        a += 1.0
        a -= a[0:1]           # broadcast
        a *= 3.0
        a /= 2.0
        view += 0.5           # in place through a view
    _same(p, j)


# ------------------------------------------------------- the nd.<op> functions
def test_every_registered_op_has_an_nd_function():
    from mxnet_tpu_torch.ops import registry

    missing = [n for n in registry._REGISTRY if not callable(getattr(pt.nd, n, None))]
    assert not missing
    assert pt.nd.broadcast_add.__name__ == "broadcast_add"


@pytest.mark.parametrize("call", [
    lambda nd, a, b: nd.dot(a, b.T),
    lambda nd, a, b: nd.dot(a, b, transpose_b=True),
    lambda nd, a, b: nd.transpose(a, axes=(1, 0)),
    lambda nd, a, b: nd.Concat(a, b, num_args=2, dim=0),
    lambda nd, a, b: nd.clip(a, a_min=-0.5, a_max=0.5),
    lambda nd, a, b: nd.broadcast_div(a, b + 3.0),
    lambda nd, a, b: nd.elemwise_add(lhs=a, rhs=b),
    lambda nd, a, b: nd.sum(a, axis=1, keepdims=True),
    lambda nd, a, b: nd.argmax(a, axis=1),
    lambda nd, a, b: nd.sqrt(nd.abs(a)) + nd.exp(b) * nd.tanh(a),
    lambda nd, a, b: nd.add_n(a, b, a, num_args=3),
    lambda nd, a, b: nd.Reshape(a, shape=(-1, 2)),
    lambda nd, a, b: nd.one_hot(nd.argmax(a, axis=1), depth=4),
    lambda nd, a, b: nd.FullyConnected(data=a, weight=b, num_hidden=3, no_bias=True),
    lambda nd, a, b: nd.softmax(a, axis=-1),
], ids=["dot", "dot_transpose_b", "transpose", "Concat", "clip", "broadcast_div", "named_inputs",
        "sum", "argmax", "chain", "add_n", "Reshape", "one_hot", "FullyConnected", "softmax"])
def test_nd_functions_match_the_reference(call):
    (ja, pa), (jb, pb) = _both(_r(3, 4)), _both(_r(3, 4, seed=1))
    _same(call(pt.nd, pa, pb), call(mx.nd, ja, jb))


def test_nd_function_results_own_their_memory_and_out_writes_in_place():
    a = pt.nd.array(_r(2, 3), ctx=CPU)
    for view_op in (lambda: pt.nd.identity(a), lambda: pt.nd.Reshape(a, shape=(3, 2)),
                    lambda: pt.nd.transpose(a), lambda: pt.nd.broadcast_to(a, shape=(2, 3))):
        before = a.asnumpy()
        out = view_op()
        out[:] = 0.0
        np.testing.assert_array_equal(a.asnumpy(), before)
    dst = pt.nd.zeros((2, 3), ctx=CPU)
    t = dst._tensor()
    assert pt.nd.elemwise_add(a, a, out=dst) is dst and dst._tensor() is t
    np.testing.assert_array_equal(dst.asnumpy(), a.asnumpy() * 2)
    with pytest.raises(pt.MXNetError, match="positional args must be NDArrays"):
        pt.nd.clip(a, -1.0, 1.0)
    with pytest.raises(pt.MXNetError, match="unknown tensor inputs"):
        pt.nd.elemwise_add(lhs=a, other=a)


def test_imperative_batchnorm_updates_its_aux_inputs_in_place():
    x = _r(4, 3, 2, 2)
    vals = [x, np.ones(3, np.float32), np.zeros(3, np.float32), np.zeros(3, np.float32),
            np.ones(3, np.float32)]
    outs = []
    for nd, kw in ((pt.nd, {"ctx": CPU}), (mx.nd, {})):
        arrs = [nd.array(v, **kw) for v in vals]
        y = nd.imperative_invoke("BatchNorm", arrs, {"fix_gamma": False, "momentum": 0.9},
                                 is_train=True)[0]
        outs.append((y, arrs[3], arrs[4]))
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5, atol=1e-6)
    assert float(np.abs(outs[0][1].asnumpy()).max()) > 0  # the moving mean moved


# ---------------------------------------------------------------- save / load
def _save_cases():
    return {
        "dict": {"arg:w": _r(3, 4), "aux:m": np.arange(5, dtype=np.int32),
                 "h": _r(2, 2).astype(np.float16), "u": np.arange(4, dtype=np.uint8),
                 "d": _r(2).astype(np.float64), "l": np.arange(3, dtype=np.int64)},
        "list": [_r(2, 3), _r(4, seed=1)],
        "single": _r(5),
        "with_none": {"a": _r(2), "none": None, "b": _r(3, 1)},
        "empty_list": [],
    }


def _wrap(data, array):
    if isinstance(data, dict):
        return {k: None if v is None else array(v) for k, v in data.items()}
    if isinstance(data, list):
        return [array(v) for v in data]
    return array(data)


def _host(loaded):
    vals = loaded.items() if isinstance(loaded, dict) else enumerate(loaded)
    return {k: None if v is None else v.asnumpy() for k, v in vals}


@pytest.mark.parametrize("case", sorted(_save_cases()))
def test_params_files_cross_between_the_packages(case, tmp_path):
    data = _save_cases()[case]
    jpath, ppath = str(tmp_path / "j.params"), str(tmp_path / "p.params")
    # 64-bit types survive a file only where the writer holds them (the JAX
    # package narrows them to 32 bits): they are left out here and go through
    # the port alone below
    jdata = {k: v for k, v in data.items() if k not in "dl"} if isinstance(data, dict) else data
    mx.nd.save(jpath, _wrap(jdata, mx.nd.array))
    pt.nd.save(ppath, _wrap(jdata, lambda v: pt.nd.array(v, ctx=CPU)))
    # the same data on cpu() gives the same bytes
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    want = _host(mx.nd.load(jpath))
    for path in (jpath, ppath):  # a JAX-written file and a port-written file load equal
        got = _host(pt.nd.load(path, ctx=CPU))
        assert list(got) == list(want)
        for k in want:
            if want[k] is None:
                assert got[k] is None
            else:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    got = _host(mx.nd.load(ppath))  # and the JAX package reads the port's file
    for k in want:
        assert (got[k] is None) if want[k] is None else np.array_equal(got[k], want[k])
    if case == "dict":
        wide = {k: pt.nd.NDArray(torch.from_numpy(data[k]), CPU) for k in "dl"}
        pt.nd.save(ppath, wide)
        for k, back in pt.nd.load(ppath, ctx=CPU).items():
            assert back.dtype == data[k].dtype
            np.testing.assert_array_equal(back.asnumpy(), data[k])


def test_save_load_refusals(tmp_path):
    path = str(tmp_path / "x.params")
    with pytest.raises(pt.MXNetError, match="0-d"):
        pt.nd.save(path, [pt.nd.NDArray(torch.tensor(1.0), CPU)])
    with pytest.raises(TypeError):
        pt.nd.save(path, "nope")
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", 0x113, 0) + b"\0" * 16)
    with pytest.raises(pt.MXNetError, match="invalid NDArray file"):
        pt.nd.load(path, ctx=CPU)
    pt.nd.save(path, {"w": pt.nd.array(_r(8, 8), ctx=CPU)})
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])  # a torn write
    with pytest.raises(pt.MXNetError, match="truncated"):
        pt.nd.load(path, ctx=CPU)
    # the saved device field is ignored by the loader: a file saved from the
    # card (device type 2) loads onto the CPU
    gpu_blob = bytearray(blob)
    off = 16 + 8 + 4 + 8  # header, count, ndim, two dims
    assert struct.unpack_from("<ii", gpu_blob, off) == (1, 0)
    struct.pack_into("<ii", gpu_blob, off, 2, 0)
    with open(path, "wb") as f:
        f.write(bytes(gpu_blob))
    np.testing.assert_array_equal(pt.nd.load(path, ctx=CPU)["w"].asnumpy(), _r(8, 8))
    np.testing.assert_array_equal(mx.nd.load(path)["w"].asnumpy(), _r(8, 8))
