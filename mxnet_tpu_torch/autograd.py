"""Imperative autograd: record NDArray ops, then take their gradients.

Counterpart of ``mxnet_tpu/autograd.py`` (the reference's
src/ndarray/autograd.cc and python/mxnet/contrib/autograd.py) with its API:
``record``/``train_section``/``test_section``, ``mark_variables``,
``backward``, ``compute_gradient``, ``grad_and_loss`` and ``grad``. The JAX
package keeps a tape of the recorded ops and replays it under ``jax.vjp``
at ``backward``; here torch autograd records the graph as the ops run.
While recording, ``ndarray.imperative_invoke`` runs each op under
``torch.enable_grad()`` on the recorded inputs (a marked array enters as a
leaf that requires grad, an op's result as the tensor it produced), and
this module keeps each result's tensor beside its NDArray, whose own
tensor is detached. ``backward`` takes ``torch.autograd.grad`` of the
heads with respect to the marked arrays and writes the gradients by each
array's grad_req.

As in the reference's contrib API, arrays must not be changed in place
between recording and ``backward``.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["set_is_training", "is_training", "set_recording", "is_recording", "record",
           "train_section", "test_section", "mark_variables", "backward",
           "compute_gradient", "grad_and_loss", "grad"]

_RECORDING = False
_TRAIN_MODE = True
_MARKED = {}  # id(NDArray) -> (NDArray, gradient NDArray, grad_req)
_LEAVES = {}  # id(NDArray) -> (NDArray, its leaf tensor), marked arrays read while recording
_GRAPH = {}  # id(NDArray) -> (NDArray, the tensor carrying its autograd graph)


# ------------------------------------------------------------------ recording
def is_recording() -> bool:
    return _RECORDING


def is_training() -> bool:
    return _TRAIN_MODE


def set_recording(flag: bool) -> bool:
    """Returns the previous state (reference: autograd.py set_is_recording)."""
    global _RECORDING
    prev, _RECORDING = _RECORDING, bool(flag)
    return prev


def set_is_training(flag: bool) -> bool:
    global _TRAIN_MODE
    prev, _TRAIN_MODE = _TRAIN_MODE, bool(flag)
    return prev


@contextlib.contextmanager
def record(train_mode=True):
    """Recording scope (reference: contrib/autograd.py train_section)."""
    prev_r = set_recording(True)
    prev_t = set_is_training(train_mode)
    try:
        yield
    finally:
        set_recording(prev_r)
        set_is_training(prev_t)


@contextlib.contextmanager
def train_section():
    with record(train_mode=True):
        yield


@contextlib.contextmanager
def test_section():
    with record(train_mode=False):
        yield


def _recorded(arr):
    """The tensor a recorded op reads for ``arr``: the graph tensor of a
    recorded result, the leaf of a marked array, else the array's own."""
    for table in (_GRAPH, _LEAVES):
        entry = table.get(id(arr))
        if entry is not None and entry[0] is arr:
            return entry[1]
    if id(arr) in _MARKED:
        leaf = arr._tensor().detach().requires_grad_(True)
        _LEAVES[id(arr)] = (arr, leaf)
        return leaf
    return arr._tensor()


def _record_outputs(arrays, tensors):
    """Called by imperative_invoke under recording: each result array's
    graph tensor."""
    for arr, t in zip(arrays, tensors):
        if t.requires_grad:
            _GRAPH[id(arr)] = (arr, t)


def _clear_tape():
    _GRAPH.clear()
    _LEAVES.clear()


# ------------------------------------------------------------------ variables
def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (reference: autograd.cc MarkVariables)."""
    if isinstance(variables, NDArray):
        variables = [variables]
    if isinstance(gradients, NDArray):
        gradients = [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    if not (len(variables) == len(gradients) == len(grad_reqs)):
        raise MXNetError("mark_variables: length mismatch")
    for v, g, r in zip(variables, gradients, grad_reqs):
        if not isinstance(v, NDArray) or not isinstance(g, NDArray):
            raise TypeError("mark_variables expects NDArrays")
        _MARKED[id(v)] = (v, g, r)


# ------------------------------------------------------------------- backward
def backward(outputs, out_grads=None, retain_graph=False):
    """Gradients of ``outputs`` with respect to every marked array, written
    into their gradient arrays (reference: autograd.cc:135 ComputeGradient).
    A marked array the heads do not depend on gets zeros under write."""
    if isinstance(outputs, NDArray):
        outputs = [outputs]
    if out_grads is not None and isinstance(out_grads, NDArray):
        out_grads = [out_grads]
    if not _MARKED:
        raise MXNetError("backward: no marked variables (call mark_variables)")
    if out_grads is not None and len(out_grads) != len(outputs):
        raise MXNetError("backward: expected %d head grads" % len(outputs))
    heads, cots = [], []
    for i, o in enumerate(outputs):
        entry = _GRAPH.get(id(o))
        if entry is None or entry[0] is not o:
            raise MXNetError("backward: output was not recorded on the tape")
        heads.append(entry[1])
        cots.append(torch.ones_like(entry[1]) if out_grads is None else
                    out_grads[i]._tensor().to(device=entry[1].device, dtype=entry[1].dtype))
    marked = list(_MARKED.values())
    leaves = [_LEAVES.get(id(v), (None, None)) for v, _, _ in marked]
    wrt = [i for i, (owner, _) in enumerate(leaves) if owner is marked[i][0]]
    got = torch.autograd.grad(heads, [leaves[i][1] for i in wrt], grad_outputs=cots,
                              retain_graph=retain_graph, allow_unused=True) if wrt else []
    grads = dict(zip(wrt, got))
    with torch.no_grad():
        for i, (_, gbuf, req) in enumerate(marked):
            if req == "null":
                continue
            t = gbuf._tensor()
            g = grads.get(i)
            if g is None:
                g = torch.zeros_like(t)
            if req == "add":
                t.add_(g.to(t.dtype))
            else:
                t.copy_(g)
    if not retain_graph:
        _clear_tape()


def compute_gradient(outputs):
    """(reference: contrib/autograd.py compute_gradient)"""
    backward(outputs)


# ------------------------------------------------------------------ decorators
def grad_and_loss(func, argnum=None):
    """A function computing both the gradient of the arguments and the loss
    (reference: contrib/autograd.py grad_and_loss)."""

    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else list(argnum)
            variables = [args[i] for i in argnums]
        for v in variables:
            if not isinstance(v, NDArray):
                raise TypeError("grad_and_loss: arguments must be NDArrays")
        from .ndarray import zeros

        grads = [zeros(v.shape, ctx=v.context, dtype=v.dtype) for v in variables]
        mark_variables(variables, grads)
        prev = (dict(_GRAPH), dict(_LEAVES))
        _clear_tape()
        try:
            with record():
                outputs = func(*args)
            backward([outputs] if isinstance(outputs, NDArray) else list(outputs))
        finally:
            for v in variables:
                _MARKED.pop(id(v), None)
            _GRAPH.update(prev[0])
            _LEAVES.update(prev[1])
        return grads, outputs

    return wrapped


def grad(func, argnum=None):
    """(reference: contrib/autograd.py grad)"""
    fn = grad_and_loss(func, argnum)

    def wrapped(*args):
        return fn(*args)[0]

    return wrapped
