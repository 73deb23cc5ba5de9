"""Parameters from the JAX package (or any numpy source) into the port.

The names are identical in both packages, and so are the layouts: the
FullyConnected weight (N, K), the Convolution weight OIHW, BatchNorm's gamma
and beta and its aux states moving_mean and moving_var (C,). So conversion
is a copy onto the target device, the same call for a JAX executor's
arguments and for its aux states:

    args = params_from_numpy(jax_exe.arg_dict, ctx)
    aux = params_from_numpy(jax_exe.aux_dict, ctx)
    port_exe.copy_params_from(args, aux)

A checkpoint the JAX package saved (``mx.model.save_checkpoint``, or
``Module.save_checkpoint``) is in the reference's ``.params`` layout, which
the port reads as it is:

    args, aux = params_from_checkpoint("ckpt/resnet", 10, ctx)

A JAX ``Module``'s optimizer-state file pickles JAX arrays. With the states
taken out as numpy on the JAX side (one array, None, a tuple of them, or a
``RowSparseState`` per key), ``updater_states_from_numpy`` makes the port's
``Updater.states``, so training resumes in the port:

    mod.init_optimizer(...)
    mod._updater.states = updater_states_from_numpy(jax_states_as_numpy, ctx)

``load_states`` reads such a state file as it is, without JAX: it
unpickles the JAX package's NDArray, Context and ``RowSparseState``
records and the arrays inside them as numpy, and gives the port's objects
(``Module.load_optimizer_states`` and ``KVStore.load_optimizer_states``
read through it, so a file either package wrote loads into the port).
``updater_states_to_numpy`` is the way back: the states as numpy, for the
JAX package to wrap.

The fused step (``parallel.SPMDTrainer``) keeps its optimizer state as the
JAX package's does: ``{"t", "mom"}`` (SGD, NAG) or ``{"t", "m", "v"}``
(Adam), each state a {name: array} dict. A JAX trainer's state, taken out
with ``jax.device_get``, goes into the port with ``opt_state_from_numpy``
(or straight into ``trainer.opt_state``) and comes back with
``opt_state_to_numpy``; both packages' fused ``Module.save_optimizer_states``
write that numpy tree as a pickle, which ``load_fused_states`` reads, so a
``.states`` file of either package's fused step loads into the other's.
"""
from __future__ import annotations

import io
import pickle
from typing import Dict

import numpy as np
import torch

from .context import Context, current_context

__all__ = ["params_from_numpy", "params_from_checkpoint", "updater_states_from_numpy",
           "updater_states_to_numpy", "load_states", "opt_state_from_numpy",
           "opt_state_to_numpy", "load_fused_states"]


def params_from_numpy(arg_params, ctx: Context = None) -> Dict[str, torch.Tensor]:
    """{name: array} (numpy, or anything with ``asnumpy()``) → {name: tensor}
    on ``ctx`` (default ``gpu(0)``), with each array's dtype kept."""
    device = (ctx or current_context()).torch_device
    out = {}
    for name, value in arg_params.items():
        host = np.ascontiguousarray(value.asnumpy() if hasattr(value, "asnumpy") else value)
        out[name] = torch.from_numpy(host).to(device)
    return out


def params_from_checkpoint(prefix, epoch, ctx: Context = None):
    """``(arg_params, aux_params)`` of the checkpoint ``<prefix>-<epoch:04d>.params``
    (written by either package) as {name: tensor} dicts on ``ctx`` (default
    ``gpu(0)``), as ``params_from_numpy`` returns them."""
    from .model import load_checkpoint

    _, arg_params, aux_params = load_checkpoint(prefix, epoch, ctx=ctx)
    return ({n: a._tensor() for n, a in arg_params.items()},
            {n: a._tensor() for n, a in aux_params.items()})


def updater_states_from_numpy(states, ctx: Context = None):
    """{key: state} with each state a numpy array (or anything with
    ``asnumpy()``), None, or a tuple of them → the same structure of
    NDArrays on ``ctx`` (default ``gpu(0)``), each array's dtype kept. A
    row-sparse state (the JAX package's ``RowSparseState``, or anything with
    its ``__getstate__``) becomes the port's, still host numpy."""
    from .ndarray import NDArray
    from .sparse import RowSparseState

    ctx = ctx or current_context()

    def one(v):
        if v is None:
            return None
        if type(v).__name__ == "RowSparseState":
            st = RowSparseState.__new__(RowSparseState)
            st.__setstate__(v.__getstate__())
            return st
        if isinstance(v, (tuple, list)):
            return tuple(one(x) for x in v)
        # a copy the port owns (the caller's array may be read-only)
        host = np.array(v.asnumpy() if hasattr(v, "asnumpy") else v, copy=True)
        return NDArray(torch.from_numpy(host), ctx=ctx)

    return {k: one(v) for k, v in states.items()}


def updater_states_to_numpy(states):
    """{key: state} of the port's Updater → the same structure with numpy
    arrays for NDArrays; a ``RowSparseState`` stays as it is (host numpy)."""
    def one(v):
        if v is None or type(v).__name__ == "RowSparseState":
            return v
        if isinstance(v, (tuple, list)):
            return tuple(one(x) for x in v)
        return v.asnumpy()

    return {k: one(v) for k, v in states.items()}


def opt_state_from_numpy(state, ctx: Context = None):
    """A fused-step optimizer state as numpy (``{"t": int32 scalar, <state>:
    {name: array}}``, a JAX ``SPMDTrainer.opt_state`` after
    ``jax.device_get``) → the same tree of tensors on ``ctx`` (default
    ``gpu(0)``)."""
    device = (ctx or current_context()).torch_device

    def one(v):
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(device)

    return one(state)


def opt_state_to_numpy(state):
    """A fused-step optimizer state (tensors) → the numpy tree the JAX
    package's trainer holds after ``jax.device_get``."""
    if isinstance(state, dict):
        return {k: opt_state_to_numpy(v) for k, v in state.items()}
    return state.detach().cpu().numpy().copy()


def load_fused_states(blob: bytes):
    """The numpy tree of a fused step's ``.states`` pickle, written by
    either package (read without JAX)."""
    state = _StateUnpickler(io.BytesIO(blob)).load()
    if not isinstance(state, dict) or "t" not in state:
        raise ValueError("not a fused-step optimizer state (no counter 't')")
    return state


class _ForeignChunk:
    """A JAX package ``_Chunk`` record: its ``data`` came back as numpy."""

    def __setstate__(self, state):
        slots = state[1] if isinstance(state, tuple) else state
        self.__dict__.update(slots)


class _ForeignNDArray:
    """A JAX package ``NDArray`` record, turned into the port's NDArray by
    ``load_states``."""

    def __setstate__(self, state):
        slots = state[1] if isinstance(state, tuple) else state
        self.__dict__.update(slots)

    def to_port(self):
        from .context import Context
        from .ndarray import NDArray

        host = np.asarray(self._chunk.data)
        begin, end = getattr(self, "_begin", None), getattr(self, "_end", None)
        if begin is not None:
            host = host[begin:end]
        host = np.array(host.reshape(self._shape), copy=True)
        ctx = self._chunk.ctx
        return NDArray(torch.from_numpy(host),
                       ctx=ctx if isinstance(ctx, Context) else Context("cpu", 0))


def _jax_array_as_numpy(fun, args, arr_state, aval_state):
    """Stands in for ``jax._src.array._reconstruct_array``: the numpy array
    it would have put on a device."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _StateUnpickler(pickle.Unpickler):
    _MAP = {("mxnet_tpu.ndarray", "NDArray"): _ForeignNDArray,
            ("mxnet_tpu.ndarray", "_Chunk"): _ForeignChunk,
            ("jax._src.array", "_reconstruct_array"): _jax_array_as_numpy}

    def find_class(self, module, name):
        got = self._MAP.get((module, name))
        if got is not None:
            return got
        if module == "mxnet_tpu.context" and name == "Context":
            from .context import Context

            return Context
        if module == "mxnet_tpu.sparse" and name == "RowSparseState":
            from .sparse import RowSparseState

            return RowSparseState
        if module.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise pickle.UnpicklingError("%s.%s has no counterpart in the port"
                                         % (module, name))
        return super().find_class(module, name)


def load_states(blob: bytes):
    """The {key: state} dict of an optimizer-state pickle written by either
    package, with the port's NDArrays (on the contexts they were saved
    from) and ``RowSparseState``s."""
    states = _StateUnpickler(io.BytesIO(blob)).load()

    def one(v):
        if isinstance(v, _ForeignNDArray):
            return v.to_port()
        if isinstance(v, (tuple, list)):
            return tuple(one(x) for x in v)
        return v

    return {k: one(v) for k, v in states.items()}


def states_on_context(state, ctx):
    """An updater state (an NDArray, None, a ``RowSparseState`` or a tuple
    of them) with its NDArrays on ``ctx`` (None: where they are)."""
    if isinstance(state, (tuple, list)):
        return type(state)(states_on_context(s, ctx) for s in state)
    if state is None or ctx is None or type(state).__name__ == "RowSparseState":
        return state
    return state.as_in_context(ctx)
