"""NDArray: the tensor holder behind an executor's arguments, gradients and
outputs.

Counterpart of the part of ``mxnet_tpu/ndarray.py`` that ``arg_dict``,
``grad_dict``, ``outputs`` and the optimizer use: ``arr[:] = value`` (numpy,
tensor or NDArray), ``asnumpy``, ``shape``, ``dtype``, ``context``,
``zeros``, ``imperative_invoke``, and the internal get/set of the held
tensor, ``_tensor``/``_set_tensor`` (the JAX package's ``_jax``/``_set_jax``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .base import MXNetError, numpy_dtype, torch_dtype
from .context import Context, current_context
from .ops.registry import get_op, parse_attrs

__all__ = ["NDArray", "zeros", "imperative_invoke"]


class NDArray:
    __slots__ = ("_t", "_ctx")

    def __init__(self, tensor: torch.Tensor, ctx: Context):
        self._t = tensor
        self._ctx = ctx

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._t.dtype)

    @property
    def context(self) -> Context:
        return self._ctx

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)), self._ctx)

    def _tensor(self) -> torch.Tensor:
        return self._t

    def _set_tensor(self, tensor: torch.Tensor):
        """Swap the held tensor (no copy); it must keep shape, dtype and device."""
        if tensor.shape != self._t.shape or tensor.dtype != self._t.dtype \
                or tensor.device != self._t.device:
            raise MXNetError("NDArray._set_tensor: %s %s on %s cannot replace %s %s on %s"
                             % (tuple(tensor.shape), tensor.dtype, tensor.device,
                                self.shape, self._t.dtype, self._t.device))
        self._t = tensor

    def asnumpy(self) -> np.ndarray:
        return self._t.detach().cpu().numpy()

    def __setitem__(self, key, value):
        if key != slice(None):
            raise MXNetError("NDArray assignment supports arr[:] = value only")
        if isinstance(value, NDArray):
            value = value._t
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value, dtype=self.dtype))
        # copy_ broadcasts, converts dtype, and copies across devices
        self._t.copy_(value)


def zeros(shape, ctx: Context = None, dtype="float32") -> NDArray:
    """Zeros on ``ctx`` (default ``current_context()``, the GPU)."""
    ctx = ctx or current_context()
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=ctx.torch_device),
                   ctx)


def imperative_invoke(op_name, inputs, attrs, out) -> List[NDArray]:
    """Run a registered op eagerly on NDArrays, outside autograd, and write
    each result into its ``out`` NDArray in place (reference:
    MXImperativeInvoke). In place is what the port does where the JAX
    package rebinds the arrays to new immutable buffers: the optimizer
    updates a weight and its state where they lie. Returns ``out``."""
    opdef = get_op(op_name)
    targets = list(out) if isinstance(out, (list, tuple)) else [out]
    with torch.no_grad():
        outs, _ = opdef.apply(parse_attrs(opdef, attrs), [x._tensor() for x in inputs])
        for t, o in zip(targets, outs):
            t._tensor().copy_(o)
    return targets
