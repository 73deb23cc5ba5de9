"""Elementwise and scalar ops.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the same-shape binary ops
behind Symbol arithmetic, the scalar ops, and the two unary ops the
transformer's LayerNorm composition uses (``rsqrt``, ``square``).
"""
from __future__ import annotations

import torch

from .registry import AttrSpec, register

_B2 = ("lhs", "rhs")

_BINARY = {
    "elemwise_add": (torch.add, ("_add", "_plus", "_Plus")),
    "elemwise_sub": (torch.sub, ("_sub", "_minus", "_Minus")),
    "elemwise_mul": (torch.mul, ("_mul", "_Mul")),
}
for _n, (_f, _aliases) in _BINARY.items():
    def _binary(attrs, lhs, rhs, _f=_f):
        return _f(lhs, rhs)

    register(_n, input_names=_B2, aliases=_aliases)(_binary)


_SCALAR = {
    "_plus_scalar": (lambda x, s: x + s, ("_PlusScalar",)),
    "_minus_scalar": (lambda x, s: x - s, ("_MinusScalar",)),
    "_rminus_scalar": (lambda x, s: s - x, ("_RMinusScalar",)),
    "_mul_scalar": (lambda x, s: x * s, ("_MulScalar",)),
}
for _n, (_f, _aliases) in _SCALAR.items():
    def _scalar(attrs, data, _f=_f):
        # the scalar takes the tensor's dtype, as jnp.asarray(s, data.dtype) does
        return _f(data, torch.tensor(attrs["scalar"], dtype=data.dtype, device=data.device))

    register(_n, attrs={"scalar": AttrSpec("float", required=True)}, aliases=_aliases)(_scalar)


@register("rsqrt")
def _rsqrt(attrs, data):
    return torch.rsqrt(data)


@register("square")
def _square(attrs, data):
    return torch.square(data)
