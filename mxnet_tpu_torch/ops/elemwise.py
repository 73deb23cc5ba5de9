"""Elementwise, scalar, logic ops.

Counterpart of ``mxnet_tpu/ops/elemwise.py``, every op it registers under
the same names and aliases: the same-shape binary ops behind Symbol
arithmetic, the unary math ops, ``Cast``, ``clip``, the scalar ops behind
NDArray's operators, ``smooth_l1`` and ``add_n``. Each is a plain function
over torch tensors; a comparison returns 0/1 in its left operand's dtype, as
the JAX package's does.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import AttrSpec, register

_B2 = ("lhs", "rhs")


def _logic(f):
    return lambda a, b: f(a, b).to(a.dtype)


# --- binary: name -> (function, aliases) --------------------------------------
_BINARY = {
    "elemwise_add": (torch.add, ("_add", "_plus", "_Plus")),
    "elemwise_sub": (torch.sub, ("_sub", "_minus", "_Minus")),
    "elemwise_mul": (torch.mul, ("_mul", "_Mul")),
    "elemwise_div": (torch.div, ("_div", "_Div")),
    "_grad_add": (torch.add, ()),
    "_power": (torch.pow, ("_Power", "_pow")),
    "_maximum": (torch.maximum, ("_Maximum",)),
    "_minimum": (torch.minimum, ("_Minimum",)),
    "_hypot": (torch.hypot, ("_Hypot",)),
    "_equal": (_logic(torch.eq), ("_Equal", "_eq")),
    "_not_equal": (_logic(torch.ne), ("_Not_Equal", "_ne")),
    "_greater": (_logic(torch.gt), ("_Greater", "_gt")),
    "_greater_equal": (_logic(torch.ge), ("_Greater_Equal", "_ge")),
    "_lesser": (_logic(torch.lt), ("_Lesser", "_lt")),
    "_lesser_equal": (_logic(torch.le), ("_Lesser_Equal", "_le")),
    # jnp.mod takes the divisor's sign, as torch.remainder does
    "_mod": (torch.remainder, ("_Mod",)),
}
for _n, (_f, _aliases) in _BINARY.items():
    def _binary(attrs, lhs, rhs, _f=_f):
        return _f(lhs, rhs)

    _binary.__doc__ = "Elementwise %s (same-shape; see broadcast_%s for broadcasting)." % (_n, _n)
    register(_n, input_names=_B2, aliases=_aliases)(_binary)


# --- unary --------------------------------------------------------------------
def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "round": torch.round,  # halves to even, as jnp.round
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "fix": torch.trunc,
    "trunc": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}
for _n, _f in _UNARY.items():
    def _unary(attrs, data, _f=_f):
        return _f(data)

    _unary.__doc__ = "Elementwise %s." % _n
    register(_n)(_unary)


@register("_copy", aliases=("identity", "_identity_with_attr_like_rhs"))
def _copy(attrs, data, *rest):
    return data


@register("BlockGrad", aliases=("stop_gradient", "make_no_grad"))
def _block_grad(attrs, data):
    return data.detach()


@register("_CrossDeviceCopy", aliases=("_copyto",),
          attrs={"__target_ctx__": AttrSpec("str", default="")})
def _cross_device_copy(attrs, data):
    """Move data to the device ``__target_ctx__`` names ("gpu:0", "cpu");
    with no target it is the identity, as ``_copyto`` on one device."""
    target = attrs.get("__target_ctx__") or ""
    if not target:
        return data
    from ..context import Context

    name, _, idx = target.partition(":")
    return data.to(Context(name, int(idx or 0)).torch_device)


@register("Cast", attrs={"dtype": AttrSpec("dtype", required=True)}, aliases=("cast",))
def _cast(attrs, data):
    """Cast to a new dtype (reference: elemwise_unary_op.cc Cast)."""
    return data.to(torch_dtype(attrs["dtype"]))


@register("clip", attrs={"a_min": AttrSpec("float", required=True),
                         "a_max": AttrSpec("float", required=True)})
def _clip(attrs, data):
    return torch.clamp(data, attrs["a_min"], attrs["a_max"])


# --- scalar ops: name -> (function, aliases) ----------------------------------
_SCALAR = {
    "_plus_scalar": (lambda x, s: x + s, ("_PlusScalar",)),
    "_minus_scalar": (lambda x, s: x - s, ("_MinusScalar",)),
    "_rminus_scalar": (lambda x, s: s - x, ("_RMinusScalar",)),
    "_mul_scalar": (lambda x, s: x * s, ("_MulScalar",)),
    "_div_scalar": (lambda x, s: x / s, ("_DivScalar",)),
    "_rdiv_scalar": (lambda x, s: s / x, ("_RDivScalar",)),
    "_power_scalar": (lambda x, s: torch.pow(x, s), ("_PowerScalar",)),
    "_rpower_scalar": (lambda x, s: torch.pow(s, x), ("_RPowerScalar",)),
    "_maximum_scalar": (lambda x, s: torch.maximum(x, s), ("_MaximumScalar",)),
    "_minimum_scalar": (lambda x, s: torch.minimum(x, s), ("_MinimumScalar",)),
    "_hypot_scalar": (lambda x, s: torch.hypot(x, s.expand_as(x)), ("_HypotScalar",)),
    "_mod_scalar": (lambda x, s: torch.remainder(x, s), ()),
    "_rmod_scalar": (lambda x, s: torch.remainder(s, x), ()),
    "_equal_scalar": (lambda x, s: (x == s).to(x.dtype), ("_EqualScalar",)),
    "_not_equal_scalar": (lambda x, s: (x != s).to(x.dtype), ("_NotEqualScalar",)),
    "_greater_scalar": (lambda x, s: (x > s).to(x.dtype), ("_GreaterScalar",)),
    "_greater_equal_scalar": (lambda x, s: (x >= s).to(x.dtype), ("_GreaterEqualScalar",)),
    "_lesser_scalar": (lambda x, s: (x < s).to(x.dtype), ("_LesserScalar",)),
    "_lesser_equal_scalar": (lambda x, s: (x <= s).to(x.dtype), ("_LesserEqualScalar",)),
}
for _n, (_f, _aliases) in _SCALAR.items():
    def _scalar(attrs, data, _f=_f):
        # the scalar takes the tensor's dtype, as jnp.asarray(s, data.dtype) does;
        # filled on the device (no host copy), so a CUDA graph can capture it
        return _f(data, torch.full((), attrs["scalar"], dtype=data.dtype, device=data.device))

    register(_n, attrs={"scalar": AttrSpec("float", required=True)}, aliases=_aliases)(_scalar)


@register("smooth_l1", attrs={"scalar": AttrSpec("float", default=1.0)})
def _smooth_l1(attrs, data):
    """Smooth L1 (reference: elemwise_binary_scalar_op_extended.cc smooth_l1)."""
    s2 = attrs["scalar"] ** 2
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * torch.square(data), a - 0.5 / s2)


def _n_args_names(attrs):
    return ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))]


@register("add_n", attrs={"num_args": AttrSpec("int", required=True)},
          input_names=_n_args_names, aliases=("ElementWiseSum", "_sum"))
def _add_n(attrs, *args):
    """Sum of N arrays (reference: ElementwiseSum, src/ndarray/ndarray.cc:302)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
