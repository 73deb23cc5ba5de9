"""Broadcasting binary ops and reductions.

Counterpart of ``mxnet_tpu/ops/broadcast_reduce.py``, every op it
registers: the broadcast arithmetic and comparisons behind NDArray's
operators, ``broadcast_to``/``broadcast_axis``, the reductions over axes
(``sum``, ``mean``, ``prod``, ``nansum``, ``nanprod``, ``max``, ``min``),
``norm``, and ``argmax``/``argmin``/``argmax_channel`` (float32 ids, as in
the JAX package).
"""
from __future__ import annotations

import torch

from .elemwise import _logic
from .registry import AttrSpec, register

_B2 = ("lhs", "rhs")

_BCAST = {
    "broadcast_add": (torch.add, ("broadcast_plus",)),
    "broadcast_sub": (torch.sub, ("broadcast_minus",)),
    "broadcast_mul": (torch.mul, ()),
    "broadcast_div": (torch.div, ()),
    "broadcast_mod": (torch.remainder, ()),
    "broadcast_power": (torch.pow, ()),
    "broadcast_maximum": (torch.maximum, ()),
    "broadcast_minimum": (torch.minimum, ()),
    "broadcast_hypot": (torch.hypot, ()),
    "broadcast_equal": (_logic(torch.eq), ()),
    "broadcast_not_equal": (_logic(torch.ne), ()),
    "broadcast_greater": (_logic(torch.gt), ()),
    "broadcast_greater_equal": (_logic(torch.ge), ()),
    "broadcast_lesser": (_logic(torch.lt), ()),
    "broadcast_lesser_equal": (_logic(torch.le), ()),
}
for _name, (_f, _aliases) in _BCAST.items():
    def _bcast(attrs, lhs, rhs, _f=_f):
        return _f(lhs, rhs)

    register(_name, input_names=_B2, aliases=_aliases)(_bcast)


@register("broadcast_to", attrs={"shape": AttrSpec("shape", default=())})
def _broadcast_to(attrs, data):
    """Broadcast to target shape; 0 in shape keeps the input dim (reference:
    broadcast_reduce_op.h BroadcastTo)."""
    tgt = tuple(int(s) if int(s) != 0 else int(d) for s, d in zip(attrs["shape"], data.shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_axis", attrs={"axis": AttrSpec("shape", default=()),
                                   "size": AttrSpec("shape", default=())},
          aliases=("broadcast_axes",))
def _broadcast_axis(attrs, data):
    tgt = list(data.shape)
    for ax, sz in zip(attrs["axis"], attrs["size"]):
        tgt[ax] = sz
    return torch.broadcast_to(data, tuple(tgt))


def _red_attrs():
    return {"axis": AttrSpec("shape", default=()),
            "keepdims": AttrSpec("bool", default=False),
            "exclude": AttrSpec("bool", default=False)}


def _resolve_axis(attrs, ndim):
    ax = attrs.get("axis", ())
    ax = None if ax is None or ax == () else tuple(
        a % ndim for a in ((ax,) if isinstance(ax, int) else ax))
    if attrs.get("exclude"):
        ax = tuple(i for i in range(ndim) if ax is None or i not in ax)
    return ax


def _prod(data, dim, keepdim):
    """torch.prod takes one axis a call: the axes one by one, last first."""
    for a in sorted(dim, reverse=True):
        data = torch.prod(data, dim=a, keepdim=keepdim)
    return data


def _nanprod(data, dim, keepdim):
    return _prod(torch.where(torch.isnan(data), torch.ones_like(data), data), dim, keepdim)


def _reduce(f):
    def fn(attrs, data):
        ax = _resolve_axis(attrs, data.ndim)
        keep = bool(attrs.get("keepdims", False))
        if ax is None:
            ax = tuple(range(data.ndim))
        if not ax:  # nothing to reduce (a 0-d array, or every axis excluded)
            return data.clone()
        return f(data, dim=ax, keepdim=keep)

    return fn


for _name, _f, _aliases in (("sum", torch.sum, ("sum_axis",)), ("mean", torch.mean, ()),
                            ("prod", _prod, ()), ("nansum", torch.nansum, ()),
                            ("nanprod", _nanprod, ()), ("max", torch.amax, ("max_axis",)),
                            ("min", torch.amin, ("min_axis",))):
    _fn = _reduce(_f)
    _fn.__doc__ = ("Reduce-%s over the given axes (reference: "
                   "broadcast_reduce_op_value.cc)." % _name)
    register(_name, attrs=_red_attrs(), aliases=_aliases)(_fn)


@register("norm")
def _norm(attrs, data):
    """L2 norm of the whole array (reference: broadcast_reduce_op_value.cc norm)."""
    return torch.sqrt(torch.sum(torch.square(data.to(torch.float32)))).to(data.dtype)


def _argminmax(attrs, data, f):
    ax = attrs.get("axis", None)
    if ax is None or ax == ():
        return f(data.reshape(-1), dim=0).to(torch.float32)
    ax = int(ax) if not isinstance(ax, tuple) else int(ax[0])
    return f(data, dim=ax, keepdim=bool(attrs.get("keepdims", False))).to(torch.float32)


def _arg_attrs():
    return {"axis": AttrSpec("any", default=None), "keepdims": AttrSpec("bool", default=False)}


@register("argmax", attrs=_arg_attrs())
def _argmax(attrs, data):
    return _argminmax(attrs, data, torch.argmax)


@register("argmin", attrs=_arg_attrs())
def _argmin(attrs, data):
    return _argminmax(attrs, data, torch.argmin)


@register("argmax_channel")
def _argmax_channel(attrs, data):
    """argmax over axis 1 (reference: broadcast_reduce_op_index.cc)."""
    return torch.argmax(data, dim=1).to(torch.float32)
