"""Broadcasting binary ops and reductions.

Counterpart of ``mxnet_tpu/ops/broadcast_reduce.py``: the broadcast
arithmetic, ``sum``/``mean`` over axes, and ``argmax`` (float32 ids, as
in the JAX package) that the serving graphs use.
"""
from __future__ import annotations

import torch

from .registry import AttrSpec, register

_B2 = ("lhs", "rhs")

_BCAST = {
    "broadcast_add": (torch.add, ("broadcast_plus",)),
    "broadcast_sub": (torch.sub, ("broadcast_minus",)),
    "broadcast_mul": (torch.mul, ()),
}
for _name, (_f, _aliases) in _BCAST.items():
    def _bcast(attrs, lhs, rhs, _f=_f):
        return _f(lhs, rhs)

    register(_name, input_names=_B2, aliases=_aliases)(_bcast)


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


def _reduce(f):
    def fn(attrs, data):
        ax = _resolve_axis(attrs, data.ndim)
        keep = bool(attrs.get("keepdims", False))
        if ax is None:
            out = f(data)
            return out.reshape((1,) * data.ndim) if keep else out
        return f(data, dim=ax, keepdim=keep)

    return fn


register("sum", attrs=_red_attrs(), aliases=("sum_axis",))(_reduce(torch.sum))
register("mean", attrs=_red_attrs())(_reduce(torch.mean))


@register("argmax", attrs={"axis": AttrSpec("any", default=None),
                           "keepdims": AttrSpec("bool", default=False)})
def _argmax(attrs, data):
    ax = attrs.get("axis", None)
    if ax is None or ax == ():
        return torch.argmax(data.reshape(-1), dim=0).to(torch.float32)
    ax = int(ax) if not isinstance(ax, tuple) else int(ax[0])
    return torch.argmax(data, dim=ax, keepdim=bool(attrs.get("keepdims", False))).to(torch.float32)
