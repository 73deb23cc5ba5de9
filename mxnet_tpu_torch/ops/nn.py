"""Neural-network layer ops.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the serving slice:
``FullyConnected`` (flatten and ``flatten=False``, weight in the (N, K)
layout), ``Activation``, ``softmax`` and the forward of ``SoftmaxOutput``
(the training symbol's head; its loss gradient comes with the training
slice). A product outside any fused pattern stays ``torch.matmul``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import AttrSpec, register


def _fc_names(attrs):
    return ["data", "weight"] if attrs.get("no_bias") else ["data", "weight", "bias"]


@register("FullyConnected", attrs={"num_hidden": AttrSpec("int", required=True),
                                   "no_bias": AttrSpec("bool", default=False),
                                   "flatten": AttrSpec("bool", default=True)},
          input_names=_fc_names)
def _fully_connected(attrs, data, weight, bias=None):
    """y = x · Wᵀ + b; ``flatten=False`` applies over the last axis."""
    if attrs.get("flatten", True) and data.ndim != 2:
        data = data.reshape(data.shape[0], -1)
    y = torch.matmul(data, weight.t())
    if bias is not None:
        y = y + bias
    return y


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # logaddexp(x, 0), as jnp.logaddexp computes it
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)),
}


@register("Activation", attrs={"act_type": AttrSpec("str", required=True)})
def _activation(attrs, data):
    t = attrs["act_type"]
    if t not in _ACTS:
        raise MXNetError("unknown act_type %r" % t)
    return _ACTS[t](data)


@register("softmax", attrs={"axis": AttrSpec("int", default=-1),
                            "temperature": AttrSpec("any", default=None)})
def _softmax(attrs, data):
    t = attrs.get("temperature")
    if t not in (None, "None"):
        data = data / float(t)
    return F.softmax(data, dim=attrs["axis"])


@register("SoftmaxOutput", attrs={"grad_scale": AttrSpec("float", default=1.0),
                                  "ignore_label": AttrSpec("float", default=-1.0),
                                  "multi_output": AttrSpec("bool", default=False),
                                  "use_ignore": AttrSpec("bool", default=False),
                                  "preserve_shape": AttrSpec("bool", default=False),
                                  "normalization": AttrSpec("str", default="null"),
                                  "out_grad": AttrSpec("bool", default=False)},
          input_names=("data", "label"), aliases=("Softmax",))
def _softmax_output(attrs, data, label):
    """The forward of the reference's softmax loss head: class probabilities."""
    axis = 1 if (attrs["multi_output"] and data.ndim > 2) else -1
    return F.softmax(data, dim=axis)
