"""Neural-network layer ops.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the transformer's paths:
``FullyConnected`` (flatten and ``flatten=False``, weight in the (N, K)
layout), ``Activation``, ``softmax`` and ``SoftmaxOutput``, the training
symbol's head, whose backward is its own loss gradient (an autograd
Function, the JAX package's ``custom_vjp``). A product outside any fused
pattern stays ``torch.matmul``; the other ops differentiate through torch.
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
    """Softmax forward with the cross-entropy gradient on backward, ignoring
    the head gradient exactly like the reference (softmax_output-inl.h)."""
    return _SoftmaxOutput.apply(data, label, attrs)


def _softmax_output_grad(prob, label, attrs):
    """(p − onehot(y))·grad_scale with 'null'|'batch'|'valid' normalization
    (JAX ``_softmax_output_grad``, mxnet_tpu/ops/nn.py:420). A label outside
    [0, C) has an all-zero one-hot row, as ``jax.nn.one_hot`` gives it."""
    multi = attrs["multi_output"] and prob.ndim > 2
    axis = 1 if multi else prob.ndim - 1
    classes = torch.arange(prob.shape[axis], device=prob.device)
    classes = classes.reshape([-1 if i == axis else 1 for i in range(prob.ndim)])
    onehot = (label.long().unsqueeze(axis) == classes).to(prob.dtype)
    grad = prob - onehot
    valid = torch.ones(label.shape, dtype=prob.dtype, device=prob.device)
    if attrs["use_ignore"]:
        keep = (label != attrs["ignore_label"]).to(prob.dtype)
        grad = grad * keep.unsqueeze(axis)
        valid = keep
    norm = attrs["normalization"]
    if norm == "batch":
        grad = grad / label.shape[0]
    elif norm == "valid":
        grad = grad / torch.clamp(valid.sum(), min=1.0)
    return grad * attrs["grad_scale"]


class _SoftmaxOutput(torch.autograd.Function):
    """Class probabilities forward; backward returns the loss gradient and
    ignores the incoming head gradient. The label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        axis = 1 if (attrs["multi_output"] and data.ndim > 2) else -1
        prob = F.softmax(data, dim=axis)
        ctx.save_for_backward(prob, label)
        ctx.attrs = attrs
        return prob

    @staticmethod
    def backward(ctx, grad):
        prob, label = ctx.saved_tensors
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return _softmax_output_grad(prob, label, ctx.attrs), dlabel, None
