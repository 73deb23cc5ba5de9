"""Optimizer update ops.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (:17-75): ``sgd_update``,
``sgd_mom_update`` and ``adam_update`` with ``_prep_grad``'s rescale and
clip. They are plain torch elementwise expressions, as the JAX package's
are XLA ones (no Pallas kernel): each returns the new weight and state, and
``ndarray.imperative_invoke`` writes them back into their arrays in place.
"""
from __future__ import annotations

import torch

from .registry import AttrSpec, register


def _common(extra=None):
    d = {
        "lr": AttrSpec("float", required=True),
        "wd": AttrSpec("float", default=0.0),
        "rescale_grad": AttrSpec("float", default=1.0),
        "clip_gradient": AttrSpec("float", default=-1.0),
    }
    d.update(extra or {})
    return d


def _prep_grad(grad, attrs):
    g = grad * attrs["rescale_grad"]
    c = attrs["clip_gradient"]
    if c is not None and c > 0:
        g = torch.clamp(g, -c, c)
    return g


@register("sgd_update", attrs=_common(), input_names=("weight", "grad"))
def _sgd_update(attrs, weight, grad):
    g = _prep_grad(grad, attrs)
    return weight - attrs["lr"] * (g + attrs["wd"] * weight)


@register("sgd_mom_update", attrs=_common({"momentum": AttrSpec("float", default=0.0)}),
          input_names=("weight", "grad", "mom"), num_outputs=2,
          output_names=("weight", "mom"))
def _sgd_mom_update(attrs, weight, grad, mom):
    g = _prep_grad(grad, attrs)
    new_mom = attrs["momentum"] * mom - attrs["lr"] * (g + attrs["wd"] * weight)
    return weight + new_mom, new_mom


@register("adam_update", attrs=_common({"beta1": AttrSpec("float", default=0.9),
                                        "beta2": AttrSpec("float", default=0.999),
                                        "epsilon": AttrSpec("float", default=1e-8)}),
          input_names=("weight", "grad", "mean", "var"), num_outputs=3,
          output_names=("weight", "mean", "var"))
def _adam_update(attrs, weight, grad, mean, var):
    g = _prep_grad(grad, attrs) + attrs["wd"] * weight
    b1, b2 = attrs["beta1"], attrs["beta2"]
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    w = weight - attrs["lr"] * new_mean / (torch.sqrt(new_var) + attrs["epsilon"])
    return w, new_mean, new_var
