"""Optimizer update ops.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (:17-125): ``sgd_update``,
``sgd_mom_update``, ``adam_update``, ``rmsprop_update`` and
``rmspropalex_update`` with ``_prep_grad``'s rescale and clip. They are
plain torch elementwise expressions, as the JAX package's are XLA ones (no
Pallas kernel): each returns the new weight and state, and
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


@register("rmsprop_update",
          attrs=_common({"gamma1": AttrSpec("float", default=0.95),
                         "epsilon": AttrSpec("float", default=1e-8),
                         "clip_weights": AttrSpec("float", default=-1.0)}),
          input_names=("weight", "grad", "n"), num_outputs=2, output_names=("weight", "n"))
def _rmsprop_update(attrs, weight, grad, n):
    g = _prep_grad(grad, attrs) + attrs["wd"] * weight
    g1 = attrs["gamma1"]
    new_n = g1 * n + (1 - g1) * torch.square(g)
    w = weight - attrs["lr"] * g / torch.sqrt(new_n + attrs["epsilon"])
    cw = attrs["clip_weights"]
    if cw is not None and cw > 0:
        w = torch.clamp(w, -cw, cw)
    return w, new_n


@register("rmspropalex_update",
          attrs=_common({"gamma1": AttrSpec("float", default=0.95),
                         "gamma2": AttrSpec("float", default=0.9),
                         "epsilon": AttrSpec("float", default=1e-8),
                         "clip_weights": AttrSpec("float", default=-1.0)}),
          input_names=("weight", "grad", "n", "g", "delta"), num_outputs=4,
          output_names=("weight", "n", "g", "delta"))
def _rmspropalex_update(attrs, weight, grad, n, g_state, delta):
    g = _prep_grad(grad, attrs) + attrs["wd"] * weight
    g1, g2 = attrs["gamma1"], attrs["gamma2"]
    new_n = g1 * n + (1 - g1) * torch.square(g)
    new_g = g1 * g_state + (1 - g1) * g
    new_delta = g2 * delta - attrs["lr"] * g / torch.sqrt(new_n - torch.square(new_g)
                                                          + attrs["epsilon"])
    w = weight + new_delta
    cw = attrs["clip_weights"]
    if cw is not None and cw > 0:
        w = torch.clamp(w, -cw, cw)
    return w, new_n, new_g, new_delta
