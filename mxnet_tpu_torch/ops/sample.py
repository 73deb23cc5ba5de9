"""Random sampling ops.

Counterpart of ``mxnet_tpu/ops/sample.py`` (:44-56) for the two samplers
the training trunk draws from: ``random_uniform`` and ``random_normal``,
with their aliases. The JAX package threads a PRNG key through the
registry's ``needs_rng`` slot; here the slot carries a ``torch.Generator``
(``ndarray.imperative_invoke`` passes the generator of the output's device,
``random.generator``), and the draw runs on that generator's device. The
draws are not JAX's bits, only the same distributions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from .registry import AttrSpec, register


def _sample_attrs(**extra):
    base = {
        "shape": AttrSpec("shape", default=()),
        "dtype": AttrSpec("dtype", default=np.float32),
        "ctx": AttrSpec("str", default=""),
    }
    base.update(extra)
    return base


def _reg_sampler(name, attr_extra, draw, aliases=()):
    def fn(attrs, rng=None):
        shape = tuple(attrs["shape"]) or (1,)
        if rng is None:
            # a graph op outside imperative_invoke: the default device's
            from .. import random as _random

            rng = _random.generator(torch.empty(0).device)
        return draw(rng, shape, torch_dtype(attrs["dtype"]), attrs)

    fn.__doc__ = "Draw samples (reference: tensor/sample_op.cc %s)." % name
    register(name, attrs=_sample_attrs(**attr_extra), input_names=(), needs_rng=True,
             aliases=aliases)(fn)


_reg_sampler(
    "random_uniform",
    {"low": AttrSpec("float", default=0.0), "high": AttrSpec("float", default=1.0)},
    lambda g, s, d, a: torch.empty(s, dtype=d, device=g.device).uniform_(a["low"], a["high"],
                                                                       generator=g),
    aliases=("_sample_uniform", "uniform"),
)
_reg_sampler(
    "random_normal",
    {"loc": AttrSpec("float", default=0.0), "scale": AttrSpec("float", default=1.0)},
    lambda g, s, d, a: torch.empty(s, dtype=d, device=g.device).normal_(a["loc"], a["scale"],
                                                                      generator=g),
    aliases=("_sample_normal", "normal"),
)
