"""Random sampling ops.

Counterpart of ``mxnet_tpu/ops/sample.py``: the ``random_`` samplers
(uniform, normal, gamma, exponential, poisson, negative_binomial,
generalized_negative_binomial) with their aliases, and the multisample
``sample_`` ops, whose distribution parameters are input arrays (output
shape: the parameters' shape + ``shape``). The JAX package threads a PRNG
key through the registry's ``needs_rng`` slot; here the slot carries a
``torch.Generator`` (``ndarray.imperative_invoke`` passes the generator of
the output's device, ``random.generator``; the executor the bind device's),
and every draw runs on that generator's device. The draws are not JAX's
bits, only the same distributions, composed as the JAX samplers compose
them (a negative binomial is a Poisson of a gamma-distributed rate).
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



def _gamma(g, alpha, shape, dtype):
    """Gamma(alpha, 1) draws of ``shape`` (alpha a float or a tensor that
    broadcasts to it)."""
    conc = torch.as_tensor(alpha, dtype=torch.float32, device=g.device).expand(shape)
    return torch._standard_gamma(conc.contiguous(), generator=g).to(dtype)


def _poisson(g, lam, shape, dtype):
    rate = torch.as_tensor(lam, dtype=torch.float32, device=g.device).expand(shape)
    return torch.poisson(rate.contiguous(), generator=g).to(dtype)


def _exponential(g, shape, dtype):
    return torch.empty(shape, dtype=dtype, device=g.device).exponential_(1.0, generator=g)


# the bare name "gamma" is the unary Γ(x) op (elemwise.py), as in the reference
_reg_sampler(
    "random_gamma",
    {"alpha": AttrSpec("float", default=1.0), "beta": AttrSpec("float", default=1.0)},
    lambda g, s, d, a: a["beta"] * _gamma(g, a["alpha"], s, d),
    aliases=("_sample_gamma",),
)
_reg_sampler(
    "random_exponential",
    {"lam": AttrSpec("float", default=1.0)},
    lambda g, s, d, a: _exponential(g, s, d) / a["lam"],
    aliases=("_sample_exponential", "exponential"),
)
_reg_sampler(
    "random_poisson",
    {"lam": AttrSpec("float", default=1.0)},
    lambda g, s, d, a: _poisson(g, a["lam"], s, d),
    aliases=("_sample_poisson", "poisson"),
)


def _neg_binomial(g, s, d, a):
    p = a["p"]
    return _poisson(g, _gamma(g, float(a["k"]), s, torch.float32) * (1.0 - p) / p, s, d)


_reg_sampler(
    "random_negative_binomial",
    {"k": AttrSpec("int", default=1), "p": AttrSpec("float", default=1.0)},
    _neg_binomial,
    aliases=("_sample_negbinomial", "negative_binomial"),
)


def _gen_neg_binomial(g, s, d, a):
    mu, alpha = a["mu"], a["alpha"]
    if alpha <= 0:
        return _poisson(g, mu, s, d)
    r = 1.0 / alpha
    p = r / (r + mu)
    return _poisson(g, _gamma(g, r, s, torch.float32) * (1.0 - p) / p, s, d)


_reg_sampler(
    "random_generalized_negative_binomial",
    {"mu": AttrSpec("float", default=1.0), "alpha": AttrSpec("float", default=1.0)},
    _gen_neg_binomial,
    aliases=("_sample_gennegbinomial", "generalized_negative_binomial"),
)


# ---------------------------------------------------------------- multisample
# JAX mxnet_tpu/ops/sample.py:112-195: one draw over params.shape + shape,
# the parameter arrays broadcast against the trailing sample axes


def _bshape(param, shape):
    return tuple(param.shape) + tuple(shape)


def _expand(param, shape):
    return param.reshape(tuple(param.shape) + (1,) * len(tuple(shape)))


def _reg_multisample(name, input_names, draw):
    def fn(attrs, *inputs, rng=None):
        shape = tuple(attrs["shape"])
        dtype = torch_dtype(attrs["dtype"]) if attrs["dtype"] is not None else inputs[0].dtype
        if rng is None:
            from .. import random as _random

            rng = _random.generator(inputs[0].device)
        return draw(rng, shape, dtype, *inputs)

    fn.__doc__ = ("Per-row parameterized samples (reference: "
                  "tensor/multisample_op.cc %s)." % name)
    register(name, attrs={"shape": AttrSpec("shape", default=()),
                          "dtype": AttrSpec("dtype", default=None)},
             input_names=input_names, needs_rng=True)(fn)


def _uniform01(g, shape, dtype):
    return torch.empty(shape, dtype=dtype, device=g.device).uniform_(generator=g)


def _normal01(g, shape, dtype):
    return torch.empty(shape, dtype=dtype, device=g.device).normal_(generator=g)


_reg_multisample(
    "sample_uniform", ("low", "high"),
    lambda g, s, d, low, high: _expand(low, s) + (_expand(high, s) - _expand(low, s))
    * _uniform01(g, _bshape(low, s), d),
)
_reg_multisample(
    "sample_normal", ("mu", "sigma"),
    lambda g, s, d, mu, sigma: _expand(mu, s) + _expand(sigma, s)
    * _normal01(g, _bshape(mu, s), d),
)
_reg_multisample(
    "sample_gamma", ("alpha", "beta"),
    lambda g, s, d, alpha, beta: _expand(beta, s)
    * _gamma(g, _expand(alpha, s), _bshape(alpha, s), d),
)
_reg_multisample(
    "sample_exponential", ("lam",),
    lambda g, s, d, lam: _exponential(g, _bshape(lam, s), d) / _expand(lam, s),
)
_reg_multisample(
    "sample_poisson", ("lam",),
    lambda g, s, d, lam: _poisson(g, _expand(lam, s), _bshape(lam, s), d),
)


def _ms_negbinomial(g, s, d, kparam, p):
    pe = _expand(p, s)
    lam = _gamma(g, _expand(kparam, s), _bshape(kparam, s), torch.float32) * (1.0 - pe) / pe
    return _poisson(g, lam, _bshape(kparam, s), d)


_reg_multisample("sample_negative_binomial", ("k", "p"), _ms_negbinomial)


def _ms_gen_negbinomial(g, s, d, mu, alpha):
    r = 1.0 / torch.clamp(_expand(alpha, s), min=1e-8)
    p = r / (r + _expand(mu, s))
    lam = _gamma(g, r, _bshape(mu, s), torch.float32) * (1.0 - p) / p
    return _poisson(g, lam, _bshape(mu, s), d)


_reg_multisample("sample_generalized_negative_binomial", ("mu", "alpha"),
                 _ms_gen_negbinomial)
