# copied from mxnet_tpu/initializer.py (backend-free; FusedRNN._init_weight raises)
"""Weight initializers.

Counterpart of the reference's python/mxnet/initializer.py: an Initializer is
called with (InitDesc/name, NDArray) and dispatches on the name suffix
(weight/bias/gamma/beta/moving_* ...), with ``__init__`` attrs on variables
overriding the default (attr-driven dispatch, initializer.py InitDesc).
Random draws go through the port's samplers on the array's own device, from
that device's generator (``random.py``), so ``random.seed`` makes them
reproducible; they are not the JAX package's bits. ``Orthogonal`` draws on
the host with numpy from a seed taken from the CPU generator, as JAX does
from its key.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np

from .base import MXNetError
from . import ndarray as nd
from . import random as _random

__all__ = [
    "InitDesc",
    "Initializer",
    "Uniform",
    "Normal",
    "Zero",
    "One",
    "Constant",
    "Orthogonal",
    "Xavier",
    "MSRAPrelu",
    "Bilinear",
    "LSTMBias",
    "FusedRNN",
    "Mixed",
    "Load",
    "register",
    "create",
]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, *args, **kwargs):
    if isinstance(name, Initializer):
        return name
    if name.lower() not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[name.lower()](*args, **kwargs)


class InitDesc(str):
    """Name + attrs descriptor handed to initializers (reference: InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base: dispatch by variable-name convention, like the reference."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            klass, kwargs = json.loads(desc.attrs["__init__"])
            create(klass, **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("upsampling"):
            self._init_bilinear(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("label"):
            # a label variable bound as a param (Module(label_names=None) for
            # inference, the reference's benchmark_score pattern) — zeros
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    # --- leaf initializers ------------------------------------------------
    def _init_bilinear(self, _, arr):
        # separable triangle filter over the trailing H×W plane, tiled over
        # the leading dims (vectorized; the reference fills element-wise)
        h, w = arr.shape[2], arr.shape[3]
        f = np.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        wx = 1.0 - np.abs(np.arange(w) / f - c)
        wy = 1.0 - np.abs(np.arange(h) / f - c)
        arr[:] = np.broadcast_to(np.outer(wy, wx), arr.shape)

    # constant-fill family (aux moving stats, biases, BN gamma/beta): one
    # factory, six bindings — subclasses may still override any name
    def _const_fill(value):  # noqa: N805 — class-body factory, not a method
        def _impl(self, _desc, arr):
            arr[:] = value

        return _impl

    _init_zero = _init_bias = _init_beta = _const_fill(0.0)
    _init_one = _init_gamma = _const_fill(1.0)
    del _const_fill

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization is now "
            "limited to %r. Name a variable with one of those suffixes or set its "
            "init attr explicitly." % (name, '"weight", "bias", "gamma", "beta"')
        )


@register
class Load:
    """Init from a dict of arrays (checkpoint), falling back to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {
            k[4:] if k.startswith("arg:") or k.startswith("aux:") else k: v
            for k, v in param.items()
        }
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if tuple(arr.shape) != tuple(self.param[name].shape):
                raise MXNetError(
                    "Parameter %s cannot be initialized from loading: shape %s vs %s"
                    % (name, arr.shape, self.param[name].shape)
                )
            arr[:] = self.param[name]
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise MXNetError(
                    "Cannot Initialize %s. Not found in loaded param and no default init" % name
                )
            self.default_init(name, arr)


@register
class Mixed:
    """Regex-pattern → initializer table (reference: Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have the same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError("Parameter name %s did not match any pattern" % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0

    def _init_default(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0

    def _init_default(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value

    def _init_default(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale) weights (reference: Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = nd.random_uniform(low=-self.scale, high=self.scale, shape=arr.shape, ctx=arr.context)


@register
class Normal(Initializer):
    """N(0, sigma) weights (reference: Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = nd.random_normal(loc=0.0, scale=self.sigma, shape=arr.shape, ctx=arr.context)


@register
class Orthogonal(Initializer):
    """Orthogonal matrix init via SVD/QR (reference: Orthogonal, Saxe et al.)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        rs = np.random.RandomState(_random._next_seed())
        if self.rand_type == "uniform":
            tmp = rs.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = rs.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape).astype(np.float32)


@register
class Xavier(Initializer):
    """Glorot init (reference: initializer.py:344)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factors = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                   "out": fan_out}
        if self.factor_type not in factors:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factors[self.factor_type])
        if self.rnd_type == "uniform":
            arr[:] = nd.random_uniform(low=-scale, high=scale, shape=arr.shape, ctx=arr.context)
        elif self.rnd_type == "gaussian":
            arr[:] = nd.random_normal(loc=0.0, scale=scale, shape=arr.shape, ctx=arr.context)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """Kaiming/He init for PReLU nets (reference: MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    def _init_weight(self, _, arr):
        self._init_bilinear(_, arr)


@register
class LSTMBias(Initializer):
    """Forget-gate bias init (reference: LSTMBias); gate order [i, f, c, o]."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden : 2 * num_hidden] = self.forget_bias
        arr[:] = b

    def _init_default(self, name, arr):
        self._init_weight(name, arr)


@register
class FusedRNN(Initializer):
    """Init the packed parameter vector of the fused RNN op by unpacking it,
    running ``init`` per block, and repacking (reference: FusedRNN)."""

    def __init__(self, init, num_hidden, num_layers, mode, bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(
            init=init.dumps() if init is not None else None,
            num_hidden=num_hidden,
            num_layers=num_layers,
            mode=mode,
            bidirectional=bidirectional,
            forget_bias=forget_bias,
        )
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    # copied from mxnet_tpu/initializer.py (FusedRNN._init_weight :354, backend-free)
    def _init_weight(self, desc, arr):
        from .rnn.rnn_cell import FusedRNNCell

        cell = FusedRNNCell(
            self._num_hidden,
            self._num_layers,
            self._mode,
            self._bidirectional,
            forget_bias=self._forget_bias,
            prefix="",
        )
        args = cell.unpack_weights({"parameters": arr.copy()})
        for name in args:
            desc_i = InitDesc(name, getattr(desc, "attrs", {}))
            if self._mode == "lstm" and name.endswith("_f_bias"):
                args[name][:] = self._forget_bias
            elif self._init is not None:
                self._init(desc_i, args[name])
        arr[:] = cell.pack_weights(args)["parameters"]
