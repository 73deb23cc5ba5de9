"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` for the dense update path
(:126-347, :433-470, :583-625): ``Optimizer`` with the reference's registry,
per-parameter lr/wd multipliers and per-key update counts; ``SGD`` (with
momentum) and ``Adam`` (host-side bias-corrected lr); ``create``,
``register``, ``Updater`` and ``get_updater``. Each update is one op of
``ops/optimizer_ops.py`` run through ``ndarray.imperative_invoke``, which
writes the new weight and state into their arrays in place. Learning-rate
schedules and multipliers read from symbol attributes come with ``Module``.
"""
from __future__ import annotations

import math

from .ndarray import imperative_invoke, zeros

__all__ = ["Optimizer", "SGD", "Adam", "create", "register", "get_updater", "Updater"]


class Optimizer:
    """Base optimizer with the reference's registry / lr&wd-mult machinery."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise ValueError("Cannot find optimizer %s" % name)
        return Optimizer.opt_registry[name.lower()](**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise TypeError("param_idx2name should be a dict of param indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    # ----------------------------------------------------------------- mults
    def set_lr_mult(self, args_lr_mult):
        """Per-parameter lr multipliers, by name or index."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-parameter wd multipliers, by name or index; every parameter
        whose name does not end in ``_weight`` or ``_gamma`` (biases, betas:
        the 1-D ones) gets wd 0, as in the reference."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(args_wd_mult)

    # ------------------------------------------------------------- schedules
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1

    def _get_lr(self, index):
        lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common_attrs(self, lr, wd):
        attrs = {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            attrs["clip_gradient"] = self.clip_gradient
        return attrs


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum, on the sgd_update / sgd_mom_update ops."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(self._get_lr(index), self._get_wd(index))
        if state is not None:
            attrs["momentum"] = self.momentum
            imperative_invoke("sgd_mom_update", [weight, grad, state], attrs, out=[weight, state])
        else:
            imperative_invoke("sgd_update", [weight, grad], attrs, out=[weight])


@register
class Adam(Optimizer):
    """Adam with the reference's bias-corrected effective lr, folded on the
    host, on the adam_update op."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),  # mean
                zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))  # var

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        attrs = self._common_attrs(lr, wd)
        attrs.update(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
        imperative_invoke("adam_update", [weight, grad, mean, var], attrs,
                          out=[weight, mean, var])


class Updater:
    """Applies an optimizer per key with lazily created state."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
