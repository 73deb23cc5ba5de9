# copied from mxnet_tpu/module/python_module.py (backend-free)
"""Modules implemented in python, without a bound Symbol.

Counterpart of the reference's python/mxnet/module/python_module.py
(PythonModule :21, PythonLossModule :190): glue modules that sit in a
SequentialModule pipeline (or stand alone) for computation that should stay
on the host — custom losses, metric adapters, debugging taps. They have no
parameters and no bound executor.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .. import ndarray as nd
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A parameterless module whose behavior is defined by overriding
    ``forward``/``backward`` in python (reference: python_module.py:21)."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # ------------------------------------------------------------ parameters
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    # ------------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [
            d if isinstance(d, DataDesc) else DataDesc(*d) for d in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [
                l if isinstance(l, DataDesc) else DataDesc(*l) for l in label_shapes]
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        """Default: one output per output name, same shape as the data
        (override for anything else)."""
        return [DataDesc(name, self._data_shapes[0].shape)
                for name in self._output_names]

    # --------------------------------------------------------------- compute
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        pass

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A pluggable python loss: forward caches the prediction, backward
    produces the input gradient via ``grad_func(scores, labels)``
    (reference: python_module.py:190 PythonLossModule)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"], logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(np.asarray(grad))
            self._scores_grad = grad
        else:
            raise MXNetError("PythonLossModule requires grad_func for backward")

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
