# copied from mxnet_tpu/module/bucketing_module.py (backend-free)
"""BucketingModule: one bound executor per bucket shape.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference:
python/mxnet/module/bucketing_module.py:18). Each bucket's Module binds with
``shared_module`` set to the default bucket's, so every bucket's executor
holds the default bucket's parameter, gradient and aux tensors (the
executor group binds over them, ``bind(shared_exec=)``): an update through
any bucket updates all. Over the fused step each bucket's Module derives
its own adapter (``spmd_adapter.derive``): one step (on the card one CUDA
graph) a bucket shape, every bucket's trainer sharing the default bucket's
state cell and graph memory pool.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    """(reference: bucketing_module.py:18)"""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging, context=None, work_load_list=None, fused_step=True):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fused_step = bool(fused_step)
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        res = self._sym_gen(bucket_key)
        if not isinstance(res, tuple):
            return res, ("data",), ("softmax_label",)
        return res

    def get_params(self):
        assert self.binded and self.params_initialized
        # OR, don't overwrite: on the fused path forward_backward() already
        # moved device weights and marked the current module dirty — clearing
        # that here would hand back stale host params
        self._curr_module._params_dirty = (
            self._params_dirty or self._curr_module._params_dirty)
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(
            initializer=initializer,
            arg_params=arg_params,
            aux_params=aux_params,
            allow_missing=allow_missing,
            force_init=force_init,
        )
        self.params_initialized = True
        self._params_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        self.init_params(None, arg_params, aux_params, allow_missing, force_init)

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False, force_rebind=False, shared_module=None, grad_req="write"):
        """Bind the default-bucket module (reference: bucketing_module bind)."""
        assert shared_module is None, "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        symbol, data_names, label_names = self._call_sym_gen(self._default_bucket_key)
        module = Module(
            symbol,
            data_names,
            label_names,
            logger=self.logger,
            context=self._context,
            work_load_list=self._work_load_list,
            fused_step=self._fused_step,
        )
        module.bind(
            data_shapes,
            label_shapes,
            for_training,
            inputs_need_grad,
            force_rebind=False,
            shared_module=None,
            grad_req=grad_req,
        )
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch (bind if new) to a bucket's executor
        (reference: bucketing_module.py switch_bucket)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(
                symbol,
                data_names,
                label_names,
                logger=self.logger,
                context=self._context,
                work_load_list=self._work_load_list,
                fused_step=self._fused_step,
            )
            module.bind(
                data_shapes,
                label_shapes,
                self._curr_module.for_training,
                self._curr_module.inputs_need_grad,
                force_rebind=False,
                shared_module=self._buckets[self._default_bucket_key],
            )
            if self.optimizer_initialized:
                module.borrow_optimizer(self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd", optimizer_params=(("learning_rate", 0.01),), force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params, force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data, data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data, data_batch.provide_label)
        self._curr_module.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)
