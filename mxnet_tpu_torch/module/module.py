"""Module: symbol-backed training module.

Counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py:22) on one context. The JAX package makes its
fused SPMD step only over several devices, a ``dist`` store or
``MXNET_MODULE_FUSED_STEP=1`` (``spmd_adapter.py:318-325``); on one device
it runs the legacy path (``module.py:408-495``), and so does the port:
``forward_backward`` runs the bound executor's forward and backward (the
fused sites launch the port's CUDA kernels), and ``update`` runs the
updater once per parameter on the bound arrays, in place. Several
contexts, a store and ``MXNET_MODULE_FUSED_STEP=1`` need data parallelism
(``ROADMAP.md`` section 1.4) and raise. The default context is
``current_context()``, the card.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from .. import optimizer as opt
from .. import telemetry as _tm
from ..base import MXNetError, anomaly_guard_mode
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..ndarray import zeros
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]

_DATA_PARALLEL = "data parallelism, which the port has not yet (ROADMAP.md section 1.4)"


class Module(BaseModule):
    """(reference: module.py:22)"""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None, fixed_param_names=None,
                 fused_step=True):
        super().__init__(logger=logger)
        self._fused_step_ok = bool(fused_step)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        if len(context) != 1:
            raise MXNetError("Module over %d contexts %s needs %s"
                             % (len(context), list(context), _DATA_PARALLEL))
        self._context = context
        self._work_load_list = work_load_list

        self._symbol = symbol
        arg_names = symbol.list_arguments()
        self._data_names = list(data_names) if data_names else []
        self._label_names = list(label_names) if label_names else []
        for name in self._data_names:
            if name not in arg_names:
                raise MXNetError("data name %r not an argument of the symbol" % name)
        self._label_names = [n for n in self._label_names if n in arg_names]
        self._param_names = [n for n in arg_names
                             if n not in self._data_names and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._fixed_param_names = list(fixed_param_names or [])
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec_group = None
        self._preload_opt_states = None
        self._skipped_steps = 0  # anomaly-guard skips

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """[(name, shape)] of the outputs, inferred from the bound input
        shapes (the port's executor has no outputs before its first
        forward)."""
        assert self.binded
        shapes = {d.name: tuple(d.shape) for d in self._data_shapes + (self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, [tuple(s) for s in out_shapes]))

    # ---------------------------------------------------------------- params
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """(reference: module.py init_params)"""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        ctx = self._context[0]
        if self._arg_params is None:
            self._arg_params = {name: zeros(arr[0].shape, ctx=ctx, dtype=arr[0].dtype)
                                for name, arr in zip(self._param_names,
                                                     self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {name: zeros(arr[0].shape, ctx=ctx, dtype=arr[0].dtype)
                                for name, arr in zip(self._aux_names,
                                                     self._exec_group.aux_arrays)}

        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    arr[:] = cache_arr
            else:
                if not allow_missing and cache is not None:
                    raise RuntimeError("%s is not presented" % name)
                if initializer is not None:
                    initializer(InitDesc(name, attrs.get(name, None)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params, aux_params=aux_params,
                             allow_missing=allow_missing, force_init=force_init)
            return
        if self.params_initialized and not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # --------------------------------------------------------------- binding
    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        """(reference: module.py bind)"""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        if not for_training:
            assert not inputs_need_grad

        self._data_shapes = self._normalize_shapes(data_shapes)
        self._label_shapes = self._normalize_shapes(label_shapes) if label_shapes else None

        shared_group = None
        if shared_module is not None:
            assert (isinstance(shared_module, Module) and shared_module.binded
                    and shared_module.params_initialized)
            shared_group = shared_module._exec_group

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, self._data_shapes,
            self._label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group=shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            # force rebind after params exist: push them to the new executors
            self._exec_group.set_params(self._arg_params, self._aux_params)

    @staticmethod
    def _normalize_shapes(shapes):
        from ..io import DataDesc

        out = []
        for s in shapes:
            if isinstance(s, DataDesc):
                out.append(s)
            elif isinstance(s, tuple) and len(s) == 2:
                out.append(DataDesc(s[0], s[1]))
            else:
                out.append(DataDesc(s.name, s.shape, getattr(s, "dtype", np.float32)))
        return out

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None

    # -------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        """(reference: module.py:432 + model.py:40-77 _create_kvstore)"""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if os.environ.get("MXNET_MODULE_FUSED_STEP", "") == "1" and self._fused_step_ok:
            raise MXNetError("MXNET_MODULE_FUSED_STEP=1: the fused training step "
                             "(module/spmd_adapter.py) comes with " + _DATA_PARALLEL)

        from ..kvstore_helper import create_kvstore

        kvstore_obj, update_on_kvstore = create_kvstore(kvstore, len(self._context),
                                                        self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size

        if isinstance(optimizer, str):
            idx2name = {}
            for k in range(len(self._context)):
                idx2name.update({i * len(self._context) + k: n
                                 for i, n in enumerate(self._param_names)})
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol, param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)

        self._optimizer = optimizer
        self._kvstore = kvstore_obj
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share optimizer/updater with another module (reference:
        module.py borrow_optimizer, used by BucketingModule)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # ------------------------------------------------------------- train step
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """One training step's forward and backward on the bound executor."""
        assert self.binded and self.params_initialized
        self._exec_group.forward_backward(data_batch)

    @property
    def skipped_steps(self):
        """Steps dropped by the NaN/Inf anomaly guard
        (``MXNET_ANOMALY_GUARD=skip``)."""
        return self._skipped_steps

    def _first_nonfinite_grad(self):
        """The first param (symbol order) with a NaN/Inf gradient, or None:
        one check on the device and one read back a gradient (opt-in via
        MXNET_ANOMALY_GUARD)."""
        for name, grads in zip(self._param_names, self._exec_group.grad_arrays):
            for g in grads:
                if g is not None and not bool(g._tensor().isfinite().all()):
                    return name
        return None

    def update(self):
        """(reference: module.py update → model.py _update_params)"""
        assert self.binded and self.params_initialized and self.optimizer_initialized
        guard = anomaly_guard_mode()
        if guard is not None:
            bad = self._first_nonfinite_grad()
            if bad is not None:
                # grad_req='add' ACCUMULATES across steps: leaving NaN in
                # those buffers would make every later step non-finite too
                for name, grads in zip(self._param_names, self._exec_group.grad_arrays):
                    if self._exec_group.grad_req.get(name) == "add":
                        for g in grads:
                            if g is not None:
                                g[:] = 0
                if guard == "raise":
                    raise MXNetError(
                        "anomaly guard: non-finite (NaN/Inf) gradient for "
                        "parameter %r — step NOT applied "
                        "(MXNET_ANOMALY_GUARD=raise)" % bad)
                self._skipped_steps += 1
                if _tm.enabled():
                    _tm.counter("trainer.skipped_steps").inc()
                self.logger.warning(
                    "anomaly guard: dropping this update — non-finite "
                    "gradient, first offending key %r (%d step(s) skipped "
                    "so far)", bad, self._skipped_steps)
                return
        self._params_dirty = True
        from ..kvstore_helper import update_params

        update_params(self._exec_group.param_arrays, self._exec_group.grad_arrays,
                      updater=self._updater, num_device=len(self._context),
                      kvstore=self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)

    # ----------------------------------------------------------- persistence
    def save_optimizer_states(self, fname):
        """The updater's states as one pickle, written atomically (temp +
        ``os.replace``)."""
        assert self.optimizer_initialized
        from ..checkpoint import atomic_write_bytes

        atomic_write_bytes(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Inverse of ``save_optimizer_states``; the states go onto the
        module's context whatever context they were saved from. A torn or
        corrupt file raises a structured ``MXNetError`` naming ``fname``."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            states = f.read()
        try:
            self._updater.set_states(states)
        except Exception as e:
            raise MXNetError(
                "optimizer-state file %r is torn or not a state pickle "
                "(%s: %s) — likely a crash mid-save; delete it and resume "
                "from the previous checkpoint" % (fname, type(e).__name__, e)) from e
        ctx = self._context[0]
        self._updater.states = {k: _on_context(v, ctx) for k, v in self._updater.states.items()}

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """(reference: module.py save_checkpoint)"""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        self.logger.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            self.logger.info('Saved optimizer state to "%s"', state_name)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """(reference: module.py:96). The parameters load onto the module's
        context (``context=``, default ``current_context()``)."""
        from ..model import load_checkpoint

        ctx = kwargs.get("context")
        ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod


def _on_context(state, ctx):
    """An updater state (an NDArray, None, or a tuple of them) on ``ctx``."""
    if isinstance(state, (tuple, list)):
        return type(state)(_on_context(s, ctx) for s in state)
    return state.as_in_context(ctx) if state is not None else None
