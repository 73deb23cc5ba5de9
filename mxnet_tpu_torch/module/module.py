"""Module: symbol-backed training module.

Counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py:22). Binding makes a
``DataParallelExecutorGroup`` with one executor per context. Two execution
strategies, as in the JAX package:

* the fused step (``spmd_adapter.py``), engaged by ``init_optimizer``
  whenever the Module has several distinct contexts, a ``dist*`` sync
  store, or ``MXNET_MODULE_FUSED_STEP=1`` (``fused_step=False`` or
  ``MXNET_MODULE_FUSED_STEP=0`` opts out): ``forward_backward`` runs
  forward, backward, the gradient sum and the update as one step, on the
  card one CUDA graph, and ``update`` only checks that it ran;
* the per-device path (``module.py:408-495``): ``forward_backward`` runs
  each executor's forward and backward (the fused sites launch the port's
  CUDA kernels), and ``update`` either pushes the gradients through the
  store, which sums them across contexts and workers and runs the
  optimizer (``update_on_kvstore``), or reduces them through the store and
  runs the updater on each context's arrays in place. A parameter whose
  producer declares a row-sparse gradient (``SparseEmbedding``,
  ``Embedding(sparse_grad=True)``) takes the store's sparse round and lazy
  update there; the fused step's gradients are dense, as JAX's are.

The default context is ``current_context()``.
"""
from __future__ import annotations

import logging

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


class Module(BaseModule):
    """(reference: module.py:22)"""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None, fixed_param_names=None,
                 fused_step=True):
        super().__init__(logger=logger)
        # fused_step=False keeps the per-device + kvstore execution
        self._fused_step_ok = bool(fused_step)
        self._spmd = None
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        self._context = list(context)
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
        self._exec_version = None  # the fused step's params version the executors hold

        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec_group = None
        self._preload_opt_states = None
        self._skipped_steps = 0  # anomaly-guard skips on the per-device path

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
        if self._spmd is not None:
            # the trainer's tensors are the params: the executors only
            # hold them as of their last refresh
            self._spmd.export_params(self._arg_params, self._aux_params)
        else:
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
        if self._spmd is not None:
            # params (re)loaded after the fused step was set up: the trainer
            # copies them into its tensors
            self._spmd.adopt_params(self._arg_params, self._aux_params)
            self._exec_version = self._spmd.params_version

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
        if self._spmd is not None:
            self._spmd.adopt_params(arg_params or {}, aux_params or {})

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
        from ..kvstore_helper import create_kvstore

        kvstore_obj, update_on_kvstore = create_kvstore(kvstore, len(self._context),
                                                        self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore_obj and "dist" in kvstore_obj.type and "_sync" in kvstore_obj.type:
            batch_size *= kvstore_obj.num_workers
        rescale_grad = 1.0 / batch_size

        if isinstance(optimizer, str):
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._param_names))
            else:
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
        self._updater = None

        # several distinct contexts (or a dist sync store): forward, backward
        # and the update as one fused step, on the card one CUDA graph
        from . import spmd_adapter

        self._spmd = spmd_adapter.try_create(self, kvstore_obj)
        if self._spmd is not None:
            self.logger.info(
                "Module: fused SPMD step active over %d device(s)%s",
                self._spmd.trainer.mesh.size,
                " (multi-process)" if self._spmd.trainer._spans_processes else "")
            self._update_on_kvstore = False
            self.optimizer_initialized = True
            if self._preload_opt_states is not None:
                self.load_optimizer_states(self._preload_opt_states)
                self._preload_opt_states = None
            return

        if kvstore_obj:
            # the initialized params go into the store; updates flow through it
            from ..kvstore_helper import initialize_kvstore

            initialize_kvstore(kvstore=kvstore_obj, param_arrays=self._exec_group.param_arrays,
                               arg_params=self._arg_params, param_names=self._param_names,
                               update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore_obj.set_optimizer(self._optimizer)
        else:
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
        if shared_module._spmd is not None:
            # bucketing over the fused step: this bucket gets its own step
            # for its shapes, sharing the donor's state cell
            from . import spmd_adapter

            self._spmd = spmd_adapter.derive(self, shared_module._spmd)
            if self._spmd is None:
                raise MXNetError(
                    "bucket module cannot share the fused SPMD step (see "
                    "warning above); rebuild the BucketingModule with "
                    "fused_step=False or set MXNET_MODULE_FUSED_STEP=0")
            self._update_on_kvstore = False
        self.optimizer_initialized = True

    # ------------------------------------------------------------- train step
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if self._spmd is not None:
            # batches still buffered for a training megastep land before a
            # plain forward reads the params
            self._spmd.flush()
            version = self._spmd.params_version
            if version != self._exec_version:
                # the fused step (through this module or a bucket sharing its
                # state) wrote the trainer's tensors: refresh the executors
                self._sync_params_from_devices()
                self._exec_group.set_params(self._arg_params, self._aux_params)
                self._exec_version = version
            # this forward's outputs now own get_outputs/update_metric; the
            # undrained train metric pairs must not leak into a validation
            # metric (fit() drains them via flush_pending_steps first)
            self._spmd._outputs = None
            self._spmd._metric_pairs = []
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """One training step's forward and backward on the bound executor;
        with the fused step, forward, backward and the update as one step."""
        assert self.binded and self.params_initialized
        if self._spmd is not None:
            self._params_dirty = True
            self._spmd.step(data_batch)
            return
        self._exec_group.forward_backward(data_batch)

    @property
    def skipped_steps(self):
        """Steps dropped by the NaN/Inf anomaly guard
        (``MXNET_ANOMALY_GUARD=skip``): the fused step's on its trainer,
        the per-device path's here."""
        if self._spmd is not None:
            return self._spmd.trainer.skipped_steps
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
        if self._spmd is not None:
            if not self._spmd.consume_pending_step():
                # a manual forward()/backward() ran through the exec group:
                # the fused step never fired, so returning would train nothing
                raise MXNetError(
                    "update() without forward_backward() in fused-SPMD mode: "
                    "use forward_backward(), or build the Module with "
                    "fused_step=False (or MXNET_MODULE_FUSED_STEP=0) for the "
                    "manual forward/backward/update loop")
            return  # the optimizer already ran inside the fused step
        guard = anomaly_guard_mode()
        if guard is not None and self._kvstore is not None and "dist" in self._kvstore.type:
            # a rank-LOCAL skip would desynchronize the gradient collective
            if not getattr(self, "_warned_guard_dist", False):
                self._warned_guard_dist = True
                self.logger.warning(
                    "MXNET_ANOMALY_GUARD is ignored with a dist kvstore: a rank-local "
                    "skip would desync the collective.")
            guard = None
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
        if self._update_on_kvstore:
            from ..kvstore_helper import update_params_on_kvstore

            update_params_on_kvstore(self._exec_group.param_arrays,
                                     self._exec_group.grad_arrays, self._kvstore,
                                     priorities=self._exec_group.param_priorities,
                                     sparse_indices=self._sparse_grad_indices())
        else:
            from ..kvstore_helper import update_params

            update_params(self._exec_group.param_arrays, self._exec_group.grad_arrays,
                          updater=self._updater, num_device=len(self._context),
                          kvstore=self._kvstore,
                          priorities=self._exec_group.param_priorities)

    def _sparse_grad_indices(self):
        """Indices of the params whose producer declared a row-sparse
        gradient (``sparse.sparse_param_names``), resolved once (JAX
        :455-495)."""
        sparse_idx = getattr(self, "_sparse_grad_idx", None)
        if sparse_idx is None:
            from ..sparse import sparse_param_names

            names = set(sparse_param_names(self._symbol))
            sparse_idx = frozenset(i for i, n in enumerate(self._param_names) if n in names)
            self._sparse_grad_idx = sparse_idx
        return sparse_idx

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._spmd is not None and self._spmd._outputs is not None:
            outs = self._spmd.get_outputs()
            return outs if merge_multi_context else [[o] for o in outs]
        return self._exec_group.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._spmd is not None and self._spmd.update_metric(eval_metric, labels):
            return
        self._exec_group.update_metric(eval_metric, labels)

    def flush_pending_steps(self, eval_metric=None):
        """Dispatch batches still buffered for a training megastep
        (``MXNET_TRAIN_MEGASTEP_N`` > 1) and, when ``eval_metric`` is given,
        drain their metric rows. fit() calls this at each epoch tail so a
        partial final buffer still trains and still scores."""
        if self._spmd is None or self._spmd._megastep_n <= 1:
            return
        self._spmd.flush()
        if eval_metric is not None:
            self._spmd.drain_metric(eval_metric)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor_installed = True
        if self._spmd is not None:
            self.logger.warning(
                "Monitor stats are not collected by the fused SPMD step; "
                "build the Module with fused_step=False to monitor per-op "
                "outputs")
        self._exec_group.install_monitor(mon)

    # ----------------------------------------------------------- persistence
    def save_optimizer_states(self, fname):
        """The updater's states as one pickle, written atomically (temp +
        ``os.replace``); through the store's when the store runs the
        optimizer."""
        assert self.optimizer_initialized
        from ..checkpoint import atomic_write_bytes

        if self._spmd is not None:
            atomic_write_bytes(fname, self._spmd.get_states())
        elif self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            atomic_write_bytes(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Inverse of ``save_optimizer_states``; a file the JAX package wrote
        loads too (``convert.load_states``). The states of key
        ``index * num_device + k`` go onto context k, whatever context they
        were saved from. A torn or corrupt file raises a structured
        ``MXNetError`` naming ``fname``."""
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._spmd is None:
            self._kvstore.load_optimizer_states(fname)
            return
        from ..convert import load_states, states_on_context

        with open(fname, "rb") as f:
            blob = f.read()
        if self._spmd is not None:
            try:
                self._spmd.set_states(blob)
            except Exception as e:
                raise MXNetError(
                    "optimizer-state file %r is torn or not a fused-step state pickle "
                    "(%s: %s) — likely a crash mid-save; delete it and resume "
                    "from the previous checkpoint" % (fname, type(e).__name__, e)) from e
            return
        try:
            states = load_states(blob)
        except Exception as e:
            raise MXNetError(
                "optimizer-state file %r is torn or not a state pickle "
                "(%s: %s) — likely a crash mid-save; delete it and resume "
                "from the previous checkpoint" % (fname, type(e).__name__, e)) from e
        n = len(self._context)
        self._updater.states = {k: states_on_context(v, self._context[k % n])
                                for k, v in states.items()}

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

