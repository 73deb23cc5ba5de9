# copied from mxnet_tpu/module/base_module.py (backend-free)
"""BaseModule: the fit/score/predict contract.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference:
python/mxnet/module/base_module.py:79). The training loop (fit :368) is
intact: bind → init_params → init_optimizer → per-batch
forward_backward/update/update_metric with epoch and batch callbacks, the
training megastep's flush and metric drain at each epoch's end
(``flush_pending_steps``), and the ``io.input_bound_pct`` gauge (the share
of an epoch's wall time spent waiting on the iterator). Under it each batch
is the fused step (``spmd_adapter.py``) or the bound executors' forward and
backward, whose fused sites launch the port's CUDA kernels.
``fit(elastic=...)`` routes to ``module/elastic.py``'s ``ElasticFit``.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple


from .. import metric as metric_mod
from .. import ndarray as nd
from .. import telemetry as _tm
from ..base import MXNetError

BatchEndParam = namedtuple("BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, list) else [obj]


class BaseModule:
    """(reference: base_module.py:79)"""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0

    # ------------------------------------------------------------ properties
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    # ------------------------------------------------------------- contract
    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        self.init_params(
            initializer=None,
            arg_params=arg_params,
            aux_params=aux_params,
            allow_missing=allow_missing,
            force_init=force_init,
        )

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False, force_rebind=False, shared_module=None, grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd", optimizer_params=(("learning_rate", 0.01),), force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()

    # ----------------------------------------------------------- composites
    def forward_backward(self, data_batch):
        """(reference: base_module.py:191)"""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None, score_end_callback=None, reset=True, epoch=0):
        """Evaluate on a data iterator (reference: base_module.py:196)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                batch_end_params = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric, locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(batch_end_params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch, eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """(reference: base_module.py:267)"""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0 : out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True, always_output_list=False):
        """Forward over an iterator, concatenating outputs
        (reference: base_module.py:293)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0 : out.shape[0] - pad].copy() for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, "Cannot merge batches: different number of outputs."
            output_list2 = [
                nd.concatenate([out[i] for out in output_list]) for i in range(num_outputs)
            ]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(
        self,
        train_data,
        eval_data=None,
        eval_metric="acc",
        epoch_end_callback=None,
        batch_end_callback=None,
        kvstore="local",
        optimizer="sgd",
        optimizer_params=(("learning_rate", 0.01),),
        eval_end_callback=None,
        eval_batch_end_callback=None,
        initializer=None,
        arg_params=None,
        aux_params=None,
        allow_missing=False,
        force_rebind=False,
        force_init=False,
        begin_epoch=0,
        num_epoch=None,
        validation_metric=None,
        monitor=None,
        elastic=None,
    ):
        """Train over a data iterator (reference: base_module.py:368).

        ``elastic`` opts into fault-tolerant training: ``True`` or a dict of
        ``ElasticFit`` knobs (``checkpoint_dir``, ``checkpoint_period``,
        ``reseed``, ...). The loop then checkpoints asynchronously off the
        step path and — on an elastic dist job (``MXNET_ELASTIC=1``) —
        survives worker death by pausing, re-forming the process group over
        the survivors and resuming. Returns the ``ElasticFit`` controller
        (check ``.evicted`` on it) instead of None."""
        assert num_epoch is not None, "please specify number of epochs"
        # explicit None/False test: elastic={} is a valid all-defaults knob
        # set and must not fall through to the classic loop
        if elastic is not None and elastic is not False:
            if monitor is not None:
                raise MXNetError(
                    "fit(elastic=) does not support monitor= — per-op "
                    "monitoring and collective re-forms don't mix")
            from .elastic import ElasticFit

            knobs = dict(elastic) if isinstance(elastic, dict) else {}
            return ElasticFit(self, **knobs).fit(
                train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=optimizer, optimizer_params=optimizer_params,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=initializer, arg_params=arg_params,
                aux_params=aux_params, allow_missing=allow_missing,
                force_rebind=force_rebind, force_init=force_init,
                begin_epoch=begin_epoch, num_epoch=num_epoch,
                validation_metric=validation_metric)
        from ..initializer import Uniform

        if initializer is None:
            initializer = Uniform(0.01)

        from ..io import DevicePrefetchIter, device_prefetch_enabled

        if (device_prefetch_enabled()
                and not isinstance(train_data, DevicePrefetchIter)):
            # double-buffered device-side prefetch: batch N+1's fetch and
            # copy onto the module's device overlap step N
            self.logger.info(
                "Module.fit: MXNET_IO_DEVICE_PREFETCH=1 — wrapping the "
                "training iterator in DevicePrefetchIter")
            contexts = getattr(self, "_context", None)
            train_data = DevicePrefetchIter(train_data,
                                            device=contexts[0] if contexts else None)

        self.bind(
            data_shapes=train_data.provide_data,
            label_shapes=train_data.provide_label,
            for_training=True,
            force_rebind=force_rebind,
        )
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(
            initializer=initializer,
            arg_params=arg_params,
            aux_params=aux_params,
            allow_missing=allow_missing,
            force_init=force_init,
        )
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer, optimizer_params=optimizer_params, force_init=force_init)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        warned_input_bound = False
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            # fetch time = what the step pipeline spends WAITING on input
            # (host slicing, queue stalls, blocking transfers) — the
            # io.input_bound_pct numerator. Timed here, at the consumer,
            # so every iterator composition is covered.
            fetch_s = 0.0
            nbatch = -1
            data_source = iter(train_data)
            while True:
                t_fetch = time.perf_counter()
                try:
                    data_batch = next(data_source)
                except StopIteration:
                    break
                fetch_s += time.perf_counter() - t_fetch
                nbatch += 1
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if _tm.enabled():
                    # close the step BEFORE the observers run: Monitor.toc
                    # and Speedometer read this step's registry row
                    _tm.mark_step()
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    batch_end_params = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric, locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(batch_end_params)

            # training megastep (MXNET_TRAIN_MEGASTEP_N>1): dispatch the
            # partial final buffer and drain its metric rows before the
            # epoch metric is logged or validation runs
            flush_pending = getattr(self, "flush_pending_steps", None)
            if flush_pending is not None:
                flush_pending(eval_metric)

            # input-bound fraction of this epoch's wall time
            # (io.input_bound_pct): visible without a trace, warned once per
            # fit past 10%
            epoch_wall = time.time() - tic
            if epoch_wall > 0 and nbatch >= 0:
                input_pct = 100.0 * fetch_s / epoch_wall
                if _tm.enabled():
                    _tm.gauge("io.input_bound_pct").set(round(input_pct, 2))
                if input_pct > 10.0 and not warned_input_bound:
                    warned_input_bound = True
                    self.logger.warning(
                        "input-bound: %.1f%% of epoch %d's wall time was "
                        "spent waiting on the data iterator "
                        "(io.input_bound_pct). Enable device-side prefetch "
                        "(MXNET_IO_DEVICE_PREFETCH=1 / io.DevicePrefetchIter"
                        ") or deepen the prefetch queue so input stops "
                        "gating the step.", input_pct, epoch)

            if getattr(eval_metric, "num_inst", 1):
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            else:
                # a Speedometer with auto_reset cleared the metric on the
                # epoch's last batch — logging 0/0 as 'nan' here would read
                # as divergence; the per-batch lines carry the real values
                self.logger.info(
                    "Epoch[%d] Train metric was reset by a batch callback on "
                    "the last batch; see the preceding Batch lines", epoch)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)

            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)

            if eval_data:
                res = self.score(
                    eval_data,
                    validation_metric,
                    score_end_callback=eval_end_callback,
                    batch_end_callback=eval_batch_end_callback,
                    epoch=epoch,
                )
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)

            train_data.reset()

    # ----------------------------------------------------------- persistence
    def save_params(self, fname):
        """(reference: base_module.py:630). Atomic: temp + ``os.replace``
        — a crash mid-save leaves the previous file, never a torn one."""
        from ..checkpoint import atomic_replace

        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v.as_in_context(v.context) for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v.as_in_context(v.context) for k, v in aux_params.items()})
        with atomic_replace(fname) as tmp:
            nd.save(tmp, save_dict)

    def load_params(self, fname):
        """(reference: base_module.py:645). A torn/partial file raises a
        structured ``MXNetError`` naming ``fname``."""
        from ..checkpoint import load_ndarrays_checked

        save_dict = load_ndarrays_checked(fname)
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)
