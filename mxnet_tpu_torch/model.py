"""Checkpointing.

Counterpart of ``mxnet_tpu/model.py`` ``save_checkpoint``,
``load_checkpoint``, ``find_last_checkpoint`` and ``resume_or_init``
(:59-178; reference: python/mxnet/model.py:319, :349). A checkpoint is the
reference's two artifacts, ``<prefix>-symbol.json`` and
``<prefix>-NNNN.params``, in the reference's binary layout, so a checkpoint
either package saved loads in the other.

``save_checkpoint`` copies the parameters to the host before it returns
(the fused step's CUDA graph updates them in place at the next step), then
pushes the disk write to the execution engine (``engine.py``) with a write
variable on the prefix, as the JAX package does (``model.py:59-124``):
under ``ThreadedEngine`` the write overlaps training, under
``MXNET_ENGINE_TYPE=NaiveEngine`` it runs before the call returns. The
write is atomic (a temporary file, then ``os.replace``), so a crash
mid-write leaves the previous epoch's file intact. ``load_checkpoint``,
``find_last_checkpoint`` (and so ``resume_or_init``) wait for the prefix's
pending write and raise a failed earlier write's error; ``nd.waitall``
drains every pending write.

``FeedForward`` (JAX :181-376; reference: model.py:387), the sklearn-style
estimator, is a thin adapter over the port's ``Module``: ``fit``,
``predict``, ``score``, ``save``, ``load`` and ``create``.

``_create_kvstore``, ``_initialize_kvstore``, ``_update_params_on_kvstore``
and ``_update_params`` are the reference's names for ``kvstore_helper``'s
functions (JAX :29-43; reference: model.py:40-116), kept here because
training loops import them from ``model``.
"""
from __future__ import annotations

import glob
import logging
import os
import re

import numpy as np

from . import io as mxio
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu

__all__ = ["save_checkpoint", "load_checkpoint", "find_last_checkpoint", "resume_or_init",
           "FeedForward", "_create_kvstore", "_initialize_kvstore",
           "_update_params_on_kvstore", "_update_params"]

from .kvstore_helper import (  # noqa: E402
    create_kvstore as _create_kvstore,
    initialize_kvstore as _initialize_kvstore,
    update_params_on_kvstore as _update_params_on_kvstore,
    update_params as _update_params,
)


# per-prefix engine variables: successive epoch writes to one prefix are
# serialized; readers (load/find_last_checkpoint) wait on the same var. Each
# entry is (engine, var): vars do not survive set_engine_type, and a stale id
# may alias a var the new engine issued, so the engine's identity decides
# (the swap drained the old engine, so a stale entry is dropped)
_ckpt_vars = {}
# a failed write does not vanish: its error is raised at the next
# save/load/find on the same prefix (and logged when it happens)
_ckpt_errors = {}


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``<prefix>-symbol.json`` (unless ``symbol`` is None) and
    ``<prefix>-<epoch:04d>.params`` holding ``arg:<name>`` and ``aux:<name>``
    entries; the values are NDArrays or numpy arrays.

    The values are copied to the host now (the arrays may be updated in
    place by the next step); the disk write is pushed through the execution
    engine with a write variable on the prefix (the reference's
    Engine::Push), so it overlaps training under ThreadedEngine."""
    from . import engine
    from .checkpoint import atomic_replace

    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
    # the host snapshot, on the CPU context, as the JAX package's
    snap = {k: nd.array(v.asnumpy() if isinstance(v, nd.NDArray) else v, ctx=cpu())
            for k, v in save_dict.items()}
    for k, v in snap.items():
        if v.ndim == 0:  # refused now, not by the queued write
            raise MXNetError("cannot save 0-d NDArray %r in the .params format; reshape to "
                             "(1,)" % k)
    param_name = "%s-%04d.params" % (prefix, epoch)
    key = os.path.abspath(prefix)
    _raise_pending_ckpt_error(key)
    eng = engine.get()
    entry = _ckpt_vars.get(key)
    if entry is None or entry[0] is not eng:
        _ckpt_vars[key] = (eng, eng.new_variable())
    var = _ckpt_vars[key][1]

    def write():
        try:
            with atomic_replace(param_name) as tmp:
                nd.save(tmp, snap)
            logging.info('Saved checkpoint to "%s"', param_name)
        except Exception as exc:  # noqa: BLE001  (raised at the next save/load/find)
            logging.error('checkpoint write to "%s" FAILED: %s', param_name, exc)
            _ckpt_errors[key] = exc

    eng.push(write, const_vars=(), mutable_vars=(var,))


def _raise_pending_ckpt_error(key):
    exc = _ckpt_errors.pop(key, None)
    if exc is not None:
        raise MXNetError("earlier async checkpoint write failed: %s" % exc) from exc


def _wait_checkpoint_writes(prefix):
    """Wait for ``prefix``'s pending checkpoint write and raise its error."""
    from . import engine

    key = os.path.abspath(prefix)
    entry = _ckpt_vars.get(key)
    if entry is not None:
        eng, var = entry
        if eng is engine.get():
            eng.wait_for_var(var)
        else:
            # the engine was swapped since the push: set_engine_type drained
            # the old one, so the write has landed
            del _ckpt_vars[key]
    _raise_pending_ckpt_error(key)


def find_last_checkpoint(prefix):
    """Latest saved epoch for ``prefix``, or None (after the prefix's
    pending write has landed)."""
    _wait_checkpoint_writes(prefix)
    best = None
    for path in glob.glob(glob.escape(prefix) + "-*.params"):
        m = re.search(r"-(\d{4,})\.params$", path)
        if m:
            ep = int(m.group(1))
            best = ep if best is None else max(best, ep)
    return best


def resume_or_init(prefix, ctx=None):
    """(begin_epoch, arg_params, aux_params) from the newest checkpoint, or
    (0, None, None) when none exists."""
    last = find_last_checkpoint(prefix)
    if last is None:
        return 0, None, None
    _, arg_params, aux_params = load_checkpoint(prefix, last, ctx=ctx)
    logging.info("Resuming from %s epoch %d", prefix, last)
    return last, arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a saved checkpoint, the params as
    NDArrays on ``ctx`` (default ``current_context()``, the GPU). A torn or
    foreign params file raises an ``MXNetError`` that names the path. Waits
    for the prefix's pending write first."""
    _wait_checkpoint_writes(prefix)
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    path = "%s-%04d.params" % (prefix, epoch)
    try:
        save_dict = nd.load(path, ctx=ctx)
    except MXNetError as e:
        raise MXNetError("checkpoint file %r is corrupt or not an NDArray file (%s)"
                         % (path, e)) from e
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """sklearn-style training wrapper (reference: model.py:387 FeedForward).
    Thin adapter over Module: the reference's _train_multi_device loop is the
    Module fit path here. ``ctx`` defaults to ``current_context()``."""

    def __init__(
        self,
        symbol,
        ctx=None,
        num_epoch=None,
        epoch_size=None,
        optimizer="sgd",
        initializer=None,
        numpy_batch_size=128,
        arg_params=None,
        aux_params=None,
        allow_extra_params=False,
        begin_epoch=0,
        **kwargs,
    ):
        from .context import current_context
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = ctx or [current_context()]
        if not isinstance(self.ctx, list):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._pred_exec = None

    def _init_iter(self, X, y, is_train):
        if isinstance(X, (np.ndarray, nd.NDArray)):
            if y is None:
                if is_train:
                    raise ValueError("y must be specified when X is numpy.ndarray")
                y = np.zeros(X.shape[0] if hasattr(X, "shape") else len(X))
            batch_size = min(self.numpy_batch_size, X.shape[0])
            with self.ctx[0]:  # the iterator's arrays on the model's device
                return mxio.NDArrayIter(X, y, batch_size=batch_size, shuffle=is_train,
                                        last_batch_handle="roll_over" if is_train else "pad")
        return X

    def fit(
        self,
        X,
        y=None,
        eval_data=None,
        eval_metric="acc",
        epoch_end_callback=None,
        batch_end_callback=None,
        kvstore="local",
        logger=None,
        work_load_list=None,
        monitor=None,
        eval_end_callback=None,
        eval_batch_end_callback=None,
    ):
        """(reference: model.py FeedForward.fit)"""
        from .module import Module

        data = self._init_iter(X, y, is_train=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._init_iter(eval_data[0], eval_data[1], is_train=False)

        label_names = [n for n in self.symbol.list_arguments() if n.endswith("label")]
        mod = Module(
            self.symbol,
            data_names=[d.name for d in data.provide_data],
            label_names=label_names,
            logger=logger or logging,
            context=self.ctx,
            work_load_list=work_load_list,
        )
        optimizer_params = dict(self.kwargs)
        if "learning_rate" not in optimizer_params and "lr" in optimizer_params:
            optimizer_params["learning_rate"] = optimizer_params.pop("lr")
        mod.fit(
            data,
            eval_data=eval_data,
            eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback,
            kvstore=kvstore,
            optimizer=self.optimizer,
            optimizer_params=tuple(optimizer_params.items()),
            initializer=self.initializer,
            arg_params=self.arg_params,
            aux_params=self.aux_params,
            allow_missing=True,
            begin_epoch=self.begin_epoch,
            num_epoch=self.num_epoch,
            monitor=monitor,
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
        )
        self.arg_params, self.aux_params = mod.get_params()
        self._module = mod
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """(reference: model.py FeedForward.predict)"""
        data = self._init_iter(X, None, is_train=False)
        from .module import Module

        label_names = [n for n in self.symbol.list_arguments() if n.endswith("label")]
        mod = Module(
            self.symbol,
            data_names=[d.name for d in data.provide_data],
            label_names=label_names,
            context=self.ctx,
        )
        mod.bind(data.provide_data, data.provide_label or None, for_training=False)
        mod.init_params(arg_params=self.arg_params, aux_params=self.aux_params, allow_missing=True)
        outputs = mod.predict(data, num_batch=num_batch, always_output_list=True)
        if len(outputs) == 1:
            return outputs[0].asnumpy()
        return [o.asnumpy() for o in outputs]

    def score(self, X, eval_metric="acc", num_batch=None):
        data = self._init_iter(X, None, is_train=False)
        from .module import Module

        label_names = [n for n in self.symbol.list_arguments() if n.endswith("label")]
        mod = Module(self.symbol, data_names=[d.name for d in data.provide_data], label_names=label_names, context=self.ctx)
        mod.bind(data.provide_data, data.provide_label, for_training=False)
        mod.init_params(arg_params=self.arg_params, aux_params=self.aux_params, allow_missing=True)
        res = mod.score(data, eval_metric, num_batch=num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        """(reference: FeedForward.save)"""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params, self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """(reference: FeedForward.load); the parameters load onto ``ctx``
        (its first context when a list), default ``current_context()``."""
        first = ctx[0] if isinstance(ctx, list) else ctx
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch, ctx=first)
        return FeedForward(
            symbol, ctx=ctx, arg_params=arg_params, aux_params=aux_params, begin_epoch=epoch, **kwargs
        )

    @staticmethod
    def create(
        symbol,
        X,
        y=None,
        ctx=None,
        num_epoch=None,
        epoch_size=None,
        optimizer="sgd",
        initializer=None,
        eval_data=None,
        eval_metric="acc",
        epoch_end_callback=None,
        batch_end_callback=None,
        kvstore="local",
        logger=None,
        work_load_list=None,
        eval_end_callback=None,
        eval_batch_end_callback=None,
        **kwargs,
    ):
        """(reference: FeedForward.create)"""
        model = FeedForward(
            symbol,
            ctx=ctx,
            num_epoch=num_epoch,
            epoch_size=epoch_size,
            optimizer=optimizer,
            initializer=initializer,
            **kwargs,
        )
        model.fit(
            X,
            y,
            eval_data=eval_data,
            eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback,
            kvstore=kvstore,
            logger=logger,
            work_load_list=work_load_list,
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
        )
        return model
