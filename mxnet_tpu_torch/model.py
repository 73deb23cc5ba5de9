"""Checkpointing.

Counterpart of ``mxnet_tpu/model.py`` ``save_checkpoint``,
``load_checkpoint``, ``find_last_checkpoint`` and ``resume_or_init``
(:59-178; reference: python/mxnet/model.py:319, :349). A checkpoint is the
reference's two artifacts, ``<prefix>-symbol.json`` and
``<prefix>-NNNN.params``, in the reference's binary layout, so a checkpoint
either package saved loads in the other.

The write here is synchronous and atomic (a temporary file, then
``os.replace``): when ``save_checkpoint`` returns the file is whole, and a
crash mid-write leaves the previous epoch's file intact. The JAX package
queues the write on its execution engine; that and ``FeedForward`` are not
part of the port yet.
"""
from __future__ import annotations

import glob
import logging
import os
import re

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu

__all__ = ["save_checkpoint", "load_checkpoint", "find_last_checkpoint", "resume_or_init"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``<prefix>-symbol.json`` (unless ``symbol`` is None) and
    ``<prefix>-<epoch:04d>.params`` holding ``arg:<name>`` and ``aux:<name>``
    entries; the values are NDArrays or numpy arrays."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
    # numpy values take the host as their saved context, as the JAX package's
    # host snapshot does
    save_dict = {k: v if isinstance(v, nd.NDArray) else nd.array(v, ctx=cpu())
                 for k, v in save_dict.items()}
    param_name = "%s-%04d.params" % (prefix, epoch)
    tmp = "%s.tmp.%d" % (param_name, os.getpid())
    try:
        nd.save(tmp, save_dict)
        os.replace(tmp, param_name)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    logging.info('Saved checkpoint to "%s"', param_name)


def find_last_checkpoint(prefix):
    """Latest saved epoch for ``prefix``, or None."""
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
    foreign params file raises an ``MXNetError`` that names the path."""
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
