"""Device contexts.

Counterpart of ``mxnet_tpu/context.py``. A ``Context`` names a logical
device, ``cpu(i)`` or ``gpu(i)``, and resolves to a ``torch.device``.
``gpu(i)`` is ``torch.device("cuda", i)`` and nothing else: on a host without
CUDA, resolving it raises. It never moves to the CPU on its own. The default
context is ``gpu(0)``, so an entry point runs on the card unless its caller
passes ``ctx=cpu()``, runs inside ``with cpu():``, which makes ``cpu()``
the default context of its thread for the block, as in the reference, or
names another default in ``MXNET_DEFAULT_CONTEXT`` (``cpu``, ``cpu:1``,
``gpu:0``; ``tools/launch.py --cpu-devices`` sets ``cpu``), as the
reference reads it (JAX ``context.py:125-135``).
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]


class Context:
    """Logical device context (reference: include/mxnet/base.h Context)."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @property
    def torch_device(self) -> torch.device:
        """The concrete ``torch.device``; raises for a GPU that is not there."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%r: CUDA is not available on this host; pass ctx=cpu() to "
                "run on the CPU" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%r: only %d CUDA device(s) present"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def empty_cache(self):
        """Release the caching allocator's unused blocks on this card
        (``torch.cuda.empty_cache``); nothing on the CPU."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.torch_device):
                torch.cuda.empty_cache()


def num_gpus():
    """The CUDA devices present (``torch.cuda.device_count()``)."""
    return torch.cuda.device_count()


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``; resolving it raises where there is none."""
    return Context("gpu", device_id)


def current_context() -> Context:
    """The default context of every entry point: the innermost ``with
    Context`` block's of this thread, else ``MXNET_DEFAULT_CONTEXT``'s
    (``name[:index]``), else ``gpu(0)``. A ``gpu`` default on a host
    without CUDA raises where it is resolved, as any ``gpu(i)`` does."""
    ctx = getattr(Context._default_ctx, "value", None)
    if ctx is not None:
        return ctx
    forced = os.environ.get("MXNET_DEFAULT_CONTEXT", "")
    if forced:
        name, _, idx = forced.partition(":")
        return Context(name, int(idx or 0))
    return gpu(0)
