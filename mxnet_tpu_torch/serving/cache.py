"""Per-bucket executable cache.

Counterpart of ``mxnet_tpu/serving/cache.py`` ``PersistentExecutableCache``
(:109): one bound, inference-only executor per input-shape bucket, sharing
one set of parameter and aux-state arrays. After ``seal()`` a lookup for a
shape no warmed bucket covers raises, so a server never binds on the
request path; an unsealed cache (the predict API's open-ended ``reshape``)
binds new shapes at any time and, with ``max_executables``, keeps only the
most recently used. The JAX package compiles at warmup; here warmup runs
one forward, which builds the CUDA kernels at their first launch. The
on-disk manifest, ``swap_params`` and ``snapshot_params`` are not part of
the port yet.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..base import MXNetError, np_dtype
from ..context import current_context

__all__ = ["PersistentExecutableCache"]


def _shape_key(input_shapes):
    return tuple(sorted((str(n), tuple(int(d) for d in s))
                        for n, s in input_shapes.items()))


class PersistentExecutableCache:
    """One grad-less executor per input-shape bucket.

    ``arg_params``/``aux_params`` are {name: numpy array, tensor or NDArray};
    every symbol argument that is not a param is an INPUT whose shape the
    bucket key carries, allocated as float32 like the serving graphs' inputs.
    An aux state (BatchNorm's moving stats) the checkpoint lacks stays zero.
    ``ctx`` defaults to ``gpu(0)`` and is resolved here, so a missing GPU
    raises at construction. ``max_executables`` bounds an UNSEALED cache:
    past it the least recently used executor is dropped, so distinct shapes
    cannot grow device memory without limit (None or 0: unbounded; a sealed
    cache has a fixed size and never evicts)."""

    def __init__(self, symbol, arg_params=None, aux_params=None, ctx=None,
                 max_executables=None):
        self._sym = symbol
        self._ctx = ctx or current_context()
        self._ctx.torch_device  # raises now if the device is not there
        self._arg_params = dict(arg_params or {})
        self._aux_params = dict(aux_params or {})
        # ONE set of parameter and aux arrays shared by every bucket executor
        self._shared_args: Dict[str, object] = {}
        self._shared_aux: Optional[Dict[str, object]] = None
        self._max_exes = int(max_executables or 0) or None
        self._exes: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.RLock()
        self._sealed = False
        #: executors bound so far (a hit binds nothing)
        self.binds = 0

    @property
    def input_names(self) -> List[str]:
        return [n for n in self._sym.list_arguments() if n not in self._arg_params]

    @property
    def sealed(self):
        return self._sealed

    def keys(self):
        """The bucket keys held now, least recently used first."""
        with self._lock:
            return list(self._exes)

    def _infer_full(self, input_shapes):
        """Shapes and dtypes of everything at these input shapes (the
        params' come from the checkpoint): no bind, no forward."""
        arg_names = set(self._sym.list_arguments())
        shapes = {n: tuple(s) for n, s in input_shapes.items()}
        types = {}
        for n, v in self._arg_params.items():
            if n in arg_names:  # extra checkpoint entries are ignored
                shapes.setdefault(n, tuple(v.shape))
                types[n] = np_dtype(v.dtype)
        for n in shapes:
            types.setdefault(n, np_dtype("float32"))
        return self._sym._infer_impl(shapes, types)

    def output_shapes(self, input_shapes) -> List[tuple]:
        """Statically inferred output shapes at these input shapes; safe to
        probe batch sizes that are not buckets."""
        return [tuple(s) for s in self._infer_full(input_shapes)[1]]

    def _bind(self, input_shapes):
        from ..ndarray import zeros

        arg_shapes, _, aux_shapes, arg_types, _, aux_types = self._infer_full(input_shapes)
        inputs = set(self.input_names)
        args = {}
        for n, s, t in zip(self._sym.list_arguments(), arg_shapes, arg_types):
            if n in inputs:  # input slots are per bucket: their shape IS the key
                args[n] = zeros(s, ctx=self._ctx, dtype=t)
                continue
            arr = self._shared_args.get(n)
            if arr is None:
                arr = zeros(s, ctx=self._ctx, dtype=t)
                arr[:] = self._arg_params[n]
                self._shared_args[n] = arr
            args[n] = arr
        if self._shared_aux is None:
            self._shared_aux = {}
            for n, s, t in zip(self._sym.list_auxiliary_states(), aux_shapes, aux_types):
                arr = zeros(s, ctx=self._ctx, dtype=t)
                if n in self._aux_params:
                    arr[:] = self._aux_params[n]
                self._shared_aux[n] = arr
        self.binds += 1
        return self._sym.bind(self._ctx, args, args_grad=None, grad_req="null",
                              aux_states=dict(self._shared_aux))

    def executable(self, input_shapes):
        """The executor for this exact input-shape bucket; before ``seal()`` a
        new bucket is bound and run once, after it a miss raises."""
        key = _shape_key(input_shapes)
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
                self._exes.move_to_end(key)
                return exe
            if self._sealed:
                raise MXNetError(
                    "serving: post-warmup executable-cache miss for input shapes %s "
                    "(warmed buckets: %s); a sealed cache never binds on the "
                    "request path" % (dict(input_shapes), [dict(k) for k in self._exes]))
            exe = self._bind(input_shapes)
            exe.forward(is_train=False)
            exe.outputs[0].asnumpy()  # wait for the warmup forward to finish
            self._exes[key] = exe
            if self._max_exes and len(self._exes) > self._max_exes:
                self._exes.popitem(last=False)
            return exe

    def warmup(self, bucket_shapes: Sequence[dict]):
        """Bind and run one executor per bucket ({input_name: shape} dicts),
        then seal. Returns the number of buckets."""
        if not bucket_shapes:
            raise MXNetError("serving: warmup needs at least one bucket (an empty "
                             "sealed cache would reject every request)")
        for shapes in bucket_shapes:
            self.executable(shapes)
        self.seal()
        return len(bucket_shapes)

    def seal(self):
        """Freeze the bucket set: from now on any lookup miss raises."""
        self._sealed = True

    def run(self, inputs: Dict[str, np.ndarray]):
        """One batch through the bucket executable matching the inputs'
        exact shapes. Returns the outputs as numpy arrays."""
        exe = self.executable({n: tuple(v.shape) for n, v in inputs.items()})
        for n, v in inputs.items():
            exe.arg_dict[n][:] = v
        exe.forward(is_train=False)
        return [o.asnumpy() for o in exe.outputs]
