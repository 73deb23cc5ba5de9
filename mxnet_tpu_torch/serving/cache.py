"""Per-bucket executable cache.

Counterpart of ``mxnet_tpu/serving/cache.py`` ``PersistentExecutableCache``
(:109): one bound, inference-only executor per input-shape bucket, made at
warmup, sharing one set of parameter tensors. After ``seal()`` a lookup for
a shape no warmed bucket covers raises, so a server never binds on the
request path. The JAX package compiles at warmup; here warmup runs one
forward, which builds the CUDA kernels at their first launch. There is no
on-disk manifest.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence

from ..base import MXNetError
from ..context import current_context

__all__ = ["PersistentExecutableCache"]


def _shape_key(input_shapes):
    return tuple(sorted((str(n), tuple(int(d) for d in s))
                        for n, s in input_shapes.items()))


class PersistentExecutableCache:
    """One grad-less executor per input-shape bucket.

    ``arg_params`` is {name: numpy array, tensor or NDArray}; every symbol
    argument that is not a param is an INPUT whose shape the bucket key
    carries, allocated as float32 like the serving graphs' inputs. ``ctx``
    defaults to ``gpu(0)`` and is resolved here, so a missing GPU raises at
    construction."""

    def __init__(self, symbol, arg_params=None, ctx=None):
        self._sym = symbol
        self._ctx = ctx or current_context()
        self._ctx.torch_device  # raises now if the device is not there
        self._arg_params = dict(arg_params or {})
        # ONE set of parameter tensors shared by every bucket executor
        self._shared_args: Dict[str, object] = {}
        self._exes: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._sealed = False

    @property
    def input_names(self) -> List[str]:
        return [n for n in self._sym.list_arguments() if n not in self._arg_params]

    @property
    def sealed(self):
        return self._sealed

    def _bind(self, input_shapes):
        from ..base import np_dtype
        from ..ndarray import zeros

        arg_names = self._sym.list_arguments()
        shapes = {n: tuple(s) for n, s in input_shapes.items()}
        types = {}
        for n, v in self._arg_params.items():
            if n in arg_names:  # extra checkpoint entries are ignored
                shapes.setdefault(n, tuple(v.shape))
                types[n] = np_dtype(v.dtype)
        for n in shapes:
            types.setdefault(n, np_dtype("float32"))
        arg_shapes, _, arg_types, _ = self._sym._infer_impl(shapes, types)
        inputs = set(self.input_names)
        args = {}
        for n, s, t in zip(arg_names, arg_shapes, arg_types):
            if n in inputs:  # input slots are per bucket: their shape IS the key
                args[n] = zeros(s, ctx=self._ctx, dtype=t)
                continue
            arr = self._shared_args.get(n)
            if arr is None:
                arr = zeros(s, ctx=self._ctx, dtype=t)
                arr[:] = self._arg_params[n]
                self._shared_args[n] = arr
            args[n] = arr
        return self._sym.bind(self._ctx, args)

    def executable(self, input_shapes):
        """The executor for this exact input-shape bucket; before ``seal()`` a
        new bucket is bound and run once, after it a miss raises."""
        key = _shape_key(input_shapes)
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
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
