"""Deployment predictor: minimal inference API over a saved checkpoint.

Counterpart of ``mxnet_tpu/predictor.py`` (reference: the C predict API,
include/mxnet/c_predict_api.h: MXPredCreate / MXPredSetInput /
MXPredForward / MXPredGetOutput / MXPredReshape). Executors come from the
serving subsystem's ``PersistentExecutableCache``, unsealed: one bound
executor per input-shape set, made at first use, all sharing one set of
parameter arrays on the device. ``reshape()`` back to a shape seen before
reuses its executor and binds nothing.

    pred = Predictor(open("m-symbol.json").read(), open("m-0010.params", "rb").read(),
                     {"data": (1, 3, 224, 224)})
    pred.forward(data=batch)
    probs = pred.get_output(0)

It runs on ``gpu(0)`` unless ``ctx`` says otherwise.
"""
from __future__ import annotations

import io
import os
from typing import Dict, Sequence

import numpy as np

from .base import MXNetError
from .context import current_context
from . import ndarray as nd
from . import symbol as sym
from .serving import PersistentExecutableCache

__all__ = ["Predictor", "load_ndarray_file"]


def load_ndarray_file(binary: bytes, ctx=None):
    """Parse a .params blob into {name: NDArray} on ``ctx`` (reference:
    MXNDListCreate, c_predict_api.cc)."""
    return nd._load_stream(io.BytesIO(binary), ctx, what="<bytes>")


# copied from mxnet_tpu/serving/engine.py (_env_int, backend-free)
def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return int(default)


class Predictor:
    """(reference: c_predict_api.h MXPredCreate → PredictorHandle)"""

    def __init__(self, symbol_json: str, param_bytes: bytes,
                 input_shapes: Dict[str, Sequence[int]], ctx=None, output_names=None):
        net = sym.load_json(symbol_json)
        if output_names:  # MXPredCreatePartialOut semantics
            outputs = net.list_outputs()
            chosen = []
            for name in output_names:
                if name not in outputs:
                    raise MXNetError("output %r not in %s" % (name, outputs))
                chosen.append(net[outputs.index(name)])
            net = sym.Group(chosen)
        self._sym = net
        self._ctx = ctx or current_context()
        params = load_ndarray_file(param_bytes, self._ctx) if param_bytes else {}
        # the saved dict uses the reference's "arg:name"/"aux:name" prefixes
        arg_params, aux_params = {}, {}
        for k, v in params.items():
            if k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k[4:] if k.startswith("arg:") else k] = v
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        # unsealed: the predict API allows new shapes at any time, each bound
        # once. MXNET_SERVE_MAX_EXECUTABLES (default 8, 0 = unbounded) bounds
        # the executors kept, least recently used dropped first, so a
        # reshape-heavy workload cannot grow device memory without limit
        self._cache = PersistentExecutableCache(
            net, arg_params, aux_params, ctx=self._ctx,
            max_executables=_env_int("MXNET_SERVE_MAX_EXECUTABLES", 8))
        self._exe = self._cache.executable(dict(self._input_shapes))

    def set_input(self, key, data):
        """(reference: MXPredSetInput) ``data`` is numpy (copied to the
        device) or an NDArray (one on the card is copied there, not through
        the host); its shape must be the bound one."""
        if key not in self._input_shapes:
            raise MXNetError("unknown input %r" % key)
        if not isinstance(data, nd.NDArray):
            data = np.asarray(data, np.float32)
        if tuple(data.shape) != self._input_shapes[key]:
            raise MXNetError("input %r: shape %s, bound as %s; reshape() first"
                             % (key, tuple(data.shape), self._input_shapes[key]))
        self._exe.arg_dict[key][:] = data

    def forward(self, **inputs):
        """(reference: MXPredForward; kwargs are a convenience over
        set_input + forward)"""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._exe.forward(is_train=False)

    def reshape(self, new_input_shapes):
        """(reference: MXPredReshape) switch to the executor for the new
        shapes. A shape set seen before (and not dropped since) reuses its
        executor; a new one binds once. Every executor reads the same
        parameter arrays."""
        for k in new_input_shapes:
            if k not in self._input_shapes:
                raise MXNetError("unknown input %r" % k)
        self._input_shapes.update({k: tuple(v) for k, v in new_input_shapes.items()})
        self._exe = self._cache.executable(dict(self._input_shapes))

    def get_output(self, index) -> np.ndarray:
        """(reference: MXPredGetOutput: copies out to the host, which waits
        for the forward)"""
        return self._exe.outputs[index].asnumpy()

    @property
    def num_outputs(self):
        return len(self._exe.outputs)

    @property
    def input_shapes(self):
        """The bound input shapes."""
        return dict(self._input_shapes)

    @property
    def executables_bound(self):
        """Executors bound so far: a ``reshape`` to a kept shape adds none."""
        return self._cache.binds
