"""Build helper for ``libmxtpu_predict.so`` (``csrc/host/predict_api.cc``).

Counterpart of ``mxnet_tpu/predict_api.py``. The library embeds CPython
and serves through ``mxnet_tpu_torch.predictor.Predictor``: C and C++
applications link it beside ``include/mxtpu/c_predict_api.h`` (the
reference's c_predict_api surface, shared with the JAX package). It is
compiled on demand with ``g++`` into ``build/torch_native/``
(``_native_build``). ``MXPredCreate``'s ``dev_type`` is honoured: 1 the
CPU, 2 the card (``c_api.device_context``), which fails naming CUDA when
there is none.
"""
from __future__ import annotations

from ._native_build import build as _build, lib_file, LIBS

__all__ = ["build", "lib_path"]


def lib_path():
    return lib_file(LIBS["predict"][1])


def build(force=False):
    """Compile (if stale) and return the .so path; None if no toolchain."""
    return _build("predict", force=force)
