"""Base utilities: the framework error and dtype normalization.

Counterpart of ``mxnet_tpu/base.py``: ``MXNetError``, the numpy-dtype
helper the Symbol layer needs, the ``.params`` type flags
(``dtype_code``/``dtype_from_code``), ``anomaly_guard_mode``
(``MXNET_ANOMALY_GUARD``), plus the numpy <-> torch dtype table the port's
tensors use.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

__all__ = ["MXNetError", "EvictedError", "string_types", "numeric_types", "anomaly_guard_mode",
           "np_dtype", "torch_dtype", "numpy_dtype", "inference_dtype", "dtype_code",
           "dtype_from_code"]


class MXNetError(Exception):
    """Error raised by the framework (reference: python/mxnet/base.py MXNetError)."""


class EvictedError(MXNetError):
    """This worker was evicted from an elastic job (copied from
    mxnet_tpu/base.py): the surviving membership re-formed without it, so
    the only safe move is to stop training and exit."""


# copied from mxnet_tpu/base.py (the reference's type tuples)
string_types = (str,)
numeric_types = (float, int, np.generic)


def np_dtype(dtype) -> np.dtype:
    """Normalize a user-provided dtype (str, numpy or torch dtype) to np.dtype."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        return numpy_dtype(dtype)
    return np.dtype(dtype)


_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy/str/torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":  # the name, where numpy has no bfloat16
        return torch.bfloat16
    d = np_dtype(dtype)
    if d not in _NP_TO_TORCH:
        if d.name == "bfloat16":  # where numpy knows it (ml_dtypes loaded)
            return torch.bfloat16
        raise MXNetError("unsupported dtype %s" % d)
    return _NP_TO_TORCH[d]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype not in _TORCH_TO_NP:
        if dtype == torch.bfloat16:
            try:  # numpy has a bfloat16 where ml_dtypes is loaded
                return np.dtype("bfloat16")
            except TypeError:
                pass
        raise MXNetError("unsupported dtype %s" % dtype)
    return _TORCH_TO_NP[dtype]


def inference_dtype(dtype) -> np.dtype:
    """The numpy dtype that shape and type inference takes for ``dtype`` (a
    torch, numpy or str dtype): its own, and for bfloat16 numpy's bfloat16
    where ``ml_dtypes`` has given numpy one, else float32. Without
    ``ml_dtypes`` numpy has no bfloat16; float32 stands in, since no shape
    depends on it, and a bound tensor keeps its own dtype."""
    if (dtype == torch.bfloat16 if isinstance(dtype, torch.dtype)
            else str(getattr(dtype, "name", dtype)) == "bfloat16"):
        try:
            return np.dtype("bfloat16")
        except TypeError:
            return np.dtype(np.float32)
    return np.dtype(np_dtype(dtype))


# copied from mxnet_tpu/base.py (_DTYPE_NP_TO_MX, dtype_code, dtype_from_code;
# backend-free): the type flags of the reference's .params layout. Code 5
# (bfloat16 there) has no numpy dtype here and is refused.
_DTYPE_NP_TO_MX = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.float16): 2,
    np.dtype(np.uint8): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int64): 6,
    np.dtype(np.bool_): 7,
}
_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}


def dtype_code(dtype) -> int:
    d = np_dtype(dtype)
    if d not in _DTYPE_NP_TO_MX:
        raise MXNetError("unsupported dtype %s" % d)
    return _DTYPE_NP_TO_MX[d]


def dtype_from_code(code: int) -> np.dtype:
    if code not in _DTYPE_MX_TO_NP:
        raise MXNetError("unsupported dtype code %d" % code)
    return _DTYPE_MX_TO_NP[code]


# copied from mxnet_tpu/base.py (anomaly_guard_mode; backend-free)
_warned_anomaly_modes = set()


def anomaly_guard_mode():
    """MXNET_ANOMALY_GUARD: post-backward NaN/Inf gradient guard in the
    training loop. Returns None (off, the default), ``"skip"`` (drop the
    anomalous step: no weight/optimizer/aux update, count it, warn with the
    first offending key) or ``"raise"`` (throw a structured MXNetError
    naming the key; state is left un-updated either way, so a caught raise
    can lower the lr and continue). Unrecognized values warn once and stay
    off."""
    raw = os.environ.get("MXNET_ANOMALY_GUARD", "0").strip().lower()
    if raw in ("", "0", "off", "false", "none", "no"):
        return None
    if raw in ("skip", "raise"):
        return raw
    if raw not in _warned_anomaly_modes:
        _warned_anomaly_modes.add(raw)
        logging.getLogger("mxnet_tpu_torch").warning(
            "MXNET_ANOMALY_GUARD=%r is not one of 0|skip|raise; the "
            "anomaly guard stays OFF", raw)
    return None
