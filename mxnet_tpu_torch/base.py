"""Base utilities: the framework error and dtype normalization.

Counterpart of ``mxnet_tpu/base.py``: only ``MXNetError`` and the
numpy-dtype helper the Symbol layer needs, plus the numpy <-> torch dtype
table the port's tensors use.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "np_dtype", "torch_dtype", "numpy_dtype"]


class MXNetError(Exception):
    """Error raised by the framework (reference: python/mxnet/base.py MXNetError)."""


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
    d = np_dtype(dtype)
    if d not in _NP_TO_TORCH:
        raise MXNetError("unsupported dtype %s" % d)
    return _NP_TO_TORCH[d]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype not in _TORCH_TO_NP:
        raise MXNetError("unsupported dtype %s" % dtype)
    return _TORCH_TO_NP[dtype]
