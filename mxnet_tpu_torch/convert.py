"""Parameters from the JAX package (or any numpy source) into the port.

The names are identical in both packages, and so is the FullyConnected
weight layout (N, K), so conversion is a copy onto the target device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .context import Context, current_context

__all__ = ["params_from_numpy"]


def params_from_numpy(arg_params, ctx: Context = None) -> Dict[str, torch.Tensor]:
    """{name: array} (numpy, or anything with ``asnumpy()``) → {name: tensor}
    on ``ctx`` (default ``gpu(0)``), with each array's dtype kept."""
    device = (ctx or current_context()).torch_device
    out = {}
    for name, value in arg_params.items():
        host = np.ascontiguousarray(value.asnumpy() if hasattr(value, "asnumpy") else value)
        out[name] = torch.from_numpy(host).to(device)
    return out
