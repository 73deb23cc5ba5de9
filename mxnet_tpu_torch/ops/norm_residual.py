"""LayerNorm + affine forward: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mxnet_tpu/ops/pallas_norm_residual.py``
``_fwd_call`` (:117) → ``_fwd_kernel`` (:78): y = (x − mean)·rstd·γ + β over
the rows of x (R, D), with the per-row mean and rstd beside y.

The kernel is ``csrc/norm_residual.cu``: one warp per row, the row held in
registers, mean and variance taken in two passes over those registers. On
an H100 it is bound by bytes (one read of x, one write of y).

``layer_norm_affine`` is the dispatcher: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_build

__all__ = ["layer_norm_affine", "layer_norm_affine_plain", "supported", "MAX_DIM"]

MAX_DIM = 1024

launches = 0


def supported(shape):
    """Whether the kernel takes rows of this (R, D) shape."""
    return len(shape) == 2 and 1 <= shape[1] <= MAX_DIM


def layer_norm_affine_plain(x, gamma, beta, eps=1e-5):
    """The kernel's function in plain PyTorch: ``(y, mean, rstd)``."""
    mean = x.mean(dim=-1, keepdim=True)
    cent = x - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (cent * rstd) * gamma + beta, mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm_affine(x, gamma, beta, eps=1e-5):
    """LayerNorm + affine over the rows of x (R, D); gamma, beta are (D,).

    Returns ``(y, mean, rstd)`` with y (R, D) and mean, rstd (R,) f32."""
    if x.ndim != 2 or gamma.shape != (x.shape[1],) or beta.shape != (x.shape[1],):
        raise MXNetError("layer_norm_affine: want x (R, D), gamma and beta (D,), got "
                         "%s, %s, %s" % (tuple(x.shape), tuple(gamma.shape), tuple(beta.shape)))
    if not supported(x.shape):
        raise MXNetError("layer_norm_affine: D = %d is not taken (1 <= D <= %d)"
                         % (x.shape[1], MAX_DIM))
    if x.device.type == "cpu":
        return layer_norm_affine_plain(x, gamma, beta, eps)
    cuda_build.check_operands("layer_norm_affine", x, gamma, beta)
    R, D = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((R,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((R,), dtype=torch.float32, device=x.device)
    if R == 0:
        return y, mean, rstd
    lib = cuda_build.library()
    global launches
    with torch.cuda.device(x.device):
        code = lib.mxt_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), R, D, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
        launches += 1
    cuda_build.check(code, "layer_norm_affine")
    return y, mean, rstd
