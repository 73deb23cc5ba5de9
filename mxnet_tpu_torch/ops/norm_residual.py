"""LayerNorm + affine, forward and backward: hand-written CUDA kernels and
their plain versions.

Replaces the TPU kernels of ``mxnet_tpu/ops/pallas_norm_residual.py``:

- ``_fwd_call`` (:117) → ``_fwd_kernel`` (:78): y = (x − mean)·rstd·γ + β
  over the rows of x (R, D), with the per-row mean and rstd beside y;
- ``_bwd_call`` (:144) → ``_bwd_kernel`` (:92): dx = rstd·(dx̂ − mean(dx̂) −
  x̂·mean(dx̂∘x̂)) with dx̂ = dy∘γ, and per-row-block partial dγ, dβ that are
  summed outside the kernel (:172).

Both kernels are in ``csrc/norm_residual.cu``, the row held in registers. On
an H100 both are bound by bytes (forward: one read of x, one write of y;
backward: one read of x and dy, one write of dx). The forward loads and
stores 16 bytes a lane (each lane 4 adjacent columns of each 128-column
chunk) and takes one row a warp, or two where ``_rows_per_warp`` says so.
The backward's C entry launches a second kernel that adds the per-block
partial rows in a fixed order, where the TPU path sums them in XLA.

``layer_norm_affine`` and ``layer_norm_affine_bwd`` are the dispatchers: a
CPU tensor takes the plain PyTorch version, a CUDA tensor launches the kernel
or raises. ``LayerNormAffine`` is the autograd Function over them (the JAX
package's ``custom_vjp``). ``launches`` and ``bwd_launches`` count kernel
launches.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_build

__all__ = ["layer_norm_affine", "layer_norm_affine_plain", "layer_norm_affine_bwd",
           "layer_norm_affine_bwd_plain", "LayerNormAffine", "supported", "MAX_DIM"]

MAX_DIM = 1024
# rows of one block of the backward kernel, each block one partial dγ/dβ row
# (kBwdRowsPerBlock in csrc/norm_residual.cu, which refuses any other value)
BWD_ROWS_PER_BLOCK = 16

#: warps of a forward block (kWarpsPerBlock in csrc/norm_residual.cu)
WARPS_PER_BLOCK = 4
#: the fewest rows for which the forward takes two rows a warp (at D <= 512):
#: measured on an H100 at D = 512, one row a warp is faster up to 1024 rows,
#: two from 2048 (``PERF.md`` §6)
TWO_ROWS_MIN = 2048

launches = 0
bwd_launches = 0


def _rows_per_warp(R, D):
    """The forward's rows a warp: two from ``TWO_ROWS_MIN`` rows at D <= 512
    (the training step's 2048), else one (the prefill's 1024, the decode's
    8)."""
    return 2 if R >= TWO_ROWS_MIN and D <= 512 else 1


def supported(shape):
    """Whether the kernel takes rows of this (R, D) shape."""
    return len(shape) == 2 and 1 <= shape[1] <= MAX_DIM


def _compute_dtype(x):
    """float32 for x of 32 bits or fewer, as the TPU kernels cast; float64 stays."""
    return torch.promote_types(x.dtype, torch.float32)


def layer_norm_affine_plain(x, gamma, beta, eps=1e-5):
    """The kernel's function in plain PyTorch: ``(y, mean, rstd)``, computed
    in float32 as ``_fwd_kernel`` (:78) does (float64 stays float64): y in
    x's dtype, mean and rstd in the computing dtype."""
    f = _compute_dtype(x)
    xf = x.to(f)
    mean = xf.mean(dim=-1, keepdim=True)
    cent = xf - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (cent * rstd) * gamma.to(f) + beta.to(f)
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


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
            mean.data_ptr(), rstd.data_ptr(), R, D, _rows_per_warp(R, D), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
        launches += 1
    cuda_build.check(code, "layer_norm_affine")
    return y, mean, rstd


def layer_norm_affine_bwd_plain(x, gamma, mean, rstd, dy):
    """The backward kernel's function in plain PyTorch: ``(dx, dgamma, dbeta)``
    from the forward's saved mean and rstd (R,), computed in float32 as
    ``_bwd_kernel`` (:92) and ``_ln_bwd`` (:186) do (float64 stays float64):
    dx in x's dtype, dgamma and dbeta in gamma's."""
    f = _compute_dtype(x)
    dyf, rstdf = dy.to(f), rstd.to(f).unsqueeze(-1)
    xhat = (x.to(f) - mean.to(f).unsqueeze(-1)) * rstdf
    dxhat = dyf * gamma.to(f)
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstdf * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype), (dyf * xhat).sum(dim=0).to(gamma.dtype),
            dyf.sum(dim=0).to(gamma.dtype))


def layer_norm_affine_bwd(x, gamma, mean, rstd, dy):
    """dx, dgamma, dbeta of ``layer_norm_affine`` over the rows of x (R, D).

    On CUDA the kernel writes dx and one partial dγ/dβ row per block of
    ``BWD_ROWS_PER_BLOCK`` rows, and a second kernel of the same C entry adds
    the rows in a fixed order (the JAX package sums its partials in XLA)."""
    if x.ndim != 2 or dy.shape != x.shape or gamma.shape != (x.shape[1],) \
            or mean.shape != (x.shape[0],) or rstd.shape != (x.shape[0],):
        raise MXNetError("layer_norm_affine_bwd: want x, dy (R, D), gamma (D,), mean and "
                         "rstd (R,), got %s, %s, %s, %s, %s"
                         % (tuple(x.shape), tuple(dy.shape), tuple(gamma.shape),
                            tuple(mean.shape), tuple(rstd.shape)))
    if not supported(x.shape):
        raise MXNetError("layer_norm_affine_bwd: D = %d is not taken (1 <= D <= %d)"
                         % (x.shape[1], MAX_DIM))
    if x.device.type == "cpu":
        return layer_norm_affine_bwd_plain(x, gamma, mean, rstd, dy)
    cuda_build.check_operands("layer_norm_affine_bwd", x, gamma, mean, rstd, dy)
    R, D = x.shape
    dx = torch.empty_like(x)
    sums = torch.empty((2, D), dtype=torch.float32, device=x.device)  # dγ; dβ
    if R == 0:
        sums.zero_()
        return dx, sums[0], sums[1]
    nb = (R + BWD_ROWS_PER_BLOCK - 1) // BWD_ROWS_PER_BLOCK
    part = torch.empty((nb, 2, D), dtype=torch.float32, device=x.device)
    lib = cuda_build.library()
    global bwd_launches
    with torch.cuda.device(x.device):
        code = lib.mxt_layer_norm_bwd(
            x.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), part.data_ptr(), sums.data_ptr(), R, D, BWD_ROWS_PER_BLOCK,
            torch.cuda.current_stream(x.device).cuda_stream)
        bwd_launches += 1
    cuda_build.check(code, "layer_norm_affine_bwd")
    return dx, sums[0], sums[1]


class LayerNormAffine(torch.autograd.Function):
    """y = layer_norm_affine(x, gamma, beta) with the LayerNorm backward as its
    gradient: saves (x, gamma, mean, rstd), not y, as ``_ln_fwd`` (:181) does.
    Both directions compute in float32; dx comes back in x's dtype, dgamma and
    dbeta in gamma's, as ``_ln_bwd`` (:186-189) returns them."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layer_norm_affine(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_affine_bwd(x, gamma, mean, rstd, dy.contiguous())
        return dx, dgamma, dbeta, None
