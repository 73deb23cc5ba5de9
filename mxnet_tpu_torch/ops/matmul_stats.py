"""Matmul with a BatchNorm-statistics epilogue: a hand-written CUDA kernel and
its plain version.

Replaces the TPU kernel ``mxnet_tpu/ops/pallas_matmul_stats.py``
``matmul_with_stats`` (:71) → ``_kernel`` (:47):

    C = A @ B;   col_sum[n] = sum_m C[m, n];   col_sumsq[n] = sum_m C[m, n]^2

for A (M, K) and B (K, N). A 1x1 convolution is this product, and the two
column sums are what the BatchNorm after it needs of its input: the kernel
takes them from its float32 accumulators while the tile is still in
registers, so C is written once and never read again for the statistics.

The kernel is ``csrc/matmul_stats.cu``: a shared-memory-tiled float32 GEMM
that reads B as it lies (row-major (K, N), no transposed copy), predicates
ragged M, N and K, writes each block's column partials into one row of an
(m_tiles, 2, N) buffer and adds the rows in a second, fixed-order pass
(no atomics: two runs give the same bits).

``matmul_with_stats`` is the dispatcher: CPU tensors take the plain PyTorch
version, CUDA tensors launch the kernel or raise. ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_build

__all__ = ["matmul_with_stats", "matmul_with_stats_plain", "supported"]

#: rows of C one block owns (BM in csrc/matmul_stats.cu, which checks it)
BLOCK_M = 128

launches = 0


def supported(m, k, n, dtype=torch.float32):
    """Whether the CUDA kernel takes an (m, k) by (k, n) product of ``dtype``.

    The port's own rule: float32 only (a bfloat16 variant is not written
    yet), every extent at least 1 and each of m, k, n, m·k, k·n and m·n
    below 2³¹ (the kernel's extents are C ints). No tiling condition: the TPU
    kernel's gate demands whole (8, 128)-aligned tiles, this kernel
    predicates its ragged edges."""
    limit = 2 ** 31
    return (dtype == torch.float32 and min(m, k, n) >= 1
            and max(m * k, k * n, m * n) < limit)


def matmul_with_stats_plain(a, b):
    """The kernel's function in plain PyTorch."""
    c = torch.matmul(a, b)
    c32 = c.to(torch.float32)
    return c, c32.sum(dim=0), (c32 * c32).sum(dim=0)


def matmul_with_stats(a, b):
    """``(C, col_sum, col_sumsq)`` for ``C = a @ b``, a (M, K), b (K, N).

    C keeps ``a``'s dtype; the statistics are float32 (N,)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] or a.dtype != b.dtype:
        raise MXNetError("matmul_with_stats: want a (M, K) and b (K, N) of one dtype, got "
                         "%s %s and %s %s" % (tuple(a.shape), a.dtype, tuple(b.shape), b.dtype))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_with_stats_plain(a, b)
    (M, K), N = a.shape, b.shape[1]
    if not supported(M, K, N, a.dtype):
        raise MXNetError("matmul_with_stats: the CUDA kernel takes float32 operands with "
                         "every extent in [1, 2^31), got %s (%d, %d) by (%d, %d)"
                         % (a.dtype, M, K, K, N))
    cuda_build.check_operands("matmul_with_stats", a, b)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise MXNetError("matmul_with_stats: the kernel takes operands aligned to 16 bytes")
    m_tiles = -(-M // BLOCK_M)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    part = torch.empty((m_tiles, 2, N), dtype=torch.float32, device=a.device)
    sums = torch.empty((2, N), dtype=torch.float32, device=a.device)
    lib = cuda_build.library()
    global launches
    with torch.cuda.device(a.device):
        code = lib.mxt_matmul_stats_fwd(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), part.data_ptr(), sums.data_ptr(),
            M, K, N, m_tiles, torch.cuda.current_stream(a.device).cuda_stream)
        launches += 1
    cuda_build.check(code, "matmul_with_stats")
    return c, sums[0], sums[1]
