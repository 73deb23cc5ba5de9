"""Matmul with a BatchNorm-statistics epilogue: a hand-written CUDA kernel and
its plain version.

Replaces the TPU kernel ``mxnet_tpu/ops/pallas_matmul_stats.py``
``matmul_with_stats`` (:71) → ``_kernel`` (:47):

    C = A @ B;   col_sum[n] = sum_m C[m, n];   col_sumsq[n] = sum_m C[m, n]^2

for A (M, K) and B (K, N). A 1x1 convolution is this product, and the two
column sums are what the BatchNorm after it needs of its input: the kernel
takes them from its float32 accumulators while the tile is still in
registers, so C is written once and never read again for the statistics.

The kernel is ``csrc/matmul_stats.cu``: f32-accurate products on the TF32
tensor cores (3xTF32 on ``mma.sync``, ``csrc/tf32x3.cuh``) with A streamed
through a ``cp.async`` ring, B read as it lies (row-major (K, N), no
transposed copy), ragged M, N and K predicated. Each block adds its columns
from the accumulator fragments into one row of a (P, 2, N) buffer, and a
second kernel adds the rows in a fixed order (no atomics: two runs give the
same bits). Two schedules, picked here by ``_schedule(M, K, N)`` so that the
CPU tests see the choice:

- ``"short_k"`` (K ≤ ``SHORT_K_MAX``: the deploy tap (100352, 64, 256)):
  persistent blocks, about one an SM (``SMS``). Block (p, s) stages B's
  N-slab s once, split into TF32 hi/lo pairs, and takes the M-tiles p,
  p + P, ... (P = ``groups``), carrying the column sums in registers across
  them; one tile's C stores overlap the next tile's loads and products.
- ``"long_k"``: one tile a block, A and B slices through the ring.

Its bf16 form (``mxt_matmul_stats_fwd_bf16``), on bfloat16 A and B, is the
TPU kernel in the dtype it was written for (its ``supported`` takes
``itemsize=2`` by default, :37; C rounded to bf16 from the f32 accumulator,
the sums taken before, :59-61): one bf16 ``mma.sync`` a step with no hi/lo
split, into f32, C rounded to bfloat16 once, Σc and Σc² from the f32
accumulators, the same schedules, blocks and fixed-order second pass.

``matmul_with_stats`` is the dispatcher: CPU tensors take the plain PyTorch
version, CUDA tensors launch the kernel or raise. ``launches`` and
``bf16_launches`` count kernel launches.
"""
from __future__ import annotations

from collections import namedtuple

import torch

from ..base import MXNetError
from . import cuda_build

__all__ = ["matmul_with_stats", "matmul_with_stats_plain", "supported"]

#: the kernel's layouts by name: (C code, rows BM and columns BN of a block's
#: tile, the K slice BK of a ring stage, its 8 warps along M (the rest along
#: N), B's slab resident in shared memory) as csrc/matmul_stats.cu's Layout
#: instances, whose code the C entry takes
LAYOUTS = {"short_64x128": (0, 64, 128, 64, 2, True), "short_128x64": (1, 128, 64, 64, 4, True),
           "tile_64x128": (2, 64, 128, 64, 2, False), "tile_256x64": (3, 256, 64, 32, 4, False)}
#: the longest K the short-K schedule takes
SHORT_K_MAX = 128
#: an H100 SXM's SMs: the short-K schedule's blocks. A constant, not the
#: card's count, so that the order of the sums is the same on every card
SMS = 132
#: the dynamic shared memory a block may have on an H100
SMEM_MAX = 232448


class Schedule(namedtuple("Schedule", "kind layout groups n_slabs")):
    """A launch of the kernel: ``kind`` "short_k" or "long_k", the layout's
    name, and ``groups`` blocks along M (one partial row [Σc | Σc²] each) by
    ``n_slabs`` along N."""


def smem_bytes(layout, K, dtype=torch.float32):
    """The dynamic shared memory of ``layout`` at depth K (``Layout::smem``):
    the ring's stages of A (and B's, streamed) slices, rows of A padded to
    BK + 8 floats and of B to BN + 4; a resident slab holds K rounded up to
    the slice as (hi, lo) pairs, rows of 2·BN + 4 words. The bf16 form's
    (``Bf16Smem``): rows of BK + 8 and BN + 8 bf16 elements, a slab of the
    k pairs packed in words, rows of BN + 8."""
    _, bm, bn, bk, _, resident = LAYOUTS[layout]
    stages = 4 if resident else 3
    slices = -(-K // bk)
    if dtype == torch.bfloat16:
        stage = bm * (bk + 8) + (0 if resident else bk * (bn + 8))
        return 2 * stages * stage + (4 * slices * bk // 2 * (bn + 8) if resident else 0)
    stage = bm * (bk + 8) + (0 if resident else bk * (bn + 4))
    slab = slices * bk * (2 * bn + 4) if resident else 0
    return 4 * (stages * stage + slab)


def _schedule(M, K, N):
    """The kernel's schedule for an (M, K) by (K, N) product: short K up to
    ``SHORT_K_MAX``, with P = ``SMS`` // the slabs persistent blocks along M
    (at most the M-tiles), else one tile a block; 64-column slabs and tiles
    for N ≤ 64, 128-column ones otherwise (the layouts measured fastest on an
    H100, ``PERF.md`` §6)."""
    narrow = N <= 64
    if K <= SHORT_K_MAX:
        layout = "short_128x64" if narrow else "short_64x128"
        bm, bn = LAYOUTS[layout][1:3]
        n_slabs = -(-N // bn)
        return Schedule("short_k", layout, min(-(-M // bm), max(1, SMS // n_slabs)), n_slabs)
    layout = "tile_256x64" if narrow else "tile_64x128"
    bm, bn = LAYOUTS[layout][1:3]
    return Schedule("long_k", layout, -(-M // bm), -(-N // bn))


launches = 0
bf16_launches = 0

#: the dtypes the kernel takes: its float32 form and its bf16 form
DTYPES = (torch.float32, torch.bfloat16)


def supported(m, k, n, dtype=torch.float32):
    """Whether the CUDA kernel takes an (m, k) by (k, n) product of ``dtype``.

    The port's own rule: float32 or bfloat16 (its two forms), every extent
    at least 1 and each of m, k, n, m·k, k·n and m·n below 2³¹ (the kernel's
    extents are C ints). No tiling condition: the TPU kernel's gate demands
    whole (8, 128)-aligned tiles, this kernel predicates its ragged edges."""
    limit = 2 ** 31
    return (dtype in DTYPES and min(m, k, n) >= 1
            and max(m * k, k * n, m * n) < limit)


def matmul_with_stats_plain(a, b):
    """The kernel's function in plain PyTorch: the statistics from the
    float32 product before C is rounded to ``a``'s dtype, as ``_kernel``
    (:47) takes them from its accumulator."""
    c32 = torch.matmul(a.float(), b.float())
    return c32.to(a.dtype), c32.sum(dim=0), (c32 * c32).sum(dim=0)


def matmul_with_stats(a, b):
    """``(C, col_sum, col_sumsq)`` for ``C = a @ b``, a (M, K), b (K, N).

    C keeps ``a``'s dtype; the statistics are float32 (N,). On the card,
    float32 operands take the 3xTF32 form (``launches``) and bfloat16 ones
    the bf16 form (``bf16_launches``)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] or a.dtype != b.dtype:
        raise MXNetError("matmul_with_stats: want a (M, K) and b (K, N) of one dtype, got "
                         "%s %s and %s %s" % (tuple(a.shape), a.dtype, tuple(b.shape), b.dtype))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_with_stats_plain(a, b)
    (M, K), N = a.shape, b.shape[1]
    cuda_build.check_operands("matmul_with_stats", a, b, dtypes=DTYPES)
    if not supported(M, K, N, a.dtype):
        raise MXNetError("matmul_with_stats: the CUDA kernel takes every extent in "
                         "[1, 2^31), got (%d, %d) by (%d, %d)" % (M, K, K, N))
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise MXNetError("matmul_with_stats: the kernel takes operands aligned to 16 bytes")
    sched = _schedule(M, K, N)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    part = torch.empty((sched.groups, 2, N), dtype=torch.float32, device=a.device)
    sums = torch.empty((2, N), dtype=torch.float32, device=a.device)
    lib = cuda_build.library()
    bf16 = a.dtype == torch.bfloat16
    fn = lib.mxt_matmul_stats_fwd_bf16 if bf16 else lib.mxt_matmul_stats_fwd
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), part.data_ptr(), sums.data_ptr(),
                  M, K, N, LAYOUTS[sched.layout][0], sched.groups,
                  torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check(code, "matmul_with_stats")
    global launches, bf16_launches
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return c, sums[0], sums[1]
