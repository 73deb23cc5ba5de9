"""Matmul + bias + activation: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mxnet_tpu/ops/pallas_matmul_bias_act.py``
``_fwd_call`` (:67) → ``_kernel`` (:57): C = act(A·Wᵀ + b) with A (M, K), W
(N, K) in the FullyConnected layout, b (N,), and the bias and activation
applied on the f32 accumulator.

The kernel is ``csrc/matmul_bias_act.cu`` with two schedules, picked here by
``_schedule(M, N, K)`` so that the CPU tests see the choice:

- ``"small_m"`` (M ≤ ``SMALL_M_MAX`` and 32 rows of A fit in 64 KiB of
  shared memory; the decode step's A (8, 512)): bound by the bytes of W
  (0.00128 ms for 2048 × 512 on an H100). A block stages up to 32 rows of A
  in shared memory, each warp streams one row of W with 16-byte loads and
  reduces by shuffles; f32 FMAs.
- ``"tiles"`` (the prefill's A (1024, 512), training's (2048, 512)): bound by
  operations. 128 × 128 tiles of f32-accurate TF32 tensor-core products
  (3xTF32 on ``mma.sync``, ``csrc/tf32x3.cuh``) fed by a 3-stage ``cp.async``
  ring; 3·2MNK FLOP at 495 TFLOP/s is 0.0130 ms at the prefill's shape.

``SMALL_M_MAX`` is the crossover measured on an H100 at the decode's K and
N (``chip_smoke.py``'s ``matmul_bias_act_crossover`` line): the small-M
schedule is faster at every M up to 192, the tiles at 256. Both schedules
run the epilogue before their one store, and both take ragged M, N and K.

``matmul_bias_act`` is the dispatcher: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches, ``small_m_launches`` and ``tile_launches`` those of each
schedule.

``MatmulBiasAct`` is the autograd Function. Its backward is ``_mba_bwd``
(:136) as the JAX package has it, which is no Pallas kernel: dpre comes from
the activated output (relu: y > 0; sigmoid: y(1 − y); tanh: 1 − y²;
softrelu: 1 − e^{−y}), then three products, da = dpre·W, dW = dpreᵀ·a and
db = Σ dpre, which stay ``torch.matmul`` and a sum as JAX leaves them to XLA.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_build
from .nn import _ACTS

__all__ = ["matmul_bias_act", "matmul_bias_act_plain", "MatmulBiasAct", "ACTIVATIONS"]

#: the kernel's activation codes, by position
ACTIVATIONS = ("relu", "sigmoid", "tanh", "softrelu")

#: each activation's derivative, from the ACTIVATED output y
_DERIVATIVES = {
    "relu": lambda y: (y > 0).to(y.dtype),
    "sigmoid": lambda y: y * (1.0 - y),
    "tanh": lambda y: 1.0 - y * y,
    # y = log(1 + e^p)  =>  act'(p) = sigmoid(p) = 1 - e^{-y}
    "softrelu": lambda y: 1.0 - torch.exp(-y),
}

#: the kernel's schedules, by their C code
SCHEDULES = ("small_m", "tiles")
#: the largest M for which the dispatcher picks the small-M schedule: the
#: crossover measured on an H100 (``PERF.md`` §5)
SMALL_M_MAX = 192
#: the small-M schedule's rows of A a block (its register tile), and the
#: shared memory a block may stage them in
SMALL_M_ROWS = 32
SMALL_M_SMEM_BYTES = 64 * 1024

launches = 0
small_m_launches = 0
tile_launches = 0


def _small_m_takes(M, K):
    """Whether the small-M schedule takes an (M, K) A: a block's rows of it
    fit in its shared memory."""
    return min(M, SMALL_M_ROWS) * K * 4 <= SMALL_M_SMEM_BYTES


def _schedule(M, N, K):
    """The kernel's schedule for a (M, K) x (N, K)ᵀ product: ``"small_m"``
    up to the crossover M where it takes the shape, else ``"tiles"``."""
    if M <= SMALL_M_MAX and _small_m_takes(M, K):
        return "small_m"
    return "tiles"


def matmul_bias_act_plain(a, w, b, act="relu"):
    """The kernel's function in plain PyTorch."""
    p = torch.matmul(a, w.t())
    if b is not None:
        p = p + b
    return _ACTS[act](p)


def matmul_bias_act(a, w, b, act="relu"):
    """``act(a @ w.T + b)`` for a (M, K), w (N, K) and b (N,) or None."""
    if act not in ACTIVATIONS:
        raise MXNetError("matmul_bias_act: act must be one of %s, got %r" % (ACTIVATIONS, act))
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[1] \
            or (b is not None and b.shape != (w.shape[0],)):
        raise MXNetError("matmul_bias_act: want a (M, K), w (N, K), b (N,), got %s, %s, %s"
                         % (tuple(a.shape), tuple(w.shape),
                            None if b is None else tuple(b.shape)))
    if a.device.type == "cpu":
        return matmul_bias_act_plain(a, w, b, act)
    operands = (a, w) if b is None else (a, w, b)
    cuda_build.check_operands("matmul_bias_act", *operands)
    M, K = a.shape
    N = w.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    return _launch(a, w, b, act, c, _schedule(M, N, K))


def _launch(a, w, b, act, c, schedule):
    """One launch of the kernel's ``schedule`` into c (M, N)."""
    M, K = a.shape
    N = w.shape[0]
    lib = cuda_build.library()
    global launches, small_m_launches, tile_launches
    with torch.cuda.device(a.device):
        code = lib.mxt_matmul_bias_act_fwd(
            a.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            c.data_ptr(), M, N, K, ACTIVATIONS.index(act), SCHEDULES.index(schedule),
            torch.cuda.current_stream(a.device).cuda_stream)
        launches += 1
        if schedule == "small_m":
            small_m_launches += 1
        else:
            tile_launches += 1
    cuda_build.check(code, "matmul_bias_act")
    return c


class MatmulBiasAct(torch.autograd.Function):
    """y = matmul_bias_act(a, w, b, act); saves (a, w, y) and recovers the
    pre-activation gradient from y, as ``_mba_fwd``/``_mba_bwd`` (:131-146) do."""

    @staticmethod
    def forward(ctx, a, w, b, act):
        y = matmul_bias_act(a, w, b, act)
        ctx.save_for_backward(a, w, y)
        ctx.act, ctx.has_bias = act, b is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        a, w, y = ctx.saved_tensors
        dpre = dy * _DERIVATIVES[ctx.act](y)
        da = torch.matmul(dpre, w)
        dw = torch.matmul(dpre.t(), a)
        db = dpre.sum(dim=0) if ctx.has_bias else None
        return da, dw, db, None
