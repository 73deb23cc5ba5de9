"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mxnet_tpu/ops/pallas_attention.py`` ``_fwd_call``
(:199) → ``_fwd_kernel`` (:81): O = softmax(Q·Kᵀ·scale)V over (B·H, T, D)
with the online softmax over key tiles, the causal mask bottom-right
aligned for S >= T, and the f32 row logsumexp beside O.

The kernel is ``csrc/flash_attention.cu``. On an H100 the prefill's shape
is bound by bytes (Q, K, V read once, O written once; the (T, S) scores stay
on chip). The source's header says how the design keeps them there and how
the TPU's sequential key axis became a loop inside one block.

``flash_attention`` is the dispatcher: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import cuda_build

__all__ = ["flash_attention", "flash_attention_plain", "supported", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_NEG = -1e30

launches = 0


def supported(q_shape, k_shape, causal):
    """Whether the kernel takes (BH, T, D) queries over (BH, S, D) keys."""
    _, T, D = q_shape
    S = k_shape[1]
    return 1 <= D <= MAX_HEAD_DIM and T >= 1 and S >= 1 and not (causal and S < T)


def flash_attention_plain(q, k, v, causal=False, scale=0.0):
    """The kernel's function in plain PyTorch: ``(O, lse)`` for (BH, T, D) inputs."""
    T, D = q.shape[1], q.shape[2]
    S = k.shape[1]
    if scale <= 0:
        scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q.to(torch.float32) * scale, k.to(torch.float32).transpose(1, 2))
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)
        s = s.masked_fill(~mask, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.to(torch.float32)) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention(q, k, v, causal=False, scale=0.0):
    """softmax(Q·Kᵀ·scale)V over (BH, T, D) queries and (BH, S, D) keys/values.

    Returns ``(O, lse)``: O is (BH, T, D), lse the (BH, T) f32 row logsumexp.
    ``scale <= 0`` means 1/sqrt(D)."""
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise MXNetError("flash_attention: want q (BH, T, D) and k, v (BH, S, D), "
                         "got %s, %s, %s" % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not supported(q.shape, k.shape, causal):
        raise MXNetError("flash_attention: shapes q %s, k %s (causal=%s) are not taken: "
                         "D <= %d, and S >= T when causal"
                         % (tuple(q.shape), tuple(k.shape), causal, MAX_HEAD_DIM))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    cuda_build.check_operands("flash_attention", q, k, v)
    BH, T, D = q.shape
    S = k.shape[1]
    if scale <= 0:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    lib = cuda_build.library()
    global launches
    with torch.cuda.device(q.device):
        code = lib.mxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            BH, T, S, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
        launches += 1
    cuda_build.check(code, "flash_attention")
    return o, lse
