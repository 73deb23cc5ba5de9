"""Flash attention, forward and backward: hand-written CUDA kernels and their
plain versions.

Replaces the TPU kernels of ``mxnet_tpu/ops/pallas_attention.py``:

- ``_fwd_call`` (:199) → ``_fwd_kernel`` (:81): O = softmax(Q·Kᵀ·scale)V over
  (B·H, T, D) with the online softmax over key tiles, the causal mask bottom-
  right aligned for S >= T, and the f32 row logsumexp beside O;
- ``_bwd_call`` (:237) → ``_dq_kernel`` (:118) and ``_dkv_kernel`` (:151):
  dQ, dK, dV with P recomputed from the saved logsumexp and
  δ = rowsum(dO∘O) computed outside the kernels (:245-247).

The kernels are ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``.
All three run every product on the TF32 tensor cores with the 3xTF32 step, to
f32 accuracy (``csrc/tf32x3.cuh``, ``csrc/flash_tc.cuh``); at the training
shape their bound is the bytes, by a little over the products. The sources'
headers say how the designs keep the scores on chip and how the TPU's
sequential grid axis became a loop inside one block. ``_tiles`` lists the rows
each block owns and streams, and the kernels read that list: the forward and
dq the blocks that own query rows, dk/dv those that own keys.

The kernels have bf16 forms, for bf16 q, k, v (and dO): the forward's
(``mxt_flash_attention_fwd_bf16``, ``KVCacheDecoder(dtype='bfloat16')``'s
prefill and the bf16 training step) computes what ``_fwd_kernel`` (:81-114)
computes on bf16 operands, the scores and P in f32, O = acc / l rounded once
to bf16 (:113), lse f32 (:114); the backward's
(``mxt_flash_attention_bwd_dq_bf16``, ``_dkv_bf16``,
``SPMDTrainer(compute_dtype='bfloat16')``'s step) what ``_dq_kernel`` and
``_dkv_kernel`` compute on bf16 q, k, v and dO with f32 lse and δ: P and dS
in f32, each of dq, dk and dv rounded once to bf16 from its f32 sum (:148,
:186-187). The plain versions widen to f32 and round once at those points.

``flash_attention``, ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``
are the dispatchers, and ``flash_attention_bwd`` runs the two backward ones: a
CPU tensor takes the plain PyTorch version, a CUDA tensor launches the kernel
(the form by q's dtype; q, k, v and dO of one dtype, lse and δ f32) or
raises. ``FlashAttention`` is the autograd Function over them (the JAX
package's ``custom_vjp``). ``launches``, ``bf16_launches``, ``dq_launches``,
``dkv_launches``, ``bf16_dq_launches`` and ``bf16_dkv_launches`` count kernel
launches (the f32 and bf16 forward's, dq's and dk/dv's).
"""
from __future__ import annotations

import collections
import functools
import math

import torch

from ..base import MXNetError
from . import cuda_build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain", "FlashAttention",
           "supported", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_NEG = -1e30

launches = 0
bf16_launches = 0
dq_launches = 0
dkv_launches = 0
bf16_dq_launches = 0
bf16_dkv_launches = 0


def supported(q_shape, k_shape, causal):
    """Whether the kernels take (BH, T, D) queries over (BH, S, D) keys."""
    _, T, D = q_shape
    S = k_shape[1]
    return 1 <= D <= MAX_HEAD_DIM and T >= 1 and S >= 1 and not (causal and S < T)


def _work_dtype(t):
    """f32 for f32 and narrower inputs, f64 for f64 (the gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, causal, scale):
    """(Q·scale)·Kᵀ in the working type, masked scores at -1e30."""
    T, S = q.shape[1], k.shape[1]
    s = torch.matmul(q.to(_work_dtype(q)) * scale, k.to(_work_dtype(q)).transpose(1, 2))
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)
        s = s.masked_fill(~mask, _NEG)
    return s


def flash_attention_plain(q, k, v, causal=False, scale=0.0):
    """The forward kernel's function in plain PyTorch: ``(O, lse)`` for
    (BH, T, D) inputs. Narrower inputs (bf16) compute in f32, as
    ``_fwd_kernel`` widens them (:93-95): O is rounded once to q's dtype,
    lse stays f32."""
    if scale <= 0:
        scale = 1.0 / math.sqrt(q.shape[2])
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.to(s.dtype)) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _recompute(q, k, v, lse, do, delta, causal, scale):
    """P from the saved lse and dS = P∘(dO·Vᵀ − δ), as each backward kernel
    recomputes them."""
    wt = _work_dtype(q)
    p = torch.exp(_scores(q, k, causal, scale) - lse.to(wt).unsqueeze(-1))
    dp = torch.matmul(do.to(wt), v.to(wt).transpose(1, 2))
    return p, p * (dp - delta.to(wt).unsqueeze(-1))


def flash_attention_bwd_dq_plain(q, k, v, lse, do, delta, causal, scale):
    """The dq kernel's function: dQ = scale·dS·K, in f32 for bf16 operands
    (P and dS f32, as ``_dq_kernel`` keeps them) and rounded once to q's
    dtype (:148)."""
    _, ds = _recompute(q, k, v, lse, do, delta, causal, scale)
    return (torch.matmul(ds, k.to(ds.dtype)) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, lse, do, delta, causal, scale):
    """The dk/dv kernel's function: dK = dSᵀ·(Q·scale), dV = Pᵀ·dO, in f32
    for bf16 operands and each rounded once to k's and v's dtypes
    (``_dkv_kernel`` :186-187)."""
    p, ds = _recompute(q, k, v, lse, do, delta, causal, scale)
    dk = torch.matmul(ds.transpose(1, 2), q.to(ds.dtype) * scale)
    dv = torch.matmul(p.transpose(1, 2), do.to(ds.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=0.0):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)``.

    P is recomputed from ``lse`` (BH, T) as ``_dq_kernel``/``_dkv_kernel``
    do, once for each; δ = rowsum(dO∘O)."""
    if scale <= 0:
        scale = 1.0 / math.sqrt(q.shape[2])
    delta = (do.to(_work_dtype(q)) * o.to(_work_dtype(q))).sum(dim=-1)
    dq = flash_attention_bwd_dq_plain(q, k, v, lse, do, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, lse, do, delta, causal, scale)
    return dq, dk, dv


def _check_shapes(what, q, k, v, causal):
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise MXNetError("%s: want q (BH, T, D) and k, v (BH, S, D), got %s, %s, %s"
                         % (what, tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not supported(q.shape, k.shape, causal):
        raise MXNetError("%s: shapes q %s, k %s (causal=%s) are not taken: "
                         "D <= %d, and S >= T when causal"
                         % (what, tuple(q.shape), tuple(k.shape), causal, MAX_HEAD_DIM))


def flash_attention(q, k, v, causal=False, scale=0.0):
    """softmax(Q·Kᵀ·scale)V over (BH, T, D) queries and (BH, S, D) keys/values.

    Returns ``(O, lse)``: O is (BH, T, D), lse the (BH, T) f32 row logsumexp.
    ``scale <= 0`` means 1/sqrt(D)."""
    _check_shapes("flash_attention", q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    bf16 = q.dtype == torch.bfloat16
    cuda_build.check_operands("flash_attention", q, k, v,
                              dtypes=(torch.bfloat16,) if bf16 else (torch.float32,))
    BH, T, D = q.shape
    S = k.shape[1]
    if scale <= 0:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    blocks = _table(T, S, bool(causal), q.device).q
    lib = cuda_build.library()
    fn = lib.mxt_flash_attention_fwd_bf16 if bf16 else lib.mxt_flash_attention_fwd
    global launches, bf16_launches
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  blocks.data_ptr(), blocks.shape[0], BH, T, S, D, float(scale),
                  int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
        if bf16:
            bf16_launches += 1
        else:
            launches += 1
    cuda_build.check(code, "flash_attention")
    return o, lse


def _check_bwd_operands(what, q, k, v, lse, do, delta):
    """The backward kernels' dtypes: q, k, v and dO float32, or all
    bfloat16 (the bf16 forms); lse and δ float32. Returns whether the bf16
    form runs."""
    bf16 = q.dtype == torch.bfloat16
    cuda_build.check_operands(what, q, k, v, do,
                              dtypes=(torch.bfloat16,) if bf16 else (torch.float32,))
    cuda_build.check_operands(what, lse, delta)
    if lse.device != q.device:
        raise MXNetError("%s: operands must share one CUDA device, got %s and %s"
                         % (what, q.device, lse.device))
    return bf16


def flash_attention_bwd_dq(q, k, v, lse, do, delta, causal=False, scale=0.0):
    """dQ from the saved lse (BH, T), the upstream dO and δ = rowsum(dO∘O)
    (BH, T): the dq kernel on CUDA tensors (its bf16 form for bf16 q, k, v
    and dO), its plain version on the CPU."""
    _check_shapes("flash_attention_bwd_dq", q, k, v, causal)
    if scale <= 0:
        scale = 1.0 / math.sqrt(q.shape[2])
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, lse, do, delta, causal, scale)
    bf16 = _check_bwd_operands("flash_attention_bwd_dq", q, k, v, lse, do, delta)
    dq = torch.empty_like(q)
    _launch_bwd("mxt_flash_attention_bwd_dq" + ("_bf16" if bf16 else ""), (dq,), q, k, v, lse,
                do, delta, causal, scale)
    global dq_launches, bf16_dq_launches
    if bf16:
        bf16_dq_launches += 1
    else:
        dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, lse, do, delta, causal=False, scale=0.0):
    """(dK, dV) from the same inputs as ``flash_attention_bwd_dq``: the dk/dv
    kernel on CUDA tensors (its bf16 form for bf16 q, k, v and dO), its plain
    version on the CPU."""
    _check_shapes("flash_attention_bwd_dkv", q, k, v, causal)
    if scale <= 0:
        scale = 1.0 / math.sqrt(q.shape[2])
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, lse, do, delta, causal, scale)
    bf16 = _check_bwd_operands("flash_attention_bwd_dkv", q, k, v, lse, do, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("mxt_flash_attention_bwd_dkv" + ("_bf16" if bf16 else ""), (dk, dv), q, k, v,
                lse, do, delta, causal, scale)
    global dkv_launches, bf16_dkv_launches
    if bf16:
        bf16_dkv_launches += 1
    else:
        dkv_launches += 1
    return dk, dv


#: a block's own rows (queries in the forward and dq, keys in dk/dv): the
#: kernels' own rows, whose C entries refuse a table of any other length
TILE_ROWS = 64
#: the kernels' blocks in launch order, each (first own row, first row and
#: end row of the other side it streams): ``q`` owns query rows and streams
#: keys (the forward and dq), ``kv`` owns keys and streams queries (dk/dv)
Tiles = collections.namedtuple("Tiles", "q kv")


@functools.lru_cache(maxsize=256)
def _tiles(T, S, causal):
    """Which rows each block owns and streams, for (BH, T, D) queries over
    (BH, S, D) keys: a ``Tiles``, whose rows the kernels read by
    ``blockIdx.y``.

    A block streams exactly the rows its own rows see, so no tile of them is
    wholly masked. ``q``: a block's last query sees every key up to its
    range's end, and the query tiles with the most keys launch first.
    ``kv``: a block's first key is seen by every query from its range's
    start on, and the first key tiles have the most queries."""
    offset = S - T
    q = []
    for q0 in reversed(range(0, T, TILE_ROWS)):
        last = min(q0 + TILE_ROWS, T) - 1
        q.append((q0, 0, min(S, last + offset + 1) if causal else S))
    kv = [(k0, max(0, k0 - offset) if causal else 0, T) for k0 in range(0, S, TILE_ROWS)]
    return Tiles(tuple(q), tuple(kv))


@functools.lru_cache(maxsize=256)
def _table(T, S, causal, device):
    """``_tiles`` as two int32 tensors on ``device``, made once a shape."""
    return Tiles(*(torch.tensor(p, dtype=torch.int32, device=device)
                   for p in _tiles(T, S, causal)))


def _launch_bwd(entry, outs, q, k, v, lse, do, delta, causal, scale):
    """Launch one backward pass over ``_tiles``'s blocks."""
    BH, T, D = q.shape
    S = k.shape[1]
    table = _table(T, S, bool(causal), q.device)
    blocks = table.kv if "_dkv" in entry else table.q
    with torch.cuda.device(q.device):
        code = getattr(cuda_build.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(o.data_ptr() for o in outs), blocks.data_ptr(),
            blocks.shape[0], BH, T, S, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(code, entry)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=0.0):
    """dQ, dK, dV of ``flash_attention`` from its O and lse and the upstream
    dO: δ = rowsum(dO∘O) in one torch reduction, as the JAX package takes it
    in XLA, then the dq kernel and the dk/dv kernel."""
    _check_shapes("flash_attention_bwd", q, k, v, causal)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise MXNetError("flash_attention_bwd: want o, do %s and lse %s, got %s, %s, %s"
                         % (tuple(q.shape), tuple(q.shape[:2]), tuple(o.shape),
                            tuple(do.shape), tuple(lse.shape)))
    delta = (do.to(_work_dtype(q)) * o.to(_work_dtype(q))).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, lse, do, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """O = flash_attention(q, k, v) with the flash backward as its gradient:
    saves (q, k, v, O, lse) as ``_flash_fwd`` (:307) does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None
