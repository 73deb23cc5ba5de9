"""Ring attention: exact attention over a sequence-sharded mesh axis.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``. The sequence is
cut into n = ``mesh.shape[seq_axis]`` blocks of t = T/n positions; query
block j stays put while the key/value blocks go round the ring, so at step
i it attends to kv block (j - i) mod n. Each step's scores are one
blockwise product in float32 and the softmax is merged online (a running
max and a running denominator, flash-attention style), so the result is
exact full attention while no block ever holds more than t x t scores.
Causal positions are global: the ring's mask is the dense op's
bottom-right mask when T = S.

Within one process a mesh is one program (``parallel/mesh.py``): q, k and
v are the global (B, T, H, D) tensors, and step i is one product over every
query block at once, the (B, n, t, H, D) key and value views rolled along
the block axis (``torch.roll``), with (B, n, H, t, t) scores. Everything
the ring launches stays on the tensors' device and syncs nothing, so it
runs inside a fused step's CUDA graph.

Across the processes of a ``torch.distributed`` job (a mesh whose seq axis
spans the ranks) each rank passes its own (B, T/n, H, D) block, as each
holds its own rows of a data axis, and the key and value blocks move to
rank r+1 by ``batch_isend_irecv`` over the mesh's group. The move is a
``torch.autograd.Function`` whose backward sends the cotangent to rank
r-1, the transpose of JAX's ``ppermute``, so gradients flow as
``jax.grad`` through the ring does. One card runs one NCCL rank, so a ring
across ranks runs over gloo on CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["ring_attention", "local_blockwise_attention"]


def _block_attend(q, k, v, scale, mask):
    """One blockwise contribution over any leading dims: q (..., t, H, D),
    k and v (..., s, H, D), ``mask`` broadcastable to (..., H, t, s) or
    None. Returns the unnormalized output (..., t, H, D), the running max
    and the denominator (..., H, t) (JAX :22-35)."""
    s = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    # an all-masked row: exp(-inf - -inf) is guarded with a max of 0
    m_safe = m.masked_fill(~torch.isfinite(m), 0.0)
    p = torch.exp(s - m_safe.unsqueeze(-1))
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("...hqk,...khd->...qhd", p, v)
    return o, m_safe, l


def _positions(first, count, device):
    """Global positions of blocks starting at ``first`` (an int, or an (n,)
    tensor of block starts on ``device``): (1, count) or (n, count). An
    int is added on the device, never copied from the host."""
    r = torch.arange(count, device=device)
    if isinstance(first, torch.Tensor):
        return first.reshape(-1, 1) + r
    return (r + first).reshape(1, -1)


def _causal_mask(q_first, k_first, t, s, device):
    """(n, t, s) mask of the global positions: key ``k_first + c`` is
    visible to query ``q_first + r`` when it is not later."""
    q_pos = _positions(q_first, t, device)
    k_pos = _positions(k_first, s, device)
    return k_pos.unsqueeze(-2) <= q_pos.unsqueeze(-1)


def local_blockwise_attention(q, k, v, scale, causal, q_block, kv_block, block):
    """Attention of one query block against one kv block with global causal
    positions (q starts at q_block·block, k at kv_block·block): the
    unnormalized output, the running max and the denominator."""
    t, s = q.shape[1], k.shape[1]
    mask = None
    if causal:
        mask = _causal_mask(q_block * block, kv_block * block, t, s, q.device)[0]
    return _block_attend(q, k, v, scale, mask)


def _merge(acc, blk):
    """The online-softmax merge of a block into the accumulators (JAX
    :75-84): ``m_new = max(m, bm)`` and the two factors exp(m - m_new) and
    exp(bm - m_new)."""
    o, m, l = acc
    bo, bm, bl = blk
    m_new = torch.maximum(m, bm)
    c1 = torch.exp(m - m_new)
    c2 = torch.exp(bm - m_new)
    o = o * c1.unsqueeze(-1).transpose(-3, -2) + bo * c2.unsqueeze(-1).transpose(-3, -2)
    return o, m_new, l * c1 + bl * c2


def _finish(o, l, dtype):
    """Divide where the denominator is positive, cast back to q's dtype."""
    denom = l.masked_fill(~(l > 0), 1.0)
    return (o / denom.unsqueeze(-1).transpose(-3, -2)).to(dtype)


def _ring_one_program(q, k, v, n, scale, causal):
    """The ring of one process over global (B, T, H, D) tensors: step i is
    one product over all n query blocks, kv rolled i blocks on."""
    B, T, H, D = q.shape
    t = T // n
    f32 = torch.float32
    qb = q.to(f32).reshape(B, n, t, H, D)
    k_cur = k.to(f32).reshape(B, n, t, H, D)
    v_cur = v.to(f32).reshape(B, n, t, H, D)
    blocks = torch.arange(n, device=q.device)
    o = torch.zeros(B, n, t, H, D, dtype=f32, device=q.device)
    m = torch.full((B, n, H, t), float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros(B, n, H, t, dtype=f32, device=q.device)
    for i in range(n):
        mask = None
        if causal:
            # query block j holds kv block (j - i) mod n at step i
            mask = _causal_mask(blocks * t, ((blocks - i) % n) * t, t, t, q.device)
            mask = mask.unsqueeze(1)  # (n, 1, t, t) against (B, n, H, t, t)
        o, m, l = _merge((o, m, l), _block_attend(qb, k_cur, v_cur, scale, mask))
        if i + 1 < n:
            k_cur = torch.roll(k_cur, 1, dims=1)
            v_cur = torch.roll(v_cur, 1, dims=1)
    return _finish(o, l, q.dtype).reshape(B, T, H, D)


def _shift(tensors, group, d):
    """Each tensor of this rank to rank r+d of ``group``, and rank r-d's in
    its place, by one ``batch_isend_irecv``."""
    import torch.distributed as tdist

    ranks = tdist.get_process_group_ranks(group)
    n, r = len(ranks), tdist.get_rank(group)
    dst, src = ranks[(r + d) % n], ranks[(r - d) % n]
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(tdist.P2POp(tdist.isend, t.contiguous(), dst, group))
        ops.append(tdist.P2POp(tdist.irecv, o, src, group))
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return tuple(outs)


class _RingStep(torch.autograd.Function):
    """k and v to the next rank of the ring; the backward sends their
    cotangents to the previous one (the transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        ctx.like = tuple((x.shape, x.dtype, x.device) for x in (k, v))
        return _shift((k, v), group, 1)

    @staticmethod
    def backward(ctx, gk, gv):
        cts = tuple(torch.zeros(sh, dtype=dt, device=dev) if g is None else g
                    for g, (sh, dt, dev) in zip((gk, gv), ctx.like))
        return (None,) + _shift(cts, ctx.group, -1)


def _ring_across_processes(q, k, v, mesh, n, scale, causal):
    """The ring over the ranks of ``mesh.group``: q, k and v are this
    rank's (B, T/n, H, D) block."""
    import torch.distributed as tdist

    B, t, H, D = q.shape
    my = tdist.get_rank(mesh.group)
    f32 = torch.float32
    qb, k_cur, v_cur = q.to(f32), k.to(f32), v.to(f32)
    o = torch.zeros(B, t, H, D, dtype=f32, device=q.device)
    m = torch.full((B, H, t), float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros(B, H, t, dtype=f32, device=q.device)
    for i in range(n):
        blk = local_blockwise_attention(qb, k_cur, v_cur, scale, causal, my, (my - i) % n, t)
        o, m, l = _merge((o, m, l), blk)
        if i + 1 < n:
            k_cur, v_cur = _RingStep.apply(mesh.group, k_cur, v_cur)
    return _finish(o, l, q.dtype)


def ring_attention(q, k, v, mesh, seq_axis="seq", causal=False, scale=None,
                   batch_axis=None):
    """Exact attention with q, k and v cut on the sequence axis over the
    mesh axis ``seq_axis``.

    Within one process q, k and v are the global (B, T, H, D) tensors, T
    divisible by the axis's size; across the processes of a mesh whose
    ``seq_axis`` spans the ranks each rank's are its own (B, T/n, H, D)
    block. Returns the attention output in q's layout and dtype.
    ``batch_axis`` names the mesh axis the batch is cut over (dp x sp): in
    one process it leaves the result unchanged; across processes it is
    ROADMAP.md section 1.4c and raises."""
    n = int(mesh.shape[seq_axis])
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if getattr(mesh, "process_count", 1) > 1:
        if batch_axis is not None:
            raise MXNetError("ring_attention: a batch axis beside the seq axis across "
                             "processes is ROADMAP.md section 1.4c (a mesh across processes "
                             "holds one axis)")
        return _ring_across_processes(q, k, v, mesh, n, scale, causal)
    if q.shape[1] % n or k.shape[1] != q.shape[1]:
        raise MXNetError("ring_attention: self-attention over T = %d positions does not cut "
                         "into %d blocks of the %r axis" % (q.shape[1], n, seq_axis))
    return _ring_one_program(q, k, v, n, scale, causal)
