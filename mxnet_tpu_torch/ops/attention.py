"""The MultiHeadAttention operator: its sequence-parallel dispatch and its
dense path.

Counterpart of ``mxnet_tpu/ops/attention.py``. Under the mesh of an SPMD
step (``parallel.mesh.current_trace_mesh``) with a ``seq`` axis of size
> 1, a self-attention site (T = S, T divisible by the seq axis, the batch
divisible by a ``data`` axis where there is one) runs as ring attention
(``parallel/ring_attention.py``) over (B, T, H, D) transposes of its
inputs, ``batch_axis="data"`` where the mesh has one; ``DISPATCH_COUNTS
["ring"]`` counts those dispatches, as in the JAX package (JAX :21-67).
``MXNET_RING_ATTENTION=0`` turns the dispatch off. ``ring_takes`` is the
one test of a site: the fusion gate declines the ``attention`` pattern
exactly where it holds (``fusion.gate_pattern_explain``), so in a bound
graph such a site reaches this op, and every other site keeps its flash
kernels; the dense path below is the op's own semantics.

The dense path (JAX :77-91): softmax(QKᵀ·scale + mask)V over (B, H, T, D)
tensors in f32, the causal mask bottom-right aligned so T queries over
S >= T keys each see their S-T+q past keys. In a bound graph the fusion
plan routes every site of this op that the ring does not take to the
flash-attention kernel (``ops/flash_attention.py``); this is the op's own semantics, which
a CPU site runs where the kernel does not take its shapes (a CUDA site
raises there).
"""
from __future__ import annotations

import math
import os

import torch

from .registry import AttrSpec, register

# dispatch counters (observability for tests and the smoke: proves the
# seq-parallel path actually engaged)
DISPATCH_COUNTS = {"ring": 0, "pallas": 0, "xla": 0}


def ring_mesh(mesh=None):
    """``mesh`` (default: the running step's, ``current_trace_mesh``) when
    the ring dispatch is on for it: a ``seq`` axis of size > 1 and
    ``MXNET_RING_ATTENTION`` = 1 (its default); else None. A ``MeshSpec``
    serves too."""
    if os.environ.get("MXNET_RING_ATTENTION", "1") != "1":
        return None
    if mesh is None:
        from ..parallel.mesh import current_trace_mesh

        mesh = current_trace_mesh()
    if mesh is not None and "seq" in mesh.axis_names and mesh.shape["seq"] > 1:
        return mesh
    return None


def ring_takes(mesh, q_shape, k_shape):
    """The mesh the ring runs a site on, given its (B, H, T, D) query and
    (B, H, S, D) key shapes, else None: ``ring_mesh(mesh)`` is set, the
    site is self-attention (S = T), T divides over the ``seq`` axis and
    the batch over a ``data`` axis where there is one (JAX :47-51). The op
    dispatches by it, and the fusion gate, ``fusion.attention_trains_flash``,
    the memory plan and the explainer decide by it, so a site the ring
    does not take keeps the flash kernels."""
    mesh = ring_mesh(mesh)
    if mesh is None:
        return None
    T = int(q_shape[2])
    batch_ok = "data" not in mesh.axis_names or int(q_shape[0]) % mesh.shape["data"] == 0
    if int(k_shape[2]) == T and T % mesh.shape["seq"] == 0 and batch_ok:
        return mesh
    return None


def ring_key(mesh=None):
    """What of ``mesh`` (default: the running step's) the ring's claims
    depend on, hashable: its axes and sizes where ``ring_mesh`` is set,
    else None. Caches of resolved fusion sites are keyed by it."""
    mesh = ring_mesh(mesh)
    return None if mesh is None else tuple((a, mesh.shape[a]) for a in mesh.axis_names)


@register("_contrib_MultiHeadAttention",
          attrs={"causal": AttrSpec("bool", default=False),
                 "scale": AttrSpec("float", default=-1.0)},
          input_names=("query", "key", "value"), aliases=("MultiHeadAttention",))
def _multi_head_attention(attrs, query, key, value):
    mesh = ring_takes(None, query.shape, key.shape)
    if mesh is not None:
        from ..parallel.ring_attention import ring_attention

        DISPATCH_COUNTS["ring"] += 1
        out = ring_attention(
            query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2), mesh,
            seq_axis="seq", causal=attrs["causal"],
            scale=attrs["scale"] if attrs["scale"] > 0 else None,
            batch_axis="data" if "data" in mesh.axis_names else None)
        return out.transpose(1, 2)
    d = query.shape[-1]
    scale = attrs["scale"] if attrs["scale"] > 0 else 1.0 / math.sqrt(d)
    q, k, v = (t.to(torch.float32) for t in (query, key, value))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if attrs["causal"]:
        T, S = s.shape[-2], s.shape[-1]
        mask = torch.ones((T, S), dtype=torch.bool, device=s.device).tril(S - T)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(query.dtype)
