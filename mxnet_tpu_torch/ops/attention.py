"""The MultiHeadAttention operator, dense path.

Counterpart of ``mxnet_tpu/ops/attention.py`` (the dense lowering at
:77-91): softmax(QKᵀ·scale + mask)V over (B, H, T, D) tensors in f32, the
causal mask bottom-right aligned so T queries over S >= T keys each see
their S-T+q past keys. In a bound graph the fusion plan routes every site
of this op to the flash-attention kernel (``ops/flash_attention.py``);
this is the op's own semantics, which a CPU site runs where the kernel
does not take its shapes (a CUDA site raises there).
"""
from __future__ import annotations

import math

import torch

from .registry import AttrSpec, register


@register("_contrib_MultiHeadAttention",
          attrs={"causal": AttrSpec("bool", default=False),
                 "scale": AttrSpec("float", default=-1.0)},
          input_names=("query", "key", "value"), aliases=("MultiHeadAttention",))
def _multi_head_attention(attrs, query, key, value):
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
