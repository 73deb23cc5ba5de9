"""The fusion patterns of the transformer's serving and training paths.

Counterpart of ``mxnet_tpu/ops/fusion_patterns.py`` for three patterns,
whose matchers are unchanged:

- ``attention``       — the MultiHeadAttention op, onto the flash-attention
  kernel (``ops/flash_attention.py``);
- ``matmul_bias_act`` — FullyConnected(+bias) → Activation, onto the
  matmul + bias + activation kernel (``ops/matmul_bias_act.py``);
- ``norm_residual``   — the LayerNorm composition the transformer zoo
  emits, onto the LayerNorm kernel (``ops/norm_residual.py``).

Contract per pattern: ``match(node, ctx)`` roots a ``Match`` (root,
interior nodes, meta) or returns None; interior nodes are single-output,
stateless, unclaimed and not program outputs, and the executor elides
them behind lazy markers. ``externals(meta, ins, resolve)`` recovers the
subgraph's external inputs. ``build(meta, args)`` returns the one lowering:
the kernel module's autograd Function wrapped to the site's layout, so a
site is differentiable through the kernels' backward on CUDA and through
their plain versions on the CPU. There is no
autotuner: a matched site always takes its kernel on CUDA and the kernel's
plain version on the CPU. Only a CPU site whose shapes the kernel does not
take gets None from ``build`` and runs the unfused ops, as the JAX gate
does off the TPU; a CUDA site goes to the dispatcher, which raises.
"""
from __future__ import annotations

import math

import numpy as np

from .registry import get_op
from . import flash_attention as _fa
from . import matmul_bias_act as _mba
from . import norm_residual as _nr

__all__ = ["Match", "Pattern", "get_patterns", "pattern_names"]


class Match:
    __slots__ = ("root", "interior", "meta")

    def __init__(self, root, interior, meta):
        self.root, self.interior, self.meta = root, list(interior), dict(meta)


class Pattern:
    name = None

    def match(self, node, ctx):
        raise NotImplementedError

    def externals(self, meta, ins, resolve):
        raise NotImplementedError

    def build(self, meta, args):
        raise NotImplementedError


# ------------------------------------------- match helpers (as in mxnet_tpu)
def _sole_consumer(ctx, node):
    """The single consumer of ``node``'s output 0, or None."""
    cons = ctx.consumers.get(id(node), [])
    if len(cons) == 1 and cons[0][1] == 0:
        return cons[0][0]
    return None


def _interior_ok(ctx, node):
    """Whether ``node`` may be elided behind a lazy marker."""
    if node.is_variable or id(node) in ctx.claimed:
        return False
    if id(node) in ctx.output_ids:
        return False  # its value is a program output: must materialize
    op = get_op(node.op)
    return (node.num_outputs() == 1 and not op.needs_rng
            and not op.needs_train_flag
            and not op.aux_names(node.parsed_attrs()))


def _unfused_on_cpu(x, taken):
    """Whether a site whose shapes the kernel takes (``taken``) or not runs
    the unfused ops instead: only on the CPU, never on CUDA."""
    return not taken and x.device.type == "cpu"


# ------------------------------------------------------------ matmul_bias_act
class MatmulBiasAct(Pattern):
    """FullyConnected(+bias) → Activation(relu|sigmoid|tanh|softrelu)."""

    name = "matmul_bias_act"

    def match(self, node, ctx):
        if node.op != "Activation" or id(node) in ctx.claimed:
            return None
        act = node.parsed_attrs().get("act_type")
        if act not in _mba.ACTIVATIONS:
            return None
        if not node.inputs or node.inputs[0][1] != 0:
            return None
        fc = node.inputs[0][0]
        if fc.is_variable or fc.op != "FullyConnected":
            return None
        if not _interior_ok(ctx, fc) or _sole_consumer(ctx, fc) is not node:
            return None
        a = fc.parsed_attrs()
        return Match(node, [fc], {"act": act,
                                  "flatten": bool(a.get("flatten", True)),
                                  "no_bias": bool(a.get("no_bias", False))})

    def externals(self, meta, ins, resolve):
        return tuple(resolve(v) for v in ins[0].ins)  # (x, w) or (x, w, b)

    def build(self, meta, args):
        x, w = args[0], args[1]
        if meta["flatten"]:
            m, k = int(x.shape[0]), int(np.prod(x.shape[1:]))
        else:
            m, k = int(np.prod(x.shape[:-1])), int(x.shape[-1])
        n = int(w.shape[0])
        if _unfused_on_cpu(x, k == int(w.shape[1])):
            return None
        act, flatten = meta["act"], meta["flatten"]

        def fused(x, w, b=None):
            y = _mba.MatmulBiasAct.apply(x.reshape(m, k).contiguous(), w.contiguous(),
                                         None if b is None else b.contiguous(), act)
            return y if flatten else y.reshape(tuple(x.shape[:-1]) + (n,))

        return fused


# ------------------------------------------------------------------ attention
class Attention(Pattern):
    """The fused MultiHeadAttention op, onto the flash-attention kernel."""

    name = "attention"
    _OPS = ("_contrib_MultiHeadAttention", "MultiHeadAttention")

    def match(self, node, ctx):
        if node.op not in self._OPS or id(node) in ctx.claimed:
            return None
        a = node.parsed_attrs()
        return Match(node, [], {"causal": bool(a.get("causal")),
                                "scale": float(a.get("scale", -1.0))})

    def externals(self, meta, ins, resolve):
        return tuple(resolve(v) for v in ins)  # (q, k, v)

    def build(self, meta, args):
        q, k, _ = args
        B, H, T, D = (int(s) for s in q.shape)
        S = int(k.shape[2])
        causal = meta["causal"]
        if _unfused_on_cpu(q, _fa.supported((B * H, T, D), (B * H, S, D), causal)):
            return None
        scale = meta["scale"] if meta["scale"] > 0 else 1.0 / math.sqrt(D)

        def flash(q, k, v):
            o = _fa.FlashAttention.apply(q.reshape(B * H, T, D).contiguous(),
                                         k.reshape(B * H, S, D).contiguous(),
                                         v.reshape(B * H, S, D).contiguous(), causal, scale)
            return o.reshape(B, H, T, D)

        return flash


# -------------------------------------------------------------- norm_residual
def _is_mean_last(node):
    if node.op != "mean":
        return False
    a = node.parsed_attrs()
    return (tuple(a.get("axis") or ()) == (-1,) and a.get("keepdims")
            and not a.get("exclude"))


class NormResidual(Pattern):
    """The LayerNorm composition the transformer zoo emits:

        mean → broadcast_sub → square → mean → +eps → rsqrt
             → broadcast_mul → broadcast_mul(gamma) → broadcast_add(beta)

    rooted at the final broadcast_add."""

    name = "norm_residual"

    def _chain(self, node, ctx):
        """The matched interior chain and meta, or (None, reason)."""
        if node.op != "broadcast_add" or len(node.inputs) != 2:
            return None, "not a 2-input broadcast_add"
        mul1 = mul1_slot = None
        for slot, (inp, oi) in enumerate(node.inputs):
            if (oi == 0 and not inp.is_variable and inp.op == "broadcast_mul"
                    and _interior_ok(ctx, inp)
                    and _sole_consumer(ctx, inp) is node):
                mul1, mul1_slot = inp, slot
                break
        if mul1 is None:
            return None, "no sole-consumer broadcast_mul feeds the add"
        mul0 = mul0_slot = None
        for slot, (inp, oi) in enumerate(mul1.inputs):
            if (oi == 0 and not inp.is_variable and inp.op == "broadcast_mul"
                    and _interior_ok(ctx, inp)
                    and _sole_consumer(ctx, inp) is mul1):
                mul0, mul0_slot = inp, slot
                break
        if mul0 is None or len(mul1.inputs) != 2:
            return None, "no gamma-scale broadcast_mul under the affine add"
        if len(mul0.inputs) != 2:
            return None, "normalize mul is not 2-input"
        cent = rs = cent_slot = None
        for slot, (inp, oi) in enumerate(mul0.inputs):
            if oi != 0 or inp.is_variable:
                return None, "normalize mul has a variable operand"
            if inp.op == "broadcast_sub":
                cent, cent_slot = inp, slot
            elif inp.op == "rsqrt":
                rs = inp
        if cent is None or rs is None:
            return None, "normalize mul is not centered*rsqrt"
        if not _interior_ok(ctx, rs) or _sole_consumer(ctx, rs) is not mul0:
            return None, "rsqrt output is consumed outside the chain"
        ps = rs.inputs[0][0] if rs.inputs else None
        if (ps is None or ps.is_variable or ps.op != "_plus_scalar"
                or not _interior_ok(ctx, ps)
                or _sole_consumer(ctx, ps) is not rs):
            return None, "no epsilon _plus_scalar under the rsqrt"
        m2 = ps.inputs[0][0]
        if (m2.is_variable or not _is_mean_last(m2)
                or not _interior_ok(ctx, m2)
                or _sole_consumer(ctx, m2) is not ps):
            return None, "variance is not a keepdims mean over the last axis"
        sq = m2.inputs[0][0]
        if (sq.is_variable or sq.op != "square" or not _interior_ok(ctx, sq)
                or _sole_consumer(ctx, sq) is not m2):
            return None, "variance operand is not square(centered)"
        if sq.inputs[0][0] is not cent:
            return None, "square input is not the centered activation"
        if not _interior_ok(ctx, cent):
            return None, "centered activation cannot be elided"
        cent_cons = {id(c) for c, _ in ctx.consumers.get(id(cent), [])}
        if cent_cons != {id(mul0), id(sq)}:
            return None, "centered activation is consumed outside the chain"
        if len(cent.inputs) != 2 or cent.inputs[0][1] != 0:
            return None, "center sub has unexpected inputs"
        m1 = cent.inputs[1][0]
        if (m1.is_variable or not _is_mean_last(m1)
                or not _interior_ok(ctx, m1)
                or _sole_consumer(ctx, m1) is not cent):
            return None, "center subtrahend is not a keepdims mean"
        if (m1.inputs[0][0] is not cent.inputs[0][0]
                or m1.inputs[0][1] != cent.inputs[0][1]):
            return None, "mean and center read different inputs"
        meta = {"eps": float(ps.parsed_attrs()["scalar"]),
                "mul1_slot": mul1_slot, "mul0_slot": mul0_slot,
                "cent_slot": cent_slot}
        return [mul1, mul0, cent, rs, ps, m2, sq, m1], meta

    def match(self, node, ctx):
        if node.op != "broadcast_add" or id(node) in ctx.claimed:
            return None
        interior, meta = self._chain(node, ctx)
        if interior is None:
            return None
        if any(id(n) in ctx.claimed for n in interior):
            return None
        return Match(node, interior, meta)

    def externals(self, meta, ins, resolve):
        l_mul1 = ins[meta["mul1_slot"]]
        beta = resolve(ins[1 - meta["mul1_slot"]])
        l_mul0 = l_mul1.ins[meta["mul0_slot"]]
        gamma = resolve(l_mul1.ins[1 - meta["mul0_slot"]])
        l_cent = l_mul0.ins[meta["cent_slot"]]
        x = resolve(l_cent.ins[0])
        return (x, gamma, beta)

    def build(self, meta, args):
        x = args[0]
        D = int(x.shape[-1])
        if _unfused_on_cpu(x, _nr.supported((1, D))):
            return None
        eps = meta["eps"]

        def layer_norm(x, gamma, beta):
            y = _nr.LayerNormAffine.apply(x.reshape(-1, D).contiguous(),
                                          gamma.reshape(D).contiguous(),
                                          beta.reshape(D).contiguous(), eps)
            return y.reshape(x.shape)

        return layer_norm


_PATTERNS = (Attention(), MatmulBiasAct(), NormResidual())


def get_patterns():
    """All patterns, in matching-priority order (as in mxnet_tpu)."""
    return _PATTERNS


def pattern_names():
    return tuple(p.name for p in _PATTERNS)
