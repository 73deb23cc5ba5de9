"""Declarative pattern registry for the subgraph fusion engine.

Counterpart of ``mxnet_tpu/ops/fusion_patterns.py``, its four patterns with
their matchers unchanged:

- ``attention``       — the MultiHeadAttention op, onto the flash-attention
  kernel (``ops/flash_attention.py``);
- ``matmul_bias_act`` — FullyConnected(+bias) → Activation, onto the
  matmul + bias + activation kernel (``ops/matmul_bias_act.py``);
- ``norm_residual``   — the LayerNorm composition the transformer zoo
  emits, onto the LayerNorm kernel (``ops/norm_residual.py``);
- ``elemwise_chain``  — runs of single-consumer unary elementwise ops, one
  grouping unit with no lowering distinct from the chain (``tunable =
  False``, as in the JAX package).

Contract per pattern: ``match(node, ctx)`` roots a ``Match`` (root,
interior nodes, meta) or returns None; interior nodes are single-output,
stateless, unclaimed and not program outputs, and the executor elides them
behind lazy markers. ``externals(meta, ins, resolve)`` recovers the
subgraph's external inputs. ``build(meta, args)`` returns ``(baseline,
[(name, fn), ...])`` as the JAX package's does: the baseline is the unfused
composition in PyTorch (library calls on the card: the measurement
reference), the candidates the port's kernel as its autograd Function,
under its launcher's own schedule. A schedule variant is added only where
a launcher already has a choice: ``matmul_bias_act``'s ``small_m`` and
``tiles`` (``cuda@schedule=<name>``). On a CPU tensor a candidate runs the
kernel's plain version, and a site whose shapes the kernel does not take
has no candidate (the unfused ops run); a CUDA site always has the kernel,
whose dispatcher raises where it does not take the shapes.

The fusion gate (``fusion.gate_pattern_explain``) picks a candidate per
site at bind: by ``MXNET_FUSED_PATTERNS``, by the measured verdict of
``fusion_tune`` under ``MXNET_FUSION_TUNE_DIR``, and otherwise (the port's
default) the kernel. A forced lowering name of the JAX package's
``pallas*`` family names the port's kernel candidate (``_port_name``), so
an environment written for the JAX package picks the same sites.
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

from .registry import get_op
from . import flash_attention as _fa
from . import matmul_bias_act as _mba
from . import norm_residual as _nr
from .nn import _ACTS

__all__ = ["Match", "Pattern", "get_patterns", "pattern_names", "sig_of",
           "tuner_build"]


class Match:
    __slots__ = ("root", "interior", "meta")

    def __init__(self, root, interior, meta):
        self.root, self.interior, self.meta = root, list(interior), dict(meta)


class Pattern:
    name = None
    inference = True  # may engage on grad-less (is_train=False) executions

    def key_variant(self, meta):
        """The meta component of the tune-cache key (shape-independent)."""
        return ""

    def match(self, node, ctx):
        raise NotImplementedError

    def externals(self, meta, ins, resolve):
        raise NotImplementedError

    def build(self, meta, args):
        raise NotImplementedError

    def reject_reason(self, node, ctx):
        return None


def _dtype_name(dt):
    if isinstance(dt, torch.dtype):
        return str(dt).rpartition(".")[2]
    return np.dtype(dt).name


def sig_of(args):
    """Canonical shape/dtype signature of the external inputs — the tune
    cache key's site component (JAX :83; a torch dtype prints as numpy's)."""
    return ";".join("%s%s" % (_dtype_name(a.dtype), tuple(int(d) for d in a.shape))
                    for a in args)


def _sched_budget():
    """How many schedule variants (beyond the default) a pattern may emit
    per candidate family (``MXNET_FUSION_TUNE_SCHEDULES``)."""
    from .. import fusion_tune

    return fusion_tune.schedule_budget()


_tuner_scope = threading.local()


# copied from mxnet_tpu/ops/fusion_patterns.py (tuner_build; backend-free)
@contextlib.contextmanager
def tuner_build():
    """Marks a ``build()`` call made to CONSTRUCT MEASUREMENT candidates
    (the auto-mode tuner): inside it ``_forced_lowering_requested`` reads
    False, so a force of one execution mode never steers a measurement."""
    _tuner_scope.active = True
    try:
        yield
    finally:
        _tuner_scope.active = False


def _port_name(name):
    """The port's candidate name for a forced lowering name: the JAX
    package's ``pallas*`` family names the port's kernel (``pallas_flash``
    → ``cuda_flash``, ``pallas`` or ``pallas@bm=..`` → ``cuda``; the TPU
    block schedules have no counterpart); any other name is kept."""
    name = str(name)
    if name.startswith("pallas"):
        return "cuda" + name.partition("@")[0][len("pallas"):]
    return name


def _forced_lowering_requested(pattern_name, prefix):
    """Whether MXNET_FUSED_PATTERNS[_INFER] forces a lowering whose name
    (or its port name) starts with ``prefix`` for this pattern (JAX :125).
    Inside ``tuner_build`` it reads False."""
    if getattr(_tuner_scope, "active", False):
        return False
    from .. import fusion

    for infer in (False, True):
        m = fusion.enabled_patterns(infer=infer).get(pattern_name, "0")
        if m not in ("0", "1", "auto") and (m.startswith(prefix)
                                             or _port_name(m).startswith(prefix)):
            return True
    return False


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


def _apply1(node, *ins):
    """Run a single-output, stateless node on concrete values — the exact
    unfused semantics (the op the interpreter would call)."""
    outs, _ = get_op(node.op).apply(node.parsed_attrs(), list(ins),
                                    aux=[], is_train=False, rng=None)
    return outs[0]


def _one_dtype(*ts):
    """The operands (None kept) in their promoted dtype: a site whose
    operands mix float32 and bfloat16 (bfloat16 inputs over float32
    weights) runs the float32 kernel on them widened, so that its output
    has the unfused ops' dtype (the promoted one); the kernels take one
    dtype, whose form (f32 or bf16) they launch."""
    dt = None
    for t in ts:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return tuple(t if t is None or t.dtype == dt else t.to(dt) for t in ts)


def _has_kernel(x, taken):
    """Whether a site gets its kernel candidate: always on CUDA (whose
    dispatcher raises where the kernel does not take the shapes), and on
    the CPU where the kernel's plain version takes them."""
    return taken or x.device.type != "cpu"


# ------------------------------------------------------------ matmul_bias_act
class MatmulBiasAct(Pattern):
    """FullyConnected(+bias) → Activation(relu|sigmoid|tanh|softrelu)."""

    name = "matmul_bias_act"

    def key_variant(self, meta):
        return "%s%s%s" % (meta["act"],
                           "" if meta["flatten"] else ",noflat",
                           ",nobias" if meta["no_bias"] else "")

    _ACTS = _mba.ACTIVATIONS

    def match(self, node, ctx):
        if node.op != "Activation" or id(node) in ctx.claimed:
            return None
        act = node.parsed_attrs().get("act_type")
        if act not in self._ACTS:
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

    # copied from mxnet_tpu/ops/fusion_patterns.py (reject_reason; backend-free)
    def reject_reason(self, node, ctx):
        if node.op != "FullyConnected":
            return None
        cons = ctx.consumers.get(id(node), [])
        acts = [c for c, oi in cons if oi == 0 and c.op == "Activation"
                and c.parsed_attrs().get("act_type") in self._ACTS]
        if not acts:
            return None
        if len(cons) != 1:
            return ("its output has %d consumers; the activation epilogue "
                    "needs the FullyConnected consumed exactly once"
                    % len(cons))
        if id(node) in ctx.output_ids:
            return "its output is a program output and must materialize"
        return None

    def externals(self, meta, ins, resolve):
        return tuple(resolve(v) for v in ins[0].ins)  # (x, w) or (x, w, b)

    def build(self, meta, args):
        act, flatten = meta["act"], meta["flatten"]
        act_fn = _ACTS[act]

        def baseline(x, w, b=None):
            if flatten:
                y = torch.matmul(x.reshape(x.shape[0], -1) if x.ndim != 2 else x, w.t())
            else:
                y = torch.matmul(x, w.t())
            if b is not None:
                y = y + b
            return act_fn(y)

        x, w = args[0], args[1]
        if flatten:
            m, k = int(x.shape[0]), int(np.prod(x.shape[1:]))
        else:
            m, k = int(np.prod(x.shape[:-1])), int(x.shape[-1])
        n = int(w.shape[0])
        cands = []
        if k == int(w.shape[1]):

            def make(schedule):
                def fused(x, w, b=None):
                    x, w, b = _one_dtype(x, w, b)
                    y = _mba.MatmulBiasAct.apply(x.reshape(m, k).contiguous(), w.contiguous(),
                                                 None if b is None else b.contiguous(), act,
                                                 schedule)
                    return y if flatten else y.reshape(tuple(x.shape[:-1]) + (n,))

                return fused

            default = _mba._schedule(m, n, k)
            cands.append(("cuda", make(None)))
            others = [s for s in _mba.SCHEDULES if s != default
                      and (s != "small_m" or _mba._small_m_takes(m, k))]
            cands.extend(("cuda@schedule=%s" % s, make(s)) for s in others[:_sched_budget()])
        return baseline, cands


# ------------------------------------------------------------------ attention
class Attention(Pattern):
    """The fused MultiHeadAttention op, onto the flash-attention kernel
    (forward and backward: training through the site never stashes the
    (B, H, T, S) probabilities)."""

    name = "attention"

    def key_variant(self, meta):
        return ("causal" if meta["causal"] else "full") + (
            ",s%g" % meta["scale"] if meta["scale"] > 0 else "")

    _OPS = ("_contrib_MultiHeadAttention", "MultiHeadAttention")

    def match(self, node, ctx):
        if node.op not in self._OPS or id(node) in ctx.claimed:
            return None
        a = node.parsed_attrs()
        return Match(node, [], {"causal": bool(a.get("causal")),
                                "scale": float(a.get("scale", -1.0))})

    def reject_reason(self, node, ctx):
        return None  # every attention node roots a match

    def externals(self, meta, ins, resolve):
        return tuple(resolve(v) for v in ins)  # (q, k, v)

    def build(self, meta, args):
        q, k, _ = args
        B, H, T, D = (int(s) for s in q.shape)
        S = int(k.shape[2])
        causal = meta["causal"]
        scale = meta["scale"] if meta["scale"] > 0 else 1.0 / math.sqrt(D)

        def baseline(q, k, v):
            # the dense composition: scores, the bottom-right causal mask,
            # softmax, the weighted sum (in float32 or wider)
            wide = torch.promote_types(q.dtype, torch.float32)
            s = torch.matmul(q.to(wide), k.to(wide).transpose(-1, -2)) * scale
            if causal:
                mask = torch.ones((T, S), dtype=torch.bool, device=s.device).tril(S - T)
                s = s.masked_fill(~mask, float("-inf"))
            return torch.matmul(torch.softmax(s, dim=-1), v.to(wide)).to(q.dtype)

        def flash(q, k, v):
            q, k, v = _one_dtype(q, k, v)
            o = _fa.FlashAttention.apply(q.reshape(B * H, T, D).contiguous(),
                                         k.reshape(B * H, S, D).contiguous(),
                                         v.reshape(B * H, S, D).contiguous(), causal, scale)
            return o.reshape(B, H, T, D)

        taken = _fa.supported((B * H, T, D), (B * H, S, D), causal)
        return baseline, [("cuda_flash", flash)] if _has_kernel(q, taken) else []


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

    def key_variant(self, meta):
        return "eps%g" % meta["eps"]

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
        eps = meta["eps"]

        def baseline(x, gamma, beta):
            mean = x.mean(dim=-1, keepdim=True)
            cent = x - mean
            var = (cent * cent).mean(dim=-1, keepdim=True)
            return (cent * torch.rsqrt(var + eps)) * gamma + beta

        x = args[0]
        D = int(x.shape[-1])

        def layer_norm(x, gamma, beta):
            x, gamma, beta = _one_dtype(x, gamma, beta)
            y = _nr.LayerNormAffine.apply(x.reshape(-1, D).contiguous(),
                                          gamma.reshape(D).contiguous(),
                                          beta.reshape(D).contiguous(), eps)
            return y.reshape(x.shape)

        taken = _nr.supported((1, D))
        return baseline, [("cuda", layer_norm)] if _has_kernel(x, taken) else []


# ------------------------------------------------------------- elemwise_chain
# copied from mxnet_tpu/ops/fusion_patterns.py (ElemwiseChain; backend-free)
class ElemwiseChain(Pattern):
    """Runs of ≥2 single-consumer unary elementwise ops, composed into one
    lowering unit (one fusion decision instead of N).

    ``tunable = False``: the composed lowering is the unfused chain itself,
    so auto mode never measures it; ``=1`` force-engages."""

    name = "elemwise_chain"
    tunable = False

    def key_variant(self, meta):
        parts = []
        for n in meta["nodes"]:
            if n.op == "Activation":
                parts.append(n.parsed_attrs().get("act_type"))
            elif n.op.endswith("_scalar"):
                parts.append("%s(%g)" % (n.op, n.parsed_attrs()["scalar"]))
            else:
                parts.append(n.op)
        return "-".join(parts)

    _UNARY = frozenset({
        "abs", "square", "sqrt", "rsqrt", "exp", "log", "log1p", "expm1",
        "negative", "reciprocal", "relu", "sigmoid", "tanh", "softsign",
        "_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
    })

    def _link_ok(self, node):
        if node.is_variable:
            return False
        if node.op == "Activation":
            return node.parsed_attrs().get("act_type") in (
                "relu", "sigmoid", "tanh", "softrelu")
        return node.op in self._UNARY

    def match(self, node, ctx):
        if id(node) in ctx.claimed or node.is_variable:
            return None
        if not self._link_ok(node):
            return None
        # only root at the END of a chain: a sole whitelisted consumer
        # would extend it, so let that consumer root instead
        nxt = _sole_consumer(ctx, node)
        if (nxt is not None and self._link_ok(nxt)
                and id(nxt) not in ctx.claimed
                and id(node) not in ctx.output_ids):
            return None
        chain = []
        cur = node
        while True:
            if not cur.inputs or cur.inputs[0][1] != 0:
                break
            prev = cur.inputs[0][0]
            if (not self._link_ok(prev) or not _interior_ok(ctx, prev)
                    or _sole_consumer(ctx, prev) is not cur):
                break
            chain.append(prev)
            cur = prev
        if not chain:
            return None
        nodes = list(reversed(chain)) + [node]  # innermost-first, root last
        return Match(node, chain, {"nodes": nodes})

    def externals(self, meta, ins, resolve):
        from .. import fusion

        v = ins[0]
        while isinstance(v, fusion.Lazy):
            v = v.ins[0]
        return (resolve(v),)

    def build(self, meta, args):
        nodes = meta["nodes"]  # innermost-first list incl. root last

        def baseline(x):
            for n in nodes:
                x = _apply1(n, x)
            return x

        return baseline, [("fused", baseline)]


_PATTERNS = (Attention(), MatmulBiasAct(), NormResidual(), ElemwiseChain())


def get_patterns():
    """All registered patterns, in matching-priority order."""
    return _PATTERNS


def pattern_names():
    return tuple(p.name for p in _PATTERNS)
