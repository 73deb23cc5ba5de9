"""Pattern-based subgraph fusion over the Symbol DAG.

Counterpart of ``mxnet_tpu/fusion.py``, both of its sides, one engine.

**Conv+BN** (JAX :5-35). Three rewrites compose along the pre-activation
ResNet chain (BN -> relu -> Conv -> [+res] -> BN ...; ``models/resnet.py``),
onto the fused kernels of ``ops/conv_bn.py``:

- **prologue fold**: a BatchNorm whose (relu) output feeds only eligible
  convolutions never materialises; its per-channel ``scale``/``shift`` ride
  into each consumer kernel's prologue (a ``Deferred`` value);
- **stats reuse**: a BatchNorm whose input carries the kernel's
  ``(Σc, Σc²)`` (a ``WithStats`` value) skips its statistics pass;
- **residual defer**: a convolution whose only consumer is an elementwise
  add runs at the add (a ``PendingConv``), the other operand in its
  epilogue, and the sum's statistics feed the next BatchNorm.

Every planned conv site takes the kernel where its gate engages it:
``ConvBlock`` (forward with statistics, fused backward) in a training
forward, the stats-free ``conv_block_infer`` in an inference forward. A
declined site runs ``F.conv2d`` on the materialised input, as the JAX
package runs ``_xla_conv`` there. In a fused step whose mesh spans
processes (one rank a process on the data axis) a site runs the kernel on
the rank's own rows and ``all_reduce``s its (Σc, Σc²) over the mesh's group
(``_conv_block_sharded``, JAX :1101-1160), and an unfused BatchNorm sums its
statistics the same way, so every BatchNorm sees the global batch's
moments, as the reference's ``psum`` gives. The BatchNorm arithmetic is
plain torch, so autograd carries gamma's and beta's gradients through
``scale``/``shift`` into the kernel's prologue cotangents.

**Generic patterns** (``Lazy``/``resolve`` :131-168, ``plan`` :385,
``_exec_pattern``/``execute`` :997-1048) over the four patterns of
``ops/fusion_patterns.py``. ``plan`` roots each match in a directive map and
marks its interior nodes ``lazy``.

**The gates** (JAX :265-957, :1245): ``MXNET_FUSED_CONV_BN=0|1|auto``,
``MXNET_FUSED_CONV_BN_BWD``, ``MXNET_FUSED_PATTERNS[_INFER]`` (the JAX
grammar; a ``pallas*`` lowering name names the port's kernel),
``MXNET_SERVE_QUANT`` and the measured verdicts of ``fusion_tune`` under
``MXNET_FUSION_TUNE_DIR``. The JAX package decides each site once per
trace; the port runs eagerly, so ``resolve_sites`` decides every site once
at bind, at the bind's shapes, into a copy of its directive (``train``,
``infer``, ``quant``, ``key``), and an executor, a fused step's shape or a
decode program runs that map: no gate, lookup or measurement runs per
forward or inside a CUDA-graph capture. A planned site whose input shapes
do not infer at bind raises there.

Departures (ROADMAP.md section 3): the port has no measured-win table, so
with no tune verdict ``auto`` engages every site its shape gate admits (the
JAX package engages none off the TPU); a tuned verdict may put a library
call in a kernel's place only under an explicit ``MXNET_FUSION_TUNE_DIR``;
a kernel that raises while measured re-raises (``fusion_tune``);
``conv_schedule`` returns None (the kernels have no stripe override); with
no VMEM budget to fit, the stash backward runs wherever the recompute
tiles. ``MXNET_SERVE_QUANT=bf16`` resolves the inference gate at bfloat16,
as the JAX package gates the cast operands, and runs the stats-free
kernel's bf16 form where it engages and the library's bfloat16 conv where
it declines, c back in the activation's dtype; ``int8`` feeds the
per-channel quantized weight in float32 to the stats-free kernel.
Counters ``fusion.{fwd,infer}_{engaged,fallback}``,
``fusion.bwd_{engaged,xla}`` and ``fusion.pattern_{engaged,fallback}.<name>``
count the decisions where they are made (at bind for a resolved site).

Training needs no switch here: the executor runs a training forward under
autograd, a site's lowering records its kernel's autograd Function, and a
marker that a consumer outside the site materialises runs ordinary torch
ops, which carry their gradients like any other node.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from .base import MXNetError, torch_dtype
from .ops import conv_bn as _cb
from .ops.attention import ring_takes
from .ops.fusion_patterns import _dtype_name, _port_name, get_patterns, pattern_names
from .ops.registry import get_op
from . import telemetry as _tm

__all__ = ["Deferred", "WithStats", "PendingConv", "Lazy", "resolve", "plan", "plan_sites",
           "execute", "conv_reject_reason", "bn_reject_reason", "CONV_BN_KINDS",
           "attention_trains_flash", "gate", "gate_explain", "bwd_mode", "infer_default",
           "quant_mode", "enabled_patterns", "gate_pattern_explain", "conv_schedule",
           "losers_note", "tuned_reject_note", "resolve_sites"]

_LOG = logging.getLogger("mxnet_tpu")

#: directive kinds owned by the conv+BN side of the planner
CONV_BN_KINDS = frozenset({"conv", "bn", "relu_fold", "resadd"})


# --------------------------------------------------------------------- values
class Deferred:
    """A folded BN(+relu) output, ``relu(raw·scale + shift)``, not yet
    materialised. ``materialize()`` computes (and caches) it for consumers
    that are not a fused conv."""

    __slots__ = ("raw", "scale", "shift", "relu", "_mat")

    def __init__(self, raw, scale, shift, relu=False):
        self.raw, self.scale, self.shift, self.relu = raw, scale, shift, relu
        self._mat = None

    def with_relu(self):
        return Deferred(self.raw, self.scale, self.shift, relu=True)

    def materialize(self):
        if self._mat is None:
            out = _Normalize.apply(self.raw, self.scale, self.shift)
            self._mat = torch.relu(out) if self.relu else out
        return self._mat


class WithStats:
    """A conv/add output plus the kernel's per-channel f32 (Σc, Σc²)."""

    __slots__ = ("c", "ssum", "ssq")

    def __init__(self, c, ssum, ssq):
        self.c, self.ssum, self.ssq = c, ssum, ssq


class PendingConv:
    """A conv deferred to its consuming residual add; ``bwd`` is its
    backward policy (``bwd_mode``)."""

    __slots__ = ("x", "w", "scale", "shift", "relu", "stride", "bwd")

    def __init__(self, x, w, scale, shift, relu, stride, bwd="recompute"):
        self.x, self.w = x, w
        self.scale, self.shift, self.relu, self.stride = scale, shift, relu, stride
        self.bwd = bwd

    def run(self, res):
        mesh = _cross_process_mesh()
        if mesh is not None:
            return _conv_block_sharded(mesh, self.x, self.w, self.scale, self.shift, res,
                                       self.stride, self.relu, self.bwd)
        return _cb.ConvBlock.apply(self.x, self.w, self.scale, self.shift, res, self.stride,
                                   self.relu, self.bwd)


class Lazy:
    """A pattern-interior node's not-yet-computed output. ``materialize()``
    runs the ordinary op (the unfused semantics) and caches the value."""

    __slots__ = ("node", "ins", "_mat")

    def __init__(self, node, ins):
        self.node, self.ins = node, list(ins)
        self._mat = None

    def materialize(self):
        if self._mat is None:
            outs, _ = get_op(self.node.op).apply(self.node.parsed_attrs(),
                                                 [resolve(v) for v in self.ins])
            self._mat = outs[0]
        return self._mat


def resolve(v):
    """Any op that is not fusion-aware sees a plain tensor."""
    if isinstance(v, WithStats):
        return v.c
    if isinstance(v, (Deferred, Lazy)):
        return v.materialize()
    if isinstance(v, PendingConv):
        # plan() keeps graph-output convs out of the defer rewrite, so a
        # marker reaches only its resadd; alone its value is the conv output
        return v.run(None)[0]
    return v


# ---------------------------------------------------- normalize (autograd)
class _Normalize(torch.autograd.Function):
    """``x·scale + shift`` per channel (axis 1) with float32 accumulators
    for the per-channel reductions of its backward (JAX ``_normalize``
    :172-196)."""

    @staticmethod
    def forward(ctx, x, scale32, shift32):
        b = (1, -1) + (1,) * (x.ndim - 2)
        ctx.save_for_backward(x, scale32)
        return x * scale32.to(x.dtype).reshape(b) + shift32.to(x.dtype).reshape(b)

    @staticmethod
    def backward(ctx, dout):
        x, scale32 = ctx.saved_tensors
        b = (1, -1) + (1,) * (x.ndim - 2)
        axes = (0,) + tuple(range(2, x.ndim))
        acc = torch.promote_types(x.dtype, torch.float32)
        dx = dout * scale32.to(dout.dtype).reshape(b)
        dout32 = dout.to(acc)
        return dx, (dout32 * x.to(acc)).sum(dim=axes), dout32.sum(dim=axes)


# ------------------------------------------------------- across processes
def _cross_process_mesh():
    """The mesh of the fused step being run when it spans processes, else
    None (JAX ``_mesh_kind`` :1104). Such a mesh is one data axis, one rank
    a process (``parallel/mesh.py``); within one process a step runs the
    global batch at once, so its statistics are global already."""
    from .parallel.mesh import current_trace_mesh

    mesh = current_trace_mesh()
    if mesh is None or mesh.process_count <= 1:
        return None
    return mesh


class _AllReduceSum(torch.autograd.Function):
    """Per-rank sums to their sum over the mesh's group. The sum feeds every
    rank's downstream, so its cotangent is the sum of the ranks'
    cotangents: the backward ``all_reduce``s them too (the transpose of the
    reference's ``psum`` over a replicated result)."""

    @staticmethod
    def forward(ctx, group, *sums):
        import torch.distributed as tdist

        ctx.group = group
        outs = tuple(s.clone() for s in sums)
        for o in outs:
            tdist.all_reduce(o, group=group)
        return outs

    @staticmethod
    def backward(ctx, *cts):
        import torch.distributed as tdist

        cts = tuple(c.clone() for c in cts)
        for c in cts:
            tdist.all_reduce(c, group=ctx.group)
        return (None,) + cts


def _global_moments(x, mesh, sums=None):
    """The per-channel (axis 1) mean and variance of the batch ``x`` is a
    rank's rows of, from Σx and Σx²: ``sums``, a kernel's (summed over the
    mesh already), or taken here in float32 or wider and summed over the
    processes of ``mesh`` (None: one process). The count is the global
    batch's: every rank feeds as many rows."""
    if sums is None:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = (0,) + tuple(range(2, x.ndim))
        sums = x32.sum(dim=axes), (x32 * x32).sum(dim=axes)
        if mesh is not None:
            sums = _AllReduceSum.apply(mesh.group, *sums)
    cnt = x.numel() // x.shape[1] * (1 if mesh is None else mesh.process_count)
    mean = sums[0] / cnt
    return mean, sums[1] / cnt - mean * mean


def _conv_block_sharded(mesh, x, w, scale, shift, res, stride, relu, bwd="recompute"):
    """The kernel on this rank's rows (``x`` and ``res`` are the rank's
    rows), then the per-rank statistics summed over the mesh, so the
    downstream BatchNorm sees GLOBAL-batch moments (JAX :1123-1158, where
    ``shard_map`` runs the kernel per data shard and ``psum``s Σc, Σc²)."""
    c, ssum, ssq = _cb.ConvBlock.apply(x, w, scale, shift, res, stride, relu, bwd)
    ssum, ssq = _AllReduceSum.apply(mesh.group, ssum, ssq)
    return c, ssum, ssq


# ----------------------------------------------------------------------- plan
def _pair(v, fill):
    v = tuple(v or ())
    return v if len(v) == 2 else (fill, fill)


# copied from mxnet_tpu/fusion.py (conv_reject_reason :205, backend-free)
def conv_reject_reason(node):
    """The exact predicate that bars this Convolution from the fused path,
    or None when it is structurally eligible (the shape gate still runs on
    the site's shapes)."""
    if node.op != "Convolution":
        return "not a Convolution"
    if len(node.inputs) != 2:
        return "bias input present (no_bias=False): the kernel has no bias epilogue"
    a = node.parsed_attrs()
    kernel = tuple(a.get("kernel") or ())
    stride = _pair(a.get("stride"), 1)
    pad = _pair(a.get("pad"), 0)
    dilate = _pair(a.get("dilate"), 1)
    if a.get("num_group", 1) != 1:
        return "grouped convolution (num_group=%s != 1)" % a.get("num_group")
    if dilate != (1, 1):
        return "dilated convolution (dilate=%s)" % (dilate,)
    if kernel == (1, 1):
        if pad != (0, 0):
            return "1x1 kernel needs pad=(0, 0), got pad=%s" % (pad,)
        if stride not in ((1, 1), (2, 2)):
            return "1x1 kernel needs stride (1, 1) or (2, 2), got %s" % (stride,)
        return None
    if kernel == (3, 3):
        if pad != (1, 1):
            return "3x3 kernel needs pad=(1, 1), got pad=%s" % (pad,)
        if stride != (1, 1):
            return "3x3 kernel needs stride=(1, 1), got %s" % (stride,)
        return None
    return ("kernel %s has no fused variant (supported: 1x1 pad 0 stride "
            "1 or 2; 3x3 pad 1 stride 1)" % (kernel,))


def _conv_cfg(node):
    """(kernel, stride) if this Convolution can take the fused path
    (structurally; the shape gate runs on the site's shapes), else None."""
    if conv_reject_reason(node) is not None:
        return None
    a = node.parsed_attrs()
    return tuple(a.get("kernel") or ()), _pair(a.get("stride"), 1)


# copied from mxnet_tpu/fusion.py (bn_reject_reason :248, backend-free)
def bn_reject_reason(node):
    """The exact predicate that bars this BatchNorm from the fusion plan,
    or None when eligible."""
    if node.op != "BatchNorm":
        return "not a BatchNorm"
    a = node.parsed_attrs()
    if a.get("use_global_stats"):
        return "use_global_stats=True: inference-style BN never runs the batch statistics pass the fusion reuses"
    if a.get("output_mean_var"):
        return "output_mean_var=True: the mean/var outputs must materialize, so the BN cannot stay folded"
    return None


def _bn_ok(node):
    return bn_reject_reason(node) is None


class _PlanCtx:
    """What pattern matchers may see of the graph: the consumer map, the
    program-output ids, and the directives built so far (``claimed``)."""

    __slots__ = ("consumers", "output_ids", "claimed")

    def __init__(self, consumers, output_ids, claimed):
        self.consumers, self.output_ids = consumers, output_ids
        self.claimed = claimed


def plan(topo, output_ids=()):
    """Build the fusion plan: id(node) -> directive dict. Structural only.

    Two passes: the conv+BN rewrites (unless ``MXNET_FUSED_CONV_BN=0``),
    then each enabled pattern (``enabled_patterns()``, the training or the
    inference map), in priority order, over the still-unclaimed nodes (a
    matched root gets a ``pattern`` directive, its interior nodes ``lazy``
    markers). ``output_ids`` are the nodes whose values are program
    outputs: they are never folded, deferred or a pattern's interior, since
    their values must materialise."""
    output_ids = frozenset(output_ids)
    consumers = {}
    for node in topo:
        for inp, oi in node.inputs:
            consumers.setdefault(id(inp), []).append((node, oi))
    order = {id(n): i for i, n in enumerate(topo)}
    directives = {}
    if os.environ.get("MXNET_FUSED_CONV_BN", "auto") != "0":
        _plan_conv_bn(topo, output_ids, consumers, order, directives)
    # a pattern is PLANNED when either the training or the inference map
    # enables it; each execution's gate reads its own map
    modes = enabled_patterns()
    for name, mode in enabled_patterns(infer=True).items():
        if modes.get(name, "0") == "0" and mode != "0":
            modes[name] = mode
    ctx = _PlanCtx(consumers, output_ids, directives)
    for pat in get_patterns():
        if modes.get(pat.name, "0") == "0":
            continue
        for node in topo:
            if node.is_variable or id(node) in directives:
                continue
            m = pat.match(node, ctx)
            if m is None:
                continue
            directives[id(node)] = {"kind": "pattern", "pat": pat, "meta": m.meta}
            for n in m.interior:
                directives[id(n)] = {"kind": "lazy"}
    return directives


# copied from mxnet_tpu/fusion.py (_plan_conv_bn :439, backend-free)
def _plan_conv_bn(topo, output_ids, consumers, order, directives):
    """The conv+BN rewrite pass (prologue fold, stats reuse, residual
    defer); fills ``directives`` in place."""
    conv_nodes = {}
    for node in topo:
        if node.is_variable:
            continue
        cfg = _conv_cfg(node)
        if cfg is not None:
            directives[id(node)] = {"kind": "conv", "kernel": cfg[0],
                                    "stride": cfg[1], "defer": False}
            conv_nodes[id(node)] = node
        elif _bn_ok(node):
            directives[id(node)] = {"kind": "bn", "fold": False}

    def _is_fusable_conv_data_edge(cons_node, producer):
        d = directives.get(id(cons_node))
        return (d is not None and d["kind"] == "conv"
                and cons_node.inputs[0][0] is producer)

    # prologue folds: BN (-> relu) whose every consumer is a fusable conv's
    # data input
    for node in topo:
        d = directives.get(id(node))
        if not d or d["kind"] != "bn":
            continue
        cons = consumers.get(id(node), [])
        if not cons:
            continue
        relu_node = None
        targets = [c for c, oi in cons if oi == 0]
        if len(cons) == 1 and len(targets) == 1:
            c0 = targets[0]
            if (c0.op == "Activation"
                    and c0.parsed_attrs().get("act_type") == "relu"):
                relu_node = c0
                targets = [c for c, oi in consumers.get(id(c0), []) if oi == 0]
                if len(targets) != len(consumers.get(id(c0), [])):
                    continue
        src = relu_node if relu_node is not None else node
        if id(node) in output_ids or id(src) in output_ids:
            continue  # the BN (or its relu) value materializes regardless
        if targets and all(_is_fusable_conv_data_edge(c, src)
                           for c in targets):
            d["fold"] = True
            if relu_node is not None:
                directives[id(relu_node)] = {"kind": "relu_fold"}

    # residual defers: elemwise_add with an operand whose only consumer is
    # the add and whose producer is a fusable conv
    for node in topo:
        if node.op != "elemwise_add" or len(node.inputs) != 2:
            continue
        best = None
        for slot, (inp, oi) in enumerate(node.inputs):
            if oi != 0 or id(inp) not in conv_nodes:
                continue
            if id(inp) in output_ids:
                continue  # program output: the conv must materialize
            if len(consumers.get(id(inp), [])) != 1:
                continue
            if best is None or order[id(inp)] > order[id(best[1])]:
                best = (slot, inp)
        if best is not None:
            slot, conv = best
            directives[id(conv)]["defer"] = True
            directives[id(node)] = {"kind": "resadd", "pending_slot": slot}
    return directives


def plan_sites(directives):
    """The static site inventory of one plan: ``(pattern_sites,
    conv_bn_directives)``, the per-pattern site counts and the number of
    conv+BN directives (JAX :358)."""
    sites, conv_bn = {}, 0
    for d in directives.values():
        if d["kind"] == "pattern":
            sites[d["pat"].name] = sites.get(d["pat"].name, 0) + 1
        elif d["kind"] in CONV_BN_KINDS:
            conv_bn += 1
    return sites, conv_bn


# ----------------------------------------------------------------- env maps
def enabled_patterns(infer=False):
    """Per-pattern mode map from ``MXNET_FUSED_PATTERNS``: name ->
    ``"auto"`` (engage per the gate), ``"1"`` (force the first candidate),
    ``"0"`` (off), or a LOWERING NAME (force that candidate where it
    exists; prefix-matched, and a ``pallas*`` name names the port's
    kernel). Grammar (JAX :265-299): ``auto``/``all`` (every pattern in
    auto, the default), ``0``/``off``/``none``, or a comma list of names
    with optional forces (``attention,matmul_bias_act=1``) — listed
    patterns get their mode, unlisted ones are off. ``infer=True`` reads
    ``MXNET_FUSED_PATTERNS_INFER`` when set (the grad-less executions'
    map). Memoized on the raw env string; callers get a fresh copy."""
    names = pattern_names()
    env = os.environ.get("MXNET_FUSED_PATTERNS", "auto").strip().lower()
    if infer:
        env = os.environ.get("MXNET_FUSED_PATTERNS_INFER",
                             env).strip().lower() or env
    cached = _patterns_env_memo.get(env)
    if cached is not None:
        return dict(cached)
    modes = _parse_patterns_env(env, names)
    _patterns_env_memo[env] = modes
    return dict(modes)


# copied from mxnet_tpu/fusion.py (_parse_patterns_env :302; backend-free)
def _parse_patterns_env(env, names):
    if env in ("", "auto", "all", "1"):
        return {n: "auto" for n in names}
    if env in ("0", "off", "none"):
        return {n: "0" for n in names}
    modes = {n: "0" for n in names}
    for item in env.split(","):
        item = item.strip()
        if not item:
            continue
        if item in ("auto", "all"):
            modes = {n: "auto" for n in names}
            continue
        name, _, val = item.partition("=")
        if name in modes:
            if val in ("0", "1"):
                modes[name] = val
            elif val in ("", "auto"):
                modes[name] = "auto"
            else:
                # a forced lowering NAME; one matching no known lowering
                # family warns once (it would silently unfuse every site)
                modes[name] = val
                if (val not in _warned_forced_vals
                        and not val.startswith(_LOWERING_FAMILIES)):
                    _warned_forced_vals.add(val)
                    _LOG.warning(
                        "MXNET_FUSED_PATTERNS treats %s=%r as a FORCED "
                        "lowering name, and it matches no known lowering "
                        "family %s: every site will run unfused (use "
                        "auto/0/1 for the mode grammar)",
                        name, val, list(_LOWERING_FAMILIES))
        else:
            global _warned_patterns_env
            if not _warned_patterns_env:
                _warned_patterns_env = True
                _LOG.warning("MXNET_FUSED_PATTERNS names unknown pattern %r "
                             "(known: %s)", name, ", ".join(names))
    return modes


_warned_patterns_env = False
_warned_forced_vals = set()
_patterns_env_memo = {}
#: candidate-name families the patterns emit (forced-name validation): the
#: JAX package's, and the port's kernels' ``cuda``
_LOWERING_FAMILIES = ("pallas", "block_causal", "chunked_kv", "fused",
                      "onepass", "xla", "cuda")


# ------------------------------------------------------------- conv+BN gate
def _conv_bn_key(kernel, stride, x_shape, w_shape, dtype, res):
    return "conv_bn|k%ds%d%s|%s%s;%s" % (
        kernel[0], stride[0], "pr" if res else "p",
        _dtype_name(dtype), tuple(int(d) for d in x_shape),
        tuple(int(d) for d in w_shape))


#: the backward policies a conv+BN site's tune measures (``cuda:<policy>``)
BWD_POLICIES = ("xla", "recompute", "stash")


def _conv_bn_measure(kernel, stride, x_shape, w_shape, dtype, res):
    """One conv+BN site's fwd+bwd measurement: the library (``F.conv2d`` of
    the normalised input, the residual, the two sums, and autograd's
    backward) against ``ConvBlock`` under each backward policy, as JAX
    measures its ``pallas:*`` ones (:576-596): ``cuda:xla`` (kernel
    forward, library backward), ``cuda:recompute`` (both kernels) and
    ``cuda:stash`` (both kernels' stash forms). At bfloat16, the dtype of the
    bf16 training step and of the ``MXNET_SERVE_QUANT=bf16`` inference
    gate, ``_conv_bn_measure_bf16``."""
    from .context import current_context
    from .fusion_tune import measure_candidates

    if _dtype_name(dtype) == "bfloat16":
        return _conv_bn_measure_bf16(kernel, stride, x_shape, w_shape, res)

    rs = np.random.RandomState(0)
    dev = current_context().torch_device
    dt = np.dtype(_dtype_name(dtype))
    K = x_shape[1]
    host = [rs.randn(*x_shape).astype(dt), (rs.randn(*w_shape) * 0.1).astype(dt),
            rs.uniform(0.5, 1.5, (K,)).astype(np.float32),
            rs.uniform(-0.2, 0.2, (K,)).astype(np.float32)]
    if res:
        Ho, Wo = _cb.strided_dims(x_shape[2], x_shape[3], stride)
        host.append((rs.randn(x_shape[0], w_shape[0], Ho, Wo) * 0.1).astype(dt))
    args = tuple(torch.from_numpy(a).to(dev) for a in host)

    def baseline(x, w, scale, shift, r=None):
        return _cb.conv_block_plain(x, w, scale, shift, r, stride, True)

    def fused(x, w, scale, shift, r=None, bwd="recompute"):
        return _cb.ConvBlock.apply(x, w, scale, shift, r, stride, True, bwd)

    cands = [("cuda:" + policy, lambda *a, _p=policy: fused(*a, bwd=_p))
             for policy in BWD_POLICIES]
    return measure_candidates(baseline, cands, args, train=True)


def _conv_bn_measure_bf16(kernel, stride, x_shape, w_shape, res):
    """A bfloat16 site's two verdicts in one record. Training (``engage``,
    ``lowering``: the bf16 training step's gate): fwd+bwd of what a
    declined site runs in bfloat16 (the library's bfloat16 conv of the
    folded BatchNorm's output, the residual, the two sums) against
    ``ConvBlock`` on bfloat16 operands under each backward policy, as
    ``_conv_bn_measure``. Inference (``engage_fwd``, ``lowering_fwd``:
    ``MXNET_SERVE_QUANT=bf16``'s gate), forward only: the library's
    bfloat16 conv of the bfloat16 prologue (``_conv_unfused_bf16``) against
    the stats-free kernel's bf16 form, on float32 operands (the serving
    path's). The operands are made from a seed."""
    from .context import current_context
    from .fusion_tune import measure_candidates

    rs = np.random.RandomState(0)
    dev = current_context().torch_device
    K = x_shape[1]
    host = [rs.randn(*x_shape), rs.randn(*w_shape) * 0.1, rs.uniform(0.5, 1.5, (K,)),
            rs.uniform(-0.2, 0.2, (K,))]
    args = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in host)
    pad, bf16 = (w_shape[2] - 1) // 2, torch.bfloat16

    def baseline(x, w, scale, shift):
        return _conv_unfused_bf16(x, w, scale, shift, True, stride)

    def fused(x, w, scale, shift):
        return _cb.conv_block_infer(x, w, scale, shift, stride, True, compute="bfloat16")

    infer = measure_candidates(baseline, [("cuda:bf16", fused)], args, train=False)

    train_args = (args[0].to(bf16), args[1].to(bf16)) + args[2:]
    if res:
        Ho, Wo = _cb.strided_dims(x_shape[2], x_shape[3], stride)
        r = rs.randn(x_shape[0], w_shape[0], Ho, Wo) * 0.1
        train_args += (torch.from_numpy(r.astype(np.float32)).to(dev).to(bf16),)

    def train_baseline(x, w, scale, shift, r=None):
        c = F.conv2d(torch.relu(_Normalize.apply(x, scale, shift)), w, stride=stride,
                     padding=pad)
        if r is not None:
            c = c + r
        c32 = c.float()
        return c, c32.sum(dim=(0, 2, 3)), (c32 * c32).sum(dim=(0, 2, 3))

    def fused_train(x, w, scale, shift, r=None, bwd="recompute"):
        return _cb.ConvBlock.apply(x, w, scale, shift, r, stride, True, bwd)

    cands = [("cuda:" + policy, lambda *a, _p=policy: fused_train(*a, bwd=_p))
             for policy in BWD_POLICIES]
    rec = measure_candidates(train_baseline, cands, train_args, train=True)
    rec["measured"].update(infer["measured"])
    rec["engage_fwd"] = infer["engage_fwd"]
    rec["lowering_fwd"] = infer.get("lowering_fwd")
    return rec


def _conv_bn_verdict(kernel, stride, x_shape, w_shape, dtype, res):
    """The measured verdict for this conv+BN site — cache hit, measure on
    miss (tuning enabled), else None."""
    from . import fusion_tune as _tune

    if _tune.cache_dir() is None:
        return None
    key = _conv_bn_key(kernel, stride, x_shape, w_shape, dtype, res)
    return _tune.verdict(key, lambda: _conv_bn_measure(
        kernel, stride, x_shape, w_shape, dtype, res))


def _conv_bn_peek(kernel, stride, x_shape, w_shape, dtype, res):
    """Cache-only read of the conv+BN verdict (never measures)."""
    from . import fusion_tune as _tune

    return _tune.peek(_conv_bn_key(kernel, stride, x_shape, w_shape, dtype, res))


def conv_schedule(kernel, stride, x_shape, w_shape, dtype, res):
    """The tuned forward stripe override for an engaged site (JAX :623):
    always None, since the port's conv kernels tile by their own schedule
    and take no override."""
    return None


def gate_explain(kernel, stride, x_shape, w_shape, dtype, prologue,
                 res=False, train=True):
    """The per-shape engage decision WITH the predicate that made it:
    ``(engaged, reason)``, in the JAX package's predicate order (:636):
    the env switch, the shape gate, the force, then the measured verdict.
    ``train=False`` reads the forward-only verdict. With no verdict (no
    tune directory, or none cached and tuning off) the port engages the
    site: it has no measured-win table to decline by."""
    env = os.environ.get("MXNET_FUSED_CONV_BN", "auto")
    if env == "0":
        return False, "MXNET_FUSED_CONV_BN=0 (fusion disabled)"
    if not _cb.supported(x_shape, w_shape, stride):
        return False, ("shape %sx%s is not taken by the kernels' shape gate "
                       "(supported() declined)" % (tuple(x_shape), tuple(w_shape)))
    if env == "1":
        return True, "forced (MXNET_FUSED_CONV_BN=1)"
    if not prologue:
        return True, ("bare conv (no folded BN prologue): never measured; the port "
                      "engages it where the shape gate admits it")
    rec = _conv_bn_verdict(kernel, stride, x_shape, w_shape, dtype, res)
    if rec is not None:
        want = "engage" if train else "engage_fwd"
        if rec.get(want):
            times = _rec_best_times(rec)
            return True, ("measured win (tuned: fused %.0fµs vs xla "
                          "%.0fµs fwd+bwd%s)"
                          % (times + (losers_note(rec, rec.get("lowering")),))
                          if times else "measured win (tuned)")
        return False, tuned_reject_note(rec)
    return True, ("no tune verdict (the port's default: every site its shape gate "
                  "admits engages)")


def gate(kernel, stride, x_shape, w_shape, dtype, prologue, res=False,
         train=True):
    """Per-shape engage decision (``gate_explain`` without the reason),
    counted into ``fusion.fwd_*`` (``train``) or ``fusion.infer_*``."""
    engaged, _ = gate_explain(kernel, stride, x_shape, w_shape, dtype,
                              prologue, res=res, train=train)
    if _tm.enabled():
        if train:
            _tm.counter("fusion.fwd_engaged" if engaged
                        else "fusion.fwd_fallback").inc()
        else:
            _tm.counter("fusion.infer_engaged" if engaged
                        else "fusion.infer_fallback").inc()
    return engaged


def infer_default():
    """Whether the conv+BN plan is active on inference executions (JAX
    :707): off under ``MXNET_FUSED_CONV_BN=0``; otherwise on, since the
    port's stats-free kernel engages at every admitted inference site by
    default (the JAX package needs a matching table or a quantized
    variant). It equals whether ``plan`` plans conv+BN at all, so the
    executor needs no inference mask (JAX's executor masks by it)."""
    return os.environ.get("MXNET_FUSED_CONV_BN", "auto") != "0"


_warned_bwd_env = False


def bwd_mode(kernel, stride, x_shape, w_shape, dtype, prologue, res=False):
    """The backward policy of an engaged site, counted into
    ``fusion.bwd_engaged`` / ``fusion.bwd_xla``: ``"recompute"`` or
    ``"stash"`` (the fused backward kernel's two policies) or ``"xla"``
    (the library backward)."""
    mode = _bwd_mode_impl(kernel, stride, x_shape, w_shape, dtype, prologue, res=res)
    if _tm.enabled():
        _tm.counter("fusion.bwd_xla" if mode == "xla"
                    else "fusion.bwd_engaged").inc()
    return mode


def _bwd_mode_impl(kernel, stride, x_shape, w_shape, dtype, prologue, res=False):
    """``MXNET_FUSED_CONV_BN_BWD`` (JAX :755): ``0|xla`` pins the library
    backward, ``1``/``recompute`` and ``stash`` the kernel's policy of that
    name where the shape tiles (``ConvBlock`` runs a site with no prologue
    to stash under recompute, as JAX's forward demotes it). ``auto`` reads
    a tuned verdict's policy (``cuda:<policy>``), else takes the recompute
    kernel (the port's default)."""
    env = os.environ.get("MXNET_FUSED_CONV_BN_BWD", "auto")
    if env in ("0", "xla"):
        return "xla"
    if env == "1":
        env = "recompute"
    elif env not in ("auto", "recompute", "stash"):
        global _warned_bwd_env
        if not _warned_bwd_env:
            _warned_bwd_env = True
            _LOG.warning("MXNET_FUSED_CONV_BN_BWD=%r not recognized "
                         "(0|xla|1|recompute|stash|auto); backward stays on the library "
                         "lowering", env)
        return "xla"
    tiles = _cb.supported(x_shape, w_shape, stride)
    if env in ("recompute", "stash"):
        return env if tiles else "xla"
    if not prologue:
        return "recompute" if tiles else "xla"
    rec = _conv_bn_peek(kernel, stride, x_shape, w_shape, dtype, res)
    if rec is not None and rec.get("engage"):
        policy = (rec.get("lowering") or "").partition(":")[2].partition("@")[0]
        return policy if policy in ("recompute", "stash") and tiles else "xla"
    return "recompute" if tiles else "xla"


# ----------------------------------------------------- generic pattern gate
def _tune_key(pat, meta, args):
    from .ops.fusion_patterns import sig_of

    return "%s|%s|%s" % (pat.name, pat.key_variant(meta), sig_of(args))


# copied from mxnet_tpu/fusion.py (_rec_best_times :832; backend-free)
def _rec_best_times(rec):
    """(fused_us, baseline_us) fwd+bwd totals from a tune record — the
    engaged lowering's when one won, else the best measured candidate's.
    None when nothing timed."""
    base = rec.get("base_fwd_us")
    if base is None:
        return None
    base += rec.get("base_bwd_us") or 0.0
    if rec.get("fused_fwd_us") is not None:
        return (rec["fused_fwd_us"] + (rec.get("fused_bwd_us") or 0.0), base)
    best = None
    for row in (rec.get("measured") or {}).values():
        if row.get("fwd_us") is None:
            continue
        t = row["fwd_us"] + (row.get("bwd_us") or 0.0)
        best = t if best is None or t < best else best
    return None if best is None else (best, base)


# copied from mxnet_tpu/fusion.py (losers_note :851; backend-free)
def losers_note(rec, winner):
    """The measured-losers clause of a schedule-search win: up to three
    runner-up candidates with their fwd(+bwd) totals, fastest first."""
    rows = []
    for name, row in (rec.get("measured") or {}).items():
        if name == winner or row.get("fwd_us") is None:
            continue
        if "rejected" in row or "error" in row:
            continue  # failed parity / failed to run: not beaten on TIME
        rows.append((row["fwd_us"] + (row.get("bwd_us") or 0.0), name))
    if not rows:
        return ""
    rows.sort()
    note = ", ".join("%s %.0fµs" % (n, t) for t, n in rows[:3])
    extra = "" if len(rows) <= 3 else " +%d more" % (len(rows) - 3)
    return "; beat %s%s" % (note, extra)


# copied from mxnet_tpu/fusion.py (tuned_reject_note :871; backend-free)
def tuned_reject_note(rec):
    """The measured-timings clause for a tuned-and-rejected site."""
    if "error" in rec:
        return "tuned and failed to measure (%s)" % rec["error"]
    times = _rec_best_times(rec)
    if times is None:
        return "tuned and rejected (no candidate lowering could be timed)"
    return ("tuned and rejected (best fused %.0fµs vs baseline %.0fµs "
            "fwd+bwd)" % times)


def gate_pattern_explain(pat, meta, args, train=True):
    """The per-site engage decision for a generic pattern WITH its
    predicate: ``(engaged, (lowering_name, fn) | None, reason)``.

    Predicate order (JAX :883): env mode (``MXNET_FUSED_PATTERNS``) →
    inference eligibility → the mesh → candidate lowerings exist → forced,
    else the measured verdict (``fusion_tune``); with none, the port
    engages its kernel (its default). The mesh declines only the
    ``attention`` pattern, and only at a site the op's own ring dispatch
    takes (``ops.attention.ring_takes``: a ``seq`` axis > 1,
    ``MXNET_RING_ATTENTION`` on, self-attention whose T and batch divide
    over the mesh); every other site engages under any mesh, since the
    port runs a rank's rows as one program."""
    from . import fusion_tune as _tune

    mode = enabled_patterns(infer=not train).get(pat.name, "0")
    if mode == "0":
        return False, None, ("pattern disabled (MXNET_FUSED_PATTERNS%s)"
                             % ("" if train else "[_INFER]"))
    if not train and not pat.inference:
        return False, None, "pattern does not engage on inference executions"
    if pat.name == "attention" and ring_takes(None, args[0].shape, args[1].shape) is not None:
        return False, None, MESH_REASON
    baseline, cands = pat.build(meta, args)
    if not cands:
        return False, None, ("no fused lowering for this site (shape does "
                             "not tile / variant unsupported)")
    if mode == "1":
        return True, cands[0], "forced (MXNET_FUSED_PATTERNS)"
    if mode != "auto":
        want = _port_name(mode)
        match = next((c for c in cands if c[0] in (mode, want)),
                     next((c for c in cands if c[0].startswith(want)), None))
        if match is not None:
            return True, match, ("forced (MXNET_FUSED_PATTERNS %s=%s)"
                                 % (pat.name, mode))
        return False, None, ("forced lowering %r has no candidate at "
                             "this site" % mode)
    if not getattr(pat, "tunable", True):
        return False, None, ("no lowering distinct from the baseline to "
                             "measure (engage via MXNET_FUSED_PATTERNS="
                             "%s=1)" % pat.name)
    key = _tune_key(pat, meta, args)

    def _measure():
        # synthetic inputs of the site's shapes on its device, never a
        # bind's live arrays
        from .ops.fusion_patterns import tuner_build

        dev = args[0].device
        sargs = tuple(torch.from_numpy(s).to(device=dev, dtype=torch_dtype(a.dtype))
                      for s, a in zip(_tune.synth_like(args), args))
        with tuner_build():
            sbase, scands = pat.build(meta, sargs)
        return _tune.measure_candidates(sbase, scands, sargs, train=True)

    rec = _tune.verdict(key, _measure)
    if rec is None:
        return True, cands[0], ("no tune verdict (the port's default: its kernel at "
                                "every admitted site)")
    want = "engage" if train else "engage_fwd"
    low = rec.get("lowering") if train else (rec.get("lowering_fwd")
                                             or rec.get("lowering"))
    if rec.get(want) and low:
        fn = dict(cands).get(low)
        if fn is None:
            return False, None, ("cached lowering %r is unavailable for "
                                 "this site" % low)
        times = _rec_best_times(rec)
        reason = "measured win (%s)" % low if times is None else (
            "measured win (%s: fused %.0fµs vs baseline %.0fµs fwd+bwd%s)"
            % ((low,) + times + (losers_note(rec, low),)))
        return True, (low, fn), reason
    return False, None, tuned_reject_note(rec)


#: the gate's reason where the ring claims an attention site, in the words
#: of JAX's mesh predicate (JAX :901-904)
MESH_REASON = ("multi-device mesh: generic patterns engage single-device only (the op's "
               "own SPMD dispatch applies)")


def _count_pattern(pat, engaged):
    if _tm.enabled():
        _tm.counter("fusion.pattern_engaged.%s" % pat.name if engaged
                    else "fusion.pattern_fallback.%s" % pat.name).inc()


class _Arg:
    """A value's shape, dtype and device: what the gates read of a site's
    inputs when it is resolved at bind."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = shape, dtype, device


def attention_trains_flash(q_shape, k_shape, dtype, causal, scale=-1.0):
    """Whether TRAINING through an attention site with these (B, H, T, D)
    query and (B, H, S, D) key shapes engages the flash kernels, whose
    backward recomputes the softmax and never stashes the (B, H, T, S)
    probabilities (JAX :959, the memory plan's score-stash elision): where
    ``ops/flash_attention.supported`` takes the shapes and the pattern
    mode, a forced name or a tuned verdict picks ``cuda_flash`` (the
    port's first and only candidate, so ``1`` and ``auto`` with no verdict
    pick it). Never at a site the running step's ring takes
    (``ops.attention.ring_takes``), as the gate decides."""
    if ring_takes(None, q_shape, k_shape) is not None:
        return False
    try:
        from .ops import flash_attention as _fa
        from . import fusion_tune as _tune

        B, H, T, D = (int(s) for s in q_shape)
        S = int(k_shape[2])
        if not _fa.supported((B * H, T, D), (B * H, S, D), bool(causal)):
            return False
        mode = enabled_patterns().get("attention", "0")
        if mode in ("0", "1"):
            return mode == "1"
        if mode != "auto":
            return _port_name(mode).startswith("cuda_flash")
        pat = next(p for p in get_patterns() if p.name == "attention")
        meta = {"causal": bool(causal), "scale": float(scale)}
        args = (_Arg(tuple(q_shape), dtype, None), _Arg(tuple(k_shape), dtype, None),
                _Arg(tuple(k_shape), dtype, None))
        rec = _tune.peek(_tune_key(pat, meta, args))
        if rec is None:
            return True
        return bool(rec.get("engage") and str(rec.get("lowering") or "").startswith(
            "cuda_flash"))
    except Exception:  # a planner refinement must never sink an analysis
        return False


# ---------------------------------------------------------- bind resolution
def _site_prologue(node, directives):
    """Whether a planned conv's data input is a folded BatchNorm (a
    ``Deferred`` with its scale and shift) in this plan."""
    src = node.inputs[0][0]
    d = directives.get(id(src))
    return d is not None and (d["kind"] == "relu_fold"
                              or (d["kind"] == "bn" and d["fold"]))


def _resolve_conv(d, x, w, prologue, node):
    kernel, stride, res = d["kernel"], d["stride"], d["defer"]
    engaged = gate(kernel, stride, x.shape, w.shape, x.dtype, prologue, res=res)
    bwd = bwd_mode(kernel, stride, x.shape, w.shape, x.dtype, prologue, res=res) \
        if engaged else None
    quant = quant_mode()
    # the inference gate sees the dtype the kernel computes in: bfloat16
    # under MXNET_SERVE_QUANT=bf16, as JAX gates x_c.dtype (:1317)
    idt = torch.bfloat16 if quant == "bf16" else x.dtype
    infer = gate(kernel, stride, x.shape, w.shape, idt, prologue, res=False, train=False)
    if _tm.tracing():
        # JAX's _note_conv (:1161) for the inference decision, made at bind
        reason = ("engaged (inference%s)" % ("" if quant == "off" else ", quant=" + quant)
                  if infer else gate_explain(kernel, stride, x.shape, w.shape, idt, prologue,
                                             res=False, train=False)[1])
        _tm.event("fusion.conv", op=node.name, shape=tuple(x.shape), engaged=infer,
                  reason=reason)
    # the tune-cache keys the two verdicts read (a bare conv is never measured)
    keys = [_conv_bn_key(kernel, stride, x.shape, w.shape, dt, r) if prologue else None
            for dt, r in ((x.dtype, res), (idt, False))]
    return dict(d, train=(engaged, bwd), infer=infer, quant=quant, key=keys[0],
                infer_key=keys[1], prologue=prologue)


def _resolve_pattern(d, args):
    pat, meta = d["pat"], d["meta"]
    out = dict(d, key=_tune_key(pat, meta, args))
    for mode, train in (("train", True), ("infer", False)):
        engaged, chosen, reason = gate_pattern_explain(pat, meta, args, train=train)
        _count_pattern(pat, engaged)
        out[mode] = chosen[0] if engaged else None
        out[mode + "_reason"] = reason
    return out


def _unresolved(node):
    return MXNetError("fusion: the input shapes or dtypes of the planned site %s (%s) do "
                      "not infer at bind, so its gates cannot be decided there"
                      % (node.name, node.op))


def resolve_sites(symbol, directives, shapes, types, device, compute=None):
    """The plan as this bind runs it: every conv and pattern directive
    copied with its verdicts at the bind's ``shapes``/``types`` (name ->
    shape / dtype of the arguments and aux states) on ``device``, each gate
    decided now, once (a measurement, under ``MXNET_FUSION_TUNE_DIR``, too).
    ``compute`` (a torch dtype, or None) is the dtype every floating value
    computes in, whatever ``types`` says: the bf16 training step's, whose
    casts the graph does not hold. A site whose input shapes or dtypes do
    not infer raises ``MXNetError``. Other directives are shared with
    ``directives``."""
    if not any(d["kind"] in ("conv", "pattern") for d in directives.values()):
        return directives
    from .analysis.manager import GraphContext
    from .analysis.shape_lint import propagate

    ctx = GraphContext(symbol, shape_hints=shapes, type_hints=types, strict_shapes=False)
    propagate(ctx)
    out = dict(directives)

    def arg(node, i):
        sh = ctx.entry_shape.get((id(node), i))
        dt = ctx.entry_dtype.get((id(node), i))
        if compute is not None and dt is not None and np.issubdtype(dt, np.floating):
            dt = compute
        return None if sh is None else _Arg(tuple(sh), dt, device)

    def static(v):
        return arg(v.node, 0) if isinstance(v, Lazy) else v

    vals = {}
    for node in ctx.topo:
        d = directives.get(id(node))
        ins = [vals.get((id(i), oi)) for i, oi in node.inputs]
        if d is not None and d["kind"] == "lazy":
            vals[(id(node), 0)] = Lazy(node, ins)
            continue
        if d is not None and d["kind"] == "conv":
            x = static(ins[0]) if ins[0] is not None else None
            if x is None or ins[1] is None or x.dtype is None:
                raise _unresolved(node)
            out[id(node)] = _resolve_conv(d, x, ins[1], _site_prologue(node, directives),
                                          node)
        elif d is not None and d["kind"] == "pattern":
            try:
                args = d["pat"].externals(d["meta"], ins, static)
            except (AttributeError, IndexError, TypeError):
                args = None  # an input whose shape does not infer
            if args is None or not all(a is not None and a.dtype is not None for a in args):
                raise _unresolved(node)
            out[id(node)] = _resolve_pattern(d, args)
        for i in range(1 if node.is_variable else node.num_outputs()):
            vals[(id(node), i)] = arg(node, i)
    return out


# -------------------------------------------------------------------- execute
def _exec_pattern(directive, node, ins, is_train):
    """Run one pattern-rooted node: the lowering its resolved directive
    names, else the unfused root op over resolved inputs."""
    pat, meta = directive["pat"], directive["meta"]
    low = directive["train" if is_train else "infer"]
    if low is not None:
        args = pat.externals(meta, ins, resolve)
        fn = dict(pat.build(meta, args)[1]).get(low)
        if fn is None:
            raise MXNetError("fusion: %s resolved %r at bind, which its inputs at run "
                             "time do not offer" % (node.name, low))
        return (fn(*args),)
    outs, _ = get_op(node.op).apply(node.parsed_attrs(), [resolve(v) for v in ins])
    return tuple(outs)


def execute(directive, node, ins, aux, is_train):
    """Run one planned node during interpret(). ``ins`` are the raw values
    (possibly markers), ``aux`` the node's aux states; returns ``(outs,
    new_aux)``."""
    kind = directive["kind"]
    if kind == "bn":
        return _exec_bn(directive, node, ins, aux, is_train)
    if kind == "relu_fold":
        v = ins[0]
        return (v.with_relu() if isinstance(v, Deferred) else torch.relu(resolve(v)),), ()
    if kind == "conv":
        run = _exec_conv if is_train else _exec_conv_infer
        return (run(directive, ins),), ()
    if kind == "resadd":
        return (_exec_resadd(directive, ins),), ()
    if kind == "lazy":
        return (Lazy(node, ins),), ()
    if kind == "pattern":
        return _exec_pattern(directive, node, ins, is_train), ()
    raise AssertionError(kind)


def _exec_bn(directive, node, ins, aux, is_train):
    """A planned BatchNorm (JAX :1051-1098): an inference forward folds the
    moving stats into scale and shift; a training forward takes the batch
    statistics from the kernel's sums (a ``WithStats`` input) or one pass
    over x, and returns the new moving stats."""
    data_v, gamma, beta = ins
    moving_mean, moving_var = aux
    a = node.parsed_attrs()
    eps, momentum = float(a["eps"]), float(a["momentum"])
    fix_gamma = bool(a["fix_gamma"])
    f32 = torch.float32

    if not is_train:
        x = resolve(data_v)
        istd = torch.rsqrt(moving_var.to(f32) + eps)
        scale32 = istd if fix_gamma else gamma.to(f32) * istd
        shift32 = beta.to(f32) - moving_mean.to(f32) * scale32
        out = (Deferred(x, scale32, shift32) if directive["fold"]
               else _Normalize.apply(x, scale32, shift32))
        return (out,), (moving_mean, moving_var)

    if isinstance(data_v, WithStats):
        x, sums = data_v.c, (data_v.ssum, data_v.ssq)  # global sums already
    else:
        x, sums = resolve(data_v), None
    mean, var = _global_moments(x, _cross_process_mesh(), sums)
    istd = torch.rsqrt(var + eps)
    scale32 = istd if fix_gamma else gamma.to(f32) * istd
    shift32 = beta.to(f32) - mean * scale32
    new_mean = moving_mean * momentum + mean.detach().to(moving_mean.dtype) * (1 - momentum)
    new_var = moving_var * momentum + var.detach().to(moving_var.dtype) * (1 - momentum)
    out = (Deferred(x, scale32, shift32) if directive["fold"]
           else _Normalize.apply(x, scale32, shift32))
    return (out,), (new_mean, new_var)


def _conv_input(v):
    """(x, scale, shift, relu) of a planned conv's data value."""
    if isinstance(v, Deferred):
        return v.raw, v.scale, v.shift, v.relu
    return resolve(v), None, None, False


def _conv_unfused(v, w, stride):
    """A declined site: the convolution of the materialised input, as the
    JAX package runs ``_xla_conv`` there (the 1x1/3x3 padding of the
    structural gate)."""
    xn = v.materialize() if isinstance(v, Deferred) else resolve(v)
    return F.conv2d(xn, w, stride=stride, padding=(w.shape[2] - 1) // 2)


def _exec_conv(directive, ins):
    """A planned conv in a training forward (JAX :1173-1238): the fused
    kernel where its gate engaged it, as a ``PendingConv`` when the site is
    deferred into a residual add, else with its statistics, summed over
    the processes of a mesh that spans them (the gate read the rank's own
    rows, as JAX's reads the shard's)."""
    v, w = ins[0], resolve(ins[1])
    stride = directive["stride"]
    x, scale, shift, relu = _conv_input(v)
    engaged, bwd = directive["train"]
    if not engaged:
        return _conv_unfused(v, w, stride)
    if directive["defer"]:
        return PendingConv(x, w, scale, shift, relu, stride, bwd)
    mesh = _cross_process_mesh()
    if mesh is not None:
        return WithStats(*_conv_block_sharded(mesh, x, w, scale, shift, None, stride, relu,
                                              bwd))
    return WithStats(*_cb.ConvBlock.apply(x, w, scale, shift, None, stride, relu, bwd))


_warned_quant_env = False


def quant_mode():
    """The requested quantized-inference variant: ``off`` | ``bf16`` |
    ``int8`` (``MXNET_SERVE_QUANT``, JAX :1245). Unrecognized values warn
    once and stay off."""
    env = os.environ.get("MXNET_SERVE_QUANT", "off").strip().lower()
    if env in ("", "0", "off", "none", "fp32", "float32"):
        return "off"
    if env in ("bf16", "bfloat16"):
        return "bf16"
    if env == "int8":
        return "int8"
    global _warned_quant_env
    if not _warned_quant_env:
        _warned_quant_env = True
        _LOG.warning("MXNET_SERVE_QUANT=%r not recognized (off|bf16|int8); "
                     "quantized inference stays off", env)
    return "off"


def _quant_weight(w):
    """``int8``: weight-only symmetric per-output-channel quantization (JAX
    ``_quant_conv_inputs`` :1267) — w snaps to the 255-point grid of its
    channel's scale and is dequantized, so the float32 kernel computes with
    the int8 grid's values."""
    w32 = w.to(torch.float32)
    s = w32.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return (torch.clamp(torch.round(w32 / s), -127, 127) * s).to(w.dtype)


def _conv_unfused_bf16(x, w, scale, shift, relu, stride):
    """A site the inference gate declines under ``MXNET_SERVE_QUANT=bf16``:
    the JAX package's fallback, ``_xla_conv`` on the bfloat16 casts of x and
    w (:1339-1344): the prologue in bfloat16, the library's bfloat16
    convolution, c back in x's dtype."""
    bf16, b = torch.bfloat16, (1, -1, 1, 1)
    xn = x.to(bf16)
    if scale is not None:
        xn = xn * scale.to(bf16).reshape(b) + shift.to(bf16).reshape(b)
        if relu:
            xn = torch.relu(xn)
    return F.conv2d(xn, w.to(bf16), stride=stride, padding=(w.shape[2] - 1) // 2).to(x.dtype)


def _exec_conv_infer(directive, ins):
    """A planned conv in an inference forward (JAX :1299-1344): the
    stats-free kernel, the BN prologue folded with its moving stats, the
    weight quantized under ``MXNET_SERVE_QUANT=int8``. Under
    ``MXNET_SERVE_QUANT=bf16`` x and w compute in bfloat16 and c returns in
    x's dtype (the kernel's bf16 form, or the library's bfloat16 conv where
    the gate declined). The weight is read, and cast or quantized, at every
    call, as in the JAX package: an update through the predict API is seen.
    A site whose x and w differ in dtype (a bfloat16 input bound beside
    float32 weights) computes in their promoted dtype, as the library ops
    do. A deferred site runs here too, and its add is a plain add."""
    v, w = ins[0], resolve(ins[1])
    stride = directive["stride"]
    x, scale, shift, relu = _conv_input(v)
    quant = directive["quant"]
    if quant == "bf16":
        if not directive["infer"]:
            return _conv_unfused_bf16(x, w, scale, shift, relu, stride)
        return _cb.conv_block_infer(x, w, scale, shift, stride, relu, compute="bfloat16")
    if quant == "int8":
        w = _quant_weight(w)
    if not directive["infer"]:
        return _conv_unfused(v, w, stride)
    dt = torch.promote_types(x.dtype, w.dtype)
    return _cb.conv_block_infer(x.to(dt), w.to(dt), scale, shift, stride, relu)


def _exec_resadd(directive, ins):
    """The add a conv was deferred into (JAX :1347): the conv runs here
    with the other operand as its residual, and the sum keeps the
    kernel's statistics."""
    slot = directive["pending_slot"]
    pending, other = ins[slot], ins[1 - slot]
    if isinstance(pending, PendingConv):
        return WithStats(*pending.run(resolve(other)))
    return resolve(pending) + resolve(other)
