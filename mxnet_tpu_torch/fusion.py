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

Every planned conv site takes the kernel where the shape gate
(``ops/conv_bn._conv_geometry``) takes its shapes: ``ConvBlock`` (forward
with statistics, fused backward) in a training forward, the stats-free
``conv_block_infer`` in an inference forward. The gate is the structural
reject reasons below plus that shape gate, decided from shapes alone and the
same on the CPU and the card; a declined site runs ``F.conv2d`` on the
materialised input, as the JAX package runs ``_xla_conv`` there. That is the
JAX package's own unfused lowering, never a reaction to a kernel failing.
There is no ``MXNET_FUSED_CONV_BN`` switch, no measured-win table or tuner
and no quantized serving (``MXNET_SERVE_QUANT``). In a fused step whose mesh
spans processes (one rank a process on the data axis) a site runs the kernel
on the rank's own rows and ``all_reduce``s its (Σc, Σc²) over the mesh's
group (``_conv_block_sharded``, JAX :1101-1160), and an unfused BatchNorm
sums its statistics the same way, so every BatchNorm sees the global
batch's moments, as the reference's ``psum`` gives.
The BatchNorm arithmetic (mean and variance from the sums, scale and shift,
the moving-stat updates) is plain torch, so autograd carries gamma's and
beta's gradients through ``scale``/``shift`` into the kernel's prologue
cotangents.

**Generic patterns** (``Lazy``/``resolve`` :131-168, ``plan`` :385,
``_exec_pattern``/``execute`` :997-1048) over the three patterns of
``ops/fusion_patterns.py``. ``plan`` roots each match in a directive map and
marks its interior nodes ``lazy``; at run time a rooted site runs its
pattern's lowering, which is a kernel on CUDA tensors and the kernel's plain
version on CPU tensors. There is no autotuner and no environment switch:
every matched site takes its lowering. Where the kernel does not take a
site's shapes, a CPU site runs the ordinary unfused ops and a CUDA site
raises.

Training needs no switch here: the executor runs a training forward under
autograd, a site's lowering records its kernel's autograd Function, and a
marker that a consumer outside the site materialises runs ordinary torch
ops, which carry their gradients like any other node.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import conv_bn as _cb
from .ops.fusion_patterns import get_patterns
from .ops.registry import get_op

__all__ = ["Deferred", "WithStats", "PendingConv", "Lazy", "resolve", "plan", "plan_sites",
           "execute", "conv_reject_reason", "bn_reject_reason", "CONV_BN_KINDS",
           "attention_trains_flash"]

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
    """A conv deferred to its consuming residual add."""

    __slots__ = ("x", "w", "scale", "shift", "relu", "stride")

    def __init__(self, x, w, scale, shift, relu, stride):
        self.x, self.w = x, w
        self.scale, self.shift, self.relu, self.stride = scale, shift, relu, stride

    def run(self, res):
        mesh = _cross_process_mesh()
        if mesh is not None:
            return _conv_block_sharded(mesh, self.x, self.w, self.scale, self.shift, res,
                                       self.stride, self.relu)
        return _cb.ConvBlock.apply(self.x, self.w, self.scale, self.shift, res, self.stride,
                                   self.relu)


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


def _conv_block_sharded(mesh, x, w, scale, shift, res, stride, relu):
    """The kernel on this rank's rows (``x`` and ``res`` are the rank's
    rows), then the per-rank statistics summed over the mesh, so the
    downstream BatchNorm sees GLOBAL-batch moments (JAX :1123-1158, where
    ``shard_map`` runs the kernel per data shard and ``psum``s Σc, Σc²)."""
    c, ssum, ssq = _cb.ConvBlock.apply(x, w, scale, shift, res, stride, relu)
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

    Two passes: the conv+BN rewrites, then each pattern, in priority order,
    over the still-unclaimed nodes (a matched root gets a ``pattern``
    directive, its interior nodes ``lazy`` markers). ``output_ids`` are the
    nodes whose values are program outputs: they are never folded, deferred
    or a pattern's interior, since their values must materialise."""
    output_ids = frozenset(output_ids)
    consumers = {}
    for node in topo:
        for inp, oi in node.inputs:
            consumers.setdefault(id(inp), []).append((node, oi))
    order = {id(n): i for i, n in enumerate(topo)}
    directives = {}
    _plan_conv_bn(topo, output_ids, consumers, order, directives)
    ctx = _PlanCtx(consumers, output_ids, directives)
    for pat in get_patterns():
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


def attention_trains_flash(q_shape, k_shape, dtype, causal, scale=-1.0):
    """Whether TRAINING through an attention site with these (B, H, T, D)
    query and (B, H, S, D) key shapes engages the flash kernels, whose
    backward recomputes the softmax and never stashes the (B, H, T, S)
    probabilities (JAX :959, the memory plan's score-stash elision). The
    port has no pattern switch and no tuner: a site trains flash exactly
    where ``ops/flash_attention.supported`` takes its shapes."""
    try:
        from .ops import flash_attention as _fa

        B, H, T, D = (int(s) for s in q_shape)
        S = int(k_shape[2])
        return bool(_fa.supported((B * H, T, D), (B * H, S, D), bool(causal)))
    except Exception:  # a planner refinement must never sink an analysis
        return False


# -------------------------------------------------------------------- execute
def _exec_pattern(directive, node, ins):
    """Run one pattern-rooted node through its lowering, or, on the CPU only,
    the unfused root op where the kernel does not take the site's shapes."""
    pat, meta = directive["pat"], directive["meta"]
    args = pat.externals(meta, ins, resolve)
    fn = pat.build(meta, args)
    if fn is not None:
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
        return _exec_pattern(directive, node, ins), ()
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
    kernel where the shape gate takes it, as a ``PendingConv`` when the
    site is deferred into a residual add, else with its statistics, summed
    over the processes of a mesh that spans them (the gate reads the
    rank's own rows, as JAX's reads the shard's)."""
    v, w = ins[0], resolve(ins[1])
    stride = directive["stride"]
    x, scale, shift, relu = _conv_input(v)
    if not _cb.supported(x.shape, w.shape, stride):
        return _conv_unfused(v, w, stride)
    if directive["defer"]:
        return PendingConv(x, w, scale, shift, relu, stride)
    mesh = _cross_process_mesh()
    if mesh is not None:
        return WithStats(*_conv_block_sharded(mesh, x, w, scale, shift, None, stride, relu))
    return WithStats(*_cb.ConvBlock.apply(x, w, scale, shift, None, stride, relu))


def _exec_conv_infer(directive, ins):
    """A planned conv in an inference forward (JAX :1299-1344): the
    stats-free kernel, the BN prologue folded with its moving stats. A
    deferred site runs here too, and its add is a plain add."""
    v, w = ins[0], resolve(ins[1])
    stride = directive["stride"]
    x, scale, shift, relu = _conv_input(v)
    if not _cb.supported(x.shape, w.shape, stride):
        return _conv_unfused(v, w, stride)
    return _cb.conv_block_infer(x, w, scale, shift, stride, relu)


def _exec_resadd(directive, ins):
    """The add a conv was deferred into (JAX :1347): the conv runs here
    with the other operand as its residual, and the sum keeps the
    kernel's statistics."""
    slot = directive["pending_slot"]
    pending, other = ins[slot], ins[1 - slot]
    if isinstance(pending, PendingConv):
        return WithStats(*pending.run(resolve(other)))
    return resolve(pending) + resolve(other)
