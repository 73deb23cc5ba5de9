"""Static memory-liveness / peak-HBM planner (GL501–GL5xx).

Copied from ``mxnet_tpu/analysis/memory_plan.py`` (backend-free). It
predicts liveness as the reference models it (each entry freed after its
last consumer, XLA's buffer assignment), not the caching allocator: the
port's autograd keeps what its saved tensors need, so a card's measured
peak is compared with this prediction only within the reference's own 2x
band. ``fusion.attention_trains_flash`` and ``fusion.plan`` are the port's.

The reference framework planned buffers at graph level (nnvm PlanMemory:
liveness over the topo order, reference-counted frees, one arena). XLA owns
real allocation now — but it tells you the verdict only after minutes of
compilation, as an OOM. This pass re-derives the *prediction* from the
Symbol DAG alone, per device under the sharding plan:

  * params + gradients + optimizer state (momentum-class, one slot per
    param) + the live-activation watermark, forward AND backward,
  * activation bytes counted per entry under ``ctx.entry_spec`` (the
    GL4xx propagation) — a dp=8 plan holds 1/8th of every batch-sharded
    activation per device,
  * a stash-vs-recompute toggle in the ``ops/conv_bn_bytes.py`` accounting
    style: ``stash`` keeps every op output across the fwd→bwd transition
    (the no-remat executor default); ``recompute`` keeps only MXU-op
    outputs (conv/FC/dot/embedding — the ``remat='dots'`` policy) and
    charges the recomputed operands transiently during each backward node.

Findings:
  GL501  predicted peak exceeds ``MXNET_MEMLINT_BUDGET_GB`` (or the
         caller's ``budget_gb``) — named peak node + its live tensors
  GL502  one activation alone is ≥ half the live-activation watermark
         (and over an absolute floor) — the recompute/stash pointer

The full table (clean graphs included) lands on ``Report.memory_plan`` and,
when telemetry is enabled, the ``memlint.predicted_peak_bytes`` gauge — so
``mxtrace`` can show predicted vs. actual side by side.
"""
from __future__ import annotations

from .diagnostics import Diagnostic
from .manager import GraphContext, graph_pass
from .shard_lint import batch_like_vars, entry_bytes, fmt_bytes, norm_spec

__all__ = ["plan_memory", "memory_plan_lint", "DOMINANT_FLOOR_BYTES"]

# ops whose outputs the 'recompute' policy keeps across fwd→bwd (the
# jax.checkpoint 'dots_with_no_batch_dims_saveable' family: MXU results are
# kept, cheap elementwise/norm chains are re-derived in backward)
_MXU_OPS = frozenset({"Convolution", "Deconvolution", "FullyConnected",
                      "dot", "batch_dot", "Embedding", "RNN"})

# GL502 floor: below this a "dominant" activation is not worth a finding
DOMINANT_FLOOR_BYTES = 1 << 30  # 1 GiB

# the fused attention op: its dense lowering's autodiff stashes the
# (B, H, T, S) softmax probabilities across fwd→bwd — an OP-INTERNAL
# residual no graph entry carries, modeled explicitly below (and elided
# when the flash training path will engage: the online-softmax recompute
# backward keeps only the (B, H, T, 1) logsumexp)
_ATTN_OPS = frozenset({"_contrib_MultiHeadAttention", "MultiHeadAttention"})

_TOP_LIVE = 8  # live tensors named at the peak


def _entry_label(ctx, node, oi):
    name = ctx.node_label(node)
    if node.num_outputs() > 1:
        name += "[%d]" % oi
    return name


def plan_memory(ctx: GraphContext):
    """Liveness walk over the topo-sorted DAG. Returns the plan dict, or
    None when the graph's shapes are not fully determined (structural lint —
    there is nothing finite to predict)."""
    from ..parallel.mesh import MeshSpec

    mesh = MeshSpec.of(ctx.mesh) if ctx.mesh is not None else None

    class _M:  # replicated fallback mesh for the byte helper
        shape = {}

    m = mesh if mesh is not None else _M()

    op_nodes = [n for n in ctx.topo if not n.is_variable]
    entries = []
    for node in op_nodes:
        entries.extend((node, i) for i in range(node.num_outputs()))

    def ebytes(node, oi):
        sh = ctx.entry_shape.get((id(node), oi))
        if sh is None:
            return None
        spec = ctx.entry_spec.get((id(node), oi)) or norm_spec(None, len(sh))
        return entry_bytes(sh, ctx.entry_dtype.get((id(node), oi)), spec, m)

    sizes = {}
    for node, oi in entries:
        b = ebytes(node, oi)
        if b is None:
            return None  # underdetermined graph: no finite prediction
        sizes[(id(node), oi)] = b

    # ---- static components ----------------------------------------------
    data_like = {n.name for n in batch_like_vars(ctx)}
    params = grads = inputs = 0
    aux_ids = {id(n) for n in ctx.aux_nodes}
    for node in ctx.arg_nodes + ctx.aux_nodes:
        b = ebytes(node, 0)
        if b is None:
            return None
        if node.name in data_like:
            inputs += b
        else:
            params += b
            # aux (BN running stats) carry no grad/optimizer state
            if ctx.train and id(node) not in aux_ids:
                grads += b
    opt = grads if ctx.train else 0  # one momentum-class slot per param
    base = params + grads + opt + inputs

    # ---- forward liveness -----------------------------------------------
    order = {id(n): i for i, n in enumerate(op_nodes)}
    heads = {(id(n), oi) for n, oi in ctx.symbol._outputs}
    remaining = {}  # entry -> #consumers not yet executed (forward)
    for node in op_nodes:
        for inp, oi in node.inputs:
            if not inp.is_variable:
                remaining[(id(inp), oi)] = remaining.get((id(inp), oi), 0) + 1

    stash_all = ctx.train and ctx.bwd_policy == "stash"
    stashed = set()
    if ctx.train:
        for node, oi in entries:
            if stash_all or node.op in _MXU_OPS:
                stashed.add((id(node), oi))

    # attention score-stash model: the dense lowering's backward needs the
    # f32 (B, H, T, S) probabilities, held from the op's forward to its
    # backward — charged per site unless the flash training path engages
    # for that exact (shape, dtype) site (fusion.attention_trains_flash)
    attn_stash, attn_info = {}, None
    if ctx.train:
        attn_info = {"sites": 0, "score_bytes": 0, "flash_elided_sites": 0}
        for node in op_nodes:
            if node.op not in _ATTN_OPS or not node.inputs:
                continue
            attn_info["sites"] += 1
            q_n, q_oi = node.inputs[0]
            k_n, k_oi = node.inputs[1] if len(node.inputs) > 1 else (None, 0)
            q_sh = ctx.entry_shape.get((id(q_n), q_oi))
            k_sh = ctx.entry_shape.get((id(k_n), k_oi)) if k_n is not None \
                else None
            if not q_sh or not k_sh or len(q_sh) != 4 or len(k_sh) != 4:
                continue
            a = node.parsed_attrs()
            from .. import fusion as _fusion

            from ..ops.attention import ring_takes

            # the predicate never raises: a refinement must not sink the plan.
            # At a site the mesh's ring takes (the gate declines flash there)
            # the ring keeps each block's probabilities for the backward:
            # (B, H, t, t) a step over n steps, what the dense charge below
            # counts with T cut over the seq axis
            flash = ring_takes(ctx.mesh, q_sh, k_sh) is None and \
                _fusion.attention_trains_flash(
                    q_sh, k_sh, ctx.entry_dtype.get((id(node), 0))
                    or "float32", a.get("causal"), a.get("scale", -1.0))
            if flash:
                attn_info["flash_elided_sites"] += 1
                continue
            out_spec = norm_spec(ctx.entry_spec.get((id(node), 0)), 4)
            score_shape = (q_sh[0], q_sh[1], q_sh[2], k_sh[2])
            b = entry_bytes(score_shape, "float32",
                            tuple(out_spec[:3]) + ((),), m)
            attn_stash[id(node)] = b
            attn_info["score_bytes"] += int(b)
        if not attn_info["sites"]:
            attn_info = None

    live = {}  # entry -> bytes
    peak = -1
    peak_node, peak_phase, peak_live = None, "forward", []

    def note_peak(node, phase):
        nonlocal peak, peak_node, peak_phase, peak_live
        cur = sum(live.values())
        if cur > peak:
            peak = cur
            peak_node = node.name
            peak_phase = phase
            rows = sorted(live.items(), key=lambda kv: -kv[1])[:_TOP_LIVE]
            peak_live = [(lbl.get(k, "?"), v) for k, v in rows]

    lbl = {"__cotangents__": "<cotangents>",
           "__recompute__": "<recomputed operands>"}
    for node, oi in entries:
        lbl[(id(node), oi)] = _entry_label(ctx, node, oi)
    for node in op_nodes:
        if id(node) in attn_stash:
            lbl[("__attn_scores__", id(node))] = \
                ctx.node_label(node) + "<scores>"

    for node in op_nodes:
        for i in range(node.num_outputs()):
            live[(id(node), i)] = sizes[(id(node), i)]
        if id(node) in attn_stash:
            live[("__attn_scores__", id(node))] = attn_stash[id(node)]
        note_peak(node, "forward")
        for inp, oi in node.inputs:
            e = (id(inp), oi)
            if inp.is_variable or e not in remaining:
                continue
            remaining[e] -= 1
            if (remaining[e] == 0 and e not in heads
                    and not (ctx.train and e in stashed)):
                live.pop(e, None)
        # an output nobody consumes: keep if head, else free non-stashed
        for i in range(node.num_outputs()):
            e = (id(node), i)
            if (e not in heads and remaining.get(e, 0) == 0
                    and not (ctx.train and e in stashed)):
                live.pop(e, None)

    # ---- backward liveness ----------------------------------------------
    if ctx.train:
        # cotangent of entry e: born at e's first consumer's backward (or at
        # the head), dies after e's producer's backward consumes it
        cot = {}
        for node, oi in ctx.symbol._outputs:
            if not node.is_variable:
                cot[(id(node), oi)] = sizes.get((id(node), oi), 0)
        for node in reversed(op_nodes):
            # grads flowing to this node's inputs materialize now
            for inp, oi in node.inputs:
                e = (id(inp), oi)
                if not inp.is_variable and e not in cot and e in sizes:
                    cot[e] = sizes[e]
            # recompute policy: un-stashed operands rematerialize for this
            # node's backward — transiently resident
            extra = 0
            for inp, oi in node.inputs:
                e = (id(inp), oi)
                if (not inp.is_variable and e not in stashed
                        and e not in live and e in sizes):
                    extra += sizes[e]
            live["__recompute__"] = extra
            live["__cotangents__"] = sum(cot.values())
            note_peak(node, "backward")
            live.pop("__recompute__", None)
            # this node's backward ran: its output cotangents, stashed
            # outputs and internal score stash are dead
            for i in range(node.num_outputs()):
                cot.pop((id(node), i), None)
                e = (id(node), i)
                if e not in heads:
                    live.pop(e, None)
            live.pop(("__attn_scores__", id(node)), None)
        live.pop("__cotangents__", None)

    act_peak = max(peak, 0)
    total = base + act_peak
    fusion_info = _fusion_byte_view(ctx, op_nodes, sizes, stash_all)
    plan = {
        "per_device": {
            "params": int(params),
            "grads": int(grads),
            "opt_state": int(opt),
            "inputs": int(inputs),
            "act_peak": int(act_peak),
            "peak": int(total),
        },
        "peak_gb": round(total / 2 ** 30, 4),
        "peak_node": peak_node,
        "peak_phase": peak_phase,
        "peak_live": [[n, int(b)] for n, b in peak_live],
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "devices": mesh.size if mesh is not None else 1,
        "policy": ctx.bwd_policy if ctx.train else "inference",
        "train": ctx.train,
        "budget_bytes": (int(ctx.budget_bytes)
                         if ctx.budget_bytes is not None else None),
    }
    if fusion_info is not None:
        plan["fusion"] = fusion_info
    if attn_info is not None:
        plan["attention"] = attn_info
    return plan


def _fusion_byte_view(ctx, op_nodes, sizes, stash_all):
    """The fusion pattern engine's byte view of this graph: per-pattern
    site counts and the interior (pattern-elided) bytes — activations that
    never materialize when their site engages. Under the ``stash`` policy
    those interiors would otherwise be HELD across the fwd→bwd transition,
    so ``stash_elidable_bytes`` is the stash-watermark headroom (in bytes)
    the engine can unlock there (0 under recompute/inference, where the
    interiors are transient anyway); the prediction above stays the
    conservative (unfused) upper bound. None when no pattern roots in
    this graph."""
    try:
        from .. import fusion

        directives = fusion.plan(
            ctx.topo, output_ids={id(n) for n, _ in ctx.symbol._outputs})
        sites, interior = {}, 0
        for node in op_nodes:
            d = directives.get(id(node))
            if d is None:
                continue
            if d["kind"] == "pattern":
                sites[d["pat"].name] = sites.get(d["pat"].name, 0) + 1
            elif d["kind"] == "lazy":
                interior += sizes.get((id(node), 0), 0)
        if not sites:
            return None
        return {"pattern_sites": sites,
                "interior_bytes": int(interior),
                "stash_elidable_bytes":
                    int(interior) if (ctx.train and stash_all) else 0}
    except Exception:  # the refinement must never sink the prediction
        return None


@graph_pass("memory_plan")
def memory_plan_lint(ctx: GraphContext):
    plan = plan_memory(ctx)
    ctx.memory_plan = plan
    if plan is None:
        return []

    from .. import telemetry as _tm

    if _tm.enabled():
        _tm.gauge("memlint.predicted_peak_bytes").set(
            plan["per_device"]["peak"])

    diags = []
    pd = plan["per_device"]
    if ctx.budget_bytes is not None and pd["peak"] > ctx.budget_bytes:
        comp = max(("params", "grads", "opt_state", "act_peak"),
                   key=lambda k: pd[k])
        hints = {
            "params": "shard more params over the model axis "
                      "(parallel.sharding.param_pspec) or grow the mesh",
            "grads": "shard params (grads follow their layout) or grow the "
                     "data axis",
            "opt_state": "shard params or use a stateless optimizer",
            "act_peak": "switch the backward policy to recompute "
                        "(SPMDTrainer(remat='dots')) or shrink the "
                        "per-device batch",
        }
        diags.append(Diagnostic(
            "GL501",
            "predicted peak HBM %s/device exceeds the %s budget "
            "(params %s + grads %s + opt %s + inputs %s + activations %s); "
            "peak at %s (%s) with %s live"
            % (fmt_bytes(pd["peak"]), fmt_bytes(int(ctx.budget_bytes)),
               fmt_bytes(pd["params"]), fmt_bytes(pd["grads"]),
               fmt_bytes(pd["opt_state"]), fmt_bytes(pd["inputs"]),
               fmt_bytes(pd["act_peak"]),
               plan["peak_node"], plan["peak_phase"],
               ", ".join("%s=%s" % (n, fmt_bytes(b))
                         for n, b in plan["peak_live"][:4]) or "nothing"),
            node=plan["peak_node"],
            fix_hint="%s component dominates: %s — or let the auto-parallel "
                     "planner search dp×tp×pp plans under this "
                     "budget for you: MXNET_AUTOPLAN=1 (trainer) / "
                     "graphlint --autoplan (CLI)" % (comp, hints[comp]),
        ))
    # the largest single ACTIVATION at the peak (the synthetic
    # <cotangents>/<recomputed> lumps are not one tensor a policy can fix)
    top = next(((n, b) for n, b in plan["peak_live"]
                if not n.startswith("<")), None)
    if top is not None:
        top_name, top_bytes = top
        if (top_bytes >= DOMINANT_FLOOR_BYTES
                and pd["act_peak"] > 0
                and top_bytes * 2 >= pd["act_peak"]):
            diags.append(Diagnostic(
                "GL502",
                "one activation (%s, %s) is %d%% of the live-activation "
                "watermark at the %s peak"
                % (top_name, fmt_bytes(top_bytes),
                   100 * top_bytes // pd["act_peak"], plan["peak_phase"]),
                node=plan["peak_node"],
                fix_hint="recompute it in backward instead of stashing "
                         "(bwd policy 'recompute' / SPMDTrainer("
                         "remat='dots')), or shard the dim it is largest in",
            ))
    return diags
