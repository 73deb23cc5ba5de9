"""Sharding-plan lint (GL401–GL405).

Copied from ``mxnet_tpu/analysis/shard_lint.py`` (backend-free): it reads
the port's ``parallel.mesh.MeshSpec``, ``parallel.sharding`` rules (specs
are plain tuples) and ``ops/infer_meta.py``.

The other passes lint the single-device graph; this one lints the *distributed
execution plan*: given a mesh (axis names/sizes — an abstract
``parallel.mesh.MeshSpec`` or a real jax Mesh) and
``parallel.sharding.ShardingRules``, it propagates per-entry PartitionSpecs
through the op semantics declared in ``ops/infer_meta.py`` (``shard_rule``
categories) and diagnoses the plan XLA would otherwise "fix" silently with
collectives — the implicit-resharding tax of *Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training* (PAPERS.md), surfaced
before a single compile:

  GL401  a rank-2 parameter large enough to shard has NO dim divisible by
         the model axis — the rule silently fell back to full replication
  GL402  an implicit reshard edge: a producer's sharded layout must be
         gathered (or re-laid-out) to satisfy a consumer, with an analytic
         bytes-moved-per-device estimate for the edge
  GL403  batch-axis loss: an op collapses the data-sharded dim mid-graph,
         forcing a full gather of everything downstream
  GL404  a sharded dim does not divide its mesh-axis factor — XLA pads
         every shard (wasted HBM + compute on padding)
  GL405  a large replicated parameter the default rule (``param_pspec``)
         could shard — the fix hint names the rule

The propagated specs land in ``ctx.entry_spec`` (per-dim tuples of mesh axis
names), which the GL5xx memory planner consumes for per-device byte
accounting. The cost model for a gather: all-gathering a tensor sharded
``f`` ways makes every device receive ``(f-1)/f`` of the global bytes.
"""
from __future__ import annotations

import numpy as np

from ..ops.infer_meta import get_meta
from .diagnostics import Diagnostic
from .manager import GraphContext, graph_pass
from .retrace_guard import _data_like_vars

__all__ = ["shard_plan_lint", "batch_like_vars", "norm_spec", "spec_factor",
           "entry_bytes", "fmt_bytes"]

_EDGE_CAP = 8          # per-edge GL402 diagnostics before summarizing
_SUMMARY_CAP = 32      # provenance rows in the overflow summary

# the reference's NameManager parameter-suffix convention: a variable whose
# auto-generated name ends in one of these is a learned parameter even when
# it reaches the graph through a generic op (LayerNorm gamma via
# broadcast_mul, positional embeddings via broadcast_add, attention
# projections via dot) — infer_meta's param_slots cannot see those
_PARAM_SUFFIXES = ("weight", "bias", "gamma", "beta",
                   "moving_mean", "moving_var", "running_mean", "running_var")


def batch_like_vars(ctx):
    """Arg variables that carry per-batch data (inputs/labels/masks) under
    the sharding plan. Starts from the retrace guard's data-like set (vars
    feeding any non-param slot) and removes the parameter-named ones the
    slot heuristic misclassifies. Known trade-off: a *data* input named
    with a param suffix (e.g. a per-example ``sample_weight``) is planned
    as a parameter — the rarer mistake than batch-sharding every LayerNorm
    gamma and positional embedding, and fixable by renaming the input."""
    return [n for n in _data_like_vars(ctx)
            if not n.name.endswith(_PARAM_SUFFIXES)]


# --------------------------------------------------------------------- bytes
def norm_spec(pspec, rank):
    """Normalize a jax PartitionSpec / tuple to per-dim tuples of axis
    names, padded to ``rank``: ``P('data', None)`` → ``(('data',), ())``."""
    out = []
    seq = tuple(pspec) if pspec is not None else ()
    for i in range(rank):
        e = seq[i] if i < len(seq) else None
        if e is None:
            out.append(())
        elif isinstance(e, (list, tuple)):
            out.append(tuple(e))
        else:
            out.append((e,))
    return tuple(out)


def _replicated(rank):
    return ((),) * rank


def _axis_size(mesh, axis):
    return int(mesh.shape[axis]) if axis in mesh.shape else 1


def spec_factor(spec, mesh, dim=None):
    """Total shard count of a normalized spec (or of one dim)."""
    dims = spec if dim is None else (spec[dim],)
    f = 1
    for axes in dims:
        for a in axes:
            f *= _axis_size(mesh, a)
    return f


def _itemsize(dtype):
    try:
        return np.dtype(dtype).itemsize if dtype is not None else 4
    except TypeError:
        return 4


def entry_bytes(shape, dtype, spec, mesh):
    """Per-device bytes of one tensor under its (normalized) spec."""
    total = int(np.prod(shape)) * _itemsize(dtype) if shape else _itemsize(dtype)
    return total // max(1, spec_factor(spec, mesh))


def fmt_bytes(n):
    for unit, div in (("GiB", 2 ** 30), ("MiB", 2 ** 20), ("KiB", 2 ** 10)):
        if n >= div:
            return "%.2f %s" % (n / div, unit)
    return "%d B" % n


def _spec_str(spec):
    if not any(spec):
        return "[replicated]"
    return "[" + ",".join("/".join(a) if a else "." for a in spec) + "]"


# ---------------------------------------------------------------- propagation
def _merge_dim(a, b):
    """Merge two per-dim axis tuples: equal or one empty → the union wins;
    a true conflict returns None (caller gathers one side)."""
    if a == b or not b:
        return a
    if not a:
        return b
    return None


def _resolve_reduce_axes(parsed, ndim):
    """Mirror ops/broadcast_reduce axis resolution: () means every dim."""
    ax = parsed.get("axis", ())
    if ax is None:
        ax = ()
    if isinstance(ax, (int, np.integer)):
        ax = (int(ax),)
    ax = tuple(int(a) % ndim for a in ax)
    if not ax:
        ax = tuple(range(ndim))
    if parsed.get("exclude"):
        ax = tuple(i for i in range(ndim) if i not in ax)
    return set(ax)


def _propagate_node(node, parsed, meta, in_specs, in_shapes, out_shapes):
    """Compute the output specs of ``node`` and the gathers it forces.

    Returns (out_specs, gathers) where gathers is a list of
    (input_index, dims, why). Specs are normalized per-dim tuples; a spec of
    None means the input's spec/shape was unknown (treated replicated)."""
    rank_of = [len(s) if s is not None else 0 for s in in_shapes]
    specs = [s if s is not None else _replicated(r)
             for s, r in zip(in_specs, rank_of)]
    gathers = []

    def gather(i, dims, why):
        dims = [d for d in dims if d < len(specs[i]) and specs[i][d]]
        if dims:
            gathers.append((i, dims, why))
            specs[i] = tuple(() if d in dims else a
                             for d, a in enumerate(specs[i]))

    def out_like(template):
        return [tuple(template)[: len(sh)] + _replicated(
            max(0, len(sh) - len(template))) if sh is not None else None
            for sh in out_shapes]

    rule = meta.shard_rule

    if rule == "elementwise":
        out_rank = max([len(sh) for sh in out_shapes if sh is not None] or [0])
        out_sh = next((sh for sh in out_shapes
                       if sh is not None and len(sh) == out_rank), None)
        merged = list(_replicated(out_rank))
        # align by trailing dims (numpy broadcasting); a dim an input
        # truly broadcasts over (extent 1 vs a larger output extent)
        # contributes nothing — but an extent-1 dim that STAYS extent 1
        # (batch=1 over a dp axis) must keep its sharding
        sized = sorted(range(len(specs)),
                       key=lambda i: -(int(np.prod(in_shapes[i]))
                                       if in_shapes[i] else 0))
        for i in sized:
            sh, sp = in_shapes[i], specs[i]
            if sh is None:
                continue
            off = out_rank - len(sh)
            for d in range(len(sh)):
                if (sh[d] == 1 and out_sh is not None
                        and out_sh[off + d] != 1):
                    continue
                m = _merge_dim(merged[off + d], sp[d])
                if m is None:
                    gather(i, [d], "layout conflict with a larger operand")
                else:
                    merged[off + d] = m
        out = [tuple(merged[: len(sh)]) if sh is not None and len(sh) == out_rank
               else (tuple(merged[-len(sh):]) if sh is not None else None)
               for sh in out_shapes]
        return out, gathers

    if rule in ("conv", "fc", "dot", "batch_dot"):
        if rule == "conv" and len(specs) == 1:
            # windowed single-input op (Pooling): batch + channel sharding
            # survive, spatial dims must be whole
            dspec = specs[0]
            gather(0, range(2, len(dspec)),
                   "spatial dims must be whole for the pooling window")
            return out_like(specs[0][:2]), gathers
        if len(specs) < 2 or in_shapes[0] is None or in_shapes[1] is None:
            return out_like(specs[0][:1] if specs else ()), gathers
        dspec, wspec = specs[0], specs[1]
        if rule == "conv":
            # data (B,C,H,W) ⊗ weight (N,K,kh,kw) → (B,N,H',W')
            gather(0, range(2, len(dspec)), "spatial dims must be whole for "
                                            "the convolution window")
            if dspec[1] != wspec[1]:
                i = 0 if dspec[1] else 1
                gather(i, [1], "contraction (channel) dim sharded on one "
                               "side only")
            batch, outc = specs[0][0], specs[1][0]
            return out_like((batch, outc)), gathers
        if rule == "fc":
            # data (B, k...) ⊗ weight (N, K) → (B, N); trailing data dims
            # flatten into the contraction
            contract_data = tuple(sorted({a for ax in dspec[1:] for a in ax}))
            contract_w = tuple(sorted(set(wspec[1]))) if len(wspec) > 1 else ()
            if contract_data != contract_w:
                if contract_data:
                    gather(0, range(1, len(dspec)),
                           "contraction dim sharded on the data side only")
                if contract_w:
                    gather(1, [1], "contraction dim sharded on the weight "
                                   "side only")
            return out_like((specs[0][0], specs[1][0])), gathers
        if rule == "dot":
            if len(dspec) > 1 and dspec[-1] != (wspec[0] if wspec else ()):
                i = 0 if dspec[-1] else 1
                gather(i, [len(specs[i]) - 1 if i == 0 else 0],
                       "dot contraction dim sharded on one side only")
            d0 = dspec[0] if len(dspec) > 1 else ()
            w1 = wspec[1] if len(wspec) > 1 else ()
            return out_like((d0, w1)), gathers
        # batch_dot (b,m,k) ⊗ (b,k,n) → (b,m,n)
        b = _merge_dim(dspec[0], wspec[0])
        if b is None:
            gather(1, [0], "batch dims sharded differently")
            b = dspec[0]
        if dspec[2] != wspec[1]:
            i = 0 if dspec[2] else 1
            gather(i, [2 if i == 0 else 1],
                   "batch_dot contraction dim sharded on one side only")
        return out_like((b, dspec[1], wspec[2])), gathers

    if rule in ("embedding", "row_sparse_embedding"):
        # data (B,...) rows of weight (V, D) → (B, ..., D). A vocab-sharded
        # table serves the lookup with a masked-sum psum whose traffic is
        # the OUTPUT, not the table — modeled as a gather of the output dim.
        # The row_sparse variant's backward mirrors it: only touched rows
        # scatter back, so the same output-bytes pricing holds both ways
        # (docs/SPARSE.md) — which is why a sharded table falls out of
        # autoplan's search instead of being taxed a full-table gather.
        dspec = specs[0] if specs else ()
        wspec = specs[1] if len(specs) > 1 else _replicated(2)
        if len(wspec) > 0 and wspec[0]:
            gathers.append((1, [0], "vocab-sharded table: the lookup psums "
                                    "the full output on every device"))
        d_dim = wspec[1] if len(wspec) > 1 else ()
        return out_like(tuple(dspec) + (d_dim,)), gathers

    if rule == "flatten":
        dspec = specs[0] if specs else ()
        gather(0, range(1, len(dspec)),
               "flatten collapses these dims into one")
        return out_like((specs[0][0] if specs and specs[0] else (),)), gathers

    if rule == "reshape":
        dspec = specs[0] if specs else ()
        ish = in_shapes[0]
        osh = out_shapes[0] if out_shapes else None
        # dim 0 sharding survives when out dim 0 is a row-major merge of the
        # leading input dims (B,T,C -> B*T,C keeps the outer-dim split);
        # anything else — splits, transpath merges — is conservatively a
        # full re-partition
        keep0 = False
        if ish and osh:
            lead = 1
            for k in range(len(ish)):
                lead *= ish[k]
                if lead == osh[0]:
                    keep0 = True
                    break
                if lead > osh[0]:
                    break
        gather(0, range(1 if keep0 else 0, len(dspec)),
               "reshape re-partitions these dims")
        return out_like((dspec[0],) if keep0 and dspec else ()), gathers

    if rule == "transpose":
        dspec = specs[0] if specs else ()
        axes = parsed.get("axes", ()) or tuple(reversed(range(len(dspec))))
        try:
            out0 = tuple(dspec[int(a)] for a in axes)
        except (IndexError, ValueError):
            out0 = _replicated(len(dspec))
        return out_like(out0), gathers

    if rule == "concat":
        cat = int(parsed.get("dim", 1))
        out_rank = len(out_shapes[0]) if out_shapes and out_shapes[0] else 0
        cat %= max(1, out_rank)
        merged = list(_replicated(out_rank))
        for i, sp in enumerate(specs):
            if len(sp) != out_rank:
                continue
            gather(i, [cat], "concat dim must be whole to interleave")
            sp = specs[i]
            for d in range(out_rank):
                if d == cat:
                    continue
                m = _merge_dim(merged[d], sp[d])
                if m is None:
                    gather(i, [d], "layout conflict across concat inputs")
                else:
                    merged[d] = m
        return out_like(tuple(merged)), gathers

    if rule == "reduce":
        dspec = specs[0] if specs else ()
        ndim = len(dspec)
        red = _resolve_reduce_axes(parsed, ndim) if ndim else set()
        keep = bool(parsed.get("keepdims", False))
        # reducing over a sharded dim is an efficient psum (traffic = output
        # bytes), not a reshard — so no gather is recorded for those dims
        out0 = tuple(dspec[d] if d not in red else ()
                     for d in range(ndim)
                     if keep or d not in red)
        return out_like(out0), gathers

    if rule == "softmax":
        dspec = specs[0] if specs else ()
        gather(0, range(1, len(dspec)),
               "softmax normalizes over the full non-batch extent")
        return out_like((dspec[0] if dspec else (),)), gathers

    # ---- default "batch0": keep the batch-dim sharding when dim 0's extent
    # survives; everything else is assumed to need whole operands
    for i in range(len(specs)):
        gather(i, range(1, len(specs[i])),
               "op %r has no declared sharding semantics: non-batch dims "
               "are assumed gathered" % node.op)
    d0 = ()
    if (specs and in_shapes[0] is not None and len(in_shapes[0]) >= 1
            and out_shapes and out_shapes[0] is not None
            and len(out_shapes[0]) >= 1
            and out_shapes[0][0] == in_shapes[0][0]):
        d0 = specs[0][0]
    return out_like((d0,)), gathers


# --------------------------------------------------------------------- pass
@graph_pass("shard_lint")
def shard_plan_lint(ctx: GraphContext):
    if ctx.mesh is None or ctx.rules is None:
        return []
    from ..parallel.mesh import MeshSpec
    from ..parallel.sharding import (MIN_SHARD_ELEMS, param_pspec,
                                     shardable_dims)

    mesh = MeshSpec.of(ctx.mesh)
    rules = ctx.rules
    model_size = rules.model_parallel_size
    diags = []

    # ---- seed variable specs (and GL401/GL404/GL405 on params) ----------
    data_like = {n.name for n in batch_like_vars(ctx)}
    aux_names = {n.name for n in ctx.aux_nodes}
    # variables consumed as an embedding TABLE (slot 1 of an embedding-
    # category op): GL405's fix hint names the table-specific placement
    # instead of the generic rank-2 advice
    from ..ops.infer_meta import EMBEDDING_RULES

    embed_tables = {}
    for node in ctx.topo:
        if node.is_variable or len(node.inputs) < 2:
            continue
        if get_meta(node.op).shard_rule in EMBEDDING_RULES:
            wnode = node.inputs[1][0]
            if wnode.is_variable:
                embed_tables.setdefault(wnode.name, (node.name, node.op))
    for node in ctx.arg_nodes + ctx.aux_nodes:
        shape = ctx.var_shape.get(node.name)
        if shape is None:
            continue
        if node.name in aux_names:
            spec = _replicated(len(shape))
        elif node.name in data_like:
            spec = norm_spec(rules.batch_spec(shape), len(shape))
        else:
            spec = norm_spec(rules.param_spec(node.name, shape), len(shape))
            if not any(spec) and model_size > 1:
                elems = int(np.prod(shape))
                default = norm_spec(
                    param_pspec(node.name, shape, rules.model_axis or "model",
                                model_size), len(shape))
                if any(default):
                    if node.name in embed_tables:
                        consumer, op = embed_tables[node.name]
                        hint = ("%r is the embedding table of %s (%s): "
                                "param_pspec(%r, %s, model_axis=%r, "
                                "model_size=%d) shards its vocab dim over "
                                "the model axis — the lookup then psums "
                                "only the output rows%s. Drop the custom "
                                "param_rule for this name or return that "
                                "spec."
                                % (node.name, consumer, op, node.name,
                                   tuple(shape), rules.model_axis or "model",
                                   model_size,
                                   " and the row-sparse backward scatters "
                                   "only touched rows (docs/SPARSE.md)"
                                   if op == "SparseEmbedding" else ""))
                    else:
                        hint = ("parallel.sharding.param_pspec would shard "
                                "it — drop the custom param_rule for this "
                                "name or return its spec")
                    diags.append(Diagnostic(
                        "GL405",
                        "parameter %r %s (%s) is replicated on every device "
                        "although dim %d divides the model axis (%s-way)"
                        % (node.name, tuple(shape),
                           fmt_bytes(elems * _itemsize(
                               ctx.var_dtype.get(node.name))),
                           next(d for d, a in enumerate(default) if a),
                           model_size),
                        node=node.name,
                        fix_hint=hint,
                    ))
                elif (len(shape) == 2 and elems >= MIN_SHARD_ELEMS
                      and not shardable_dims(shape, model_size)):
                    diags.append(Diagnostic(
                        "GL401",
                        "parameter %r %s (%s) was requested sharded over the "
                        "model axis (%d-way) but neither dim divides — the "
                        "rule silently fell back to FULL replication on all "
                        "%d devices"
                        % (node.name, tuple(shape),
                           fmt_bytes(elems * _itemsize(
                               ctx.var_dtype.get(node.name))),
                           model_size, mesh.size),
                        node=node.name,
                        fix_hint="pad the layer width to a multiple of %d "
                                 "(or pick a divisible num_hidden) so "
                                 "param_pspec can split it" % model_size,
                    ))
        ctx.entry_spec[(id(node), 0)] = spec

    # ---- propagate through op nodes, collecting reshard edges -----------
    edges = []  # (node, input_node, dims, why, factor, spec_str, bytes_moved)
    heads = {id(n) for n, _ in ctx.symbol._outputs}
    for node in ctx.topo:
        if node.is_variable:
            continue
        try:
            parsed = node.parsed_attrs()
        except Exception:
            parsed = {}
        meta = get_meta(node.op)
        in_specs = [ctx.entry_spec.get((id(inp), oi))
                    for inp, oi in node.inputs]
        in_shapes = [ctx.entry_shape.get((id(inp), oi))
                     for inp, oi in node.inputs]
        out_shapes = [ctx.entry_shape.get((id(node), i))
                      for i in range(node.num_outputs())]
        out_specs, gathers = _propagate_node(node, parsed, meta, in_specs,
                                             in_shapes, out_shapes)
        for i, sh, sp in zip(range(node.num_outputs()), out_shapes, out_specs):
            ctx.entry_spec[(id(node), i)] = (
                sp if sp is not None else _replicated(len(sh or ())))
        for i, dims, why in gathers:
            inp, oi = node.inputs[i]
            sh = in_shapes[i]
            sp = in_specs[i]
            if sh is None or sp is None:
                continue
            f = 1
            for d in dims:
                f *= spec_factor(sp, mesh, dim=d)
            if f <= 1:
                continue
            if meta.shard_rule in ("embedding", "row_sparse_embedding") \
                    and i == 1:
                # a vocab-sharded table never moves: the masked-sum psum
                # traffic is the LOOKUP OUTPUT, once per non-owner shard
                osh = out_shapes[0]
                if osh is None:
                    continue
                total = int(np.prod(osh)) * _itemsize(
                    ctx.entry_dtype.get((id(node), 0)))
            else:
                total = int(np.prod(sh)) * _itemsize(
                    ctx.entry_dtype.get((id(inp), oi)))
            moved = total * (f - 1) // f
            edges.append((node, inp, dims, why, f, _spec_str(sp), moved))

        # ---- GL403: the data axis vanished mid-graph --------------------
        dax = rules.data_axis
        if dax is not None:
            in_has = any(dax in a for sp in in_specs if sp for a in sp)
            out_has = any(dax in a for sp in out_specs if sp for a in sp)
            if in_has and not out_has and id(node) not in heads:
                big_bytes = max(
                    (int(np.prod(sh)) * _itemsize(
                        ctx.entry_dtype.get((id(inp), oi)))
                     for (inp, oi), sh in zip(node.inputs, in_shapes)
                     if sh is not None),
                    default=None)
                diags.append(Diagnostic(
                    "GL403",
                    "%s (%s) collapses the %r-sharded batch dim mid-graph: "
                    "its output is replicated, so every consumer downstream "
                    "runs un-sharded and the op itself gathers %s of "
                    "activations"
                    % (node.name, node.op, dax,
                       fmt_bytes(big_bytes) if big_bytes is not None
                       else "its inputs"),
                    node=node.name, op=node.op,
                    provenance=ctx.provenance(node, depth=2, max_lines=4),
                    fix_hint="keep a batch dim through this op (keepdims=1 "
                             "/ reshape around it) or move the reduction "
                             "into the loss head",
                ))

    # ---- GL402: per-edge reshard diagnostics (largest first, capped) -----
    edges.sort(key=lambda e: -e[-1])
    # Machine-readable, UNCAPPED view for the auto-parallel planner and JSON
    # consumers: the human diagnostics below stay capped at _EDGE_CAP, but a
    # cost model fed a truncated total would under-price bad plans.
    ctx.reshard_total_bytes = int(sum(m for *_, m in edges))
    ctx.reshard_edges = [
        {"consumer": node.name, "op": node.op, "producer": inp.name,
         "dims": list(dims), "factor": int(f), "spec": spec_str,
         "bytes_per_device": int(moved)}
        for node, inp, dims, why, f, spec_str, moved in edges]
    for node, inp, dims, why, f, spec_str, moved in edges[:_EDGE_CAP]:
        diags.append(Diagnostic(
            "GL402",
            "implicit reshard into %s (%s): input %r dim(s) %s are sharded "
            "%d-way but %s — est %s moved per device (all-gather of %s)"
            % (node.name, node.op, inp.name, list(dims), f, why,
               fmt_bytes(moved), spec_str),
            node=node.name, op=node.op,
            fix_hint="make the producer and consumer agree on this layout "
                     "(shard the consumer's other operand to match, or "
                     "replicate the producer)",
        ))
    if len(edges) > _EDGE_CAP:
        rest = edges[_EDGE_CAP:]
        tail = ["%s -> %s (%s): %s" % (inp.name, node.name, node.op,
                                       fmt_bytes(moved))
                for node, inp, _, _, _, _, moved in rest[:_SUMMARY_CAP]]
        if len(rest) > _SUMMARY_CAP:
            tail.append("and %d more" % (len(rest) - _SUMMARY_CAP))
        diags.append(Diagnostic(
            "GL402",
            "%d smaller implicit reshard edge(s), est %s total moved per "
            "device" % (len(rest), fmt_bytes(sum(m for *_, m in rest))),
            node=rest[0][0].name,
            provenance=tail,
        ))

    # ---- GL404: uneven shards over every placed entry --------------------
    uneven = []
    for node in ctx.topo:
        for i in range(node.num_outputs()):
            sp = ctx.entry_spec.get((id(node), i))
            sh = ctx.entry_shape.get((id(node), i))
            if not sp or sh is None:
                continue
            for d, axes in enumerate(sp):
                if not axes:
                    continue
                f = spec_factor(sp, mesh, dim=d)
                if f > 1 and sh[d] % f:
                    uneven.append((node, d, sh, f))
    for node, d, sh, f in uneven[:_EDGE_CAP]:
        pad = (-sh[d]) % f
        diags.append(Diagnostic(
            "GL404",
            "%s: dim %d extent %d does not divide its %d-way sharding — "
            "XLA pads every shard to %d row(s) (%d padded row(s) in total "
            "across the axis, dead compute+HBM)"
            % (ctx.node_label(node), d, sh[d], f, -(-sh[d] // f), pad),
            node=node.name,
            fix_hint="pad the batch/layer to a multiple of %d, or shrink "
                     "the mesh axis" % f,
        ))
    if len(uneven) > _EDGE_CAP:
        rest = uneven[_EDGE_CAP:]
        tail = ["%s dim %d extent %d %% %d" % (ctx.node_label(node), d,
                                               sh[d], f)
                for node, d, sh, f in rest[:_SUMMARY_CAP]]
        if len(rest) > _SUMMARY_CAP:
            tail.append("and %d more" % (len(rest) - _SUMMARY_CAP))
        diags.append(Diagnostic(
            "GL404",
            "%d more tensor(s) with uneven shards" % len(rest),
            node=rest[0][0].name,
            provenance=tail,
        ))
    return diags
