"""Shape/dtype propagation lint (GL001–GL006).

Counterpart of ``mxnet_tpu/analysis/shape_lint.py``: the port's
``symbol._eval_node_shape`` runs each op on ``meta`` tensors where the JAX
package calls ``jax.eval_shape``; the rest is the reference's code.

Re-runs the executor's inference symbolically — same backward parameter
rules (``ops.infer_meta.backward_shape_rule``), same per-node abstract
evaluation (``symbol._eval_node_shape``) — but with
per-node error recovery: a node that cannot be inferred becomes a
diagnostic carrying the full producer provenance chain, and the walk
continues so ONE lint run reports EVERY broken node, where ``bind`` stops
at the first traceback.

Codes:
  GL001  op-level inference failed (eval_shape raised) — unbindable node
  GL002  argument shape still underdetermined under full hints
  GL003  declared ``__shape__``/hint conflicts with the inferred shape
  GL004  mixed-dtype inputs silently promoted (per infer_meta dtype_policy)
  GL005  duplicate node names (bind-by-dict / output_dict collide)
  GL006  input rank violates the op's declared rank constraints
"""
from __future__ import annotations

import numpy as np

from ..base import np_dtype
from ..ops.infer_meta import backward_shape_rule, get_meta
from ..symbol import _eval_node_shape, _aux_positions, _freeze, _parse_shape_attr
from .diagnostics import Diagnostic
from .manager import GraphContext, graph_pass

__all__ = ["propagate", "shape_dtype_lint"]


def _short_exc(exc) -> str:
    """First informative line of an exception, without the traceback."""
    msg = str(exc).strip()
    for line in msg.splitlines():
        line = line.strip()
        if line:
            return line[:300]
    return type(exc).__name__


def propagate(ctx: GraphContext):
    """Fill ctx.entry_shape/entry_dtype/var_shape/var_dtype node by node,
    yielding diagnostics instead of raising. Mirrors ``symbol._infer_impl``
    (the executor's single inference pass) with error recovery."""
    diags = []
    for node in ctx.topo:
        if not node.is_variable:
            continue
        sh = ctx.shape_hints.get(node.name)
        declared = None
        if "__shape__" in node.attrs:
            declared = _parse_shape_attr(node.attrs["__shape__"])
        if sh is not None and declared is not None and tuple(sh) != tuple(declared):
            diags.append(Diagnostic(
                "GL003",
                "hinted shape %s conflicts with declared __shape__ %s"
                % (tuple(sh), tuple(declared)),
                node=node.name,
                fix_hint="drop the Variable(shape=...) declaration or pass a "
                         "matching hint",
            ))
        if sh is None:
            sh = declared
        dt = ctx.type_hints.get(node.name)
        if dt is None and "__dtype__" in node.attrs:
            dt = np_dtype(node.attrs["__dtype__"])
        ctx.var_shape[node.name] = tuple(sh) if sh is not None else None
        ctx.var_dtype[node.name] = np.dtype(dt) if dt is not None else None
        ctx.entry_shape[(id(node), 0)] = ctx.var_shape[node.name]
        ctx.entry_dtype[(id(node), 0)] = ctx.var_dtype[node.name]

    for node in ctx.topo:
        if node.is_variable:
            continue
        try:
            parsed = node.parsed_attrs()
        except Exception as exc:
            diags.append(Diagnostic(
                "GL001", "attribute parsing failed: %s" % _short_exc(exc),
                node=node.name, op=node.op,
                provenance=ctx.provenance(node)))
            ctx.blocked[id(node)] = "bad attributes"
            _mark_unknown(ctx, node)
            continue
        in_entries = [(id(n), i) for n, i in node.inputs]
        in_shapes = [ctx.entry_shape.get(e) for e in in_entries]

        meta = get_meta(node.op)
        try:
            slots = node.opdef().input_names(parsed) + node.opdef().aux_names(parsed)
        except Exception:
            slots = []

        # Backward parameter-shape rule fills variable inputs (FC weight...).
        # Declared param slots are masked so the rule re-deduces them: a
        # mismatch between declaration and deduction is then a precise GL003
        # at the variable, not a cryptic GL001 two nodes downstream.
        rule = backward_shape_rule(node.op)
        conflict = False
        if rule is not None:
            masked, remasked = [], []
            for i, ((inp, _), s) in enumerate(zip(node.inputs, in_shapes)):
                slot = slots[i] if i < len(slots) else None
                m = (inp.is_variable and s is not None
                     and slot in meta.param_slots)
                masked.append(None if m else s)
                remasked.append(m)
            try:
                filled = rule(parsed, list(masked))
            except Exception as exc:
                filled = masked
                diags.append(Diagnostic(
                    "GL001",
                    "backward shape rule failed: %s" % _short_exc(exc),
                    node=node.name, op=node.op,
                    provenance=ctx.provenance(node)))
            for (inp, out_i), old, new, was_masked in zip(
                    node.inputs, in_shapes, filled, remasked):
                if new is None:
                    continue
                new = tuple(int(x) for x in new)
                if old is None:
                    ctx.entry_shape[(id(inp), out_i)] = new
                    if inp.is_variable:
                        ctx.var_shape[inp.name] = new
                elif was_masked and tuple(old) != new:
                    diags.append(Diagnostic(
                        "GL003",
                        "%s (%s) requires shape %s for %r, conflicting with "
                        "its declared shape %s"
                        % (node.name, node.op, new, inp.name, tuple(old)),
                        node=inp.name,
                        provenance=ctx.provenance(node, depth=2, max_lines=4),
                        fix_hint="fix the Variable(shape=...) declaration or "
                                 "the layer configuration feeding %s"
                                 % node.name,
                    ))
                    conflict = True
            in_shapes = [ctx.entry_shape.get(e) for e in in_entries]
        if conflict:
            ctx.blocked[id(node)] = "declared/deduced shape conflict"
            _mark_unknown(ctx, node)
            continue

        in_dtypes = [ctx.entry_dtype.get(e) for e in in_entries]

        # rank constraints from infer_meta: a precise GL006 beats the
        # eval_shape crash the bad rank would cause two lines later
        rank_bad = False
        if meta.input_ranks:
            for slot, (inp, oi), sh in zip(slots, node.inputs, in_shapes):
                lohi = meta.input_ranks.get(slot)
                if lohi is None or sh is None:
                    continue
                lo, hi = lohi
                if not (lo <= len(sh) <= hi):
                    want = ("rank %d" % lo) if lo == hi else "rank %d..%s" % (lo, hi)
                    diags.append(Diagnostic(
                        "GL006",
                        "input %r has rank %d (shape %s); %s requires %s"
                        % (slot, len(sh), tuple(sh), node.op, want),
                        node=node.name, op=node.op,
                        provenance=ctx.provenance(node),
                        fix_hint="reshape/expand the %r input or fix the "
                                 "producing layer" % slot,
                    ))
                    rank_bad = True
        if rank_bad:
            ctx.blocked[id(node)] = "rank constraint violated"
            _mark_unknown(ctx, node)
            continue

        if any(s is None for s in in_shapes):
            missing = sorted({
                inp.name for (inp, _), s in zip(node.inputs, in_shapes)
                if s is None and inp.is_variable
            })
            blocked_by = sorted({
                inp.name for (inp, _), s in zip(node.inputs, in_shapes)
                if s is None and not inp.is_variable
            })
            ctx.blocked[id(node)] = (
                "unknown input shapes: vars %s%s"
                % (missing, (" via %s" % blocked_by) if blocked_by else ""))
            ctx.blocked_vars[id(node)] = set(missing)
            _mark_unknown(ctx, node, dtype=_promote(in_dtypes))
            continue

        # GL004: ops that numpy-promote see mixed input dtypes
        known = [d for d in in_dtypes if d is not None]
        if meta.dtype_policy == "promote" and len({d.name for d in known}) > 1:
            promoted = np.result_type(*known)
            diags.append(Diagnostic(
                "GL004",
                "inputs have mixed dtypes %s; %s silently promotes to %s"
                % (sorted({d.name for d in known}), node.op, promoted.name),
                node=node.name, op=node.op,
                provenance=ctx.provenance(node, depth=2, max_lines=4),
                fix_hint="insert an explicit Cast (or declare the Variable "
                         "dtype) so the widening is intentional",
            ))
        filled_dtypes = [np.dtype(np.float32) if d is None else d for d in in_dtypes]
        for (inp, _), d in zip(node.inputs, filled_dtypes):
            if inp.is_variable and ctx.var_dtype.get(inp.name) is None:
                ctx.var_dtype[inp.name] = d
                ctx.entry_dtype[(id(inp), 0)] = d

        try:
            out_structs = _eval_node_shape(
                node.op, _freeze(parsed), tuple(in_shapes),
                tuple(str(d) for d in filled_dtypes), _aux_positions(node))
        except Exception as exc:
            diags.append(Diagnostic(
                "GL001",
                "shape/dtype inference failed: %s" % _short_exc(exc),
                node=node.name, op=node.op,
                provenance=ctx.provenance(node),
                fix_hint="the op rejected these input shapes; the chain above "
                         "shows where each one came from",
            ))
            ctx.blocked[id(node)] = "op inference raised"
            _mark_unknown(ctx, node)
            continue
        for i, st in enumerate(out_structs[: node.num_outputs()]):
            ctx.entry_shape[(id(node), i)] = tuple(st[0])
            ctx.entry_dtype[(id(node), i)] = np.dtype(st[1])
    return diags


def _promote(in_dtypes):
    known = [d for d in in_dtypes if d is not None]
    if not known:
        return None
    return np.dtype(np.result_type(*known))


def _mark_unknown(ctx: GraphContext, node, dtype=None):
    for i in range(node.num_outputs()):
        ctx.entry_shape[(id(node), i)] = None
        ctx.entry_dtype[(id(node), i)] = dtype


@graph_pass("shape_lint")
def shape_dtype_lint(ctx: GraphContext):
    diags = list(propagate(ctx))

    # GL005: duplicate names. Two distinct variable nodes with one name make
    # bind-by-dict ambiguous (error); duplicate op-node names corrupt
    # output_dict/attr_dict lookups (warning).
    seen_vars, seen_ops = {}, {}
    for node in ctx.topo:
        table = seen_vars if node.is_variable else seen_ops
        if node.name in table:
            kind = "variable" if node.is_variable else "op node"
            diags.append(Diagnostic(
                "GL005",
                "duplicate %s name %r (also used by a %s)"
                % (kind, node.name,
                   seen_vars.get(node.name) or seen_ops.get(node.name)),
                node=node.name, op=node.op,
                severity="error" if node.is_variable else "warning",
                fix_hint="pass name=... to the colliding layer or rename the "
                         "Variable",
            ))
        else:
            table[node.name] = "variable" if node.is_variable else node.op
    # a name used by BOTH a variable and an op node is also a collision
    for name in set(seen_vars) & set(seen_ops):
        diags.append(Diagnostic(
            "GL005",
            "name %r is used by both a variable and an op node" % name,
            node=name, severity="warning",
            fix_hint="rename one of them",
        ))

    # GL002: under full hints the graph must bind — leftover unknowns are
    # errors, attributed to the nodes they blocked
    if ctx.strict_shapes:
        for node in ctx.arg_nodes:
            if ctx.var_shape.get(node.name) is None:
                blockers = [
                    "%s (%s): %s" % (nd.name, nd.op, ctx.blocked.get(id(nd)))
                    for nd in ctx.topo
                    if not nd.is_variable
                    and node.name in ctx.blocked_vars.get(id(nd), ())
                ][:4]
                diags.append(Diagnostic(
                    "GL002",
                    "argument %r has no shape after applying all hints and "
                    "backward rules" % node.name,
                    node=node.name,
                    provenance=blockers,
                    fix_hint="pass %s=<shape> to bind/infer_shape, or declare "
                             "Variable(shape=...)" % node.name,
                ))
    return diags
