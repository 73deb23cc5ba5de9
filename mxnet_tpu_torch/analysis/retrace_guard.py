"""Retrace guard (GL201–GL203): compile-cache-busting patterns.

Copied from ``mxnet_tpu/analysis/retrace_guard.py`` (backend-free). The
port runs eagerly, but the same three patterns cost it a captured CUDA
graph, a bound program or a bucket's executor each, as they cost the JAX
package an XLA compile; the codes are the reference's, and the messages
name the port's cost (a bound program, a captured graph).

The executor compiles one XLA program per (program, is_train, input
shapes/dtypes) — ``jax.jit`` retraces whenever an abstract value changes
(PyGraph's capture/recompile hazard, PAPERS.md). Nothing warns when a
training script quietly forces one compile per step; these checks surface
the three classic causes *before* device time burns:

  GL201  python scalars baked into the graph as op attributes
         (``x * lr`` builds ``_mul_scalar(scalar=lr)`` — a NEW graph, hence
         a new XLA program, per distinct value)
  GL202  weak-dtype inputs next to explicitly-typed variables (the untyped
         ones default to float32 at trace time; feeding them bf16/f16 later
         is a silent retrace + upcast)
  GL203  shape-polymorphic data inputs with the expected compile-cache
         cardinality (each distinct shape tuple of each listed input is a
         separate compile, ×2 for is_train — the executor-per-bucket
         economics of BucketingModule, stated up front)
"""
from __future__ import annotations

import numpy as np

from .diagnostics import Diagnostic
from .manager import GraphContext, graph_pass
from ..ops.infer_meta import get_meta

__all__ = ["retrace_guard"]

_LIST_CAP = 6  # nodes/vars named per diagnostic before "and N more"


def _cap(names):
    names = list(names)
    if len(names) <= _LIST_CAP:
        return ", ".join(names)
    return "%s, and %d more" % (", ".join(names[:_LIST_CAP]),
                                len(names) - _LIST_CAP)


def _data_like_vars(ctx: GraphContext):
    """Arg variables that are NOT parameters: a variable is parameter-like
    when every slot it feeds is a declared param slot (infer_meta) — those
    get their shapes from backward rules; the rest (data, labels, masks)
    come from the user per batch and drive retraces."""
    param_only = {}
    for node in ctx.topo:
        if node.is_variable:
            continue
        try:
            parsed = node.parsed_attrs()
            slots = node.opdef().input_names(parsed) + node.opdef().aux_names(parsed)
        except Exception:
            slots = []
        meta = get_meta(node.op)
        for slot, (inp, _) in zip(slots, node.inputs):
            if not inp.is_variable:
                continue
            is_param = slot in meta.param_slots
            prev = param_only.get(inp.name)
            param_only[inp.name] = is_param if prev is None else (prev and is_param)
    return [n for n in ctx.arg_nodes
            if not param_only.get(n.name, False)]


@graph_pass("retrace_guard")
def retrace_guard(ctx: GraphContext):
    diags = []

    # ---- GL201: scalar attrs baked into the trace -----------------------
    scalar_nodes = []
    for node in ctx.topo:
        if node.is_variable:
            continue
        try:
            parsed = node.parsed_attrs()
        except Exception:
            continue
        if "scalar" in parsed and parsed["scalar"] is not None:
            scalar_nodes.append(node)
    if scalar_nodes:
        values = sorted({float(n.parsed_attrs()["scalar"]) for n in scalar_nodes})
        diags.append(Diagnostic(
            "GL201",
            "%d node(s) bake a python scalar into the graph (%s); every "
            "distinct value is a distinct graph and hence a distinct bound "
            "program — a per-step-varying scalar (lr, loss scale) forces one "
            "bind (and graph capture) per step"
            % (len(scalar_nodes),
               _cap("%s=%g" % (n.name, float(n.parsed_attrs()["scalar"]))
                    for n in scalar_nodes)),
            node=scalar_nodes[0].name, op=scalar_nodes[0].op,
            fix_hint="if the value varies at runtime, feed it as a Variable "
                     "input instead of an attribute; %d distinct value(s) "
                     "seen in this graph" % len(values),
        ))

    # ---- GL202: weak-dtype inputs beside explicitly-typed ones ----------
    declared = {}
    for node in ctx.arg_nodes:
        if "__dtype__" in node.attrs:
            declared[node.name] = np.dtype(node.attrs["__dtype__"])
        elif node.name in ctx.type_hints:
            declared[node.name] = np.dtype(ctx.type_hints[node.name])
    non_f32 = {n: d for n, d in declared.items() if d != np.dtype(np.float32)}
    if non_f32:
        weak = [n.name for n in _data_like_vars(ctx) if n.name not in declared]
        if weak:
            diags.append(Diagnostic(
                "GL202",
                "inputs %s carry no dtype while %s are explicitly %s; the "
                "untyped ones weak-default to float32 at trace time, so "
                "feeding them anything else later silently retraces (and "
                "mixed math upcasts)"
                % (_cap(weak), _cap(sorted(non_f32)),
                   sorted({d.name for d in non_f32.values()})),
                node=weak[0],
                fix_hint="declare Variable(dtype=...) (or pass type_dict at "
                         "bind) for every data input of a reduced-precision "
                         "graph",
            ))

    # ---- GL203: shape-polymorphic inputs → compile-cache cardinality ----
    poly = [n.name for n in _data_like_vars(ctx)
            if ctx.var_shape.get(n.name) is None]
    if poly and not ctx.strict_shapes:
        diags.append(Diagnostic(
            "GL203",
            "inputs %s are shape-polymorphic: expected compile-cache "
            "cardinality is (distinct shape tuples of %s) x 2 for "
            "is_train - each combination binds a fresh program (and "
            "captures a fresh CUDA graph), and bound buffers are not "
            "shared across shapes"
            % (_cap(poly), _cap(poly)),
            node=poly[0],
            fix_hint="pad/bucket batches to a fixed set of shapes "
                     "(BucketingModule economics) and keep that set small",
        ))
    return diags
