"""Pass manager: walks a Symbol DAG once, shares the walk across passes.

Copied from ``mxnet_tpu/analysis/manager.py`` (backend-free): the port
registers the reference's seven passes in the reference's order,
``shape_lint``, ``retrace_guard``, ``fusion_explain``, ``shard_lint``,
``memory_plan``, ``dispatch_lint`` and ``concurrency_lint``.

The reference's nnvm pass pipeline (``InferShape`` → ``InferType`` →
``PlanMemory`` → ``PlaceDevice``) keyed every pass off one immutable graph
with per-entry attribute columns. ``GraphContext`` is the analogue: one topo
order, one consumer map, one shape/dtype propagation table, shared by every
registered pass so adding a new check never re-derives graph structure.

Passes register with ``@graph_pass(name)`` and receive the context; they
return (or yield) ``Diagnostic`` objects. ``run_graph_passes`` assembles the
``Report``. Engine-schedule analysis lives outside this manager (it consumes
a recorded push trace, not a Symbol) — see ``engine_race.py``.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from .diagnostics import Diagnostic, Report

__all__ = ["GraphContext", "graph_pass", "run_graph_passes", "list_passes"]

_PASSES: List[Tuple[str, Callable]] = []
_warned_budgets: set = set()


def graph_pass(name: str):
    """Register a graph-lint pass. Order of registration is run order."""

    def _reg(fn):
        _PASSES.append((name, fn))
        return fn

    return _reg


def list_passes() -> List[str]:
    return [n for n, _ in _PASSES]


class GraphContext:
    """Shared per-lint state handed to every pass.

    Attributes:
      symbol        — the Symbol under analysis
      topo          — topo-ordered ``_Node`` list
      consumers     — id(node) -> [(consumer_node, out_index_consumed)]
      arg_nodes / aux_nodes — classified variable nodes
      shape_hints / type_hints — caller-provided name -> shape/dtype
      strict_shapes — True when the caller claims the hints fully bind the
                      graph (bind-time lint); underdetermined args are then
                      errors (GL002) rather than expected polymorphism (GL203)
      entry_shape / entry_dtype — (id(node), out_idx) -> shape/dtype, filled
                      by the shape_lint pass and reused by later passes
      var_shape / var_dtype — variable name -> inferred shape/dtype
      blocked       — id(node) -> reason string for nodes whose inference
                      could not run (unknown inputs / upstream failure)

    Distributed-plan state (sharding lint + memory planner):
      mesh          — parallel.mesh.MeshSpec (or a real Mesh) or None;
                      None skips the GL4xx pass and plans memory replicated
      rules         — parallel.sharding.ShardingRules over that mesh (built
                      via ShardingRules.infer_axes when not given)
      budget_bytes  — peak-HBM budget (from MXNET_MEMLINT_BUDGET_GB or the
                      caller); None disables GL501
      bwd_policy    — 'stash' (save every activation for backward, the
                      no-remat executor default) or 'recompute' (only
                      MXU-op outputs survive the fwd→bwd transition — the
                      remat='dots' accounting)
      train         — account grads + optimizer state + backward liveness
      entry_spec    — (id(node), out_idx) -> per-dim axis-name tuples,
                      filled by shard_lint, read by memory_plan
      memory_plan   — the planner's dict output (copied onto the Report)
    """

    def __init__(self, symbol, shape_hints=None, type_hints=None,
                 strict_shapes: Optional[bool] = None, mesh=None, rules=None,
                 budget_bytes=None, bwd_policy="stash", train=True):
        import os

        self.symbol = symbol
        self.topo = symbol._topo()
        self.shape_hints = dict(shape_hints or {})
        self.type_hints = dict(type_hints or {})
        self.strict_shapes = (bool(self.shape_hints)
                              if strict_shapes is None else strict_shapes)
        args, auxs = symbol._classified_variables()
        self.arg_nodes = args
        self.aux_nodes = auxs
        self.consumers: Dict[int, list] = {}
        for node in self.topo:
            for inp, oi in node.inputs:
                self.consumers.setdefault(id(inp), []).append((node, oi))
        # filled by shape_lint, read by retrace_guard / fusion_explain
        self.entry_shape: Dict[Tuple[int, int], Optional[tuple]] = {}
        self.entry_dtype: Dict[Tuple[int, int], object] = {}
        self.var_shape: Dict[str, Optional[tuple]] = {}
        self.var_dtype: Dict[str, object] = {}
        self.blocked: Dict[int, str] = {}
        self.blocked_vars: Dict[int, set] = {}
        # distributed-plan state (shard_lint / memory_plan)
        if mesh is None and rules is not None:
            # rules carry their mesh — passing only rules must not silently
            # skip the GL4xx pass and plan memory replicated
            mesh = getattr(rules, "mesh", None)
        self.mesh = mesh
        if rules is None and mesh is not None:
            from ..parallel.sharding import ShardingRules

            rules = ShardingRules.infer_axes(mesh)
        self.rules = rules
        if budget_bytes is None:
            raw = os.environ.get("MXNET_MEMLINT_BUDGET_GB", "").strip()
            if raw:
                try:
                    # binary GiB: the same unit every report line prints
                    budget_bytes = float(raw) * 2 ** 30
                except ValueError:
                    if raw not in _warned_budgets:
                        _warned_budgets.add(raw)
                        logging.getLogger("mxnet_tpu.graphlint").warning(
                            "MXNET_MEMLINT_BUDGET_GB=%r is not a number; "
                            "no memory budget is enforced", raw)
        self.budget_bytes = budget_bytes
        if bwd_policy not in ("stash", "recompute"):
            raise ValueError("bwd_policy must be 'stash' or 'recompute', "
                             "got %r" % (bwd_policy,))
        self.bwd_policy = bwd_policy
        self.train = bool(train)
        self.entry_spec: Dict[Tuple[int, int], tuple] = {}
        self.memory_plan = None
        # filled by shard_lint when a mesh is set: the UNCAPPED GL402 totals
        # (the diagnostic list stays capped for humans; planners/JSON
        # consumers read these)
        self.reshard_total_bytes: Optional[int] = None
        self.reshard_edges: List[dict] = []

    # ---------------------------------------------------------------- helpers
    def node_label(self, node) -> str:
        return node.name if node.is_variable else "%s(%s)" % (node.name, node.op)

    def entry_desc(self, node, out_idx: int = 0) -> str:
        """Human line for one graph entry: name(op): shape dtype."""
        sh = self.entry_shape.get((id(node), out_idx))
        dt = self.entry_dtype.get((id(node), out_idx))
        return "%s: shape=%s dtype=%s" % (
            self.node_label(node),
            "?" if sh is None else tuple(sh),
            "?" if dt is None else getattr(dt, "name", dt),
        )

    def provenance(self, node, depth: int = 4, max_lines: int = 12) -> List[str]:
        """Producer chain for ``node``: its inputs, their inputs, ... with
        inferred shapes/dtypes — the graph-level story a JAX traceback loses."""
        lines: List[str] = []
        seen = set()
        frontier = [(inp, oi, 1) for inp, oi in node.inputs]
        while frontier and len(lines) < max_lines:
            inp, oi, lvl = frontier.pop(0)
            key = (id(inp), oi)
            if key in seen:
                continue
            seen.add(key)
            lines.append("%s%s" % ("  " * (lvl - 1), self.entry_desc(inp, oi)))
            if lvl < depth:
                frontier.extend((i2, o2, lvl + 1) for i2, o2 in inp.inputs)
        return lines


def run_graph_passes(symbol, shape_hints=None, type_hints=None,
                     strict_shapes=None, passes=None, target="", mesh=None,
                     rules=None, budget_bytes=None, bwd_policy="stash",
                     train=True) -> Report:
    """Run every registered graph pass (or the named subset) over ``symbol``.

    A pass that itself crashes is reported as a GL001 on the pass, never
    swallowed and never fatal to the other passes — the linter must not be
    flakier than the thing it lints.
    """
    # passes live in sibling modules registered at import time
    from . import (shape_lint, retrace_guard, fusion_explain,  # noqa: F401
                   shard_lint, memory_plan, dispatch_lint,  # noqa: F401
                   concurrency_lint)  # noqa: F401

    ctx = GraphContext(symbol, shape_hints=shape_hints, type_hints=type_hints,
                       strict_shapes=strict_shapes, mesh=mesh, rules=rules,
                       budget_bytes=budget_bytes, bwd_policy=bwd_policy,
                       train=train)
    report = Report(target=target)
    selected = set(passes) if passes is not None else None
    if selected is not None:
        unknown = selected - {n for n, _ in _PASSES}
        if unknown:
            # a typo'd pass subset must not lint nothing and report "clean"
            raise ValueError(
                "unknown analysis pass(es) %s; registered: %s"
                % (sorted(unknown), list_passes()))
    for name, fn in _PASSES:
        if selected is not None and name not in selected:
            continue
        try:
            result = fn(ctx)
            if result:
                for d in result:
                    d.pass_name = d.pass_name or name
                    report.add(d)
        except Exception as exc:  # pragma: no cover - pass bug guard
            report.add(Diagnostic(
                "GL001",
                "analysis pass %r crashed: %s: %s"
                % (name, type(exc).__name__, exc),
                pass_name=name,
                fix_hint="report this as a graphlint bug; other passes ran",
            ))
    report.memory_plan = ctx.memory_plan
    report.reshard_total_bytes = ctx.reshard_total_bytes
    return report
