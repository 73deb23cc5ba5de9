"""Static analysis of the port: the graph lint, the bind-time rewrite, the
engine-race analysis and the dispatch and concurrency lints.

Counterpart of ``mxnet_tpu/analysis/__init__.py`` (:27-125):

* ``lint(symbol, shapes=..., types=...)`` — run the graph passes
  (``shape_lint``, ``retrace_guard``, ``fusion_explain``, ``shard_lint``,
  ``memory_plan``, ``dispatch_lint``, ``concurrency_lint``) and get a
  ``Report`` of ``Diagnostic``s with the reference's ``GLxxx`` codes.
  ``mesh="dp=8,model=2"`` (and ``rules``/``budget_gb``/``bwd``) adds the
  GL4xx sharding-plan lint and the GL5xx per-device memory plan, whose
  table lands on ``Report.memory_plan``.
* ``MXNET_GRAPHLINT=warn|error`` — ``executor.bind``/``simple_bind`` and
  the fused step's bind (``module.spmd_adapter``, with the real mesh and
  rules) run the same passes; ``warn`` logs, ``error`` raises
  ``MXNetError`` with the formatted report.
* ``rewrite(symbol, shapes=..., types=...)`` — the Symbol→Symbol
  rewrite pipeline (``rewrite.py``): const fold, CSE, canonicalize, the
  opt-in bf16 legalization and DCE, returning a ``RewriteResult`` that
  ``verify_rewrite`` checks (GL6xx); ``pattern_site_counts`` counts the
  fusion sites a symbol roots. ``MXNET_GRAPHREWRITE=on|verify`` runs it at
  every bind (``rewrite_for_bind``); under ``0`` a bind runs the port's
  always-on rules.
* ``python -m mxnet_tpu_torch.analysis.cli`` — the ``graphlint`` CLI: lints
  bundled models or a serialized Symbol JSON (``--all-models``), dumps
  rewrites (``--rewrite``) and parallel plans (``--autoplan``), and runs the
  source lints over Python files (``--dispatch [--trace dump.json]``,
  ``--concurrency [--witness dump.json]``). It allocates nothing on the card.

Engine schedules are analyzed separately (they are runtime traces, not
graphs): wrap any engine in ``RecordingEngine``, run the workload, then
``analyze_trace(engine.trace)``. The measured lints read a run's telemetry:
``lint_dispatch_gaps(telemetry.gap_summary(...))`` (GL705) and
``concurrency_lint.lint_lock_witness(telemetry.witness_report())`` (GL805).
"""
from __future__ import annotations

import logging
import os

from ..base import MXNetError
# registration order IS run order: the passes register here, in the order of
# the reference's manager (its own order follows whichever of its modules a
# process imports first)
from . import (shape_lint, retrace_guard, fusion_explain,  # noqa: F401
               shard_lint, memory_plan, dispatch_lint,  # noqa: F401
               concurrency_lint)  # noqa: F401
from .diagnostics import CODES, Diagnostic, Report, Severity, describe_code
from .dispatch_lint import (dispatch_gap_pct, lint_dispatch_gaps,
                            lint_dispatch_paths, lint_dispatch_source)
from .engine_race import RecordingEngine, ScheduleTrace, analyze_trace
from .manager import GraphContext, graph_pass, list_passes, run_graph_passes
from .rewrite import (RewritePass, RewriteResult, graphrewrite_mode,  # noqa: F401
                      pattern_site_counts, rewrite, rewrite_for_bind,
                      rewrite_pass_names, verify_rewrite)

__all__ = [
    "CODES", "Diagnostic", "Report", "Severity", "describe_code",
    "GraphContext", "graph_pass", "list_passes", "run_graph_passes",
    "RecordingEngine", "ScheduleTrace", "analyze_trace",
    "lint", "lint_bind", "graphlint_mode",
    "rewrite", "verify_rewrite", "graphrewrite_mode", "RewritePass",
    "RewriteResult", "rewrite_pass_names", "pattern_site_counts",
    "lint_dispatch_paths", "lint_dispatch_source", "lint_dispatch_gaps",
    "dispatch_gap_pct",
]

_LOG = logging.getLogger("mxnet_tpu.graphlint")


# copied from mxnet_tpu/analysis/__init__.py (lint; backend-free)
def lint(symbol, shapes=None, types=None, strict_shapes=None, passes=None,
         target="", mesh=None, rules=None, budget_gb=None, bwd="stash",
         train=True) -> Report:
    """Run the registered graph passes over ``symbol``.

    ``shapes``/``types`` are name->shape / name->dtype hints (same contract
    as ``Symbol.infer_shape``/``infer_type`` kwargs). ``strict_shapes``
    defaults to True when shape hints are given: underdetermined arguments
    are then GL002 errors rather than expected polymorphism (GL203).

    ``mesh`` is a ``parallel.MeshSpec``/``parallel.Mesh``/axis dict/
    ``"dp=8,model=2"`` string enabling the sharding-plan lint; ``rules``
    overrides the ``ShardingRules`` derived from it. ``budget_gb`` (binary
    GiB — the unit every report line prints; default: the
    ``MXNET_MEMLINT_BUDGET_GB`` env) arms GL501; ``bwd`` is the planner's
    stash/recompute policy and ``train`` toggles grad/optimizer accounting.
    """
    if mesh is not None:
        from ..parallel.mesh import parse_mesh_spec

        mesh = parse_mesh_spec(mesh)
    return run_graph_passes(symbol, shape_hints=shapes, type_hints=types,
                            strict_shapes=strict_shapes, passes=passes,
                            target=target, mesh=mesh, rules=rules,
                            budget_bytes=(None if budget_gb is None
                                          else float(budget_gb) * 2 ** 30),
                            bwd_policy=bwd, train=train)


_warned_modes = set()


# copied from mxnet_tpu/analysis/__init__.py (graphlint_mode; backend-free)
def graphlint_mode():
    """The MXNET_GRAPHLINT env knob: None (off, the default), 'warn', or
    'error'. Boolean-style truthy values ('1', 'true', 'on') mean 'warn';
    anything else logs a one-time warning and stays off rather than letting
    the user believe a gate is active that never runs."""
    raw = os.environ.get("MXNET_GRAPHLINT", "0").strip().lower()
    if raw in ("warn", "error"):
        return raw
    if raw in ("1", "true", "on"):
        return "warn"
    if raw not in ("", "0", "false", "off") and raw not in _warned_modes:
        _warned_modes.add(raw)
        _LOG.warning("MXNET_GRAPHLINT=%r is not a recognized mode "
                     "(0|warn|error); graphlint stays OFF", raw)
    return None


# copied from mxnet_tpu/analysis/__init__.py (lint_bind; backend-free)
def lint_bind(symbol, shapes, types, mode, target="bind", mesh=None,
              rules=None, train=True):
    """Bind-time hook used by ``executor.bind`` (single device: memory plan
    only) and ``SPMDStepAdapter`` (real mesh + rules: the full GL4xx/GL5xx
    suite): lint with the concrete bind shapes/dtypes, log findings, and
    under ``error`` raise MXNetError when any error-severity diagnostic
    fires."""
    report = lint(symbol, shapes=shapes, types=types, strict_shapes=True,
                  target=target, mesh=mesh, rules=rules, train=train)
    for d in report:
        if d.severity == Severity.ERROR:
            _LOG.error(d.format())
        elif d.severity == Severity.WARNING:
            _LOG.warning(d.format())
        else:
            _LOG.debug(d.format())
    if mode == "error" and report.errors:
        raise MXNetError(
            "graphlint found %d error(s) at bind (MXNET_GRAPHLINT=error):\n%s"
            % (len(report.errors), report.format(min_severity=Severity.WARNING)))
    return report
