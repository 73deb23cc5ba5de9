# copied from mxnet_tpu/analysis/diagnostics.py (backend-free)
"""Structured diagnostics for the static-analysis subsystem.

The reference framework surfaces graph errors through nnvm pass exceptions
(InferShape failures are a C++ throw with the node name baked into the
message); XLA surfaces them as multi-page tracebacks from deep inside jit
tracing. Both lose the *graph-level* story. A ``Diagnostic`` keeps it:
every finding has a stable code (``GL001`` ...), a severity, the node it
anchors to, a one-line message, an optional fix hint, and a provenance
chain (producer nodes with their inferred shapes/dtypes) so the user reads
"conv1's data input is rank 2 because flatten0 collapsed it" instead of a
``jax.eval_shape`` stack.

Codes are grouped by pass family:
  * ``GL0xx`` — shape/dtype propagation lint (``shape_lint.py``)
  * ``GL1xx`` — engine race analysis (``engine_race.py``)
  * ``GL2xx`` — retrace guard (``retrace_guard.py``)
  * ``GL3xx`` — fusion eligibility explainer (``fusion_explain.py``)
  * ``GL4xx`` — sharding-plan lint (``shard_lint.py``)
  * ``GL5xx`` — static memory-liveness / peak-HBM planner (``memory_plan.py``)
  * ``GL6xx`` — graph-rewrite provenance verifier (``rewrite.py``)
  * ``GL7xx`` — dispatch-discipline analyzer (``dispatch_lint.py``)
  * ``GL8xx`` — concurrency analyzer (``concurrency_lint.py``)
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

__all__ = ["Severity", "Diagnostic", "Report", "CODES", "describe_code"]


class Severity:
    """Ordered severity levels. ``ERROR`` means a bind/run would fail or
    produce wrong results; ``WARNING`` means probably-unintended behavior;
    ``INFO`` is explanatory (fusion rejections, retrace economics)."""

    INFO = "info"
    WARNING = "warning"
    ERROR = "error"

    _ORDER = {INFO: 0, WARNING: 1, ERROR: 2}

    @classmethod
    def rank(cls, sev: str) -> int:
        return cls._ORDER[sev]


# code -> (default severity, one-line description). docs/static_analysis.md
# documents each in depth; tests/test_graphlint.py triggers each one.
CODES = {
    # --- shape/dtype propagation lint ------------------------------------
    "GL001": (Severity.ERROR,
              "unbindable node: op-level shape/dtype inference failed"),
    "GL002": (Severity.ERROR,
              "underdetermined argument shape after applying all hints"),
    "GL003": (Severity.ERROR,
              "declared shape conflicts with the inferred shape"),
    "GL004": (Severity.WARNING,
              "silent dtype promotion across mixed-dtype inputs"),
    "GL005": (Severity.ERROR,
              "duplicate node name (bind-by-name would collide)"),
    "GL006": (Severity.ERROR,
              "input rank violates the op's declared rank constraints"),
    # --- engine race analysis --------------------------------------------
    "GL101": (Severity.WARNING,
              "variable appears in both const_vars and mutable_vars of one push"),
    "GL102": (Severity.WARNING,
              "wait_for_var on a variable no push ever writes"),
    "GL103": (Severity.WARNING,
              "duplicate variable inside one push's mutable_vars (write-write)"),
    "GL104": (Severity.WARNING,
              "read of a variable with no preceding write (unordered read-write)"),
    "GL105": (Severity.ERROR,
              "runtime engine-discipline violation (ops overlapped on a var)"),
    # --- retrace guard -----------------------------------------------------
    "GL201": (Severity.INFO,
              "python scalar baked into the trace as an op attribute"),
    "GL202": (Severity.WARNING,
              "weak-dtype input alongside explicitly-typed variables"),
    "GL203": (Severity.INFO,
              "shape-polymorphic inputs: compile-cache cardinality grows per shape"),
    # --- fusion explainer --------------------------------------------------
    "GL301": (Severity.INFO,
              "convolution rejected by the conv+BN fusion planner"),
    "GL302": (Severity.INFO,
              "BatchNorm not folded into its consumers by the fusion planner"),
    "GL303": (Severity.INFO,
              "generic fusion-pattern site inventory / near-miss rejection"),
    # --- sharding-plan lint ------------------------------------------------
    "GL401": (Severity.WARNING,
              "parameter silently replicated: no dim divides the model axis"),
    "GL402": (Severity.WARNING,
              "implicit reshard edge: producer/consumer layouts disagree"),
    "GL403": (Severity.WARNING,
              "batch-axis loss: op collapses the data-sharded dim mid-graph"),
    "GL404": (Severity.WARNING,
              "uneven per-device shards: a sharded dim needs padding"),
    "GL405": (Severity.INFO,
              "large replicated parameter a sharding rule could shard"),
    # --- memory planner ----------------------------------------------------
    "GL501": (Severity.WARNING,
              "predicted peak HBM per device exceeds the configured budget"),
    "GL502": (Severity.WARNING,
              "a single activation dominates the predicted memory peak"),
    # --- graph-rewrite verifier (rewrite.py) -------------------------------
    "GL601": (Severity.ERROR,
              "rewrite changed an output's inferred shape/dtype (or the "
              "argument interface)"),
    "GL602": (Severity.ERROR,
              "provenance gap: a rewritten node with no originating rule"),
    "GL603": (Severity.WARNING,
              "rewrite pipeline did not reach a fixpoint within its round "
              "budget"),
    "GL604": (Severity.ERROR,
              "rewrite-eliminated argument still referenced by a grad_req"),
    "GL605": (Severity.INFO,
              "rewrite summary: nodes folded/merged/removed with bytes-saved "
              "estimates"),
    # --- dispatch-discipline analyzer (dispatch_lint.py) -------------------
    "GL701": (Severity.WARNING,
              "host sync inside a dispatch loop: a device->host pull feeds "
              "the next iteration's dispatch"),
    "GL702": (Severity.INFO,
              "foldable per-iteration dispatch: N identical executable "
              "calls with loop-carried state could be one CUDA-graph "
              "megastep"),
    "GL703": (Severity.WARNING,
              "host-side reduction of a device output where an on-device "
              "lowering exists (argmax/top-k/sampling)"),
    "GL704": (Severity.WARNING,
              "premature blocking pull serializes an in-flight async "
              "dispatch chain"),
    "GL705": (Severity.WARNING,
              "measured dispatch gap: host time between executable return "
              "and next enqueue exceeds the threshold fraction of device "
              "time"),
    # --- concurrency analyzer (concurrency_lint.py) ------------------------
    "GL801": (Severity.ERROR,
              "collective-order divergence: a collective call is "
              "control-dependent on rank-varying data (cross-rank deadlock)"),
    "GL802": (Severity.WARNING,
              "unguarded shared state: attribute mutated from >=2 thread "
              "contexts with no common lock on every mutating path"),
    "GL803": (Severity.ERROR,
              "lock-order inversion: cycle in the static lock-acquisition "
              "graph"),
    "GL804": (Severity.WARNING,
              "blocking call (collective/RPC/timeout-less wait) reached "
              "while holding a lock"),
    "GL805": (Severity.WARNING,
              "witnessed concurrency hazard: real-run lock-order inversion "
              "or >threshold hold across a dispatch seam"),
}


def describe_code(code: str) -> str:
    sev, desc = CODES[code]
    return "%s [%s] %s" % (code, sev, desc)


class Diagnostic:
    """One finding: ``code``, ``severity``, ``node``, ``message``,
    ``fix_hint``, ``provenance`` (producer chain lines)."""

    __slots__ = ("code", "severity", "node", "op", "message", "fix_hint",
                 "provenance", "pass_name")

    def __init__(self, code: str, message: str, node: Optional[str] = None,
                 op: Optional[str] = None, fix_hint: Optional[str] = None,
                 provenance: Optional[Sequence[str]] = None,
                 severity: Optional[str] = None, pass_name: str = ""):
        if code not in CODES:
            raise KeyError("unknown diagnostic code %r" % code)
        self.code = code
        self.severity = severity or CODES[code][0]
        self.node = node
        self.op = op
        self.message = message
        self.fix_hint = fix_hint
        self.provenance = list(provenance or [])
        self.pass_name = pass_name

    def format(self, color: bool = False) -> str:
        where = ""
        if self.node:
            where = " @ %s" % self.node
            if self.op:
                where += " (%s)" % self.op
        head = "%s %s%s: %s" % (self.code, self.severity, where, self.message)
        lines = [head]
        for p in self.provenance:
            lines.append("    | " + p)
        if self.fix_hint:
            lines.append("    hint: " + self.fix_hint)
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "node": self.node,
            "op": self.op,
            "message": self.message,
            "fix_hint": self.fix_hint,
            "provenance": list(self.provenance),
            "pass": self.pass_name,
        }

    def __repr__(self):
        return "<Diagnostic %s %s @ %s>" % (self.code, self.severity, self.node)


class Report:
    """An ordered collection of diagnostics from one lint run.

    ``memory_plan`` carries the GL5xx planner's non-diagnostic output (the
    per-device byte table and peak ownership, ``memory_plan.MemoryPlan
    .to_dict()``) when that pass ran with enough shape information — a clean
    graph still has a peak worth printing."""

    def __init__(self, target: str = ""):
        self.target = target
        self.diagnostics: List[Diagnostic] = []
        self.memory_plan: Optional[dict] = None
        # UNCAPPED GL402 reshard total (bytes moved per device per forward)
        # — the per-edge diagnostic list is capped at 8 for humans, but a
        # machine consumer (parallel.autoplan, JSON) must never see a
        # truncated total. None when the shard_lint pass did not run.
        self.reshard_total_bytes: Optional[int] = None
        # the GL6xx rewrite verifier's machine summary (nodes before/after,
        # per-action counts, bytes-saved estimate) — set by
        # rewrite.verify_rewrite; the GL605 diagnostic is its human line
        self.rewrite_summary: Optional[dict] = None

    def add(self, diag: Diagnostic):
        self.diagnostics.append(diag)

    def extend(self, diags):
        self.diagnostics.extend(diags)

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def codes(self):
        return sorted({d.code for d in self.diagnostics})

    def at_least(self, severity: str) -> List[Diagnostic]:
        floor = Severity.rank(severity)
        return [d for d in self.diagnostics if Severity.rank(d.severity) >= floor]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.at_least(Severity.ERROR)

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARNING]

    def ok(self, strict: bool = False) -> bool:
        """No errors (and, with ``strict``, no warnings either)."""
        return not self.at_least(Severity.WARNING if strict else Severity.ERROR)

    def format(self, min_severity: str = Severity.INFO) -> str:
        shown = self.at_least(min_severity)
        lines = []
        if self.target:
            lines.append("== graphlint: %s ==" % self.target)
        if not shown:
            lines.append("clean (%d suppressed below %r)"
                         % (len(self.diagnostics) - len(shown), min_severity)
                         if self.diagnostics else "clean")
        for d in shown:
            lines.append(d.format())
        n_err, n_warn = len(self.errors), len(self.warnings)
        lines.append("%d error(s), %d warning(s), %d total finding(s)"
                     % (n_err, n_warn, len(self.diagnostics)))
        return "\n".join(lines)

    def to_json(self) -> str:
        payload = {
            "target": self.target,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }
        if self.memory_plan is not None:
            payload["memory_plan"] = self.memory_plan
        if self.reshard_total_bytes is not None:
            payload["reshard_total_bytes"] = self.reshard_total_bytes
        if self.rewrite_summary is not None:
            payload["rewrite_summary"] = self.rewrite_summary
        return json.dumps(payload, indent=2)
