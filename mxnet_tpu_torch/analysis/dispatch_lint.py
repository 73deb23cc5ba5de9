"""Dispatch-discipline analyzer — the GL7xx family.

Copied from ``mxnet_tpu/analysis/dispatch_lint.py`` (backend-free) but for
its vocabularies and hints, which name the port's own seams. The port's
blocking device->host pulls are torch's: ``.cpu()`` (a method call on a
value; ``pt.cpu()``, the context factory of an imported module, is not),
``.numpy()``, ``.item()``, ``.tolist()``, ``torch.cuda.synchronize()`` and
a CUDA event's or stream's ``.synchronize()``; its dispatches include a
captured CUDA graph's ``.replay()``. The fix a loop finding asks for is a
CUDA-graph megastep (``serving/kv_decode.py`` ``decode_megastep``).

PyGraph's observation (PAPERS.md) is that small-kernel work-loops are
priced by per-launch CPU overhead, not device compute; the decode loop in
``serving/kv_decode.py`` is the canonical shape: one executable dispatch
per token with a device->host pull in between, so the card idles for the
host round-trip every step. No Symbol-level pass can see that seam — it
lives in the *call sites*, not the graph — so this family has three legs:

  * a source-level lint (``lint_dispatch_paths``) that walks the Python
    call sites with ``ast`` and diagnoses the loop shapes: GL701
    host-sync-inside-loop, GL702 per-iteration dispatch a megastep could
    fold (with a modeled dispatches-saved estimate), GL703 host-side
    reduction with an on-device lowering, GL704 premature blocking pull
    that serializes an async dispatch chain;
  * a graph pass (``dispatch_lint``) on the shared ``GraphContext`` walk
    that flags decode-signature Symbols (loop-carried KV outputs plus a
    full-logits head) with no on-device token reduction — the graph-side
    face of GL703, run at ``executor.bind`` / SPMD bind under
    ``MXNET_GRAPHLINT`` like every other family;
  * a measured lint (``lint_dispatch_gaps``) over the telemetry
    ``dispatch.host_gap`` attribution: GL705 when the host gap between an
    executable's return and the next enqueue exceeds
    ``MXNET_DISPATCHLINT_GAP_PCT`` of device busy time.

Acknowledged sites carry an inline waiver comment::

    x = exe.outputs[0].asnumpy()  # graphlint: waive GL703 -- reason

on the finding's line (or the line above). Waived findings stay in the
site table but do not fail the run. ``GL7xx`` waives the whole family.
"""
from __future__ import annotations

import ast
import logging
import os
import re
from typing import Dict, List, Optional, Tuple

from .diagnostics import Diagnostic, Report
from .manager import graph_pass
# registration order IS run order: the graph-side pass below reads
# ctx.entry_shape/var_shape, which shape_lint fills — import it first so
# an eager ``from analysis import dispatch_lint`` cannot register us ahead
# of it
from . import shape_lint  # noqa: F401

__all__ = ["lint_dispatch_paths", "lint_dispatch_source",
           "lint_dispatch_gaps", "dispatch_gap_pct", "DEFAULT_SCAN_PATHS"]

_log = logging.getLogger("mxnet_tpu.graphlint")

# call-site vocabulary ------------------------------------------------------
# a method call by one of these names enqueues device work. The megastep
# entry points (serving/kv_decode.py decode_megastep/step_megastep) are
# dispatches too — K tokens per call, but still one host round-trip each,
# so a loop over them is a (K-amortized) GL701 site; so is a captured CUDA
# graph's replay.
_DISPATCH_NAMES = frozenset({"forward", "decode_step", "greedy_step",
                             "step", "prefill", "run",
                             "decode_megastep", "step_megastep", "replay"})
# a call by one of these names blocks on a device->host transfer: the
# reference's, and torch's copies to the host (.cpu(), .numpy()) and waits
# (torch.cuda.synchronize(), Event/Stream.synchronize())
_PULL_NAMES = frozenset({"asnumpy", "block_until_ready", "item", "tolist",
                         "cpu", "numpy", "synchronize"})
# host reductions numpy performs that sym.* can lower on device instead
_HOST_REDUCERS = frozenset({"argmax", "argmin", "argsort", "argpartition",
                            "choice"})  # np.random.choice = host sampling
# on-device reduction ops: their presence in a graph clears graph-side GL703
_DEVICE_ARG_OPS = frozenset({"argmax", "argmin", "argmax_channel", "topk",
                             "sample_multinomial", "multinomial"})
# loss heads: a training symbol's non-carry output, never a logits head a
# decoder would reduce on host
_LOSS_OPS = frozenset({"SoftmaxOutput", "LinearRegressionOutput",
                       "LogisticRegressionOutput", "MAERegressionOutput",
                       "MakeLoss", "softmax_cross_entropy"})

# default source-scan surface: the serving hot paths. The port's
# tools/torch_*.py scripts time closures of these paths, and none of them
# loops over a dispatch itself. Model zoo code never dispatches in a loop,
# so it is not scanned — the graph pass covers Symbols.
DEFAULT_SCAN_PATHS = ("mxnet_tpu_torch/serving",)

_WAIVE_RE = re.compile(r"#\s*graphlint:\s*waive\s+([A-Za-z0-9, x]+)")

_warned_pcts: set = set()


def dispatch_gap_pct(default: float = 0.25) -> float:
    """GL705 threshold: host gap as a fraction of device busy time
    (``MXNET_DISPATCHLINT_GAP_PCT``, default 0.25)."""
    raw = os.environ.get("MXNET_DISPATCHLINT_GAP_PCT", "").strip()
    if not raw:
        return default
    try:
        val = float(raw)
        if val <= 0:
            raise ValueError
        return val
    except ValueError:
        if raw not in _warned_pcts:
            _warned_pcts.add(raw)
            _log.warning("MXNET_DISPATCHLINT_GAP_PCT=%r is not a positive "
                         "number; using %.2f", raw, default)
        return default


# --------------------------------------------------------------------------
# source-level analysis
# --------------------------------------------------------------------------

def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_pull(node: ast.Call, imported) -> bool:
    """A blocking device->host pull. ``cpu`` is one only as a method call
    on a value: ``cpu()``, ``cpu(0)`` and ``pt.cpu()`` (``pt`` bound by an
    import) make a context."""
    name = _call_name(node)
    if name not in _PULL_NAMES:
        return False
    if name != "cpu":
        return True
    f = node.func
    return (isinstance(f, ast.Attribute) and not node.args
            and not (isinstance(f.value, ast.Name) and f.value.id in imported))


def _imported_names(tree) -> set:
    """Names an import statement binds anywhere in the module."""
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            for a in n.names:
                out.add((a.asname or a.name).split(".")[0])
    return out


def _base_name(expr) -> Optional[str]:
    """Leftmost Name of an attribute/subscript chain: exe.outputs[0] -> exe."""
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _walk_shallow(node):
    """Walk ``node`` without descending into nested function/class defs."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


class _FuncFacts:
    """Per-function call inventory, one level of the module call graph."""

    def __init__(self, qualname: str, node, imported=frozenset()):
        self.qualname = qualname
        self.node = node
        self.imported = imported
        self.pulls: List[Tuple[int, str]] = []       # (line, pull name)
        self.dispatches: List[Tuple[int, str]] = []  # (line, call name)
        for n in _walk_shallow(node):
            if not isinstance(n, ast.Call):
                continue
            name = _call_name(n)
            if _is_pull(n, imported):
                self.pulls.append((n.lineno, name))
            elif name in _DISPATCH_NAMES:
                self.dispatches.append((n.lineno, name))


def _collect_functions(tree) -> Dict[str, _FuncFacts]:
    """qualname -> facts; methods indexed under both Class.meth and meth
    (``self.decode_step(...)`` resolves by bare name)."""
    out: Dict[str, _FuncFacts] = {}
    imported = frozenset(_imported_names(tree))

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = prefix + child.name
                facts = _FuncFacts(q, child, imported)
                out[q] = facts
                out.setdefault(child.name, facts)
            elif isinstance(child, ast.ClassDef):
                visit(child, child.name + ".")

    visit(tree, "")
    return out


def _range_trip_count(loop) -> Optional[str]:
    """Human trip-count of ``for _ in range(...)``: a literal, a name, or
    None when the loop is not range-shaped (while loops, iterators)."""
    if not isinstance(loop, ast.For):
        return None
    it = loop.iter
    if isinstance(it, ast.Call) and _call_name(it) == "range" and it.args:
        last = it.args[-1]
        if isinstance(last, ast.Constant) and isinstance(last.value, int):
            return str(last.value)
        if isinstance(last, ast.Name):
            return last.id
        if isinstance(last, ast.Attribute):
            return ast.unparse(last) if hasattr(ast, "unparse") else last.attr
    return None


def _load_waivers(text: str) -> Dict[int, set]:
    """line -> set of waived codes; a waiver covers its own line and the
    line below (comment-above style)."""
    waivers: Dict[int, set] = {}
    for i, line in enumerate(text.splitlines(), 1):
        m = _WAIVE_RE.search(line)
        if not m:
            continue
        codes = {c.strip().upper() for c in m.group(1).split(",") if c.strip()}
        waivers.setdefault(i, set()).update(codes)
        waivers.setdefault(i + 1, set()).update(codes)
    return waivers


def _is_waived(waivers: Dict[int, set], line: int, code: str) -> bool:
    at = waivers.get(line, ())
    return code in at or "GL7XX" in at


class _Finding:
    """One dispatch-lint site: a Diagnostic plus table metadata."""

    def __init__(self, code, path, line, function, message, fix_hint=None,
                 provenance=None, waived=False):
        self.code = code
        self.path = path
        self.line = line
        self.function = function
        self.message = message
        self.fix_hint = fix_hint
        self.provenance = list(provenance or [])
        self.waived = waived

    @property
    def site(self) -> str:
        return "%s:%d" % (self.path, self.line)

    def to_diagnostic(self) -> Diagnostic:
        msg = self.message
        if self.waived:
            msg += " [waived]"
        return Diagnostic(self.code, msg, node=self.site,
                          fix_hint=self.fix_hint, provenance=self.provenance,
                          pass_name="dispatch_lint",
                          severity="info" if self.waived else None)

    def to_dict(self) -> dict:
        return {"code": self.code, "file": self.path, "line": self.line,
                "function": self.function, "message": self.message,
                "fix_hint": self.fix_hint, "waived": self.waived,
                "provenance": list(self.provenance)}


def lint_dispatch_source(path: str, text: Optional[str] = None
                         ) -> List[_Finding]:
    """Static GL701-GL704 over one Python source file.

    The analysis is a module-local call graph (one level deep: a loop that
    calls ``self.decode_step`` inherits decode_step's pulls/dispatches) —
    exactly deep enough for the decoder/bench loop shapes without whole-
    program inference."""
    if text is None:
        with open(path) as f:
            text = f.read()
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as exc:
        return [_Finding("GL704", path, exc.lineno or 1, "<module>",
                         "unparseable source: %s" % exc, waived=False)]
    waivers = _load_waivers(text)
    funcs = _collect_functions(tree)
    findings: List[_Finding] = []
    seen = set()

    def add(code, line, function, message, fix_hint=None, provenance=None):
        key = (code, line)
        if key in seen:
            return
        seen.add(key)
        findings.append(_Finding(
            code, path, line, function, message, fix_hint=fix_hint,
            provenance=provenance, waived=_is_waived(waivers, line, code)))

    for facts in {id(f): f for f in funcs.values()}.values():
        _lint_function(facts, funcs, add)
    findings.sort(key=lambda f: (f.line, f.code))
    return findings


def _lint_function(facts: _FuncFacts, funcs, add):
    fn = facts.node
    # ---- GL701 / GL702: loop shapes -------------------------------------
    for loop in _walk_shallow(fn):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        pulls: List[Tuple[int, List[str]]] = []     # (line, provenance)
        dispatches: List[Tuple[int, str, object]] = []  # (line, label, call)
        assigned: Dict[str, set] = {}               # name -> names it reads
        for n in _walk_shallow(loop):
            if isinstance(n, ast.Assign):
                reads = _names_in(n.value)
                for tgt in n.targets:
                    for t in ast.walk(tgt):
                        if isinstance(t, ast.Name):
                            assigned.setdefault(t.id, set()).update(reads)
            if not isinstance(n, ast.Call):
                continue
            name = _call_name(n)
            if _is_pull(n, facts.imported):
                pulls.append((n.lineno, []))
            elif name in _DISPATCH_NAMES:
                dispatches.append((n.lineno, name, n))
                callee = funcs.get(name)
                if callee is not None and callee.node is not fn:
                    # one level of the module call graph: the loop inherits
                    # the callee's host syncs
                    for pline, pname in callee.pulls:
                        pulls.append((pline, [
                            "%s() pulls to host at line %d (%s)"
                            % (callee.qualname, pline, pname),
                            "called from the loop at line %d in %s"
                            % (n.lineno, facts.qualname)]))
        if dispatches and pulls:
            for pline, prov in pulls:
                add("GL701", pline, facts.qualname,
                    "device->host pull inside the dispatch loop at line %d "
                    "(%s): the pulled value gates the next iteration's "
                    "dispatch, so the device idles for a host round-trip "
                    "every step" % (loop.lineno, facts.qualname),
                    fix_hint="keep the loop state on device and fold the "
                    "loop into a CUDA-graph megastep (serving/kv_decode.py "
                    "decode_megastep: K steps a replay)",
                    provenance=prov)
        if dispatches:
            # loop-carried state, strictly: some argument of a dispatch
            # reads (transitively through in-loop assignments) a name that
            # holds a dispatch result — `logits = step(tok); tok = f(logits)`.
            # Merely assigning things in a loop that also dispatches (warmup
            # loops, retry loops) is not a megastep's shape.
            results = set()
            for n in _walk_shallow(loop):
                if isinstance(n, ast.Assign) and any(
                        isinstance(c, ast.Call)
                        and _call_name(c) in _DISPATCH_NAMES
                        for c in ast.walk(n.value)):
                    for tgt in n.targets:
                        for t in ast.walk(tgt):
                            if isinstance(t, ast.Name):
                                results.add(t.id)

            def _reaches_result(name):
                stack, visited = [name], set()
                while stack:
                    cur = stack.pop()
                    if cur in visited:
                        continue
                    visited.add(cur)
                    if cur in results:
                        return True
                    stack.extend(assigned.get(cur, ()))
                return False

            carried = any(
                _reaches_result(an)
                for _, _, call in dispatches
                for a in list(call.args) + [kw.value for kw in call.keywords]
                for an in _names_in(a))
            if carried:
                trips = _range_trip_count(loop)
                saved = ("~%s-1 dispatches -> 1" % trips) if trips else \
                    "N-1 of N per-iteration dispatches"
                dline = dispatches[0][0]
                add("GL702", dline, facts.qualname,
                    "per-iteration executable dispatch with loop-carried "
                    "state (loop at line %d); a CUDA-graph megastep saves "
                    "%s" % (loop.lineno, saved),
                    fix_hint="fold the loop into a CUDA-graph megastep: "
                    "keep the loop state in the graph's buffers, replay "
                    "once")
    # ---- GL703: host reduction of a device output -----------------------
    # names assigned (anywhere in the function) from a dispatch or a pull
    device_derived: Dict[str, Tuple[int, str]] = {}
    for n in _walk_shallow(fn):
        if not isinstance(n, ast.Assign):
            continue
        for c in ast.walk(n.value):
            if isinstance(c, ast.Call) and (
                    _call_name(c) in _DISPATCH_NAMES
                    or _is_pull(c, facts.imported)):
                origin = "%s() at line %d" % (_call_name(c), c.lineno)
                for tgt in n.targets:
                    for t in ast.walk(tgt):
                        if isinstance(t, ast.Name):
                            device_derived[t.id] = (c.lineno, origin)
    for n in _walk_shallow(fn):
        if not (isinstance(n, ast.Call) and _call_name(n) in _HOST_REDUCERS):
            continue
        arg_names = set()
        for a in list(n.args) + [kw.value for kw in n.keywords]:
            arg_names |= _names_in(a)
        inline_pull = any(
            isinstance(c, ast.Call) and _is_pull(c, facts.imported)
            for a in n.args for c in ast.walk(a))
        hits = sorted(an for an in arg_names if an in device_derived)
        if not hits and not inline_pull:
            continue
        prov = ["%s derives from %s" % (an, device_derived[an][1])
                for an in hits]
        add("GL703", n.lineno, facts.qualname,
            "host-side %s() of a device output; sym.%s lowers the same "
            "reduction on device, so the host need only pull the reduced "
            "result" % (_call_name(n), _call_name(n)
                        if _call_name(n) != "choice" else "multinomial"),
            fix_hint="add the reduction to the executable's outputs and "
            "pull the (tiny) reduced array instead of the full tensor",
            provenance=prov)
    # ---- GL704: premature blocking pull between independent dispatches --
    _lint_premature_pull(facts, add)


def _lint_premature_pull(facts: _FuncFacts, add):
    """Straight-line shape: dispatch on A, blocking pull of A's output,
    then a dispatch on B that does not consume the pulled value — the pull
    serializes B behind A's device completion for no reason."""
    events = []  # (line, kind, base, result_names, arg_names)
    for stmt in _walk_shallow(facts.node):
        if isinstance(stmt, (ast.For, ast.While)):
            return  # loop bodies belong to GL701/GL702
        if not isinstance(stmt, ast.Assign):
            if isinstance(stmt, ast.Expr):
                stmt_val = stmt.value
                targets = []
            else:
                continue
        else:
            stmt_val = stmt.value
            targets = [t.id for tgt in stmt.targets
                       for t in ast.walk(tgt) if isinstance(t, ast.Name)]
        for c in ast.walk(stmt_val):
            if not isinstance(c, ast.Call):
                continue
            name = _call_name(c)
            if name in _DISPATCH_NAMES:
                events.append((c.lineno, "dispatch",
                               _base_name(c.func), set(targets),
                               _names_in(c)))
            elif _is_pull(c, facts.imported):
                events.append((c.lineno, "pull",
                               _base_name(c.func), set(targets), set()))
    events.sort(key=lambda e: e[0])
    dispatched_bases = {}
    for i, (line, kind, base, results, _args) in enumerate(events):
        if kind == "dispatch":
            dispatched_bases[base] = line
            for r in results:
                dispatched_bases[r] = line
            continue
        if base not in dispatched_bases:
            continue
        for lline, lkind, lbase, _lres, largs in events[i + 1:]:
            if lkind == "dispatch" and lbase != base \
                    and not (results & largs):
                add("GL704", line, facts.qualname,
                    "blocking pull of %r (dispatched at line %d) before "
                    "the independent dispatch at line %d: the pull "
                    "serializes an async dispatch chain"
                    % (base, dispatched_bases[base], lline),
                    fix_hint="enqueue the independent dispatch first, "
                    "then pull; device queues overlap the transfer")
                break


def _iter_py_files(paths):
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif os.path.exists(p):
            yield p
        else:
            raise OSError("dispatch-lint path does not exist: %s" % p)


def lint_dispatch_paths(paths=None, root: Optional[str] = None
                        ) -> Tuple[Report, List[dict]]:
    """Run the source-level dispatch lint over ``paths`` (files or
    directories; default ``DEFAULT_SCAN_PATHS`` resolved against ``root``
    or the repo checkout this package sits in).

    Returns ``(Report, site rows)``; waived findings are severity-info in
    the report (they never fail a run) and ``"waived": true`` in the rows.
    """
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    if paths is None:
        paths = [os.path.join(root, p) for p in DEFAULT_SCAN_PATHS]
        paths = [p for p in paths if os.path.exists(p)]
    report = Report(target="dispatch")
    sites: List[dict] = []
    for path in _iter_py_files(paths):
        rel = os.path.relpath(path, root) if os.path.isabs(path) else path
        for f in lint_dispatch_source(path):
            f.path = rel
            report.add(f.to_diagnostic())
            sites.append(f.to_dict())
    return report, sites


# --------------------------------------------------------------------------
# measured side: GL705 over the dispatch.host_gap attribution
# --------------------------------------------------------------------------

def lint_dispatch_gaps(gap_rows, pct: Optional[float] = None,
                       min_intervals: int = 2) -> List[Diagnostic]:
    """GL705 over ``telemetry.gap_summary`` rows (``{"name", "count",
    "busy_ms", "gap_ms", "intervals", "max_gap_ms"}``): flag a call site
    whose summed host gap exceeds ``pct`` (default
    ``MXNET_DISPATCHLINT_GAP_PCT``) of its device busy time."""
    if pct is None:
        pct = dispatch_gap_pct()
    out: List[Diagnostic] = []
    for row in gap_rows:
        if row.get("intervals", 0) < min_intervals:
            continue
        busy = float(row.get("busy_ms", 0.0))
        gap = float(row.get("gap_ms", 0.0))
        if busy <= 0.0 or gap <= pct * busy:
            continue
        out.append(Diagnostic(
            "GL705",
            "measured host gap at %r: %.3f ms across %d intervals = "
            "%.0f%% of %.3f ms device busy time (threshold %.0f%%)"
            % (row.get("name"), gap, row.get("intervals", 0),
               100.0 * gap / busy, busy, 100.0 * pct),
            node=row.get("name"),
            fix_hint="the host gates every dispatch at this site; batch "
            "the host work or fold the loop into a CUDA-graph megastep",
            pass_name="dispatch_lint"))
    return out


# --------------------------------------------------------------------------
# graph-side GL703: decode-signature Symbol without an on-device token head
# --------------------------------------------------------------------------

def _carry_outputs(ctx):
    """Output indices that are loop-carried state: the producer's input
    chain (short walk) contains a *variable* whose inferred shape equals
    the output's — the KV write-back pattern ``kv' = f(kv, ...)``."""
    carries = []
    outputs = getattr(ctx.symbol, "_outputs", None)
    if not outputs:
        return carries
    for oi, (node, out_idx) in enumerate(outputs):
        oshape = ctx.entry_shape.get((id(node), out_idx))
        if oshape is None or node.is_variable:
            continue
        frontier, seen, found = [node], set(), False
        for _depth in range(8):
            if not frontier or found:
                break
            nxt = []
            for n in frontier:
                for inp, _ii in n.inputs:
                    if id(inp) in seen:
                        continue
                    seen.add(id(inp))
                    if inp.is_variable:
                        vshape = ctx.var_shape.get(inp.name)
                        if vshape is not None and \
                                tuple(vshape) == tuple(oshape):
                            found = True
                    else:
                        nxt.append(inp)
            frontier = nxt
        if found:
            carries.append(oi)
    return carries


@graph_pass("dispatch_lint")
def dispatch_lint_pass(ctx):
    """Graph-side GL703: a decode-signature Symbol — >=2 loop-carried
    (KV) outputs plus a non-carry, non-loss float head — with no on-device
    arg-reduction anywhere in the graph forces its caller to pull the full
    head tensor and reduce on host every step."""
    diags: List[Diagnostic] = []
    ops = {n.op for n in ctx.topo if not n.is_variable}
    if ops & _DEVICE_ARG_OPS:
        return diags
    carries = set(_carry_outputs(ctx))
    if len(carries) < 2:
        return diags
    outputs = ctx.symbol._outputs
    for oi, (node, out_idx) in enumerate(outputs):
        if oi in carries or node.is_variable or node.op in _LOSS_OPS:
            continue
        sh = ctx.entry_shape.get((id(node), out_idx))
        if sh is None or len(sh) < 2:
            continue
        diags.append(Diagnostic(
            "GL703",
            "decode-signature symbol (%d loop-carried output(s)) exposes "
            "the full %s head %r with no on-device reduction: greedy "
            "decode will pull %s floats per step and argmax on host"
            % (len(carries), "x".join(map(str, sh)), ctx.node_label(node),
               "x".join(map(str, sh))),
            node=ctx.node_label(node), op=node.op,
            fix_hint="append sym.argmax(head, axis=-1) to the output "
            "group (models.transformer.get_decode_symbol token_out=True) "
            "so the host pulls one id per stream",
            provenance=ctx.provenance(node, depth=2, max_lines=4)))
        break  # one finding per symbol: the head, not every output
    return diags
