"""Concurrency analyzer — the GL8xx family.

Copied from ``mxnet_tpu/analysis/concurrency_lint.py`` (backend-free) but
for its vocabularies and scan surface, which name the port's own: its
collectives are ``torch.distributed``'s (``all_reduce``, ``all_gather*``,
``broadcast*``, ``reduce_scatter_tensor``, ``barrier``,
``monitored_barrier``, ``send``, ``recv``) and the wrappers the port puts
around them (``kvstore._Collective``, ``parallel.trainer``), and its ranks
are read through ``dist.rank``, ``dist.orig_rank`` and ``get_rank``.

The reference engine serialized every mutation through var dependencies
(PAPER.md: the L2 dependency engine IS the race-safety mechanism). This
port replaced that with free threads — serving batcher, fleet health
pollers and dispatch workers, checkpoint writer, prefetch pumps,
supervisor monitor — plus SPMD collectives whose one hard rule is that
every rank reaches the same collectives in the same order. Neither
property is visible in any Symbol graph; both live in the Python call
sites. So, like GL7xx, this family has a static side and a measured side:

  * **GL801** collective-order divergence: a collective call
    (``allreduce*``, ``allgather*``, barrier, reduce-scatter, ``reform``)
    control-dependent on rank-varying data — the rank itself, a dead-node
    scan, a local clock, a fault-injection outcome, or a caught-exception
    branch. If the condition can differ across ranks, some rank skips (or
    reorders) the rendezvous and the rest hang in it. Reported with the
    provenance chain from the divergent condition to the collective.
  * **GL802** unguarded shared state: an attribute mutated from >=2
    execution contexts — thread entry points discovered from
    ``threading.Thread(target=...)``/``Timer``/pool-``submit`` sites,
    plus the public API surface — with no common lock held on every
    mutating path.
  * **GL803** lock-order inversion: a cycle in the static
    lock-acquisition graph over the named lock attributes.
  * **GL804** blocking-while-holding-lock: a collective, an RPC, or a
    timeout-less ``queue.get()``/``future.result()``/``join()``/
    ``wait()`` reached with a lock held. ``cond.wait()`` on a condition
    backed by the held lock is exempt — wait releases it.
  * **GL805** (measured): ``telemetry.lockwitness`` events from a real
    run under ``MXNET_CONCLINT=witness`` — an observed inversion, or a
    >``MXNET_CONCLINT_HOLD_MS`` hold spanning a dispatch seam.

The analysis is module-local with a bounded call-graph closure: thread
contexts propagate transitively through same-module calls, lock-held sets
inherit two levels of call sites, collective detection follows one level.
That is deep enough for this repo's thread shapes without whole-program
inference — the same budget GL7xx set.

Waivers follow the GL7xx comment convention::

    self._reform()  # graphlint: waive GL801 -- first-write-wins payload

on the finding's line or the line above; ``GL8xx`` waives the family.
CLI: ``python -m mxnet_tpu_torch.analysis.cli --concurrency [paths]
[--format json] [--witness dump.json]``.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, Report
from .manager import graph_pass
# registration order IS run order: keep the family order stable by
# importing the earlier families first (see dispatch_lint.py)
from . import shape_lint  # noqa: F401
from . import dispatch_lint  # noqa: F401

__all__ = ["lint_concurrency_source", "lint_concurrency_paths",
           "lint_lock_witness", "DEFAULT_SCAN_PATHS"]

# the threaded/distributed surface the repo gate scans by default
DEFAULT_SCAN_PATHS = ("mxnet_tpu_torch/serving", "mxnet_tpu_torch/kvstore.py",
                      "mxnet_tpu_torch/kvstore_bucket.py",
                      "mxnet_tpu_torch/sparse/kvstore_sparse.py",
                      "mxnet_tpu_torch/dist.py", "mxnet_tpu_torch/checkpoint.py",
                      "mxnet_tpu_torch/io.py", "mxnet_tpu_torch/module/elastic.py")

_WAIVE_RE = re.compile(r"#\s*graphlint:\s*waive\s+([A-Za-z0-9, x]+)")

# ---------------------------------------------------------- vocabularies
# cross-rank rendezvous points: every rank must reach these in the same
# order. reform IS a rendezvous (it barriers inside); the digest verifiers
# are allgathers themselves. The reference's names, then torch.distributed's
# and the port's wrappers of them (kvstore._Collective.allgather_host,
# parallel.trainer's _all_reduce_grads).
_COLLECTIVE_NAMES = frozenset({
    "allreduce", "allreduce_concat", "allreduce_rows", "_allreduce_batch",
    "allgather", "all_gather", "process_allgather", "_allgather_digest",
    "_allgather_union", "make_global_rows",
    "reduce_scatter", "psum", "sync_global_devices",
    "barrier", "_barrier", "wait_at_barrier",
    "broadcast_one_to_all", "_broadcast_rank0",
    "reform", "_verify_across_workers", "_verify_push_round",
    "all_reduce", "all_gather_object", "all_gather_into_tensor",
    "broadcast", "broadcast_object_list", "reduce_scatter_tensor",
    "monitored_barrier", "send", "recv",
    "allgather_host", "_all_reduce_grads",
})

# calls whose RESULT varies per rank. process_count/num_workers are
# deliberately absent: world size is rank-uniform, so guarding a
# collective on it is the correct idiom, not a divergence.
_RANK_CALLS = {
    "process_index": "the process rank",
    "rank": "the process rank",
    "get_rank": "the process rank",
    "orig_rank": "the process's original rank",
    "num_dead_nodes": "a dead-node heartbeat scan",
    "get_num_dead_node": "a dead-node heartbeat scan",
    "_scan_heartbeats": "a dead-node heartbeat scan",
    "dead_members": "a dead-node heartbeat scan",
    "poll_pause": "the elastic pause poll (first observer wins)",
    "time": "a local clock",
    "monotonic": "a local clock",
    "perf_counter": "a local clock",
    "fire": "a fault-injection outcome",
    "should_fire": "a fault-injection outcome",
}
# bare names / attribute names that carry rank-varying values
_RANK_NAMES = frozenset({"rank", "orig_rank", "_orig_rank",
                         "process_index", "num_dead", "n_dead",
                         "dead_nodes"})

# attributes assigned one of these constructors hold a concurrency
# primitive, not shared data — lifecycle writes to them are not GL802
_PRIMITIVE_CTORS = frozenset({
    "Lock", "RLock", "Condition", "Event", "Semaphore", "BoundedSemaphore",
    "Barrier", "Thread", "Timer", "Queue", "SimpleQueue", "LifoQueue",
    "local", "ThreadPoolExecutor", "named_lock", "named_rlock",
    "named_condition"})
_LOCK_CTORS = frozenset({"Lock", "RLock", "allocate_lock", "named_lock",
                         "named_rlock"})
_COND_CTORS = frozenset({"Condition", "named_condition"})

# timeout-less blocking waits (zero-argument form only: dict.get(k),
# "".join(x), thread.join(t) all carry arguments and stay exempt)
_BLOCKING_ZERO_ARG = frozenset({"get", "result", "join", "wait"})
_RPC_HINTS = ("client", "rpc", "stub")


# --------------------------------------------------------------- helpers

def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _self_attr(expr) -> Optional[str]:
    """``self.X`` -> ``"X"``; anything else -> None."""
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return expr.attr
    return None


def _walk_shallow(node):
    """Walk ``node`` without descending into nested function/class defs."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _load_waivers(text: str) -> Dict[int, set]:
    """line -> waived codes; a waiver covers its line and the line below."""
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
    return code in at or "GL8XX" in at


class _Finding:
    """One concurrency-lint site: a Diagnostic plus table metadata."""

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
                          pass_name="concurrency_lint",
                          severity="info" if self.waived else None)

    def to_dict(self) -> dict:
        return {"code": self.code, "file": self.path, "line": self.line,
                "function": self.function, "message": self.message,
                "fix_hint": self.fix_hint, "waived": self.waived,
                "provenance": list(self.provenance)}


# ------------------------------------------------------- module modeling

class _Fn:
    """One function/method with the facts the four checks consume."""

    def __init__(self, qualname: str, name: str, cls: Optional[str], node):
        self.qualname = qualname
        self.name = name
        self.cls = cls              # enclosing class name or None
        self.node = node
        self.collectives: List[Tuple[int, str]] = []  # (line, name), shallow
        self.callees: Set[str] = set()                # bare callee names
        for n in _walk_shallow(node):
            if isinstance(n, ast.Call):
                cname = _call_name(n)
                if cname in _COLLECTIVE_NAMES:
                    self.collectives.append((n.lineno, cname))
                if cname:
                    self.callees.add(cname)


class _Module:
    """Module-local model: functions, classes, lock attributes (with
    Condition aliasing), thread entry points, rank-tainted attributes."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.funcs: Dict[str, _Fn] = {}       # qualname AND bare name
        self.classes: Dict[str, ast.ClassDef] = {}
        self.class_locks: Dict[str, Dict[str, str]] = {}  # cls -> attr->canon
        self.global_locks: Set[str] = set()
        self.entries: Dict[str, int] = {}     # entry bare name -> line
        self.tainted_attrs: Dict[str, str] = {}  # attr -> reason

        for child in ast.iter_child_nodes(tree):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = _Fn(child.name, child.name, None, child)
                self.funcs[child.name] = fn
            elif isinstance(child, ast.ClassDef):
                self.classes[child.name] = child
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        q = "%s.%s" % (child.name, sub.name)
                        fn = _Fn(q, sub.name, child.name, sub)
                        self.funcs[q] = fn
                        self.funcs.setdefault(sub.name, fn)
            elif isinstance(child, ast.Assign) and \
                    isinstance(child.value, ast.Call) and \
                    _call_name(child.value) in _LOCK_CTORS:
                for tgt in child.targets:
                    if isinstance(tgt, ast.Name):
                        self.global_locks.add(tgt.id)
        self._collect_locks_and_taint()
        self._collect_entries()

    def functions(self):
        """Unique _Fn facts (the bare-name aliases dedup away)."""
        return {id(f): f for f in self.funcs.values()}.values()

    def _collect_locks_and_taint(self):
        for fn in self.functions():
            locks = self.class_locks.setdefault(fn.cls, {}) \
                if fn.cls else None
            for n in _walk_shallow(fn.node):
                if not isinstance(n, ast.Assign):
                    continue
                attrs = [a for t in n.targets
                         for a in [_self_attr(t)] if a]
                if not attrs:
                    continue
                val = n.value
                if isinstance(val, ast.Call) and locks is not None:
                    cname = _call_name(val)
                    if cname in _LOCK_CTORS:
                        for a in attrs:
                            locks[a] = a
                    elif cname in _COND_CTORS:
                        # Condition(self._lock) IS self._lock: alias the
                        # cv attribute to the backing lock so with/wait
                        # analysis sees one lock, not two
                        backing = None
                        args = [arg for arg in val.args]
                        # named_condition("name", self._lock): the lock is
                        # the first non-string positional
                        for arg in args:
                            got = _self_attr(arg)
                            if got:
                                backing = got
                                break
                        for a in attrs:
                            locks[a] = locks.get(backing, backing) \
                                if backing else a
                reasons = _rank_reads(val, {}, {})
                if reasons:
                    for a in attrs:
                        self.tainted_attrs.setdefault(a, reasons[0])

    def _collect_entries(self):
        """Thread entry points: Thread(target=f)/Timer(..., f)/submit(f).
        The target resolves by bare name (``self._loop`` -> ``_loop``)."""
        for n in ast.walk(self.tree):
            if not isinstance(n, ast.Call):
                continue
            cname = _call_name(n)
            target = None
            if cname == "Thread":
                for kw in n.keywords:
                    if kw.arg == "target":
                        target = kw.value
            elif cname == "Timer":
                if len(n.args) >= 2:
                    target = n.args[1]
                for kw in n.keywords:
                    if kw.arg == "function":
                        target = kw.value
            elif cname == "submit" and n.args:
                target = n.args[0]
            if target is None:
                continue
            tname = _self_attr(target)
            if tname is None and isinstance(target, ast.Name):
                tname = target.id
            elif tname is None and isinstance(target, ast.Attribute):
                tname = target.attr
            if tname and tname in self.funcs:
                self.entries.setdefault(tname, n.lineno)

    # ------------------------------------------------------ lock identity
    def lock_id(self, expr, cls: Optional[str]):
        """The canonical lock a ``with`` item acquires: ``(cls, attr)``
        for self-attribute locks (Condition attrs alias to their backing
        lock), ``("", name)`` for module-level locks, else None."""
        attr = _self_attr(expr)
        if attr is not None and cls:
            locks = self.class_locks.get(cls, {})
            if attr in locks:
                return (cls, locks[attr])
            return None
        if isinstance(expr, ast.Name) and expr.id in self.global_locks:
            return ("", expr.id)
        return None

    # ------------------------------------------------ context propagation
    def contexts(self) -> Dict[str, Set[str]]:
        """qualname -> execution contexts reaching it: ``thread:<entry>``
        for thread entry points, ``api:<name>`` for public functions and
        methods, propagated transitively through same-module calls."""
        ctx: Dict[str, Set[str]] = {f.qualname: set()
                                    for f in self.functions()}
        for tname in self.entries:
            fn = self.funcs.get(tname)
            if fn is not None:
                ctx[fn.qualname].add("thread:%s" % tname)
        for fn in self.functions():
            if not fn.name.startswith("_") and fn.name not in self.entries:
                ctx[fn.qualname].add("api:%s" % fn.name)
        for _ in range(6):  # bounded closure; call depth here is ~3
            changed = False
            for fn in self.functions():
                mine = ctx[fn.qualname]
                if not mine:
                    continue
                for callee in fn.callees:
                    target = self._resolve(callee, fn.cls)
                    if target is None:
                        continue
                    before = len(ctx[target.qualname])
                    ctx[target.qualname] |= mine
                    changed |= len(ctx[target.qualname]) != before
            if not changed:
                break
        return ctx

    def _resolve(self, bare: str, cls: Optional[str]) -> Optional[_Fn]:
        if cls:
            got = self.funcs.get("%s.%s" % (cls, bare))
            if got is not None:
                return got
        got = self.funcs.get(bare)
        # a bare-name alias may point at another class's method; only
        # trust it for module-level functions or same-class methods
        if got is not None and (got.cls is None or got.cls == cls):
            return got
        return None


def _rank_reads(expr, local_taint: Dict[str, str],
                tainted_attrs: Dict[str, str]) -> List[str]:
    """Provenance lines for every rank-varying read inside ``expr``.
    ``x is None`` comparisons are skipped: presence of a value is
    rank-uniform even when the value (a clock, a scan) is not."""
    out: List[str] = []

    def rec(n):
        if isinstance(n, ast.Compare) and \
                all(isinstance(o, (ast.Is, ast.IsNot)) for o in n.ops):
            return
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            return
        if isinstance(n, ast.Call):
            cname = _call_name(n)
            if cname in _RANK_CALLS:
                out.append("%s() reads %s" % (cname, _RANK_CALLS[cname]))
        elif isinstance(n, ast.Attribute):
            a = _self_attr(n)
            if a is not None and a in tainted_attrs:
                out.append("self.%s carries %s" % (a, tainted_attrs[a]))
            elif n.attr in _RANK_NAMES:
                out.append(".%s reads the process rank" % n.attr)
        elif isinstance(n, ast.Name):
            if n.id in _RANK_NAMES:
                out.append("%r reads the process rank" % n.id)
            elif n.id in local_taint:
                out.append("%r derives from %s" % (n.id, local_taint[n.id]))
        for c in ast.iter_child_nodes(n):
            rec(c)

    rec(expr)
    return out


def _local_taint(fn_node, tainted_attrs: Dict[str, str]) -> Dict[str, str]:
    """Names assigned (transitively, two hops) from rank-varying reads."""
    taint: Dict[str, str] = {}
    for _ in range(2):
        for n in _walk_shallow(fn_node):
            if not isinstance(n, ast.Assign):
                continue
            reasons = _rank_reads(n.value, taint, tainted_attrs)
            if not reasons:
                continue
            for tgt in n.targets:
                if isinstance(tgt, ast.Name):
                    taint.setdefault(tgt.id, reasons[0])
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    for t in tgt.elts:
                        if isinstance(t, ast.Name):
                            taint.setdefault(t.id, reasons[0])
    return taint


# ----------------------------------------------------------------- GL801

def _lint_gl801(model: _Module, fn: _Fn, add):
    taint = _local_taint(fn.node, model.tainted_attrs)

    def check_calls(stmt, stack):
        for call in ast.walk(stmt):
            if not isinstance(call, ast.Call):
                continue
            cname = _call_name(call)
            extra = []
            if cname in _COLLECTIVE_NAMES:
                what = "collective %s()" % cname
            else:
                callee = model._resolve(cname, fn.cls) if cname else None
                if callee is None or callee.node is fn.node \
                        or not callee.collectives:
                    continue
                cline, ccall = callee.collectives[0]
                what = "%s(), which performs collective %s() at line %d" \
                    % (cname, ccall, cline)
                extra = ["%s() reaches %s() at line %d"
                         % (callee.qualname, ccall, cline)]
            prov = []
            for line, kind, reasons in stack:
                prov.append("%s at line %d is rank-varying: %s"
                            % (kind, line, reasons[0]))
            add("GL801", call.lineno, fn.qualname,
                "%s is control-dependent on rank-varying data (%s at "
                "line %d): ranks that branch differently skip or reorder "
                "the rendezvous and the rest deadlock in it"
                % (what, stack[-1][1], stack[-1][0]),
                fix_hint="hoist the collective out of the rank-varying "
                "branch, or make the branch rank-uniform first (agree on "
                "the value via the coordination KV / an allgather)",
                provenance=prov + extra)

    def visit(stmts, stack):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.If, ast.While)):
                reasons = _rank_reads(st.test, taint, model.tainted_attrs)
                entry = [(st.lineno, "branch condition", reasons)] \
                    if reasons else []
                visit(st.body, stack + entry)
                visit(st.orelse, stack + entry)
            elif isinstance(st, ast.For):
                reasons = _rank_reads(st.iter, taint, model.tainted_attrs)
                entry = [(st.lineno, "loop iterable", reasons)] \
                    if reasons else []
                visit(st.body, stack + entry)
                visit(st.orelse, stack + entry)
            elif isinstance(st, ast.Try):
                visit(st.body, stack)
                for h in st.handlers:
                    entry = [(h.lineno, "except handler",
                              ["which rank raises (and what) is "
                               "runtime-local"])]
                    visit(h.body, stack + entry)
                visit(st.orelse, stack)
                visit(st.finalbody, stack)
            elif isinstance(st, ast.With):
                visit(st.body, stack)
            else:
                if stack:
                    check_calls(st, stack)

    visit(fn.node.body, [])


# ---------------------------------------------- held-lock walking (3/4)

def _iter_held(stmts, held: frozenset, lock_of):
    """Yield ``(kind, node, held, acquired)`` for every statement with the
    lock set lexically held there. ``kind`` is ``"with"`` (acquired =
    locks its items take), else ``"stmt"``."""
    for st in stmts:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        if isinstance(st, ast.With):
            acquired = []
            for item in st.items:
                lid = lock_of(item.context_expr)
                if lid is not None:
                    acquired.append(lid)
            yield ("with", st, held, acquired)
            yield from _iter_held(st.body, held | frozenset(acquired),
                                  lock_of)
        elif isinstance(st, (ast.If, ast.While)):
            yield ("stmt", st.test, held, None)
            yield from _iter_held(st.body, held, lock_of)
            yield from _iter_held(st.orelse, held, lock_of)
        elif isinstance(st, ast.For):
            yield ("stmt", st.iter, held, None)
            yield from _iter_held(st.body, held, lock_of)
            yield from _iter_held(st.orelse, held, lock_of)
        elif isinstance(st, ast.Try):
            yield from _iter_held(st.body, held, lock_of)
            for h in st.handlers:
                yield from _iter_held(h.body, held, lock_of)
            yield from _iter_held(st.orelse, held, lock_of)
            yield from _iter_held(st.finalbody, held, lock_of)
        else:
            yield ("stmt", st, held, None)


def _fn_lock_facts(model: _Module, fn: _Fn):
    """(acquire_edges, call_sites, blocking_sites, mutation_sites,
    acquired_locks) for one function, from the lexical held-walk."""
    lock_of = lambda e: model.lock_id(e, fn.cls)  # noqa: E731
    edges = []       # (held_lock, acquired_lock, line)
    calls = []       # (bare_name, line, held)
    mutations = []   # (attr, line, held)
    acquired = set()
    for kind, node, held, got in _iter_held(fn.node.body, frozenset(),
                                            lock_of):
        if kind == "with":
            for lid in got:
                acquired.add(lid)
                for h in held:
                    if h != lid:
                        edges.append((h, lid, node.lineno))
            continue
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                cname = _call_name(n)
                if cname:
                    calls.append((cname, n, held))
            elif isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                val_ctor = _call_name(n.value) \
                    if isinstance(n.value, ast.Call) else None
                for t in targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    attr = _self_attr(base)
                    if attr is None:
                        continue
                    if val_ctor in _PRIMITIVE_CTORS:
                        continue
                    mutations.append((attr, n.lineno, held))
    return edges, calls, mutations, acquired


_LIFECYCLE = frozenset({"__init__", "__new__", "__del__", "__enter__",
                        "__exit__"})


def _lint_module(model: _Module, add):
    """GL802/GL803/GL804 need whole-module facts; GL801 is per-function."""
    facts = {}
    for fn in model.functions():
        facts[fn.qualname] = _fn_lock_facts(model, fn)
        _lint_gl801(model, fn, add)

    # -- held-set inheritance: two rounds of call-site intersection -------
    inherited: Dict[str, frozenset] = {q: frozenset() for q in facts}
    for _ in range(2):
        nxt = {}
        for fn in model.functions():
            sites = []
            for caller in model.functions():
                if caller.node is fn.node:
                    continue
                _e, calls, _m, _a = facts[caller.qualname]
                for cname, _node, held in calls:
                    target = model._resolve(cname, caller.cls)
                    if target is not None and target.node is fn.node:
                        sites.append(frozenset(held)
                                     | inherited[caller.qualname])
            if sites:
                common = sites[0]
                for s in sites[1:]:
                    common &= s
                nxt[fn.qualname] = common
            else:
                nxt[fn.qualname] = frozenset()
        inherited = nxt

    # -- GL803: cycles in the acquisition graph ---------------------------
    graph: Dict[tuple, Dict[tuple, Tuple[str, int]]] = {}

    def edge(a, b, fn, line):
        graph.setdefault(a, {}).setdefault(b, (fn, line))

    for fn in model.functions():
        edges, calls, _m, _a = facts[fn.qualname]
        base = inherited[fn.qualname]
        for h, lid, line in edges:
            edge(h, lid, fn.qualname, line)
        for h in base:
            for _hh, lid, line in edges:
                if lid != h:
                    edge(h, lid, fn.qualname, line)
        # one level: calling a method that acquires L while holding H
        for cname, node, held in calls:
            target = model._resolve(cname, fn.cls)
            if target is None or target.node is fn.node:
                continue
            _te, _tc, _tm_, tacq = facts[target.qualname]
            for h in frozenset(held) | base:
                for lid in tacq:
                    if lid != h:
                        edge(h, lid, fn.qualname, node.lineno)

    reported_pairs = set()
    for a in sorted(graph):
        for b in sorted(graph[a]):
            if a in graph.get(b, ()):
                pair = frozenset((a, b))
                if pair in reported_pairs:
                    continue
                reported_pairs.add(pair)
                fn_ab, line_ab = graph[a][b]
                fn_ba, line_ba = graph[b][a]
                fmt = lambda lid: ("%s.%s" % lid if lid[0]  # noqa: E731
                                   else lid[1])
                add("GL803", max(line_ab, line_ba),
                    fn_ab if line_ab >= line_ba else fn_ba,
                    "lock-order inversion: %s acquired before %s (line %d "
                    "in %s) but %s before %s (line %d in %s) — two threads "
                    "taking the paths concurrently deadlock"
                    % (fmt(a), fmt(b), line_ab, fn_ab,
                       fmt(b), fmt(a), line_ba, fn_ba),
                    fix_hint="pick one global order for these locks and "
                    "re-nest the laggard path (or collapse to one lock)",
                    provenance=["%s -> %s at %s:%d" % (fmt(a), fmt(b),
                                                       fn_ab, line_ab),
                                "%s -> %s at %s:%d" % (fmt(b), fmt(a),
                                                       fn_ba, line_ba)])

    # -- GL804: blocking with a lock held ---------------------------------
    for fn in model.functions():
        _e, calls, _m, _a = facts[fn.qualname]
        base = inherited[fn.qualname]
        for cname, node, held in calls:
            eff = frozenset(held) | base
            if not eff:
                continue
            blocking = None
            if cname in _COLLECTIVE_NAMES:
                blocking = "collective %s()" % cname
            elif cname == "blocking_key_value_get":
                blocking = "coordination-service RPC %s()" % cname
            elif cname in _BLOCKING_ZERO_ARG and not node.args \
                    and not node.keywords:
                recv = node.func.value \
                    if isinstance(node.func, ast.Attribute) else None
                rattr = _self_attr(recv) if recv is not None else None
                if cname == "wait" and rattr is not None and fn.cls:
                    locks = model.class_locks.get(fn.cls, {})
                    canon = locks.get(rattr)
                    if canon is not None and (fn.cls, canon) in eff:
                        continue  # cond.wait() releases the held lock
                if isinstance(recv, ast.Name) and recv.id == "self" and \
                        model._resolve(cname, fn.cls) is not None:
                    continue  # self.wait() etc is a method call, not a
                    # primitive wait — the callee's own sites are linted
                blocking = "timeout-less %s()" % cname
            elif cname == "call" and isinstance(node.func, ast.Attribute):
                parts = []
                cur = node.func.value
                while isinstance(cur, ast.Attribute):
                    parts.append(cur.attr.lower())
                    cur = cur.value
                if isinstance(cur, ast.Name):
                    parts.append(cur.id.lower())
                if any(h in p for p in parts for h in _RPC_HINTS):
                    blocking = "RPC %s()" % ast.unparse(node.func)
            if blocking is None:
                continue
            fmt = lambda lid: ("%s.%s" % lid if lid[0]  # noqa: E731
                               else lid[1])
            add("GL804", node.lineno, fn.qualname,
                "%s reached while holding %s: every other thread needing "
                "the lock stalls behind an unbounded wait"
                % (blocking, ", ".join(sorted(fmt(h) for h in eff))),
                fix_hint="move the blocking call outside the lock, or "
                "bound it with a timeout/deadline knob and handle expiry",
                provenance=["lock(s) held here: %s"
                            % ", ".join(sorted(fmt(h) for h in eff))])

    # -- GL802: shared attributes without a common lock -------------------
    ctx = model.contexts()
    by_attr: Dict[tuple, List[tuple]] = {}
    for fn in model.functions():
        if fn.cls is None or fn.name in _LIFECYCLE:
            continue
        _e, _c, mutations, _a = facts[fn.qualname]
        base = inherited[fn.qualname]
        for attr, line, held in mutations:
            locks = model.class_locks.get(fn.cls, {})
            if attr in locks or attr in set(locks.values()):
                continue
            by_attr.setdefault((fn.cls, attr), []).append(
                (line, fn, frozenset(held) | base))
    for (cls, attr), sites in sorted(by_attr.items()):
        union_ctx: Set[str] = set()
        per_site = []
        for line, fn, eff in sites:
            fctx = ctx.get(fn.qualname, set())
            if not fctx:
                continue  # unreachable from any entry/API: not shared
            union_ctx |= fctx
            per_site.append((line, fn, eff, fctx))
        if len(union_ctx) < 2 or \
                not any(c.startswith("thread:") for c in union_ctx):
            continue
        common = per_site[0][2]
        for _l, _f, eff, _c2 in per_site[1:]:
            common &= eff
        if common:
            continue
        fmt = lambda lid: ("%s.%s" % lid if lid[0] else lid[1])  # noqa: E731
        per_site.sort(key=lambda s: s[0])
        worst = next((s for s in per_site if not s[2]), per_site[0])
        add("GL802", worst[0], worst[1].qualname,
            "self.%s is mutated from %d contexts (%s) with no common lock "
            "on every mutating path" % (attr, len(union_ctx),
                                        ", ".join(sorted(union_ctx))),
            fix_hint="guard every mutating path with one named lock "
            "(telemetry.named_lock) or confine the attribute to a single "
            "thread",
            provenance=["line %d in %s holds {%s}; reachable from %s"
                        % (line, fn.qualname,
                           ", ".join(sorted(fmt(h) for h in eff)) or "-",
                           ", ".join(sorted(fctx)))
                        for line, fn, eff, fctx in per_site[:6]])


# ------------------------------------------------------------ public API

def lint_concurrency_source(path: str, text: Optional[str] = None
                            ) -> List[_Finding]:
    """Static GL801-GL804 over one Python source file."""
    if text is None:
        with open(path) as f:
            text = f.read()
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as exc:
        return [_Finding("GL804", path, exc.lineno or 1, "<module>",
                         "unparseable source: %s" % exc, waived=False)]
    waivers = _load_waivers(text)
    model = _Module(path, tree)
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

    _lint_module(model, add)
    findings.sort(key=lambda f: (f.line, f.code))
    return findings


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
            raise OSError("concurrency-lint path does not exist: %s" % p)


def lint_concurrency_paths(paths=None, root: Optional[str] = None
                           ) -> Tuple[Report, List[dict]]:
    """Run the static concurrency lint over ``paths`` (files or
    directories; default ``DEFAULT_SCAN_PATHS`` resolved against ``root``
    or the repo checkout this package sits in).

    Returns ``(Report, site rows)``; waived findings are severity-info in
    the report (they never fail a run) and ``"waived": true`` in rows."""
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    if paths is None:
        paths = [os.path.join(root, p) for p in DEFAULT_SCAN_PATHS]
        paths = [p for p in paths if os.path.exists(p)]
    report = Report(target="concurrency")
    sites: List[dict] = []
    for path in _iter_py_files(paths):
        rel = os.path.relpath(path, root) if os.path.isabs(path) else path
        for f in lint_concurrency_source(path):
            f.path = rel
            report.add(f.to_diagnostic())
            sites.append(f.to_dict())
    return report, sites


# ----------------------------------------------------- measured: GL805

def lint_lock_witness(witness: Optional[dict]) -> List[Diagnostic]:
    """GL805 over a ``telemetry.lockwitness.witness_report()`` dict (or
    the ``otherData.lock_witness`` block of a chrome dump): one finding
    per witnessed inversion, one per >threshold hold that crossed a
    dispatch seam. Long holds that never crossed a seam stay in the
    contention table but are not findings — holding a lock through host
    work is legal; holding it across device dispatch serializes the
    pipeline."""
    diags: List[Diagnostic] = []
    if not witness:
        return diags
    for ev in witness.get("events", ()):
        kind = ev.get("kind")
        if kind == "inversion":
            diags.append(Diagnostic(
                "GL805",
                "witnessed lock-order inversion: thread %r acquired %r "
                "then %r after the reverse order (%s) was taken %d "
                "time(s) — a concurrent interleaving of the two paths "
                "deadlocks"
                % (ev.get("thread"), ev.get("first"), ev.get("then"),
                   ev.get("prior_order"), ev.get("prior_count", 1)),
                node="%s<->%s" % (ev.get("first"), ev.get("then")),
                fix_hint="pick one global acquisition order for these "
                "locks (see the static GL803 sites for the paths)",
                pass_name="concurrency_lint"))
        elif kind == "long_hold" and ev.get("dispatch_seam"):
            diags.append(Diagnostic(
                "GL805",
                "witnessed long hold: %r held %.1f ms (threshold %.0f ms) "
                "across a dispatch seam on thread %r — the lock sat "
                "across device-dispatch work, stalling every contender"
                % (ev.get("lock"), ev.get("hold_ms", 0.0),
                   ev.get("threshold_ms", 0.0), ev.get("thread")),
                node=ev.get("lock"),
                fix_hint="shrink the critical section: snapshot under the "
                "lock, dispatch outside it",
                pass_name="concurrency_lint"))
    return diags


@graph_pass("concurrency_lint")
def concurrency_lint_pass(ctx):
    """Bind-time face of the family: when the process is witnessing
    (``MXNET_CONCLINT=witness``), surface any GL805 the witness has
    recorded so far. The static GL801-804 checks are source-level and run
    through ``graphlint --concurrency`` / the CI repo gate instead."""
    from ..telemetry import lockwitness

    if not lockwitness.witnessing():
        return []
    return lint_lock_witness(lockwitness.witness_report())
