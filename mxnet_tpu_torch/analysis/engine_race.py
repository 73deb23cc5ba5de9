"""Engine race analysis (GL101–GL105).

Copied from ``mxnet_tpu/analysis/engine_race.py`` (backend-free), over the
port's ``engine.Engine``. The engine's correctness contract is entirely in
the ``const_vars`` / ``mutable_vars`` sets callers pass to ``engine.push``
(reference: include/mxnet/engine.h Push) — nothing checks that callers
declare them honestly or coherently. Two layers of defense:

* **Static schedule analysis** — ``RecordingEngine`` wraps any engine and
  records every ``new_variable`` / ``push`` / ``wait_for_var`` with the
  caller's file:line. ``analyze_trace`` then flags declaration hazards:

    GL101  a var in both const_vars and mutable_vars of one push (the
           reference's CheckDuplicate rejects this outright; our engines
           resolve it as a write, which readers of the code won't expect)
    GL102  wait_for_var on a var no push in the whole trace ever writes
    GL103  the same var twice in one push's mutable_vars (a write-write
           declared inside a single op)
    GL104  a const read with no preceding write — either never written
           (reads an uninitialized slot) or first written by a LATER push
           (the read does NOT wait for that write: unordered read-write)

* **Runtime assertion shim** (``assert_discipline=True``) — each pushed fn
  is bracketed with entry/exit bookkeeping that checks the var discipline
  the moment the op actually runs: no two writers overlap on a var, no
  reader overlaps a writer. A violation is recorded (GL105) and also raised
  into the engine's error channel. The shim wraps the callable, so it
  holds over all three of the port's engines: the native
  ``ThreadedEngine``, its pure-Python ``_PythonThreadedEngine`` and
  ``NaiveEngine``. Installed as the process engine (``engine._engine``),
  it judges the engine-queued checkpoint writes of ``model.save_checkpoint``.
"""
from __future__ import annotations

import threading
import traceback

from ..base import MXNetError
from ..engine import Engine
from .diagnostics import Diagnostic, Report

__all__ = ["PushRecord", "ScheduleTrace", "RecordingEngine", "analyze_trace"]


def _caller_site():
    """file:line of the frame that called into the engine facade."""
    for frame in reversed(traceback.extract_stack(limit=8)[:-2]):
        fname = frame.filename
        if "analysis/engine_race" not in fname.replace("\\", "/"):
            return "%s:%d" % (fname, frame.lineno)
    return "<unknown>"


class PushRecord:
    __slots__ = ("seq", "const_vars", "mutable_vars", "where")

    def __init__(self, seq, const_vars, mutable_vars, where):
        self.seq = seq
        self.const_vars = tuple(const_vars)
        self.mutable_vars = tuple(mutable_vars)
        self.where = where

    def __repr__(self):
        return ("<push #%d const=%s mutable=%s @ %s>"
                % (self.seq, list(self.const_vars), list(self.mutable_vars),
                   self.where))


class ScheduleTrace:
    """Everything observed through one RecordingEngine."""

    def __init__(self):
        self.created = []          # var ids from new_variable, in order
        self.pushes = []           # PushRecord, in push order
        self.waits = []            # (seq, var, where)
        self.violations = []       # runtime shim findings (strings)
        self._seq = 0
        self._lock = threading.Lock()

    def next_seq(self):
        with self._lock:
            self._seq += 1
            return self._seq


class RecordingEngine(Engine):
    """Engine proxy: records the schedule; optionally asserts the var
    discipline at op execution time (the pure-Python-backend shim)."""

    def __init__(self, inner: Engine, assert_discipline: bool = False):
        self.inner = inner
        self.trace = ScheduleTrace()
        self.assert_discipline = assert_discipline
        self._run_lock = threading.Lock()
        self._running_readers = {}   # var -> count
        self._running_writers = {}   # var -> count (should never exceed 1)

    # ------------------------------------------------------------ facade
    def new_variable(self):
        v = self.inner.new_variable()
        self.trace.created.append(v)
        return v

    def push(self, fn, const_vars=(), mutable_vars=()):
        rec = PushRecord(self.trace.next_seq(), const_vars, mutable_vars,
                         _caller_site())
        self.trace.pushes.append(rec)
        if self.assert_discipline:
            fn = self._shimmed(fn, rec)
        return self.inner.push(fn, const_vars=const_vars,
                               mutable_vars=mutable_vars)

    def wait_for_var(self, var):
        self.trace.waits.append((self.trace.next_seq(), var, _caller_site()))
        return self.inner.wait_for_var(var)

    def wait_for_all(self):
        return self.inner.wait_for_all()

    # -------------------------------------------------------------- shim
    def _shimmed(self, fn, rec: PushRecord):
        # overlap of declared sets within one push is resolved write-wins,
        # matching the engines' own dedup
        muts = tuple(dict.fromkeys(rec.mutable_vars))
        consts = tuple(v for v in dict.fromkeys(rec.const_vars)
                       if v not in muts)

        def run():
            bad = []
            with self._run_lock:
                for v in muts:
                    if self._running_writers.get(v):
                        bad.append("write-write overlap on var %r" % v)
                    if self._running_readers.get(v):
                        bad.append("write overlaps %d running reader(s) on "
                                   "var %r" % (self._running_readers[v], v))
                for v in consts:
                    if self._running_writers.get(v):
                        bad.append("read overlaps a running writer on var %r"
                                   % v)
                for v in muts:
                    self._running_writers[v] = self._running_writers.get(v, 0) + 1
                for v in consts:
                    self._running_readers[v] = self._running_readers.get(v, 0) + 1
                if bad:
                    self.trace.violations.extend(
                        "%s (push #%d from %s)" % (b, rec.seq, rec.where)
                        for b in bad)
            try:
                if bad:
                    raise MXNetError(
                        "engine discipline violated: %s" % "; ".join(bad))
                return fn()
            finally:
                with self._run_lock:
                    for v in muts:
                        self._running_writers[v] -= 1
                    for v in consts:
                        self._running_readers[v] -= 1

        return run


def analyze_trace(trace: ScheduleTrace, target: str = "engine-schedule") -> Report:
    """Static hazard analysis over a recorded schedule."""
    report = Report(target=target)
    first_write = {}   # var -> seq of first push that mutates it
    for rec in trace.pushes:
        for v in rec.mutable_vars:
            first_write.setdefault(v, rec.seq)

    for rec in trace.pushes:
        overlap = sorted(set(rec.const_vars) & set(rec.mutable_vars))
        if overlap:
            report.add(Diagnostic(
                "GL101",
                "push #%d declares var(s) %s as BOTH const and mutable; the "
                "engine resolves this as a write, serializing what the "
                "const_vars entry promises can run concurrently"
                % (rec.seq, overlap),
                node=rec.where, pass_name="engine_race",
                fix_hint="declare each var exactly once: mutable if the op "
                         "writes it, const otherwise",
            ))
        dups = sorted({v for v in rec.mutable_vars
                       if rec.mutable_vars.count(v) > 1})
        if dups:
            report.add(Diagnostic(
                "GL103",
                "push #%d lists var(s) %s more than once in mutable_vars — a "
                "write-write hazard declared within a single op"
                % (rec.seq, dups),
                node=rec.where, pass_name="engine_race",
                fix_hint="deduplicate the mutable_vars list at the call site",
            ))
        for v in dict.fromkeys(rec.const_vars):
            if v in rec.mutable_vars:
                continue  # GL101 already covers the overlap
            fw = first_write.get(v)
            if fw is None:
                report.add(Diagnostic(
                    "GL104",
                    "push #%d reads var %r which NO push in this schedule "
                    "ever writes — the read is ordered against nothing and "
                    "sees whatever the initial state is" % (rec.seq, v),
                    node=rec.where, pass_name="engine_race",
                    fix_hint="either drop the var from const_vars or add the "
                             "producing push",
                ))
            elif fw > rec.seq:
                report.add(Diagnostic(
                    "GL104",
                    "push #%d reads var %r whose FIRST write is pushed later "
                    "(push #%d): the read does not wait for that write — "
                    "unordered read-write" % (rec.seq, v, fw),
                    node=rec.where, pass_name="engine_race",
                    fix_hint="push the writer before the reader; engine "
                             "ordering is push order, per var",
                ))

    written = set(first_write)
    for seq, var, where in trace.waits:
        if var not in written:
            report.add(Diagnostic(
                "GL102",
                "wait_for_var(%r) at seq %d, but no push in this schedule "
                "writes that var — the wait can only drain pending READERS "
                "of it; if this wait was meant to order against produced "
                "data, the producing push is missing (and on a var the "
                "engine never issued, wait_for_var raises)" % (var, seq),
                node=where, pass_name="engine_race",
                fix_hint="if the wait exists to drain readers, it is "
                         "working as intended and this finding can be "
                         "ignored; otherwise add (or wait on) the push that "
                         "actually mutates the var",
            ))

    for v in trace.violations:
        report.add(Diagnostic(
            "GL105",
            "runtime discipline violation: %s" % v,
            pass_name="engine_race",
            fix_hint="the engine executed ops concurrently that its var "
                     "declarations forbid — this is an engine bug, not a "
                     "caller bug",
        ))
    return report
