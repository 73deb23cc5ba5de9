# copied from mxnet_tpu/telemetry/lockwitness.py (backend-free)
"""Lock witness — the measured side of the GL8xx concurrency analyzer.

The static lint (``analysis/concurrency_lint.py``) proves what it can
about lock discipline from the AST; this module witnesses what actually
happens. Under ``MXNET_CONCLINT=witness`` the repo's named-lock
construction sites (``named_lock``/``named_rlock``/``named_condition`` in
the serving engine, the fleet router/supervisor/replica, the executable
cache and the checkpoint writer) return instrumented wrappers that
record, per thread, the order locks are acquired in and how long they are
held:

  * a real lock-order inversion — some thread acquires X then Y after any
    thread acquired Y then X — is recorded as an ``inversion`` event the
    moment the reversed edge appears in the global acquisition graph;
  * a hold longer than ``MXNET_CONCLINT_HOLD_MS`` (default 50) is a
    ``long_hold`` event, flagged ``dispatch_seam`` when ``note_dispatch``
    ticked while the lock was held — the lock sat across device-dispatch
    work, the exact shape that serializes the batcher behind a collective
    or a compile;
  * every lock keeps acquisition/contention/wait/hold statistics for the
    mxtrace contention table (``otherData.lock_witness`` in chrome dumps,
    rendered by ``tools/mxtrace``).

``analysis.concurrency_lint.lint_lock_witness`` turns the event list into
GL805 diagnostics; the bind-time pass suite and ``graphlint --concurrency
--witness dump.json`` both consume ``witness_report()``.

Off (the default) the factories return PLAIN ``threading`` primitives, so
an unarmed run pays one env read per lock *construction* and nothing per
acquire. ``set_mode()`` overrides the env for tests. The wrappers define
the private ``Condition`` hooks (``_is_owned``/``_release_save``/
``_acquire_restore``) so ``threading.Condition(witness_lock)`` releases
end the hold measurement exactly like a plain release.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["named_lock", "named_rlock", "named_condition", "note_dispatch",
           "witnessing", "set_mode", "current_override", "witness_report",
           "reset_witness", "hold_threshold_ms"]

MODE_OFF, MODE_WITNESS = 0, 1
_MODE_NAMES = {"": MODE_OFF, "0": MODE_OFF, "off": MODE_OFF,
               "false": MODE_OFF,
               "witness": MODE_WITNESS, "1": MODE_WITNESS,
               "on": MODE_WITNESS, "true": MODE_WITNESS}

_override = None
_warned = set()

# all witness bookkeeping below is guarded by this one registry lock —
# deliberately a bare threading.Lock, never a witness wrapper (the witness
# must not witness itself)
_reg_lock = threading.Lock()
_stats: dict = {}                 # lock name -> stats dict
_edges: dict = {}                 # (first, then) -> {"count", "threads"}
_events: list = []                # bounded inversion/long_hold events
_events_dropped = [0]
_MAX_EVENTS = 512
_dispatch_epoch = [0]
_inversions_seen: set = set()     # frozenset({a, b}) pairs already evented
_tls = threading.local()


def _env_mode() -> int:
    raw = os.environ.get("MXNET_CONCLINT", "").strip().lower()
    m = _MODE_NAMES.get(raw)
    if m is None:
        if raw not in _warned:
            _warned.add(raw)
            import logging

            logging.getLogger("mxnet_tpu_torch").warning(
                "MXNET_CONCLINT=%r is not a recognized mode (0|witness); "
                "the lock witness stays OFF", raw)
        return MODE_OFF
    return m


def mode() -> int:
    """The active mode. Reads the env on every call (like
    telemetry.spans.mode) so tests and subprocesses can flip it live."""
    return _override if _override is not None else _env_mode()


def witnessing() -> bool:
    return mode() >= MODE_WITNESS


def set_mode(m):
    """Override the env gate: ``"0"``/``"witness"`` (or the int
    constants), ``None`` to fall back to MXNET_CONCLINT."""
    global _override
    if m is None:
        _override = None
        return
    if isinstance(m, str):
        if m.strip().lower() not in _MODE_NAMES:
            raise ValueError("unknown conclint mode %r" % m)
        m = _MODE_NAMES[m.strip().lower()]
    if m not in (MODE_OFF, MODE_WITNESS):
        raise ValueError("unknown conclint mode %r" % m)
    _override = m


def current_override():
    return _override


def hold_threshold_ms(default: float = 50.0) -> float:
    """GL805 long-hold threshold (``MXNET_CONCLINT_HOLD_MS``, default 50):
    a hold longer than this across a dispatch seam is witness-reported."""
    raw = os.environ.get("MXNET_CONCLINT_HOLD_MS", "").strip()
    if not raw:
        return default
    try:
        val = float(raw)
        if val <= 0:
            raise ValueError
        return val
    except ValueError:
        if raw not in _warned:
            _warned.add(raw)
            import logging

            logging.getLogger("mxnet_tpu_torch").warning(
                "MXNET_CONCLINT_HOLD_MS=%r is not a positive number; "
                "using %.0f", raw, default)
        return default


def note_dispatch():
    """Tick the dispatch-seam epoch. The serving engine calls this once
    per executable dispatch; a lock whose hold spans a tick was held
    across device work. Unconditional integer bump — cheaper than the
    mode check it would otherwise hide behind."""
    _dispatch_epoch[0] += 1


def _held() -> list:
    """This thread's stack of held witness locks:
    ``[lock, name, t_acquired, epoch_at_acquire, reentrant]`` entries."""
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _stat(name: str) -> dict:
    """Per-lock stats row; caller holds ``_reg_lock``."""
    st = _stats.get(name)
    if st is None:
        st = _stats[name] = {"acquisitions": 0, "contentions": 0,
                             "wait_s": 0.0, "hold_s": 0.0, "max_hold_s": 0.0,
                             "long_holds": 0, "threads": {}}
    return st


def _append_event(ev: dict):
    """Bounded event append; caller holds ``_reg_lock``."""
    if len(_events) >= _MAX_EVENTS:
        _events_dropped[0] += 1
        return
    _events.append(ev)


class _WitnessLock:
    """``threading.Lock`` wrapper recording order edges, waits and holds."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._lock = self._make()
        with _reg_lock:
            _stat(name)

    def _make(self):
        return threading.Lock()

    # ------------------------------------------------------------ acquire
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if self._reentrant and any(e[0] is self for e in held):
            # recursion level: no edges, no contention — the outer
            # acquisition owns the hold window
            got = self._lock.acquire(blocking, timeout)
            if got:
                held.append([self, self.name, time.perf_counter(),
                             _dispatch_epoch[0], True])
            return got
        t0 = time.perf_counter()
        got = self._lock.acquire(False)
        contended = not got
        if not got:
            if not blocking:
                return False
            got = self._lock.acquire(True, timeout)
            if not got:
                # timed out: the contention (and the fruitless wait) still
                # happened — the table must show it
                with _reg_lock:
                    st = _stat(self.name)
                    st["contentions"] += 1
                    st["wait_s"] += time.perf_counter() - t0
                return False
        t1 = time.perf_counter()
        self._note_acquired(held, t1, t1 - t0 if contended else 0.0,
                            contended)
        return True

    def _note_acquired(self, held, t_now, wait_s, contended):
        tname = threading.current_thread().name
        with _reg_lock:
            st = _stat(self.name)
            st["acquisitions"] += 1
            if contended:
                st["contentions"] += 1
                st["wait_s"] += wait_s
            st["threads"][tname] = st["threads"].get(tname, 0) + 1
            for entry in held:
                if entry[4] or entry[1] == self.name:
                    continue
                edge = (entry[1], self.name)
                row = _edges.get(edge)
                if row is None:
                    row = _edges[edge] = {"count": 0, "threads": set()}
                row["count"] += 1
                if len(row["threads"]) < 4:
                    row["threads"].add(tname)
                rev = (self.name, entry[1])
                if rev in _edges:
                    pair = frozenset(edge)
                    if pair not in _inversions_seen:
                        _inversions_seen.add(pair)
                        _append_event({
                            "kind": "inversion",
                            "first": entry[1], "then": self.name,
                            "thread": tname,
                            "prior_order": "%s -> %s" % rev,
                            "prior_count": _edges[rev]["count"]})
        held.append([self, self.name, t_now, _dispatch_epoch[0], False])

    # ------------------------------------------------------------ release
    def release(self):
        held = _held()
        entry = None
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                entry = held.pop(i)
                break
        if entry is not None and not entry[4]:
            hold = time.perf_counter() - entry[2]
            seam = _dispatch_epoch[0] != entry[3]
            thr = hold_threshold_ms() / 1e3
            with _reg_lock:
                st = _stat(self.name)
                st["hold_s"] += hold
                if hold > st["max_hold_s"]:
                    st["max_hold_s"] = hold
                if hold > thr:
                    st["long_holds"] += 1
                    _append_event({
                        "kind": "long_hold", "lock": self.name,
                        "hold_ms": hold * 1e3,
                        "threshold_ms": thr * 1e3,
                        "thread": threading.current_thread().name,
                        "dispatch_seam": seam})
        self._lock.release()

    # ------------------------------------------------- context / Condition
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        probe = getattr(self._lock, "locked", None)
        return probe() if probe is not None else self._is_owned()

    def _is_owned(self) -> bool:
        # Condition's ownership probe: answer from the thread-local stack
        # instead of the default try-acquire probe (which would show up as
        # a phantom acquisition in the stats)
        return any(e[0] is self for e in _held())

    def _release_save(self):
        self.release()
        return 1

    def _acquire_restore(self, state):
        self.acquire()

    def __repr__(self):
        return "<%s %r>" % (type(self).__name__, self.name)


class _WitnessRLock(_WitnessLock):
    """``threading.RLock`` wrapper: recursion levels piggyback on the
    outer acquisition's hold window."""

    _reentrant = True

    def _make(self):
        return threading.RLock()

    def _release_save(self):
        n = 0
        while any(e[0] is self for e in _held()):
            self.release()
            n += 1
        return n

    def _acquire_restore(self, state):
        for _ in range(max(1, state)):
            self.acquire()


# ------------------------------------------------------------- factories

def named_lock(name: str):
    """A named mutex: plain ``threading.Lock`` unless witnessing."""
    if not witnessing():
        return threading.Lock()
    return _WitnessLock(name)


def named_rlock(name: str):
    """A named reentrant mutex: plain ``threading.RLock`` unless
    witnessing."""
    if not witnessing():
        return threading.RLock()
    return _WitnessRLock(name)


def named_condition(name: str, lock=None):
    """A named condition variable. ``lock=None`` gets its own (witnessed)
    lock; passing an existing lock aliases the condition to it — same
    semantics as ``threading.Condition(lock)``."""
    if not witnessing():
        return threading.Condition(lock)
    if lock is None:
        lock = _WitnessLock(name)
    return threading.Condition(lock)


# --------------------------------------------------------------- reports

def witness_report() -> dict:
    """Everything the witness recorded: per-lock stats rows, the
    acquisition-order edge list, and the inversion/long-hold events.
    ``analysis.concurrency_lint.lint_lock_witness`` maps it to GL805;
    ``telemetry.trace.build_trace`` embeds it in chrome dumps for
    mxtrace's contention table."""
    with _reg_lock:
        locks = []
        for name in sorted(_stats):
            st = _stats[name]
            locks.append({
                "name": name,
                "acquisitions": st["acquisitions"],
                "contentions": st["contentions"],
                "wait_ms": round(st["wait_s"] * 1e3, 3),
                "hold_ms": round(st["hold_s"] * 1e3, 3),
                "max_hold_ms": round(st["max_hold_s"] * 1e3, 3),
                "long_holds": st["long_holds"],
                "threads": dict(st["threads"])})
        edges = [{"first": a, "then": b, "count": row["count"],
                  "threads": sorted(row["threads"])}
                 for (a, b), row in sorted(_edges.items())]
        events = [dict(ev) for ev in _events]
        dropped = _events_dropped[0]
    return {"enabled": witnessing(),
            "threshold_ms": hold_threshold_ms(),
            "dispatch_epochs": _dispatch_epoch[0],
            "locks": locks, "edges": edges, "events": events,
            "events_dropped": dropped}


def reset_witness():
    """Drop all recorded stats/edges/events (tests, capture windows).
    Locks currently held keep working: release() re-creates stats rows on
    demand."""
    with _reg_lock:
        _stats.clear()
        _edges.clear()
        del _events[:]
        _events_dropped[0] = 0
        _inversions_seen.clear()
