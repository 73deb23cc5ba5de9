# copied from mxnet_tpu/faultinject.py (backend-free)
"""Deterministic, seeded fault injection (docs/RESILIENCE.md).

Every recovery path this repo has grown — serving dispatch retry, the
checkpoint writer's transient-I/O retry, elastic re-form, the prefetcher
wedge latch — used to be exercisable only by hand-rolled chaos scripts
(sleeps, kills, monkeypatched file systems). This module makes faults a
first-class, *reproducible* input: named injection sites sit at the
existing seams, each site evaluates a seeded plan, and the same seed
replays the same injected-event sequence — the determinism argument the
PyGraph / cross-replica-sharding line of work (PAPERS.md) makes for the
happy path applies to the failure path too.

Configuration — ``MXNET_FAULTINJECT`` is a comma-separated list of plans::

    MXNET_FAULTINJECT="serving.dispatch:raise:0.1:42,io.prefetch:delay_ms:0.5:7:20"

each ``site:kind:prob:seed[:arg]`` meaning: at ``site``, with probability
``prob`` per evaluation (drawn from a dedicated ``random.Random(seed)``
stream, so the fire/skip sequence is a pure function of the seed and the
call order), perform ``kind``:

================  ============================================================
``raise``         raise ``FaultInjected`` (an ``MXNetError``); ``arg`` may name
                  an errno (``EIO``/``ENOSPC``/``EAGAIN``/...) to raise a real
                  ``OSError`` instead — exercises OS-error recovery paths
``delay_ms``      sleep ``arg`` milliseconds (default 10) — latency faults
``hang``          sleep ``arg`` *seconds* (default 60) — a wedged dependency
``torn_write``    at byte-writing sites only: the write persists just a prefix
                  (fraction ``arg`` of the bytes, default 0.5) and raises
                  ``OSError(EIO)`` — a crash/ENOSPC mid-write
================  ============================================================

Tests use the scoped context-manager API instead of the env::

    with faultinject.inject("serving.dispatch", "raise", prob=1.0, seed=3,
                            times=1):
        ...   # exactly one dispatch fails, deterministically

Zero overhead when unset (the telemetry ``NULL_SPAN`` discipline):
``fire()``'s fast path is one env-membership check plus one empty-dict
check — no plan objects, no RNG, no allocation. The env is re-read every
check so subprocesses and tests can flip it live; parsing is cached on the
raw string.

Telemetry: every fired event counts into an internal table (``stats()``,
available even with telemetry off) and, when telemetry is enabled, into
``faultinject.fired`` plus a ``faultinject.<site>.<kind>`` counter per
site/kind (docs/OBSERVABILITY.md).

Sites are just strings; the ones wired today are listed in ``SITES`` (and
docs/RESILIENCE.md). Firing an unknown site is legal — new seams only need
a ``faultinject.fire("my.site")`` call.
"""
from __future__ import annotations

import errno as _errno
import logging
import os
import random
import threading
import time

from .base import MXNetError
from . import telemetry as _tm

__all__ = ["FaultInjected", "fire", "torn_fraction", "inject", "refresh",
           "stats", "reset_stats", "SITES", "KINDS", "ENV_FAULTINJECT"]

log = logging.getLogger("mxnet_tpu_torch.faultinject")

ENV_FAULTINJECT = "MXNET_FAULTINJECT"

KINDS = ("raise", "delay_ms", "hang", "torn_write")

#: the reference's seams (site -> where it fires); informational — see
#: docs/RESILIENCE.md for the per-site failure semantics. The port wires
#: the three ``serving.*`` sites (``serving/engine.py``) and the three
#: ``fleet.*`` sites (``serving/fleet/router.py``, ``supervisor.py``).
SITES = {
    "serving.submit": "InferenceEngine.submit entry (request admission)",
    "serving.dispatch": "InferenceEngine._dispatch, before the executable "
                        "runs (the retry-covered window)",
    "serving.batcher": "top of the batcher loop, outside the per-batch "
                       "recovery (a fire here latches the engine)",
    "checkpoint.write": "checkpoint.atomic_write_bytes (torn_write "
                        "supported; covered by the writer retry)",
    "dist.heartbeat": "the heartbeat thread's beat (a raise skips one "
                      "beat; delay/hang make the file go stale)",
    "dist.collective": "_Collective.make_global_rows — every kvstore "
                       "allreduce/reduce-scatter passes through it",
    "io.prefetch": "PrefetchingIter._pump, before child.next() (a raise "
                   "surfaces to the consumer as the epoch's error)",
    "fleet.dispatch": "Router dispatch worker, before the replica RPC "
                      "(the re-dispatch-covered window; a raise exercises "
                      "redispatch-to-another-replica)",
    "fleet.health": "Router health poll, before the replica's health RPC "
                    "(a raise/hang makes that replica's snapshot go stale "
                    "— the router must stop dispatching on it)",
    "fleet.replica_spawn": "ReplicaSupervisor._spawn, before the process "
                           "launch (a raise fails the spawn; the capped "
                           "restart backoff retries it)",
}


class FaultInjected(MXNetError):
    """An injected fault (kind=``raise``). Carries ``site`` and ``kind`` so
    recovery code and tests can tell injected faults from organic ones."""

    def __init__(self, site, kind="raise"):
        super().__init__(
            "faultinject: injected %s at site %r (%s=...)"
            % (kind, site, ENV_FAULTINJECT))
        self.site = site
        self.kind = kind


class _Plan:
    """One site's seeded decision stream. ``roll()`` draws exactly one
    uniform per evaluation (until the optional ``times`` cap is reached),
    so the fire/skip sequence is deterministic in (seed, call order)."""

    __slots__ = ("site", "kind", "prob", "seed", "arg", "times",
                 "fired", "calls", "_rng", "_lock")

    def __init__(self, site, kind, prob, seed, arg=None, times=None):
        if kind not in KINDS:
            raise MXNetError("faultinject: unknown kind %r (one of %s)"
                             % (kind, "/".join(KINDS)))
        self.site = site
        self.kind = kind
        self.prob = float(prob)
        self.seed = int(seed)
        self.arg = arg
        self.times = times
        self.fired = 0
        self.calls = 0
        self._rng = random.Random(int(seed))
        self._lock = threading.Lock()

    def roll(self):
        with self._lock:
            if self.times is not None and self.fired >= self.times:
                return False
            self.calls += 1
            if self._rng.random() >= self.prob:
                return False
            self.fired += 1
            return True


def _parse(raw):
    """Parse the env value into {site: [plan, ...]}. Malformed entries are
    skipped with one warning — a bad knob must degrade, not kill import."""
    plans = {}
    if not raw:
        return plans
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        try:
            if len(parts) < 4 or len(parts) > 5:
                raise ValueError("need site:kind:prob:seed[:arg]")
            site, kind, prob, seed = parts[0], parts[1], float(parts[2]), \
                int(parts[3])
            if not 0.0 <= prob <= 1.0:
                raise ValueError("prob %r outside [0, 1]" % prob)
            arg = parts[4] if len(parts) == 5 else None
            plans.setdefault(site, []).append(
                _Plan(site, kind, prob, seed, arg=arg))
        except (ValueError, MXNetError) as exc:
            log.warning("%s entry %r ignored (%s)", ENV_FAULTINJECT,
                        entry, exc)
    return plans


_lock = threading.Lock()
_env_cache = (None, {})   # (raw env string, parsed {site: [plans]})
_ctx_plans = {}           # inject() overlays; replaced wholesale (COW)
_counts = {}              # "site:kind" -> fired count; survives refresh()


def _env_plans(site):
    global _env_cache
    raw = os.environ.get(ENV_FAULTINJECT) or None
    cached_raw, cached = _env_cache
    if raw != cached_raw:
        with _lock:
            # re-check under the lock; first thread in parses
            if raw != _env_cache[0]:
                _env_cache = (raw, _parse(raw))
            cached = _env_cache[1]
    return cached.get(site)


def _active():
    """The no-op fast path's whole cost: one env membership test + one
    truthiness test. No parsing, no allocation."""
    return _ctx_plans or ENV_FAULTINJECT in os.environ


def _record(site, kind):
    key = "%s:%s" % (site, kind)
    with _lock:
        _counts[key] = _counts.get(key, 0) + 1
    if _tm.enabled():
        _tm.counter("faultinject.fired").inc()
        _tm.counter("faultinject.%s.%s" % (site, kind)).inc()


def _all_plans(site):
    env = _env_plans(site)
    ctx = _ctx_plans.get(site)
    if env and ctx:
        return ctx + env  # scoped overlays evaluate first
    return ctx or env


def fire(site):
    """Evaluate the ``raise``/``delay_ms``/``hang`` plans for ``site``:
    may sleep, may raise ``FaultInjected`` (or an ``OSError`` when the
    plan's arg names an errno). No-op (and allocation-free) when no
    injection is configured. ``torn_write`` plans are evaluated by
    byte-writing sites via ``torn_fraction`` instead."""
    if not _active():
        return
    plans = _all_plans(site)
    if not plans:
        return
    for plan in plans:
        if plan.kind == "torn_write" or not plan.roll():
            continue
        _record(site, plan.kind)
        if plan.kind == "delay_ms":
            time.sleep(float(plan.arg if plan.arg is not None else 10.0)
                       / 1000.0)
        elif plan.kind == "hang":
            time.sleep(float(plan.arg if plan.arg is not None else 60.0))
        else:  # raise
            eno = getattr(_errno, str(plan.arg), None) \
                if plan.arg is not None else None
            if eno is not None:
                raise OSError(eno, "faultinject: injected %s at site %r"
                              % (plan.arg, site))
            raise FaultInjected(site)


def torn_fraction(site):
    """For byte-writing sites: the fraction of the payload to KEEP if a
    ``torn_write`` plan fires (then the site must persist only that prefix
    and raise ``OSError(EIO)``), else None. See
    ``checkpoint.atomic_write_bytes`` for the canonical consumer."""
    if not _active():
        return None
    plans = _all_plans(site)
    if not plans:
        return None
    for plan in plans:
        if plan.kind == "torn_write" and plan.roll():
            _record(site, plan.kind)
            frac = float(plan.arg) if plan.arg is not None else 0.5
            return min(max(frac, 0.0), 1.0)
    return None


class inject:
    """Scoped injection for tests::

        with faultinject.inject("serving.dispatch", "raise",
                                prob=1.0, seed=3, times=1) as plan:
            ...
        assert plan.fired == 1

    Overlays the env configuration for the ``with`` body (evaluated before
    env plans at the same site); nestable; thread-safe via copy-on-write of
    the overlay table, so readers never take a lock."""

    def __init__(self, site, kind, prob=1.0, seed=0, arg=None, times=None):
        self.plan = _Plan(site, kind, prob, seed, arg=arg, times=times)

    def __enter__(self):
        global _ctx_plans
        with _lock:
            table = {k: list(v) for k, v in _ctx_plans.items()}
            table.setdefault(self.plan.site, []).append(self.plan)
            _ctx_plans = table
        return self.plan

    def __exit__(self, *exc):
        global _ctx_plans
        with _lock:
            table = {k: [p for p in v if p is not self.plan]
                     for k, v in _ctx_plans.items()}
            _ctx_plans = {k: v for k, v in table.items() if v}
        return False


def refresh():
    """Drop the parsed-env cache so the NEXT evaluation re-parses
    ``MXNET_FAULTINJECT`` with fresh RNG streams — the same env value then
    replays the same injected-event sequence from the start (tests pin the
    determinism contract on this)."""
    global _env_cache
    with _lock:
        _env_cache = (None, {})


def stats():
    """Fired-event counts ``{"site:kind": n}`` — live regardless of the
    telemetry gate (the chaos harness asserts injections actually ran)."""
    with _lock:
        return dict(_counts)


def reset_stats():
    with _lock:
        _counts.clear()
