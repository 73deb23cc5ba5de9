# copied from mxnet_tpu/telemetry/slo.py (backend-free)
"""Declarative SLOs with multi-window burn-rate evaluation
(docs/OBSERVABILITY.md §Fleet).

An SLO spec is a small set of objectives over the serving request
stream::

    MXNET_SLO="p99_ms:250,err_pct:1,avail_pct:99"

or a JSON object / path to a JSON file with the same keys
(``{"p99_ms": 250, "err_pct": 1, "avail_pct": 99}``).  Objectives:

* ``p50_ms`` / ``p95_ms`` / ``p99_ms`` — latency ceiling at that
  quantile.  The error budget is the quantile's complement (a p99
  objective tolerates 1% of requests over the ceiling).
* ``err_pct`` — maximum failed-request percentage.
* ``avail_pct`` — minimum fraction of evaluation ticks with at least one
  eligible replica.

``SloMonitor`` consumes per-tick DELTAS (requests completed, errors,
sparse latency-histogram buckets from :mod:`telemetry.histogram`, an
availability sample) and evaluates each objective over TWO sliding
windows — short (default 5 s, ``MXNET_SLO_SHORT_WINDOW_S``) and long
(default 60 s, ``MXNET_SLO_WINDOW_S``).  The burn rate of an objective
is budget consumption speed: observed bad fraction / allowed bad
fraction (1.0 = exactly exhausting the budget).  The reported
``slo.burn_rate`` gauge is the worst objective's ``min(short, long)`` —
the multi-window AND that ignores both ancient history (long-only) and
one-tick blips (short-only).  Crossing ``MXNET_SLO_BURN_THRESHOLD``
(default 1.0) fires a structured violation event
(``telemetry.event("slo.violation")`` + the ``violations()`` list); the
matching ``slo.clear`` event is emitted when the burn drops back under.

Stdlib-only: this module rides the standalone telemetry import
(tools/mxtrace) and the replica subprocess.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

from . import histogram as _histmod
from . import registry, spans

__all__ = ["SloSpec", "SloMonitor", "DEFAULT_WINDOW_S",
           "DEFAULT_SHORT_WINDOW_S", "DEFAULT_BURN_THRESHOLD"]

DEFAULT_WINDOW_S = 60.0
DEFAULT_SHORT_WINDOW_S = 5.0
DEFAULT_BURN_THRESHOLD = 1.0

_LATENCY_KEYS = {"p50_ms": 0.50, "p95_ms": 0.95, "p99_ms": 0.99}
_KEYS = set(_LATENCY_KEYS) | {"err_pct", "avail_pct"}


def _env_float(name, default):
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        v = float(raw)
        if v <= 0:
            raise ValueError
        return v
    except ValueError:
        import logging

        logging.getLogger("mxnet_tpu_torch").warning(
            "%s=%r is not a positive number; using the default %s",
            name, raw, default)
        return default


class SloSpec:
    """Parsed objectives: ``{key: threshold}`` over ``_KEYS``."""

    __slots__ = ("objectives",)

    def __init__(self, objectives):
        bad = set(objectives) - _KEYS
        if bad:
            raise ValueError("unknown SLO objective(s): %s (known: %s)"
                             % (sorted(bad), sorted(_KEYS)))
        self.objectives = {k: float(v) for k, v in objectives.items()}
        for k, v in self.objectives.items():
            if v <= 0 or (k.endswith("_pct") and v > 100):
                raise ValueError("SLO %s:%r out of range" % (k, v))

    @classmethod
    def parse(cls, text):
        """``"p99_ms:250,err_pct:1"``, an inline JSON object, or a path
        to a JSON file holding one."""
        text = (text or "").strip()
        if not text:
            raise ValueError("empty SLO spec")
        if text.startswith("{"):
            return cls(json.loads(text))
        if os.path.exists(text):
            with open(text) as f:
                return cls(json.load(f))
        obj = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise ValueError(
                    "malformed SLO entry %r (want key:value)" % part)
            k, v = part.split(":", 1)
            obj[k.strip()] = float(v)
        return cls(obj)

    @classmethod
    def from_env(cls):
        """MXNET_SLO, or None when unset/empty. A malformed value warns
        and disables (a bad knob must not take down a server)."""
        raw = os.environ.get("MXNET_SLO", "").strip()
        if not raw:
            return None
        try:
            return cls.parse(raw)
        except (ValueError, OSError) as exc:
            import logging

            logging.getLogger("mxnet_tpu_torch").warning(
                "MXNET_SLO=%r is unparseable (%s); SLO gating disabled",
                raw, exc)
            return None

    def __repr__(self):
        return "SloSpec(%s)" % ",".join(
            "%s:%g" % kv for kv in sorted(self.objectives.items()))


class SloMonitor:
    """Sliding-window burn-rate evaluator over per-tick deltas."""

    def __init__(self, spec, window_s=None, short_window_s=None,
                 burn_threshold=None, clock=time.monotonic):
        self.spec = spec
        self.window_s = window_s if window_s is not None else \
            _env_float("MXNET_SLO_WINDOW_S", DEFAULT_WINDOW_S)
        self.short_window_s = short_window_s if short_window_s is not None \
            else _env_float("MXNET_SLO_SHORT_WINDOW_S",
                            DEFAULT_SHORT_WINDOW_S)
        self.short_window_s = min(self.short_window_s, self.window_s)
        self.burn_threshold = burn_threshold if burn_threshold is not None \
            else _env_float("MXNET_SLO_BURN_THRESHOLD",
                            DEFAULT_BURN_THRESHOLD)
        self._clock = clock
        self._lock = threading.Lock()
        self._samples = collections.deque()   # (t, total, errors, buckets, avail)
        self._violations = []                 # structured fire/clear events
        self._active = set()                  # objectives currently firing

    # ------------------------------------------------------------ feed
    def observe(self, total=0, errors=0, latency_buckets=None,
                available=None, t=None):
        """One tick of DELTAS: ``total`` requests finished, ``errors`` of
        them failed, their latency as sparse histogram buckets, and an
        availability sample (bool or 0..1 fraction; None = no opinion)."""
        t = self._clock() if t is None else t
        av = None if available is None else float(available)
        with self._lock:
            self._samples.append((t, int(total), int(errors),
                                  dict(latency_buckets or {}), av))
            self._prune(t)

    def _prune(self, now):
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    # ------------------------------------------------------- evaluate
    def _window_stats(self, now, width):
        total = errors = 0
        buckets = {}
        avail_sum, avail_n = 0.0, 0
        for t, n, e, b, av in self._samples:
            if t < now - width:
                continue
            total += n
            errors += e
            for k, v in b.items():
                buckets[k] = buckets.get(k, 0) + v
            if av is not None:
                avail_sum += av
                avail_n += 1
        return total, errors, buckets, (avail_sum / avail_n
                                        if avail_n else None)

    @staticmethod
    def _bad_latency(buckets, threshold_ms):
        """How many bucketed samples exceed the ceiling (bucket geometric
        midpoint vs threshold — within the histogram's ~10% error)."""
        bad = 0
        thr_s = threshold_ms / 1000.0
        for k, n in buckets.items():
            if _histmod._bucket_mid(int(k)) > thr_s:
                bad += n
        return bad

    def _objective_burn(self, key, threshold, stats):
        """(burn_rate, observed_value) for one objective in one window.
        burn_rate = observed bad fraction / allowed bad fraction; None
        when the window holds no relevant signal."""
        total, errors, buckets, avail = stats
        if key in _LATENCY_KEYS:
            n = sum(buckets.values())
            if n == 0:
                return None, None
            bad = self._bad_latency(buckets, threshold)
            allowed = 1.0 - _LATENCY_KEYS[key]
            q = _histmod.quantiles_from_buckets(
                buckets, ps=(_LATENCY_KEYS[key],))
            observed = q.get("p%g" % (100.0 * _LATENCY_KEYS[key]))
            return (bad / float(n)) / allowed, observed
        if key == "err_pct":
            if total == 0:
                return None, None
            allowed = threshold / 100.0
            return (errors / float(total)) / allowed, \
                100.0 * errors / float(total)
        if key == "avail_pct":
            if avail is None:
                return None, None
            allowed = 1.0 - threshold / 100.0
            if allowed <= 0:
                allowed = 1e-9      # avail_pct:100 — any downtime burns
            return (1.0 - avail) / allowed, 100.0 * avail
        return None, None

    def evaluate(self, t=None):
        """Evaluate every objective over both windows; update the
        ``slo.*`` gauges; fire/clear structured violation events.

        Returns ``{"ok", "burn_rate", "objectives": {key: {burn_rate,
        short, long, value, threshold, firing}}, ...}``."""
        now = self._clock() if t is None else t
        with self._lock:
            self._prune(now)
            long_stats = self._window_stats(now, self.window_s)
            short_stats = self._window_stats(now, self.short_window_s)
            objectives = {}
            worst = 0.0
            fired, cleared = [], []
            for key, thr in sorted(self.spec.objectives.items()):
                b_long, v_long = self._objective_burn(key, thr, long_stats)
                b_short, v_short = self._objective_burn(key, thr,
                                                        short_stats)
                # multi-window AND: both must burn — the long window
                # screens out blips, the short screens out stale history
                burn = min(b_long, b_short) \
                    if b_long is not None and b_short is not None \
                    else (b_long if b_short is None else b_short)
                burn = 0.0 if burn is None else burn
                firing = burn >= self.burn_threshold
                was = key in self._active
                if firing and not was:
                    self._active.add(key)
                    fired.append((key, thr, burn, v_long))
                elif was and not firing:
                    self._active.discard(key)
                    cleared.append((key, thr, burn, v_long))
                worst = max(worst, burn)
                objectives[key] = {
                    "threshold": thr, "burn_rate": round(burn, 4),
                    "short": None if b_short is None else round(b_short, 4),
                    "long": None if b_long is None else round(b_long, 4),
                    "value": None if v_long is None else round(v_long, 3),
                    "firing": firing}
            result = {"ok": not self._active, "burn_rate": round(worst, 4),
                      "objectives": objectives,
                      "window_s": self.window_s,
                      "short_window_s": self.short_window_s,
                      "burn_threshold": self.burn_threshold}
        if spans.enabled():
            registry.gauge("slo.burn_rate").set(result["burn_rate"])
        for key, thr, burn, val in fired:
            ev = {"kind": "slo.violation", "objective": key,
                  "threshold": thr, "burn_rate": round(burn, 4),
                  "value": None if val is None else round(val, 3),
                  "t": now}
            with self._lock:
                self._violations.append(ev)
            if spans.enabled():
                registry.counter("slo.violations").inc()
            spans.event("slo.violation", objective=key, threshold=thr,
                        burn_rate=round(burn, 4))
        for key, thr, burn, val in cleared:
            ev = {"kind": "slo.clear", "objective": key, "threshold": thr,
                  "burn_rate": round(burn, 4), "t": now}
            with self._lock:
                self._violations.append(ev)
            spans.event("slo.clear", objective=key,
                        burn_rate=round(burn, 4))
        return result

    # ---------------------------------------------------------- reads
    def violations(self):
        """The structured fire/clear event log, oldest first."""
        with self._lock:
            return list(self._violations)

    def firing(self):
        """Objectives currently in violation."""
        with self._lock:
            return sorted(self._active)
