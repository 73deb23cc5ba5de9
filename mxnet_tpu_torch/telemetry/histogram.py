# copied from mxnet_tpu/telemetry/histogram.py (backend-free)
"""Log-bucketed streaming latency histogram (docs/OBSERVABILITY.md §Fleet).

Fixed memory, mergeable, bounded relative error — the representation every
hot-seam timer keeps so p50/p95/p99 exist without per-sample storage:

* ``record(seconds)`` is one bucket increment (an integer ``+= 1`` under a
  lock — CPython's ``list[i] += 1`` is not atomic, and the serving seams
  record from many threads).
* Buckets are geometric: ``BUCKETS_PER_DECADE`` (12) per factor-of-10 over
  ``LO``..``HI`` (1 µs .. 100 s), 96 buckets + 2 overflow sentinels.  The
  growth factor is ``10**(1/12)`` ≈ 1.2115, so any quantile read from a
  bucket's geometric midpoint is within ``10**(1/24) - 1`` ≈ 10.1% of the
  true sample value — the documented error bound.
* ``merge()`` is element-wise addition: associative, commutative, lossless
  with respect to the bucketed representation.  That is what lets the
  router fold per-replica snapshots into fleet rollups in any order.
* ``to_dict()`` is sparse (only non-zero buckets) and pure-JSON, so it
  rides health() snapshots and chrome-dump ``otherData`` unchanged.

Stdlib-only on purpose: ``tools/mxtrace`` imports the telemetry package
standalone (no framework, no numpy), and this module is on that path.
"""
from __future__ import annotations

import math
import threading

BUCKETS_PER_DECADE = 12
LO = 1e-6                     # 1 µs — bucket 0 upper edge region
HI = 100.0                    # 100 s — everything above lands in overflow
DECADES = 8                   # log10(HI / LO)
NUM_BUCKETS = BUCKETS_PER_DECADE * DECADES          # 96 finite buckets
# bucket index for value v (LO <= v < HI):
#   floor(log10(v / LO) * BUCKETS_PER_DECADE)
# under-/overflow get dedicated sentinel buckets so counts are never lost.
UNDER = NUM_BUCKETS            # v < LO (incl. zero/negative clamps)
OVER = NUM_BUCKETS + 1         # v >= HI
TOTAL_BUCKETS = NUM_BUCKETS + 2

_LOG10_LO = math.log10(LO)
# Relative half-width of one bucket read at its geometric midpoint.
REL_ERROR = 10.0 ** (1.0 / (2 * BUCKETS_PER_DECADE)) - 1.0   # ~10.1%


def bucket_index(seconds):
    """Bucket index for a duration in seconds (sentinels included)."""
    if seconds < LO:
        return UNDER
    if seconds >= HI:
        return OVER
    i = int((math.log10(seconds) - _LOG10_LO) * BUCKETS_PER_DECADE)
    # float edge: log10 can land exactly on NUM_BUCKETS for v ~= HI
    return i if i < NUM_BUCKETS else OVER


def bucket_bounds(i):
    """(lo, hi) seconds covered by finite bucket ``i``."""
    lo = 10.0 ** (_LOG10_LO + i / BUCKETS_PER_DECADE)
    hi = 10.0 ** (_LOG10_LO + (i + 1) / BUCKETS_PER_DECADE)
    return lo, hi


def _bucket_mid(i):
    if i == UNDER:
        return LO
    if i == OVER:
        return HI
    return 10.0 ** (_LOG10_LO + (i + 0.5) / BUCKETS_PER_DECADE)


class Histogram:
    """Fixed-size log-bucketed histogram of durations (seconds)."""

    __slots__ = ("_counts", "_lock")

    def __init__(self):
        self._counts = [0] * TOTAL_BUCKETS
        self._lock = threading.Lock()

    # ------------------------------------------------------------ write
    def record(self, seconds):
        i = bucket_index(seconds)
        with self._lock:
            self._counts[i] += 1

    # ------------------------------------------------------------- read
    @property
    def count(self):
        with self._lock:
            return sum(self._counts)

    def quantile(self, p):
        """Value (seconds) at quantile ``p`` in [0, 1]; None when empty.

        Reads the geometric midpoint of the bucket holding the p-th
        sample — within ``REL_ERROR`` (~10%) of the true sample for
        values inside [LO, HI); sentinel buckets answer their edge."""
        if not 0.0 <= p <= 1.0:
            raise ValueError("quantile p must be in [0, 1], got %r" % (p,))
        with self._lock:
            counts = list(self._counts)
        total = sum(counts)
        if total == 0:
            return None
        # rank of the target sample, 1-based, ceil(p * total) clamped
        rank = max(1, min(total, int(math.ceil(p * total))))
        seen = 0
        # scan order puts UNDER first (smallest values), then finite
        # buckets ascending, then OVER — rank order over values.
        for i in [UNDER] + list(range(NUM_BUCKETS)) + [OVER]:
            seen += counts[i]
            if seen >= rank:
                return _bucket_mid(i)
        return _bucket_mid(OVER)      # unreachable

    def quantiles_ms(self, ps=(0.5, 0.95, 0.99)):
        """{"p50": ms, ...} for the given quantiles; {} when empty."""
        out = {}
        for p in ps:
            q = self.quantile(p)
            if q is None:
                return {}
            out["p%g" % (100.0 * p)] = q * 1000.0
        return out

    # ------------------------------------------------------- merge/wire
    def merge(self, other):
        """Fold ``other`` (Histogram or to_dict() output) into self."""
        if isinstance(other, Histogram):
            with other._lock:
                add = list(other._counts)
            with self._lock:
                for i, n in enumerate(add):
                    self._counts[i] += n
            return self
        # dict form: sparse {index: count}
        buckets = other.get("buckets", other) if isinstance(other, dict) \
            else other
        with self._lock:
            for k, n in buckets.items():
                i = int(k)
                if 0 <= i < TOTAL_BUCKETS and n > 0:
                    self._counts[i] += int(n)
        return self

    def to_dict(self):
        """Sparse JSON-safe snapshot: {"v": 1, "buckets": {"i": count}}."""
        with self._lock:
            buckets = {str(i): n for i, n in enumerate(self._counts) if n}
        return {"v": 1, "buckets": buckets}

    @classmethod
    def from_dict(cls, d):
        h = cls()
        h.merge(d)
        return h

    def delta_since(self, prev_buckets):
        """Sparse bucket delta vs a previous dense/sparse snapshot.

        ``prev_buckets`` is the {index: count} map a prior ``to_dict()``
        carried (or None).  Returns only buckets that grew — the compact
        increment a replica ships in each health() snapshot."""
        with self._lock:
            cur = list(self._counts)
        prev = prev_buckets or {}
        out = {}
        for i, n in enumerate(cur):
            d = n - int(prev.get(str(i), 0))
            if d > 0:
                out[str(i)] = d
        return out

    def clear(self):
        with self._lock:
            self._counts = [0] * TOTAL_BUCKETS

    def __repr__(self):
        q = self.quantiles_ms()
        return "Histogram(n=%d%s)" % (
            self.count,
            "".join(", %s=%.3fms" % kv for kv in sorted(q.items())))


def merge_bucket_maps(*maps):
    """Merge sparse {index: count} maps (associative, commutative)."""
    out = {}
    for m in maps:
        if not m:
            continue
        for k, n in m.items():
            out[k] = out.get(k, 0) + int(n)
    return out


def quantiles_from_buckets(buckets, ps=(0.5, 0.95, 0.99)):
    """{"p50": ms, ...} straight from a sparse bucket map (router path)."""
    if not buckets:
        return {}
    return Histogram.from_dict({"buckets": buckets}).quantiles_ms(ps)
