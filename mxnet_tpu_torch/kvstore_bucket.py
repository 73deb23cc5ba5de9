"""Bucketed gradient comm for the dist KVStore (docs/PERF.md §11).

Counterpart of ``mxnet_tpu/kvstore_bucket.py`` on ``torch.distributed``:

* **Static bucket plan**: built ONCE from the first dist push round. Keys
  pack, in arrival (reverse-topo) order, into per-dtype buckets of
  ``MXNET_KVSTORE_BUCKET_MB`` (default 25 MB); a key larger than the cap
  splits into parts. Each bucket owns one flat buffer, allocated once,
  with every slot at a fixed offset and the padding zeroed once.
* **Asynchronous flush**: a push copies its gradient into its slot, and
  the bucket's collective starts (``async_op=True``) the moment its last
  slot fills. ``pull`` finalizes only its own keys' buckets: it waits on
  their work handles, which on NCCL orders the current stream after the
  collective before the weights are read.
* **Sharded weight update** (``MXNET_KVSTORE_UPDATE=sharded``):
  reduce-scatter, the flat optimizer kernel (``optimizer.FLAT_KERNELS``)
  on this worker's 1/W shard, then all-gather of the new weights.
* **Wire compression** (``MXNET_KVSTORE_COMM_DTYPE=bf16``): float32
  buckets pack as bf16; the collective all-gathers the bf16 buffers and
  sums them in float32 (the sum never runs in bf16).

The engine runs only when the world has more than one worker
(``KVStore._engine``). Telemetry: ``kvstore.bucket_flushes`` /
``kvstore.bucket_flush_bytes`` counters, the per-transport byte counters
(``kvstore.bytes.allreduce|reduce_scatter|all_gather``), the
``kvstore.overlap_ratio`` gauge, the ``kvstore.comm_inflight`` timer and
``kvstore.bucket_flush`` spans, with the JAX package's byte formulas.
"""
from __future__ import annotations

import hashlib
import logging
import math
import os
import time
from collections import namedtuple
from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from . import telemetry as _tm
from .ndarray import NDArray
from .optimizer import FLAT_KERNELS as _FLAT_KERNELS

__all__ = ["BucketPlan", "BucketSpec", "Slot", "BucketEngine", "bucket_bytes", "update_mode",
           "comm_dtype_for", "verify_digest_across_workers"]

log = logging.getLogger("mxnet_tpu_torch.kvstore")

DEFAULT_BUCKET_MB = 25.0
DEFAULT_CHECK_ROUNDS = 3

# copied from mxnet_tpu/kvstore_bucket.py (Slot, bucket_bytes, update_mode,
# comm_dtype_for, BucketSpec, BucketPlan; backend-free)
Slot = namedtuple("Slot", ["key", "offset", "size", "shape", "dtype",
                           "src_off", "part", "n_parts"])


def bucket_bytes() -> int:
    """Bucket capacity in bytes from MXNET_KVSTORE_BUCKET_MB."""
    raw = os.environ.get("MXNET_KVSTORE_BUCKET_MB", "")
    try:
        mb = float(raw) if raw else DEFAULT_BUCKET_MB
        if mb <= 0:
            raise ValueError(mb)
    except ValueError:
        log.warning("MXNET_KVSTORE_BUCKET_MB=%r is not a positive number; "
                    "using %g", raw, DEFAULT_BUCKET_MB)
        mb = DEFAULT_BUCKET_MB
    return max(1, int(mb * 1e6))


def update_mode() -> str:
    """MXNET_KVSTORE_UPDATE=replicated|sharded."""
    raw = os.environ.get("MXNET_KVSTORE_UPDATE", "replicated").lower()
    if raw in ("replicated", "sharded"):
        return raw
    log.warning("MXNET_KVSTORE_UPDATE=%r unknown (replicated|sharded); "
                "using replicated", raw)
    return "replicated"


def comm_dtype_for(dtype) -> str:
    """Wire dtype for a bucket of ``dtype`` under MXNET_KVSTORE_COMM_DTYPE:
    only float32 buckets compress (bf16 wire, float32 accumulate)."""
    raw = os.environ.get("MXNET_KVSTORE_COMM_DTYPE", "").lower()
    if raw in ("", "0", "none", "off"):
        return str(dtype)
    if raw in ("bf16", "bfloat16"):
        return "bfloat16" if str(dtype) == "float32" else str(dtype)
    log.warning("MXNET_KVSTORE_COMM_DTYPE=%r unknown (bf16); ignoring", raw)
    return str(dtype)


def _itemsize(dtype) -> int:
    return 2 if str(dtype) == "bfloat16" else np.dtype(dtype).itemsize


def _tdtype(dtype) -> torch.dtype:
    return torch.bfloat16 if str(dtype) == "bfloat16" else torch_dtype(dtype)


class BucketSpec:
    """One bucket: a fixed window of keys at fixed offsets in a flat comm
    buffer. ``total`` is padded to a multiple of ``n_workers`` so the
    sharded update's reduce-scatter splits evenly."""

    def __init__(self, index, dtype, comm_dtype, slots, n_workers, priority):
        self.index = index
        self.dtype = str(dtype)
        self.comm_dtype = str(comm_dtype)
        self.slots = list(slots)
        self.priority = priority
        used = self.slots[-1].offset + self.slots[-1].size if self.slots else 0
        self.total = -(-used // n_workers) * n_workers
        self.pad = self.total - used

    @property
    def keys(self):
        return [s.key for s in self.slots]

    def describe(self):
        return {"index": self.index, "dtype": self.dtype, "comm_dtype": self.comm_dtype,
                "total": self.total, "pad": self.pad, "priority": self.priority,
                "slots": [tuple(s) for s in self.slots]}


class BucketPlan:
    """Deterministic one-time packing of a push round's keys into buckets,
    built from the FIRST dist push round's arrival sequence, then frozen:
    every worker derives the identical plan (hash-verified)."""

    def __init__(self, buckets, bucket_cap, n_workers):
        self.buckets: List[BucketSpec] = buckets
        self.bucket_cap = bucket_cap
        self.n_workers = n_workers
        self.key_to_slots: Dict = {}
        for b in buckets:
            for s in b.slots:
                self.key_to_slots.setdefault(s.key, []).append((b, s))
        for parts in self.key_to_slots.values():
            parts.sort(key=lambda bs: bs[1].part)
        self.hash = hashlib.sha1(
            repr([(b.dtype, b.comm_dtype, b.total, [tuple(s) for s in b.slots])
                  for b in buckets]).encode()).hexdigest()

    @staticmethod
    def build(records, n_workers, bucket_cap=None) -> "BucketPlan":
        """``records``: [(key, shape, dtype_str, priority)] in arrival order.
        Keys pack greedily per dtype; a bucket closes when the next key
        would overflow ``bucket_cap`` bytes; a key LARGER than the cap
        splits into cap-sized parts across consecutive buckets."""
        if bucket_cap is None:
            bucket_cap = bucket_bytes()
        by_dtype: Dict[str, list] = {}
        order: List[str] = []
        for key, shape, dtype, priority in records:
            dt = str(dtype)
            if dt not in by_dtype:
                by_dtype[dt] = []
                order.append(dt)
            by_dtype[dt].append((key, tuple(shape), priority))
        buckets = []
        for dt in order:
            comm_dt = comm_dtype_for(dt)
            cap_elems = max(n_workers, bucket_cap // _itemsize(comm_dt))
            cur, cur_elems, cur_prio = [], 0, None

            def close():
                nonlocal cur, cur_elems, cur_prio
                if cur:
                    buckets.append(BucketSpec(len(buckets), dt, comm_dt, cur, n_workers,
                                              cur_prio))
                    cur, cur_elems, cur_prio = [], 0, None

            for key, shape, priority in by_dtype[dt]:
                size = int(np.prod(shape)) if shape else 1
                n_parts = -(-size // cap_elems)
                if n_parts == 1:
                    if cur_elems + size > cap_elems:
                        close()
                    offset = cur[-1].offset + cur[-1].size if cur else 0
                    cur.append(Slot(key, offset, size, shape, dt, 0, 0, 1))
                    cur_elems += size
                else:
                    close()
                    for part in range(n_parts):
                        src_off = part * cap_elems
                        psize = min(cap_elems, size - src_off)
                        cur.append(Slot(key, 0, psize, shape, dt, src_off, part, n_parts))
                        cur_elems = psize
                        cur_prio = priority
                        if part != n_parts - 1:
                            close()
                cur_prio = priority if cur_prio is None else max(cur_prio, priority)
            close()
        return BucketPlan(buckets, bucket_cap, n_workers)

    def describe(self):
        return {"hash": self.hash, "bucket_cap": self.bucket_cap, "n_workers": self.n_workers,
                "buckets": [b.describe() for b in self.buckets]}

    def describe_portable(self):
        """JSON-round-trippable describe() (tuples -> lists): the slot map a
        checkpoint manifest records so any-world loaders can re-flatten the
        shard set (``checkpoint.per_key_states``)."""
        d = self.describe()
        for b in d["buckets"]:
            b["slots"] = [[s[0], s[1], s[2], list(s[3])] + list(s[4:]) for s in b["slots"]]
        return d


class _BucketState:
    """Runtime state of one bucket: its preallocated flat buffer and the
    current round's filled slots and in-flight collective."""

    def __init__(self, spec, device):
        self.spec = spec
        self.buf = torch.zeros((spec.total,), dtype=_tdtype(spec.comm_dtype),
                               device=device)
        self.slots = set()            # (key, part) written this round
        self.result = None            # ("replicated"|"sharded", _Pending)
        self.segments = None          # the sharded round's (lr, wd) segments
        self.t_dispatch = None
        self.partial = False

    def reset(self):
        self.slots.clear()
        self.result = None
        self.segments = None
        self.t_dispatch = None
        self.partial = False


class BucketEngine:
    """Per-KVStore comm engine: records the first push round, commits the
    plan, then runs every later round through the per-bucket collectives
    with asynchronous flush and per-bucket finalize."""

    def __init__(self, kv):
        self._kv = kv
        self._collective = None
        self.plan: Optional[BucketPlan] = None
        self._recording: List = []    # (key, merged tensor copy, priority)
        self._states: Dict[int, _BucketState] = {}
        self._sharded_state: Dict[int, dict] = {}
        self._mode = update_mode()
        self._mode_reason = None
        self._plan_records = None     # committed plan's records (for reform)
        self._preloaded_shards = {}   # bucket idx -> [np local state shards]
        self._pending_parts: Dict = {}
        self._ticked = set()
        self._round_seq: List = []
        self._round_t0 = None
        self._round_flushes = []
        self._rounds_done = 0
        self._check_rounds = self._env_check_rounds()
        self._legacy_warned = False

    @staticmethod
    def _env_check_rounds():
        raw = os.environ.get("MXNET_KVSTORE_CHECK_STEPS", "")
        try:
            return int(raw) if raw else DEFAULT_CHECK_ROUNDS
        except ValueError:
            log.warning("MXNET_KVSTORE_CHECK_STEPS=%r not an int; using %d",
                        raw, DEFAULT_CHECK_ROUNDS)
            return DEFAULT_CHECK_ROUNDS

    def _coll(self):
        if self._collective is None:
            from .kvstore import _Collective

            self._collective = _Collective.get()
        return self._collective

    @property
    def mode(self) -> str:
        """Effective update mode: 'sharded' only when the optimizer has a
        flat lowering and the store runs the updater."""
        return self._resolve_mode()

    def _resolve_mode(self):
        if self._mode != "sharded" or self._mode_reason is not None:
            return "replicated"
        opt = getattr(self._kv, "_optimizer", None)
        upd = getattr(self._kv, "_updater", None)
        if upd is None or opt is None:
            self._mode_reason = ("no kvstore optimizer (update_on_kvstore is off) — sharded "
                                 "update needs the updater to run inside the collective")
        elif opt.flat_update_spec() is None:
            self._mode_reason = "optimizer %s has no flat_update_spec()" % type(opt).__name__
        else:
            return "sharded"
        log.warning("MXNET_KVSTORE_UPDATE=sharded unavailable: %s; falling back to "
                    "replicated", self._mode_reason)
        return "replicated"

    # ------------------------------------------------------------------ push
    def push(self, keys, merged_list, priority):
        """One push call's keys (already locally reduced), in order."""
        now = time.perf_counter()
        if self._round_t0 is None:
            self._round_t0 = now
        if self._rounds_done <= self._check_rounds:
            for k, m in zip(keys, merged_list):
                self._round_seq.append((k, tuple(m.shape), str(m.dtype)))
        if self.plan is None:
            recorded = {r[0] for r in self._recording}
            if not any(k in recorded for k in keys):
                for k, m in zip(keys, merged_list):
                    # a copy NOW: the caller may overwrite its array before
                    # the plan-committing pull reads it
                    self._recording.append((k, NDArray(m._tensor().clone(), ctx=m.context),
                                            priority))
                return
            self._commit_plan()
        self._push_bucketed(keys, merged_list, priority)

    def _push_bucketed(self, keys, merged_list, priority):
        legacy_k, legacy_m = [], []
        for k, m in zip(keys, merged_list):
            parts = self.plan.key_to_slots.get(k)
            if parts is None:
                legacy_k.append(k)
                legacy_m.append(m)
                continue
            flat = None
            self._ticked.discard(k)
            for bucket, slot in parts:
                st = self._states[bucket.index]
                sid = (k, slot.part)
                if sid in st.slots or st.result is not None:
                    # round restart for this bucket: drain it first
                    if st.result is None:
                        self._flush(st)
                    self._finalize(st)
                if flat is None:
                    flat = m._tensor().reshape(-1)
                st.buf[slot.offset:slot.offset + slot.size].copy_(
                    flat[slot.src_off:slot.src_off + slot.size])
                st.slots.add(sid)
                if len(st.slots) == len(bucket.slots):
                    self._flush(st)
        if legacy_k:
            self._legacy_round(legacy_k, legacy_m)

    def before_read(self, keys):
        """Pull-side sync: commit the plan if still recording, then finalize
        ONLY the buckets the requested keys live in."""
        if self.plan is None and self._recording:
            self._commit_plan()
        if self.plan is None:
            return
        touched = []
        for k in keys:
            for b, _slot in self.plan.key_to_slots.get(k, ()):
                if b.index not in touched:
                    touched.append(b.index)
        pending = [self._states[i] for i in touched]
        for st in sorted((s for s in pending if s.result is None and s.slots),
                         key=lambda s: (-s.spec.priority, s.spec.index)):
            self._flush(st)
        for i in touched:
            self._finalize(self._states[i])
        if not any(s.result is not None or s.slots for s in self._states.values()):
            self._close_round()

    def finalize_all(self):
        """Drain every in-flight or partial bucket."""
        if self.plan is None:
            if self._recording:
                self._commit_plan()
            else:
                return
        for st in sorted((s for s in self._states.values() if s.result is None and s.slots),
                         key=lambda s: (-s.spec.priority, s.spec.index)):
            self._flush(st)
        for st in self._states.values():
            self._finalize(st)
        self._close_round()

    # ---------------------------------------------------------- resume/reform
    def preload_flat_shards(self, shards):
        """Seed the NEXT flat-state build from checkpoint shards: ``shards``
        maps bucket index -> [np local 1/W state slices] (this worker's).
        The live sharded state is dropped so the next flush rebuilds from
        the preload (the same-W shard-direct resume: the exact bytes the
        checkpoint captured go straight back)."""
        self._preloaded_shards = dict(shards)
        self._sharded_state.clear()
        # a load clears a capability veto: the caller proved the
        # optimizer/world alignment by matching the manifest
        if self._mode_reason and "partial push round" not in self._mode_reason:
            self._mode_reason = None

    def reseed_updater_states(self):
        """Drop the flat sharded state so the next flush seeds from the
        per-key Updater states (the re-flattened resume; also after a state
        load mid-run)."""
        self._preloaded_shards.clear()
        self._sharded_state.clear()

    def drain_inflight(self):
        """Wait out every dispatched collective before the process group it
        runs on is torn down (an elastic re-form after a crash). A handle
        whose peer died raises the transport's error when waited on: that
        is the failure being recovered from, so it is logged and the
        bucket's round dropped."""
        for st in self._states.values():
            if st.result is not None:
                try:
                    st.result[1].wait()
                except RuntimeError as e:
                    log.warning("KVStore: bucket %d's collective failed before the re-form "
                                "(%s); its round is dropped", st.spec.index, e)
            st.reset()
        self._pending_parts = {}

    def reform(self, records=None):
        """Rebuild this engine for the CURRENT world (after an elastic
        re-form changed the process set): drop every collective handle,
        buffer and in-flight bucket, then re-plan the committed key
        sequence for the new worker count. The plan-digest allgather
        re-verifies agreement and the first-N round checks re-arm."""
        records = records if records is not None else self._plan_records
        self._collective = None     # _Collective.get() re-keys on the group
        self._states = {}
        self._sharded_state = {}
        self._preloaded_shards = {}
        self._pending_parts = {}
        self._ticked = set()
        self._round_seq = []
        self._round_t0 = None
        self._round_flushes = []
        self.rearm_verify()
        self._mode = update_mode()
        self._mode_reason = None
        self.plan = None
        self._recording = []
        if records is not None:
            self._plan_records = list(records)
            coll = self._coll()
            self.plan = BucketPlan.build(records, coll.n_workers)
            self._states = {b.index: _BucketState(b, coll.device) for b in self.plan.buckets}
            log.info("KVStore bucket plan re-formed: %d keys -> %d bucket(s) over %d "
                     "worker(s), hash %s", len(records), len(self.plan.buckets),
                     coll.n_workers, self.plan.hash[:12])
            self._verify_across_workers("plan:" + self.plan.hash)

    def export_per_key_states(self):
        """Per-key optimizer states from the live flat shards, on the host:
        the pause-time snapshot elastic recovery seeds from (a collective:
        the full current membership must take part, i.e. a DRAINING
        departure, not a crash). In-flight buckets finalize first. ``{}``
        when the engine holds no flat state."""
        self.finalize_all()
        _, states = self._gather_per_key_states()
        return {k: [t.cpu().numpy() for t in v] for k, v in states.items()}

    # ------------------------------------------------------------------ plan
    def _commit_plan(self):
        records = [(k, tuple(m.shape), str(m.dtype), p) for k, m, p in self._recording]
        self._plan_records = records
        coll = self._coll()
        self.plan = BucketPlan.build(records, coll.n_workers)
        self._states = {b.index: _BucketState(b, coll.device) for b in self.plan.buckets}
        log.info("KVStore bucket plan: %d keys -> %d bucket(s), cap %.1f MB, update=%s, "
                 "hash %s", len(records), len(self.plan.buckets), self.plan.bucket_cap / 1e6,
                 self.mode, self.plan.hash[:12])
        self._verify_across_workers("plan:" + self.plan.hash)
        self.rearm_verify()
        recorded, self._recording = self._recording, []
        for k, m, p in recorded:
            self._push_bucketed([k], [m], p)

    # ----------------------------------------------------------------- flush
    def _flush(self, st):
        """Start this bucket's collective without waiting for it. Slots not
        pushed this round are zeros (a partial flush)."""
        spec = st.spec
        coll = self._coll()
        wire = int(2 * (coll.n_workers - 1) / coll.n_workers * spec.total
                   * _itemsize(spec.comm_dtype))
        for s in spec.slots:
            if (s.key, s.part) not in st.slots:
                st.buf[s.offset:s.offset + s.size].zero_()
                st.partial = True
        if self.mode == "sharded" and st.partial:
            # a key not pushed this round would still see wd/momentum in
            # the fused update: downgrade the whole engine to replicated
            self._downgrade_sharded()
        mode = self.mode
        sp = _tm.NULL_SPAN
        if _tm.enabled():
            _tm.counter("kvstore.bucket_flushes").inc()
            _tm.counter("kvstore.bucket_flush_bytes").inc(wire)
            sp = _tm.span("kvstore.bucket_flush", bucket=spec.index, nkeys=len(spec.slots),
                          bytes=wire, priority=spec.priority, mode=mode,
                          comm_dtype=spec.comm_dtype, partial=st.partial)
        acc = _tdtype(spec.dtype)
        with sp:
            if mode == "sharded":
                if spec.index not in self._sharded_state:
                    self._build_sharded(spec)
                # the update counts tick at dispatch, in push order, as in
                # the JAX package (its manifests list them in this order)
                st.segments = self._lr_wd_segments(spec)
                st.result = ("sharded", coll.reduce_scatter(st.buf, acc_dtype=acc,
                                                            async_op=True))
                if _tm.enabled():
                    _tm.counter("kvstore.bytes.reduce_scatter").inc(wire // 2)
                    _tm.counter("kvstore.bytes.all_gather").inc(wire // 2)
            else:
                st.result = ("replicated", coll.allreduce(st.buf, acc_dtype=acc,
                                                          async_op=True))
                if _tm.enabled():
                    _tm.counter("kvstore.bytes.allreduce").inc(wire)
        st.t_dispatch = time.perf_counter()

    def _downgrade_sharded(self):
        """Move the WHOLE engine from the sharded update to replicated,
        keeping optimizer history: all-gather every bucket's flat state
        shards into the per-key Updater states."""
        if self._mode_reason is not None:
            return
        self._mode_reason = ("partial push round — bucket keys were not all pushed; "
                             "replicated from here on")
        for st in self._states.values():
            if st.result is not None and st.result[0] == "sharded":
                self._finalize(st)
        if not self._sharded_state:
            return
        log.warning("KVStore: partial push round under MXNET_KVSTORE_UPDATE=sharded — "
                    "downgrading to the replicated update (per-key optimizer states "
                    "seeded from the flat shards; momentum history preserved)")
        n_states, per_key = self._gather_per_key_states()
        self._sharded_state.clear()
        if not n_states:
            return
        upd = self._kv._updater
        for key, arrs in per_key.items():
            ctx = self._kv._store[key].context
            nds = [NDArray(a, ctx=ctx) for a in arrs]
            upd.states[key] = nds[0] if n_states == 1 else tuple(nds)

    def _gather_per_key_states(self):
        """All-gather every bucket's flat state shards into per-key tensors
        (a collective: every worker calls it together)."""
        coll = self._coll()
        n_states = 0
        pending: Dict = {}
        for spec in (s.spec for s in self._states.values()):
            sstate = self._sharded_state.get(spec.index)
            if sstate is None or not sstate["states"]:
                continue
            n_states = len(sstate["states"])
            full = [coll.all_gather(s) for s in sstate["states"]]
            for s in spec.slots:
                pending.setdefault(s.key, {})[s.part] = [
                    fs[s.offset:s.offset + s.size] for fs in full]
        if not n_states:
            return 0, {}
        out = {}
        for key, parts in pending.items():
            slots = [sl for _, sl in self.plan.key_to_slots[key]]
            segs = [parts.get(sl.part, [torch.zeros((sl.size,), dtype=_tdtype(sl.dtype),
                                                    device=coll.device)
                                        for _ in range(n_states)]) for sl in slots]
            shape = slots[0].shape
            out[key] = [torch.cat([p[i] for p in segs]).reshape(shape) for i in range(n_states)]
        return n_states, out

    # -------------------------------------------------------------- finalize
    def _finalize(self, st):
        if st.result is None:
            return
        kind, pend = st.result
        t_fin = time.perf_counter()
        self._round_flushes.append((st.t_dispatch, t_fin))
        spec = st.spec
        if kind == "sharded":
            w_full = self._apply_sharded(st, pend.wait())
            for s in spec.slots:
                self._deliver(s, w_full[s.offset:s.offset + s.size], is_weight=True)
        else:
            summed = pend.wait()
            for s in spec.slots:
                if (s.key, s.part) not in st.slots:
                    continue  # not pushed this round (partial flush)
                self._deliver(s, summed[s.offset:s.offset + s.size], is_weight=False)
        st.reset()

    def _deliver(self, slot, seg, is_weight):
        """Land one finalized slot; a split key waits for all its parts."""
        kv = self._kv
        if slot.n_parts > 1:
            parts = self._pending_parts.setdefault(slot.key, {})
            parts[slot.part] = seg.clone()
            if len(parts) < slot.n_parts:
                return
            seg = torch.cat([parts[p] for p in range(slot.n_parts)])
            del self._pending_parts[slot.key]
        stored = kv._store[slot.key]
        t = stored._tensor()
        value = seg.reshape(slot.shape).to(device=t.device, dtype=t.dtype)
        if is_weight:
            t.copy_(value)
        elif kv._updater is None:
            # the store must not alias the bucket buffer, reused next round
            kv._store[slot.key] = NDArray(value.clone(), ctx=stored.context)
        else:
            kv._updater(slot.key, NDArray(value, ctx=stored.context), stored)

    def _close_round(self):
        """End-of-round bookkeeping: overlap telemetry and the first-N
        verify."""
        if self._round_t0 is None:
            return
        if self._round_flushes and _tm.enabled():
            t_end = max(f[1] for f in self._round_flushes)
            span = t_end - self._round_t0
            inflight = sum(f[1] - f[0] for f in self._round_flushes)
            ratio = min(1.0, inflight / span) if span > 0 else 0.0
            _tm.gauge("kvstore.overlap_ratio").set(round(ratio, 4))
            _tm.timer("kvstore.comm_inflight").add(inflight)
        seq, self._round_seq = self._round_seq, []
        self._round_t0 = None
        self._round_flushes = []
        self._ticked.clear()
        self._rounds_done += 1
        if self._rounds_done <= self._check_rounds:
            self._verify_across_workers(repr(seq))

    # ------------------------------------------------------------ validation
    def rearm_verify(self):
        """Re-open the first-N digest window."""
        self._rounds_done = 0

    def _verify_across_workers(self, payload: str):
        verify_digest_across_workers(payload, self._check_rounds, self._allgather_digest)

    @staticmethod
    def _allgather_digest(arr):
        from .kvstore import _Collective

        return _Collective.get().allgather_host(np.asarray(arr, np.int64))

    # ---------------------------------------------------------------- legacy
    def _legacy_round(self, keys, merged_list):
        """Keys outside the committed plan: the unbucketed collective."""
        kv = self._kv
        if not self._legacy_warned:
            log.info("KVStore: %d key(s) outside the bucket plan (first seen after the "
                     "planning round) ride the unbucketed collective: %s", len(keys), keys[:4])
            self._legacy_warned = True
        reduced = kv._allreduce_batch(merged_list)
        for k, merged in zip(keys, reduced):
            if kv._updater is not None:
                kv._updater(k, merged, kv._store[k])
            else:
                kv._store[k] = merged

    # --------------------------------------------------------------- sharded
    def _build_sharded(self, spec):
        """The bucket's persistent flat weight (replicated) and this worker's
        1/W optimizer-state shards, seeded in this order from a preloaded
        checkpoint shard (the same-W resume), the per-key Updater states
        where present, else zeros."""
        coll = self._coll()
        opt = self._kv._optimizer
        _, _, n_states = opt.flat_update_spec()
        acc = _tdtype(spec.dtype)
        shard = spec.total // coll.n_workers
        lo = coll.rank * shard
        preloaded = self._preloaded_shards.pop(spec.index, None)
        states = []
        for i in range(n_states):
            if preloaded is not None:
                loc = np.asarray(preloaded[i]).reshape(-1)
                if loc.shape[0] != shard:
                    raise MXNetError(
                        "preloaded checkpoint shard for bucket %d has %d elements, expected "
                        "%d — plan/world mismatch" % (spec.index, loc.shape[0], shard))
                states.append(torch.from_numpy(np.array(loc, copy=True)).to(
                    device=coll.device, dtype=acc))
                continue
            host = torch.zeros((spec.total,), dtype=acc, device=coll.device)
            for s in spec.slots:
                loaded = self._kv._updater.states.get(s.key)
                if loaded is None:
                    continue
                if n_states > 1 and not isinstance(loaded, (tuple, list)):
                    continue
                part = loaded if n_states == 1 else loaded[i]
                flat = part._tensor().reshape(-1)
                host[s.offset:s.offset + s.size] = flat[s.src_off:s.src_off + s.size]
            states.append(host[lo:lo + shard].clone())
        self._sharded_state[spec.index] = {"w_full": self._weights_from_store(spec),
                                           "states": tuple(states),
                                           "idx": None, "idx_ordinals": None}

    def _weights_from_store(self, spec):
        """The bucket's persistent flat weight buffer, assembled from the
        current store values."""
        coll = self._coll()
        w_full = torch.zeros((spec.total,), dtype=_tdtype(spec.dtype), device=coll.device)
        for s in spec.slots:
            flat = self._kv._store[s.key]._tensor().reshape(-1)
            w_full[s.offset:s.offset + s.size] = flat[s.src_off:s.src_off + s.size]
        return w_full

    def _lr_wd_segments(self, spec):
        """Per-unique-(lr, wd) segment values for this flush, gathered to
        per-element vectors through the bucket's static index map. The
        per-key update counts tick here, once a key a round, at the
        bucket's dispatch."""
        opt = self._kv._optimizer
        kind, hyper, _ = opt.flat_update_spec()
        per_key = []
        for s in spec.slots:
            if s.key not in self._ticked:
                opt._update_count(s.key)
                self._ticked.add(s.key)
            lr, wd = opt._get_lr(s.key), opt._get_wd(s.key)
            if kind == "adam":
                t = opt._index_update_count[s.key]
                lr *= math.sqrt(1.0 - hyper["beta2"] ** t) / (1.0 - hyper["beta1"] ** t)
            per_key.append((lr, wd))
        uniq = {}
        for lw in per_key:
            uniq.setdefault(lw, len(uniq))
        lr_seg = np.zeros((len(uniq),), np.float32)
        wd_seg = np.zeros((len(uniq),), np.float32)
        for (lr, wd), i in uniq.items():
            lr_seg[i], wd_seg[i] = lr, wd
        sstate = self._sharded_state[spec.index]
        ordinals = tuple(uniq[lw] for lw in per_key)
        if sstate["idx_ordinals"] != ordinals:
            sstate["idx"] = self._build_idx(spec, ordinals)
            sstate["idx_ordinals"] = ordinals
        dev = self._coll().device
        return torch.from_numpy(lr_seg).to(dev), torch.from_numpy(wd_seg).to(dev)

    def _build_idx(self, spec, ordinals):
        """This worker's shard of the static per-element segment map."""
        if len(set(ordinals)) > 256:
            raise MXNetError("bucket %d has >256 distinct (lr,wd) segments" % spec.index)
        coll = self._coll()
        idx = np.zeros((spec.total,), np.int64)
        for s, o in zip(spec.slots, ordinals):
            idx[s.offset:s.offset + s.size] = o
        shard = spec.total // coll.n_workers
        return torch.from_numpy(idx[coll.rank * shard:(coll.rank + 1) * shard]).to(coll.device)

    def _apply_sharded(self, st, g_shard):
        """The flat update on this worker's shard, with the (lr, wd)
        segments of the round's dispatch, then the all-gather of the new
        weights; returns the bucket's full flat weight."""
        coll = self._coll()
        spec = st.spec
        sstate = self._sharded_state[spec.index]
        opt = self._kv._optimizer
        kind, hyper, _ = opt.flat_update_spec()
        lr_seg, wd_seg = st.segments
        idx = sstate["idx"]
        shard = spec.total // coll.n_workers
        lo = coll.rank * shard
        w = sstate["w_full"][lo:lo + shard]
        w_new, new_states = _FLAT_KERNELS[kind](hyper)(
            w, g_shard.to(w.dtype), sstate["states"], lr_seg[idx], wd_seg[idx])
        sstate["w_full"] = coll.all_gather(w_new)
        sstate["states"] = tuple(new_states)
        return sstate["w_full"]


def verify_digest_across_workers(payload: str, check_rounds: int, allgather) -> None:
    """Allgather a 4-byte sha1 of ``payload`` and require every rank to
    agree (the BucketEngine round/plan checks and the unbucketed
    ``KVStore._verify_push_round``)."""
    from . import dist

    if dist.num_workers() == 1:
        return
    digest = hashlib.sha1(payload.encode()).digest()[:4]
    mine = np.frombuffer(digest, dtype=np.uint32)
    theirs = np.asarray(allgather(mine)).reshape(-1)
    if not (theirs == mine[0]).all():
        bad = {int(r): hex(int(v)) for r, v in enumerate(theirs)}
        raise MXNetError(
            "dist KVStore workers disagree on the pushed key "
            "set/order this round (digest by rank: %s). Every worker "
            "must push the same keys in the same order — check for "
            "rank-dependent branches around kv.push. (Verified for the "
            "first %d rounds; set MXNET_KVSTORE_CHECK_STEPS to tune.)"
            % (bad, check_rounds))
