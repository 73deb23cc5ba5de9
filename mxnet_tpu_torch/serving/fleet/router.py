# copied from mxnet_tpu/serving/fleet/router.py (backend-free)
"""Front-end Router: load-aware dispatch over the replica tier
(docs/SERVING.md §Fleet has the architecture diagram and the
router-vs-replica failure-mode matrix).

Dispatch policy, in order:

* **Eligibility** — a replica is dispatchable only while its last health
  snapshot is FRESH (accepted within ``MXNET_FLEET_STALE_MS`` and passing
  the seq/snapshot_ms staleness check below) and its state is not
  ``latched``/``stopped``. ``degraded`` replicas are skipped whenever a
  healthy one exists (they still beat shedding when the whole fleet is
  degraded). Draining replicas (mid-rollout) are never picked.
* **Prefix affinity** — a request submitted with a ``prefix_key`` (the
  prompt's chunk-hash stem, docs/SERVING.md §Prefix cache) prefers the
  replica that rendezvous-hashing (HRW over the registered replica set)
  assigns that key: repeat prefixes keep landing where their KV pages
  are already cached. Affinity NEVER overrides eligibility — when the
  assigned replica is stale, unhealthy, draining, or already tried, the
  pick falls back to the load-aware EWMA policy below
  (``fleet.affinity_hits`` / ``fleet.affinity_fallbacks``). Disable
  with ``MXNET_FLEET_AFFINITY=0``.
* **Load-awareness** — among eligible replicas, lowest EWMA queue wait
  (each engine's own admission-control estimate, exported by
  ``health()``), tie-broken by the router's in-flight count then
  round-robin.
* **Shedding** — when the best eligible replica's wait estimate exceeds
  the request's deadline budget (or the absolute ``MXNET_FLEET_SHED_MS``
  cap), or when NO replica is eligible at all, the request is shed at
  admission with ``ServeOverloadError`` carrying ``retry_after_ms`` —
  the fleet-level analogue of the engine's EWMA shed.
* **Re-dispatch** — a transport failure mid-request (replica died, RPC
  timed out, injected ``fleet.dispatch`` fault) marks the replica
  suspect (its view is invalidated; the supervisor decides if it is
  really dead) and RE-dispatches the request to another replica, up to
  ``MXNET_FLEET_REDISPATCH`` times. Inference is idempotent, so replay
  is safe — a dead replica's in-flight requests are never lost.

Staleness: the router trusts a snapshot only if it proves the replica is
still answering — a new engine incarnation (pid change), a strictly
higher ``seq``, or a newer ``snapshot_ms``. A poll that merely re-reads
a dead replica's last-good numbers fails all three and is discarded
(``fleet.stale_health_discards``), so traffic never routes on a corpse's
flattering statistics.

Rollout: ``rollout(arg_params)`` applies a fleet-wide hitless weight swap
ONE replica at a time — drain it (stop picking it, wait in-flight → 0),
RPC ``reload`` (the engine's zero-retrace barrier swap), verify, move on.
Any failed swap ABORTS: already-swapped replicas are rolled back to the
snapshot their replica kept, so the fleet is never left serving mixed
weights — old weights stay live everywhere.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import uuid
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait as _fut_wait

from ...base import MXNetError
from ... import telemetry as _tm
from ...telemetry import histogram as _hg
from ...telemetry.slo import SloMonitor, SloSpec
from ... import faultinject as _fi
from ..engine import (ServeFuture, ServeOverloadError, ServeDeadlineError,
                      ServeClosedError, _env_float, _env_int)
from .rpc import RpcClient, RpcConnectionError

__all__ = ["Router", "FleetRolloutError", "FleetDispatchError"]

log = logging.getLogger("mxnet_tpu_torch.serving.fleet")


class FleetDispatchError(MXNetError):
    """Every eligible replica was tried and none could serve the request
    (the terminal form of the re-dispatch path)."""


class FleetRolloutError(MXNetError):
    """A fleet rollout aborted. ``result`` carries the per-replica
    outcome; old weights are live fleet-wide (already-swapped replicas
    were rolled back)."""

    def __init__(self, msg, result=None):
        super().__init__(msg)
        self.result = result or {}


class _View:
    """Router-side cache of one replica's last ACCEPTED health snapshot."""

    __slots__ = ("rid", "target", "health", "seq", "pid", "received_t")

    def __init__(self, rid, target):
        self.rid = rid
        self.target = target     # "host:port" or an in-process client
        self.health = None
        self.seq = -1
        self.pid = None
        self.received_t = 0.0    # perf_counter of last accepted snapshot


class _FleetRequest:
    __slots__ = ("inputs", "future", "t_enq", "deadline", "deadline_ms",
                 "tried", "redispatches", "trace_id", "prefix_key")

    def __init__(self, inputs, deadline=None, deadline_ms=None,
                 trace_id=None, prefix_key=None):
        self.inputs = inputs
        self.future = ServeFuture()
        self.t_enq = time.perf_counter()
        self.deadline = deadline          # absolute perf_counter or None
        self.deadline_ms = deadline_ms    # forwarded to the replica engine
        self.tried = set()
        self.redispatches = 0
        self.trace_id = trace_id          # router-minted request trace id
        self.prefix_key = prefix_key      # prefix-affinity routing key


class Router:
    """Load-aware request router over a set of replicas.

    ``provider`` is a zero-arg callable returning ``{replica_id:
    target}`` where target is either an ``"host:port"`` RPC address
    (``ReplicaSupervisor.addresses``) or any in-process object exposing
    the replica protocol (``infer``/``health``/``reload``/``rollback``
    RPC-handler signatures) — which is how the tests drive the router
    against fake replicas with scripted failure behavior.
    """

    def __init__(self, provider, workers=None, max_queue=None,
                 health_interval_ms=None, stale_ms=None, shed_ms=None,
                 max_redispatch=None, rpc_timeout_ms=None,
                 dispatch_wait_ms=None, deadline_ms=None, name="fleet",
                 slo=None):
        self.provider = provider
        self.name = name
        self.workers = (_env_int("MXNET_FLEET_WORKERS", 8)
                        if workers is None else int(workers))
        self.max_queue = (_env_int("MXNET_FLEET_MAX_QUEUE", 4096)
                          if max_queue is None else int(max_queue))
        self.health_interval_s = (
            _env_float("MXNET_FLEET_HEALTH_INTERVAL_MS", 100.0)
            if health_interval_ms is None
            else float(health_interval_ms)) / 1000.0
        self.stale_s = (_env_float("MXNET_FLEET_STALE_MS", 1000.0)
                        if stale_ms is None else float(stale_ms)) / 1000.0
        shed = (_env_float("MXNET_FLEET_SHED_MS", 0.0)
                if shed_ms is None else float(shed_ms))
        self.shed_cap_ms = shed if shed > 0 else None
        self.max_redispatch = (_env_int("MXNET_FLEET_REDISPATCH", 3)
                               if max_redispatch is None
                               else int(max_redispatch))
        self.rpc_timeout_s = (
            _env_float("MXNET_FLEET_RPC_TIMEOUT_MS", 30000.0)
            if rpc_timeout_ms is None else float(rpc_timeout_ms)) / 1000.0
        # how long a dispatch worker waits for SOME replica to become
        # eligible before failing the request (covers the window where
        # the only replica died and its restart is still warming)
        self.dispatch_wait_s = (
            _env_float("MXNET_FLEET_DISPATCH_WAIT_MS", 10000.0)
            if dispatch_wait_ms is None
            else float(dispatch_wait_ms)) / 1000.0
        dl = (_env_float("MXNET_FLEET_DEADLINE_MS", 0.0)
              if deadline_ms is None else float(deadline_ms))
        self.default_deadline_s = dl / 1000.0 if dl > 0 else None
        # prefix-affinity dispatch is on by default; it only engages for
        # requests that carry a prefix_key, so plain traffic is untouched
        self.affinity_enabled = os.environ.get(
            "MXNET_FLEET_AFFINITY", "1").strip().lower() \
            not in ("0", "off", "false", "no")
        self._views = {}
        self._inflight = {}
        self._draining = set()
        self._poll_pool = None     # per-replica poll concurrency; start()
        self._poll_pending = set()  # rids with an in-flight poll
        self._rr = 0
        self._queue = deque()
        self._cond = _tm.named_condition("fleet.router.queue")
        self._stop = False
        self._started = False
        self._threads = []
        self._tls = threading.local()
        self._counts = {"submitted": 0, "completed": 0, "shed": 0,
                        "redispatched": 0, "failed": 0}
        self._rollout_lock = _tm.named_lock("fleet.router.rollout")
        # ---- fleet observability plane (docs/OBSERVABILITY.md §Fleet)
        self._t_start = None
        # router's own request-latency histogram, recorded regardless of
        # telemetry mode so SLO latency objectives and the metrics()
        # rollup always have truth (one bucket increment per delivery)
        self._req_hist = _hg.Histogram()
        self._tel_lock = _tm.named_lock("fleet.router.telemetry")
        self._fleet_counters = {}      # folded replica counter deltas
        self._fleet_hists = {}         # timer -> merged sparse buckets
        self._replica_tel = {}         # rid -> {"counters", "dropped"}
        self._per_replica_done = {}    # rid -> deliveries via this router
        self._clock_offsets = {}       # rid -> (offset_s, remote_pid)
        # SLO gate: explicit spec (SloSpec | spec string) wins; else the
        # MXNET_SLO env; else no monitor
        if slo is not None and not isinstance(slo, SloSpec):
            slo = SloSpec.parse(slo)
        self._slo_spec = slo if slo is not None else SloSpec.from_env()
        self._slo_monitor = (SloMonitor(self._slo_spec)
                             if self._slo_spec is not None else None)
        self._slo_last = {"completed": 0, "failed": 0, "buckets": {}}
        self._slo_status = None

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._started:
            return self
        with self._cond:
            self._stop = False
        if self._t_start is None:
            self._t_start = time.perf_counter()
        self._poll_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="%s-health" % self.name)
        self._poll_once(wait_s=5.0)  # seed views before accepting traffic
        t = threading.Thread(target=self._poll_loop,
                             name="%s-health-poller" % self.name,
                             daemon=True)
        t.start()
        self._threads = [t]
        for i in range(self.workers):
            w = threading.Thread(target=self._worker_loop,
                                 name="%s-dispatch-%d" % (self.name, i),
                                 daemon=True)
            w.start()
            self._threads.append(w)
        with self._cond:
            self._started = True
        return self

    def close(self):
        with self._cond:
            self._stop = True
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for r in pending:
            if not r.future.done():
                r.future.set_error(ServeClosedError(
                    "fleet: router closed before this request was "
                    "dispatched"))
        for t in self._threads:
            t.join(timeout=2.0)
        with self._cond:
            if self._poll_pool is not None:
                self._poll_pool.shutdown(wait=False)
                self._poll_pool = None
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------------- clients
    def _client(self, view: _View):
        """Per-worker-thread client for a replica target. In-process
        targets (test fakes) are used directly; addresses get one
        ``RpcClient`` per (worker thread, address) so concurrent requests
        to one replica pipeline over separate connections."""
        if not isinstance(view.target, str):
            return view.target
        cache = getattr(self._tls, "clients", None)
        if cache is None:
            cache = self._tls.clients = {}
        key = (view.rid, view.target)
        cli = cache.get(key)
        if cli is None:
            # drop clients for dead incarnations of this replica id
            for k in [k for k in cache if k[0] == view.rid and k != key]:
                cache.pop(k).close()
            cli = cache[key] = RpcClient(view.target,
                                         timeout_s=self.rpc_timeout_s)
        return cli

    @staticmethod
    def _call(client, method, rpc_timeout_s=None, **kw):
        """Uniform invocation for RPC clients and in-process fakes.
        ``rpc_timeout_s`` bounds the SOCKET wait (RPC targets only);
        everything in ``kw`` — including a handler-side ``timeout_s`` —
        reaches the replica method on both paths, so tests exercise the
        same call contract production does."""
        if isinstance(client, RpcClient):
            return client.call(method, rpc_timeout_s=rpc_timeout_s, **kw)
        return getattr(client, method)(**kw)

    # -------------------------------------------------------- health views
    def _accept_snapshot(self, view: _View, h, now):
        """The staleness contract: accept only a snapshot that proves the
        replica answered — new incarnation (pid), higher seq, or newer
        snapshot_ms. Anything else is a replay of last-good numbers."""
        seq = h.get("seq", 0)
        pid = h.get("pid")
        prev = view.health
        fresh_incarnation = pid is not None and pid != view.pid
        if prev is not None and not fresh_incarnation:
            if seq <= view.seq and \
                    h.get("snapshot_ms", 0) <= prev.get("snapshot_ms", 0):
                if _tm.enabled():
                    _tm.counter("fleet.stale_health_discards").inc()
                return False
        view.health = h
        view.seq = seq
        view.pid = pid
        view.received_t = now
        return True

    def _poll_once(self, wait_s=None):
        """One poll round: each replica polled on its OWN pool task, so a
        wedged replica (slow/hung health RPC) costs itself freshness but
        can never stale the rest of the fleet's views. A replica whose
        previous poll is still in flight is skipped, so a hang cannot
        pile up tasks either. ``wait_s`` blocks for the round's results
        (the start() seed and the rollout refresh want settled views)."""
        try:
            targets = dict(self.provider())
        except Exception as exc:
            log.warning("fleet: replica provider failed: %s", exc)
            return
        with self._cond:
            for rid in list(self._views):
                if rid not in targets:
                    del self._views[rid]
            for rid, target in targets.items():
                v = self._views.get(rid)
                if v is None or v.target != target:
                    self._views[rid] = _View(rid, target)
            views = [v for v in self._views.values()
                     if v.rid not in self._poll_pending]
            for v in views:
                self._poll_pending.add(v.rid)
        pool = self._poll_pool
        if pool is None:  # pre-start probe: poll inline
            for v in views:
                self._poll_replica(v)
            return
        futs = [pool.submit(self._poll_replica, v) for v in views]
        if wait_s is not None and futs:
            _fut_wait(futs, timeout=wait_s)

    def _poll_replica(self, v: _View):
        if _tm.enabled():
            _tm.counter("fleet.health_polls").inc()
        try:
            _fi.fire("fleet.health")
            # RPC timeout well under the rpc default: a slow replica's
            # snapshot just ages out, it must not tie up a poll slot
            cli = self._client(v)
            h = self._call(cli, "health",
                           rpc_timeout_s=min(5.0, max(0.5, self.stale_s)))
        except Exception:
            if _tm.enabled():
                _tm.counter("fleet.health_poll_errors").inc()
            with self._cond:
                self._poll_pending.discard(v.rid)
            return  # view ages out; staleness does the skipping
        if isinstance(cli, RpcClient) and cli.clock_offset_s is not None:
            with self._tel_lock:
                self._clock_offsets[v.rid] = (cli.clock_offset_s,
                                              cli.remote_pid)
        now = time.perf_counter()
        with self._cond:
            self._poll_pending.discard(v.rid)
            accepted = (self._views.get(v.rid) is v
                        and self._accept_snapshot(v, h, now))
            if accepted:
                if _tm.enabled():
                    _tm.gauge("fleet.replica.%s.queue_wait_ms"
                              % v.rid).set(
                        h.get("ewma_queue_wait_ms") or 0.0)
                self._cond.notify_all()
        if accepted and h.get("telemetry"):
            self._fold_telemetry(v.rid, h["telemetry"])

    def _fold_telemetry(self, rid, tel):
        """Fold one ACCEPTED delta-encoded replica snapshot into the
        fleet rollups. The staleness contract guarantees each snapshot
        folds at most once (every health() gets a fresh seq; replays are
        discarded before reaching here), so counters stay exact and
        histogram merges stay associative."""
        with self._tel_lock:
            for k, dv in (tel.get("counters") or {}).items():
                if isinstance(dv, (int, float)):
                    self._fleet_counters[k] = \
                        self._fleet_counters.get(k, 0) + dv
            for name, db in (tel.get("hist") or {}).items():
                self._fleet_hists[name] = _hg.merge_bucket_maps(
                    self._fleet_hists.get(name), db)
            per = self._replica_tel.setdefault(
                rid, {"counters": {}, "dropped": 0})
            for k, dv in (tel.get("counters") or {}).items():
                if isinstance(dv, (int, float)):
                    per["counters"][k] = per["counters"].get(k, 0) + dv
            per["dropped"] = tel.get("dropped", per["dropped"])

    def _poll_loop(self):
        while not self._stop:
            t0 = time.perf_counter()
            self._poll_once()
            if self._slo_monitor is not None:
                self._slo_tick()
            delay = self.health_interval_s - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)

    def _slo_tick(self):
        """One SLO sample per poll round: request/error deltas since the
        last tick, the request-latency bucket delta, and an availability
        sample (any eligible replica?). Sheds are admission control, not
        server errors — they hit availability/throughput, not err_pct."""
        now = time.perf_counter()
        with self._cond:
            completed = self._counts["completed"]
            failed = self._counts["failed"]
            avail = 1.0 if self._eligible_locked(now) else 0.0
        buckets = self._req_hist.to_dict()["buckets"]
        last = self._slo_last
        d_done = completed - last["completed"]
        d_fail = failed - last["failed"]
        db = {k: v - last["buckets"].get(k, 0) for k, v in buckets.items()
              if v - last["buckets"].get(k, 0) > 0}
        self._slo_last = {"completed": completed, "failed": failed,
                          "buckets": buckets}
        self._slo_monitor.observe(total=d_done + d_fail, errors=d_fail,
                                  latency_buckets=db, available=avail)
        self._slo_status = self._slo_monitor.evaluate()

    def _invalidate(self, rid):
        """Mark a replica suspect after a transport fault: its view goes
        stale immediately so no new request picks it until a FRESH
        snapshot proves it back."""
        with self._cond:
            v = self._views.get(rid)
            if v is not None:
                v.received_t = 0.0

    # ------------------------------------------------------------- picking
    def _eligible_locked(self, now, exclude=()):
        healthy, degraded = [], []
        for v in self._views.values():
            if v.rid in exclude or v.rid in self._draining:
                continue
            if v.health is None or now - v.received_t > self.stale_s:
                continue
            state = v.health.get("state")
            if state == "healthy":
                healthy.append(v)
            elif state == "degraded":
                degraded.append(v)
        return healthy if healthy else degraded

    def _affinity_target(self, prefix_key):
        """Rendezvous (HRW) hash over the REGISTERED replica set: every
        router instance maps a prefix key to the same replica without
        coordination, and a membership change only remaps the keys that
        hashed to the departed replica. md5, not ``hash()`` — Python's
        string hash is per-process salted and would shatter the
        cross-router agreement this exists for."""
        best, best_score = None, None
        for rid in self._views:
            score = hashlib.md5(
                ("%s|%s" % (prefix_key, rid)).encode()).hexdigest()
            if best_score is None or score > best_score:
                best, best_score = rid, score
        return best

    def _pick_locked(self, now, exclude=(), prefix_key=None):
        """(view, est_wait_ms) of the best eligible replica, or (None,
        None). A prefix_key prefers its rendezvous-assigned replica IF
        that replica is currently eligible; otherwise — and for plain
        requests — lowest EWMA queue wait wins; in-flight count then
        round-robin break ties."""
        cands = self._eligible_locked(now, exclude)
        if not cands:
            return None, None
        if prefix_key is not None and self.affinity_enabled:
            target = self._affinity_target(prefix_key)
            for v in cands:
                if v.rid == target:
                    if _tm.enabled():
                        _tm.counter("fleet.affinity_hits").inc()
                    return v, v.health.get("ewma_queue_wait_ms") or 0.0
            # assigned replica is stale/unhealthy/draining/excluded:
            # health and freshness rules outrank page locality
            if _tm.enabled():
                _tm.counter("fleet.affinity_fallbacks").inc()
        self._rr += 1
        best, best_key = None, None
        for i, v in enumerate(cands):
            est = v.health.get("ewma_queue_wait_ms") or 0.0
            key = (round(est, 1), self._inflight.get(v.rid, 0),
                   (i + self._rr) % len(cands))
            if best_key is None or key < best_key:
                best, best_key = v, key
        return best, best.health.get("ewma_queue_wait_ms") or 0.0

    # -------------------------------------------------------------- submit
    def submit(self, inputs, deadline_ms=None,
               prefix_key=None) -> ServeFuture:
        """Enqueue one request for load-aware dispatch; returns a
        ``ServeFuture``. Sheds at admission (``ServeOverloadError`` with
        ``retry_after_ms``) when no replica is eligible or the best
        replica's wait estimate exceeds the deadline budget / shed cap.
        ``prefix_key`` (any stable string — normally the prompt's prefix
        chunk hash) opts the request into affinity dispatch: repeat
        keys land on the replica whose KV pages already hold them."""
        if deadline_ms is None and self.default_deadline_s is not None:
            deadline_ms = self.default_deadline_s * 1000.0
        dl_s = (float(deadline_ms) / 1000.0
                if deadline_ms and float(deadline_ms) > 0 else None)
        now = time.perf_counter()
        with self._cond:
            if self._stop or not self._started:
                raise MXNetError("fleet: router is not running")
            _, est = self._pick_locked(now)
            if est is None:
                self._counts["shed"] += 1
                shed_err = ServeOverloadError(
                    "fleet: no replica eligible (all dead, latched, "
                    "stale, or draining); retry after ~%dms"
                    % int(self.stale_s * 1000),
                    retry_after_ms=int(self.stale_s * 1000))
            elif (dl_s is not None and est > dl_s * 1000.0) or \
                    (self.shed_cap_ms is not None
                     and est > self.shed_cap_ms):
                self._counts["shed"] += 1
                shed_err = ServeOverloadError(
                    "fleet: saturated — best replica's queue-wait "
                    "estimate %.1fms exceeds %s; retry after ~%dms"
                    % (est,
                       "the %.0fms deadline" % (dl_s * 1000.0)
                       if dl_s is not None and est > dl_s * 1000.0
                       else "the %.0fms shed cap" % self.shed_cap_ms,
                       max(1, int(est))),
                    retry_after_ms=max(1, int(est)))
            elif len(self._queue) >= self.max_queue:
                # queue-full IS saturation backpressure: same error type
                # (and retry hint) as the estimate-driven shed, so
                # clients back off uniformly
                self._counts["shed"] += 1
                shed_err = ServeOverloadError(
                    "fleet: router queue full (%d requests); retry "
                    "after ~%dms" % (len(self._queue),
                                     max(1, int(est or 100))),
                    retry_after_ms=max(1, int(est or 100)))
            else:
                shed_err = None
            if shed_err is not None:
                if _tm.enabled():
                    _tm.counter("fleet.sheds").inc()
                raise shed_err
            req = _FleetRequest(
                inputs,
                deadline=None if dl_s is None else now + dl_s,
                deadline_ms=deadline_ms,
                # trace_id minted at admission (trace mode only): every
                # span this request touches — router dispatch, RPC frame,
                # replica engine/decoder — inherits it
                trace_id=(uuid.uuid4().hex[:16] if _tm.tracing()
                          else None),
                prefix_key=prefix_key)
            self._queue.append(req)
            self._counts["submitted"] += 1
            depth = len(self._queue)
            self._cond.notify_all()
        if _tm.enabled():
            _tm.gauge("fleet.queue_depth").set(depth)
        return req.future

    def infer(self, inputs, timeout=60.0, deadline_ms=None,
              prefix_key=None):
        return self.submit(inputs, deadline_ms=deadline_ms,
                           prefix_key=prefix_key).result(timeout=timeout)

    # ------------------------------------------------------------ dispatch
    def _worker_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(0.2)
                if self._stop:
                    return
                req = self._queue.popleft()
            try:
                self._dispatch_one(req)
            except BaseException as exc:  # a worker must never die silent
                if not req.future.done():
                    req.future.set_error(exc)

    def _dispatch_one(self, req: _FleetRequest):
        overload = None
        wait_deadline = req.t_enq + self.dispatch_wait_s
        while True:
            now = time.perf_counter()
            if req.deadline is not None and now >= req.deadline:
                req.future.set_error(ServeDeadlineError(
                    "fleet: deadline expired after %.1fms in the router "
                    "(%d dispatch attempt(s))"
                    % ((now - req.t_enq) * 1000.0, len(req.tried)),
                    queued_ms=(now - req.t_enq) * 1000.0))
                if _tm.enabled():
                    _tm.counter("fleet.deadline_expired").inc()
                return
            with self._cond:
                view, _ = self._pick_locked(now, exclude=req.tried,
                                            prefix_key=req.prefix_key)
                if view is None and req.tried:
                    # every replica tried once: forget the exclusions and
                    # allow a retried replica a second look (it may have
                    # recovered) as long as redispatch budget remains
                    view, _ = self._pick_locked(
                        now, prefix_key=req.prefix_key)
                if view is not None:
                    self._inflight[view.rid] = \
                        self._inflight.get(view.rid, 0) + 1
            if view is None:
                if now >= wait_deadline:
                    if overload is not None:
                        # the last word was a replica shed: this is
                        # saturation backpressure, not a dispatch failure
                        req.future.set_error(overload)
                        with self._cond:
                            self._counts["shed"] += 1
                        if _tm.enabled():
                            _tm.counter("fleet.sheds").inc()
                    else:
                        req.future.set_error(FleetDispatchError(
                            "fleet: no replica became eligible within "
                            "%.1fs (%d tried)" % (self.dispatch_wait_s,
                                                  len(req.tried))))
                        self._count_fail()
                    return
                time.sleep(min(0.05, self.health_interval_s))
                continue
            rid = view.rid
            req.tried.add(rid)
            try:
                timeout_s = self.rpc_timeout_s
                if req.deadline is not None:
                    timeout_s = min(timeout_s,
                                    max(0.05, req.deadline - now) + 5.0)
                # the time this request sat in the ROUTER queue, as a
                # trace span (start was observed on the submit thread)
                _tm.record_span("fleet.queue_wait", req.t_enq,
                                now - req.t_enq, trace_id=req.trace_id,
                                replica=rid)
                with _tm.trace_scope(req.trace_id), \
                        _tm.span("fleet.dispatch", replica=rid):
                    _fi.fire("fleet.dispatch")
                    # timeout_s is the REPLICA-side result wait; the
                    # socket bound sits strictly above it so the remote
                    # timeout error (not a transport cut) comes back
                    outs = self._call(self._client(view), "infer",
                                      rpc_timeout_s=timeout_s + 5.0,
                                      inputs=req.inputs,
                                      deadline_ms=req.deadline_ms,
                                      timeout_s=timeout_s)
            except (RpcConnectionError, _fi.FaultInjected, OSError) as exc:
                # transport-class fault: replica suspect; re-dispatch
                self._invalidate(rid)
                if req.redispatches < self.max_redispatch:
                    req.redispatches += 1
                    with self._cond:
                        self._counts["redispatched"] += 1
                    if _tm.enabled():
                        _tm.counter("fleet.redispatches").inc()
                    log.info("fleet: re-dispatching after fault on "
                             "replica %s (%s)", rid, exc)
                    continue
                req.future.set_error(FleetDispatchError(
                    "fleet: request failed after %d re-dispatches; last "
                    "replica %s fault: %s" % (req.redispatches, rid, exc)))
                self._count_fail()
                return
            except ServeOverloadError as exc:
                overload = exc  # that replica is saturated; try another
                if _tm.enabled():
                    _tm.counter("fleet.replica_overloads").inc()
                with self._cond:
                    untried = [v.rid for v in self._eligible_locked(
                        time.perf_counter()) if v.rid not in req.tried]
                if not untried:
                    # the WHOLE eligible fleet shed this request: the
                    # saturation is global — propagate the shed (with its
                    # retry_after_ms) instead of spinning on hot replicas
                    req.future.set_error(exc)
                    with self._cond:
                        self._counts["shed"] += 1
                    if _tm.enabled():
                        _tm.counter("fleet.sheds").inc()
                    return
                continue
            except ServeDeadlineError as exc:
                req.future.set_error(exc)  # terminal: the budget is spent
                if _tm.enabled():
                    _tm.counter("fleet.deadline_expired").inc()
                return
            except Exception as exc:
                # non-transport failure (validation, latched engine...):
                # terminal — replaying a request the replica REJECTED
                # would loop forever
                req.future.set_error(exc)
                self._count_fail()
                return
            finally:
                with self._cond:
                    n = self._inflight.get(rid, 1) - 1
                    self._inflight[rid] = max(0, n)
                    self._cond.notify_all()
            # books BEFORE the future resolves: a client that wakes on
            # set_result and immediately reads health() must already see
            # this delivery counted
            dur = time.perf_counter() - req.t_enq
            self._req_hist.record(dur)
            with self._cond:
                self._counts["completed"] += 1
            with self._tel_lock:
                self._per_replica_done[rid] = \
                    self._per_replica_done.get(rid, 0) + 1
            req.future.set_result(outs)
            if _tm.enabled():
                _tm.counter("fleet.dispatches").inc()
                _tm.timer("fleet.request").add(dur)
            return

    def _count_fail(self):
        with self._cond:
            self._counts["failed"] += 1
        if _tm.enabled():
            _tm.counter("fleet.dispatch_failures").inc()

    # ------------------------------------------------------------- rollout
    def rollout(self, arg_params, aux_params=None, drain_timeout_s=30.0,
                reload_timeout_s=120.0):
        """Fleet-wide hitless weight rollout, one replica at a time:
        drain → reload → verify → next. Returns {"applied": [rids],
        "skipped": [rids]} on success. On ANY failed swap the rollout
        ABORTS: replicas already swapped are rolled back (each kept its
        pre-swap snapshot), and ``FleetRolloutError`` is raised — old
        weights stay live fleet-wide. Replicas that are not currently
        eligible (dead/restarting) are SKIPPED, not failed: they reload
        from their spec's param file on restart, and the caller decides
        whether a partial fleet is acceptable (the result lists them)."""
        if not self._rollout_lock.acquire(blocking=False):
            raise FleetRolloutError("fleet: a rollout is already running")
        try:
            with _tm.span("fleet.rollout"):
                return self._rollout_locked(arg_params, aux_params,
                                            drain_timeout_s,
                                            reload_timeout_s)
        finally:
            self._rollout_lock.release()

    def _rollout_locked(self, arg_params, aux_params, drain_timeout_s,
                        reload_timeout_s):
        # refresh the fleet view NOW: a replica invalidated moments ago by
        # a transport blip (but alive) must be rolled out, not skipped
        self._poll_once(wait_s=3.0)
        now = time.perf_counter()
        with self._cond:
            targets = [v.rid for v in self._views.values()
                       if v.health is not None
                       and now - v.received_t <= self.stale_s]
            all_known = set(self._views)
        applied, skipped = [], sorted(all_known - set(targets))
        failure = None
        for rid in sorted(targets):
            with self._cond:
                self._draining.add(rid)
            try:
                if not self._wait_drained(rid, drain_timeout_s):
                    failure = (rid, MXNetError(
                        "fleet: replica %s did not drain within %.0fs"
                        % (rid, drain_timeout_s)))
                    break
                view = self._views.get(rid)
                if view is None:
                    skipped.append(rid)
                    continue
                ok = self._call(self._client(view), "reload",
                                rpc_timeout_s=reload_timeout_s + 10.0,
                                arg_params=arg_params,
                                aux_params=aux_params,
                                timeout_s=reload_timeout_s)
                if not ok:
                    failure = (rid, MXNetError(
                        "fleet: replica %s reload returned %r"
                        % (rid, ok)))
                    break
                applied.append(rid)
                if _tm.enabled():
                    _tm.counter("fleet.rollout_replicas").inc()
            except Exception as exc:
                failure = (rid, exc)
                break
            finally:
                with self._cond:
                    self._draining.discard(rid)
        if failure is None:
            if _tm.enabled():
                _tm.counter("fleet.rollouts").inc()
            return {"applied": applied, "skipped": skipped}
        # ---- abort: restore old weights on every already-swapped replica
        bad_rid, exc = failure
        rollback_failed = []
        for rid in applied:
            view = self._views.get(rid)
            try:
                if view is None:
                    raise MXNetError("replica %s vanished" % rid)
                self._call(self._client(view), "rollback",
                           rpc_timeout_s=reload_timeout_s + 10.0,
                           timeout_s=reload_timeout_s)
            except Exception as rexc:
                rollback_failed.append((rid, str(rexc)))
        if _tm.enabled():
            _tm.counter("fleet.rollout_aborts").inc()
        result = {"applied": [], "skipped": skipped,
                  "failed_replica": bad_rid,
                  "rolled_back": [r for r in applied
                                  if r not in
                                  [x[0] for x in rollback_failed]],
                  "rollback_failed": rollback_failed}
        raise FleetRolloutError(
            "fleet: rollout aborted at replica %s (%s: %s); %d "
            "already-swapped replica(s) rolled back to old weights%s"
            % (bad_rid, type(exc).__name__, exc, len(applied)
               - len(rollback_failed),
               "" if not rollback_failed else
               "; ROLLBACK FAILED on %s — restart those replicas"
               % [x[0] for x in rollback_failed]),
            result=result)

    def _wait_drained(self, rid, timeout_s):
        deadline = time.perf_counter() + timeout_s
        with self._cond:
            while self._inflight.get(rid, 0) > 0:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.2))
        return True

    # ------------------------------------------------------------- metrics
    def metrics(self):
        """Fleet-wide observability rollup (docs/OBSERVABILITY.md §Fleet):
        router books (qps, shed rate, redispatches), replica telemetry
        folded from the delta-encoded health() snapshots (counters +
        merged latency histograms with p50/p95/p99), per-replica rows
        with measured clock offsets, and — when an SLO spec is live —
        the burn-rate status and structured violation log. JSON-safe;
        ``serve_bench --fleet`` stamps it into the trace dump's
        ``otherData.fleet`` for ``mxtrace --fleet``."""
        now = time.perf_counter()
        with self._cond:
            counts = dict(self._counts)
            views = dict(self._views)
            fresh = [rid for rid, v in views.items()
                     if v.health is not None
                     and now - v.received_t <= self.stale_s]
        elapsed = max(1e-9, now - (self._t_start or now))
        with self._tel_lock:
            fleet_counters = dict(self._fleet_counters)
            fleet_hists = {k: dict(v)
                           for k, v in self._fleet_hists.items()}
            per_tel = {rid: {"counters": dict(d["counters"]),
                             "dropped": d.get("dropped", 0)}
                       for rid, d in self._replica_tel.items()}
            per_done = dict(self._per_replica_done)
            offsets = dict(self._clock_offsets)
        # the router's own request-latency histogram IS the fleet view of
        # submit→delivery (it brackets queue + rpc + replica service)
        fleet_hists["fleet.request"] = _hg.merge_bucket_maps(
            fleet_hists.get("fleet.request"),
            self._req_hist.to_dict()["buckets"])
        latency = {}
        for name, b in sorted(fleet_hists.items()):
            if not b:
                continue
            q = _hg.quantiles_from_buckets(b)
            latency[name] = {"count": sum(b.values()),
                             "p50": round(q.get("p50", 0.0), 3),
                             "p95": round(q.get("p95", 0.0), 3),
                             "p99": round(q.get("p99", 0.0), 3)}
        tokens = fleet_counters.get("serving.decode_tokens", 0)
        dispatches = (fleet_counters.get("serving.megasteps", 0)
                      or fleet_counters.get("serving.dispatches", 0))
        replicas = {}
        for rid, v in sorted(views.items()):
            off = offsets.get(rid)
            done = per_done.get(rid, 0)
            replicas[str(rid)] = {
                "state": (v.health or {}).get("state", "unknown"),
                "requests": done, "qps": round(done / elapsed, 3),
                "clock_offset_ms": round(
                    (off[0] if off else 0.0) * 1000.0, 3),
                "dropped": per_tel.get(rid, {}).get("dropped", 0)}
        attempts = counts["submitted"] + counts["shed"]
        out = {"qps": round(counts["completed"] / elapsed, 3),
               "requests": counts["completed"],
               "errors": counts["failed"],
               "shed": counts["shed"],
               "shed_rate": round(counts["shed"] / attempts, 4)
               if attempts else 0.0,
               "redispatches": counts["redispatched"],
               "submitted": counts["submitted"],
               "replicas_fresh": len(fresh),
               "tokens_per_dispatch": round(tokens / dispatches, 3)
               if tokens and dispatches else None,
               "elapsed_s": round(elapsed, 3),
               "latency_ms": latency,
               "counters": fleet_counters,
               "replicas": replicas,
               "dropped_events": (_tm.dropped_events()
                                  + sum(d.get("dropped", 0)
                                        for d in per_tel.values()))}
        if self._slo_monitor is not None:
            out["slo"] = self._slo_status or self._slo_monitor.evaluate()
            out["violations"] = self._slo_monitor.violations()
        return out

    def slo_violations(self):
        """Structured slo.violation/slo.clear events, oldest first
        (empty without an SLO spec)."""
        return ([] if self._slo_monitor is None
                else self._slo_monitor.violations())

    def collect_fleet_trace(self):
        """ONE merged fleet chrome trace: the router's own dump plus each
        reachable replica's (``dump_trace`` RPC), re-pidded and aligned
        onto the router's wall clock via the per-connection midpoint
        offsets. ``otherData.fleet`` carries ``metrics()``; unreachable
        replicas are skipped with a log line (their spans simply don't
        appear — the trace stays honest about ``dropped``)."""
        with self._cond:
            views = list(self._views.values())
        with self._tel_lock:
            off_by_rid = dict(self._clock_offsets)
        dumps = [_tm.build_trace(extra={"label": "router"})]
        labels = {os.getpid(): "router"}
        offsets = {}
        for v in views:
            try:
                d = self._call(self._client(v), "dump_trace",
                               rpc_timeout_s=10.0)
            except Exception as exc:
                log.warning("fleet: dump_trace from replica %s failed: "
                            "%s", v.rid, exc)
                continue
            if not isinstance(d, dict):
                continue
            pid = (d.get("otherData") or {}).get("pid")
            off = off_by_rid.get(v.rid)
            if pid is not None:
                labels[pid] = "replica-%s" % v.rid
                if off is not None:
                    offsets[pid] = off[0]
            dumps.append(d)
        merged = _tm.merge_traces(dumps, offsets_s=offsets,
                                  labels=labels)
        merged["otherData"]["fleet"] = self.metrics()
        return merged

    # -------------------------------------------------------------- health
    def health(self):
        """Aggregate fleet snapshot: per-replica state/freshness/wait +
        router counters."""
        now = time.perf_counter()
        with self._cond:
            reps = {}
            for rid, v in sorted(self._views.items()):
                fresh = (v.health is not None
                         and now - v.received_t <= self.stale_s)
                reps[rid] = {
                    "state": (v.health or {}).get("state", "unknown"),
                    "fresh": fresh,
                    "ewma_queue_wait_ms":
                        (v.health or {}).get("ewma_queue_wait_ms"),
                    "inflight": self._inflight.get(rid, 0),
                    "draining": rid in self._draining,
                }
            counts = dict(self._counts)
        eligible = [r for r, d in reps.items()
                    if d["fresh"] and not d["draining"]
                    and d["state"] in ("healthy", "degraded")]
        state = ("healthy" if any(reps[r]["state"] == "healthy"
                                  for r in eligible)
                 else "degraded" if eligible else "unavailable")
        return {"state": state, "replicas": reps,
                "eligible": len(eligible), "counts": counts}
