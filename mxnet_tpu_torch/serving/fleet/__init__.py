# copied from mxnet_tpu/serving/fleet/__init__.py (backend-free)
"""mxnet_tpu_torch.serving.fleet: the multi-replica serving tier
(docs/SERVING.md §Fleet).

The ``InferenceEngine`` is one process — one batcher, one queue, one
failure domain. This package composes the engine, the RPC layer,
heartbeats and telemetry into a replicated tier: a ``ReplicaSupervisor``
spawns and babysits N engine processes (heartbeat-file liveness,
capped-backoff restart), a
``Router`` load-balances requests over them by each replica's own
``health()`` EWMA queue-wait (skipping degraded/latched/stale replicas,
shedding with ``retry_after_ms`` when the whole fleet is saturated, and
RE-dispatching a dead replica's in-flight requests so nothing is lost),
and ``Router.rollout()`` applies a fleet-wide hitless weight swap one
drained replica at a time, aborting — with rollback — on any failed
swap. ``Fleet`` glues the two together:

    spec = {"model": "mlp", "item_shapes": {"data": [784]},
            "buckets": [1, 2, 4, 8], "params": "/path/params.npz"}
    with Fleet(spec, n_replicas=4) as fleet:
        out = fleet.router.infer({"data": batch})
        fleet.router.rollout(new_arg_params)       # hitless, fleet-wide

Chaos is a first-class input: ``fleet.dispatch`` / ``fleet.health`` /
``fleet.replica_spawn`` are deterministic fault-injection sites
(mxnet_tpu_torch/faultinject.py), and ``supervisor.kill_replica()`` is the
kill-one chaos vector ``serve_bench --fleet`` drives in CI.

Observability (docs/OBSERVABILITY.md §Fleet): the router mints a
``trace_id`` per request that RPC frames propagate into replica spans,
``Router.collect_fleet_trace()`` merges per-process chrome dumps onto
one clock-aligned timeline, ``Router.metrics()`` folds the replicas'
delta-encoded telemetry snapshots into fleet rollups (qps, shed rate,
merged latency histograms), and ``MXNET_SLO`` arms a burn-rate monitor
with structured violation events.
"""
from __future__ import annotations

from ...base import MXNetError
from .rpc import (RpcServer, RpcClient, RpcError, RpcConnectionError,
                  RpcRemoteError)
from .replica import (ReplicaApp, build_model, save_params_npz,
                      load_params_npz)
from .supervisor import ReplicaSupervisor, ReplicaHandle
from .router import Router, FleetRolloutError, FleetDispatchError

__all__ = ["Fleet", "Router", "ReplicaSupervisor", "ReplicaHandle",
           "ReplicaApp", "RpcServer", "RpcClient", "RpcError",
           "RpcConnectionError", "RpcRemoteError", "FleetRolloutError",
           "FleetDispatchError", "build_model", "save_params_npz",
           "load_params_npz"]


class Fleet:
    """Supervisor + router in one handle. ``start()`` spawns the
    replicas, waits for ``min_ready`` (default: all) to publish their
    RPC addresses, then starts the router over the supervisor's live
    address book — a restarted replica re-enters rotation as soon as the
    router's next health poll sees its fresh snapshot."""

    def __init__(self, spec, n_replicas=None, workdir=None,
                 min_ready=None, ready_timeout_s=240.0,
                 supervisor_kwargs=None, router_kwargs=None):
        self.supervisor = ReplicaSupervisor(
            spec, n_replicas=n_replicas, workdir=workdir,
            **(supervisor_kwargs or {}))
        self.router = Router(self.supervisor.addresses,
                             **(router_kwargs or {}))
        self.min_ready = (self.supervisor.n_replicas
                          if min_ready is None else int(min_ready))
        self.ready_timeout_s = float(ready_timeout_s)
        self._started = False

    def start(self):
        if self._started:
            return self
        self.supervisor.start()
        try:
            self.supervisor.wait_ready(self.min_ready,
                                       timeout_s=self.ready_timeout_s)
            self.router.start()
        except MXNetError:
            self.supervisor.stop()
            raise
        self._started = True
        return self

    def rollout(self, arg_params, aux_params=None, **kw):
        """Fleet-wide hitless rollout that CONVERGES across restarts.
        ``Router.rollout`` can only swap replicas it can see — one that
        died moments ago (or is mid-restart, having already loaded the
        OLD param file) would silently rejoin on old weights and leave
        the fleet mixed. This wrapper closes that hole: after the
        router-level rollout succeeds, the spec's param file is
        REWRITTEN with the new weights (every restart from now on loads
        them), and any replica the router did NOT swap is recycled
        through the supervisor (killed → auto-restarted onto the new
        file). Returns {"applied": [rids swapped live],
        "recycled": [rids restarted onto the new weights]}. An aborted
        router rollout propagates ``FleetRolloutError`` with the spec
        file untouched — old weights stay live fleet-wide."""
        from .replica import save_params_npz

        res = self.router.rollout(arg_params, aux_params, **kw)
        applied = set(res["applied"])
        save_params_npz(self.supervisor.base_spec["params"],
                        arg_params, aux_params)
        recycled = sorted(set(range(self.supervisor.n_replicas))
                          - applied)
        for rid in recycled:
            # dead/starting replicas loaded (or will load) a param file;
            # make sure it is the NEW one — a no-op kill on an
            # already-dead slot still respawns onto the rewritten file
            self.supervisor.kill_replica(rid)
        return {"applied": sorted(applied), "recycled": recycled}

    def metrics(self):
        """Fleet rollups (``Router.metrics()``)."""
        return self.router.metrics()

    def collect_fleet_trace(self):
        """Merged, clock-aligned fleet chrome trace
        (``Router.collect_fleet_trace()``)."""
        return self.router.collect_fleet_trace()

    def close(self):
        self.router.close()
        self.supervisor.stop()
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
