# copied from mxnet_tpu/serving/fleet/replica.py (backend-free); the engine is the port's
"""Replica worker process: ONE InferenceEngine behind an RPC endpoint
(docs/SERVING.md §Fleet).

Launched by ``ReplicaSupervisor`` as ``python -m
mxnet_tpu_torch.serving.fleet.replica <spec.json>``. The spec names the model,
its per-item input shapes, the bucket ladder, and a ``.npz`` of trained
params; the process builds the model, warms + seals its executable cache,
starts the RPC server on an OS-assigned loopback port, and only THEN
commits its address to ``port_file`` (atomic write) — so the supervisor
never routes to a replica that has not finished compiling. Liveness is a
heartbeat file touched on a timer (the ps-lite idiom: mtime IS the
signal; a wedged process stops touching it even though the PID exists).

RPC surface: ``ping`` / ``infer`` / ``health`` / ``reload`` /
``rollback`` / ``stop`` / ``dump_trace``. ``health`` additionally ships
a delta-encoded telemetry snapshot (counter + histogram-bucket
increments keyed to the engine seq) the router folds into fleet
rollups; ``dump_trace`` returns this process's chrome-trace dict for
``telemetry.merge_traces``. ``reload`` snapshots the prior values of every
key it is about to swap before applying the engine's hitless
``reload()`` — ``rollback`` restores that snapshot, which is what lets
the router abort a fleet-wide rollout and leave the OLD weights live
everywhere even on replicas that had already swapped.

In the port each replica process binds the default context, ``gpu(0)``,
with a CUDA context and a caching allocator of its own; replicas on one
card time-slice it. A host without CUDA fails the replica at start (its
breadcrumb on stderr), unless ``MXNET_DEFAULT_CONTEXT=cpu`` asks for the
CPU. ``infer`` returns the engine's numpy rows, never a tensor, so nothing
on the wire touches CUDA in the router's process; ``reload`` and
``rollback`` ``copy_`` into the tensors the bound executors read
(``PersistentExecutableCache.swap_params``), so a swap binds nothing.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading

import numpy as np

from ... import telemetry
from ...base import MXNetError
from .rpc import RpcServer

__all__ = ["ReplicaApp", "build_model", "save_params_npz",
           "load_params_npz", "main"]

_AUX_PREFIX = "aux:"


def _host(v):
    """A numpy copy of a numpy array, an NDArray or a tensor on any device."""
    if hasattr(v, "asnumpy"):
        return np.asarray(v.asnumpy())
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_params_npz(path, arg_params, aux_params=None):
    """Persist {name: array} arg/aux params into one npz the replica spec
    points at (aux keys carry an ``aux:`` prefix). The file is the
    reference's: either package reads what the other wrote."""
    flat = {n: _host(v) for n, v in (arg_params or {}).items()}
    for n, v in (aux_params or {}).items():
        flat[_AUX_PREFIX + n] = _host(v)
    np.savez(path, **flat)


def load_params_npz(path):
    with np.load(path) as z:
        arg, aux = {}, {}
        for n in z.files:
            if n.startswith(_AUX_PREFIX):
                aux[n[len(_AUX_PREFIX):]] = z[n]
            else:
                arg[n] = z[n]
    return arg, aux


def build_model(name, **kwargs):
    """Model-zoo symbol for a serving replica (mirrors serve_bench's
    model construction so the bench and the fleet agree on it)."""
    from ... import models

    return models.get_symbol(name, **kwargs)


def _atomic_write(path, text):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class ReplicaApp:
    """The replica process body; separable from ``main`` so tests can run
    a replica in-process (the serve_bench fleet harness uses real
    subprocesses)."""

    def __init__(self, spec):
        self.spec = spec
        self.replica_id = spec.get("replica_id", 0)
        self.engine = None
        self.server = None
        self._stop = threading.Event()
        self._hb_thread = None
        self._rollback_args = None
        self._rollback_aux = None
        # delta-encoding state for the health() telemetry snapshot: the
        # counter values / histogram buckets already shipped, so each
        # snapshot carries only the increment since the last one
        self._tel_lock = telemetry.named_lock("fleet.replica.telemetry")
        self._tel_last_counters = {}
        self._tel_last_buckets = {}

    # ------------------------------------------------------------- assembly
    def _build_engine(self):
        from ..cache import PersistentExecutableCache
        from ..engine import InferenceEngine

        spec = self.spec
        arg_params, aux_params = load_params_npz(spec["params"])
        net = build_model(spec["model"], **spec.get("model_kwargs", {}))
        cache = PersistentExecutableCache(
            net, arg_params, aux_params,
            cache_dir=spec.get("cache_dir"),
            model_key=spec.get("model_key")
            or "%s-r%s" % (spec["model"], self.replica_id))
        eng_kw = dict(spec.get("engine", {}))
        item_shapes = {n: tuple(s)
                       for n, s in spec["item_shapes"].items()}
        self.engine = InferenceEngine(
            cache, item_shapes,
            buckets=tuple(spec.get("buckets", (1, 2, 4, 8))),
            name="fleet-r%s" % self.replica_id, **eng_kw)
        self.engine.start()  # warms + seals before the port is published

    # ------------------------------------------------------------- handlers
    def _h_ping(self):
        return {"pid": os.getpid(), "replica_id": self.replica_id}

    def _h_infer(self, inputs, deadline_ms=None, timeout_s=60.0):
        fut = self.engine.submit(inputs, deadline_ms=deadline_ms)
        return fut.result(timeout=timeout_s)

    def _telemetry_snapshot(self):
        """Compact telemetry increment for health(): counter deltas and
        sparse histogram-bucket deltas since the LAST snapshot shipped.

        Delta encoding leans on the router's staleness contract: every
        ``health()`` bumps the engine seq, and ``_accept_snapshot``
        accepts a given seq at most once — so an accepted delta folds
        into the fleet rollup exactly once. A poll whose response is
        lost (or rejected as stale) drops that window's increments: the
        rollup skews low by one poll interval and self-heals on the
        next accepted snapshot — bounded, and the right trade against
        shipping full monotonic state every 100 ms."""
        if not telemetry.enabled():
            return None
        counters = telemetry.counters()
        buckets = telemetry.hist_buckets()
        with self._tel_lock:
            dc = {k: v - self._tel_last_counters.get(k, 0)
                  for k, v in counters.items()
                  if v - self._tel_last_counters.get(k, 0)}
            db = {}
            for name, b in buckets.items():
                prev = self._tel_last_buckets.get(name, {})
                d = {k: v - prev.get(k, 0) for k, v in b.items()
                     if v - prev.get(k, 0) > 0}
                if d:
                    db[name] = d
            self._tel_last_counters = counters
            self._tel_last_buckets = buckets
        return {"counters": dc, "hist": db,
                "dropped": telemetry.dropped_events()}

    def _h_health(self):
        h = self.engine.health()
        h["pid"] = os.getpid()
        h["replica_id"] = self.replica_id
        tel = self._telemetry_snapshot()
        if tel is not None:
            h["telemetry"] = tel
        return h

    def _h_dump_trace(self):
        """The replica's chrome-trace dict (router/serve_bench fetches
        one per replica and ``merge_traces`` aligns them)."""
        return telemetry.build_trace(
            extra={"label": "replica-%s" % self.replica_id})

    def _h_reload(self, arg_params, aux_params=None, timeout_s=60.0):
        # snapshot the PRIOR value of every key about to be swapped — the
        # rollout-abort path restores exactly these
        self._rollback_args, self._rollback_aux = \
            self.engine.cache.snapshot_params(
                list(arg_params or {}), list(aux_params or {}))
        ok = self.engine.reload(arg_params, aux_params).result(
            timeout=timeout_s)
        return bool(ok)

    def _h_rollback(self, timeout_s=60.0):
        if self._rollback_args is None and self._rollback_aux is None:
            raise MXNetError("fleet.replica: nothing to roll back "
                             "(no reload applied)")
        ok = self.engine.reload(self._rollback_args or {},
                                self._rollback_aux or None).result(
            timeout=timeout_s)
        self._rollback_args = self._rollback_aux = None
        return bool(ok)

    def _h_stop(self):
        self._stop.set()
        return True

    # ------------------------------------------------------------ lifecycle
    def _heartbeat_loop(self):
        path = self.spec["heartbeat_path"]
        interval = float(self.spec.get("heartbeat_ms", 500)) / 1000.0
        while not self._stop.is_set():
            try:
                with open(path, "a"):
                    os.utime(path, None)
            except OSError:
                pass
            self._stop.wait(interval)

    def start(self):
        # replica subprocesses do not inherit the parent's in-process
        # set_mode(): the spec carries the telemetry mode the fleet runs
        # under (serve_bench --check sets "trace")
        if self.spec.get("telemetry"):
            telemetry.set_mode(self.spec["telemetry"])
        self._build_engine()
        self.server = RpcServer({
            "ping": self._h_ping,
            "infer": self._h_infer,
            "health": self._h_health,
            "reload": self._h_reload,
            "rollback": self._h_rollback,
            "stop": self._h_stop,
            "dump_trace": self._h_dump_trace,
        }).start()
        if self.spec.get("heartbeat_path"):
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="fleet-heartbeat",
                daemon=True)
            self._hb_thread.start()
        # address committed LAST: a published replica can actually serve
        if self.spec.get("port_file"):
            _atomic_write(self.spec["port_file"], self.server.addr + "\n")
        return self

    def run_forever(self):
        try:
            while not self._stop.is_set():
                self._stop.wait(0.5)
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self.server is not None:
            self.server.stop()
        if self.engine is not None:
            try:
                self.engine.close(timeout=5.0, drain=False)
            except MXNetError:
                pass


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.stderr.write(
            "usage: python -m mxnet_tpu_torch.serving.fleet.replica <spec.json>\n")
        return 2
    with open(argv[0]) as f:
        spec = json.load(f)
    app = ReplicaApp(spec)
    signal.signal(signal.SIGTERM, lambda *_: app._stop.set())
    try:
        app.start()
    except BaseException as exc:  # the supervisor reads this breadcrumb
        sys.stderr.write("fleet.replica %s failed to start: %s: %s\n"
                         % (spec.get("replica_id"),
                            type(exc).__name__, exc))
        raise
    app.run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
