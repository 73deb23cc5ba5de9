"""The serving fleet of the port (``mxnet_tpu_torch/serving/fleet/``) held
against the JAX package's.

Every case of the reference's ``tests/test_fleet.py`` that needs no JAX
replica process runs here on BOTH packages (fixture ``P``): the router's
dispatch policy against in-process fake replicas (load-aware pick, prefix
affinity and its fallback, degraded/latched skip, stale snapshots,
saturated shed, zero-lost re-dispatch and its budget, overload, rollout
and its abort, the ``fleet.*`` fault sites), the RPC layer, the
supervisor against a stand-in worker, the metrics fold, trace ids and
the SLO monitor. Each package answers with its own error types. What is
deterministic is compared across the packages exactly: the rendezvous
target of 64 keys, ``_pick_locked`` on the same snapshots, ``metrics()``
folded from the same replica snapshots, rollout results and the bytes of
an RPC frame. Then one in-process ``ReplicaApp`` of each package serves
``mlp`` from one npz (either package's), and two real replica processes of
the port serve on the CPU through a rollout, a SIGKILL and a supervised
restart with no request lost, each under an import blocker for JAX.
"""
import io
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import faultinject as mx_fi
from mxnet_tpu import telemetry as mx_tm
from mxnet_tpu.serving import fleet as mx_fleet
from mxnet_tpu.serving.fleet import rpc as mx_rpc
from mxnet_tpu.serving import engine as mx_engine
from mxnet_tpu_torch import faultinject as pt_fi
from mxnet_tpu_torch import telemetry as pt_tm
from mxnet_tpu_torch.serving import fleet as pt_fleet
from mxnet_tpu_torch.serving.fleet import rpc as pt_rpc
from mxnet_tpu_torch.serving import engine as pt_engine

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
ROOT = Path(__file__).resolve().parents[1]


class Pkg:
    def __init__(self, name, mod, fleet, engine, tm, fi):
        self.name, self.mod, self.fleet, self.tm, self.fi = name, mod, fleet, tm, fi
        self.MXNetError = mod.base.MXNetError
        self.ServeOverloadError = engine.ServeOverloadError

    def __repr__(self):
        return self.name


PKGS = {"jax": Pkg("jax", mx, mx_fleet, mx_engine, mx_tm, mx_fi),
        "torch": Pkg("torch", pt, pt_fleet, pt_engine, pt_tm, pt_fi)}


@pytest.fixture(params=["jax", "torch"])
def P(request):
    p = PKGS[request.param]
    saved = p.tm.current_override()
    p.tm.reset()
    p.tm.clear_events()
    p.fi.reset_stats()
    yield p
    p.tm.set_mode(saved)
    p.tm.reset()
    p.tm.clear_events()
    p.fi.reset_stats()


@pytest.fixture
def payload():
    return {"data": np.zeros((2, 3), np.float32)}


# ---------------------------------------------------------------- fakes
class FakeReplica:
    """In-process replica implementing the RPC-handler protocol with
    scripted behavior (the reference test's fake), raising the errors of
    the package under test."""

    def __init__(self, P, rid, wait_ms=1.0, state="healthy"):
        self.P = P
        self.rid = rid
        self.wait_ms = wait_ms
        self.state = state
        self.seq = 0
        self.pid = 40000 + rid
        self.served = 0
        self.fail_next = 0
        self.overload_next = 0
        self.infer_delay_s = 0.0
        self.frozen_health = None
        self.health_raises = False
        self.reload_raises = False
        self.params_ver = 0
        self._prev_ver = None
        self.reload_times = []
        self.infer_done_times = []
        self._lock = threading.Lock()

    def health(self, **kw):
        if self.health_raises:
            raise ConnectionError("health: replica %d gone" % self.rid)
        if self.frozen_health is not None:
            return dict(self.frozen_health)
        self.seq += 1
        return {"state": self.state, "seq": self.seq,
                "snapshot_ms": time.time() * 1000.0,
                "ewma_queue_wait_ms": self.wait_ms, "pid": self.pid,
                "queue_depth": 0}

    def infer(self, inputs, deadline_ms=None, **kw):
        with self._lock:
            if self.fail_next > 0:
                self.fail_next -= 1
                raise ConnectionError("infer: replica %d died" % self.rid)
            if self.overload_next > 0:
                self.overload_next -= 1
                raise self.P.ServeOverloadError("replica %d saturated" % self.rid,
                                                retry_after_ms=25)
        if self.infer_delay_s:
            time.sleep(self.infer_delay_s)
        with self._lock:
            self.served += 1
            self.infer_done_times.append(time.perf_counter())
        return [np.full((2, 4), self.rid, np.float32)]

    def reload(self, arg_params, aux_params=None, **kw):
        if self.reload_raises:
            raise self.P.MXNetError("swap refused on replica %d" % self.rid)
        with self._lock:
            self._prev_ver = self.params_ver
            self.params_ver += 1
            self.reload_times.append(time.perf_counter())
        return True

    def rollback(self, **kw):
        with self._lock:
            if self._prev_ver is None:
                raise self.P.MXNetError("nothing to roll back")
            self.params_ver = self._prev_ver
            self._prev_ver = None
        return True


def make_router(P, fakes, **kw):
    kw.setdefault("workers", 4)
    kw.setdefault("health_interval_ms", 20)
    kw.setdefault("stale_ms", 400)
    kw.setdefault("dispatch_wait_ms", 2000)
    return P.fleet.Router(lambda: fakes, **kw)


def _wait_fresh(router, n, timeout=3.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        h = router.health()
        if sum(1 for d in h["replicas"].values() if d["fresh"]) >= n:
            return h
        time.sleep(0.02)
    raise AssertionError("views never became fresh: %s" % router.health())


# ------------------------------------------------------------ dispatch
def test_load_aware_pick_prefers_lowest_wait(P, payload):
    fakes = {0: FakeReplica(P, 0, wait_ms=2.0), 1: FakeReplica(P, 1, wait_ms=80.0)}
    with make_router(P, fakes) as r:
        _wait_fresh(r, 2)
        futs = [r.submit(payload) for _ in range(12)]
        for f in futs:
            f.result(timeout=5)
    assert fakes[0].served == 12
    assert fakes[1].served == 0


def test_prefix_affinity_pins_key_to_rendezvous_replica(P, payload):
    fakes = {i: FakeReplica(P, i, wait_ms=1.0 + 40.0 * i) for i in range(3)}
    P.tm.set_mode("counters")
    with make_router(P, fakes) as r:
        _wait_fresh(r, 3)
        key = "prefix-chain-abc123"
        target = r._affinity_target(key)
        futs = [r.submit(payload, prefix_key=key) for _ in range(8)]
        for f in futs:
            f.result(timeout=5)
        assert fakes[target].served == 8
        assert all(r._affinity_target(key) == target for _ in range(4))
        c = P.tm.counters()
        assert c.get("fleet.affinity_hits", 0) == 8
        assert c.get("fleet.affinity_fallbacks", 0) == 0
        r.infer(payload, timeout=5)
        assert fakes[0].served >= (1 if target != 0 else 9)


def test_prefix_affinity_falls_back_when_target_unhealthy(P, payload):
    fakes = {i: FakeReplica(P, i, wait_ms=1.0 + 10.0 * i) for i in range(3)}
    P.tm.set_mode("counters")
    with make_router(P, fakes) as r:
        _wait_fresh(r, 3)
        key = "prefix-chain-def456"
        target = r._affinity_target(key)
        fakes[target].state = "latched"
        _wait_fresh(r, 3)
        time.sleep(0.1)
        for _ in range(5):
            r.infer(payload, timeout=5, prefix_key=key)
        assert fakes[target].served == 0
        assert sum(f.served for rid, f in fakes.items() if rid != target) == 5
        assert P.tm.counters().get("fleet.affinity_fallbacks", 0) == 5


def test_prefix_affinity_disabled_by_env(P, payload, monkeypatch):
    monkeypatch.setenv("MXNET_FLEET_AFFINITY", "0")
    fakes = {0: FakeReplica(P, 0, wait_ms=2.0), 1: FakeReplica(P, 1, wait_ms=80.0)}
    with make_router(P, fakes) as r:
        _wait_fresh(r, 2)
        futs = [r.submit(payload, prefix_key="anything") for _ in range(6)]
        for f in futs:
            f.result(timeout=5)
    assert fakes[0].served == 6 and fakes[1].served == 0


def test_degraded_and_latched_skip(P, payload):
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0, state="degraded"),
             1: FakeReplica(P, 1, wait_ms=90.0),
             2: FakeReplica(P, 2, wait_ms=1.0, state="latched")}
    with make_router(P, fakes) as r:
        _wait_fresh(r, 3)
        for _ in range(5):
            r.infer(payload, timeout=5)
        assert fakes[1].served == 5
        assert fakes[0].served == 0 and fakes[2].served == 0
        fakes[1].state = "latched"
        _wait_fresh(r, 3)
        time.sleep(0.1)
        r.infer(payload, timeout=5)
        assert fakes[0].served == 1


def test_stale_snapshot_discarded(P, payload):
    P.tm.set_mode("counters")
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0), 1: FakeReplica(P, 1, wait_ms=50.0)}
    with make_router(P, fakes) as r:
        _wait_fresh(r, 2)
        fakes[0].frozen_health = fakes[0].health()
        deadline = time.perf_counter() + 3.0
        while time.perf_counter() < deadline:
            if not r.health()["replicas"][0]["fresh"]:
                break
            time.sleep(0.02)
        assert not r.health()["replicas"][0]["fresh"]
        for _ in range(4):
            r.infer(payload, timeout=5)
        assert fakes[1].served == 4
        assert fakes[0].served == 0
    assert P.tm.counters().get("fleet.stale_health_discards", 0) > 0


def test_fleet_saturated_shed_with_retry_after(P, payload):
    fakes = {0: FakeReplica(P, 0, wait_ms=5000.0), 1: FakeReplica(P, 1, wait_ms=9000.0)}
    with make_router(P, fakes, shed_ms=1000.0) as r:
        _wait_fresh(r, 2)
        with pytest.raises(P.ServeOverloadError) as ei:
            r.submit(payload)
        assert ei.value.retry_after_ms >= 1000
        with pytest.raises(P.ServeOverloadError):
            r.submit(payload, deadline_ms=100)
    with make_router(P, {}, stale_ms=100) as r:
        with pytest.raises(P.ServeOverloadError) as ei:
            r.submit(payload)
        assert ei.value.retry_after_ms > 0


def test_dead_replica_redispatch_zero_lost(P, payload):
    P.tm.set_mode("counters")
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0), 1: FakeReplica(P, 1, wait_ms=60.0)}
    with make_router(P, fakes, workers=4) as r:
        _wait_fresh(r, 2)
        fakes[0].fail_next = 6
        fakes[0].health_raises = True
        futs = [r.submit(payload) for _ in range(6)]
        outs = [f.result(timeout=10) for f in futs]
        deadline = time.perf_counter() + 3.0
        while time.perf_counter() < deadline and \
                not P.tm.counters().get("fleet.health_poll_errors", 0):
            time.sleep(0.02)
        counts = r.health()["counts"]
    for o in outs:
        assert o[0][0, 0] == 1.0
    assert fakes[1].served == 6
    assert counts["completed"] == counts["submitted"] == 6
    assert P.tm.counters().get("fleet.redispatches", 0) >= 1
    assert P.tm.counters().get("fleet.health_poll_errors", 0) >= 1


def test_redispatch_budget_exhausted_fails_structured(P, payload):
    fakes = {0: FakeReplica(P, 0)}
    fakes[0].fail_next = 10
    with make_router(P, fakes, max_redispatch=2, dispatch_wait_ms=500) as r:
        _wait_fresh(r, 1)
        fut = r.submit(payload)
        with pytest.raises(P.fleet.FleetDispatchError, match="re-dispatches"):
            fut.result(timeout=10)


def test_replica_overload_tries_next_then_sheds(P, payload):
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0), 1: FakeReplica(P, 1, wait_ms=2.0)}
    with make_router(P, fakes) as r:
        _wait_fresh(r, 2)
        fakes[0].overload_next = 1
        r.infer(payload, timeout=5)
        assert fakes[0].served + fakes[1].served == 1
        fakes[0].overload_next = 5
        fakes[1].overload_next = 5
        fut = r.submit(payload)
        with pytest.raises(P.ServeOverloadError):
            fut.result(timeout=10)


# -------------------------------------------------------------- rollout
def test_rollout_drains_then_swaps_every_replica(P, payload):
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0), 1: FakeReplica(P, 1, wait_ms=2.0)}
    fakes[0].infer_delay_s = 0.3
    with make_router(P, fakes) as r:
        _wait_fresh(r, 2)
        fut = r.submit(payload)
        time.sleep(0.05)
        res = r.rollout({"w": np.zeros(3, np.float32)}, drain_timeout_s=5.0)
        fut.result(timeout=5)
        assert res == {"applied": [0, 1], "skipped": []}
        assert fakes[0].params_ver == 1 and fakes[1].params_ver == 1
        assert fakes[0].reload_times[0] > fakes[0].infer_done_times[0]


def test_rollout_abort_rolls_back_swapped_replicas(P, payload):
    P.tm.set_mode("counters")
    fakes = {0: FakeReplica(P, 0), 1: FakeReplica(P, 1), 2: FakeReplica(P, 2)}
    fakes[2].reload_raises = True
    with make_router(P, fakes) as r:
        _wait_fresh(r, 3)
        with pytest.raises(P.fleet.FleetRolloutError, match="rolled back") as ei:
            r.rollout({"w": np.zeros(3, np.float32)})
        assert ei.value.result == {"applied": [], "skipped": [], "failed_replica": 2,
                                   "rolled_back": [0, 1], "rollback_failed": []}
        assert [f.params_ver for f in fakes.values()] == [0, 0, 0]
        r.infer(payload, timeout=5)
    assert P.tm.counters().get("fleet.rollout_aborts", 0) == 1


# --------------------------------------------------------- faultinject
def test_fleet_dispatch_site_drives_redispatch(P, payload):
    fakes = {0: FakeReplica(P, 0)}
    with make_router(P, fakes) as r:
        _wait_fresh(r, 1)
        P.fi.reset_stats()
        with P.fi.inject("fleet.dispatch", "raise", prob=1.0, seed=3, times=1):
            out = r.infer(payload, timeout=10)
        assert P.fi.stats().get("fleet.dispatch:raise") == 1
        assert r.health()["counts"]["redispatched"] == 1
    assert out[0][0, 0] == 0.0


def test_wedged_health_poll_does_not_stale_the_fleet(P, payload):
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0), 1: FakeReplica(P, 1, wait_ms=5.0)}
    orig = fakes[0].health

    def slow_health(**kw):
        time.sleep(1.2)
        return orig(**kw)

    with make_router(P, fakes, stale_ms=300) as r:
        _wait_fresh(r, 2)
        fakes[0].health = slow_health
        time.sleep(0.6)
        h = r.health()
        assert h["replicas"][1]["fresh"], h
        assert not h["replicas"][0]["fresh"], h
        r.infer(payload, timeout=5)
        assert fakes[1].served == 1


def test_fleet_health_site_starves_the_view(P, payload):
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0), 1: FakeReplica(P, 1, wait_ms=50.0)}
    with make_router(P, fakes, stale_ms=150) as r:
        _wait_fresh(r, 2)
        with P.fi.inject("fleet.health", "raise", prob=1.0, seed=5):
            deadline = time.perf_counter() + 2.0
            while time.perf_counter() < deadline:
                if not any(d["fresh"] for d in r.health()["replicas"].values()):
                    break
                time.sleep(0.02)
            assert not any(d["fresh"] for d in r.health()["replicas"].values())
        _wait_fresh(r, 2)
        r.infer(payload, timeout=5)


# ------------------------------------------------------------------ rpc
def test_rpc_roundtrip_errors_and_connection_loss(P):
    def echo(x):
        return {"got": x, "arr": np.arange(6).reshape(2, 3)}

    def boom():
        raise P.ServeOverloadError("busy", retry_after_ms=7)

    srv = P.fleet.RpcServer({"echo": echo, "boom": boom}).start()
    addr = srv.addr
    try:
        cli = P.fleet.RpcClient(addr, timeout_s=5.0)
        out = cli.call("echo", x=3)
        assert out["got"] == 3
        np.testing.assert_array_equal(out["arr"], np.arange(6).reshape(2, 3))
        # remote structured errors arrive as the package's own type
        with pytest.raises(P.ServeOverloadError) as ei:
            cli.call("boom")
        assert ei.value.retry_after_ms == 7
        with pytest.raises(P.MXNetError, match="unknown method"):
            cli.call("nope")
        assert cli.remote_pid == os.getpid() and cli.clock_offset_s is not None
    finally:
        srv.stop()
    cli2 = P.fleet.RpcClient(addr, timeout_s=1.0, connect_timeout_s=0.5)
    with pytest.raises(P.fleet.RpcConnectionError):
        cli2.call("echo", x=1)
    cli.close()


class _Wire:
    """A socket stand-in that keeps what ``_send_msg`` writes."""

    def __init__(self):
        self.buf = io.BytesIO()

    def sendall(self, b):
        self.buf.write(b)


def test_rpc_frames_are_the_references_bytes():
    rs = np.random.RandomState(7)
    msgs = [{"method": "infer", "kw": {"inputs": {"data": rs.rand(3, 5).astype(np.float32)},
                                       "deadline_ms": None, "timeout_s": 35.0},
             "trace": {"id": "0123456789abcdef"}},
            {"method": "__clock__", "kw": {}},
            {"method": "reload", "kw": {"arg_params": {"w": rs.randn(4).astype(np.float32)},
                                        "aux_params": None, "timeout_s": 120.0}},
            {"ok": True, "result": [rs.randn(2, 10).astype(np.float32)]}]
    for m in msgs:
        frames = []
        for rpc in (mx_rpc, pt_rpc):
            w = _Wire()
            rpc._send_msg(w, m)
            frames.append(w.buf.getvalue())
        assert frames[0] == frames[1]
        (n,) = pt_rpc._LEN.unpack(frames[1][:4])
        assert n == len(frames[1]) - 4
    # either side reads the other's frames
    a, b = __import__("socket").socketpair()
    try:
        mx_rpc._send_msg(a, msgs[0])
        got = pt_rpc._recv_msg(b)
        np.testing.assert_array_equal(got["kw"]["inputs"]["data"], msgs[0]["kw"]["inputs"]["data"])
        pt_rpc._send_msg(b, msgs[3])
        np.testing.assert_array_equal(mx_rpc._recv_msg(a)["result"][0], msgs[3]["result"][0])
    finally:
        a.close()
        b.close()
    assert pt_rpc._MAX_MSG == mx_rpc._MAX_MSG


# ------------------------------------------- deterministic cross-package
def _seeded_router(P, rids):
    fakes = {rid: FakeReplica(P, rid, wait_ms=1.0) for rid in rids}
    r = make_router(P, fakes)
    r._poll_once()  # before start(): inline polls seed every view
    return r


def test_affinity_targets_equal_the_references():
    rids = [0, 1, 2, 3, 5, 8]
    rs = np.random.RandomState(11)
    keys = ["prefix-%016x" % rs.randint(0, 2**62) for _ in range(64)]
    got = {}
    for name in ("jax", "torch"):
        r = _seeded_router(PKGS[name], rids)
        got[name] = [r._affinity_target(k) for k in keys]
    assert got["torch"] == got["jax"]
    assert len(set(got["torch"])) == len(rids)  # every replica draws keys


def test_pick_on_the_same_snapshots_equals_the_references(monkeypatch):
    rs = np.random.RandomState(12)
    waits = [float(w) for w in rs.choice([1.0, 1.04, 2.0, 5.0], size=5)]
    states = ["healthy", "healthy", "degraded", "healthy", "latched"]
    script = []
    for i in range(40):
        exclude = tuple(int(x) for x in rs.choice(5, size=int(rs.randint(0, 3)),
                                                    replace=False))
        key = None if i % 3 else "key-%d" % int(rs.randint(0, 6))
        script.append((exclude, key, int(rs.randint(0, 5)), int(rs.randint(0, 3))))
    got = {}
    for name in ("jax", "torch"):
        P = PKGS[name]
        r = make_router(P, {})
        now = 1000.0
        for rid in range(5):
            v = P.fleet.router._View(rid, "127.0.0.1:%d" % (9000 + rid))
            v.health = {"state": states[rid], "seq": 1, "snapshot_ms": 1.0,
                        "ewma_queue_wait_ms": waits[rid], "pid": 1 + rid}
            v.received_t = now
            r._views[rid] = v
        picks = []
        for exclude, key, busy, n in script:
            r._inflight[busy] = n
            v, est = r._pick_locked(now, exclude=exclude, prefix_key=key)
            picks.append((None if v is None else v.rid, est))
        r._draining.add(1)
        v, _ = r._pick_locked(now)
        picks.append(v.rid)
        got[name] = picks
    assert got["torch"] == got["jax"]


def test_metrics_fold_equals_the_references():
    """``metrics()`` folded from the same delta-encoded replica snapshots
    gives the same rollup in both packages (but the clock's fields)."""
    tels = []
    for seed in range(3):
        rs = np.random.RandomState(20 + seed)
        hs = {}
        for name in ("serving.request", "serving.dispatch"):
            h = mx_tm.Histogram()
            for v in rs.lognormal(-5, 1, 30):
                h.record(float(v))
            hs[name] = h.to_dict()["buckets"]
        tels.append({"counters": {"serving.requests": int(rs.randint(1, 50)),
                                  "serving.batches": int(rs.randint(1, 9))},
                     "hist": hs, "dropped": int(rs.randint(0, 3))})
    got = {}
    for name in ("jax", "torch"):
        P = PKGS[name]
        P.tm.clear_events()
        r = make_router(P, {})
        for rid in range(2):
            r._views[rid] = P.fleet.router._View(rid, "127.0.0.1:%d" % (9000 + rid))
        for i, tel in enumerate(tels):
            r._fold_telemetry(i % 2, tel)
        for d in (0.002, 0.004, 0.03):
            r._req_hist.record(d)
        m = r.metrics()
        for k in ("qps", "elapsed_s"):
            m.pop(k)
        for row in m["replicas"].values():
            row.pop("qps")
        got[name] = m
    assert got["torch"] == got["jax"]
    assert got["torch"]["counters"]["serving.requests"] == sum(
        t["counters"]["serving.requests"] for t in tels)


def test_rollout_results_equal_the_references(payload):
    got = {}
    for name in ("jax", "torch"):
        P = PKGS[name]
        fakes = {i: FakeReplica(P, i) for i in range(4)}
        fakes[3].reload_raises = True
        out = []
        with make_router(P, fakes) as r:
            _wait_fresh(r, 4)
            try:
                r.rollout({"w": np.zeros(3, np.float32)})
            except P.fleet.FleetRolloutError as exc:
                out.append(exc.result)
            fakes[3].reload_raises = False
            out.append(r.rollout({"w": np.ones(3, np.float32)}))
            out.append([f.params_ver for f in fakes.values()])
        got[name] = out
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["rolled_back"] == [0, 1, 2]


# ------------------------------------------------------------ supervisor
_FAKE_WORKER = r"""
import json, os, sys, time
spec = json.load(open(sys.argv[1]))
mode = spec.get("fake_mode", "ok")
if mode != "never_ready":
    with open(spec["port_file"] + ".tmp", "w") as f:
        f.write("127.0.0.1:1\n")
    os.replace(spec["port_file"] + ".tmp", spec["port_file"])
beats = 0
while True:
    if mode != "wedge" or beats < 2:
        with open(spec["heartbeat_path"], "a"):
            os.utime(spec["heartbeat_path"], None)
        beats += 1
    time.sleep(0.05)
"""


def _mk_sup(P, tmp_path, n=2, **kw):
    class StubSupervisor(P.fleet.ReplicaSupervisor):
        def _spawn_cmd(self, h):
            return [sys.executable, "-c", _FAKE_WORKER, h.spec_path]

    spec = {"model": "stub", "fake_mode": kw.pop("fake_mode", "ok")}
    kw.setdefault("restart_backoff_ms", 50)
    kw.setdefault("restart_backoff_max_ms", 400)
    kw.setdefault("dead_after_ms", 600)
    kw.setdefault("poll_interval_s", 0.05)
    return StubSupervisor(spec, n_replicas=n, workdir=str(tmp_path), **kw)


def test_supervisor_spawns_to_ready_and_restarts_dead(P, tmp_path):
    sup = _mk_sup(P, tmp_path, n=2)
    try:
        sup.start()
        sup.wait_ready(2, timeout_s=15)
        states = sup.states()
        pid0 = states[0]["pid"]
        assert all(d["state"] == "ready" for d in states.values())
        sup.kill_replica(0)
        deadline = time.perf_counter() + 15
        while time.perf_counter() < deadline:
            s = sup.states()[0]
            if s["state"] == "ready" and s["pid"] not in (None, pid0):
                break
            time.sleep(0.05)
        s = sup.states()[0]
        assert s["state"] == "ready" and s["pid"] != pid0
        assert s["restarts"] == 1
        assert sup.states()[1]["restarts"] == 0
    finally:
        sup.stop()


def test_supervisor_kills_wedged_replica_on_stale_heartbeat(P, tmp_path):
    sup = _mk_sup(P, tmp_path, n=1, fake_mode="wedge", dead_after_ms=300)
    try:
        sup.start()
        sup.wait_ready(1, timeout_s=15)
        deadline = time.perf_counter() + 15
        while time.perf_counter() < deadline:
            if sup.states()[0]["restarts"] >= 1:
                break
            time.sleep(0.05)
        assert sup.states()[0]["restarts"] >= 1
    finally:
        sup.stop()


def test_supervisor_spawn_fault_injection_backs_off_and_retries(P, tmp_path):
    sup = _mk_sup(P, tmp_path, n=1)
    try:
        with P.fi.inject("fleet.replica_spawn", "raise", prob=1.0, seed=9, times=1):
            sup.start()
            sup.wait_ready(1, timeout_s=15)
        assert P.fi.stats().get("fleet.replica_spawn:raise") == 1
        assert sup.states()[0]["restarts"] >= 1
    finally:
        sup.stop()


def test_supervisor_backoff_is_capped(P, tmp_path):
    sup = _mk_sup(P, tmp_path, n=1, restart_backoff_ms=100, restart_backoff_max_ms=250)
    h = sup._handles[0]
    now = time.perf_counter()
    delays = []
    with sup._lock:
        for _ in range(5):
            sup._note_death_locked(h, "test", now)
            delays.append(h.next_spawn_t - now)
    assert delays[0] == pytest.approx(0.1, abs=0.02)
    assert delays[-1] == pytest.approx(0.25, abs=0.02)
    assert all(b >= a - 1e-9 for a, b in zip(delays, delays[1:]))


@pytest.mark.parametrize("var, attr, default", [
    ("MXNET_FLEET_REPLICAS", "n_replicas", 2),
    ("MXNET_FLEET_RESTART_BACKOFF_MS", "restart_backoff_s", 0.2),
    ("MXNET_FLEET_RESTART_BACKOFF_MAX_MS", "restart_backoff_max_s", 5.0),
    ("MXNET_FLEET_DEAD_MS", "dead_after_s", 3.0)])
def test_supervisor_knobs_and_defaults_are_the_references(var, attr, default, tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv(var, raising=False)
    for P in PKGS.values():
        assert getattr(P.fleet.ReplicaSupervisor({}, workdir=str(tmp_path)), attr) == default
    monkeypatch.setenv(var, "3")
    want = getattr(mx_fleet.ReplicaSupervisor({}, workdir=str(tmp_path)), attr)
    assert getattr(pt_fleet.ReplicaSupervisor({}, workdir=str(tmp_path)), attr) == want


@pytest.mark.parametrize("var, attr", [
    ("MXNET_FLEET_WORKERS", "workers"), ("MXNET_FLEET_MAX_QUEUE", "max_queue"),
    ("MXNET_FLEET_HEALTH_INTERVAL_MS", "health_interval_s"),
    ("MXNET_FLEET_STALE_MS", "stale_s"), ("MXNET_FLEET_SHED_MS", "shed_cap_ms"),
    ("MXNET_FLEET_REDISPATCH", "max_redispatch"),
    ("MXNET_FLEET_RPC_TIMEOUT_MS", "rpc_timeout_s"),
    ("MXNET_FLEET_DISPATCH_WAIT_MS", "dispatch_wait_s"),
    ("MXNET_FLEET_DEADLINE_MS", "default_deadline_s"),
    ("MXNET_FLEET_AFFINITY", "affinity_enabled")])
def test_router_knobs_and_defaults_are_the_references(var, attr, monkeypatch):
    for value in (None, "0", "7"):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
        got = [getattr(P.fleet.Router(dict), attr) for P in PKGS.values()]
        assert got[0] == got[1], (var, value, got)


# ------------------------------------------- engine health() staleness
def test_engine_health_seq_and_snapshot_ms_are_monotonic(P):
    net = P.mod.sym.FullyConnected(P.mod.sym.Variable("data"), num_hidden=4, name="fc")
    rs = np.random.RandomState(0)
    cache = P.mod.serving.PersistentExecutableCache(
        net, {"fc_weight": rs.randn(4, 6).astype("float32"),
              "fc_bias": np.zeros(4, "float32")}, ctx=P.mod.cpu())
    eng = P.mod.serving.InferenceEngine(cache, {"data": (6,)}, buckets=(1, 2))
    eng.start()
    try:
        t0 = time.time() * 1000.0
        h1 = eng.health()
        h2 = eng.health()
        assert h2["seq"] == h1["seq"] + 1
        assert t0 - 5000 < h1["snapshot_ms"] <= h2["snapshot_ms"]
        assert h2["snapshot_ms"] <= time.time() * 1000.0 + 5000
    finally:
        eng.close()


def test_fleet_rollout_recycles_unrolled_replicas(P, tmp_path):
    params_path = str(tmp_path / "p.npz")
    P.fleet.save_params_npz(params_path, {"w": np.zeros(2, np.float32)})

    class StubSup:
        n_replicas = 3
        base_spec = {"params": params_path}
        killed = []

        def kill_replica(self, rid):
            self.killed.append(rid)

    class StubRouter:
        def rollout(self, arg_params, aux_params=None, **kw):
            return {"applied": [1, 2], "skipped": []}

    f = object.__new__(P.fleet.Fleet)
    f.supervisor = StubSup()
    f.router = StubRouter()
    res = f.rollout({"w": np.ones(2, np.float32)})
    assert res == {"applied": [1, 2], "recycled": [0]}
    assert f.supervisor.killed == [0]
    arg, _ = P.fleet.load_params_npz(params_path)
    np.testing.assert_array_equal(arg["w"], np.ones(2, np.float32))


# ---------------------------------------- fleet observability (metrics)
class TelemetryFake(FakeReplica):
    def __init__(self, P, rid, **kw):
        super().__init__(P, rid, **kw)
        self.pending_tel = []

    def health(self, **kw):
        h = super().health(**kw)
        if self.pending_tel:
            h["telemetry"] = self.pending_tel.pop(0)
        return h


def test_router_metrics_fold_replica_snapshots(P, payload):
    Histogram = P.tm.histogram.Histogram
    h0, h1 = Histogram(), Histogram()
    for _ in range(20):
        h0.record(0.004)
    for _ in range(20):
        h1.record(0.016)
    fakes = {0: TelemetryFake(P, 0, wait_ms=1.0), 1: TelemetryFake(P, 1, wait_ms=2.0)}
    fakes[0].pending_tel = [
        {"counters": {"serving.requests": 20},
         "hist": {"serving.request": h0.to_dict()["buckets"]}, "dropped": 0},
        {"counters": {"serving.requests": 5}, "hist": {}, "dropped": 2}]
    fakes[1].pending_tel = [
        {"counters": {"serving.requests": 20},
         "hist": {"serving.request": h1.to_dict()["buckets"]}, "dropped": 0}]
    with make_router(P, fakes) as r:
        _wait_fresh(r, 2)
        for _ in range(3):
            r.infer(payload, timeout=5)
        deadline = time.perf_counter() + 3.0
        m = r.metrics()
        while time.perf_counter() < deadline:
            m = r.metrics()
            if m["counters"].get("serving.requests") == 45 \
                    and m["replicas"].get("0", {}).get("dropped") == 2:
                break
            time.sleep(0.02)
    assert m["counters"]["serving.requests"] == 45
    lat = m["latency_ms"]["serving.request"]
    assert lat["count"] == 40
    assert abs(lat["p50"] - 4.0) / 4.0 < 0.15
    assert abs(lat["p99"] - 16.0) / 16.0 < 0.15
    assert m["latency_ms"]["fleet.request"]["count"] == 3
    assert m["requests"] == 3 and m["errors"] == 0
    assert m["replicas"]["0"]["dropped"] == 2
    assert m["dropped_events"] >= 2


def test_trace_id_minting_gated_by_mode(P, payload):
    seen = []

    class Spy(FakeReplica):
        def infer(self, inputs, **kw):
            seen.append(P.tm.trace_context())
            return super().infer(inputs, **kw)

    fakes = {0: Spy(P, 0)}
    with make_router(P, fakes) as r:
        _wait_fresh(r, 1)
        P.tm.set_mode("counters")
        r.infer(payload, timeout=5)
        P.tm.set_mode("trace")
        r.infer(payload, timeout=5)
    assert seen[0] is None
    assert isinstance(seen[1], str) and len(seen[1]) == 16
    int(seen[1], 16)


def test_fleet_trace_ids_propagate_across_rpc(P, payload):
    from importlib import import_module

    cli = import_module(P.mod.__name__ + ".telemetry.cli")
    P.tm.set_mode("trace")
    seen = []
    seq = [0]

    def health(**kw):
        seq[0] += 1
        return {"state": "healthy", "seq": seq[0], "snapshot_ms": time.time() * 1000.0,
                "ewma_queue_wait_ms": 1.0, "pid": os.getpid(), "queue_depth": 0}

    def infer(inputs, deadline_ms=None, **kw):
        seen.append(P.tm.trace_context())
        with P.tm.span("serving.dispatch", rows=2):
            pass
        return [np.zeros((2, 4), np.float32)]

    def dump_trace(**kw):
        d = P.tm.build_trace(extra={"label": "replica-0"})
        d["otherData"]["pid"] = os.getpid() + 100000
        return d

    srv = P.fleet.RpcServer({"health": health, "infer": infer,
                             "dump_trace": dump_trace}).start()
    try:
        with make_router(P, {0: srv.addr}) as r:
            _wait_fresh(r, 1)
            r.infer(payload, timeout=10)
            assert len(seen) == 1 and isinstance(seen[0], str)
            m = r.metrics()
            assert abs(m["replicas"]["0"]["clock_offset_ms"]) < 5000.0
            merged = r.collect_fleet_trace()
        assert cli.check(merged) == []
        assert merged["otherData"]["merged"] is True
        assert merged["otherData"]["fleet"]["requests"] == 1
        labels = {d["label"] for d in merged["otherData"]["processes"].values()}
        assert "router" in labels and "replica-0" in labels
        chains = cli.request_chains(merged)
        assert seen[0] in chains
        assert len({s["pid"] for s in chains[seen[0]]}) >= 2
        names = {s["name"] for s in chains[seen[0]]}
        assert "fleet.dispatch" in names and "serving.dispatch" in names
    finally:
        srv.stop()


def test_router_slo_violation_fires_and_clears(P, payload, monkeypatch):
    monkeypatch.setenv("MXNET_SLO_WINDOW_S", "2")
    monkeypatch.setenv("MXNET_SLO_SHORT_WINDOW_S", "0.5")
    fakes = {0: FakeReplica(P, 0, wait_ms=1.0)}
    with make_router(P, fakes, slo="err_pct:5", max_redispatch=1,
                     dispatch_wait_ms=500) as r:
        _wait_fresh(r, 1)
        for _ in range(5):
            r.infer(payload, timeout=5)
        s = r.metrics()["slo"]
        assert s["ok"] and "err_pct" in s["objectives"]
        fakes[0].fail_next = 12
        futs = [r.submit(payload) for _ in range(6)]
        for f in futs:
            with pytest.raises(Exception):
                f.result(timeout=10)
        fakes[0].fail_next = 0
        deadline = time.perf_counter() + 5.0
        fired = False
        while time.perf_counter() < deadline:
            s = r.metrics().get("slo") or {}
            if s and not s.get("ok", True):
                fired = True
                break
            time.sleep(0.05)
        assert fired, s
        assert s["objectives"]["err_pct"]["firing"]
        assert s["burn_rate"] >= s["burn_threshold"]
        deadline = time.perf_counter() + 10.0
        cleared = False
        while time.perf_counter() < deadline:
            try:
                r.infer(payload, timeout=5)
            except Exception:
                pass
            s = r.metrics().get("slo") or {}
            if s.get("ok"):
                cleared = True
                break
            time.sleep(0.1)
        assert cleared, s
        kinds = [v["kind"] for v in r.slo_violations()]
        assert "slo.violation" in kinds and "slo.clear" in kinds
        viol = [v for v in r.slo_violations() if v["kind"] == "slo.violation"][0]
        assert viol["objective"] == "err_pct"
        assert viol["burn_rate"] >= 1.0


# ------------------------------------------------- replicas of each package
def _mlp_params(pkg, seed=0):
    net = pkg.models.get_symbol("mlp", num_classes=10)
    shapes = net.infer_shape(data=(1, 784), softmax_label=(1,))[0]
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * 0.1).astype("float32")
            for n, s in zip(net.list_arguments(), shapes) if n not in ("data", "softmax_label")}


def _mlp_spec(path):
    return {"model": "mlp", "model_kwargs": {"num_classes": 10},
            "item_shapes": {"data": [784]}, "buckets": [1, 2, 4], "params": str(path),
            "heartbeat_ms": 300}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_in_process_replicas_agree_and_roll_back_bitwise(writer, tmp_path):
    """A JAX and a port ``ReplicaApp`` serve ``mlp`` from one npz (written
    by either package, the port's from tensors): ``_h_infer`` agrees,
    returns numpy, and ``_h_rollback`` after ``_h_reload`` gives the first
    outputs back bitwise."""
    args = _mlp_params(mx)
    path = tmp_path / "p.npz"
    if writer == "torch":
        pt_fleet.save_params_npz(str(path), {n: torch.from_numpy(v) for n, v in args.items()})
    else:
        mx_fleet.save_params_npz(str(path), {n: mx.nd.array(v) for n, v in args.items()})
    for P in PKGS.values():
        got, _ = P.fleet.load_params_npz(str(path))
        assert sorted(got) == sorted(args)
        assert all(np.array_equal(got[n], args[n]) for n in args)
    x = np.random.RandomState(1).rand(3, 784).astype("float32")
    new = {n: (v * 1.02 + 0.01).astype("float32") for n, v in args.items()}
    outs = {}
    for name, P in PKGS.items():
        app = P.fleet.ReplicaApp(_mlp_spec(path)).start()
        try:
            # the batcher thread's first GEMM on the CPU may split its sums
            # otherwise than the later ones (1.2e-7 seen): compare from the
            # second call on
            app._h_infer({"data": x})
            first = app._h_infer({"data": x})
            assert all(type(o) is np.ndarray for o in first)
            assert app._h_ping()["pid"] == os.getpid()
            assert app._h_reload(new) is True
            swapped = app._h_infer({"data": x})
            assert app._h_rollback() is True
            back = app._h_infer({"data": x})
            with pytest.raises(P.MXNetError, match="nothing to roll back"):
                app._h_rollback()
            h = app._h_health()
            assert h["replica_id"] == 0 and h["reloads"] == 2
        finally:
            app.close()
        assert all(np.array_equal(a, b) for a, b in zip(back, first))
        assert not np.array_equal(swapped[0], first[0])
        outs[name] = (first, swapped)
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a[0], b[0], rtol=RTOL, atol=ATOL)


def test_replica_without_cuda_fails_with_its_breadcrumb(tmp_path):
    """With no default context named, a replica binds ``gpu(0)``; on a host
    without CUDA it does not serve on the CPU but fails at start, its
    breadcrumb on stderr."""
    path = tmp_path / "p.npz"
    pt_fleet.save_params_npz(str(path), _mlp_params(pt))
    spec = tmp_path / "spec.json"
    spec.write_text(__import__("json").dumps(dict(_mlp_spec(path), port_file=str(
        tmp_path / "port"))))
    env = {k: v for k, v in os.environ.items() if k != "MXNET_DEFAULT_CONTEXT"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.serving.fleet.replica",
                          str(spec)], env=env, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "fleet.replica None failed to start: MXNetError" in res.stderr
    assert "CUDA is not available" in res.stderr
    assert not (tmp_path / "port").exists()


# --------------------------------------------------- real port processes
_BLOCKER = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "mxnet_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def test_spawn_command_names_the_ports_replica(tmp_path):
    sup = pt_fleet.ReplicaSupervisor({}, n_replicas=1, workdir=str(tmp_path))
    cmd = sup._spawn_cmd(sup._handles[0])
    assert cmd[0] == sys.executable and cmd[1] == "-c" and cmd[-1] == sup._handles[0].spec_path
    assert "from mxnet_tpu_torch.serving.fleet.replica import main" in cmd[2]
    assert "mxnet_tpu." not in cmd[2].replace("mxnet_tpu_torch.", "")
    ref = mx_fleet.ReplicaSupervisor({}, n_replicas=1, workdir=str(tmp_path))._spawn_cmd(
        sup._handles[0])
    assert cmd[2] == ref[2].replace("mxnet_tpu.", "mxnet_tpu_torch.")


def test_fleet_end_to_end_real_processes(tmp_path, monkeypatch):
    """Two real replica processes of the port on the CPU, each started
    under an import blocker for JAX and the JAX package: routed inference
    equal to an in-process cache, a hitless rollout, a SIGKILL and a
    supervised restart, and zero lost requests throughout."""
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    real = pt_fleet.ReplicaSupervisor._spawn_cmd

    def blocked(self, h):
        cmd = real(self, h)
        return cmd[:2] + [_BLOCKER + cmd[2] + "\n"] + cmd[3:]

    monkeypatch.setattr(pt_fleet.ReplicaSupervisor, "_spawn_cmd", blocked)
    args = _mlp_params(pt)
    path = tmp_path / "params.npz"
    pt_fleet.save_params_npz(str(path), args)
    rs = np.random.RandomState(0)
    x = rs.rand(2, 784).astype("float32")
    net = pt.models.get_symbol("mlp", num_classes=10)
    new = {k: (v * 1.01).astype("float32") for k, v in args.items()}
    want, want_new = ({n: pt.serving.PersistentExecutableCache(net, a, {}, ctx=pt.cpu()).run(
        {"data": x[:n]})[0] for n in (1, 2)} for a in (args, new))
    with pt_fleet.Fleet(_mlp_spec(path), n_replicas=2, workdir=str(tmp_path),
                        router_kwargs=dict(health_interval_ms=100)) as fl:
        pids = {rid: s["pid"] for rid, s in fl.supervisor.states().items()}
        for _ in range(4):
            out = fl.router.infer({"data": x}, timeout=30)
            np.testing.assert_allclose(out[0], want[2], rtol=RTOL, atol=ATOL)
        res = fl.rollout(new)
        assert res == {"applied": [0, 1], "recycled": []}
        assert fl.supervisor.kill_replica(0) == pids[0]
        futs = [fl.router.submit({"data": x[:1]}) for _ in range(10)]
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=30)[0], want_new[1], rtol=RTOL,
                                       atol=ATOL)
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline:
            s = fl.supervisor.states()[0]
            if s["restarts"] >= 1 and s["state"] == "ready":
                break
            time.sleep(0.05)
        fl.supervisor.wait_ready(2, timeout_s=60)
        s = fl.supervisor.states()
        assert s[0]["restarts"] >= 1 and s[0]["pid"] not in (None, pids[0])
        # the restarted replica loads the rolled-out file
        _wait_fresh(fl.router, 2, timeout=10)
        for _ in range(4):
            np.testing.assert_allclose(fl.router.infer({"data": x}, timeout=30)[0], want_new[2],
                                       rtol=RTOL, atol=ATOL)
        counts = fl.router.health()["counts"]
        assert counts["completed"] == counts["submitted"] == 18
        assert counts["failed"] == 0
        live = [d["pid"] for d in fl.supervisor.states().values()]
    for pid in live:
        with pytest.raises(OSError):
            os.kill(pid, 0)
