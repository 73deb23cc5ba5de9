"""Elastic fault tolerance of the port (``mxnet_tpu_torch/dist.py``'s elastic
half, ``module/elastic.py``) held against the JAX package's.

* The unit cases of the reference's ``tests/test_dist_elastic.py`` on BOTH
  packages (fixture ``D``): ``num_dead_nodes`` edge cases (clock skew, the
  grace boundary, the heartbeat dir removed mid-scan, the transition
  counter), the heartbeat drain, ``plan_reform``/``plan_from_pause``
  validation, ``EvictedError`` and ``elastic_enabled``.
* The pause protocol over the port's coordination store (worker 0's
  ``TCPStore``) in a subprocess: first write wins, ``poll_pause`` does not
  block, the payload round-trips. The reference's own copy of this case
  fails on the JAX package before it starts (its elastic bootstrap imports
  ``jax._src.lib.xla_extension``, which the installed JAX lacks; ROADMAP.md
  section 3); the port is held here to the behaviour the reference
  documents (``mxnet_tpu/dist.py:496-543``), not to its result.
* ``random.refresh_backend`` keeps every readable generator and drops an
  unreadable one.
* Under ``tools/launch.py --elastic --cpu-devices 1`` on gloo, each launch
  with a timeout of its own (the crash with short heartbeat and dead
  timeouts):

  - two ranks, sharded optimizer state (JAX :333): the pointer file, the
    same-W shard-direct reload bit for bit, the re-flattened reload of
    another bucket plan within 1e-6, the optimizer-kind guard;
  - two ranks, ``fit(elastic=..., resume=True)`` at the same world (JAX
    :438): bit for bit an uninterrupted run, and the shard-direct slices
    equal the shard file;
  - three ranks of the MNIST-sized ``mlp`` where rank 2 drains (SIGTERM) or
    crashes (SIGKILL) at round 8: the survivors reach generation 1 / world
    2, a drained rank exits 0, and the survivors' weights match a fresh
    two-rank control resumed from the step they reseeded from (rtol 0,
    atol 1e-6) — the comparison ``tests/nightly/dist_elastic_chaos.py``
    makes, cut to three ranks;
  - two ranks whose Module engages the fused step: refused, as in JAX.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu
import mxnet_tpu_torch as pt
from mxnet_tpu import dist as mx_dist
from mxnet_tpu import telemetry as mx_tm
from mxnet_tpu_torch import checkpoint as pt_ckpt
from mxnet_tpu_torch import dist as pt_dist
from mxnet_tpu_torch import telemetry as pt_tm

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": (mxnet_tpu, mx_dist, mx_tm), "torch": (pt, pt_dist, pt_tm)}


@pytest.fixture(params=["jax", "torch"])
def D(request):
    """(package, its dist module, its telemetry) under test."""
    return PKGS[request.param]


@pytest.fixture
def hb(tmp_path, monkeypatch, D):
    """A heartbeat dir with 2 configured workers and a pinned job-start
    anchor; yields (dist, dir, touch(rank, age))."""
    _, dist, _ = D
    d = str(tmp_path / "hb")
    os.makedirs(d)
    monkeypatch.setenv("MXNET_TPU_HEARTBEAT_DIR", d)
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "2")
    monkeypatch.setattr(dist, "_start_time", time.time() - 3600)
    monkeypatch.setattr(dist, "_last_dead", 0)
    old = time.time() - 3600
    os.utime(d, (old, old))

    def touch(rank, age=0.0):
        path = os.path.join(d, "worker-%d" % rank)
        with open(path, "a"):
            pass
        t = time.time() - age
        os.utime(path, (t, t))

    return dist, d, touch


# ------------------------------------------------------------ num_dead_nodes
def test_dead_nodes_future_mtime_is_alive(hb):
    dist, _, touch = hb
    touch(0, age=-300.0)  # 5 minutes in the future
    touch(1, age=0.0)
    assert dist.num_dead_nodes(timeout=60) == 0


def test_dead_nodes_exact_grace_boundary(hb, monkeypatch):
    dist, _, touch = hb
    touch(0, age=0.0)  # worker 1 never wrote a file
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    monkeypatch.setattr(dist, "_start_time", now - 30.0)
    assert dist.num_dead_nodes(timeout=60, startup_grace=30.0) == 0
    monkeypatch.setattr(dist, "_start_time", now - 30.001)
    assert dist.num_dead_nodes(timeout=60, startup_grace=30.0) == 1


def test_dead_nodes_dir_removed_mid_scan(hb, monkeypatch):
    dist, d, touch = hb
    touch(0)
    touch(1)
    assert dist.num_dead_nodes(timeout=60) == 0
    shutil.rmtree(d)
    assert dist.num_dead_nodes(timeout=60) == 0
    os.makedirs(d)
    os.utime(d, (time.time() - 3600,) * 2)
    touch(0)
    real_getmtime = os.path.getmtime

    def racing_getmtime(path):
        if path.endswith("worker-1"):
            raise OSError("vanished mid-scan")
        return real_getmtime(path)

    monkeypatch.setattr(os.path, "getmtime", racing_getmtime)
    assert dist.num_dead_nodes(timeout=60) == 1  # past grace: counts dead
    assert dist.num_dead_nodes(timeout=60, startup_grace=10 ** 9) == 0


def test_dead_alive_dead_transition_counter(hb, D):
    dist, _, touch = hb
    tm = D[2]
    tm.reset()
    saved = tm.current_override()
    tm.set_mode("counters")
    try:
        touch(0)
        touch(1, age=300.0)
        assert dist.num_dead_nodes(timeout=60) == 1
        touch(1, age=0.0)
        assert dist.num_dead_nodes(timeout=60) == 0
        touch(1, age=300.0)
        assert dist.num_dead_nodes(timeout=60) == 1
        assert dist.num_dead_nodes(timeout=60) == 1  # no change, no tick
        assert tm.counter("dist.dead_node_transitions").value == 3
    finally:
        tm.set_mode(saved)
        tm.reset()


def test_stop_heartbeat_removes_file(hb, monkeypatch):
    dist, d, _ = hb
    monkeypatch.setenv("MXNET_TPU_WORKER_ID", "0")
    monkeypatch.setattr(dist, "_initialized", True)
    monkeypatch.setattr(dist, "_heartbeat_thread", None)
    monkeypatch.setattr(dist, "_heartbeat_stop", None)
    monkeypatch.setenv("MXNET_TPU_HEARTBEAT_INTERVAL", "0.05")
    dist._start_heartbeat(0)
    assert dist.is_heartbeating()
    deadline = time.time() + 5
    path = os.path.join(d, "worker-0")
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.01)
    assert os.path.exists(path)
    dist.stop_heartbeat(remove=True)
    assert not dist.is_heartbeating()
    assert not os.path.exists(path)


def test_elastic_scan_covers_the_current_members_only(hb, monkeypatch):
    """A worker re-formed away stays dead forever; the scan of the new
    generation must not count it again (JAX ``_scan_heartbeats``)."""
    dist, _, touch = hb
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "3")
    monkeypatch.setattr(dist, "_elastic", True)
    monkeypatch.setattr(dist, "_members", [0, 1])
    touch(0)
    touch(1)
    touch(2, age=900.0)
    assert dist.dead_members(timeout=60) == []
    monkeypatch.setattr(dist, "_members", [0, 1, 2])
    assert dist.dead_members(timeout=60) == [2]


# ------------------------------------------------------------- plan validation
@pytest.fixture
def elastic_world(monkeypatch, D):
    """A faked 4-worker elastic membership (the plan logic needs no store)."""
    _, dist, _ = D
    monkeypatch.setattr(dist, "_elastic", True)
    monkeypatch.setattr(dist, "_members", [0, 1, 2, 3])
    monkeypatch.setattr(dist, "_orig_rank", 1)
    monkeypatch.setattr(dist, "_orig_world", 4)
    monkeypatch.setattr(dist, "_generation", 0)
    return dist


def test_plan_reform_survivor_set(elastic_world):
    assert elastic_world.plan_reform(dead=[3]) == {
        "generation": 1, "members": [0, 1, 2], "dead": [3], "rank": 1, "world": 3}
    assert elastic_world.rank() == 1 and elastic_world.num_workers() == 4
    assert elastic_world.members() == [0, 1, 2, 3] and elastic_world.orig_rank() == 1


def test_plan_reform_coordinator_death_unrecoverable(elastic_world, D):
    with pytest.raises(D[0].base.MXNetError, match="coordinator"):
        elastic_world.plan_reform(dead=[0, 3])


def test_plan_reform_min_workers(elastic_world, monkeypatch, D):
    monkeypatch.setenv("MXNET_ELASTIC_MIN_WORKERS", "3")
    with pytest.raises(D[0].base.MXNetError, match="MIN_WORKERS"):
        elastic_world.plan_reform(dead=[2, 3])


def test_plan_reform_nothing_dead_raises(elastic_world, D):
    with pytest.raises(D[0].base.MXNetError, match="no dead"):
        elastic_world.plan_reform(dead=[])


def test_plan_reform_self_classed_dead_raises(elastic_world, D):
    with pytest.raises(D[0].base.MXNetError, match="THIS worker"):
        elastic_world.plan_reform(dead=[1])


def test_plan_from_pause_evicts_self(elastic_world, D):
    with pytest.raises(D[0].base.EvictedError):
        elastic_world.plan_from_pause({"generation": 1, "dead": [1], "pause_at": 5,
                                       "proposer": 1})


def test_plan_from_pause_generation_mismatch(elastic_world, D):
    with pytest.raises(D[0].base.MXNetError, match="generation"):
        elastic_world.plan_from_pause({"generation": 7, "dead": [3], "pause_at": 5,
                                       "proposer": 0})


def test_evicted_error_is_mxnet_error(D):
    assert issubclass(D[0].base.EvictedError, D[0].base.MXNetError)


def test_elastic_enabled_env(monkeypatch, D):
    dist = D[1]
    monkeypatch.delenv("MXNET_ELASTIC", raising=False)
    assert not dist.elastic_enabled()
    monkeypatch.setenv("MXNET_ELASTIC", "1")
    assert dist.elastic_enabled()
    monkeypatch.setenv("MXNET_ELASTIC", "off")
    assert not dist.elastic_enabled()


def test_elastic_calls_outside_an_elastic_job_raise(D, monkeypatch):
    dist = D[1]
    monkeypatch.setattr(dist, "_elastic", False)
    monkeypatch.setattr(dist, "_members", None)
    assert dist.members() is None
    for call in (dist.coordination_client, lambda: dist.plan_reform(dead=[1]),
                 lambda: dist.plan_from_pause({"generation": 1, "dead": [1]})):
        with pytest.raises(D[0].base.MXNetError, match="elastic job"):
            call()


def test_store_get_num_dead_node_reads_the_scan_under_elastic(hb, monkeypatch, D):
    dist, _, touch = hb
    mx = D[0]
    touch(0)
    touch(1, age=300.0)
    kv_cls = mx.kvstore.KVStore
    kv = kv_cls.__new__(kv_cls)
    kv._type = "dist_sync"
    monkeypatch.delenv("MXNET_ELASTIC", raising=False)
    assert kv.get_num_dead_node() == 0  # gang scheduled: 0 while we run
    monkeypatch.setenv("MXNET_ELASTIC", "1")
    monkeypatch.setenv("MXNET_ELASTIC_DEAD_TIMEOUT", "60")
    assert kv.get_num_dead_node() == 1
    assert kv.get_num_dead_node(timeout=600) == 0


# --------------------------------------------- pause protocol (subprocess)
PAUSE_PROBE = r"""
import os, sys, json
os.environ["MXNET_ELASTIC"] = "1"
os.environ["MXNET_DEFAULT_CONTEXT"] = "cpu"
os.environ["MXNET_TPU_COORDINATOR"] = "127.0.0.1:%(port)d"
os.environ["MXNET_TPU_NUM_WORKERS"] = "1"
os.environ["MXNET_TPU_WORKER_ID"] = "0"
os.environ["MXNET_ELASTIC_REFORM_TIMEOUT"] = "20"
sys.path.insert(0, %(root)r)
import time
from mxnet_tpu_torch import dist
dist.init()
assert dist.generation() == 0 and dist.members() == [0] and dist.orig_rank() == 0
t0 = time.perf_counter()
assert dist.poll_pause() is None
assert time.perf_counter() - t0 < 2.0, "poll_pause blocked"
p1 = dist.propose_pause([0], round_no=10, margin=2)
assert p1["pause_at"] == 12 and p1["dead"] == [0] and p1["generation"] == 1, p1
# first-write-wins: a second proposal adopts the FIRST payload
p2 = dist.propose_pause([0], round_no=99)
assert p2 == p1, (p1, p2)
assert dist.poll_pause() == p1
store = dist.coordination_client()
assert json.loads(store.get("mxtpu-elastic/gen-1/pause")) == p1
dist.shutdown()
print("PAUSE_PROTO_OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_pause_kv_protocol_first_write_wins(tmp_path):
    script = tmp_path / "pause_probe.py"
    script.write_text(PAUSE_PROBE % {"port": _free_port(), "root": str(ROOT)})
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert "PAUSE_PROTO_OK" in r.stdout, (r.stdout + r.stderr)[-2000:]


# ------------------------------------------------- launches over gloo ranks
def _launch(tmp_path, n, script, args, env_extra=None, elastic=False, timeout=150):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MXNET_ELASTIC_REFORM_TIMEOUT="40", **(env_extra or {}))
    env.pop("MXNET_TELEMETRY", None)
    cmd = [sys.executable, str(ROOT / "tools" / "launch.py"), "-n", str(n), "--launcher",
           "local", "--cpu-devices", "1"] + (["--elastic"] if elastic else []) + [
        sys.executable, str(script)] + [str(a) for a in args]
    return subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=timeout)


SHARDED_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
os.environ.setdefault("MXNET_KVSTORE_BUCKET_MB", "0.001")
os.environ["MXNET_KVSTORE_UPDATE"] = "sharded"
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import checkpoint as ckpt

SHAPES = [(40, 4), (40,), (16, 40), (16,)]
workdir = sys.argv[1]


def store(opt=None):
    kv = pt.kv.create("dist_sync")
    kv.set_optimizer(opt or pt.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                                             rescale_grad=1.0 / 8))
    rs = np.random.RandomState(5)
    for i, s in enumerate(SHAPES):
        kv.init(i, pt.nd.array(rs.rand(*s).astype("float32")))
    return kv


def run(n_rounds, kv, start=0):
    rank = kv.rank
    outs = {i: pt.nd.zeros(s) for i, s in enumerate(SHAPES)}
    for step in range(start, start + n_rounds):
        rs = np.random.RandomState(1000 + step)
        for i in reversed(range(len(SHAPES))):
            g = rs.rand(*SHAPES[i]).astype("float32") - 0.5
            kv.push(i, pt.nd.array(g * (rank + 1)), priority=-i)
        for i in range(len(SHAPES)):
            kv.pull(i, out=outs[i], priority=-i)
    kv._barrier()
    return kv, {i: o.asnumpy() for i, o in outs.items()}


with pt.cpu():
    # (a) continuous 6 rounds -> reference weights
    _, ref = run(6, store())
    state_file = os.path.join(workdir, "opt.states")
    # (b) 3 rounds, save, reload into the same engine (same-W shard-direct:
    #     the plan hash matches -> preload), 3 more: bit parity
    kv2, mid = run(3, store())
    kv2.save_optimizer_states(state_file)
    kv2._barrier()
    assert ckpt.read_sharded_pointer(state_file) is not None, "sharded save must write a pointer"
    assert kv2._bucket_engine.mode == "sharded"
    kv2.load_optimizer_states(state_file)
    assert kv2._bucket_engine._preloaded_shards, "same-W load must take the shard-direct path"
    kv2, direct = run(3, kv2, start=3)
    for i in ref:
        np.testing.assert_array_equal(direct[i], ref[i])
    # (c) a fresh store with ANOTHER bucket plan -> re-flatten
    os.environ["MXNET_KVSTORE_BUCKET_MB"] = "0.0005"
    kv3, _ = run(3, store())
    kv3.load_optimizer_states(state_file)
    kv3, reflat = run(3, kv3, start=3)
    for i in ref:
        np.testing.assert_allclose(reflat[i], ref[i], atol=1e-6, rtol=0)
    # (d) the optimizer-kind guard: sgd states into adam raise
    kv4 = pt.kv.create("dist_sync")
    kv4.set_optimizer(pt.optimizer.Adam(learning_rate=0.01))
    for i, s in enumerate(SHAPES):
        kv4.init(i, pt.nd.array(np.zeros(s, "float32")))
    try:
        kv4.load_optimizer_states(state_file)
        raise AssertionError("kind mismatch must raise")
    except pt.MXNetError as e:
        assert "not portable" in str(e), e
    kv4._barrier()
print("SHARDED_STATES_OK rank %d" % kv2.rank, flush=True)
pt.dist.shutdown()
"""


def test_sharded_optimizer_states_2proc_parity(tmp_path):
    """JAX :333 on the port: same-W resume bit for bit (shard-direct),
    another bucket plan within 1e-6 (re-flatten), cross-kind loads raise.
    The set the ranks wrote reads back through the JAX package's readers,
    every re-flattened state equal to the port's."""
    script = tmp_path / "sharded_worker.py"
    script.write_text(SHARDED_WORKER)
    r = _launch(tmp_path, 2, script, [tmp_path])
    assert r.returncode == 0 and r.stdout.count("SHARDED_STATES_OK") == 2, \
        (r.stdout + r.stderr)[-4000:]
    ptr = pt_ckpt.read_sharded_pointer(str(tmp_path / "opt.states"))
    assert ptr == mxnet_tpu.checkpoint.read_sharded_pointer(str(tmp_path / "opt.states"))
    got = {}
    for name, ck in (("jax", mxnet_tpu.checkpoint), ("torch", pt_ckpt)):
        step, manifest = ck.latest_complete(ptr["dir"])
        flats = ck.read_flat_buckets(ptr["dir"], step, manifest)
        got[name] = (step, ck.per_key_states(manifest, flats),
                     ck.per_key_states(manifest, flats, weights=True))
    assert got["jax"][0] == got["torch"][0] == ptr["step"]
    for k, v in got["torch"][1].items():
        for a, b in zip(v, got["jax"][1][k]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["torch"][2][k], got["jax"][2][k])


RESUME_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
os.environ.setdefault("MXNET_KVSTORE_BUCKET_MB", "0.002")
os.environ["MXNET_KVSTORE_UPDATE"] = "sharded"
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import checkpoint as ckpt

workdir = sys.argv[1]
BATCH, BATCHES = 8, 6


def mlp():
    s = pt.sym.Variable("data")
    s = pt.sym.FullyConnected(s, num_hidden=24, name="fc1")
    s = pt.sym.Activation(s, act_type="relu")
    s = pt.sym.FullyConnected(s, num_hidden=4, name="fc2")
    return pt.sym.SoftmaxOutput(s, name="softmax")


pt.kv.create("dist_sync")
rank = int(os.environ["MXNET_TPU_WORKER_ID"])
rs = np.random.RandomState(100 + rank)
x = rs.rand(BATCHES * BATCH, 8).astype("float32")
y = rs.randint(0, 4, (BATCHES * BATCH,)).astype("float32")


def fit(ckpt_dir, num_epoch, resume, period):
    pt.random.seed(7)  # the same init in the three runs
    with pt.cpu():
        it = pt.io.NDArrayIter(x, y, batch_size=BATCH)
        mod = pt.mod.Module(mlp(), context=pt.cpu(), fused_step=False)
        mod.fit(it, num_epoch=num_epoch, kvstore="dist_sync", optimizer="sgd",
                optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9)),
                elastic={"checkpoint_dir": ckpt_dir, "checkpoint_period": period,
                         "resume": resume})
        a, _ = mod.get_params()
        assert mod._kvstore._bucket_engine.mode == "sharded"
        return {k: v.asnumpy() for k, v in a.items()}


dir_a = os.path.join(workdir, "ckpt-a")
fit(dir_a, 4, False, BATCHES)
got_b = fit(dir_a, 6, True, BATCHES)
got_c = fit(os.path.join(workdir, "ckpt-c"), 6, False, BATCHES)
for k in got_c:
    np.testing.assert_array_equal(got_b[k], got_c[k])  # BIT parity
print("RESUME_PARITY_OK rank %d" % rank, flush=True)

# a store whose COMMITTED plan matches the manifest loads through the
# already-assembled flat buckets: the preloaded slices equal the shard file
step, manifest = ckpt.latest_complete(dir_a)
with pt.cpu():
    kv = pt.kv.create("dist_sync")
    kv.set_optimizer(pt.optimizer.SGD(learning_rate=0.05, momentum=0.9))
    shapes = [(24, 8), (24,), (4, 24), (4,)]   # the mlp's params, in push order
    for i, s in enumerate(shapes):
        kv.init(i, pt.nd.zeros(s))
    outs = {i: pt.nd.zeros(s) for i, s in enumerate(shapes)}
    for i in reversed(range(len(shapes))):
        kv.push(i, pt.nd.ones(shapes[i]), priority=-i)
    for i in range(len(shapes)):
        kv.pull(i, out=outs[i], priority=-i)
    kv._barrier()
    eng = kv._bucket_engine
    assert eng.plan is not None and eng.plan.hash == manifest["plan_hash"], \
        (eng.plan and eng.plan.hash, manifest["plan_hash"])
    step2, _w = kv.load_sharded_checkpoint(dir_a)
    assert step2 == step
    local = ckpt.read_local_shard(dir_a, step, manifest, kv.rank)
    for b in manifest["plan"]["buckets"]:
        idx = int(b["index"])
        for i in range(manifest["optimizer"]["n_states"]):
            np.testing.assert_array_equal(np.asarray(eng._preloaded_shards[idx][i]),
                                          local["b%d.s%d" % (idx, i)])
    kv._barrier()
print("FLATS_SLICE_OK rank %d" % kv.rank, flush=True)
pt.dist.shutdown()
"""


def test_same_world_fit_resume_bit_parity(tmp_path):
    script = tmp_path / "resume_worker.py"
    script.write_text(RESUME_WORKER)
    r = _launch(tmp_path, 2, script, [tmp_path])
    assert r.returncode == 0 and r.stdout.count("RESUME_PARITY_OK") == 2 \
        and r.stdout.count("FLATS_SLICE_OK") == 2, (r.stdout + r.stderr)[-4000:]


CHAOS_WORKER = r"""
import json, os, signal, sys, threading, time
import numpy as np
import torch
torch.set_num_threads(1)
os.environ["MXNET_TELEMETRY"] = "counters"
os.environ.setdefault("MXNET_KVSTORE_BUCKET_MB", "0.002")
os.environ.setdefault("MXNET_KVSTORE_UPDATE", "sharded")
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import dist, telemetry

phase, workdir, ckpt_dir, mode = sys.argv[1:5]
EPOCHS, BATCHES, BATCH, KILL_ROUND, CKPT_PERIOD = 2, 12, 8, 8, 3


def mlp():
    s = pt.sym.Variable("data")
    s = pt.sym.FullyConnected(s, num_hidden=32, name="fc1")
    s = pt.sym.Activation(s, act_type="relu")
    s = pt.sym.FullyConnected(s, num_hidden=16, name="fc2")
    s = pt.sym.Activation(s, act_type="relu")
    s = pt.sym.FullyConnected(s, num_hidden=4, name="fc3")
    return pt.sym.SoftmaxOutput(s, name="softmax")


pt.kv.create("dist_sync")  # dist.init under the launcher's variables
orig = dist.orig_rank()
kill_rank = int(os.environ["MXNET_TPU_NUM_WORKERS"]) - 1
# the checkpoint.inflight gauge, sampled while training: the async write
# must overlap the steps
peak = {"inflight": 0.0}
stop = threading.Event()


def sample():
    g = telemetry.gauge("checkpoint.inflight")
    while not stop.is_set():
        if g.value:
            peak["inflight"] = max(peak["inflight"], g.value)
        time.sleep(0.0005)


threading.Thread(target=sample, daemon=True).start()
seen = {"rounds": 0}


def batch_cb(param):
    seen["rounds"] += 1
    if phase == "chaos" and orig == kill_rank and seen["rounds"] == KILL_ROUND:
        print("worker %d kills itself (%s) at round %d" % (orig, mode, KILL_ROUND), flush=True)
        os.kill(os.getpid(), signal.SIGKILL if mode == "crash" else signal.SIGTERM)


rs = np.random.RandomState(100 + orig)
x = rs.rand(BATCHES * BATCH, 8).astype("float32")
y = rs.randint(0, 4, (BATCHES * BATCH,)).astype("float32")
pt.random.seed(7)
with pt.cpu():
    mod = pt.mod.Module(mlp(), context=pt.cpu(), fused_step=False)
    ctl = mod.fit(pt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=EPOCHS,
                  kvstore="dist_sync", optimizer="sgd",
                  optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9), ("wd", 1e-4)),
                  batch_end_callback=batch_cb,
                  elastic={"checkpoint_dir": ckpt_dir, "checkpoint_period": CKPT_PERIOD,
                           "reseed": "checkpoint", "resume": phase == "control"})
stop.set()
if ctl.evicted:
    print("worker %d evicted cleanly at round %d" % (orig, ctl._round), flush=True)
    sys.exit(0)
rank, world = dist.rank(), dist.num_workers()
args, _ = mod.get_params()
if rank == 0:
    np.savez(os.path.join(workdir, "%s_final.npz" % phase),
             **{k: v.asnumpy() for k, v in args.items()})
    report = {"phase": phase, "world": world, "generation": dist.generation(),
              "members": dist.members(), "rounds": ctl._round,
              "peak_inflight": peak["inflight"],
              "rescale_grad": mod._optimizer.rescale_grad,
              "saves": telemetry.counter("checkpoint.saves").value,
              "recoveries": telemetry.counter("dist.recoveries").value,
              "elastic_state": mod._kvstore.elastic_state}
    with open(os.path.join(workdir, "%s_report.json" % phase), "w") as f:
        json.dump(report, f)
dist.shutdown()
"""


@pytest.mark.parametrize("mode", ["drain", "crash"])
def test_three_rank_elastic_job_survives_and_matches_a_two_rank_control(tmp_path, mode):
    """Rank 2 of three SIGTERMs (drain) or SIGKILLs (crash) itself at round
    8. Drain: it proposes the pause, everyone trains through the agreed
    round, it exits 0. Crash: the survivors' collective breaks, they wait
    out its stale heartbeat and recover from the checkpoint. Either way
    they re-form to generation 1 / world 2, rescale the gradients 3 → 2,
    reseed from the newest complete checkpoint and finish; a fresh two-rank
    job resumed from that step ends on the same weights."""
    script = tmp_path / "chaos_worker.py"
    script.write_text(CHAOS_WORKER)
    ckpt_dir = tmp_path / "ckpt"
    # a SIGKILLed worker is found by its stale heartbeat: a short staleness
    # window keeps the case quick (a drain needs none: it proposes itself)
    extra = ({"MXNET_ELASTIC_DEAD_TIMEOUT": "3", "MXNET_TPU_HEARTBEAT_INTERVAL": "0.2"}
             if mode == "crash" else {})
    r = _launch(tmp_path, 3, script, ["chaos", tmp_path, ckpt_dir, mode], extra, elastic=True)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "worker 2 kills itself (%s)" % mode in r.stdout, out[-4000:]
    if mode == "drain":
        assert "worker 2 evicted cleanly" in r.stdout, out[-4000:]
    report = json.loads((tmp_path / "chaos_report.json").read_text())
    assert report["world"] == 2 and report["generation"] == 1 and report["members"] == [0, 1]
    assert report["recoveries"] == 1 and report["elastic_state"] == "running"
    assert report["peak_inflight"] > 0, report
    assert report["rescale_grad"] == pytest.approx(1.0 / (8 * 2)), report
    # the step the survivors reseeded from: the newest complete world-3 one
    steps = [s for s in pt_ckpt.list_steps(str(ckpt_dir))
             if (pt_ckpt.load_manifest(str(ckpt_dir), s) or {}).get("world") == 3]
    complete = [s for s in steps if pt_ckpt._step_complete(
        str(ckpt_dir), s, pt_ckpt.load_manifest(str(ckpt_dir), s))]
    reseed = complete[-1]
    assert reseed == (9 if mode == "drain" else 6), (steps, complete)
    control_dir = tmp_path / "ckpt-control"
    shutil.copytree(pt_ckpt.step_dir(str(ckpt_dir), reseed),
                    pt_ckpt.step_dir(str(control_dir), reseed))
    r = _launch(tmp_path, 2, script, ["control", tmp_path, control_dir, mode], elastic=True)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    control = json.loads((tmp_path / "control_report.json").read_text())
    assert control["world"] == 2 and control["generation"] == 0
    assert control["rounds"] == report["rounds"] == 24
    chaos = np.load(tmp_path / "chaos_final.npz")
    ctl = np.load(tmp_path / "control_final.npz")
    assert set(chaos.files) == set(ctl.files)
    for k in chaos.files:
        np.testing.assert_allclose(chaos[k], ctl[k], atol=1e-6, rtol=0, err_msg=k)


def test_refresh_backend_keeps_readable_generators_and_drops_the_rest(monkeypatch):
    """JAX's ``refresh_backend`` re-materializes its key or drops an
    unreadable one; a torch generator outlives a process group, so the
    port keeps every readable generator (its state carries over) and drops
    one whose state cannot be read."""
    import torch

    from mxnet_tpu_torch import random as pt_random

    class _Poisoned:
        def get_state(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(pt_random, "_GENS", {})
    good = pt_random.generator("cpu")
    state = good.get_state().clone()
    pt_random._GENS[torch.device("cuda", 3)] = _Poisoned()
    pt_random.refresh_backend()
    assert pt_random._GENS == {torch.device("cpu"): good}
    assert torch.equal(pt_random.generator("cpu").get_state(), state)


REFUSE_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as pt

pt.kv.create("dist_sync")
with pt.cpu():
    s = pt.sym.SoftmaxOutput(pt.sym.FullyConnected(pt.sym.Variable("data"), num_hidden=3,
                                                   name="fc"), name="softmax")
    mod = pt.mod.Module(s, context=pt.cpu())  # a dist store engages the fused step
    it = pt.io.NDArrayIter(np.ones((8, 4), "f"), np.zeros(8, "f"), batch_size=4)
    try:
        mod.fit(it, num_epoch=1, kvstore="dist_sync", elastic={"checkpoint_dir": None})
        print("NOT REFUSED", flush=True)
    except pt.MXNetError as e:
        assert mod._spmd is not None
        # one write a line: the two ranks share the launcher's stdout
        print("REFUSED %s" % ("fused_step=False" in str(e)), flush=True)
pt.dist.shutdown()
"""


def test_the_fused_step_refuses_an_elastic_multi_process_job(tmp_path):
    """As in the JAX package (``mxnet_tpu/module/elastic.py:184``): the
    fused step cannot re-form its mesh, so an elastic job of two ranks
    that engages it raises, naming the per-key path."""
    script = tmp_path / "refuse_worker.py"
    script.write_text(REFUSE_WORKER)
    r = _launch(tmp_path, 2, script, [], elastic=True)
    assert r.returncode == 0 and r.stdout.count("REFUSED True") == 2, \
        (r.stdout + r.stderr)[-4000:]


CROSS_WORKER = r"""
import contextlib, os, sys
import numpy as np
os.environ["MXNET_KVSTORE_BUCKET_MB"] = "0.001"
os.environ["MXNET_KVSTORE_UPDATE"] = "sharded"
import %(pkg)s as mx

SHAPES = [(40, 4), (40,), (16, 40), (16,)]
workdir, other = sys.argv[1], sys.argv[2]
torch_port = mx.__name__ == "mxnet_tpu_torch"
if torch_port:
    import torch
    torch.set_num_threads(1)


def store():
    kv = mx.kv.create("dist_sync")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4,
                                      rescale_grad=1.0 / 8))
    rs = np.random.RandomState(5)
    for i, s in enumerate(SHAPES):
        kv.init(i, mx.nd.array(rs.rand(*s).astype("float32")))
    return kv


def run(kv, start, n):
    outs = {i: mx.nd.zeros(s) for i, s in enumerate(SHAPES)}
    for step in range(start, start + n):
        rs = np.random.RandomState(1000 + step)
        for i in reversed(range(len(SHAPES))):
            g = rs.rand(*SHAPES[i]).astype("float32") - 0.5
            kv.push(i, mx.nd.array(g * (kv.rank + 1)), priority=-i)
        for i in range(len(SHAPES)):
            kv.pull(i, out=outs[i], priority=-i)
    kv._barrier()
    return {"w%%d" %% i: o.asnumpy() for i, o in outs.items()}


with (mx.cpu() if torch_port else contextlib.nullcontext()):
    kv = store()
    run(kv, 0, 3)
    w = mx.checkpoint.Checkpointer(os.path.join(workdir, mx.__name__))
    w.save_sharded(kv, 3, meta={"rounds": 3}, block=True)
    w.close()
    kv._barrier()
    final = run(kv, 3, 3)
    np.savez(os.path.join(workdir, "%%s_final%%d.npz" %% (mx.__name__, kv.rank)), **final)
    if other != "-":
        # the other package's set seeds a fresh store, which trains on
        kv2 = store()
        step, _ = kv2.load_sharded_checkpoint(other)
        assert step == 3, step
        resumed = run(kv2, 3, 3)
        np.savez(os.path.join(workdir, "resumed%%d.npz" %% kv.rank), **resumed)
print("CROSS_OK %%s %%d" %% (mx.__name__, kv.rank), flush=True)
if torch_port:
    mx.dist.shutdown()
"""


def test_two_rank_sharded_sets_cross_between_the_packages(tmp_path):
    """The same two-rank sharded rounds in both packages, each saving with
    its own ``Checkpointer.save_sharded``: the manifests are equal but
    ``written_at`` (the same bucket plan and hash, slot map, optimizer,
    update counts), each set reads in both packages to the same arrays bit
    for bit, the two sets' arrays agree within rtol 1e-5, atol 1e-6, and
    the port's fresh store resumes from the JAX package's set to JAX's
    final weights within that tolerance."""
    script_jax = tmp_path / "cross_jax.py"
    script_jax.write_text(CROSS_WORKER % {"pkg": "mxnet_tpu"})
    r = _launch(tmp_path, 2, script_jax, [tmp_path, "-"], {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0 and r.stdout.count("CROSS_OK") == 2, (r.stdout + r.stderr)[-4000:]
    script_pt = tmp_path / "cross_torch.py"
    script_pt.write_text(CROSS_WORKER % {"pkg": "mxnet_tpu_torch"})
    r = _launch(tmp_path, 2, script_pt, [tmp_path, tmp_path / "mxnet_tpu"])
    assert r.returncode == 0 and r.stdout.count("CROSS_OK") == 2, (r.stdout + r.stderr)[-4000:]
    readers = {"jax": mxnet_tpu.checkpoint, "torch": pt_ckpt}
    got, manifests = {}, {}
    for writer in ("mxnet_tpu", "mxnet_tpu_torch"):
        root = str(tmp_path / writer)
        for name, ck in readers.items():
            step, manifest = ck.latest_complete(root)
            assert step == 3
            flats = ck.read_flat_buckets(root, step, manifest)
            got[writer, name] = (ck.per_key_states(manifest, flats),
                                 ck.per_key_states(manifest, flats, weights=True))
            manifests[writer] = {k: v for k, v in manifest.items() if k != "written_at"}
        for (sa, wa), (sb, wb) in [(got[writer, "jax"], got[writer, "torch"])]:
            for k in wa:
                np.testing.assert_array_equal(wa[k], wb[k])
                for x, y in zip(sa[k], sb[k]):
                    np.testing.assert_array_equal(x, y)
    assert manifests["mxnet_tpu"] == manifests["mxnet_tpu_torch"]
    sj, wj = got["mxnet_tpu", "torch"]
    st, wt = got["mxnet_tpu_torch", "jax"]
    for k in wj:
        np.testing.assert_allclose(wt[k], wj[k], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st[k][0], sj[k][0], rtol=1e-5, atol=1e-6)
    for r_ in range(2):
        want = np.load(tmp_path / ("mxnet_tpu_final%d.npz" % r_))
        resumed = np.load(tmp_path / ("resumed%d.npz" % r_))
        for k in want.files:
            np.testing.assert_allclose(resumed[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
