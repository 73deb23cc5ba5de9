"""The port's sharded asynchronous checkpoint (``mxnet_tpu_torch/checkpoint.py``)
and single-process ``fit(elastic=...)`` held against the JAX package's.

* Every case of the reference's ``tests/test_checkpoint.py`` on BOTH
  packages (fixture ``mx``, the port inside ``with cpu():``): the atomic
  writes and torn-file armour, the manifest/shard completeness contract, the
  re-flatten (``read_flat_buckets``/``per_key_states``), the pointer file,
  the async writer's supersede/latch/close behaviour and its
  ``checkpoint.inflight`` gauge, retention, and ``fit(elastic=...)``'s
  checkpoint-and-resume on the per-device path and through the fused step
  (momentum kept across the resume, within atol 1e-6 as the reference
  holds it; the port's is bitwise).
* Sets cross between the packages: a replicated set and a fake two-rank
  sharded set written by each package are read by the other, every array
  equal bit for bit and the manifests' fields equal but ``written_at`` (the
  wall clock at the write). The one file that does not cross both ways is
  the per-device path's ``states.bin``: it is each package's pickle of its
  own NDArrays, so the port reads the JAX package's (``convert.load_states``)
  and the JAX package reads the port's only through
  ``convert.updater_states_to_numpy``. A fused step's ``states.bin`` is
  numpy in both and crosses both ways.
* ``fit(elastic=...)`` in the port ends on the JAX package's final weights
  (rtol 1e-5, atol 1e-6) on the per-device path and through the fused step,
  and resumes from the JAX package's checkpoint set.
* The in-place trap: the fused step updates its state cell in place, so a
  save freezes a copy before it returns. A writer held busy while the next
  step runs still writes the saved step's bytes.
"""
import glob
import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


@pytest.fixture
def tm(mx):
    telemetry = mx.telemetry
    telemetry.reset()
    telemetry.clear_events()
    saved = telemetry.current_override()
    telemetry.set_mode("counters")
    yield telemetry
    telemetry.set_mode(saved)
    telemetry.reset()
    telemetry.clear_events()


def _fc_net(mx, hidden=2):
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=hidden, name="fc"), name="softmax")


# ------------------------------------------------------------ atomic writes
def test_atomic_write_bytes_replaces_whole_file(mx, tmp_path):
    p = str(tmp_path / "f.bin")
    mx.checkpoint.atomic_write_bytes(p, b"one")
    mx.checkpoint.atomic_write_bytes(p, b"two")
    assert open(p, "rb").read() == b"two"
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_atomic_replace_keeps_old_file_on_error(mx, tmp_path):
    ckpt = mx.checkpoint
    p = str(tmp_path / "f.bin")
    ckpt.atomic_write_bytes(p, b"good")
    with pytest.raises(RuntimeError):
        with ckpt.atomic_replace(p) as tmp:
            with open(tmp, "wb") as f:
                f.write(b"half-writ")
            raise RuntimeError("crash mid-save")
    assert open(p, "rb").read() == b"good"
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_load_ndarrays_checked_torn_file_names_path(mx, tmp_path):
    p = str(tmp_path / "torn.params")
    good = str(tmp_path / "good.params")
    mx.nd.save(good, {"w": mx.nd.ones((3,))})
    blob = open(good, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[: len(blob) // 2])  # torn mid-write
    with pytest.raises(mx.base.MXNetError, match="torn.params"):
        mx.checkpoint.load_ndarrays_checked(p)


def test_model_load_checkpoint_torn_params_structured(mx, tmp_path):
    prefix = str(tmp_path / "ck")
    mx.model.save_checkpoint(prefix, 1, _fc_net(mx), {"fc_weight": mx.nd.ones((2, 4))}, {})
    mx.nd.waitall()
    path = prefix + "-0001.params"
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(mx.base.MXNetError, match="0001.params"):
        mx.model.load_checkpoint(prefix, 1)


def test_module_optimizer_states_atomic_and_checked(mx, tmp_path):
    mod = mx.mod.Module(_fc_net(mx), context=mx.cpu(), fused_step=False)
    it = mx.io.NDArrayIter(np.random.RandomState(0).rand(8, 4).astype("f"),
                           np.zeros((8,), "f"), batch_size=4)
    mod.fit(it, num_epoch=1, optimizer="sgd", kvstore="local",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
    p = str(tmp_path / "opt.states")
    mod.save_optimizer_states(p)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    with open(p, "wb") as f:
        f.write(b"\x80\x04 torn!")
    with pytest.raises(mx.base.MXNetError, match="opt.states"):
        mod.load_optimizer_states(p)


# --------------------------------------------------- manifest / completeness
def _write_fake_sharded_step(ckpt, root, step, world=2, n_states=1, seed=0,
                             extra_files=(), break_shard=None, skip_manifest=False):
    """A minimal sharded checkpoint step written with ``ckpt``'s helpers (the
    reference test's): one bucket, two keys, flat total divisible by world.
    Returns the per-key host arrays the shards encode."""
    rs = np.random.RandomState(seed)
    k0, k1 = rs.rand(4).astype("f"), rs.rand(2, 3).astype("f")
    flat_w = np.concatenate([k0, k1.reshape(-1)])
    states = [np.arange(10, dtype="f") * (i + 1) for i in range(n_states)]
    d = ckpt.step_dir(root, step)
    os.makedirs(d, exist_ok=True)
    shard = 10 // world
    for r in range(world):
        arrays = {"b0.w": flat_w[r * shard:(r + 1) * shard]}
        for i, s in enumerate(states):
            arrays["b0.s%d" % i] = s[r * shard:(r + 1) * shard]
        buf = ckpt._npz_bytes(arrays)
        base = os.path.join(d, "shard-%05d-of-%05d" % (r, world))
        data = buf if break_shard != r else buf[: len(buf) // 2]
        ckpt.atomic_write_bytes(base + ".npz", data)
        ckpt.atomic_write_bytes(base + ".json", json.dumps(
            {"digest": ckpt._sha256(buf), "rank": r, "world": world,
             "step": step, "plan_hash": "fakehash", "nbytes": len(buf)}).encode())
    manifest = {
        "format": ckpt.FORMAT_VERSION, "kind": "sharded", "step": step,
        "world": world, "plan_hash": "fakehash",
        "plan": {"buckets": [{
            "index": 0, "dtype": "float32",
            "slots": [[0, 0, 4, [4], "float32", 0, 0, 1],
                      [1, 4, 6, [2, 3], "float32", 0, 0, 1]]}]},
        "optimizer": {"kind": "sgd", "n_states": n_states, "hyper": {}, "class": "SGD"},
        "update_counts": [[0, 7], [1, 7]], "num_update": 7,
        "files": sorted(extra_files), "meta": {}, "written_at": time.time(),
    }
    if not skip_manifest:
        ckpt.atomic_write_bytes(os.path.join(d, ckpt.MANIFEST_NAME),
                                json.dumps(manifest).encode())
    return {0: k0, 1: k1}, states


def test_latest_complete_skips_incomplete_steps(mx, tmp_path):
    root = str(tmp_path)
    _write_fake_sharded_step(mx.checkpoint, root, 10)
    _write_fake_sharded_step(mx.checkpoint, root, 20, skip_manifest=True)
    got = mx.checkpoint.latest_complete(root)
    assert got is not None and got[0] == 10


def test_latest_complete_rejects_missing_shard(mx, tmp_path):
    root = str(tmp_path)
    _write_fake_sharded_step(mx.checkpoint, root, 10)
    _write_fake_sharded_step(mx.checkpoint, root, 20)
    os.unlink(os.path.join(mx.checkpoint.step_dir(root, 20), "shard-00001-of-00002.npz"))
    assert mx.checkpoint.latest_complete(root)[0] == 10


def test_read_flat_buckets_and_per_key_states_roundtrip(mx, tmp_path):
    ckpt = mx.checkpoint
    root = str(tmp_path)
    keys, states = _write_fake_sharded_step(ckpt, root, 5, n_states=2)
    step, manifest = ckpt.latest_complete(root)
    flats = ckpt.read_flat_buckets(root, step, manifest)
    np.testing.assert_array_equal(flats[0]["states"][0], states[0])
    per_key = ckpt.per_key_states(manifest, flats)
    assert set(per_key) == {0, 1}
    assert per_key[1][1].shape == (2, 3)
    weights = ckpt.per_key_states(manifest, flats, weights=True)
    np.testing.assert_array_equal(weights[0], keys[0])
    np.testing.assert_array_equal(weights[1], keys[1])


def test_torn_shard_fails_digest_with_structured_error(mx, tmp_path):
    ckpt = mx.checkpoint
    root = str(tmp_path)
    _write_fake_sharded_step(ckpt, root, 5, break_shard=1)
    manifest = ckpt.load_manifest(root, 5)
    with pytest.raises(mx.base.MXNetError, match="digest|corrupt"):
        ckpt.read_local_shard(root, 5, manifest, 1)
    assert ckpt.latest_complete(root) is None


def test_read_sharded_pointer(mx, tmp_path):
    ckpt = mx.checkpoint
    p = str(tmp_path / "opt.states")
    ckpt.atomic_write_bytes(p, json.dumps(
        {"format": "mxtpu-sharded-states", "dir": "/x", "step": 3}).encode())
    got = ckpt.read_sharded_pointer(p)
    assert got["step"] == 3 and got["dir"] == "/x"
    ckpt.atomic_write_bytes(p, pickle.dumps({"classic": "blob"}))
    assert ckpt.read_sharded_pointer(p) is None
    assert ckpt.read_sharded_pointer(str(tmp_path / "absent")) is None


# ------------------------------------------------------------ async writer
def test_checkpointer_async_write_and_wait(mx, tmp_path, tm):
    ckpt = mx.checkpoint
    w = ckpt.Checkpointer(str(tmp_path), async_=True)
    job = w.save_replicated(3, {"w": np.ones((4,), "f")}, meta={"epoch": 0}, block=False)
    w.wait()
    assert job.error is None
    step, manifest = ckpt.latest_complete(str(tmp_path))
    assert step == 3 and manifest["kind"] == "replicated"
    blob = ckpt._load_npz_checked(os.path.join(ckpt.step_dir(str(tmp_path), 3), "weights.npz"))
    np.testing.assert_array_equal(blob["w"], np.ones((4,), "f"))


def test_checkpointer_supersede_drops_queued_job(mx, tmp_path, tm):
    ckpt = mx.checkpoint
    w = ckpt.Checkpointer(str(tmp_path), async_=True)
    gate = threading.Event()
    w._submit(gate.wait, step=1, block=False)   # writer busy until released
    w.save_replicated(2, {"w": np.zeros((2,), "f")}, block=False)
    w.save_replicated(3, {"w": np.ones((2,), "f")}, block=False)  # drops 2
    gate.set()
    w.wait()
    assert tm.counter("checkpoint.drops").value == 1
    steps = ckpt.list_steps(str(tmp_path))
    assert 3 in steps and 2 not in steps


def test_checkpointer_failure_latches_to_next_save(mx, tmp_path):
    ckpt = mx.checkpoint
    w = ckpt.Checkpointer(str(tmp_path), async_=True)

    def boom():
        raise RuntimeError("disk on fire")

    w._submit(boom, step=1, block=False)
    deadline = time.time() + 10
    while w._error is None and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(mx.base.MXNetError, match="disk on fire"):
        w.save_replicated(2, {"w": np.zeros((2,), "f")}, block=False)
    w.save_replicated(3, {"w": np.zeros((2,), "f")}, block=True)
    assert ckpt.latest_complete(str(tmp_path))[0] == 3


def test_checkpointer_close_stops_thread_even_on_latched_failure(mx, tmp_path):
    ckpt = mx.checkpoint
    w = ckpt.Checkpointer(str(tmp_path), async_=True)

    def boom():
        raise RuntimeError("disk on fire")

    w._submit(boom, step=1, block=False)
    deadline = time.time() + 10
    while w._error is None and time.time() < deadline:
        time.sleep(0.01)
    t = w._thread
    assert t is not None and t.is_alive()
    with pytest.raises(mx.base.MXNetError, match="disk on fire"):
        w.close()
    t.join(timeout=10)
    assert not t.is_alive() and w._thread is None
    w.save_replicated(2, {"w": np.zeros((2,), "f")}, block=True)
    assert ckpt.latest_complete(str(tmp_path))[0] == 2


def test_checkpoint_inflight_gauge_set_while_queued(mx, tmp_path, tm):
    w = mx.checkpoint.Checkpointer(str(tmp_path), async_=True)
    gate = threading.Event()
    w._submit(gate.wait, step=1, block=False)
    deadline = time.time() + 5
    while tm.gauge("checkpoint.inflight").value in (None, 0) and time.time() < deadline:
        time.sleep(0.005)
    assert tm.gauge("checkpoint.inflight").value >= 1
    gate.set()
    w.wait()
    assert tm.gauge("checkpoint.inflight").value == 0


def test_transient_write_error_is_retried_then_lands(mx, tmp_path, tm, monkeypatch):
    """``MXNET_CHECKPOINT_RETRIES``: an EIO on the first attempt is retried
    (``checkpoint.retries`` ticks) and the write lands; a non-transient
    error latches at once."""
    ckpt = mx.checkpoint
    monkeypatch.setenv("MXNET_CHECKPOINT_RETRIES", "2")
    assert ckpt.checkpoint_retries() == 2
    w = ckpt.Checkpointer(str(tmp_path), async_=True)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            import errno

            raise OSError(errno.EIO, "transient")

    w._submit(flaky, step=1, block=True)
    assert len(calls) == 2 and tm.counter("checkpoint.retries").value == 1
    with pytest.raises(mx.base.MXNetError, match="permission"):
        w._submit(lambda: (_ for _ in ()).throw(PermissionError("permission")), step=2,
                  block=True)
    monkeypatch.setenv("MXNET_CHECKPOINT_RETRIES", "lots")
    assert ckpt.checkpoint_retries() == 3
    monkeypatch.setenv("MXNET_CHECKPOINT_ASYNC", "0")
    assert not ckpt.checkpoint_async()
    monkeypatch.setenv("MXNET_CHECKPOINT_DIR", str(tmp_path))
    assert ckpt.checkpoint_dir() == str(tmp_path)


# --------------------------------------------------------------- retention
def test_apply_retention_keeps_newest_complete_and_protected(mx, tmp_path):
    ckpt = mx.checkpoint
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        _write_fake_sharded_step(ckpt, root, s)
    victims = ckpt.apply_retention(root, keep=2, protect_step=1)
    assert sorted(victims) == [2]
    assert sorted(ckpt.list_steps(root)) == [1, 3, 4]


def test_prefix_retention_spares_newest_complete_manifest(mx, tmp_path):
    ckpt = mx.checkpoint
    prefix = str(tmp_path / "run")
    shard_root = str(tmp_path / "run-0002.states.sharded")
    _write_fake_sharded_step(ckpt, shard_root, 7)
    for ep in (1, 2, 3, 4):
        ckpt.atomic_write_bytes("%s-%04d.params" % (prefix, ep), b"P")
    ckpt.atomic_write_bytes("%s-0002.states" % prefix, json.dumps(
        {"format": "mxtpu-sharded-states", "dir": shard_root, "step": 7}).encode())
    for ep in (3, 4):
        ckpt.atomic_write_bytes("%s-%04d.states" % (prefix, ep), json.dumps(
            {"format": "mxtpu-sharded-states", "dir": str(tmp_path / "nope"),
             "step": 1}).encode())
    victims = ckpt.prefix_retention(prefix, keep=1)
    assert sorted(victims) == [1, 3]
    assert os.path.exists("%s-0002.params" % prefix)
    assert os.path.exists(ckpt.step_dir(shard_root, 7))
    assert ckpt.prefix_retention(prefix, keep=None) == []


def test_prefix_retention_removes_sharded_backing_dir(mx, tmp_path):
    ckpt = mx.checkpoint
    prefix = str(tmp_path / "run")
    shard_root = str(tmp_path / "run-0001.states.sharded")
    _write_fake_sharded_step(ckpt, shard_root, 3)
    for ep in (1, 2, 3):
        ckpt.atomic_write_bytes("%s-%04d.params" % (prefix, ep), b"P")
    ckpt.atomic_write_bytes("%s-0001.states" % prefix, json.dumps(
        {"format": "mxtpu-sharded-states", "dir": shard_root, "step": 3}).encode())
    victims = ckpt.prefix_retention(prefix, keep=1)
    assert 1 in victims
    assert not os.path.exists(shard_root)


def test_module_checkpoint_callback_retention(mx, tmp_path):
    mod = mx.mod.Module(_fc_net(mx), context=mx.cpu(), fused_step=False)
    it = mx.io.NDArrayIter(np.random.RandomState(0).rand(8, 4).astype("f"),
                           np.zeros((8,), "f"), batch_size=4)
    cb = mx.callback.module_checkpoint(mod, str(tmp_path / "m"), keep=2)
    mod.fit(it, num_epoch=5, optimizer="sgd", kvstore="local", epoch_end_callback=cb)
    left = sorted(glob.glob(str(tmp_path / "m-*.params")))
    assert len(left) == 2 and left[-1].endswith("m-0005.params")


def test_callback_negative_keep_disables_retention(mx, tmp_path):
    prefix = str(tmp_path / "m")
    for ep in (1, 2, 3):
        with open("%s-%04d.params" % (prefix, ep), "wb") as f:
            f.write(b"x")
    mx.callback._apply_keep(prefix, -1)
    assert len(glob.glob(prefix + "-*.params")) == 3


def test_checkpoint_keep_env_parsing(mx, monkeypatch):
    ckpt = mx.checkpoint
    monkeypatch.delenv("MXNET_CHECKPOINT_KEEP", raising=False)
    assert ckpt.checkpoint_keep() is None
    monkeypatch.setenv("MXNET_CHECKPOINT_KEEP", "4")
    assert ckpt.checkpoint_keep() == 4
    monkeypatch.setenv("MXNET_CHECKPOINT_KEEP", "-1")
    assert ckpt.checkpoint_keep() is None
    monkeypatch.setenv("MXNET_CHECKPOINT_KEEP", "lots")
    assert ckpt.checkpoint_keep() is None


# ------------------------------------------------------- single-proc elastic
def _fc3_data():
    rs = np.random.RandomState(0)
    return rs.rand(24, 4).astype("f"), rs.randint(0, 3, (24,)).astype("f")


def test_elastic_fit_single_process_checkpoints_and_resumes(mx, tmp_path):
    sym = _fc_net(mx, 3)
    x, y = _fc3_data()
    root = str(tmp_path / "ck")
    mod = mx.mod.Module(sym, context=mx.cpu(), fused_step=False)
    ctl = mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2, optimizer="sgd",
                  kvstore="local", optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9)),
                  elastic={"checkpoint_dir": root, "checkpoint_period": 4})
    assert not ctl.evicted and ctl._round == 12
    step, manifest = mx.checkpoint.latest_complete(root)
    assert step == 12 and manifest["meta"]["epoch"] == 1
    w_full = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod2 = mx.mod.Module(sym, context=mx.cpu(), fused_step=False)
    ctl2 = mod2.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2, optimizer="sgd",
                    kvstore="local",
                    optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9)),
                    elastic={"checkpoint_dir": root, "checkpoint_period": 0, "resume": True})
    assert ctl2._round == 12
    w_res = {k: v.asnumpy() for k, v in mod2.get_params()[0].items()}
    for k in w_full:
        np.testing.assert_array_equal(w_res[k], w_full[k])


def _fused_fit(mx, root, num_epoch, resume, period=6, params=None):
    """The reference's fused-step elastic fit: lr 0.1, momentum 0.9, a
    checkpoint every epoch (6 batches)."""
    x, y = _fc3_data()
    mx.random.seed(7)
    mod = mx.mod.Module(_fc_net(mx, 3), context=mx.cpu())  # fused_step default
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=num_epoch, optimizer="sgd",
            kvstore="local", optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)),
            arg_params=params,
            elastic={"checkpoint_dir": root, "checkpoint_period": period, "resume": resume})
    assert mod._spmd is not None, "fused path did not engage"
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_elastic_fit_fused_spmd_saves_and_restores_optimizer_state(mx, tmp_path, monkeypatch):
    """JAX :416: the fused step owns the optimizer state; a resume restores
    momentum, so a resumed run matches an uninterrupted one (atol 1e-6 as
    the reference; the port's is bitwise)."""
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    root = str(tmp_path / "ck")
    _fused_fit(mx, root, 2, False)
    step, _ = mx.checkpoint.latest_complete(root)
    assert os.path.exists(os.path.join(mx.checkpoint.step_dir(root, step), "states.bin"))
    _, resumed = _fused_fit(mx, root, 4, True)
    _, reference = _fused_fit(mx, str(tmp_path / "ck-ref"), 4, False)
    for k in reference:
        np.testing.assert_allclose(resumed[k], reference[k], atol=1e-6, rtol=0, err_msg=k)
        if mx is pt:
            np.testing.assert_array_equal(resumed[k], reference[k], err_msg=k)


# ------------------------------------------------------ across the packages
def _manifest_fields(m):
    """A manifest without its wall clock, the one field that differs."""
    return {k: v for k, v in m.items() if k != "written_at"}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_replicated_set_written_by_either_package_reads_in_the_other(tmp_path, writer):
    rs = np.random.RandomState(11)
    weights = {"arg:fc_weight": rs.rand(3, 4).astype("f"), "arg:fc_bias": rs.rand(3).astype("f"),
               "aux:bn_moving_mean": rs.rand(3).astype("f")}
    states = pickle.dumps({"t": np.int32(5), "mom": {"fc_weight": rs.rand(3, 4).astype("f")}})
    extra = {"aux:extra": rs.rand(2, 2).astype("f")}
    sets = {}
    for name, ck in (("jax", mxnet_tpu.checkpoint), ("torch", pt.checkpoint)):
        root = str(tmp_path / name)
        w = ck.Checkpointer(root)
        w.save_replicated(7, weights, states_bytes=states, extra=extra,
                          meta={"epoch": 1, "nbatch": 2, "round": 7}, block=True)
        w.close()
        sets[name] = root
    reader = pt.checkpoint if writer == "jax" else mxnet_tpu.checkpoint
    other = mxnet_tpu.checkpoint if writer == "jax" else pt.checkpoint
    root = sets[writer]
    step, manifest = reader.latest_complete(root)
    _, own = other.latest_complete(sets["torch" if writer == "jax" else "jax"])
    assert step == 7 and _manifest_fields(manifest) == _manifest_fields(own)
    d = reader.step_dir(root, 7)
    blob = reader._load_npz_checked(os.path.join(d, "weights.npz"))
    assert set(blob) == set(weights)
    for k, v in weights.items():
        np.testing.assert_array_equal(blob[k], v)
    with open(os.path.join(d, "states.bin"), "rb") as f:
        assert f.read() == states
    np.testing.assert_array_equal(
        reader._load_npz_checked(os.path.join(d, "aux:extra"))["value"], extra["aux:extra"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_set_written_by_either_package_reads_in_the_other(tmp_path, writer):
    """The fake two-rank set of the reference's test, written with one
    package's helpers and re-flattened by the other's, and the torn shard
    refused by both."""
    ck_w = mxnet_tpu.checkpoint if writer == "jax" else pt.checkpoint
    ck_r = pt.checkpoint if writer == "jax" else mxnet_tpu.checkpoint
    root = str(tmp_path)
    keys, states = _write_fake_sharded_step(ck_w, root, 5, n_states=2)
    _write_fake_sharded_step(ck_w, root, 6, break_shard=0)
    step, manifest = ck_r.latest_complete(root)
    assert step == 5
    for r in range(2):
        a = ck_r.read_local_shard(root, 5, manifest, r)
        b = ck_w.read_local_shard(root, 5, manifest, r)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    flats = ck_r.read_flat_buckets(root, step, manifest)
    weights = ck_r.per_key_states(manifest, flats, weights=True)
    for k in keys:
        np.testing.assert_array_equal(weights[k], keys[k])
    np.testing.assert_array_equal(flats[0]["states"][1], states[1])
    with pytest.raises(Exception, match="digest|corrupt"):
        ck_r.read_local_shard(root, 6, ck_r.load_manifest(root, 6), 0)


def _per_device_fit(mx, root, num_epoch, params, resume=False, period=6):
    x, y = _fc3_data()
    mod = mx.mod.Module(_fc_net(mx, 3), context=mx.cpu(), fused_step=False)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=num_epoch, optimizer="sgd",
            kvstore="local",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4)),
            arg_params=params,
            elastic={"checkpoint_dir": root, "checkpoint_period": period, "resume": resume})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _init_params():
    rs = np.random.RandomState(21)
    return {"fc_weight": (rs.randn(3, 4) * 0.3).astype("f"), "fc_bias": np.zeros(3, "f")}


@pytest.mark.parametrize("path", ["per_device", "fused"])
def test_elastic_fit_matches_jax_and_resumes_from_its_checkpoint(tmp_path, monkeypatch, path):
    """The port's fit(elastic=...) from the same numpy weights ends on the
    JAX package's final weights (rtol 1e-5, atol 1e-6), per-device and
    through the fused step; the port then resumes from the JAX package's
    epoch-2 checkpoint set and lands on JAX's 4-epoch weights too. Through
    the fused step the JAX package resumes from the port's set as well (its
    ``states.bin`` is numpy in both)."""
    params = _init_params()
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1" if path == "fused" else "0")

    def run(pkg, root, num_epoch, resume=False):
        p = {k: pkg.nd.array(v) for k, v in params.items()}
        if path == "fused":
            return _fused_fit(pkg, root, num_epoch, resume, params=p)[1]
        return _per_device_fit(pkg, root, num_epoch, p, resume)

    want = run(mxnet_tpu, str(tmp_path / "jax-full"), 4)
    run(mxnet_tpu, str(tmp_path / "jax-half"), 2)
    with pt.cpu():
        got = run(pt, str(tmp_path / "pt-full"), 4)
        run(pt, str(tmp_path / "pt-half"), 2)
        resumed = run(pt, str(tmp_path / "jax-half"), 4, resume=True)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(resumed[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    if path == "fused":
        back = run(mxnet_tpu, str(tmp_path / "pt-half"), 4, resume=True)
        for k, v in want.items():
            np.testing.assert_allclose(back[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_sparse_sharded_set_crosses_between_the_packages(tmp_path):
    """A local store's row-sparse table trained in one package, saved with
    ``save_sharded`` and loaded by the other's fresh store: weights, state
    rows, the touched set and update counts bit for bit, both ways; the
    manifests' fields are equal but ``written_at``."""
    V, D = 24, 4
    rs = np.random.RandomState(4)
    w0 = rs.rand(V, D).astype("float32")
    rounds = [(rs.randint(0, V, (6,)), rs.rand(6, D).astype("float32")) for _ in range(3)]
    saved = {}
    for name, pkg in (("jax", mxnet_tpu), ("torch", pt)):
        with pt.cpu():
            kv = pkg.kv.create("local")
            kv.set_optimizer(pkg.optimizer.Adam(learning_rate=0.01))
            kv.init("emb", pkg.nd.array(w0))
            for ids, og in rounds:
                kv.push("emb", pkg.sparse.embedding_backward(ids, pkg.nd.array(og), V))
            w = pkg.checkpoint.Checkpointer(str(tmp_path / name))
            w.save_sharded(kv, 9, block=True)
            w.close()
            saved[name] = kv
    mj = mxnet_tpu.checkpoint.load_manifest(str(tmp_path / "jax"), 9)
    mt = pt.checkpoint.load_manifest(str(tmp_path / "torch"), 9)
    assert _manifest_fields(mj) == _manifest_fields(mt)
    for writer, reader in (("jax", pt), ("torch", mxnet_tpu)):
        with pt.cpu():
            kv2 = reader.kv.create("local")
            opt2 = reader.optimizer.Adam(learning_rate=0.01)
            kv2.set_optimizer(opt2)
            kv2.init("emb", reader.nd.zeros((V, D)))
            step, _ = kv2.load_sharded_checkpoint(str(tmp_path / writer))
            assert step == 9
            b = reader.nd.zeros((V, D))
            kv2.pull("emb", out=b)
        src = saved[writer]
        np.testing.assert_array_equal(b.asnumpy(), src._store["emb"].asnumpy())
        st1, st2 = src._updater.states["emb"], kv2._updater.states["emb"]
        assert type(st2).__name__ == "RowSparseState"
        np.testing.assert_array_equal(st1.indices, st2.indices)
        for x_, y_ in zip(st1.rows, st2.rows):
            np.testing.assert_array_equal(x_, y_)
        assert opt2._index_update_count == src._optimizer._index_update_count


# ------------------------------------------------------------ in-place trap
def test_a_save_keeps_its_steps_bytes_while_the_next_step_runs(tmp_path, monkeypatch):
    """The fused step updates its flat buffers in place. A save taken after
    step 2, queued behind a busy writer while step 3 runs, still writes
    step 2's weights and momentum (the JAX package can hand its writer
    references; the port must freeze a copy first)."""
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    x, y = _fc3_data()
    with pt.cpu():
        mod = pt.mod.Module(_fc_net(pt, 3), context=pt.cpu())
        it = pt.io.NDArrayIter(x, y, batch_size=4)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: pt.nd.array(v) for k, v in _init_params().items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
        batches = list(it)
        for b in batches[:2]:
            mod.forward_backward(b)
            mod.update()
        at_save = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
        states_at_save = pickle.loads(mod._spmd.get_states())
        w = pt.checkpoint.Checkpointer(str(tmp_path))
        gate = threading.Event()
        w._submit(gate.wait, step=0, block=False)  # the writer is busy
        weights, states = mod._spmd.freeze()
        w.save_replicated(2, weights, states_bytes=states, block=False)
        mod.forward_backward(batches[2])
        mod.update()
        after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        assert any(not np.array_equal(after[k], at_save[k]) for k in at_save)
        gate.set()
        w.close()
    d = pt.checkpoint.step_dir(str(tmp_path), 2)
    blob = pt.checkpoint._load_npz_checked(os.path.join(d, "weights.npz"))
    for k, v in at_save.items():
        np.testing.assert_array_equal(blob["arg:" + k], v)
    with open(os.path.join(d, "states.bin"), "rb") as f:
        written = pickle.load(f)
    assert int(written["t"]) == int(states_at_save["t"]) == 2
    for k, v in states_at_save["mom"].items():
        np.testing.assert_array_equal(written["mom"][k], v)


def test_freeze_copies_tensors_now_and_keeps_numpy(tmp_path):
    ckpt = pt.checkpoint
    t = torch.arange(6, dtype=torch.float32)
    frozen = ckpt.freeze(t)
    view = ckpt.FrozenView(frozen, 2, 4, (2, 2))
    t.add_(100)  # the next step, in place
    np.testing.assert_array_equal(frozen.numpy(), np.arange(6, dtype="f"))
    np.testing.assert_array_equal(view.numpy(), np.arange(2, 6, dtype="f").reshape(2, 2))
    a = np.ones(3, "f")
    assert ckpt.freeze(a) is a and ckpt.freeze(frozen) is frozen
    nd = pt.nd.array(np.ones(2, "f"), ctx=pt.cpu())
    f2 = ckpt.freeze(nd)
    nd[:] = 5.0
    np.testing.assert_array_equal(f2.numpy(), np.ones(2, "f"))


# ------------------------------------------- one rank of dist_sync, sharded
def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_rank_sharded_save_and_resume_is_bitwise(tmp_path, monkeypatch):
    """The smoke's sharded-set case at a small size, on one gloo rank: under
    ``MXNET_KVSTORE_UPDATE=sharded`` one worker runs the bucket engine (the
    JAX package builds none for one process), ``save_sharded`` every 2
    steps writes complete, digest-checked sets, and a fresh module seeded by
    ``load_sharded_checkpoint`` from the newest one continues to the
    uninterrupted run's bits. The one-rank engine is held against the JAX
    package's one-process ``dist_sync`` run (the per-key Updater) on the same
    inputs: the saved step's weights, momentum and update counts, and the
    uninterrupted run's final weights and momentum (rtol 1e-5, atol 1e-6)."""
    rs = np.random.RandomState(3)
    x, y = rs.rand(6 * 8, 12).astype("f"), rs.randint(0, 4, 6 * 8).astype("f")
    init = {"fc1_weight": rs.randn(16, 12).astype("f") * 0.2, "fc1_bias": np.zeros(16, "f"),
            "fc2_weight": rs.randn(4, 16).astype("f") * 0.2, "fc2_bias": np.zeros(4, "f")}

    def net_of(pkg):
        s = pkg.sym
        return s.SoftmaxOutput(s.FullyConnected(s.Activation(s.FullyConnected(
            s.Variable("data"), num_hidden=16, name="fc1"), act_type="relu"), num_hidden=4,
            name="fc2"), name="softmax")

    # the reference: one JAX process, dist_sync, no engine (the coordinator
    # variables are not set yet, so its dist.init is a no-op)
    jm = mxnet_tpu.mod.Module(net_of(mxnet_tpu), context=mxnet_tpu.cpu(), fused_step=False)
    jm.bind([("data", (8, 12))], [("softmax_label", (8,))])
    jm.init_params(arg_params={k: mxnet_tpu.nd.array(v) for k, v in init.items()})
    jm.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
    jkv = jm._kvstore
    assert jkv.num_workers == 1 and jkv._bucket_engine is None and jm._update_on_kvstore
    ref = {}
    for i in range(6):
        jm.forward_backward(mxnet_tpu.io.DataBatch(
            data=[mxnet_tpu.nd.array(x[i * 8:(i + 1) * 8])],
            label=[mxnet_tpu.nd.array(y[i * 8:(i + 1) * 8])]))
        jm.update()
        if i + 1 in (4, 6):
            ref[i + 1] = ({k: v.asnumpy() for k, v in jm.get_params()[0].items()},
                          {k: v.asnumpy() for k, v in jkv._updater.states.items()},
                          dict(jkv._optimizer._index_update_count))
    for k, v in {"MXNET_TPU_COORDINATOR": "127.0.0.1:%d" % _free_port(),
                 "MXNET_TPU_NUM_WORKERS": "1", "MXNET_TPU_WORKER_ID": "0",
                 "MXNET_MODULE_FUSED_STEP": "0", "MXNET_KVSTORE_UPDATE": "sharded",
                 "MXNET_KVSTORE_BUCKET_MB": "0.01"}.items():
        monkeypatch.setenv(k, v)
    ckpt = pt.checkpoint
    net = net_of(pt)
    root, root_end = str(tmp_path / "sharded"), str(tmp_path / "end")
    with pt.cpu():
        batches = [pt.io.DataBatch(data=[pt.nd.array(x[i * 8:(i + 1) * 8])],
                                   label=[pt.nd.array(y[i * 8:(i + 1) * 8])]) for i in range(6)]

        def module():
            m = pt.mod.Module(net, context=pt.cpu())
            m.bind([("data", (8, 12))], [("softmax_label", (8,))])
            m.init_params(arg_params={k: pt.nd.array(v) for k, v in init.items()})
            m.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                             optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
            return m

        try:
            m = module()
            kv = m._kvstore
            assert kv.num_workers == 1 and m._spmd is None
            w = ckpt.Checkpointer(root)
            for i, b in enumerate(batches):
                m.forward_backward(b)
                m.update()
                if (i + 1) % 2 == 0 and i + 1 < 6:
                    assert kv._bucket_engine.mode == "sharded"
                    w.save_sharded(kv, i + 1, meta={"nbatch": i})
            w.close()
            want = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
            end = ckpt.Checkpointer(root_end)
            end.save_sharded(kv, 6, block=True)
            end.close()
            step, manifest = ckpt.latest_complete(root)
            assert step == 4 and manifest["world"] == 1
            assert ckpt.list_steps(root) == [2, 4]
            assert len(ckpt.read_shard_set(root, step, manifest)) == 1
            m2 = module()
            loaded, weights = m2._kvstore.load_sharded_checkpoint(root)
            names = m2._param_names
            m2.set_params({names[k]: pt.nd.array(v) for k, v in weights.items()}, {},
                          allow_missing=True)
            for b in batches[4:]:
                m2.forward_backward(b)
                m2.update()
            got = {k: v.asnumpy() for k, v in m2.get_params()[0].items()}
        finally:
            pt.dist.shutdown()
    assert loaded == 4 and not pt.dist.is_initialized()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the one-rank engine against the JAX package's per-key Updater
    for at, (rroot, final) in ((4, (root, weights)), (6, (root_end, want))):
        jw, jstates, jcounts = ref[at]
        man = ckpt.load_manifest(rroot, at)
        states = ckpt.per_key_states(man, ckpt.read_flat_buckets(rroot, at, man))
        names = ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
        assert sorted(states) == sorted(jstates) == [0, 1, 2, 3]
        for key, (mom,) in states.items():
            np.testing.assert_allclose(mom, jstates[key], rtol=1e-5, atol=1e-6,
                                       err_msg="momentum %s at step %d" % (names[key], at))
        for k, v in final.items():
            name = names[k] if isinstance(k, int) else k
            np.testing.assert_allclose(v, jw[name], rtol=1e-5, atol=1e-6,
                                       err_msg="%s at step %d" % (name, at))
        assert {int(k): int(c) for k, c in man["update_counts"]} == jcounts
        assert int(man["num_update"]) == at
    # the JAX package's readers take the port's one-rank set as well
    jm = mxnet_tpu.checkpoint.load_manifest(root, 4)
    assert _manifest_fields(jm) == _manifest_fields(manifest)
    flats = mxnet_tpu.checkpoint.read_flat_buckets(root, 4, jm)
    for k, v in mxnet_tpu.checkpoint.per_key_states(jm, flats, weights=True).items():
        np.testing.assert_array_equal(v, weights[k])
