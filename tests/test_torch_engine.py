"""InferenceEngine of the port held against the JAX package's.

Every engine case of the reference's own tests (``tests/test_serving.py``
and ``tests/test_resilience.py``) runs here on BOTH packages, the port on
``cpu()``: bucket choice, partial batches at the batching deadline, a full
bucket before it, oversize refusal, non-batch-major outputs, cross-thread
FIFO, pad-to-bucket, deadlines, shedding, retry, health, hitless reload,
close and the latch. Each package answers with its own error types and
counters; the cases check that both give the same outputs (within rtol
1e-5, atol 1e-6 of each other and of numpy), the same error classes by
name and the same ``health()`` keys and states.

The execution engine (``mxnet_tpu_torch/engine.py``) follows: the cases of
the reference's ``tests/test_engine.py`` run on the port's three backends
(``NaiveEngine``, the native ``ThreadedEngine`` over ``src/engine_native.cc``
built into ``build/torch_native/``, and the Python pool), and the
engine-queued ``model.save_checkpoint`` writes the bytes the JAX package's
writes for the same parameters on ``cpu()``, drained by ``nd.waitall``.
"""
import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import faultinject as mx_fi
from mxnet_tpu import telemetry as mx_tm
from mxnet_tpu import serving as mx_serving
from mxnet_tpu_torch import faultinject as pt_fi
from mxnet_tpu_torch import serving as pt_serving
from mxnet_tpu_torch import telemetry as pt_tm

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


class Pkg:
    def __init__(self, name, mod, tm, fi, serving):
        self.name, self.mod, self.tm, self.fi, self.serving = name, mod, tm, fi, serving
        self.MXNetError = mod.MXNetError if hasattr(mod, "MXNetError") else mod.base.MXNetError

    def __repr__(self):
        return self.name


PKGS = {"jax": Pkg("jax", mx, mx_tm, mx_fi, mx_serving),
        "torch": Pkg("torch", pt, pt_tm, pt_fi, pt_serving)}


@pytest.fixture(params=["jax", "torch"])
def P(request):
    p = PKGS[request.param]
    saved = p.tm.current_override()
    p.tm.reset()
    p.tm.clear_events()
    p.tm.set_mode("counters")
    p.fi.reset_stats()
    yield p
    p.tm.set_mode(saved)
    p.tm.reset()
    p.fi.reset_stats()


def _mlp_net(P):
    net = P.mod.sym.FullyConnected(P.mod.sym.Variable("data"), num_hidden=5, name="fc")
    return P.mod.sym.SoftmaxOutput(net, name="softmax")


def _mlp_params(seed=0):
    rs = np.random.RandomState(seed)
    return {"fc_weight": rs.randn(5, 8).astype("float32"),
            "fc_bias": rs.randn(5).astype("float32")}


def _softmax_ref(params, x):
    z = x.astype(np.float64) @ params["fc_weight"].T.astype(np.float64) + params["fc_bias"]
    z = np.exp(z - z.max(axis=1, keepdims=True))
    return z / z.sum(axis=1, keepdims=True)


def _cache(P, net=None, params=None, **kw):
    return P.serving.PersistentExecutableCache(
        net if net is not None else _mlp_net(P), params if params is not None else _mlp_params(),
        {}, ctx=P.mod.cpu(), **kw)


def _engine(P, **kw):
    params = kw.pop("params", None) or _mlp_params()
    kw.setdefault("buckets", (1, 2, 4))
    return P.serving.InferenceEngine(_cache(P, params=params), {"data": (8,)}, **kw)


def _x(rows=1, fill=1.0):
    return {"data": np.full((rows, 8), fill, "float32")}


def _counters(P):
    return P.tm.counters()


def _direct(P, net, params, x_padded):
    exe = net.simple_bind(P.mod.cpu(), grad_req="null", data=x_padded.shape)
    for k, v in params.items():
        exe.arg_dict[k][:] = v
    exe.arg_dict["data"][:] = x_padded
    exe.forward(is_train=False)
    return exe.outputs[0].asnumpy()


# ------------------------------------------------------------ batching
def test_pad_to_bucket_bitwise(P):
    net, params = _mlp_net(P), _mlp_params()
    rs = np.random.RandomState(3)
    x = rs.rand(3, 8).astype("float32")
    with P.serving.InferenceEngine(_cache(P, net, params), {"data": (8,)}, buckets=(4, 8),
                                   max_delay_ms=1) as eng:
        got = eng.infer({"data": x})[0]
    pad = np.zeros((4, 8), "float32")
    pad[:3] = x
    np.testing.assert_array_equal(got, _direct(P, net, params, pad)[:3])
    np.testing.assert_allclose(got, _softmax_ref(params, x), rtol=RTOL, atol=ATOL)


def test_bucket_selection_smallest_covering(P):
    eng = P.serving.InferenceEngine(_cache(P), {"data": (8,)}, buckets=(1, 2, 4, 8),
                                    max_delay_ms=0).start()
    try:
        for rows, want_bucket in ((1, 1), (2, 2), (3, 4), (5, 8)):
            c0 = _counters(P)
            out = eng.infer({"data": np.zeros((rows, 8), "float32")})
            assert out[0].shape == (rows, 5)
            got = _counters(P)["serving.batch_capacity"] - c0.get("serving.batch_capacity", 0)
            assert got == want_bucket, (rows, got, want_bucket)
    finally:
        eng.close()


def test_deadline_triggered_partial_batch(P):
    eng = P.serving.InferenceEngine(_cache(P), {"data": (8,)}, buckets=(8,),
                                    max_delay_ms=50).start()
    try:
        t0 = time.perf_counter()
        f1 = eng.submit({"data": np.zeros((1, 8), "float32")})
        f2 = eng.submit({"data": np.zeros((2, 8), "float32")})
        r = f1.result(timeout=10.0)
        waited = time.perf_counter() - t0
        f2.result(timeout=10.0)
        assert r[0].shape == (1, 5)
        snap = _counters(P)
        assert snap["serving.batches"] == 1
        assert snap["serving.batch_items"] == 3
        assert snap["serving.batch_capacity"] == 8
        assert waited >= 0.045, "dispatched before the deadline"
        assert P.tm.gauge("serving.batch_occupancy").value == pytest.approx(3 / 8)
    finally:
        eng.close()


def test_full_bucket_dispatches_before_deadline(P):
    eng = P.serving.InferenceEngine(_cache(P), {"data": (8,)}, buckets=(2,),
                                    max_delay_ms=10_000).start()
    try:
        t0 = time.perf_counter()
        f1 = eng.submit({"data": np.zeros((1, 8), "float32")})
        f2 = eng.submit({"data": np.zeros((1, 8), "float32")})
        f1.result(timeout=10.0)
        f2.result(timeout=10.0)
        assert time.perf_counter() - t0 < 5.0, "a full bucket waited for the deadline"
    finally:
        eng.close()


def test_oversize_request_rejected_and_counted(P):
    with P.serving.InferenceEngine(_cache(P), {"data": (8,)}, buckets=(1, 4),
                                   max_delay_ms=1) as eng:
        c0 = _counters(P).get("serving.rejected", 0)
        with pytest.raises(P.MXNetError, match="exceed the largest bucket"):
            eng.submit({"data": np.zeros((5, 8), "float32")})
        with pytest.raises(P.MXNetError, match="item shape"):
            eng.submit({"data": np.zeros((2, 9), "float32")})
        assert _counters(P).get("serving.rejected", 0) == c0 + 2


def test_engine_unknown_input_name_rejected(P):
    with pytest.raises(P.MXNetError, match="not model inputs"):
        P.serving.InferenceEngine(_cache(P), {"nope": (8,)}, buckets=(1,))


def test_non_batch_major_output_replicated_whole(P):
    rs = np.random.RandomState(2)
    params = {"fc_weight": rs.randn(8, 8).astype("float32"),
              "fc_bias": rs.randn(8).astype("float32")}
    S = P.mod.sym
    net = S.Group([S.FullyConnected(S.Variable("data"), num_hidden=8, name="fc"),
                   S.sum(S.Variable("fc_weight"), axis=1, name="wsum")])
    x = rs.rand(5, 8).astype("float32")
    for buckets in ((1, 8), (8,)):
        with P.serving.InferenceEngine(_cache(P, net, params), {"data": (8,)},
                                       buckets=buckets, max_delay_ms=1) as eng:
            out = eng.infer({"data": x})
        assert out[0].shape == (5, 8), buckets
        assert out[1].shape == (8,), buckets
        np.testing.assert_allclose(out[0], x @ params["fc_weight"].T + params["fc_bias"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out[1], params["fc_weight"].sum(axis=1), rtol=1e-6)


def test_cross_thread_queue_ordering_and_correctness(P):
    params = _mlp_params()
    results, errs = {}, []

    def worker(tid):
        try:
            futs = []
            for j in range(6):
                x = np.full((1, 8), (tid * 10 + j) / 50.0, "float32")
                futs.append((j, x, eng.submit({"data": x})))
            for j, x, f in futs:
                results[(tid, j)] = (x, f.result(timeout=30.0)[0], f.done_at)
        except Exception as exc:  # pragma: no cover - surfaced by the assert
            errs.append(exc)

    with P.serving.InferenceEngine(_cache(P, params=params), {"data": (8,)},
                                   buckets=(1, 2, 4), max_delay_ms=2) as eng:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs, errs
    assert len(results) == 30
    for (tid, j), (x, got, _) in results.items():
        np.testing.assert_allclose(got, _softmax_ref(params, x), rtol=RTOL, atol=ATOL)
    for tid in range(5):
        stamps = [results[(tid, j)][2] for j in range(6)]
        assert stamps == sorted(stamps), "completions overtook submit order within a thread"


def test_both_packages_serve_the_same_rows():
    """One request stream through both engines: the same outputs."""
    params = _mlp_params(4)
    rs = np.random.RandomState(5)
    xs = [rs.rand(r, 8).astype("float32") for r in (1, 3, 2, 4, 1)]
    outs = {}
    for name, P in PKGS.items():
        with P.serving.InferenceEngine(_cache(P, params=params), {"data": (8,)},
                                       buckets=(1, 2, 4), max_delay_ms=1) as eng:
            outs[name] = [eng.submit({"data": x}) for x in xs]
            outs[name] = [f.result(10)[0] for f in outs[name]]
    for a, b in zip(outs["jax"], outs["torch"]):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ deadlines
def test_deadline_expired_while_queued_is_never_dispatched(P):
    eng = _engine(P, name="dl").start()
    eng.infer(_x())
    c0 = _counters(P)
    with P.fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=1, arg=250, times=1):
        f1 = eng.submit(_x())
        time.sleep(0.03)
        f2 = eng.submit(_x(), deadline_ms=40)
        with pytest.raises(P.serving.ServeDeadlineError) as ei:
            f2.result(timeout=5)
        f1.result(timeout=5)
    assert ei.value.queued_ms >= 40
    c1 = _counters(P)
    assert c1["serving.batches"] - c0.get("serving.batches", 0) == 1
    assert c1["serving.deadline_expired"] - c0.get("serving.deadline_expired", 0) == 1
    eng.close()


def test_deadline_overrun_in_flight_still_delivers(P):
    eng = _engine(P, name="dlov").start()
    eng.infer(_x())
    with P.fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=1, arg=120, times=1):
        out = eng.submit(_x(), deadline_ms=30).result(timeout=5)
    assert out[0].shape == (1, 5)
    assert _counters(P).get("serving.deadline_overrun", 0) >= 1
    eng.close()


def test_expired_request_fails_even_with_idle_queue(P):
    eng = _engine(P, name="dlidle").start()
    eng.infer(_x())
    with P.fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=1, arg=200, times=1):
        eng.submit(_x())
        time.sleep(0.03)
        f = eng.submit(_x(), deadline_ms=30)
    t0 = time.perf_counter()
    with pytest.raises(P.serving.ServeDeadlineError):
        f.result(timeout=5)
    assert time.perf_counter() - t0 < 2.0
    eng.close()


# ------------------------------------------------------------- shedding
def test_shed_carries_retry_after(P):
    eng = _engine(P, name="shed").start()
    eng.infer(_x())
    with P.fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=2, arg=150, times=1):
        fa = eng.submit(_x())
        time.sleep(0.02)
        fb = eng.submit(_x())
        with eng._cond:
            eng._ewma_wait_s = 0.5
            eng._ewma_t = time.perf_counter()
        with pytest.raises(P.serving.ServeOverloadError) as ei:
            eng.submit(_x(), deadline_ms=20)
        fa.result(5), fb.result(5)
    assert ei.value.retry_after_ms >= 20
    assert _counters(P)["serving.shed"] == 1
    h = eng.health()
    assert h["recent_sheds"] == 1 and h["state"] == "degraded"
    assert h["shed_rate"] > 0
    eng.close()


def test_empty_queue_floors_the_estimate(P):
    eng = _engine(P, name="shedidle").start()
    eng.infer(_x())
    with eng._cond:
        eng._ewma_wait_s = 5.0
        eng._ewma_t = time.perf_counter()
    assert eng.submit(_x(), deadline_ms=100).result(5)[0].shape == (1, 5)
    eng.close()


def test_shed_disabled_via_knob(P):
    eng = _engine(P, name="shedoff", shed="0").start()
    eng.infer(_x())
    with P.fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=2, arg=100, times=1):
        fa = eng.submit(_x())
        time.sleep(0.02)
        fb = eng.submit(_x())
        with eng._cond:
            eng._ewma_wait_s = 0.5
            eng._ewma_t = time.perf_counter()
        f = eng.submit(_x(), deadline_ms=1)
        fa.result(5), fb.result(5)
    with pytest.raises(P.serving.ServeDeadlineError):
        f.result(5)
    eng.close()


# ----------------------------------------------------- retry and health
def test_dispatch_retry_recovers_from_single_injected_failure(P):
    eng = _engine(P, name="retry").start()
    want = eng.infer(_x())[0]
    with P.fi.inject("serving.dispatch", "raise", prob=1.0, seed=3, times=1) as plan:
        out = eng.infer(_x(), timeout=10)
    assert plan.fired == 1
    np.testing.assert_array_equal(out[0], want)
    c = _counters(P)
    assert c["serving.dispatch_retries"] == 1
    assert c.get("serving.dispatch_failures", 0) == 0
    assert eng.health()["state"] == "degraded"
    eng.close()


def test_dispatch_retry_exhausted_fails_but_engine_survives(P):
    eng = _engine(P, name="retryx").start()
    eng.infer(_x())
    with P.fi.inject("serving.dispatch", "raise", prob=1.0, seed=3):
        with pytest.raises(P.fi.FaultInjected):
            eng.infer(_x(), timeout=10)
    assert eng.infer(_x(), timeout=10)[0].shape == (1, 5)
    c = _counters(P)
    assert c["serving.dispatch_retries"] == 1
    assert c["serving.dispatch_failures"] == 1
    eng.close()


def test_health_recovers_after_window(P):
    eng = _engine(P, name="heal", health_window_s=0.3).start()
    eng.infer(_x())
    with P.fi.inject("serving.dispatch", "raise", prob=1.0, seed=3, times=1):
        eng.infer(_x(), timeout=10)
    assert eng.health()["state"] == "degraded"
    time.sleep(0.35)
    assert eng.health()["state"] == "healthy"
    eng.close()


def test_health_snapshots_have_the_same_keys_and_states():
    snaps = {}
    for name, P in PKGS.items():
        eng = _engine(P, name="keys")
        first = eng.health()["state"]
        eng.start()
        eng.infer(_x())
        running = eng.health()
        eng.close()
        snaps[name] = (first, running["state"], eng.health()["state"], set(running),
                       sorted(running["fusion"]))
    assert snaps["jax"] == snaps["torch"]
    assert snaps["torch"][:3] == ("stopped", "healthy", "stopped")


# --------------------------------------------------------------- reload
def test_reload_mid_load_zero_losses_zero_binds(P):
    params = _mlp_params()
    eng = _engine(P, name="reload", params=params).start()
    eng.infer(_x())
    c0 = _counters(P)
    before = eng.infer(_x())[0]
    new = {k: (v * 2.0).astype("float32") for k, v in params.items()}
    futs = [eng.submit(_x()) for _ in range(6)]
    rfut = eng.reload(new)
    futs += [eng.submit(_x()) for _ in range(6)]
    for f in futs:
        assert f.result(timeout=10)[0].shape == (1, 5)
    assert rfut.result(timeout=10) is True
    after = eng.infer(_x())[0]
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, _softmax_ref(new, _x()["data"]), rtol=RTOL, atol=ATOL)
    c1 = _counters(P)
    assert c1.get("serving.executable_compile", 0) == c0.get("serving.executable_compile", 0)
    if P.name == "torch":
        assert eng.cache.binds == 3  # one a bucket, all at warmup
    assert c1["serving.reloads"] == 1
    assert eng.health()["reloads"] == 1
    eng.close()


def test_reload_is_a_fifo_barrier(P):
    params = _mlp_params()
    eng = _engine(P, name="barrier", params=params, max_delay_ms=0.0).start()
    eng.infer(_x())
    old = eng.infer(_x())[0]
    with P.fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=5, arg=100, times=1):
        blocker = eng.submit(_x())
        time.sleep(0.03)
        pre = eng.submit(_x())
        rfut = eng.reload({k: (v * 2.0).astype("float32") for k, v in params.items()})
        post = eng.submit(_x())
    assert np.allclose(pre.result(10)[0], old)
    assert rfut.result(10)
    assert not np.allclose(post.result(10)[0], old)
    blocker.result(10)
    eng.close()


def test_reload_uncastable_value_rejected_before_any_write(P):
    params = _mlp_params()
    eng = _engine(P, name="mixedreload", params=params).start()
    eng.infer(_x())
    before = eng.infer(_x())[0]
    bad = np.empty((5,), dtype=object)
    bad[:] = "not a number"
    with pytest.raises(P.MXNetError, match="not castable"):
        eng.reload({"fc_weight": params["fc_weight"] * 2.0, "fc_bias": bad}).result(10)
    assert np.allclose(eng.infer(_x())[0], before)
    eng.close()


def test_reload_bad_shape_rejected_serving_continues(P):
    eng = _engine(P, name="badreload").start()
    eng.infer(_x())
    before = eng.infer(_x())[0]
    with pytest.raises(P.MXNetError, match="shape mismatch"):
        eng.reload({"fc_weight": np.zeros((7, 8), "float32")}).result(10)
    with pytest.raises(P.MXNetError, match="unknown"):
        eng.reload({"nope": np.zeros((1,), "float32")}).result(10)
    assert np.allclose(eng.infer(_x())[0], before)
    eng.close()


# ----------------------------------------------------- shutdown and latch
def test_close_no_drain_fails_queued_with_shutdown_error(P):
    eng = _engine(P, name="closefast").start()
    eng.infer(_x())
    with P.fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=4, arg=250, times=1):
        inflight = eng.submit(_x())
        time.sleep(0.03)
        queued = eng.submit(_x())
        eng.close(drain=False)
    with pytest.raises(P.serving.ServeClosedError):
        queued.result(timeout=5)
    inflight.result(timeout=5)


def test_result_on_latched_engine_raises_immediately(P):
    eng = _engine(P, name="latch").start()
    eng.infer(_x())
    with P.fi.inject("serving.batcher", "raise", prob=1.0, seed=5, times=1):
        # wake the batcher so its next loop iteration hits the injection
        try:
            eng.infer(_x(), timeout=5)
        except P.MXNetError:
            pass
        deadline = time.time() + 5
        while eng._fatal is None and time.time() < deadline:
            time.sleep(0.01)
    assert eng._fatal is not None
    f = P.serving.ServeFuture(eng)
    t0 = time.perf_counter()
    with pytest.raises(P.MXNetError, match="latched"):
        f.result()
    assert time.perf_counter() - t0 < 1.0
    with pytest.raises(P.MXNetError, match="latched"):
        eng.submit(_x())
    assert eng.health()["state"] == "latched"
    assert _counters(P)["serving.batcher_deaths"] == 1


def test_batcher_death_latches_and_fails_fast(P):
    eng = P.serving.InferenceEngine(_cache(P), {"data": (8,)}, buckets=(2,),
                                    max_delay_ms=1).start()
    try:
        def boom(batch):
            raise KeyboardInterrupt("simulated batcher death")

        eng._dispatch = boom
        f1 = eng.submit({"data": np.zeros((2, 8), "float32")})
        with pytest.raises((P.MXNetError, KeyboardInterrupt)):
            f1.result(timeout=10)
        eng._thread.join(timeout=10)
        t0 = time.time()
        with pytest.raises(P.MXNetError, match="latched|died"):
            eng.submit({"data": np.zeros((1, 8), "float32")})
        assert time.time() - t0 < 5
        with pytest.raises(P.MXNetError, match="latched|died"):
            eng.start()
        assert P.tm.counter("serving.batcher_deaths").value == 1
    finally:
        eng._started = False


def test_latch_fails_pending_queued_futures(P):
    eng = P.serving.InferenceEngine(_cache(P), {"data": (8,)}, buckets=(8,),
                                    max_delay_ms=5000).start()
    try:
        fut = eng.submit({"data": np.zeros((1, 8), "float32")})
        deadline = time.time() + 5
        while not eng._queue and time.time() < deadline:
            time.sleep(0.005)
        eng._latch_failure(RuntimeError("simulated death"))
        with pytest.raises(P.MXNetError, match="died"):
            fut.result(timeout=5)
        with pytest.raises(P.MXNetError, match="died"):
            eng.submit({"data": np.zeros((1, 8), "float32")})
    finally:
        eng._started = False


@pytest.mark.parametrize("err", ["deadline", "overload"])
def test_serve_errors_pickle_with_their_fields(err):
    import pickle

    fields = {}
    for name, P in PKGS.items():
        e = (P.serving.ServeDeadlineError("late", queued_ms=12.5) if err == "deadline"
             else P.serving.ServeOverloadError("busy", retry_after_ms=7))
        back = pickle.loads(pickle.dumps(e))
        assert type(back) is type(e)
        fields[name] = (type(e).__name__, str(back), getattr(back, "queued_ms", None),
                        getattr(back, "retry_after_ms", None))
    assert fields["jax"] == fields["torch"]


# ------------------------------------------------------- execution engine
from mxnet_tpu_torch import engine as peng  # noqa: E402


@pytest.fixture(params=["native", "python", "naive"])
def make_engine(request):
    def factory():
        if request.param == "naive":
            return peng.NaiveEngine()
        if request.param == "native":
            e = peng.ThreadedEngine(num_workers=4)
            assert e.native, "src/engine_native.cc did not build"
            return e
        return peng._PythonThreadedEngine(4)

    return factory


def test_native_engine_library_builds_into_the_ports_directory():
    e = peng.ThreadedEngine(num_workers=2)
    assert e.native and peng._lib._name.endswith("build/torch_native/libmxtpu_engine.so")


def test_writers_serialize_in_push_order(make_engine):
    e = make_engine()
    v = e.new_variable()
    log = []
    for i in range(50):
        e.push((lambda i=i: log.append(i)), const_vars=[], mutable_vars=[v])
    e.wait_for_var(v)
    assert log == list(range(50))


def test_reader_sees_preceding_writes(make_engine):
    e = make_engine()
    v = e.new_variable()
    state = {"n": 0}
    observed = []

    def writer():
        time.sleep(0.001)
        state["n"] += 1

    for i in range(10):
        e.push(writer, const_vars=[], mutable_vars=[v])
        e.push((lambda i=i: observed.append((i, state["n"]))), const_vars=[v], mutable_vars=[])
    e.wait_for_all()
    assert observed == [(i, i + 1) for i in range(10)]


def test_readers_run_concurrently(make_engine):
    e = make_engine()
    if isinstance(e, peng.NaiveEngine):
        pytest.skip("the naive engine is serial by design")
    v = e.new_variable()
    barrier = threading.Barrier(3, timeout=10)
    for _ in range(3):
        e.push(barrier.wait, const_vars=[v], mutable_vars=[])  # deadlocks unless 3 overlap
    e.wait_for_all()


def test_disjoint_vars_run_independently(make_engine):
    e = make_engine()
    va, vb = e.new_variable(), e.new_variable()
    log_a, log_b = [], []
    for i in range(20):
        e.push((lambda i=i: log_a.append(i)), mutable_vars=[va])
        e.push((lambda i=i: log_b.append(i)), mutable_vars=[vb])
    e.wait_for_all()
    assert log_a == list(range(20)) and log_b == list(range(20))


def test_random_workload_dependency_consistency(make_engine):
    """A random DAG of 120 ops over 6 vars, the switch interval shortened:
    each var's log is its writers in push order, and every op reads the
    state its pushes promised."""
    e = make_engine()
    rng = random.Random(0)
    vars_ = [e.new_variable() for _ in range(6)]
    logs = {v: [] for v in vars_}
    expected = {v: [] for v in vars_}
    snapshots = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for op_id in range(120):
            muts = rng.sample(vars_, rng.randint(0, 2))
            consts = [v for v in rng.sample(vars_, rng.randint(0, 3)) if v not in muts]
            want = {v: len(expected[v]) for v in consts}
            for v in muts:
                expected[v].append(op_id)

            def fn(op_id=op_id, muts=tuple(muts), consts=tuple(consts), want=dict(want)):
                snapshots.append((op_id, {v: len(logs[v]) for v in consts}, want))
                for v in muts:
                    logs[v].append(op_id)

            e.push(fn, const_vars=consts, mutable_vars=muts)
        e.wait_for_all()
    finally:
        sys.setswitchinterval(interval)
    assert logs == expected
    for op_id, snap, want in snapshots:
        assert snap == want, "op %d read stale or future state" % op_id


def test_wait_for_var_blocks_until_drained_and_unknown_vars_raise(make_engine):
    e = make_engine()
    v = e.new_variable()
    done = []
    e.push(lambda: (time.sleep(0.05), done.append(1)), mutable_vars=[v])
    e.wait_for_var(v)
    assert done == [1]
    with pytest.raises(pt.MXNetError, match="unknown engine variable"):
        e.wait_for_var(10 ** 9)


@pytest.mark.parametrize("kind", ["native", "python"])
def test_engine_error_surfaces_at_the_wait(kind):
    e = peng.ThreadedEngine(num_workers=2) if kind == "native" else peng._PythonThreadedEngine(2)
    v = e.new_variable()
    e.push(lambda: 1 / 0, mutable_vars=[v])
    with pytest.raises(pt.MXNetError, match="engine op failed"):
        e.wait_for_all()


def test_engine_type_selection_and_telemetry(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    monkeypatch.setattr(peng, "_engine", None)
    assert isinstance(peng.get(), peng.NaiveEngine)
    e = peng.set_engine_type("ThreadedEnginePerDevice")
    assert isinstance(e, peng.ThreadedEngine) and peng.get() is e
    with pytest.raises(pt.MXNetError, match="unknown MXNET_ENGINE_TYPE"):
        peng.set_engine_type("NoSuchEngine")
    saved = pt_tm.current_override()
    pt_tm.reset()
    pt_tm.clear_events()
    pt_tm.set_mode("trace")
    try:
        v = e.new_variable()
        e.push(lambda: None, mutable_vars=[v])
        e.wait_for_var(v)
        e.wait_for_all()
        names = {ev[0] for ev in pt_tm.drain_events()}
        assert pt_tm.counter("engine.push").value == 1
        assert {"engine.op", "engine.wait_for_var", "engine.wait_for_all"} <= names
    finally:
        pt_tm.set_mode(saved)
        pt_tm.reset()
        monkeypatch.setattr(peng, "_engine", None)


@pytest.mark.parametrize("engine_type", ["ThreadedEngine", "NaiveEngine"])
def test_checkpoint_rides_the_engine_and_matches_the_references_bytes(tmp_path, monkeypatch,
                                                                      engine_type):
    """``save_checkpoint`` queues its write on the engine: ``waitall``
    drains it, ``find_last_checkpoint`` and ``load_checkpoint`` wait for
    it, and the file is the JAX package's for the same parameters."""
    monkeypatch.setattr(peng, "_engine", None)
    monkeypatch.setenv("MXNET_ENGINE_TYPE", engine_type)
    rs = np.random.RandomState(0)
    args = {"fc_weight": rs.randn(3, 4).astype(np.float32),
            "fc_bias": rs.randn(3).astype(np.float32)}
    aux = {"bn_moving_mean": rs.randn(3).astype(np.float32)}
    for pkg, name in ((mx, "jax"), (pt, "torch")):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3, name="fc")
        for epoch in (1, 2):
            pkg.model.save_checkpoint(
                str(tmp_path / name), epoch, net,
                {k: pkg.nd.array(v * epoch, ctx=pkg.cpu()) for k, v in args.items()},
                {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in aux.items()})
    # a write queued behind a slow op on the prefix's variable: waitall
    # returns after it landed (the naive engine runs both on push)
    gate = threading.Event()
    threading.Timer(0.05, gate.set).start()
    peng.get().push(gate.wait, mutable_vars=[pt.model._ckpt_vars[
        os.path.abspath(str(tmp_path / "torch"))][1]])
    pt.model.save_checkpoint(str(tmp_path / "torch"), 3, None,
                             {k: pt.nd.array(v, ctx=pt.cpu()) for k, v in args.items()}, {})
    pt.nd.waitall()
    assert (tmp_path / "torch-0003.params").is_file()
    assert pt.model.find_last_checkpoint(str(tmp_path / "torch")) == 3
    for epoch in (1, 2):
        want = (tmp_path / ("jax-%04d.params" % epoch)).read_bytes()
        assert (tmp_path / ("torch-%04d.params" % epoch)).read_bytes() == want
    _, got, got_aux = pt.model.load_checkpoint(str(tmp_path / "torch"), 2, ctx=pt.cpu())
    np.testing.assert_array_equal(got["fc_weight"].asnumpy(), args["fc_weight"] * 2)
    np.testing.assert_array_equal(got_aux["bn_moving_mean"].asnumpy(), aux["bn_moving_mean"])
    monkeypatch.setattr(peng, "_engine", None)


def test_a_failed_checkpoint_write_is_raised_at_the_next_call(tmp_path, monkeypatch):
    monkeypatch.setattr(peng, "_engine", None)
    prefix = str(tmp_path / "missing-dir" / "ck")
    pt.model.save_checkpoint(prefix, 1, None, {"w": np.ones(2, np.float32)}, {})
    with pytest.raises(pt.MXNetError, match="earlier async checkpoint write failed"):
        pt.model.find_last_checkpoint(prefix)
    monkeypatch.setattr(peng, "_engine", None)
