"""The port's telemetry and fault-injection layers held against the JAX
package's: both are backend-free copies, so the same calls must give the
same histograms, registry snapshots, chrome-trace schema, fault plans and
lock-witness reports. The decoders' spans and counters (``serving.*``,
``spec.*``, ``dispatch.host_gap``) are held against the JAX decoders' on
the same small transformer."""
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu import faultinject as mx_fi
from mxnet_tpu import telemetry as mx_tm
from mxnet_tpu.telemetry import histogram as mx_hist
from mxnet_tpu.telemetry import lockwitness as mx_lw
from mxnet_tpu_torch import faultinject as pt_fi
from mxnet_tpu_torch import telemetry as pt_tm
from mxnet_tpu_torch.telemetry import histogram as pt_hist
from mxnet_tpu_torch.telemetry import lockwitness as pt_lw

torch.set_num_threads(1)

BOTH = [(mx_tm, mx_fi), (pt_tm, pt_fi)]


@pytest.fixture(autouse=True)
def _clean():
    saved = [tm.current_override() for tm, _ in BOTH]
    for tm, fi in BOTH:
        tm.reset()
        tm.clear_events()
        fi.reset_stats()
    yield
    for (tm, fi), s in zip(BOTH, saved):
        tm.set_mode(s)
        tm.reset()
        tm.clear_events()
        fi.reset_stats()


def _samples(seed, n=500):
    rs = np.random.RandomState(seed)
    return list(np.exp(rs.uniform(np.log(2e-6), np.log(30.0), n)))


def test_histogram_quantiles_and_merge_equal_the_reference():
    got = []
    for mod in (mx_hist, pt_hist):
        a, b = mod.Histogram(), mod.Histogram()
        for s in _samples(0):
            a.record(s)
        for s in _samples(1, 300):
            b.record(s)
        a.merge(b)
        c = mod.Histogram()
        c.merge(a.to_dict())
        got.append((a.count, a.quantiles_ms(), a.to_dict(), c.to_dict(),
                    [mod.bucket_index(s) for s in _samples(2, 50)]))
    assert got[0] == got[1]


def _registry_script(tm):
    tm.set_mode("counters")
    tm.counter("serving.batches").inc()
    tm.counter("serving.batches").inc(4)
    tm.gauge("serving.batch_occupancy").set(0.375)
    t = tm.timer("serving.request")
    for s in _samples(3, 40):
        t.add(s)
    tm.mark_step(wall_ms=12.5)
    return tm.snapshot(), tm.counters(), t.quantiles_ms()


def test_registry_snapshot_has_the_same_keys_and_values():
    ref, port = (_registry_script(tm) for tm, _ in BOTH)
    assert ref[1] == port[1]
    assert sorted(ref[0]) == sorted(port[0])
    for k in ref[0]:
        a, b = ref[0][k], port[0][k]
        if isinstance(a, dict):
            # the timers' totals are float sums of the same samples in order
            assert sorted(a) == sorted(b), k
            for f in a:
                assert a[f] == pytest.approx(b[f], rel=1e-12), (k, f)
        else:
            assert a == b, k
    assert ref[2] == port[2]


def _trace_script(tm):
    tm.set_mode("trace")
    with tm.span("serving.dispatch", model="m", bucket=4):
        tm.counter("serving.batches").inc()
    tm.record_span("serving.queue_wait", 1.0, 0.002, trace_id="t1")
    with tm.trace_scope("t2"):
        with tm.span("serving.batch", requests=2):
            pass
    return tm.build_trace(xla_trace_dir="/tmp/profile", extra={"run": 1})


def test_chrome_trace_export_has_the_same_schema():
    ref, port = (_trace_script(tm) for tm, _ in BOTH)
    assert mx_tm.SCHEMA_VERSION == pt_tm.SCHEMA_VERSION
    assert sorted(ref) == sorted(port)
    assert sorted(ref["otherData"]) == sorted(port["otherData"])
    assert ref["otherData"]["mxnet_telemetry"] == port["otherData"]["mxnet_telemetry"]
    assert ref["otherData"]["xla_trace_dir"] == port["otherData"]["xla_trace_dir"]

    def shape(trace):
        return [(e["ph"], e.get("name"), e.get("cat"), sorted(e),
                 sorted((e.get("args") or {}).items()) if e["ph"] == "X" else None)
                for e in trace["traceEvents"]]

    assert shape(ref) == shape(port)


@pytest.mark.parametrize("plan", [
    "serving.dispatch:raise:0.3:42",
    "serving.dispatch:delay_ms:0.5:7:0,serving.submit:raise:0.2:9",
    "serving.batcher:raise:1.0:1, bogus, serving.dispatch:raise:x:1"])
def test_faultinject_parses_the_same_plans_and_fires_the_same_sequence(plan, monkeypatch):
    monkeypatch.setenv("MXNET_FAULTINJECT", plan)
    seqs = []
    for _, fi in BOTH:
        fi.refresh()
        seq = []
        for i in range(60):
            site = ("serving.dispatch", "serving.submit", "serving.batcher")[i % 3]
            try:
                fi.fire(site)
                seq.append(None)
            except fi.FaultInjected as e:
                seq.append((e.site, e.kind))
        seqs.append((seq, fi.stats()))
    assert seqs[0] == seqs[1]
    assert any(s is not None for s in seqs[1][0])


def test_faultinject_scoped_plan_fires_the_same_times():
    fired = []
    for _, fi in BOTH:
        with fi.inject("serving.dispatch", "raise", prob=0.5, seed=11, times=3) as plan:
            hits = 0
            for _ in range(40):
                try:
                    fi.fire("serving.dispatch")
                except fi.FaultInjected:
                    hits += 1
        fired.append((hits, plan.fired, plan.calls))
    assert fired[0] == fired[1] and fired[1][0] == 3


def _witness_script(tm, lw):
    lw.set_mode("witness")
    lw.reset_witness()
    try:
        a, b = tm.named_lock("test.a"), tm.named_lock("test.b")
        cond = tm.named_condition("test.cond")
        with a:
            with b:
                pass
        t = threading.Thread(target=lambda: [b.acquire(), a.acquire(), a.release(),
                                             b.release()])
        t.start()
        t.join()
        with cond:
            cond.notify_all()
        rep = lw.witness_report()
    finally:
        lw.set_mode(None)
        lw.reset_witness()
    locks = [{k: v for k, v in row.items() if k not in ("wait_ms", "hold_ms", "max_hold_ms",
                                                         "threads")}
             for row in rep["locks"]]
    edges = [(e["first"], e["then"], e["count"], len(e["threads"])) for e in rep["edges"]]
    events = sorted((e["kind"], sorted(k for k in e if k not in ("t", "ts")))
                    for e in rep["events"])
    return rep["enabled"], sorted(rep), locks, edges, events


def test_lock_witness_report_matches_the_reference(monkeypatch):
    # no hold in the script is long: a busy host must not make one so
    monkeypatch.setenv("MXNET_CONCLINT_HOLD_MS", "60000")
    ref = _witness_script(mx_tm, mx_lw)
    port = _witness_script(pt_tm, pt_lw)
    assert ref == port
    assert any(kind == "inversion" for kind, _ in port[4])


# ------------------------------------------------------- decoder telemetry
CFG = dict(vocab_size=19, num_layers=2, num_heads=2, model_dim=16, ffn_dim=32)


def _decode_params():
    import mxnet_tpu as mx

    net = mx.models.transformer.get_symbol(seq_len=16, **CFG)
    shapes, _, _ = net.infer_shape(data=(1, 16), softmax_label=(1, 16))
    rs = np.random.RandomState(0)
    return {n: (rs.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _decode_counters(which, params):
    if which == "jax":
        from mxnet_tpu.serving import KVCacheDecoder, PagedKVDecoder, SpeculativeDecoder
        tm, kw = mx_tm, {}
    else:
        import mxnet_tpu_torch as pt
        from mxnet_tpu_torch.serving import KVCacheDecoder, PagedKVDecoder, SpeculativeDecoder
        tm, kw = pt_tm, {"ctx": pt.cpu()}
    tm.set_mode("counters")
    tm.reset()
    prompt = np.array([[3, 5, 7, 2, 1]])
    dec = KVCacheDecoder(params, max_len=16, prefill_len=8, pos_len=16, batch=1, **CFG, **kw)
    toks = dec.greedy(prompt, 9, k=4)
    paged = PagedKVDecoder(params, max_len=16, page_size=4, lanes=2, prefill_len=8,
                           pos_len=16, prefix_cache=True, prefix_chunk=4, **CFG, **kw)
    ptoks = paged.greedy([prompt[0], prompt[0]], 6, k=2)
    spec = SpeculativeDecoder.build(params, draft_layers=1, gamma=2, max_len=16,
                                    page_size=4, lanes=1, prefill_len=8, pos_len=16,
                                    **CFG, **kw)
    stoks = spec.greedy(prompt[0], 6)
    snap = tm.snapshot()
    counts = {k: v for k, v in tm.counters().items()
              if k.split(".")[0] in ("serving", "spec") and not isinstance(v, dict)}
    timers = sorted(k for k, v in snap.items() if isinstance(v, dict))
    return toks, ptoks, stoks, counts, timers


def test_decoders_emit_the_references_counters_and_timers():
    params = _decode_params()
    ref = _decode_counters("jax", params)
    port = _decode_counters("torch", params)
    np.testing.assert_array_equal(ref[0], port[0])
    for a, b in zip(ref[1], port[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref[2], port[2])
    assert ref[3] == port[3]
    for name in ("serving.megasteps", "serving.prefill_tokens", "serving.decode_tokens",
                 "serving.paged_admits", "serving.prefix_hits", "spec.rounds"):
        assert port[3].get(name, 0) > 0, name
    assert ref[4] == port[4]
    assert "dispatch.host_gap" in port[4] and "serving.decode_megastep" in port[4]
