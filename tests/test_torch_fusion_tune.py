"""The port's measure-and-cache autotuner (``mxnet_tpu_torch/fusion_tune.py``)
held against the JAX package's.

Every case of the reference's ``tests/test_fusion_tune_cache.py`` and
``tests/test_schedule_search.py`` runs on both packages (fixture ``mx``,
the port inside ``with cpu():``): the cold tune that persists, the warm
rebind that measures nothing, the corrupt, digest-mismatched, foreign and
future-version files ignored with a warning, version-1 records served, the
schedule annotations, and the gate reasons that quote measured µs. A JAX
case that reads a Pallas planner's schedule space (block or stripe
candidates) holds the port to its own: ``matmul_bias_act``'s two launcher
schedules, one flash and one LayerNorm schedule, and the conv+BN
candidates' two backward policies; ``conv_schedule`` is None in the port
(its kernels take no stripe override). The cache files the two packages
write at the same sites hold the same keys.

The port's departure: on a CUDA tensor a candidate that raises, or whose
numbers leave the baseline, raises and caches nothing
(``tests/test_torch_cuda.py::test_fusion_tune_reraises_a_failing_kernel``,
on a card), while on the CPU a parity rejection is cached and a
candidate's failure is recorded, as in the JAX package
(``test_*_departure``).
"""
import ast
import contextlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu.fusion
import mxnet_tpu.fusion_tune
import mxnet_tpu.ops.fusion_patterns
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.fusion
import mxnet_tpu_torch.fusion_tune
import mxnet_tpu_torch.ops.fusion_patterns  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(params=["jax", "port"])
def mx(request, monkeypatch, tmp_path):
    m = mxnet_tpu if request.param == "jax" else pt
    saved = m.telemetry.current_override()
    monkeypatch.setenv("MXNET_FUSION_TUNE_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_FUSION_TUNE_ITERS", "2")
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    m.telemetry.set_mode("counters")
    m.fusion_tune.reset()
    m.telemetry.reset()
    with pt.cpu() if m is pt else contextlib.nullcontext():
        yield m
    m.fusion_tune.reset()
    m.telemetry.reset()
    m.telemetry.set_mode(saved)


def _count(m, name):
    return m.telemetry.counter(name).value


def _mba_net(m, hidden=128):
    sym = m.sym
    x = sym.Variable("data")
    h = sym.FullyConnected(x, num_hidden=hidden, name="fc1")
    h = sym.Activation(h, act_type="relu", name="act1")
    fc = sym.FullyConnected(h, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc, name="softmax")


def _fit_once(m, monkeypatch, seed=0, hidden=128, rows=8, cols=32):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "matmul_bias_act")
    rs = np.random.RandomState(seed)
    net = _mba_net(m, hidden)
    ex = net.simple_bind(m.cpu(), data=(rows, cols), softmax_label=(rows,), grad_req="write")
    for name, arr in zip(net.list_arguments(), ex.arg_arrays):
        if "label" in name:
            arr[:] = rs.randint(0, 4, arr.shape).astype("f")
        else:
            arr[:] = rs.uniform(-0.5, 0.5, arr.shape).astype("f")
    ex.forward(is_train=True)
    ex.backward()
    return ex


def _write_cache(m, version, entries):
    path = m.fusion_tune.cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"version": version, "device_kind": m.fusion_tune.device_kind(),
                   "digest": m.fusion_tune.entries_digest(entries), "entries": entries}, f)
    return path


# ------------------------------------------------ tests/test_fusion_tune_cache.py
def test_cold_tune_persists_and_warm_process_never_retunes(mx, monkeypatch):
    _fit_once(mx, monkeypatch)
    assert _count(mx, "fusion.tune") == 1  # one site, one measurement
    path = mx.fusion_tune.cache_path()
    assert path is not None and os.path.exists(path)
    payload = json.load(open(path))
    assert payload["device_kind"] == mx.fusion_tune.device_kind() == "cpu"
    assert payload["digest"] == mx.fusion_tune.entries_digest(payload["entries"])
    [key] = list(payload["entries"])
    assert key.startswith("matmul_bias_act|relu|")
    mx.fusion_tune.reset()
    mx.telemetry.reset()
    _fit_once(mx, monkeypatch)
    assert _count(mx, "fusion.tune") == 0
    assert _count(mx, "fusion.tune_cache_hit") >= 1


def test_corrupt_cache_file_is_ignored_not_fatal(mx, monkeypatch, caplog):
    path = mx.fusion_tune.cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("{ this is not json")
    with caplog.at_level("WARNING", logger="mxnet_tpu"):
        _fit_once(mx, monkeypatch)
    assert _count(mx, "fusion.tune") == 1
    assert any("ignoring cache file" in r.message for r in caplog.records)
    payload = json.load(open(path))
    assert payload["digest"] == mx.fusion_tune.entries_digest(payload["entries"])


def test_digest_mismatch_is_ignored_with_warning(mx, monkeypatch, caplog):
    _fit_once(mx, monkeypatch)
    path = mx.fusion_tune.cache_path()
    payload = json.load(open(path))
    for k in payload["entries"]:
        payload["entries"][k]["engage"] = True
        payload["entries"][k]["lowering"] = "hand-edited"
    with open(path, "w") as f:
        json.dump(payload, f)
    mx.fusion_tune.reset()
    with caplog.at_level("WARNING", logger="mxnet_tpu"):
        assert mx.fusion_tune.peek(list(payload["entries"])[0]) is None
    assert any("digest mismatch" in r.message for r in caplog.records)


def test_device_kind_mismatch_is_ignored(mx, caplog):
    path = mx.fusion_tune.cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    entries = {"k": {"engage": True}}
    with open(path, "w") as f:
        json.dump({"version": 1, "device_kind": "TPU v99",
                   "digest": mx.fusion_tune.entries_digest(entries), "entries": entries}, f)
    with caplog.at_level("WARNING", logger="mxnet_tpu"):
        assert mx.fusion_tune.peek("k") is None
    assert any("device_kind" in r.message for r in caplog.records)


def test_tuned_and_rejected_reason_reports_measured_timings(mx):
    key = "conv_bn|k1s1p|float32(2, 8, 8, 8);(16, 8, 1, 1)"
    rec = {"engage": False, "engage_fwd": False, "lowering": None,
           "base_fwd_us": 100.0, "base_bwd_us": 200.0,
           "measured": {"pallas:xla": {"fwd_us": 400.0, "bwd_us": 500.0, "rel_err": 0.0}}}
    got = mx.fusion_tune.verdict(key, lambda: rec)
    assert got["engage"] is False
    note = mx.fusion.tuned_reject_note(got)
    assert "tuned and rejected" in note
    assert "900" in note and "300" in note


def test_conv_bn_gate_explain_quotes_tuned_timings(mx, monkeypatch):
    kernel, stride = (1, 1), (1, 1)
    x_shape, w_shape = (2, 8, 8, 8), (16, 8, 1, 1)
    key = mx.fusion._conv_bn_key(kernel, stride, x_shape, w_shape, np.float32, False)
    assert key == "conv_bn|k1s1p|float32(2, 8, 8, 8);(16, 8, 1, 1)"
    rec = {"engage": False, "engage_fwd": False, "lowering": None,
           "base_fwd_us": 50.0, "base_bwd_us": 70.0,
           "measured": {"pallas:xla": {"fwd_us": 300.0, "bwd_us": 400.0, "rel_err": 0.0}}}
    assert mx.fusion_tune.verdict(key, lambda: rec) is rec
    monkeypatch.setenv("MXNET_FUSED_CONV_BN", "auto")
    engaged, reason = mx.fusion.gate_explain(kernel, stride, x_shape, w_shape,
                                             np.float32, prologue=True)
    assert engaged is False
    assert "tuned and rejected" in reason and "µs" in reason


def test_measure_candidates_rejects_parity_violations(mx):
    rec = mx.fusion_tune.measure_candidates(
        lambda x: x * 2.0, [("wrong", lambda x: x * 2.5)],
        (np.random.RandomState(0).randn(64).astype("f"),), train=True, iters=2)
    assert rec["engage"] is False
    assert "rejected" in rec["measured"]["wrong"]


# ------------------------------------------------- tests/test_schedule_search.py
def test_v1_binary_verdict_cache_loads_with_zero_retunes(mx, caplog):
    rec = {"engage": False, "engage_fwd": False, "lowering": None,
           "base_fwd_us": 10.0, "base_bwd_us": 20.0, "measured": {}}
    _write_cache(mx, 1, {"k1": rec})
    with caplog.at_level("WARNING", logger="mxnet_tpu"):
        got = mx.fusion_tune.peek("k1")
    assert got == rec
    assert not any("ignoring cache file" in r.message for r in caplog.records)

    def boom():
        raise AssertionError("a loaded v1 verdict must never re-tune")

    assert mx.fusion_tune.verdict("k1", boom) == rec
    assert _count(mx, "fusion.tune") == 0
    assert "schedule" not in got


def test_future_version_cache_invalidated_with_one_warning(mx, caplog):
    _write_cache(mx, 99, {"k2": {"engage": True, "lowering": "pallas"}})
    with caplog.at_level("WARNING", logger="mxnet_tpu"):
        assert mx.fusion_tune.peek("k2") is None
        assert mx.fusion_tune.peek("k2") is None
    assert len([r for r in caplog.records if "unknown schema version" in r.message]) == 1
    rec = mx.fusion_tune.verdict("k2", lambda: {"engage": False, "lowering": None})
    assert rec["engage"] is False
    assert json.load(open(mx.fusion_tune.cache_path()))["version"] == 2


def test_v1_record_never_a_silent_stale_winner(mx):
    pat = next(p for p in mx.ops.fusion_patterns.get_patterns() if p.name == "matmul_bias_act")
    meta = {"act": "relu", "flatten": True, "no_bias": False}
    rs = np.random.RandomState(0)
    host = (rs.randn(8, 32).astype("f"), rs.randn(128, 32).astype("f"),
            rs.randn(128).astype("f"))
    if mx is pt:
        args = tuple(torch.from_numpy(a) for a in host)
    else:
        import jax.numpy as jnp

        args = tuple(jnp.asarray(a) for a in host)
    key = mx.fusion._tune_key(pat, meta, args)
    _write_cache(mx, 1, {key: {"engage": True, "lowering": "gone-lowering"}})
    engaged, chosen, reason = mx.fusion.gate_pattern_explain(pat, meta, args)
    assert engaged is False
    assert "unavailable" in reason


def test_verdict_annotates_schedule_and_search_width(mx):
    rec = mx.fusion_tune.verdict("s1", lambda: {
        "engage": True, "lowering": "pallas@bm=256,bn=128",
        "measured": {"pallas": {"fwd_us": 9.0}, "pallas@bm=256,bn=128": {"fwd_us": 5.0}}})
    assert rec["schedule"] == {"bm": 256, "bn": 128}
    assert rec["schedules_searched"] == 1


def test_default_winner_schedule_is_default(mx):
    rec = mx.fusion_tune.verdict("s2", lambda: {
        "engage": True, "lowering": "pallas", "measured": {"pallas": {"fwd_us": 5.0}}})
    assert rec["schedule"] == "default"
    assert rec["schedules_searched"] == 0


def test_sched_name_parse_roundtrip(mx):
    name = mx.fusion_tune.sched_name("block_causal", bq=64)
    assert name == "block_causal@bq=64"
    assert mx.fusion_tune.parse_schedule(name) == {"bq": 64}
    assert mx.fusion_tune.parse_schedule("pallas") == "default"
    assert mx.fusion_tune.parse_schedule(None) is None
    # the port's launcher-schedule names parse to their schedule
    assert mx.fusion_tune.parse_schedule("cuda@schedule=small_m") == {"schedule": "small_m"}


def test_schedule_budget_knob(mx, monkeypatch):
    monkeypatch.setenv("MXNET_FUSION_TUNE_SCHEDULES", "0")
    assert mx.fusion_tune.schedule_budget() == 0
    monkeypatch.setenv("MXNET_FUSION_TUNE_SCHEDULES", "7")
    assert mx.fusion_tune.schedule_budget() == 7
    monkeypatch.setenv("MXNET_FUSION_TUNE_SCHEDULES", "junk")
    assert mx.fusion_tune.schedule_budget() == 4
    monkeypatch.delenv("MXNET_FUSION_TUNE_SCHEDULES")
    assert mx.fusion_tune.schedule_budget() == 4


def test_losers_note_quotes_runners_up(mx):
    rec = {"measured": {
        "pallas": {"fwd_us": 5.0, "bwd_us": 5.0},
        "pallas@bm=256,bn=128": {"fwd_us": 20.0, "bwd_us": 20.0},
        "pallas@bm=128,bn=256": {"fwd_us": 12.0, "bwd_us": 10.0}}}
    note = mx.fusion.losers_note(rec, "pallas")
    assert "beat" in note
    assert note.index("bm=128") < note.index("bm=256")


def _arg(shape):
    return torch.zeros(shape)


def test_matmul_block_candidates_bounded_and_supported(mx):
    """JAX: the Pallas planner's (bm, bn) blocks. Port: the launcher's own
    two schedules, the default first, each one the kernel takes."""
    if mx is mxnet_tpu:
        from mxnet_tpu.ops import pallas_matmul_bias_act as pk

        cands = pk.block_candidates(1024, 128, 2048, "relu", itemsize=4)
        assert cands and cands[0] == (512, 256)
        assert len(cands) == len(set(cands))
        for bm, bn in cands:
            assert pk.supported(1024, 128, 2048, "relu", bm, bn, itemsize=4)
        return
    from mxnet_tpu_torch.ops import matmul_bias_act as mba

    pat = next(p for p in pt.ops.fusion_patterns.get_patterns() if p.name == "matmul_bias_act")
    meta = {"act": "relu", "flatten": True, "no_bias": False}
    for m, k, default, other in ((1024, 128, "tiles", "small_m"), (8, 512, "small_m", "tiles")):
        _, cands = pat.build(meta, (_arg((m, k)), _arg((2048, k)), _arg((2048,))))
        names = [c[0] for c in cands]
        assert names == ["cuda", "cuda@schedule=" + other]
        assert mba._schedule(m, 2048, k) == default
    # a (64, 32768) A: the small-M schedule's rows do not fit, so only the default
    _, cands = pat.build(meta, (_arg((64, 32768)), _arg((16, 32768)), _arg((16,))))
    assert [c[0] for c in cands] == ["cuda"]


def test_attention_block_schedules_distinct_effective(mx):
    """JAX: the Pallas flash kernel's block schedules. Port: the flash
    kernel's one candidate (its tiles are fixed), on both shapes."""
    if mx is mxnet_tpu:
        from mxnet_tpu.ops import pallas_attention as pa

        q = (2, 4, 512, 32)
        scheds = pa.block_schedules(q, q, causal=True)
        assert scheds and scheds[0] == (128, 128)
        assert len(scheds) == len(set(scheds))
        small = pa.block_schedules((2, 2, 8, 16), (2, 2, 64, 16), causal=False)
        assert len({s for s in small}) == len(small)
        return
    pat = next(p for p in pt.ops.fusion_patterns.get_patterns() if p.name == "attention")
    for q, k, causal in (((2, 4, 512, 32), (2, 4, 512, 32), True),
                         ((2, 2, 8, 16), (2, 2, 64, 16), False)):
        _, cands = pat.build({"causal": causal, "scale": -1.0}, (_arg(q), _arg(k), _arg(k)))
        assert [c[0] for c in cands] == ["cuda_flash"]


def test_norm_residual_block_candidates(mx):
    """JAX: the Pallas LayerNorm's row blocks (D lane-aligned only). Port:
    the kernel's one candidate wherever it takes the row length."""
    if mx is mxnet_tpu:
        from mxnet_tpu.ops import pallas_norm_residual as pn

        cands = pn.block_candidates((4, 64, 128), itemsize=4)
        assert cands and cands[0] == max(cands)
        assert all(256 % br == 0 or 256 // br for br in cands)
        assert pn.block_candidates((4, 64, 100)) == []
        return
    pat = next(p for p in pt.ops.fusion_patterns.get_patterns() if p.name == "norm_residual")
    for shape in ((4, 64, 128), (4, 64, 100)):
        _, cands = pat.build({"eps": 1e-5}, (_arg(shape), _arg(shape[-1:]), _arg(shape[-1:])))
        assert [c[0] for c in cands] == ["cuda"]


def test_conv_bn_candidates_and_stripe_override_parity(mx):
    """JAX: every stripe (default first) computes the planner default's
    numbers. Port: the measured candidates are the three backward policies;
    the kernel's two (recompute, stash) give the same bits, and the
    library's the same forward and gradients (the CPU runs plain
    versions)."""
    rs = np.random.RandomState(0)
    host = [rs.randn(2, 8, 8, 8).astype("f"), rs.randn(16, 8, 1, 1).astype("f") * 0.1,
            rs.uniform(0.5, 1.5, (8,)).astype("f"), rs.uniform(-0.2, 0.2, (8,)).astype("f")]
    if mx is mxnet_tpu:
        import jax.numpy as jnp

        from mxnet_tpu.ops.pallas_conv_bn import bn_candidates, conv_block

        x, w, scale, shift = (jnp.asarray(a) for a in host)
        cands = bn_candidates(2, 8, 16, 64, 4, taps=1, prologue=True)
        assert cands[0] == 16 and 8 in cands
        ref = conv_block(x, w, scale, shift, None, (1, 1), (1, 1), True, True, "xla")
        got = conv_block(x, w, scale, shift, None, (1, 1), (1, 1), True, True, "xla", 8)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-5)
        bad = conv_block(x, w, scale, shift, None, (1, 1), (1, 1), True, True, "xla", 3)
        for a, b in zip(ref, bad):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        return
    from mxnet_tpu_torch.ops import conv_bn as cb

    def run(bwd):
        leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in host]
        outs = cb.ConvBlock.apply(*leaves, None, (1, 1), True, bwd)
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
        return [o.detach() for o in outs] + [t.grad for t in leaves]

    for a, b in zip(run("recompute"), run("xla")):
        assert torch.equal(a, b)
    for a, b in zip(run("stash"), run("recompute")):
        assert torch.equal(a, b)
    with pytest.raises(pt.MXNetError, match="bwd must be"):
        run("pallas")


def test_conv_schedule_reads_tuned_stripe(mx):
    kernel, stride = (1, 1), (1, 1)
    x_shape, w_shape = (2, 8, 8, 8), (16, 8, 1, 1)
    key = mx.fusion._conv_bn_key(kernel, stride, x_shape, w_shape, np.float32, False)
    mx.fusion_tune.verdict(key, lambda: {
        "engage": True, "lowering": "pallas:recompute@bn=8",
        "measured": {"pallas:recompute@bn=8": {"fwd_us": 1.0}}})
    want = 8 if mx is mxnet_tpu else None  # the port's kernels take no stripe override
    assert mx.fusion.conv_schedule(kernel, stride, x_shape, w_shape, np.float32, False) == want
    assert mx.fusion.bwd_mode(kernel, stride, x_shape, w_shape, np.float32,
                              True) in ("recompute", "xla")


def test_cold_tune_searches_and_persists_schedules(mx, monkeypatch):
    _fit_once(mx, monkeypatch, hidden=256, rows=256)
    assert _count(mx, "fusion.tune") == 1
    payload = json.load(open(mx.fusion_tune.cache_path()))
    assert payload["version"] == 2
    [rec] = list(payload["entries"].values())
    assert rec["schedules_searched"] >= 1
    assert any("@" in n for n in rec["measured"])
    mx.fusion_tune.reset()
    mx.telemetry.reset()
    _fit_once(mx, monkeypatch, hidden=256, rows=256)
    assert _count(mx, "fusion.tune") == 0


def test_schedules_zero_restores_binary_verdicts(mx, monkeypatch):
    monkeypatch.setenv("MXNET_FUSION_TUNE_SCHEDULES", "0")
    _fit_once(mx, monkeypatch, hidden=256, rows=256)
    [rec] = list(json.load(open(mx.fusion_tune.cache_path()))["entries"].values())
    assert rec["schedules_searched"] == 0
    assert not any("@" in n for n in rec["measured"])


# -------------------------------------------------------------- both packages
def test_the_cache_keys_match_the_reference(monkeypatch, tmp_path):
    """At the same site both packages key their verdict alike, and the
    port's record carries the reference's fields."""
    recs = {}
    for name, m in (("jax", mxnet_tpu), ("port", pt)):
        monkeypatch.setenv("MXNET_FUSION_TUNE_DIR", str(tmp_path / name))
        monkeypatch.setenv("MXNET_FUSION_TUNE_ITERS", "2")
        m.fusion_tune.reset()
        with pt.cpu() if m is pt else contextlib.nullcontext():
            _fit_once(m, monkeypatch)
            recs[name] = json.load(open(m.fusion_tune.cache_path()))["entries"]
        m.fusion_tune.reset()
    assert list(recs["jax"]) == list(recs["port"])
    [(jrec, prec)] = [(recs["jax"][k], recs["port"][k]) for k in recs["jax"]]
    # a winner adds its own fields (fused_*_us, rel_err, schedule), and
    # which candidate wins is each package's own measurement
    always = {"engage", "engage_fwd", "lowering", "iters", "train", "measured",
              "base_fwd_us", "base_bwd_us", "tune_s", "schedules_searched"}
    assert always <= set(jrec) and always <= set(prec)
    assert "pallas" in jrec["measured"] and "cuda" in prec["measured"]


# ------------------------------------------------------------- the departure
def test_a_parity_rejection_is_cached_departure(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FUSION_TUNE_DIR", str(tmp_path))
    pt.fusion_tune.reset()
    with pt.cpu():
        x = (np.random.RandomState(0).randn(64).astype("f"),)
        calls = []

        def measure():
            calls.append(1)
            return pt.fusion_tune.measure_candidates(lambda a: a * 2.0,
                                                     [("wrong", lambda a: a * 2.5)], x, iters=2)

        rec = pt.fusion_tune.verdict("parity", measure)
        assert rec["engage"] is False and "rejected" in rec["measured"]["wrong"]
        pt.fusion_tune.reset()
        assert pt.fusion_tune.verdict("parity", measure) == rec
        assert len(calls) == 1
    pt.fusion_tune.reset()


def test_a_cpu_candidate_failure_is_recorded_departure():
    """On the CPU a candidate that raises is recorded, as the JAX package
    records it (the card re-raises: ``tests/test_torch_cuda.py``)."""
    def bad(a):
        raise RuntimeError("broken candidate")

    with pt.cpu():
        rec = pt.fusion_tune.measure_candidates(lambda a: a * 2.0, [("bad", bad)],
                                                (np.ones(8, "f"),), iters=1)
    assert rec["engage"] is False and "broken candidate" in rec["measured"]["bad"]["error"]


def test_every_reference_case_is_mirrored():
    here = {n for n in globals() if n.startswith("test_")}
    for ref in ("test_fusion_tune_cache.py", "test_schedule_search.py"):
        names = {n.name for n in ast.parse((ROOT / "tests" / ref).read_text()).body
                 if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
        assert names <= here, sorted(names - here)
