"""The port's PersistentExecutableCache held against the JAX package's:
the same digest and model key for the same Symbol JSON, the same manifest
fields on disk, ``warmup(None)`` replaying the manifest, an unsealed cache
after zero buckets, the LRU bound, the fusion-site summary's keys,
``snapshot_params`` and an all-or-nothing ``swap_params`` that lands in the
next run without a bind. The port runs on ``cpu()``."""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import telemetry as mx_tm
from mxnet_tpu.serving import PersistentExecutableCache as JaxCache
from mxnet_tpu_torch import telemetry as pt_tm
from mxnet_tpu_torch.serving import PersistentExecutableCache as PortCache
from mxnet_tpu_torch.serving import cache as pcache

torch.set_num_threads(1)

TF = dict(vocab_size=29, num_layers=1, num_heads=2, model_dim=16, ffn_dim=32)


def _mlp(S):
    net = S.FullyConnected(S.Variable("data"), num_hidden=5, name="fc")
    return S.SoftmaxOutput(net, name="softmax")


def _conv(S):
    x = S.Convolution(S.Variable("data"), num_filter=4, kernel=(3, 3), pad=(1, 1),
                      no_bias=True, name="c0")
    x = S.Activation(S.BatchNorm(x, fix_gamma=False, name="bn0"), act_type="relu", name="r0")
    return S.FullyConnected(S.Flatten(x, name="flat"), num_hidden=3, name="fc")


def _params(net, data_shape, seed=0):
    shapes, _, aux_shapes = net.infer_shape(data=data_shape)
    rs = np.random.RandomState(seed)
    args = {n: (rs.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes) if n not in ("data", "softmax_label")}
    aux = {n: (np.abs(rs.randn(*s)) + 0.5).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _pair(build, data_shape, **kw):
    jnet, pnet = build(mx.sym), build(pt.sym)
    args, aux = _params(pnet, data_shape)
    return (JaxCache(jnet, args, aux, ctx=mx.cpu(), **kw),
            PortCache(pnet, args, aux, ctx=pt.cpu(), **kw), args, aux)


@pytest.mark.parametrize("which", ["mlp", "conv", "prefill"])
def test_digest_and_model_key_equal_the_references(which):
    build = {"mlp": _mlp, "conv": _conv,
             "prefill": lambda S: (mx if S is mx.sym else pt).models.transformer
             .get_prefill_symbol(prefill_len=8, pos_len=16, **TF)}[which]
    # fresh name counters: the prefill graph names some nodes automatically
    with mx.name.NameManager():
        jnet = build(mx.sym)
    with pt.name.NameManager():
        pnet = build(pt.sym)
    assert jnet.tojson() == pnet.tojson()
    j = JaxCache(jnet, {}, {}, ctx=mx.cpu())
    p = PortCache(pnet, {}, {}, ctx=pt.cpu())
    assert (p._digest, p._model_key) == (j._digest, j._model_key)
    named = PortCache(pnet, {}, {}, ctx=pt.cpu(), model_key="res net/50")
    assert named._model_key == JaxCache(jnet, {}, {}, ctx=mx.cpu(),
                                        model_key="res net/50")._model_key == "res_net_50"


def test_signature_matches_and_other_dtypes_are_refused():
    net = _mlp(pt.sym)
    with pytest.raises(pt.MXNetError, match="TF32/bf16"):
        PortCache(net, {}, {}, pt.cpu(), "bfloat16")
    c = PortCache(net, {}, {}, pt.cpu(), "float32", "k", None, 3)
    assert (c._dtype, c._model_key, c._cache_dir, c._max_exes) == ("float32", "k", None, 3)


def test_manifest_round_trip_has_the_references_fields(tmp_path):
    recs = []
    for i, (cls, S, ctx) in enumerate(((JaxCache, mx.sym, mx.cpu()),
                                       (PortCache, pt.sym, pt.cpu()))):
        root = str(tmp_path / str(i))
        args, _ = _params(_mlp(pt.sym), (1, 8))
        c1 = cls(_mlp(S), args, {}, ctx=ctx, cache_dir=root, model_key="m")
        assert c1.warmup([{"data": (1, 8)}, {"data": (2, 8)}]) == 2
        path = c1._manifest_path()
        assert path == os.path.join(root, "cpu", "m.json")
        assert not os.path.exists(path + ".tmp")
        rec = json.load(open(path))
        recs.append(rec)
        c2 = cls(_mlp(S), args, {}, ctx=ctx, cache_dir=root, model_key="m")
        assert c2.warmup(None) == 2 and c2.sealed
        assert sorted(c2.keys()) == sorted(c1.keys())
        # another model under the same key inherits nothing, and zero
        # warmed buckets neither seal nor overwrite the manifest
        other = S.SoftmaxOutput(S.FullyConnected(S.Variable("data"), num_hidden=7, name="fc"),
                                name="softmax")
        c3 = cls(other, _params(other, (1, 8))[0], {}, ctx=ctx, cache_dir=root, model_key="m")
        assert c3.warmup(None) == 0 and not c3.sealed
        c3.executable({"data": (1, 8)})
        assert json.load(open(path))["digest"] == rec["digest"]
    assert recs[0] == recs[1]
    assert sorted(recs[1]) == ["buckets", "device_kind", "digest", "dtype", "model_key"]


def test_serve_cache_dir_reads_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv("MXNET_SERVE_CACHE_DIR", raising=False)
    assert pcache.serve_cache_dir() is None
    monkeypatch.setenv("MXNET_SERVE_CACHE_DIR", "  %s " % tmp_path)
    assert pcache.serve_cache_dir() == str(tmp_path)
    args, _ = _params(_mlp(pt.sym), (1, 8))
    c = PortCache(_mlp(pt.sym), args, {}, ctx=pt.cpu(), model_key="env")
    c.warmup([{"data": (1, 8)}])
    assert os.path.exists(os.path.join(str(tmp_path), "cpu", "env.json"))


def test_device_kind_is_the_sanitised_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert pcache._device_kind() == "NVIDIA_H100_80GB_HBM3"


def test_zero_buckets_leave_the_cache_unsealed():
    for cls, S, ctx in ((JaxCache, mx.sym, mx.cpu()), (PortCache, pt.sym, pt.cpu())):
        c = cls(_mlp(S), _params(_mlp(pt.sym), (1, 8))[0], {}, ctx=ctx)
        assert c.warmup([]) == 0 and not c.sealed
        assert c.warmup(None) == 0 and not c.sealed
        c.executable({"data": (3, 8)})


def test_warmup_without_seal_keeps_binding():
    j, p, _, _ = _pair(_mlp, (1, 8))
    for c in (j, p):
        assert c.warmup([{"data": (2, 8)}], seal=False) == 1 and not c.sealed
        c.executable({"data": (3, 8)})
    assert p.binds == 2


def test_the_lru_bound_evicts_as_the_reference():
    saved = pt_tm.current_override(), mx_tm.current_override()
    try:
        for tm in (pt_tm, mx_tm):
            tm.reset()
            tm.set_mode("counters")
        j, p, _, _ = _pair(_mlp, (1, 8), max_executables=2)
        for c in (j, p):
            for r in (1, 2, 3, 2, 4):
                c.executable({"data": (r, 8)})
        assert p.keys() == j.keys() == [(("data", (2, 8)),), (("data", (4, 8)),)]
        for name in ("serving.executable_compile", "serving.executable_evict",
                     "serving.executable_hit"):
            assert pt_tm.counters()[name] == mx_tm.counters()[name], name
        assert pt_tm.gauge("serving.executables").value == 2
        assert sorted(p.fusion_sites()) == sorted(j.fusion_sites())
    finally:
        for tm, s in zip((pt_tm, mx_tm), saved):
            tm.set_mode(s)
            tm.reset()


@pytest.mark.parametrize("build,shape", [(_mlp, (2, 8)), (_conv, (2, 3, 6, 6))])
def test_fusion_sites_have_the_references_keys(build, shape):
    j, p, _, _ = _pair(build, (1,) + shape[1:])
    for c in (j, p):
        c.warmup([{"data": shape}, {"data": (1,) + shape[1:]}])
    js, ps = j.fusion_sites(), p.fusion_sites()
    assert sorted(js) == sorted(ps)
    for k in ps:
        assert sorted(ps[k]) == sorted(js[k])
        # the conv and its BatchNorm are one planned block: two directives
        assert ps[k]["conv_bn_directives"] == (0 if build is _mlp else 2)
        assert ps[k]["conv_bn_infer_active"] == (build is _conv)


def test_snapshot_params_returns_host_copies_of_the_loaded_values():
    j, p, args, aux = _pair(_conv, (1, 3, 6, 6))
    for c in (j, p):
        c.warmup([{"data": (2, 3, 6, 6)}])
    ja, jx = j.snapshot_params()
    pa, px = p.snapshot_params(["fc_weight", "nope"], None)
    assert sorted(pa) == ["fc_weight"] and sorted(px) == sorted(jx)
    np.testing.assert_array_equal(pa["fc_weight"], ja["fc_weight"])
    for n in px:
        np.testing.assert_array_equal(px[n], jx[n])
    pa["fc_weight"][:] = 0  # a copy: the cache keeps its weights
    assert np.array_equal(p.snapshot_params(["fc_weight"])[0]["fc_weight"], args["fc_weight"])


def _run_both(j, p, x):
    return j.run({"data": x})[0], p.run({"data": x})[0]


@pytest.mark.parametrize("bad", ["shape", "uncastable", "input", "unknown", "unknown_aux"])
def test_swap_params_is_all_or_nothing(bad):
    """A swap whose LAST value is bad raises before anything is written:
    both packages keep serving the old weights, with the same error."""
    j, p, args, aux = _pair(_conv, (1, 3, 6, 6))
    x = np.random.RandomState(1).randn(2, 3, 6, 6).astype(np.float32)
    for c in (j, p):
        c.warmup([{"data": (2, 3, 6, 6)}])
    before = _run_both(j, p, x)
    good = {n: v * 2.0 for n, v in args.items()}
    aux_new = None
    if bad == "shape":
        good["fc_bias"] = np.zeros((4,), np.float32)
        match = "shape mismatch"
    elif bad == "uncastable":
        obj = np.empty(args["fc_bias"].shape, dtype=object)
        obj[:] = "x"
        good["fc_bias"] = obj
        match = "not castable"
    elif bad == "input":
        good["data"] = x
        match = "INPUT"
    elif bad == "unknown":
        good["nope"] = np.zeros(3, np.float32)
        match = "unknown argument"
    else:
        aux_new = {"bn0_moving_mean": aux["bn0_moving_mean"] + 1, "nope": np.zeros(1)}
        match = "unknown aux state"
    for c, err in ((j, mx.base.MXNetError), (p, pt.MXNetError)):
        with pytest.raises(err, match=match):
            c.swap_params(good, aux_new)
    after = _run_both(j, p, x)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(after[1], after[0], rtol=1e-5, atol=1e-6)


def test_swap_lands_in_the_next_run_with_zero_binds():
    j, p, args, aux = _pair(_conv, (1, 3, 6, 6))
    x = np.random.RandomState(2).randn(2, 3, 6, 6).astype(np.float32)
    for c in (j, p):
        c.warmup([{"data": (1, 3, 6, 6)}, {"data": (2, 3, 6, 6)}])
    binds = p.binds
    tensors = {n: a._tensor() for n, a in p._shared_args.items()}
    new_args = {n: (v * 1.5).astype(np.float64) for n, v in args.items()}  # cast on swap
    new_aux = {"bn0_moving_var": aux["bn0_moving_var"] * 2}
    assert j.swap_params(new_args, new_aux) == p.swap_params(new_args, new_aux) == \
        len(new_args) + 1
    got = _run_both(j, p, x)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)
    fresh = PortCache(_conv(pt.sym), {n: v.astype(np.float32) for n, v in new_args.items()},
                      dict(aux, **new_aux), ctx=pt.cpu())
    np.testing.assert_array_equal(fresh.run({"data": x})[0], got[1])
    assert p.binds == binds
    assert all(p._shared_args[n]._tensor() is t for n, t in tensors.items())
    snap = p.snapshot_params()
    assert snap[0]["fc_weight"].dtype == np.float32
    np.testing.assert_array_equal(snap[1]["bn0_moving_var"], new_aux["bn0_moving_var"])


def test_a_swap_before_warmup_is_staged_for_the_first_bind():
    j, p, args, _ = _pair(_mlp, (1, 8))
    new = {"fc_bias": args["fc_bias"] + 1}
    for c in (j, p):
        assert c.swap_params(new) == 1
    x = np.ones((2, 8), np.float32)
    got = _run_both(j, p, x)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)
    assert p.binds == 1


def test_a_swap_never_lands_inside_a_run_under_thread_stress():
    """Runs from more threads than cores while another thread swaps between
    two weight sets, with a short switch interval: every output is exactly
    the old weights' or the new weights', never a mix."""
    import sys
    import threading

    net = _conv(pt.sym)
    args, aux = _params(net, (1, 3, 6, 6))
    other = {n: (v * -0.5).astype(np.float32) for n, v in args.items()}
    cache = PortCache(net, args, aux, ctx=pt.cpu())
    cache.warmup([{"data": (2, 3, 6, 6)}])
    x = np.random.RandomState(3).randn(2, 3, 6, 6).astype(np.float32)
    want = [cache.run({"data": x})[0]]
    cache.swap_params(other)
    want.append(cache.run({"data": x})[0])
    assert not np.array_equal(want[0], want[1])
    outs, stop = [], threading.Event()

    def runner():
        while not stop.is_set():
            outs.append(cache.run({"data": x})[0])

    def swapper():
        for i in range(40):
            cache.swap_params(args if i % 2 == 0 else other)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=runner) for _ in range(8)]
        for t in threads:
            t.start()
        sw = threading.Thread(target=swapper)
        sw.start()
        sw.join(timeout=60)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not sw.is_alive() and not any(t.is_alive() for t in threads)
    assert len(outs) > 8
    for o in outs:
        assert np.array_equal(o, want[0]) or np.array_equal(o, want[1])
    assert cache.binds == 1
