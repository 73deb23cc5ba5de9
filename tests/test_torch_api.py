"""API parity of the port against the JAX package (ROADMAP section 3,
faults F1-F4): the same call on both packages, with the same signature
(``inspect.signature``: the same parameter names in the same order) and the
same result (the same Symbol JSON, or the same values at float32
tolerance). A sweep compares the signatures of every public callable both
packages define; its exceptions are named in ``SIGNATURE_EXCEPTIONS``, so a
new gap fails it."""
import copy
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _params_of(obj):
    return [p.name for p in inspect.signature(obj).parameters.values()]


def _same_signature(ref, port):
    assert _params_of(port) == _params_of(ref), (port, _params_of(port), _params_of(ref))


# ---------------------------------------------------------------- F1
def test_f1_the_serving_cache_and_the_decoders_take_the_references_arguments(tmp_path):
    from mxnet_tpu import serving as js
    from mxnet_tpu_torch import serving as ps

    for name in ("PersistentExecutableCache", "KVCacheDecoder", "PagedKVDecoder"):
        _same_signature(getattr(js, name), getattr(ps, name))
    _same_signature(js.PersistentExecutableCache.warmup, ps.PersistentExecutableCache.warmup)
    _same_signature(js.SpeculativeDecoder.build, ps.SpeculativeDecoder.build)

    def mlp(S):
        return S.FullyConnected(S.Variable("data"), num_hidden=3, name="fc")

    rs = np.random.RandomState(0)
    args = {"fc_weight": rs.randn(3, 4).astype(np.float32), "fc_bias": np.zeros(3, np.float32)}
    x = rs.randn(2, 4).astype(np.float32)
    outs = []
    for i, (S, ctx, cls) in enumerate(((mx.sym, mx.cpu(), js.PersistentExecutableCache),
                                       (pt.sym, pt.cpu(), ps.PersistentExecutableCache))):
        # positional, in the reference's order
        c = cls(mlp(S), args, {}, ctx, "float32", "fc model", str(tmp_path / str(i)), 4)
        assert c.warmup([{"data": (2, 4)}], seal=True) == 1
        assert c._model_key == "fc_model"
        outs.append(c.run({"data": x})[0])
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    with pytest.raises(pt.MXNetError, match="TF32/bf16"):
        ps.PersistentExecutableCache(mlp(pt.sym), args, {}, pt.cpu(), "bfloat16")

    cfg = dict(vocab_size=11, num_layers=1, num_heads=1, model_dim=8, ffn_dim=16,
               max_len=8, prefill_len=4, pos_len=8)
    net = pt.models.transformer.get_symbol(seq_len=8, **cfg)
    shapes = net.infer_shape(data=(1, 8), softmax_label=(1, 8))[0]
    w = {n: (rs.randn(*s) * 0.3).astype(np.float32)
         for n, s in zip(net.list_arguments(), shapes) if n not in ("data", "softmax_label")}
    tcfg = {k: v for k, v in cfg.items() if k != "max_len"}
    for cls_name, extra in (("KVCacheDecoder", dict(max_len=8, batch=1)),
                            ("PagedKVDecoder", dict(max_len=8, page_size=4, lanes=1))):
        keys = []
        for mod, ctx in ((js, mx.cpu()), (ps, pt.cpu())):
            dec = getattr(mod, cls_name)(w, ctx=ctx, dtype="float32", cache_dir=None,
                                         model_key="lm", **tcfg, **extra)
            keys.append((dec._pf_cache._model_key, dec._dec_cache._model_key))
        assert keys[0] == keys[1] == ("lm-prefill", "lm-decode")
        with pytest.raises(pt.MXNetError, match="TF32/bf16"):
            getattr(ps, cls_name)(w, ctx=pt.cpu(), dtype="bfloat16", **tcfg, **extra)
    spec_keys = []
    for mod, ctx in ((js, mx.cpu()), (ps, pt.cpu())):
        spec = mod.SpeculativeDecoder.build(w, draft_layers=1, gamma=2, model_key="lm",
                                            ctx=ctx, page_size=4, lanes=1, **cfg)
        spec_keys.append((spec.target._dec_cache._model_key, spec.draft._dec_cache._model_key))
    assert spec_keys[0] == spec_keys[1] == ("lm-decode", "lm-draft1-decode")


# ---------------------------------------------------------------- F2
def _expressions(S):
    a, b = S.Variable("a"), S.Variable("b")
    return [a / 2, 2 / a, a / b, -a, a ** 2, a ** b, a == 1, a != 1, a < 1, a <= 1, a > 1,
            a >= 1, a == b, a != b, a < b, a <= b, a > b, a >= b, a + 1, 1 - a, a * b,
            S.pow(a, 2), S.pow(2, a), S.pow(a, b), S.maximum(a, 1), S.maximum(1, a),
            S.maximum(a, b), S.minimum(a, 2), S.minimum(a, b)]


def _with_names(pkg, fn):
    with pkg.name.NameManager():
        return fn()


def test_f2_symbol_operators_helpers_and_methods_match_the_reference():
    ref = _with_names(mx, lambda: mx.sym.Group(_expressions(mx.sym)))
    port = _with_names(pt, lambda: pt.sym.Group(_expressions(pt.sym)))
    assert port.tojson() == ref.tojson()
    assert len(port) == len(ref) == 29
    assert [s.tojson() for s in port] == [s.tojson() for s in ref]
    assert copy.copy(port).tojson() == port.tojson()
    assert hash(port) != hash(copy.copy(port))  # identity hashing, as the reference's

    def variables(S):
        return S.Group([
            S.Variable("w", shape=(3, 4), lr_mult=0.5, wd_mult=2, dtype="float16",
                       init="zeros", __ctx_group__="dev1"),
            S.var("v", attr={"mood": "x"}),
            S.FullyConnected(S.Variable("data"), num_hidden=3, name="fc",
                             attr={"__lr_mult__": "0.1"})])

    vr, vp = variables(mx.sym), variables(pt.sym)
    assert vp.tojson() == vr.tojson()
    assert pt.sym.fromjson(vr.tojson()).tojson() == vr.tojson()
    with pytest.raises(ValueError):
        pt.sym.Variable("w", mood="x")
    for name in ("attr_dict", "list_inputs", "list_arguments", "list_outputs", "debug_str"):
        assert getattr(vp, name)() == getattr(vr, name)(), name
    w_r, w_p = vr[0], vp[0]
    assert w_p.attr("__lr_mult__") == w_r.attr("__lr_mult__") == "0.5"
    assert w_p.attr("nope") is None
    assert w_p.list_attr() == w_r.list_attr()
    fc_r, fc_p = vr[2], vp[2]
    assert fc_p.get_children().tojson() == fc_r.get_children().tojson()
    assert pt.sym.Variable("x").get_children() is None

    def net(S):
        return S.FullyConnected(S.Variable("data"), num_hidden=3, name="fc")

    nr, np_ = net(mx.sym), net(pt.sym)
    assert np_.infer_shape((2, 4)) == nr.infer_shape((2, 4))
    assert np_.infer_shape((2, 4))[0] == [(2, 4), (3, 4), (3,)]
    assert np_.infer_shape_partial() == nr.infer_shape_partial()
    assert np_.infer_shape_partial(fc_weight=(3, 4)) == nr.infer_shape_partial(fc_weight=(3, 4))
    assert np_.infer_type(np.float32) == nr.infer_type(np.float32)
    assert np_.infer_type(data="float16") == nr.infer_type(data="float16")
    rs = np.random.RandomState(0)
    vals = {"data": rs.randn(2, 4).astype(np.float32),
            "fc_weight": rs.randn(3, 4).astype(np.float32),
            "fc_bias": rs.randn(3).astype(np.float32)}
    out_r = nr.eval(ctx=mx.cpu(), **{k: mx.nd.array(v) for k, v in vals.items()})
    out_p = np_.eval(ctx=pt.cpu(), **{k: pt.nd.array(v, ctx=pt.cpu()) for k, v in vals.items()})
    np.testing.assert_allclose(out_p[0].asnumpy(), out_r[0].asnumpy(), rtol=RTOL, atol=ATOL)
    for name in ("Variable", "var", "pow", "maximum", "minimum", "fromjson"):
        _same_signature(getattr(mx.sym, name), getattr(pt.sym, name))
    for name in ("infer_shape", "infer_shape_partial", "infer_type", "eval", "attr",
                 "list_attr", "attr_dict", "list_inputs", "get_children", "debug_str"):
        _same_signature(getattr(mx.sym.Symbol, name), getattr(pt.sym.Symbol, name))


# ---------------------------------------------------------------- F3
def test_f3_executor_and_context_match_the_reference():
    for name in ("forward", "reshape", "set_monitor_callback", "debug_str"):
        _same_signature(getattr(mx.executor.Executor, name), getattr(pt.Executor, name))
    for name in ("bind", "simple_bind"):
        _same_signature(getattr(mx.executor, name), getattr(pt.executor, name))
        _same_signature(getattr(mx.sym.Symbol, name), getattr(pt.sym.Symbol, name))

    def net(S):
        return S.FullyConnected(S.Variable("data"), num_hidden=3, name="fc")

    rs = np.random.RandomState(1)
    w = rs.randn(3, 4).astype(np.float32)
    x2, x5 = rs.randn(2, 4).astype(np.float32), rs.randn(5, 4).astype(np.float32)
    results = []
    for pkg in (mx, pt):
        sym = net(pkg.sym)
        exe = sym.simple_bind(pkg.cpu(), grad_req="null", data=(2, 4), group2ctx={"dev": pkg.cpu()})
        exe.arg_dict["fc_weight"][:] = w
        seen = []
        exe.set_monitor_callback(lambda name, arr: seen.append(name))
        a = exe.forward(is_train=False, data=x2)[0].asnumpy()
        big = exe.reshape(allow_up_sizing=True, data=(5, 4))
        assert big.arg_dict["fc_weight"] is exe.arg_dict["fc_weight"]
        b = big.forward(data=x5)[0].asnumpy()
        shared = sym.simple_bind(pkg.cpu(), grad_req="write", shared_exec=exe, data=(2, 4))
        if pkg is pt:  # the port shares the parameter tensors themselves
            assert shared.arg_dict["fc_weight"] is exe.arg_dict["fc_weight"]
        else:
            shared.arg_dict["fc_weight"][:] = w
        # inputs and gradients stay each executor's own, as in the reference
        exe.arg_dict["data"][:] = x2
        shared.arg_dict["data"][:] = 2 * x2
        assert np.array_equal(exe.arg_dict["data"].asnumpy(), x2)
        c = shared.forward(is_train=True)[0].asnumpy()
        shared.backward(pkg.nd.ones((2, 3), ctx=pkg.cpu()))
        again = sym.simple_bind(pkg.cpu(), grad_req="write", shared_exec=shared, data=(2, 4))
        again.arg_dict["data"][:] = x2
        again.forward(is_train=True)
        again.backward(pkg.nd.ones((2, 3), ctx=pkg.cpu()) * 3)
        grads = {n: g.asnumpy() for n, g in shared.grad_dict.items()}
        bound = sym.bind(pkg.cpu(), dict(exe.arg_dict), shared_exec=exe)
        d = bound.forward(data=x2)[0].asnumpy()
        with pytest.raises(pkg.base.MXNetError, match="unknown argument"):
            exe.forward(nope=x2)
        with pytest.raises(pkg.base.MXNetError, match="larger than original"):
            exe.reshape(data=(5, 4))
        results.append((a, b, c, d, grads, seen, exe.debug_str()))
    for r, p in zip(results[0][:4], results[1][:4]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)
    assert sorted(results[0][4]) == sorted(results[1][4])
    for n, g in results[0][4].items():
        np.testing.assert_allclose(results[1][4][n], g, rtol=RTOL, atol=ATOL)
    assert results[0][5:] == results[1][5:]
    with pytest.raises(pt.MXNetError, match="one device"):
        net(pt.sym).simple_bind(pt.cpu(), grad_req="null", data=(2, 4),
                                group2ctx={"dev": pt.gpu(0)})
    assert pt.context.num_gpus() == torch.cuda.device_count()
    _same_signature(mx.context.num_gpus, pt.context.num_gpus)
    _same_signature(mx.context.Context.empty_cache, pt.context.Context.empty_cache)
    pt.cpu().empty_cache()  # nothing to return on the CPU


# ---------------------------------------------------------------- F4
def test_f4_graph_functions_registry_name_and_base_match_the_reference():
    graphs = [("get_symbol", dict(seq_len=8)), ("get_prefill_symbol", dict(prefill_len=4)),
              ("get_decode_symbol", dict(max_len=8)),
              ("get_chunk_symbol", dict(chunk_len=2, total_slots=8, pos_len=8))]
    cfg = dict(vocab_size=11, num_layers=1, num_heads=1, model_dim=8, ffn_dim=16)
    for name, kw in graphs:
        _same_signature(getattr(mx.models.transformer, name),
                        getattr(pt.models.transformer, name))
        ref = _with_names(mx, lambda: getattr(mx.models.transformer, name)(
            dropout=0.1, **cfg, **kw))
        port = _with_names(pt, lambda: getattr(pt.models.transformer, name)(
            dropout=0.1, **cfg, **kw))
        assert port.tojson() == ref.tojson(), name
    for op in ("FullyConnected", "_div_scalar", "no_such_op"):
        assert pt.ops.registry.has_op(op) == mx.ops.registry.has_op(op)
    with mx.name.Prefix("enc_"):
        ref = mx.sym.FullyConnected(mx.sym.Variable("x"), num_hidden=2)
    with pt.name.Prefix("enc_"):
        port = pt.sym.FullyConnected(pt.sym.Variable("x"), num_hidden=2)
    assert port.tojson() == ref.tojson() and port.name.startswith("enc_")
    assert issubclass(pt.base.EvictedError, pt.MXNetError)
    assert pt.base.EvictedError.__name__ == mx.base.EvictedError.__name__


# -------------------------------------------------------- signature sweep
#: (module, name) pairs whose signatures differ on purpose or wait for a
#: queued item: the loaders' trailing ``ctx=`` and ``Rtc(block=)`` (CUDA
#: side), the rewrite passes' arguments and NDArray's ``writable``
#: (ROADMAP section 5), and fusion's internal marker, whose fields follow
#: the port's kernels
SIGNATURE_EXCEPTIONS = {
    ("analysis.rewrite", "rewrite"), ("analysis.rewrite", "rewrite_for_bind"),
    ("fusion", "PendingConv"), ("model", "load_checkpoint"), ("model", "resume_or_init"),
    ("ndarray", "NDArray"), ("ndarray", "load"),
    ("predictor", "load_ndarray_file"), ("rtc", "Rtc"),
}


def _signature_gaps():
    gaps = set()
    for info in pkgutil.walk_packages(pt.__path__, "mxnet_tpu_torch."):
        rel = info.name[len("mxnet_tpu_torch."):]
        port_mod = importlib.import_module(info.name)
        try:
            ref_mod = importlib.import_module("mxnet_tpu." + rel)
        except ImportError:
            continue
        for attr in dir(port_mod):
            po, ro = getattr(port_mod, attr), getattr(ref_mod, attr, None)
            if attr.startswith("_") or ro is None or not callable(po) or not callable(ro) \
                    or getattr(po, "__module__", None) != info.name:
                continue
            pairs = [(attr, po, ro)]
            if inspect.isclass(po) and inspect.isclass(ro):
                pairs += [("%s.%s" % (attr, m), getattr(po, m), getattr(ro, m))
                          for m in dir(po) if not m.startswith("_") and hasattr(ro, m)
                          and callable(getattr(po, m)) and callable(getattr(ro, m))]
            for name, a, b in pairs:
                try:
                    same = _params_of(a) == _params_of(b)
                except (TypeError, ValueError):
                    continue  # a builtin without a signature
                if not same:
                    gaps.add((rel, name))
    return gaps


def test_every_shared_public_callable_has_the_references_signature():
    gaps = _signature_gaps()
    assert gaps == SIGNATURE_EXCEPTIONS, (
        "new gaps: %s; closed exceptions to remove: %s"
        % (sorted(gaps - SIGNATURE_EXCEPTIONS), sorted(SIGNATURE_EXCEPTIONS - gaps)))


# ---------------------------------------------------------------- F5
@pytest.mark.parametrize("value", ["cpu", "cpu:1"])
def test_f5_default_context_follows_the_environment(value):
    """``MXNET_DEFAULT_CONTEXT`` names the default context in both packages
    (JAX ``context.py:125-135``), read in a fresh process each; under
    ``cpu`` the port's process group backend is gloo."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import {pkg} as m; c = m.current_context(); print(c.device_type, c.device_id)"
            "{extra}")
    extra = {"mxnet_tpu": "",
             "mxnet_tpu_torch": "; from mxnet_tpu_torch import dist; print(dist._default_backend())"}
    got = {}
    for pkg in ("mxnet_tpu", "mxnet_tpu_torch"):
        env = dict(os.environ, MXNET_DEFAULT_CONTEXT=value, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", code.format(pkg=pkg, extra=extra[pkg])],
                             env=env, capture_output=True, text=True, timeout=300,
                             cwd=str(Path(__file__).resolve().parents[1]), check=True)
        got[pkg] = out.stdout.split()
    name, _, idx = value.partition(":")
    assert got["mxnet_tpu"] == [name, idx or "0"]
    assert got["mxnet_tpu_torch"] == [name, idx or "0", "gloo"]


def test_f5_a_with_block_wins_and_a_gpu_default_does_not_fall_back(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu:2")
    assert pt.current_context() == pt.cpu(2)
    with pt.cpu(5):
        assert pt.current_context() == pt.cpu(5)
    assert pt.current_context() == pt.cpu(2)
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "gpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pt.current_context() == pt.gpu(0)
    from mxnet_tpu_torch import dist

    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        dist._default_backend()


# ---------------------------------------------------------------- F6
_STEP4 = "ROADMAP.md section 1.4b step 4 (the planner, the analysis passes)"
_TOOLING = "ROADMAP.md section 1.5 (tooling: fusion, profiler and lint families)"
_FLEET = "ROADMAP.md section 1, item 6 (the serving fleet)"
_NO_TPU = "the port targets no TPU"

#: (module, name) of the reference's ``__all__`` that the port lacks, each
#: with the queued item it waits on or the reason it never comes
ALL_EXCEPTIONS = {
    ("", "tpu"): _NO_TPU,
    ("context", "tpu"): _NO_TPU,
    ("context", "num_tpus"): _NO_TPU,
    ("parallel", "ParallelPlan"): _STEP4,
    ("parallel", "PlanError"): _STEP4,
    ("parallel", "plan_parallel"): _STEP4,
    ("parallel.mesh", "shard_map_compat"): "JAX's shard_map; the port runs a mesh's shards "
                                           "as one program (parallel/trainer.py)",
    ("module", "PipelineExecutorGroup"): _STEP4,
    ("serving", "fleet"): _FLEET,
    **{("analysis", n): _STEP4 for n in (
        "CODES", "Diagnostic", "Report", "Severity", "describe_code", "GraphContext",
        "graph_pass", "list_passes", "run_graph_passes")},
    **{("analysis", n): _TOOLING for n in (
        "RecordingEngine", "ScheduleTrace", "analyze_trace", "lint", "lint_bind",
        "graphlint_mode", "verify_rewrite", "graphrewrite_mode", "RewritePass",
        "RewriteResult", "rewrite_pass_names", "pattern_site_counts", "lint_dispatch_paths",
        "lint_dispatch_source", "lint_dispatch_gaps", "dispatch_gap_pct")},
    **{("analysis.rewrite", n): _TOOLING for n in (
        "verify_rewrite", "graphrewrite_mode", "RewritePass", "RewriteResult",
        "rewrite_pass_names", "pattern_site_counts")},
    **{("fusion", n): _TOOLING for n in (
        "gate", "gate_explain", "bwd_mode", "infer_default", "quant_mode", "enabled_patterns",
        "gate_pattern_explain", "conv_schedule", "losers_note", "attention_trains_flash")},
    **{("ops.fusion_patterns", n): _TOOLING for n in ("sig_of", "tuner_build")},
}


def _all_gaps():
    """(module, name) of every name in a reference module's ``__all__``
    (the top level's too) that the port's module of the same name lacks."""
    gaps = set()
    rels = [""] + [info.name[len("mxnet_tpu_torch."):]
                   for info in pkgutil.walk_packages(pt.__path__, "mxnet_tpu_torch.")]
    for rel in rels:
        port_mod = importlib.import_module("mxnet_tpu_torch" + ("." + rel if rel else ""))
        try:
            ref_mod = importlib.import_module("mxnet_tpu" + ("." + rel if rel else ""))
        except ImportError:
            continue
        for name in getattr(ref_mod, "__all__", ()):
            if not hasattr(port_mod, name):
                gaps.add((rel, name))
    return gaps


def test_f6_every_shared_modules_all_names_exist_in_the_port():
    gaps = _all_gaps()
    want = set(ALL_EXCEPTIONS)
    assert gaps == want, ("new gaps: %s; closed exceptions to remove: %s"
                          % (sorted(gaps - want), sorted(want - gaps)))


def test_f6_the_names_the_port_lacked_are_the_references():
    assert pt.AttrScope is pt.attribute.AttrScope
    with pt.AttrScope(ctx_group="dev1"):
        a = pt.sym.Variable("a")
    with mx.AttrScope(ctx_group="dev1"):
        b = mx.sym.Variable("a")
    assert a.tojson() == b.tojson()
    for name in ("_create_kvstore", "_initialize_kvstore", "_update_params_on_kvstore",
                 "_update_params"):
        assert getattr(pt.model, name) is getattr(pt.kvstore_helper, name[1:])
        _same_signature(getattr(mx.model, name), getattr(pt.model, name))
    for name in ("AttrSpec", "OpDef", "has_op", "parse_attrs", "register", "get_op",
                 "list_ops"):
        assert getattr(pt.ops, name) is getattr(pt.ops.registry, name)
    assert pt.base.string_types == mx.base.string_types
    assert pt.base.numeric_types == mx.base.numeric_types
