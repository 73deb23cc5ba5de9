"""The port's graph lint (``mxnet_tpu_torch/analysis/``: ``shape_lint``,
``retrace_guard``, ``shard_lint``, ``memory_plan``) held against the JAX
package's.

The cases of the reference's ``tests/test_graphlint.py`` for these four
passes run on both packages (fixture ``mx``): every GL0xx, GL2xx, GL4xx and
GL5xx code fires on its broken graph and stays silent on its clean one, the
sharding-plan and memory-plan acceptance cases, the telemetry gauge, the
budget variable, the fused step's bind feeding the real mesh, the
``infer_meta`` registry, the bind-time modes and the unknown-pass refusal.
Beside them, each report's ``(code, node, severity)`` list and its
``memory_plan`` dict equal the JAX package's, for every code's graphs and
for the zoo's models over several meshes, budgets and policies. The JAX
side runs its four passes by name (its other passes belong to ROADMAP.md
section 1.5), with its pattern engine set to the port's three patterns and
its attention forced onto the flash lowering (``MXNET_FUSED_PATTERNS``):
the port's engine has no ``elemwise_chain`` pattern and trains every
attention site it can through its flash kernels, and the memory plan's
fusion and attention entries report each package's own engine.

The cases of ``tests/test_graphlint.py`` that wait for section 1.5 (the
engine analysis, the rewrite verifier, the dispatch and concurrency lints,
the fusion explainer's GL3xx codes and the ``graphlint`` CLI) are named in
``WAITS_FOR_1_5``; a completeness check holds that every reference case is
mirrored here or listed there.
"""
import ast
import contextlib
import importlib
import logging
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu
import mxnet_tpu_torch as pt

ROOT = Path(__file__).resolve().parents[1]
PASSES = ["shape_lint", "retrace_guard", "shard_lint", "memory_plan"]
JAX_PATTERNS = "attention=pallas_flash,matmul_bias_act,norm_residual"

_S15 = "ROADMAP.md section 1.5 (tooling: the engine, rewrite, dispatch and concurrency lints, " \
       "the fusion explainer and the graphlint CLI)"
WAITS_FOR_1_5 = {name: _S15 for name in (
    "test_engine_code_triggers_on_broken_schedule", "test_engine_code_silent_on_clean_schedule",
    "test_gl105_runtime_shim_catches_broken_engine",
    "test_shipped_python_engine_passes_discipline_shim",
    "test_rewrite_code_triggers_on_broken_rewrite", "test_rewrite_code_silent_on_clean_rewrite",
    "test_dispatch_code_triggers_on_broken_source", "test_dispatch_code_silent_on_clean_source",
    "test_dispatch_waived_site_reported_but_not_failing",
    "test_dispatch_family_waiver_covers_every_gl7xx_code", "test_gl705_needs_two_intervals",
    "test_repo_dispatch_scan_flags_kv_decode_host_sync_sites",
    "test_graph_gl703_fires_on_tokenless_decode_symbol_only",
    "test_concurrency_code_triggers_on_broken_source",
    "test_concurrency_code_silent_on_clean_source",
    "test_concurrency_waived_site_reported_but_not_failing",
    "test_concurrency_family_waiver_covers_every_gl8xx_code",
    "test_gl801_except_handler_is_rank_varying", "test_gl801_provenance_names_the_divergent_read",
    "test_repo_concurrency_scan_is_clean_or_waived", "test_wait_for_unknown_var_raises",
    "test_cli_mesh_resnet50_reshard_and_peak_table", "test_cli_mesh_summary_table_and_json_plan",
    "test_cli_bad_mesh_is_usage_error", "test_cli_single_model_clean", "test_cli_list_codes",
    "test_cli_json_format_and_broken_symbol_file", "test_cli_unknown_target_is_usage_error",
    "test_cli_default_shapes_are_case_insensitive", "test_cli_strict_fails_on_warnings",
    "test_cli_all_models_sweep_exits_zero")}
#: the fusion explainer's codes (GL301-GL303) come with section 1.5 too
GL3XX_WAITS = ("GL301", "GL302", "GL303")


@pytest.fixture(params=["jax", "port"])
def mx(request):
    return mxnet_tpu if request.param == "jax" else pt


def _on(m):
    return pt.cpu() if m is pt else contextlib.nullcontext()


def _lint(m, sym, **kw):
    if m is mxnet_tpu:
        kw.setdefault("passes", PASSES)
    return m.analysis.lint(sym, **kw)


def _codes(m, sym, **kw):
    return set(_lint(m, sym, **kw).codes())


def _empty_spec(m):
    if m is mxnet_tpu:
        from jax.sharding import PartitionSpec as P

        return P()
    return ()


# ------------------------------------------------------------ code table
def _gl001_broken(m):
    a = m.sym.Variable("a", shape=(2, 3))
    b = m.sym.Variable("b", shape=(4, 5))
    return m.sym.dot(a, b, name="baddot"), {}


def _gl001_clean(m):
    a = m.sym.Variable("a", shape=(2, 3))
    b = m.sym.Variable("b", shape=(3, 5))
    return m.sym.dot(a, b, name="okdot"), {}


def _gl002_broken(m):
    d, e = m.sym.Variable("data"), m.sym.Variable("extra")
    s = m.sym.FullyConnected(data=d, num_hidden=4, name="fcA") \
        + m.sym.FullyConnected(data=e, num_hidden=4, name="fcB")
    return s, {"shapes": {"data": (2, 8)}}


def _gl002_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=4, name="fcC"),
            {"shapes": {"data": (2, 8)}})


def _gl003_broken(m):
    w = m.sym.Variable("fc_weight", shape=(7, 99))
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), weight=w, num_hidden=7, name="fc"),
            {"shapes": {"data": (2, 10)}})


def _gl003_clean(m):
    w = m.sym.Variable("fc_weight", shape=(7, 10))
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), weight=w, num_hidden=7, name="fc"),
            {"shapes": {"data": (2, 10)}})


def _gl004_broken(m):
    x = m.sym.Variable("x", dtype="float16")
    y = m.sym.Variable("y", dtype="float32")
    return x + y, {"shapes": {"x": (2,), "y": (2,)}}


def _gl004_clean(m):
    x = m.sym.Variable("x", dtype="float16")
    y = m.sym.Variable("y", dtype="float16")
    return x + y, {"shapes": {"x": (2,), "y": (2,)}}


def _gl005_broken(m):
    return m.sym.Variable("dup") + m.sym.Variable("dup"), {"shapes": {"dup": (2,)}}


def _gl005_clean(m):
    return m.sym.Variable("p") + m.sym.Variable("q"), {"shapes": {"p": (2,), "q": (2,)}}


def _gl006_broken(m):
    flat = m.sym.Flatten(data=m.sym.Variable("data"))
    return (m.sym.Convolution(data=flat, num_filter=8, kernel=(3, 3), name="badconv"),
            {"shapes": {"data": (2, 3, 8, 8)}})


def _gl006_clean(m):
    return (m.sym.Convolution(data=m.sym.Variable("data"), num_filter=8, kernel=(3, 3),
                              pad=(1, 1), name="okconv"),
            {"shapes": {"data": (2, 3, 8, 8)}})


def _gl201_broken(m):
    return m.sym.Variable("x") * 0.125, {}


def _gl201_clean(m):
    return m.sym.Variable("x") + m.sym.Variable("y"), {}


def _gl202_broken(m):
    h = m.sym.Variable("h", dtype="float16")
    return m.sym.Variable("x") + h, {}


def _gl202_clean(m):
    h = m.sym.Variable("h", dtype="float16")
    return m.sym.Variable("x", dtype="float16") + h, {}


def _gl203_broken(m):
    return m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=4, name="fcP"), {}


def _gl203_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=4, name="fcP"),
            {"shapes": {"data": (2, 8)}})


def _gl401_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=999, name="oddfc"),
            {"shapes": {"data": (4, 783)}, "mesh": "dp=2,model=2"})


def _gl401_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=1000, name="evenfc"),
            {"shapes": {"data": (4, 784)}, "mesh": "dp=2,model=2"})


def _gl402_broken(m):
    h = m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=256, name="fcbig")
    return (m.sym.FullyConnected(data=h, num_hidden=8, name="fcsmall"),
            {"shapes": {"data": (8, 512)}, "mesh": "dp=2,model=2"})


def _gl402_clean(m):
    h = m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=16, name="fc_a")
    return (m.sym.FullyConnected(data=h, num_hidden=8, name="fc_b"),
            {"shapes": {"data": (8, 64)}, "mesh": "dp=2,model=2"})


def _gl403_broken(m):
    s = m.sym.sum(m.sym.Variable("data"), name="collapse")
    return s * 2.0, {"shapes": {"data": (8, 16)}, "mesh": "dp=2"}


def _gl403_clean(m):
    return (m.sym.sum(m.sym.Variable("data"), name="lossval"),
            {"shapes": {"data": (8, 16)}, "mesh": "dp=2"})


def _gl404_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (3, 16)}, "mesh": "dp=2"})


def _gl404_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (4, 16)}, "mesh": "dp=2"})


def _gl405_rules(m, param_rule):
    mesh = m.parallel.parse_mesh_spec("dp=2,model=2")
    return mesh, m.parallel.ShardingRules.infer_axes(mesh, param_rule=param_rule)


def _gl405_broken(m):
    empty = _empty_spec(m)
    mesh, rules = _gl405_rules(m, lambda name, shape: empty)  # replicate all
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=256, name="fc"),
            {"shapes": {"data": (8, 512)}, "mesh": mesh, "rules": rules})


def _gl405_clean(m):
    mesh, rules = _gl405_rules(m, None)
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=256, name="fc"),
            {"shapes": {"data": (8, 512)}, "mesh": mesh, "rules": rules})


def _gl501_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (8, 16)}, "budget_gb": 1e-6})


def _gl501_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (8, 16)}, "budget_gb": 1000.0})


def _gl502_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=65536, name="bigfc"),
            {"shapes": {"data": (4096, 64)}})


def _gl502_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=1024, name="smallfc"),
            {"shapes": {"data": (64, 64)}})


GRAPH_CODE_CASES = {
    "GL001": (_gl001_broken, _gl001_clean), "GL002": (_gl002_broken, _gl002_clean),
    "GL003": (_gl003_broken, _gl003_clean), "GL004": (_gl004_broken, _gl004_clean),
    "GL005": (_gl005_broken, _gl005_clean), "GL006": (_gl006_broken, _gl006_clean),
    "GL201": (_gl201_broken, _gl201_clean), "GL202": (_gl202_broken, _gl202_clean),
    "GL203": (_gl203_broken, _gl203_clean),
    "GL401": (_gl401_broken, _gl401_clean), "GL402": (_gl402_broken, _gl402_clean),
    "GL403": (_gl403_broken, _gl403_clean), "GL404": (_gl404_broken, _gl404_clean),
    "GL405": (_gl405_broken, _gl405_clean),
    "GL501": (_gl501_broken, _gl501_clean), "GL502": (_gl502_broken, _gl502_clean),
}


def _build(m, builder):
    with m.name.NameManager():
        return builder(m)


@pytest.mark.parametrize("code", sorted(GRAPH_CODE_CASES))
def test_graph_code_triggers_on_broken_graph(mx, code):
    sym, kw = _build(mx, GRAPH_CODE_CASES[code][0])
    assert code in _codes(mx, sym, **kw)


@pytest.mark.parametrize("code", sorted(GRAPH_CODE_CASES))
def test_graph_code_silent_on_clean_graph(mx, code):
    sym, kw = _build(mx, GRAPH_CODE_CASES[code][1])
    assert code not in _codes(mx, sym, **kw)


def _rows(report):
    return [(d.code, d.node, d.severity) for d in report]


@pytest.fixture
def jax_patterns(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", JAX_PATTERNS)


@pytest.mark.parametrize("code", sorted(GRAPH_CODE_CASES))
@pytest.mark.parametrize("side", [0, 1], ids=["broken", "clean"])
def test_each_codes_report_equals_the_references(code, side, jax_patterns):
    reports = []
    for m in (mxnet_tpu, pt):
        sym, kw = _build(m, GRAPH_CODE_CASES[code][side])
        reports.append(_lint(m, sym, **kw))
    ref, port = reports
    assert _rows(port) == _rows(ref)
    assert port.memory_plan == ref.memory_plan
    assert port.reshard_total_bytes == ref.reshard_total_bytes
    # a GL001 quotes the backend's own exception after its prefix
    assert [_message(d) for d in port] == [_message(d) for d in ref]


def _message(d):
    return d.message.split(": ")[0] if d.code == "GL001" else d.message


ZOO = {
    "mlp": (dict(num_classes=10), {"data": (8, 784)}),
    "lenet": (dict(num_classes=10), {"data": (8, 1, 28, 28)}),
    "resnet-18": (dict(num_classes=10, image_shape="3,32,32"), {"data": (8, 3, 32, 32)}),
    "resnet-50": (dict(num_classes=10, image_shape="3,32,32"), {"data": (8, 3, 32, 32)}),
    "transformer": (dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64,
                         seq_len=16), {"data": (8, 16), "softmax_label": (8, 16)}),
    "recommender": (dict(num_users=512, num_items=256, embed_dim=16, dense_dim=8),
                    {"user": (8,), "item": (8,), "dense": (8, 8)}),
}
LINT_KW = {"single": {}, "dp8": {"mesh": "dp=8"}, "dp4_tp2": {"mesh": "dp=4,model=2"},
           "budget": {"mesh": "dp=2", "budget_gb": 1e-4}, "recompute": {"bwd": "recompute"},
           "inference": {"train": False}}


@pytest.mark.parametrize("kw", sorted(LINT_KW))
@pytest.mark.parametrize("model", sorted(ZOO))
def test_zoo_reports_and_memory_plans_equal_the_references(model, kw, jax_patterns):
    build, shapes = ZOO[model]
    reports = []
    for m in (mxnet_tpu, pt):
        with m.name.NameManager():
            sym = m.models.get_symbol(model, **build)
        reports.append(_lint(m, sym, shapes=shapes, **LINT_KW[kw]))
    ref, port = reports
    assert _rows(port) == _rows(ref)
    assert port.memory_plan == ref.memory_plan
    assert port.memory_plan is not None and port.memory_plan["per_device"]["peak"] > 0


def test_every_diagnostic_code_is_tested():
    """Every code of the four passes has its trigger/clean pair here; the
    GL3xx codes wait for the fusion explainer (section 1.5)."""
    codes = {c for c in pt.analysis.CODES if c[:3] in ("GL0", "GL2", "GL4", "GL5")}
    assert set(GRAPH_CODE_CASES) == codes
    assert set(pt.analysis.CODES) == set(mxnet_tpu.analysis.CODES)
    assert set(c for c in pt.analysis.CODES if c.startswith("GL3")) == set(GL3XX_WAITS)


def test_every_reference_case_is_mirrored_or_waits_for_section_1_5():
    ref = {n.name for n in ast.parse((ROOT / "tests" / "test_graphlint.py").read_text()).body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    here = {n for n in globals() if n.startswith("test_")}
    assert ref - here == set(WAITS_FOR_1_5)


def test_registered_passes_are_the_references_four_in_order():
    assert pt.analysis.list_passes() == PASSES
    for name in ("fusion_explain", "dispatch_lint", "concurrency_lint"):
        with pytest.raises(ValueError, match="unknown analysis pass"):
            pt.analysis.lint(_build(pt, _gl001_clean)[0], passes=[name])


# ------------------------------------------- GL4xx/GL5xx acceptance cases
def test_missharded_symbol_fires_three_distinct_gl4xx_codes(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, num_hidden=256, name="fc1")
    h = mx.sym.Activation(data=h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(data=h, num_hidden=8, name="fc2")
    odd = mx.sym.FullyConnected(data=mx.sym.Variable("aux_data"), num_hidden=999, name="oddfc")
    sym = mx.sym.Group([h, odd])
    report = _lint(mx, sym, shapes={"data": (3, 512), "aux_data": (4, 783)},
                   mesh="dp=2,model=2", target="missharded")
    fired = {c for c in report.codes() if c.startswith("GL4")}
    assert len(fired) >= 3 and {"GL401", "GL402", "GL404"} <= fired, report.format()


def test_clean_model_lints_clean_under_mesh_and_budget(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    report = _lint(mx, net, shapes={"data": (8, 784)}, mesh="dp=8", budget_gb=16.0,
                   target="mlp")
    assert report.codes() == [], report.format()
    assert report.memory_plan is not None and report.memory_plan["per_device"]["peak"] > 0


def test_memory_plan_structure_and_policies(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    sh = {"data": (32, 784)}
    stash = _lint(mx, net, shapes=sh).memory_plan
    rec = _lint(mx, net, shapes=sh, bwd="recompute").memory_plan
    inf = _lint(mx, net, shapes=sh, train=False).memory_plan
    pd = stash["per_device"]
    assert pd["peak"] == (pd["params"] + pd["grads"] + pd["opt_state"] + pd["inputs"]
                          + pd["act_peak"])
    assert pd["grads"] == pd["opt_state"] > 0
    assert rec["per_device"]["act_peak"] <= pd["act_peak"]
    assert inf["per_device"]["grads"] == inf["per_device"]["opt_state"] == 0
    assert inf["per_device"]["peak"] < pd["peak"]
    assert stash["peak_node"] and stash["peak_live"]
    dp = _lint(mx, net, shapes=sh, mesh="dp=8").memory_plan
    assert dp["per_device"]["act_peak"] < pd["act_peak"]
    assert dp["per_device"]["params"] == pd["params"]


def test_predicted_peak_within_2x_of_measured_live_buffers(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    shapes = {"data": (32, 784), "softmax_label": (32,)}
    pred = _lint(mx, net, shapes=shapes, target="mlp").memory_plan["per_device"]["peak"]
    with _on(mx):
        exe = net.simple_bind(ctx=mx.cpu(), **shapes)
        exe.forward(is_train=True)
        exe.backward()

    def nbytes(a):
        return int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize

    measured = sum(nbytes(a) for a in exe.arg_arrays)
    measured += sum(nbytes(g) for g in exe.grad_arrays if g is not None)
    measured += sum(nbytes(a) for a in exe.aux_arrays)
    measured += sum(nbytes(o) for o in exe.outputs)
    assert measured / 2 <= pred <= measured * 2, (pred, measured)


def test_batch_one_keeps_batch_sharding_no_false_gl403(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    report = _lint(mx, net, shapes={"data": (1, 784)}, mesh="dp=8,model=2", target="mlp-b1")
    assert "GL403" not in report.codes(), report.format()


def test_null_grad_req_bind_plans_inference(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    net = mx.models.get_symbol("mlp", num_classes=10)
    arg_shapes, _, _ = net.infer_shape(data=(8, 784))
    with _on(mx):
        args = {n: mx.nd.zeros(s) for n, s in zip(net.list_arguments(), arg_shapes)}
        grads = {n: mx.nd.zeros(s) for n, s in zip(net.list_arguments(), arg_shapes)}
    mx.telemetry.reset()
    net.bind(ctx=mx.cpu(), args=args, args_grad=grads, grad_req="write")
    train_peak = mx.telemetry.gauge("memlint.predicted_peak_bytes").value
    mx.telemetry.reset()
    net.bind(ctx=mx.cpu(), args=args, args_grad=grads, grad_req="null")
    inf_peak = mx.telemetry.gauge("memlint.predicted_peak_bytes").value
    assert inf_peak < train_peak, (inf_peak, train_peak)


def test_memory_plan_exports_telemetry_gauge(mx, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    mx.telemetry.reset()
    net = mx.models.get_symbol("mlp", num_classes=10)
    report = _lint(mx, net, shapes={"data": (8, 784)})
    g = mx.telemetry.gauge("memlint.predicted_peak_bytes")
    assert g.value == report.memory_plan["per_device"]["peak"]


def test_memlint_budget_env_var(mx, monkeypatch):
    monkeypatch.setenv("MXNET_MEMLINT_BUDGET_GB", "0.000001")
    sym, kw = _build(mx, _gl501_clean)
    assert "GL501" in _lint(mx, sym, shapes=kw["shapes"]).codes()
    monkeypatch.setenv("MXNET_MEMLINT_BUDGET_GB", "1000")
    assert "GL501" not in _codes(mx, sym, shapes=kw["shapes"])


def test_spmd_adapter_feeds_mesh_to_lint(mx, monkeypatch):
    """The fused step's bind lints with the REAL mesh and rules: the
    predicted peak lands on the gauge and reflects the dp=8 sharding."""
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    mx.telemetry.reset()
    net = mx.models.get_symbol("mlp", num_classes=10)
    with _on(mx):
        it = mx.io.NDArrayIter(np.zeros((16, 784), "float32"), np.zeros((16,), "float32"),
                               batch_size=16)
        mod = mx.mod.Module(net, context=[mx.cpu(i) for i in range(8)])
        mod.fit(it, num_epoch=1)
    assert mod._spmd is not None, "fused SPMD step did not engage"
    spmd_peak = mx.telemetry.gauge("memlint.predicted_peak_bytes").value
    assert spmd_peak and spmd_peak > 0
    single = _lint(mx, net, shapes={"data": (16, 784), "softmax_label": (16,)}).memory_plan
    assert single["per_device"]["act_peak"] > 0
    assert spmd_peak < single["per_device"]["peak"]


def test_spmd_adapter_lints_the_same_plan_in_both_packages(monkeypatch, caplog):
    """Under ``MXNET_GRAPHLINT=warn`` the fused step of a batch of 12 over
    eight devices logs the same GL404 (12 rows do not split 8 ways) and
    sets the same gauge value in both packages."""
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    peaks, lines = [], []
    for m in (mxnet_tpu, pt):
        m.telemetry.reset()
        caplog.clear()
        net = m.models.get_symbol("mlp", num_classes=10)
        with _on(m), caplog.at_level(logging.WARNING, logger="mxnet_tpu.graphlint"):
            it = m.io.NDArrayIter(np.zeros((16, 784), "float32"), np.zeros((16,), "float32"),
                                  batch_size=16)
            mod = m.mod.Module(net, context=[m.cpu(i) for i in range(8)])
            mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
            mod.init_params()
            mod.init_optimizer()
        assert mod._spmd is not None
        peaks.append(m.telemetry.gauge("memlint.predicted_peak_bytes").value)
        lines.append(sorted(r.getMessage() for r in caplog.records
                            if r.name == "mxnet_tpu.graphlint"))
    assert peaks[0] == peaks[1] > 0
    assert lines[0] == lines[1]


# ----------------------------------------------------------- infer_meta
def test_infer_meta_registry(mx):
    infer_meta = importlib.import_module(mx.__name__ + ".ops.infer_meta")
    shape_rules = importlib.import_module(mx.__name__ + ".ops.shape_rules")
    conv = infer_meta.get_meta("Convolution")
    assert conv.input_ranks["data"] == (4, 4)
    assert "weight" in conv.param_slots
    assert infer_meta.backward_shape_rule("FullyConnected") \
        is shape_rules.RULES["FullyConnected"]
    default = infer_meta.get_meta("no_such_op")
    assert default.input_ranks == {} and default.param_slots == ()


def test_infer_meta_tables_equal_the_references():
    from mxnet_tpu.ops import infer_meta as jm
    from mxnet_tpu_torch.ops import infer_meta as pm

    assert pm.SHARD_RULES == jm.SHARD_RULES and pm.EMBEDDING_RULES == jm.EMBEDDING_RULES
    assert sorted(pm._META) == sorted(jm._META)
    for name, meta in jm._META.items():
        got = pm._META[name]
        for field in meta.__slots__:
            assert getattr(got, field) == getattr(meta, field), (name, field)


# ------------------------------------------------ bind-time modes
def test_bind_lint_error_mode_raises(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "error")
    sym, kw = _build(mx, _gl006_broken)
    with _on(mx), pytest.raises(mx.MXNetError, match="GL006"):
        sym.simple_bind(ctx=mx.cpu(), **kw["shapes"])


def test_bind_lint_error_mode_passes_clean_graph(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "error")
    net = mx.models.get_symbol("mlp", num_classes=10)
    with _on(mx):
        exe = net.simple_bind(ctx=mx.cpu(), data=(4, 784), softmax_label=(4,))
        assert exe.forward(is_train=False)[0].shape == (4, 10)


def test_bind_lint_warn_mode_logs_but_binds(mx, monkeypatch, caplog):
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    x = mx.sym.Variable("x", dtype="float16")
    y = mx.sym.Variable("y", dtype="float32")
    with _on(mx), caplog.at_level("WARNING", logger="mxnet_tpu.graphlint"):
        exe = (x + y).simple_bind(ctx=mx.cpu(), x=(2,), y=(2,),
                                  type_dict={"x": "float16", "y": "float32"})
    assert exe is not None
    assert any("GL004" in r.message for r in caplog.records)


def test_bind_lint_off_by_default(mx, monkeypatch):
    monkeypatch.delenv("MXNET_GRAPHLINT", raising=False)
    assert mx.analysis.graphlint_mode() is None


def test_graphlint_mode_aliases_and_unknown(mx, monkeypatch, caplog):
    monkeypatch.setenv("MXNET_GRAPHLINT", "1")
    assert mx.analysis.graphlint_mode() == "warn"
    monkeypatch.setenv("MXNET_GRAPHLINT", "bogus-%s" % mx.__name__)
    with caplog.at_level("WARNING", logger="mxnet_tpu.graphlint"):
        assert mx.analysis.graphlint_mode() is None
    assert any("not a recognized mode" in r.message for r in caplog.records)


def test_resnet_lints_clean_under_error_mode(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "error")
    net = mx.models.get_symbol("resnet-18", num_classes=10, image_shape="3,32,32")
    with _on(mx):
        exe = net.simple_bind(ctx=mx.cpu(), data=(2, 3, 32, 32), softmax_label=(2,))
    assert exe is not None
    report = _lint(mx, net, shapes={"data": (2, 3, 32, 32)}, target="resnet-18")
    assert report.errors == [] and report.warnings == []


def test_unknown_pass_subset_raises(mx):
    sym, _ = _build(mx, _gl001_clean)
    with pytest.raises(ValueError, match="unknown analysis pass"):
        mx.analysis.lint(sym, passes=["shapelint"])


# ------------------------------------------------------------ sources
def test_package_sources_compile():
    """Every port source parses and compiles."""
    bad = []
    for path in sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")):
        try:
            compile(path.read_text(), str(path), "exec")
        except SyntaxError as exc:
            bad.append("%s: %s" % (path, exc))
    assert not bad, "\n".join(bad)


def test_pyflakes_clean_when_available():
    pytest.importorskip("pyflakes")
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "pyflakes", str(ROOT / "mxnet_tpu_torch")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
