"""The port's auto-parallel planner (``parallel/autoplan.py``) and GPipe
pipeline (``module.PipelineExecutorGroup``) held against the JAX package's.

The cases of the reference's ``tests/test_autoplan.py`` run on both
packages (fixture ``mx``), its two ``graphlint`` CLI cases through each
package's ``analysis/cli.py`` (``WAIT_FOR_CLI`` is empty). Beside them:
``plan_parallel(...).to_json()`` is byte-equal to the JAX package's for
``mlp``, resnet-18, ResNet-50, the transformer LM and the recommender at
1, 2, 4 and 8 devices, with no budget and with one that forces pipeline
stages; the pipeline's gradients, outputs and BatchNorm moving statistics
equal the JAX package's ``PipelineExecutorGroup`` and the full-batch step;
and the 2-process comm-bytes prediction lies within 2x of the port's
``kvstore.bytes.*`` counters on a gloo job (``tools/launch.py -n 2
--cpu-devices 1``). The JAX side plans with its pattern engine set to the
port's three patterns and its attention on the flash lowering
(``MXNET_FUSED_PATTERNS``), as ``tests/test_torch_graphlint.py`` explains.
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_PATTERNS = "attention=pallas_flash,matmul_bias_act,norm_residual"
#: reference cases not mirrored here (none)
WAIT_FOR_CLI = ()


@pytest.fixture(params=["jax", "port"])
def mx(request):
    return mxnet_tpu if request.param == "jax" else pt


def _on(m):
    return pt.cpu() if m is pt else contextlib.nullcontext()


def _autoplan(m):
    return m.parallel.autoplan


def _mlp(m, hidden=512, layers=2, name_prefix="fc"):
    s = m.sym.Variable("data")
    for i in range(layers):
        s = m.sym.FullyConnected(s, num_hidden=hidden, name="%s%d" % (name_prefix, i))
        s = m.sym.Activation(s, act_type="relu", name="act%d" % i)
    s = m.sym.FullyConnected(s, num_hidden=4, name="head")
    return m.sym.SoftmaxOutput(s, name="softmax")


MLP_SHAPES = {"data": (32, 512)}


def _lint(m, sym, **kw):
    return m.analysis.lint(sym, **kw)


class _Batch:
    def __init__(self, data, label):
        self.data, self.label = data, label


# ------------------------------------------------------------------ search
def test_plan_deterministic(mx):
    ap = _autoplan(mx)
    a = ap.plan_parallel(_mlp(mx), MLP_SHAPES, devices=8)
    b = ap.plan_parallel(_mlp(mx), MLP_SHAPES, devices=8)
    assert a.to_dict() == b.to_dict()
    c = ap.ParallelPlan.from_dict(json.loads(a.to_json()))
    assert c.to_dict() == a.to_dict()


def test_plan_beats_or_matches_naive(mx):
    plan = _autoplan(mx).plan_parallel(_mlp(mx), MLP_SHAPES, devices=8)
    assert plan.feasible and plan.naive is not None
    assert plan.predicted["comm_bytes"] <= plan.naive["comm_bytes"]


def test_budget_boundary(mx):
    ap = _autoplan(mx)
    free = ap.plan_parallel(_mlp(mx), MLP_SHAPES, devices=8)
    peak = free.predicted["peak_bytes"]
    at = ap.plan_parallel(_mlp(mx), MLP_SHAPES, devices=8, budget_bytes=peak)
    assert at.feasible and at.mesh == free.mesh and at.predicted["peak_bytes"] == peak
    under = ap.plan_parallel(_mlp(mx), MLP_SHAPES, devices=8, budget_bytes=peak - 1)
    if under.feasible and under.pipeline_stages == 1:
        assert under.predicted["peak_bytes"] <= peak - 1
    assert under.to_dict() != at.to_dict()


def test_indivisible_param_falls_back_to_replication_matching_gl401(mx):
    sym = _mlp(mx, hidden=1001)
    shapes = {"data": (8, 1001)}
    plan = _autoplan(mx).plan_parallel(sym, shapes, devices=8)
    for name, axes in plan.param_specs.items():
        assert not any(axes), "planner sharded indivisible param %r" % name
    report = _lint(mx, sym, shapes=shapes, mesh="data=4,model=2")
    assert any("fc0_weight" in (d.node or "") for d in report.by_code("GL401")), \
        report.format()


def test_spec_options_respect_min_shard_elems(mx):
    plan = _autoplan(mx).plan_parallel(_mlp(mx, hidden=64), {"data": (32, 64)}, devices=8)
    for name, axes in plan.param_specs.items():
        if name.startswith("fc") and name.endswith("_weight"):
            assert not any(axes), name


# --------------------------------------------------- analysis satellites
def test_reshard_total_bytes_uncapped(mx):
    H, N = 64, 12
    s = mx.sym.Variable("data")
    for i in range(N):
        s = mx.sym.FullyConnected(s, num_hidden=H, no_bias=True, name="fc%d" % i)
    sym = mx.sym.SoftmaxOutput(s, name="softmax")
    if mx is mxnet_tpu:
        from jax.sharding import PartitionSpec as P
    else:
        P = lambda *a: tuple(a)  # noqa: E731 - the port's spec is a tuple

    def rule(name, shape):
        if name.endswith("_weight") and len(shape) == 2:
            return P(None, "model")
        return P()

    mesh = mx.parallel.MeshSpec({"data": 2, "model": 2})
    rules = mx.parallel.ShardingRules(mesh, param_rule=rule)
    report = _lint(mx, sym, shapes={"data": (8, H)}, mesh=mesh, rules=rules)
    assert report.reshard_total_bytes == N * (H * H * 4 // 2)
    assert len(report.by_code("GL402")) == 9
    assert "reshard_total_bytes" in report.to_json()


def test_gl501_hint_names_the_planner(mx):
    report = _lint(mx, _mlp(mx), shapes=MLP_SHAPES, mesh="data=2,model=1", budget_gb=1e-6)
    gl501 = report.by_code("GL501")
    assert gl501, report.format()
    hint = gl501[0].fix_hint or ""
    assert "MXNET_AUTOPLAN=1" in hint and "graphlint --autoplan" in hint


# ---------------------------------------------------- byte-equal plans
PLAN_MODELS = {
    "mlp": (dict(num_classes=10), {"data": (32, 784), "softmax_label": (32,)}),
    "resnet-18": (dict(num_classes=10, image_shape="3,32,32"),
                  {"data": (8, 3, 32, 32), "softmax_label": (8,)}),
    "resnet-50": (dict(num_classes=10, image_shape="3,32,32"),
                  {"data": (8, 3, 32, 32), "softmax_label": (8,)}),
    "transformer": (dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64,
                         seq_len=16), {"data": (8, 16), "softmax_label": (8, 16)}),
    "recommender": (dict(num_users=4096, num_items=2048, embed_dim=32, dense_dim=8),
                    {"user": (16,), "item": (16,), "dense": (16, 8), "label": (16,)}),
}


@pytest.mark.parametrize("model", sorted(PLAN_MODELS))
def test_plans_are_byte_equal_to_the_references(model, monkeypatch):
    """No budget, then 0.55 of the unconstrained peak (every dp x tp plan
    over budget: pipeline stages where the graph offers cuts, else the
    infeasible plan with its reason), at 1, 2, 4 and 8 devices."""
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", JAX_PATTERNS)
    build, shapes = PLAN_MODELS[model]
    syms = {}
    for m in (mxnet_tpu, pt):
        with m.name.NameManager():
            syms[m] = m.models.get_symbol(model, **build)
    pipelined = 0
    for devices in (1, 2, 4, 8):
        free = mxnet_tpu.parallel.autoplan.plan_parallel(syms[mxnet_tpu], shapes,
                                                         devices=devices)
        budget = int(free.predicted["peak_bytes"] * 0.55)
        for kw in ({}, {"budget_bytes": budget}):
            ref = mxnet_tpu.parallel.autoplan.plan_parallel(syms[mxnet_tpu], shapes,
                                                            devices=devices, **kw)
            port = pt.parallel.autoplan.plan_parallel(syms[pt], shapes, devices=devices, **kw)
            assert port.to_json() == ref.to_json(), (model, devices, kw)
            assert port.summary() == ref.summary()
            pipelined += port.pipeline_stages > 1
    if model != "mlp":
        assert pipelined, "no budget forced pipeline stages for %s" % model


# ----------------------------------------------------------- pipeline split
def test_find_cuts_and_split_symbol(mx):
    ap = _autoplan(mx)
    sym = _mlp(mx, hidden=128, layers=3)
    cuts = ap.find_pipeline_cuts(sym, {"data": (8, 128)})
    assert cuts and all(c["bytes"] > 0 for c in cuts)
    stages, bnames = ap.split_symbol(sym, [cuts[0]["entry"]])
    assert len(stages) == 2 and bnames == ["__pipe0__"]
    orig = set(sym.list_arguments()) - {"data", "softmax_label"}
    s0 = set(stages[0].list_arguments()) - {"data"}
    s1 = set(stages[1].list_arguments()) - {"__pipe0__", "softmax_label"}
    assert s0 | s1 == orig and not (s0 & s1)
    assert set(sym.list_arguments()) >= orig


def test_cuts_and_stage_symbols_equal_the_references():
    sym = {m: _mlp(m, hidden=128, layers=3) for m in (mxnet_tpu, pt)}
    cuts = {m: m.parallel.autoplan.find_pipeline_cuts(sym[m], {"data": (8, 128)})
            for m in sym}
    assert cuts[pt] == cuts[mxnet_tpu]
    labels = [c["entry"] for c in cuts[pt][:2]]
    stages = {m: m.parallel.autoplan.split_symbol(sym[m], labels)[0] for m in sym}
    assert [s.tojson() for s in stages[pt]] == [s.tojson() for s in stages[mxnet_tpu]]
    assert pt.parallel.autoplan.choose_cuts(sym[pt], {"data": (8, 128)}, n_stages=3) == \
        mxnet_tpu.parallel.autoplan.choose_cuts(sym[mxnet_tpu], {"data": (8, 128)}, n_stages=3)


def _parity_net(m):
    s = m.sym.Variable("data")
    s = m.sym.FullyConnected(s, num_hidden=32, name="fc1")
    s = m.sym.Activation(s, act_type="relu", name="a1")
    s = m.sym.FullyConnected(s, num_hidden=32, name="fc2")
    s = m.sym.Activation(s, act_type="tanh", name="a2")
    s = m.sym.FullyConnected(s, num_hidden=4, name="fc3")
    return m.sym.SoftmaxOutput(s, name="softmax")


def _pipeline_case(m, sym, x, y, init, aux=None, **kw):
    with _on(m):
        pg = importlib.import_module(m.__name__ + ".module").PipelineExecutorGroup(sym, m.cpu(), [("data", x.shape)],
                                            [("softmax_label", y.shape)], **kw)
        pg.set_params({k: m.nd.array(v) for k, v in init.items()},
                      {k: m.nd.array(v) for k, v in (aux or {}).items()})
        pg.forward_backward(_Batch([m.nd.array(x)], [m.nd.array(y)]))
    grads = {n: pg._owner(n).grad_dict[n].asnumpy() for n in init}
    args, auxs = {}, {}
    pg.get_params(args, auxs)
    return pg, pg.get_outputs()[0].asnumpy(), grads, {k: v.asnumpy() for k, v in auxs.items()}


def test_pipeline_schedule_grad_parity(mx):
    """GPipe microbatch schedule == single-executor full batch, atol 1e-5."""
    rs = np.random.RandomState(0)
    B, D, C = 8, 16, 4
    sym = _parity_net(mx)
    x = rs.uniform(-1, 1, (B, D)).astype("f")
    y = rs.randint(0, C, (B,)).astype("f")
    with _on(mx):
        ex = sym.simple_bind(mx.cpu(), data=(B, D), softmax_label=(B,), grad_req="write")
    init = {}
    for name, arr in ex.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        init[name] = rs.uniform(-0.5, 0.5, arr.shape).astype("f")
        arr[:] = init[name]
    ex.arg_dict["data"][:] = x
    ex.arg_dict["softmax_label"][:] = y
    ex.forward(is_train=True)
    ex.backward()
    base_grads = {n: ex.grad_dict[n].asnumpy() for n in init}
    base_out = ex.outputs[0].asnumpy()
    pg, out, grads, _ = _pipeline_case(mx, sym, x, y, init, num_stages=2, microbatches=4)
    assert pg.num_stages == 2 and pg.microbatches == 4
    np.testing.assert_allclose(out, base_out, atol=1e-5)
    for n in init:
        np.testing.assert_allclose(grads[n], base_grads[n], atol=1e-5, err_msg=n)


@pytest.mark.parametrize("stages,mu", [(2, 4), (3, 2), (2, 1)])
def test_pipeline_equals_the_references_pipeline(stages, mu):
    """The port's schedule and the JAX package's over the same cuts, from
    the same numpy weights: outputs and every gradient within 1e-5."""
    rs = np.random.RandomState(3)
    B, D = 8, 16
    x = rs.uniform(-1, 1, (B, D)).astype("f")
    y = rs.randint(0, 4, (B,)).astype("f")
    shapes = dict(zip(_parity_net(pt).list_arguments(),
                      _parity_net(pt).infer_shape(data=(B, D))[0]))
    init = {n: rs.uniform(-0.5, 0.5, s).astype("f") for n, s in shapes.items()
            if n not in ("data", "softmax_label")}
    got = {m: _pipeline_case(m, _parity_net(m), x, y, init, num_stages=stages, microbatches=mu)
           for m in (mxnet_tpu, pt)}
    assert got[pt][0].cut_entries == got[mxnet_tpu][0].cut_entries
    np.testing.assert_allclose(got[pt][1], got[mxnet_tpu][1], atol=1e-5)
    for n in init:
        np.testing.assert_allclose(got[pt][2][n], got[mxnet_tpu][2][n], atol=1e-5, err_msg=n)


def test_pipeline_of_a_batchnorm_net_equals_the_references():
    """A narrow pre-activation bottleneck net (the zoo's ``residual_unit``)
    cut into two stages, two microbatches: the port's stages run their
    conv+BN sites through the kernels' plain versions, the JAX package's
    through XLA; outputs, gradients and the moving statistics (updated
    once a microbatch forward, never by the recompute) agree within the
    conv+BN tolerances of ``tests/test_torch_resnet.py``."""
    from mxnet_tpu.models import resnet as jres
    from mxnet_tpu_torch.models import resnet as pres

    def net(m, res):
        with m.name.NameManager():
            body = res.residual_unit(m.sym.Variable("data"), 16, (1, 1), False, "u1")
            body = res.residual_unit(body, 16, (1, 1), True, "u2")
            bn = m.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn")
            relu = m.sym.Activation(data=bn, act_type="relu", name="relu")
            pool = m.sym.Pooling(data=relu, global_pool=True, kernel=(8, 8), pool_type="avg",
                                 name="pool")
            fc = m.sym.FullyConnected(data=m.sym.Flatten(data=pool), num_hidden=4, name="fc")
            return m.sym.SoftmaxOutput(data=fc, name="softmax")

    rs = np.random.RandomState(5)
    B = 4
    x = rs.uniform(-1, 1, (B, 8, 8, 8)).astype("f")
    y = rs.randint(0, 4, (B,)).astype("f")
    psym = net(pt, pres)
    arg_shapes, _, aux_shapes = psym.infer_shape(data=x.shape)
    init, aux = {}, {}
    for n, s in zip(psym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        init[n] = (rs.uniform(0.5, 1.5, s) if n.endswith("_gamma") else
                   rs.uniform(-0.2, 0.2, s) if n.endswith(("_beta", "_bias")) else
                   rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))).astype("f")
    for n, s in zip(psym.list_auxiliary_states(), aux_shapes):
        aux[n] = (rs.uniform(0.5, 1.5, s) if n.endswith("_var")
                  else rs.uniform(-0.1, 0.1, s)).astype("f")
    got = {}
    for m, res in ((mxnet_tpu, jres), (pt, pres)):
        got[m] = _pipeline_case(m, net(m, res), x, y, init, aux, num_stages=2, microbatches=2)
    assert got[pt][0].cut_entries == got[mxnet_tpu][0].cut_entries
    np.testing.assert_allclose(got[pt][1], got[mxnet_tpu][1], rtol=1e-4, atol=1e-5)
    for n in init:
        np.testing.assert_allclose(got[pt][2][n], got[mxnet_tpu][2][n], rtol=2e-3, atol=2e-4,
                                   err_msg=n)
    for n in aux:
        np.testing.assert_allclose(got[pt][3][n], got[mxnet_tpu][3][n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
        assert np.abs(got[pt][3][n] - aux[n]).max() > 0, n


def test_over_budget_model_trains_under_pipeline_plan(mx):
    """A model over budget on every dp x tp assignment gets a pipeline
    plan, and 3 SGD steps under its schedule equal the single-stage
    baseline's (atol 1e-5)."""
    ap = _autoplan(mx)
    rs = np.random.RandomState(1)
    B, D, C = 8, 1001, 4
    s = mx.sym.Variable("data")
    for i in range(4):
        s = mx.sym.FullyConnected(s, num_hidden=1001, name="fc%d" % i)
        s = mx.sym.Activation(s, act_type="relu", name="act%d" % i)
    s = mx.sym.FullyConnected(s, num_hidden=C, name="head")
    sym = mx.sym.SoftmaxOutput(s, name="softmax")
    shapes = {"data": (B, D)}
    free = ap.plan_parallel(sym, shapes, devices=4)
    budget = int(free.predicted["peak_bytes"] * 0.55)
    report = _lint(mx, sym, shapes=shapes, mesh="data=4,model=1", budget_gb=budget / 2 ** 30)
    assert report.by_code("GL501"), report.format()
    plan = ap.plan_parallel(sym, shapes, devices=4, budget_bytes=budget, microbatches=4)
    assert plan.feasible and plan.pipeline_stages > 1, plan.summary()
    assert plan.stage_cuts and plan.predicted["peak_bytes"] <= budget

    x = rs.uniform(-1, 1, (B, D)).astype("f")
    y = rs.randint(0, C, (B,)).astype("f")
    with _on(mx):
        ex = sym.simple_bind(mx.cpu(), data=(B, D), softmax_label=(B,), grad_req="write")
    init = {}
    for name, arr in ex.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        init[name] = rs.uniform(-0.02, 0.02, arr.shape).astype("f")
        arr[:] = init[name]
    ex.arg_dict["data"][:] = x
    ex.arg_dict["softmax_label"][:] = y
    lr = 0.01
    for _ in range(3):
        ex.forward(is_train=True)
        ex.backward()
        for name in init:
            ex.arg_dict[name][:] = ex.arg_dict[name].asnumpy() - lr * ex.grad_dict[name].asnumpy()
    with _on(mx):
        pg = importlib.import_module(mx.__name__ + ".module").PipelineExecutorGroup(sym, mx.cpu(), [("data", (B, D))],
                                             [("softmax_label", (B,))],
                                             cut_entries=plan.stage_cuts,
                                             microbatches=plan.microbatches)
        pg.set_params({k: mx.nd.array(v) for k, v in init.items()}, {})
        b = _Batch([mx.nd.array(x)], [mx.nd.array(y)])
    for _ in range(3):
        pg.forward_backward(b)
        for k, ex_k in enumerate(pg.execs):
            for name in pg._stage_params[k]:
                ex_k.arg_dict[name][:] = (ex_k.arg_dict[name].asnumpy()
                                          - lr * ex_k.grad_dict[name].asnumpy())
    for name in init:
        np.testing.assert_allclose(pg._owner(name).arg_dict[name].asnumpy(),
                                   ex.arg_dict[name].asnumpy(), atol=1e-5, err_msg=name)


# ------------------------------------------------------------ integration
def test_spmd_adapter_consumes_plan(mx, monkeypatch):
    """MXNET_AUTOPLAN=1: the fused-step Module takes the planner's mesh and
    lays its params out by the planner's specs."""
    monkeypatch.setenv("MXNET_AUTOPLAN", "1")
    rs = np.random.RandomState(0)
    sym = _mlp(mx)
    with _on(mx):
        it = mx.io.NDArrayIter(rs.rand(32, 512).astype("f"),
                               rs.randint(0, 4, (32,)).astype("f"), batch_size=16)
        mod = mx.mod.Module(sym, context=[mx.cpu(i) for i in range(4)])
        mod.fit(it, num_epoch=1, optimizer="sgd")
    assert mod._spmd is not None
    tr = mod._spmd.trainer
    plan = _autoplan(mx).plan_parallel(sym, {"data": (16, 512), "softmax_label": (16,)},
                                       devices=4)
    assert dict(tr.mesh.shape) == plan.mesh
    sharded = [n for n, axes in plan.param_specs.items() if any(axes)]
    assert sharded
    for name in sharded:
        spec = (tr.params[name].sharding.spec if mx is mxnet_tpu
                else tr.rules.param_spec(name, tuple(tr.params[name].shape)))
        assert "model" in tuple(spec), (name, spec)


def test_autoplan_trains_the_same_weights_in_both_packages(monkeypatch):
    """One epoch of the fused step under ``MXNET_AUTOPLAN=1`` over four
    contexts: the same plan, the same weights (rtol 2e-4, atol 2e-5, the
    fused step's tolerances in ``tests/test_torch_spmd.py``)."""
    monkeypatch.setenv("MXNET_AUTOPLAN", "1")
    rs = np.random.RandomState(2)
    x = rs.rand(32, 512).astype("f")
    y = rs.randint(0, 4, (32,)).astype("f")
    shapes = dict(zip(_mlp(pt).list_arguments(), _mlp(pt).infer_shape(data=(16, 512))[0]))
    init = {n: (rs.randn(*s) * 0.05).astype("f") for n, s in shapes.items()
            if n not in ("data", "softmax_label")}
    weights, meshes = [], []
    for m in (mxnet_tpu, pt):
        with _on(m):
            it = m.io.NDArrayIter(x, y, batch_size=16)
            mod = m.mod.Module(_mlp(m), context=[m.cpu(i) for i in range(4)])
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)),
                    arg_params={k: m.nd.array(v) for k, v in init.items()})
        meshes.append(dict(mod._spmd.trainer.mesh.shape))
        weights.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    assert meshes[0] == meshes[1] and meshes[1].get("model", 1) > 1
    for k, want in weights[0].items():
        np.testing.assert_allclose(weights[1][k], want, rtol=2e-4, atol=2e-5, err_msg=k)


def test_autoplan_never_takes_down_a_job(monkeypatch, caplog):
    """A plan with pipeline stages (a budget no dp x tp plan meets) logs
    and keeps the all-data mesh, as the JAX package's adapter does."""
    monkeypatch.setenv("MXNET_AUTOPLAN", "1")
    monkeypatch.setenv("MXNET_AUTOPLAN_BUDGET_GB", "0.00001")
    with pt.cpu():
        it = pt.io.NDArrayIter(np.zeros((16, 512), "f"), np.zeros((16,), "f"), batch_size=16)
        mod = pt.mod.Module(_mlp(pt, layers=4), context=[pt.cpu(i) for i in range(2)])
        with caplog.at_level("WARNING"):
            mod.fit(it, num_epoch=1, optimizer="sgd")
    assert mod._spmd is not None and dict(mod._spmd.trainer.mesh.shape) == {"data": 2}
    assert any("MXNET_AUTOPLAN=1" in r.getMessage() for r in caplog.records)


def _cli_main(m):
    return importlib.import_module(m.__name__ + ".analysis.cli").main


def test_graphlint_autoplan_cli(mx, capsys, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", JAX_PATTERNS)
    rc = _cli_main(mx)(["mlp", "--autoplan", "--mesh-devices", "8", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    plan = payload[0]["autoplan"]
    assert plan["devices"] == 8 and plan["feasible"]
    assert plan["naive"]["comm_bytes"] >= plan["predicted"]["comm_bytes"]


def test_graphlint_autoplan_needs_devices(mx):
    assert _cli_main(mx)(["mlp", "--autoplan"]) == 2


def test_every_reference_case_is_mirrored_or_waits_for_the_cli():
    import ast

    ref = {n.name for n in ast.parse((ROOT / "tests" / "test_autoplan.py").read_text()).body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    here = {n for n in globals() if n.startswith("test_")}
    assert ref - here == set(WAIT_FOR_CLI)


MEASURE = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
os.environ["MXNET_TELEMETRY"] = "counters"
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.parallel import autoplan

BATCH, BATCHES, EPOCHS, DIM = 16, 4, 2, 64


def mlp():
    s = pt.sym.Variable("data")
    s = pt.sym.FullyConnected(s, num_hidden=256, name="fc1")
    s = pt.sym.Activation(s, act_type="relu")
    s = pt.sym.FullyConnected(s, num_hidden=256, name="fc2")
    s = pt.sym.Activation(s, act_type="relu")
    s = pt.sym.FullyConnected(s, num_hidden=4, name="fc3")
    return pt.sym.SoftmaxOutput(s, name="softmax")


with pt.cpu():
    kv = pt.kv.create("dist_sync")
    rank, world = kv.rank, kv.num_workers
    rs = np.random.RandomState(11 + rank)
    x = rs.rand(BATCH * BATCHES, DIM).astype("float32")
    y = rs.randint(0, 4, (BATCH * BATCHES,)).astype("float32")
    it = pt.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = pt.mod.Module(mlp(), context=pt.cpu(), fused_step=False)
    mod.fit(it, num_epoch=EPOCHS, kvstore=kv, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05),))
measured = sum(pt.telemetry.counter("kvstore.bytes.%s" % k).value
               for k in ("allreduce", "reduce_scatter", "all_gather"))
steps = BATCHES * EPOCHS
plan = autoplan.plan_parallel(mlp(), {"data": (BATCH * world, DIM)}, devices=world)
predicted = plan.naive["comm_bytes"]
row = {"workers": world, "steps": steps, "predicted_bytes_per_step": int(predicted),
       "measured_bytes": int(measured), "ratio": measured / float(predicted * steps)}
if rank == 0:
    print("AUTOPLAN_MEASURE " + json.dumps(row), flush=True)
pt.dist.shutdown()
'''


def test_predicted_within_2x_of_measured_2proc(tmp_path):
    """The cost model's grad-sync prediction (the naive all-dp plan's ring
    all-reduce bytes) within 2x of the port's ``kvstore.bytes.*`` counters
    on a 2-process gloo fit through the per-device path and the bucketed
    store."""
    script = tmp_path / "measure.py"
    script.write_text(MEASURE)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("MXNET_TELEMETRY", None)
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "launch.py"), "-n", "2", "--launcher", "local",
         "--cpu-devices", "1", sys.executable, str(script)],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(ROOT))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    row = next(json.loads(l[len("AUTOPLAN_MEASURE "):]) for l in r.stdout.splitlines()
               if l.startswith("AUTOPLAN_MEASURE {"))
    assert row["measured_bytes"] > 0
    assert 0.5 <= row["ratio"] <= 2.0, row
