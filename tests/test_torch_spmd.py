"""The fused training step of the port (``module/spmd_adapter.py`` over
``parallel.SPMDTrainer``) held against the JAX package's.

The cases of ``tests/test_module_spmd.py`` run on the port, and each
parity case runs the JAX package's fused step beside it on the same numpy
parameters and batches: JAX over its eight virtual CPUs, the port over
``cpu(0..7)``, eight logical devices of the one CPU on which the port runs
the global batch as one step. Tolerances are the JAX test's (params rtol
2e-4, atol 2e-5; outputs rtol 1e-4, atol 1e-5). ``[cpu(0), cpu(0)]`` stays
on the per-device path in both packages, and a ``.states`` file written by
either package's fused step loads into the other's.
"""
import contextlib
import logging
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

PRTOL, PATOL = 2e-4, 2e-5
ORTOL, OATOL = 1e-4, 1e-5
OPTIMIZERS = [
    ("sgd", (("learning_rate", 0.1), ("momentum", 0.9))),
    ("sgd", (("learning_rate", 0.05), ("momentum", 0.0), ("wd", 1e-3))),
    ("adam", (("learning_rate", 0.01),)),
    ("nag", (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-3))),
]


def _on(mx):
    return pt.cpu() if mx is pt else contextlib.nullcontext()


def _mlp(mx, hidden=32, classes=4):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, name="fc1", num_hidden=hidden)
    h = mx.sym.Activation(h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(h, name="fc2", num_hidden=classes)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _params(hidden=32, classes=4, feat=8, seed=1):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": (rs.randn(hidden, feat) * 0.3).astype("f"),
            "fc1_bias": (rs.randn(hidden) * 0.1).astype("f"),
            "fc2_weight": (rs.randn(classes, hidden) * 0.3).astype("f"),
            "fc2_bias": (rs.randn(classes) * 0.1).astype("f")}


def _host_batches(n, batch=16, feat=8, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, feat).astype("f"), rs.randint(0, classes, (batch,)).astype("f"))
            for _ in range(n)]


def _ctxs(mx, n):
    return [mx.cpu(i) for i in range(n)]


def _fit(mx, ctxs, batches, optimizer="sgd", opt_params=None, fused=None, params=None,
         lr_scheduler=None, steps=None):
    """Train the batches (the first ``steps`` of them) through a Module on
    ``ctxs``; returns the module and its final params as numpy."""
    with _on(mx):
        mod = mx.mod.Module(_mlp(mx), context=ctxs,
                            **({} if fused is None else {"fused_step": fused}))
        x0, y0 = batches[0]
        mod.bind(data_shapes=[("data", x0.shape)], label_shapes=[("softmax_label", y0.shape)])
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in (params or _params()).items()})
        opt_params = list(opt_params or (("learning_rate", 0.1), ("momentum", 0.9)))
        if lr_scheduler is not None:
            opt_params.append(("lr_scheduler", lr_scheduler))
        mod.init_optimizer(kvstore="local", optimizer=optimizer, optimizer_params=opt_params)
        for x, y in batches[:steps]:
            mod.forward_backward(mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)]))
            mod.update()
        args, _ = mod.get_params()
        return mod, {k: v.asnumpy() for k, v in args.items()}


def _close(got, want, rtol=PRTOL, atol=PATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------ which path runs
@pytest.mark.parametrize("mx", [mxnet_tpu, pt], ids=["jax", "torch"])
def test_fused_path_is_active_on_multi_device(mx):
    mod, _ = _fit(mx, _ctxs(mx, 4), _host_batches(1))
    assert mod._spmd is not None, "fused SPMD step should be active"


@pytest.mark.parametrize("mx", [mxnet_tpu, pt], ids=["jax", "torch"])
def test_single_device_stays_legacy(mx):
    mod, _ = _fit(mx, _ctxs(mx, 1), _host_batches(1))
    assert mod._spmd is None


@pytest.mark.parametrize("mx", [mxnet_tpu, pt], ids=["jax", "torch"])
def test_duplicate_contexts_stay_legacy(mx, caplog):
    with caplog.at_level(logging.WARNING):
        mod, _ = _fit(mx, [mx.cpu(0), mx.cpu(0)], _host_batches(1))
    assert mod._spmd is None
    assert "duplicate devices in context list" in caplog.text


def test_fused_step_flag_engages_one_context_and_opt_outs_hold(monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    mod, _ = _fit(pt, _ctxs(pt, 1), _host_batches(1))
    assert mod._spmd is not None and mod._spmd.trainer.mesh.size == 1
    mod, _ = _fit(pt, _ctxs(pt, 4), _host_batches(1), fused=False)
    assert mod._spmd is None
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    mod, _ = _fit(pt, _ctxs(pt, 4), _host_batches(1))
    assert mod._spmd is None


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("optimizer,opt_params", OPTIMIZERS[:3])
def test_params_match_legacy_path(optimizer, opt_params):
    """Same data, same init → fused params over eight contexts == the
    per-device path's over one (the sum over shards is the full-batch
    gradient)."""
    batches = _host_batches(5)
    _, fused = _fit(pt, _ctxs(pt, 8), batches, optimizer, opt_params)
    _, legacy = _fit(pt, _ctxs(pt, 1), batches, optimizer, opt_params)
    _close(fused, legacy)


@pytest.mark.parametrize("optimizer,opt_params", OPTIMIZERS)
def test_params_match_the_jax_fused_step(optimizer, opt_params):
    batches = _host_batches(5)
    jmod, jax_p = _fit(mxnet_tpu, _ctxs(mxnet_tpu, 8), batches, optimizer, opt_params)
    pmod, port_p = _fit(pt, _ctxs(pt, 8), batches, optimizer, opt_params)
    assert jmod._spmd is not None and pmod._spmd is not None
    _close(port_p, jax_p)
    # the optimizer state, key for key
    js = jmod._spmd.trainer.opt_state
    ps = pmod._spmd.trainer.opt_state
    assert set(js) == set(ps)
    assert int(np.asarray(js["t"])) == int(ps["t"]) == len(batches)
    for s in set(js) - {"t"}:
        _close({k: v.numpy() for k, v in ps[s].items()},
               {k: np.asarray(v) for k, v in js[s].items()})


def test_outputs_match_legacy_path_and_jax():
    batches = _host_batches(1)
    outs = {}
    for name, mx, n in (("fused", pt, 4), ("legacy", pt, 1), ("jax", mxnet_tpu, 4)):
        mod, _ = _fit(mx, _ctxs(mx, n), batches)
        outs[name] = mod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(outs["fused"], outs["legacy"], rtol=ORTOL, atol=OATOL)
    np.testing.assert_allclose(outs["fused"], outs["jax"], rtol=ORTOL, atol=OATOL)


def test_lr_scheduler_drives_fused_step():
    """A FactorScheduler must change the learning rate inside the fused
    step: with factor 1e-8 after step 1 the params freeze (atol 1e-6)."""
    batches = _host_batches(4, seed=3)
    sched = pt.lr_scheduler.FactorScheduler(step=1, factor=1e-8)
    mod, _ = _fit(pt, _ctxs(pt, 4), batches[:1], "sgd",
                  (("learning_rate", 0.5), ("momentum", 0.0)), lr_scheduler=sched)
    assert mod._spmd is not None
    after_1 = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    for x, y in batches[1:]:
        mod.forward_backward(pt.io.DataBatch(data=[pt.nd.array(x, ctx=pt.cpu())],
                                             label=[pt.nd.array(y, ctx=pt.cpu())]))
        mod.update()
    after_n, _ = mod.get_params()
    for k, v in after_n.items():
        np.testing.assert_allclose(v.asnumpy(), after_1[k], rtol=0, atol=1e-6)


def test_fit_converges_and_scores():
    """fit() on separable data through the fused path, then score() (which
    must see the fused step's params through forward)."""
    rs = np.random.RandomState(0)
    n, feat = 256, 16
    w = rs.randn(feat, 2).astype("float32")
    x = rs.randn(n, feat).astype("float32")
    y = np.argmax(x @ w, axis=1).astype("float32")
    with pt.cpu():
        it = pt.io.NDArrayIter(x, y, batch_size=32, shuffle=False, label_name="softmax_label")
        mod = pt.mod.Module(_mlp(pt, hidden=32, classes=2), context=_ctxs(pt, 8))
        mod.fit(it, num_epoch=12, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.5), ("momentum", 0.9)),
                initializer=pt.init.Xavier(magnitude=2.0), eval_metric="acc", kvstore="local")
        assert mod._spmd is not None
        it.reset()
        acc = dict(mod.score(it, pt.metric.Accuracy()))["accuracy"]
    assert acc > 0.95, "fused-path fit failed to converge: acc=%.3f" % acc


def _batch(mx, x, y):
    return mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])


@pytest.mark.parametrize("read", ["get_params", "save_checkpoint"])
def test_executors_follow_the_fused_step_after_a_host_read(tmp_path, read):
    """A host read of the fused params (get_params, save_checkpoint) between
    a step and forward/score must not leave the bound executors on older
    weights: forward's outputs and score equal a per-device module's on the
    fused step's params (outputs rtol 1e-4, atol 1e-5)."""
    batches = _host_batches(4)
    x_eval, y_eval = batches[3]
    with pt.cpu():
        mod, _ = _fit(pt, _ctxs(pt, 4), batches, steps=2)  # ends on get_params
        mod.forward_backward(_batch(pt, *batches[2]))
        mod.update()
        if read == "get_params":
            mod.get_params()
        else:
            mod.save_checkpoint(str(tmp_path / "ck"), 1, save_optimizer_states=True)
        mod.forward(_batch(pt, x_eval, y_eval), is_train=False)
        got = mod.get_outputs()[0].asnumpy()
        it = pt.io.NDArrayIter(x_eval, y_eval, batch_size=len(x_eval),
                               label_name="softmax_label")
        got_score = dict(mod.score(it, pt.metric.CrossEntropy()))["cross-entropy"]
        args, _ = mod.get_params()
        ref = pt.mod.Module(_mlp(pt), context=[pt.cpu(0)])
        ref.bind(data_shapes=[("data", x_eval.shape)],
                 label_shapes=[("softmax_label", y_eval.shape)], for_training=False)
        ref.init_params(arg_params={k: v.copy() for k, v in args.items()})
        ref.forward(_batch(pt, x_eval, y_eval), is_train=False)
        want = ref.get_outputs()[0].asnumpy()
        it.reset()
        want_score = dict(ref.score(it, pt.metric.CrossEntropy()))["cross-entropy"]
    assert ref._spmd is None
    init = _params()
    assert any(np.abs(args[k].asnumpy() - init[k]).max() > 1e-3 for k in init)
    np.testing.assert_allclose(got, want, rtol=ORTOL, atol=OATOL)
    np.testing.assert_allclose(got_score, want_score, rtol=ORTOL, atol=OATOL)


def test_update_without_forward_backward_raises():
    mod, _ = _fit(pt, _ctxs(pt, 2), _host_batches(1))
    x, y = _host_batches(1)[0]
    with pt.cpu():
        mod.forward(pt.io.DataBatch(data=[pt.nd.array(x)], label=[pt.nd.array(y)]),
                    is_train=True)
        mod.backward()
        with pytest.raises(pt.MXNetError, match="update\\(\\) without forward_backward"):
            mod.update()


@pytest.mark.parametrize("var,value", [("MXNET_AUTOPLAN", "1"), ("MXNET_GRAPHLINT", "warn")])
def test_planner_and_graphlint_raise_naming_step_4(monkeypatch, var, value):
    """Neither raises any more (ROADMAP.md section 1.4b step 4 landed): under
    ``MXNET_AUTOPLAN=1`` the fused fit takes the planner's mesh, under
    ``MXNET_GRAPHLINT=warn`` its bind lints the real mesh, and either trains
    the same weights as the fit without the variable."""
    batches = _host_batches(1)
    _, want = _fit(pt, _ctxs(pt, 2), batches)
    monkeypatch.setenv(var, value)
    mod, got = _fit(pt, _ctxs(pt, 2), batches)
    assert mod._spmd is not None
    if var == "MXNET_AUTOPLAN":
        assert dict(mod._spmd.trainer.mesh.shape) == {"data": 2, "model": 1}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bf16_compute_raises_naming_section_2b():
    mesh = pt.parallel.make_mesh((1,), ("data",), [pt.cpu()])
    with pytest.raises(pt.MXNetError, match="TF32/bf16"):
        pt.parallel.SPMDTrainer(_mlp(pt), mesh, compute_dtype="bfloat16")


# -------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_with_spmd_states(tmp_path):
    batches = _host_batches(2)
    mod, params = _fit(pt, _ctxs(pt, 4), batches)
    prefix = str(tmp_path / "spmd")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    with pt.cpu():
        loaded = pt.mod.Module.load(prefix, 1, load_optimizer_states=True, context=_ctxs(pt, 4))
        loaded.bind(data_shapes=[("data", batches[0][0].shape)],
                    label_shapes=[("softmax_label", batches[0][1].shape)])
        loaded.init_params()
        loaded.init_optimizer(optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.1), ("momentum", 0.9)))
    args, _ = loaded.get_params()
    for k, v in args.items():
        np.testing.assert_allclose(v.asnumpy(), params[k], rtol=1e-6)
    # the momentum state survived the round trip into the fused step, in
    # the trainer's own tensors
    assert loaded._spmd is not None
    mom = loaded._spmd.trainer.opt_state["mom"]
    want = mod._spmd.trainer.opt_state["mom"]
    for k in want:
        np.testing.assert_array_equal(mom[k].numpy(), want[k].numpy())
    assert int(loaded._spmd.trainer.opt_state["t"]) == 2


@pytest.mark.parametrize("src", ["jax", "torch"])
@pytest.mark.parametrize("optimizer,opt_params", [OPTIMIZERS[0], OPTIMIZERS[2]])
def test_states_file_crosses_packages(tmp_path, src, optimizer, opt_params):
    """A ``.states`` file written by one package's fused step loads into the
    other's; both then take the same next step (params rtol 2e-4, atol
    2e-5)."""
    batches = _host_batches(3)
    pkgs = {"jax": mxnet_tpu, "torch": pt}
    a, b = pkgs[src], pkgs["torch" if src == "jax" else "jax"]
    mod_a, params_a = _fit(a, _ctxs(a, 4), batches[:2], optimizer, opt_params)
    fname = str(tmp_path / "fused.states")
    mod_a.save_optimizer_states(fname)
    if a is mxnet_tpu:
        state = pickle.load(open(fname, "rb"))
        assert set(state) == ({"t", "mom"} if optimizer == "sgd" else {"t", "m", "v"})
    mod_b, _ = _fit(b, _ctxs(b, 4), batches, optimizer, opt_params, params=params_a, steps=0)
    mod_b.load_optimizer_states(fname)
    for mod, mx in ((mod_a, a), (mod_b, b)):
        x, y = batches[2]
        with _on(mx):
            mod.forward_backward(mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)]))
            mod.update()
    # the loaded state (momentum, Adam's moments and counter) drove mod_b's
    # step from params_a as mod_a's own state drove its step
    _close({k: v.asnumpy() for k, v in mod_b.get_params()[0].items()},
           {k: v.asnumpy() for k, v in mod_a.get_params()[0].items()})


def test_a_jax_trainers_opt_state_carries_into_the_port_and_back():
    """``convert.opt_state_from_numpy`` takes a JAX ``SPMDTrainer``'s state
    (after ``jax.device_get``) into the port's trainer, which then takes the
    JAX trainer's next step (rtol 2e-4, atol 2e-5); ``opt_state_to_numpy``
    gives the JAX layout back."""
    import jax

    from mxnet_tpu_torch.convert import opt_state_from_numpy, opt_state_to_numpy

    (x, y), = _host_batches(1)
    jt = mxnet_tpu.parallel.SPMDTrainer(
        _mlp(mxnet_tpu), mxnet_tpu.parallel.make_mesh((2,), ("data",), jax.devices()[:2]),
        optimizer="adam", optimizer_params={"learning_rate": 0.01})
    jt.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=2)
    jt.step({"data": x}, {"softmax_label": y})
    state = jax.device_get(jt.opt_state)
    params, _ = jt.get_params()
    pt_tr = pt.parallel.SPMDTrainer(
        _mlp(pt), pt.parallel.make_mesh((2,), ("data",), [pt.cpu(0), pt.cpu(1)]),
        optimizer="adam", optimizer_params={"learning_rate": 0.01})
    pt_tr.init_params({"data": x.shape}, {"softmax_label": y.shape})
    pt_tr.set_params(params)
    pt_tr.opt_state = opt_state_from_numpy(state, pt.cpu())
    for tr in (jt, pt_tr):
        tr.step({"data": x}, {"softmax_label": y})
    _close(pt_tr.get_params()[0], jt.get_params()[0])
    back = opt_state_to_numpy(pt_tr.opt_state)
    want = jax.device_get(jt.opt_state)
    assert set(back) == set(want) == {"t", "m", "v"}
    assert back["t"].dtype == np.int32 and int(back["t"]) == int(want["t"]) == 2
    for s in ("m", "v"):
        _close(back[s], {k: np.asarray(v) for k, v in want[s].items()})
