"""The Module.fit trunk of the port held against the JAX package's.

Every case of the reference's own ``tests/test_module.py`` runs here on BOTH
packages (fixture ``mx``, the port inside ``with cpu():``), but the three
that need ``kvstore.py`` or several contexts, which run in
``tests/test_torch_kvstore.py``; elastic fit runs (``ElasticFit``, held
against the JAX package in ``tests/test_torch_checkpoint.py``) and the
fused step's planner raises, naming ROADMAP.md section 1.4b step 4
(checked below). Then parity: the MNIST ``mlp`` and ``lenet`` at their published
widths trained through ``Module.fit`` from the same numpy parameters on
the same shuffled batches in both packages (SGD with momentum and wd, a
FactorScheduler, an lr multiplier through ``set_lr_mult`` and one through a
``__lr_mult__`` attribute the optimizer reads from the symbol) give the
same outputs, metric values and parameters within rtol 1e-4, atol 1e-5;
one case runs JAX under its Pallas lowering of kernel 6
(``matmul_bias_act``, interpret mode). BucketingModule, SequentialModule
and PythonLossModule against JAX, and a JAX checkpoint resumed in the port.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


# ------------------------------------------- tests/test_module.py, both packages
def _synthetic_classification(n=600, n_features=20, n_classes=5, seed=7):
    """Linearly separable-ish clusters an MLP must fit to ~100%."""
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-3, 3, (n_classes, n_features)).astype("f")
    y = rs.randint(0, n_classes, n)
    x = centers[y] + rs.normal(0, 0.3, (n, n_features)).astype("f")
    return x.astype("f"), y.astype("f")


def mlp_symbol(mx, num_classes=5):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=64, name="fc1")
    net = mx.sym.Activation(data=net, act_type="relu")
    net = mx.sym.FullyConnected(data=net, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(data=net, name="softmax")


def test_module_fit_mlp_converges(mx):
    x, y = _synthetic_classification()
    train = mx.io.NDArrayIter(x[:500], y[:500], batch_size=50, shuffle=True)
    val = mx.io.NDArrayIter(x[500:], y[500:], batch_size=50)
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)), num_epoch=6)
    score = mod.score(val, "acc")
    assert score[0][1] > 0.95, "accuracy %f too low" % score[0][1]


def test_module_fit_conv_converges(mx):
    """Small conv net on image-shaped synthetic data (train/test_conv.py gate)."""
    rs = np.random.RandomState(0)
    n, classes = 400, 4
    y = rs.randint(0, classes, n)
    x = np.zeros((n, 1, 8, 8), dtype="f")
    for i, yi in enumerate(y):
        r, c = divmod(int(yi), 2)
        x[i, 0, r * 4: r * 4 + 4, c * 4: c * 4 + 4] = 1.0
    x += rs.normal(0, 0.2, x.shape).astype("f")

    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data=data, kernel=(3, 3), num_filter=8, name="c1")
    net = mx.sym.Activation(data=net, act_type="relu")
    net = mx.sym.Pooling(data=net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.Flatten(data=net)
    net = mx.sym.FullyConnected(data=net, num_hidden=classes, name="fc")
    net = mx.sym.SoftmaxOutput(data=net, name="softmax")

    train = mx.io.NDArrayIter(x, y.astype("f"), batch_size=40, shuffle=True)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(train, optimizer="sgd", optimizer_params=(("learning_rate", 0.2),), num_epoch=5)
    score = mod.score(mx.io.NDArrayIter(x, y.astype("f"), batch_size=40), "acc")
    assert score[0][1] > 0.95


def test_module_adam_converges(mx):
    x, y = _synthetic_classification(n=300)
    train = mx.io.NDArrayIter(x, y, batch_size=30, shuffle=True)
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
    mod.fit(train, optimizer="adam", optimizer_params=(("learning_rate", 0.01),), num_epoch=5)
    score = mod.score(mx.io.NDArrayIter(x, y, batch_size=30), "acc")
    assert score[0][1] > 0.95


def test_module_get_set_params_roundtrip(mx):
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", (10, 20))], label_shapes=[("softmax_label", (10,))])
    mod.init_params(initializer=mx.init.Xavier())
    args, auxs = mod.get_params()
    assert set(args.keys()) == {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"}
    mod2 = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
    mod2.bind(data_shapes=[("data", (10, 20))], label_shapes=[("softmax_label", (10,))])
    mod2.init_params(arg_params=args, aux_params=auxs)
    a2, _ = mod2.get_params()
    for k in args:
        assert np.allclose(args[k].asnumpy(), a2[k].asnumpy())


def test_module_predict(mx):
    x, y = _synthetic_classification(n=100)
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
    it = mx.io.NDArrayIter(x, y, batch_size=25)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label, for_training=False)
    mod.init_params()
    out = mod.predict(it)
    assert out.shape == (100, 5)
    assert np.allclose(out.asnumpy().sum(axis=1), 1.0, atol=1e-5)


def test_module_predict_unlabeled_after_fit(mx):
    x, y = _synthetic_classification(n=100)
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=25), num_epoch=1)
    out = mod.predict(mx.io.NDArrayIter(x, batch_size=25))
    assert out.shape == (100, 5)
    assert np.allclose(out.asnumpy().sum(axis=1), 1.0, atol=1e-5)


def test_module_save_load_checkpoint(mx, tmp_path):
    x, y = _synthetic_classification(n=100)
    prefix = str(tmp_path / "mlp")
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
    it = mx.io.NDArrayIter(x, y, batch_size=20)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    mod.save_checkpoint(prefix, 3)
    mod2 = mx.mod.Module.load(prefix, 3, context=mx.cpu())
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    a1, _ = mod.get_params()
    a2, _ = mod2.get_params()
    for k in a1:
        assert np.allclose(a1[k].asnumpy(), a2[k].asnumpy())


def test_ndarray_iter_pad_and_shuffle(mx):
    x = np.arange(50, dtype="f").reshape(10, 5)
    y = np.arange(10, dtype="f")
    it = mx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle="pad")
    batches = list(it)
    assert len(batches) == 3
    assert batches[-1].pad == 2
    it.reset()
    total = sum(b.data[0].shape[0] for b in it)
    assert total == 12


def test_optimizer_lr_scheduler(mx):
    sched = mx.lr_scheduler.FactorScheduler(step=10, factor=0.5)
    opt = mx.optimizer.SGD(learning_rate=1.0, lr_scheduler=sched)
    w = mx.nd.ones((2,))
    g = mx.nd.ones((2,))
    for _ in range(25):
        opt.update(0, w, g, None)
    assert sched.base_lr < 1.0


def test_optimizer_wd_mult_skips_bias(mx):
    opt = mx.optimizer.SGD(learning_rate=0.1, wd=0.5,
                           param_idx2name={0: "fc_weight", 1: "fc_bias"})
    w = mx.nd.ones((2,))
    b = mx.nd.ones((2,))
    zero_grad = mx.nd.zeros((2,))
    opt.update(0, w, zero_grad, None)
    opt.update(1, b, zero_grad, None)
    assert np.allclose(w.asnumpy(), 1.0 - 0.1 * 0.5)  # decayed
    assert np.allclose(b.asnumpy(), 1.0)  # bias: wd_mult 0


def test_initializers(mx):
    for init, check in [
        (mx.init.Zero(), lambda a: np.allclose(a, 0)),
        (mx.init.One(), lambda a: np.allclose(a, 1)),
        (mx.init.Constant(3.5), lambda a: np.allclose(a, 3.5)),
        (mx.init.Uniform(0.1), lambda a: np.abs(a).max() <= 0.1),
        (mx.init.Normal(0.01), lambda a: np.abs(a).mean() < 0.05),
        (mx.init.Xavier(), lambda a: np.isfinite(a).all()),
        (mx.init.MSRAPrelu(), lambda a: np.isfinite(a).all()),
    ]:
        arr = mx.nd.zeros((20, 30))
        init("test_weight", arr)
        assert check(arr.asnumpy()), type(init).__name__
    arr = mx.nd.zeros((10, 30))
    mx.init.Orthogonal(scale=1.0)("q_weight", arr)
    a = arr.asnumpy()
    assert np.allclose(a @ a.T, np.eye(10), atol=1e-4)
    arr = mx.nd.full((5,), 9.0)
    mx.init.Xavier()("fc1_bias", arr)
    assert np.allclose(arr.asnumpy(), 0.0)


def test_regression_metrics_rank1_pred(mx):
    rs = np.random.RandomState(0)
    y = rs.randn(32).astype("float32")
    p = rs.randn(32).astype("float32")
    for cls, ref in ((mx.metric.MAE, np.abs(y - p).mean()),
                     (mx.metric.MSE, ((y - p) ** 2).mean()),
                     (mx.metric.RMSE, np.sqrt(((y - p) ** 2).mean()))):
        m = cls()
        m.update([mx.nd.array(y)], [mx.nd.array(p)])
        assert abs(m.get()[1] - ref) < 1e-5, (cls.__name__, m.get()[1], ref)
        m2 = cls()
        m2.update([mx.nd.array(y)], [mx.nd.array(p.reshape(-1, 1))])
        assert abs(m2.get()[1] - m.get()[1]) < 1e-7


def test_metrics(mx):
    acc = mx.metric.create("acc")
    acc.update([mx.nd.array([0, 1, 1])], [mx.nd.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]])])
    assert abs(acc.get()[1] - 2.0 / 3) < 1e-6
    mse = mx.metric.MSE()
    mse.update([mx.nd.array([1.0, 2.0])], [mx.nd.array([[1.5], [2.5]])])
    assert abs(mse.get()[1] - 0.25) < 1e-6
    topk = mx.metric.TopKAccuracy(top_k=2)
    topk.update([mx.nd.array([2, 0])], [mx.nd.array([[0.1, 0.5, 0.4], [0.35, 0.4, 0.25]])])
    assert abs(topk.get()[1] - 1.0) < 1e-6


# ------------------------------------------------------------- waits for 1.4b
def test_elastic_fit_and_the_fused_step_raise_naming_section_1_4b(monkeypatch):
    """What still raises of data parallelism. Elastic fit no longer does
    (ROADMAP.md section 1.4b step 3 landed): it returns its ``ElasticFit``
    controller, and refuses ``monitor=`` as the JAX package does. The
    fused step does not either: under ``MXNET_MODULE_FUSED_STEP=1`` one
    context engages it (``tests/test_torch_spmd.py`` holds it against the
    JAX package's); its planner raises, naming section 1.4b step 4."""
    net = mlp_symbol(pt)
    mod = pt.mod.Module(net, context=pt.cpu())
    mod.bind(data_shapes=[("data", (10, 20))], label_shapes=[("softmax_label", (10,))])
    mod.init_params()
    with pt.cpu():
        train = pt.io.NDArrayIter(np.zeros((10, 20), "f"), np.zeros(10, "f"), batch_size=10)
    monkeypatch.delenv("MXNET_CHECKPOINT_DIR", raising=False)
    fit_mod = pt.mod.Module(net, context=pt.cpu())
    ctl = fit_mod.fit(train, num_epoch=1, elastic=True)
    assert isinstance(ctl, pt.mod.ElasticFit) and ctl._round == 1 and not ctl.evicted
    with pytest.raises(pt.MXNetError, match="monitor="):
        fit_mod.fit(train, num_epoch=1, elastic={}, monitor=pt.monitor.Monitor(1))
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    monkeypatch.setenv("MXNET_AUTOPLAN", "1")
    with pytest.raises(pt.MXNetError, match="section 1.4b step 4"):
        mod.init_optimizer()
    monkeypatch.delenv("MXNET_AUTOPLAN")
    mod.init_optimizer(force_init=True)
    assert mod._spmd is not None and mod._updater is None
    monkeypatch.delenv("MXNET_MODULE_FUSED_STEP")
    mod.init_optimizer(kvstore="local", force_init=True)  # one device: the updater
    assert mod._spmd is None
    assert mod._kvstore is None and mod._updater is not None


def test_module_defaults_to_the_gpu(monkeypatch):
    # the default no variable names (tests/conftest.py sets one for JAX)
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = pt.mod.Module(mlp_symbol(pt))
    assert mod._context == [pt.gpu(0)]
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        mod.bind(data_shapes=[("data", (10, 20))], label_shapes=[("softmax_label", (10,))])


# ------------------------------------------------------------------ parity
PKGS = {"jax": mxnet_tpu, "torch": pt}


def _mnist_like(n, seed, flat):
    """Images in [0, 1) and digit labels, as MNISTIter gives them."""
    rs = np.random.RandomState(seed)
    templates = np.random.RandomState(12345).rand(10, 28, 28) > 0.7
    y = rs.randint(0, 10, n)
    x = np.clip(templates[y] * 1.0 + rs.normal(0, 0.12, (n, 28, 28)), 0, 1).astype("f")
    return (x.reshape(n, 784) if flat else x.reshape(n, 1, 28, 28)), y.astype("f")


def _net(mx, name, attr_mult):
    """The zoo's symbol; with ``attr_mult`` the same graph with a
    ``__lr_mult__`` attribute on fc2's weight."""
    if not attr_mult:
        return getattr(mx.models, name).get_symbol(num_classes=10)
    with mx.name.NameManager():
        S = mx.sym
        data = S.Variable("data")
        w2 = S.Variable("fc2_weight", lr_mult=2.0)
        if name == "mlp":
            net = S.Activation(S.FullyConnected(S.Flatten(data), name="fc1", num_hidden=128),
                               act_type="relu", name="relu1")
            net = S.Activation(S.FullyConnected(net, name="fc2", num_hidden=64, weight=w2),
                               act_type="relu", name="relu2")
            net = S.FullyConnected(net, name="fc3", num_hidden=10)
        else:
            net = S.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
            net = S.Pooling(S.Activation(net, act_type="tanh"), pool_type="max",
                            kernel=(2, 2), stride=(2, 2))
            net = S.Convolution(net, kernel=(5, 5), num_filter=50, name="conv2")
            net = S.Pooling(S.Activation(net, act_type="tanh"), pool_type="max",
                            kernel=(2, 2), stride=(2, 2))
            net = S.Activation(S.FullyConnected(S.Flatten(net), num_hidden=500, name="fc1"),
                               act_type="tanh")
            net = S.FullyConnected(net, num_hidden=10, name="fc2", weight=w2)
        return S.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_mnist_nets_symbol_json_is_the_references(name):
    for kw in ({}, {"num_classes": 7}):
        with mxnet_tpu.name.NameManager():
            want = getattr(mxnet_tpu.models, name).get_symbol(**kw).tojson()
        with pt.name.NameManager():
            got = getattr(pt.models, name).get_symbol(**kw).tojson()
        assert got == want


def _init_params(net, batch, shape):
    arg_shapes, _, _ = net.infer_shape(data=(batch,) + shape, softmax_label=(batch,))
    rs = np.random.RandomState(5)
    return {n: (rs.standard_normal(s) * math.sqrt(1.0 / max(1, np.prod(s[1:])))).astype("f")
            if n.endswith("weight") else (rs.standard_normal(s) * 0.01).astype("f")
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _fit_parity(name, pkg, attr_mult, steps=5, batch=20):
    """Train ``name`` for ``steps`` batches in ``pkg``; returns (per-batch
    outputs, per-batch metric values, final params, the module)."""
    mx = PKGS[pkg]
    flat = False
    x, y = _mnist_like(batch * steps, seed=3, flat=flat)
    net = _net(mx, name, attr_mult)
    params = _init_params(net, batch, x.shape[1:])
    ctx = mx.cpu()
    with (ctx if pkg == "torch" else contextlib.nullcontext()):
        np.random.seed(21)
        train = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=True)
        mod = mx.mod.Module(net, context=ctx)
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = mx.optimizer.create("sgd", learning_rate=0.05, momentum=0.9, wd=1e-3,
                                  rescale_grad=1.0 / batch, lr_scheduler=sched, sym=net,
                                  param_idx2name=dict(enumerate(
                                      [n for n in net.list_arguments()
                                       if n not in ("data", "softmax_label")])))
        opt.set_lr_mult({"fc1_weight": 0.5})
        outs, metrics = [], []

        def record(param):
            outs.append(mod.get_outputs()[0].asnumpy())
            metrics.append(param.eval_metric.get_name_value())

        mod.fit(train, eval_metric=["acc", "ce"], optimizer=opt,
                arg_params={k: mx.nd.array(v) for k, v in params.items()},
                batch_end_callback=record, num_epoch=1)
        args, _ = mod.get_params()
        return outs, metrics, {k: v.asnumpy() for k, v in args.items()}, mod


def _assert_parity(got, want):
    worst = 0.0
    for o, w in zip(got[0], want[0]):
        np.testing.assert_allclose(o, w, rtol=RTOL, atol=ATOL)
        worst = max(worst, float(np.abs(o - w).max()))
    assert len(got[0]) == len(want[0]) == 5
    for m, w in zip(got[1], want[1]):
        assert [k for k, _ in m] == [k for k, _ in w]
        np.testing.assert_allclose([v for _, v in m], [v for _, v in w], rtol=RTOL, atol=ATOL)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=RTOL, atol=ATOL, err_msg=k)
        worst = max(worst, float(np.abs(got[2][k] - want[2][k]).max()))
    return worst


@pytest.mark.parametrize("attr_mult", [False, True], ids=["set_lr_mult", "attr_lr_mult"])
@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_mnist_nets_train_as_in_jax(name, attr_mult):
    want = _fit_parity(name, "jax", attr_mult)
    got = _fit_parity(name, "torch", attr_mult)
    worst = _assert_parity(got, want)
    print("%s parity (%s): largest abs difference %.3g" % (name, attr_mult, worst))
    assert got[3]._optimizer.lr_mult.get("fc2_weight") == (2.0 if attr_mult else None)


def test_mlp_trains_as_jax_under_its_pallas_kernel(monkeypatch):
    """JAX forced onto its Pallas lowering of matmul_bias_act (interpret
    mode on the CPU): the port's module holding kernel 6 against the Pallas
    kernel itself. The Pallas kernel tiles rows by 8 and columns by 128
    (``pallas_matmul_bias_act.supported``), so the batch is 24 and fc1
    (N = 128) engages it; fc2 (N = 64) runs unfused in JAX."""
    monkeypatch.setenv("MXNET_GRAPHREWRITE", "on")
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "matmul_bias_act=pallas")
    from mxnet_tpu import telemetry as jtm

    saved = jtm.current_override()
    jtm.set_mode("counters")
    jtm.reset()
    try:
        want = _fit_parity("mlp", "jax", False, batch=24)
        engaged = jtm.counters().get("fusion.pattern_engaged.matmul_bias_act", 0)
    finally:
        jtm.set_mode(saved)
    assert engaged > 0
    got = _fit_parity("mlp", "torch", False, batch=24)
    print("mlp parity under the Pallas kernel: largest abs difference %.3g"
          % _assert_parity(got, want))


# ------------------------------------------------- bucketing, sequential, loss
def _bucket_sym(mx, key):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(data=net, act_type="tanh")
    net = mx.sym.FullyConnected(data=net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(data=net, name="softmax"), ("data",), ("softmax_label",)


def _bucketing_run(mx):
    rs = np.random.RandomState(1)
    params = {"fc1_weight": rs.randn(8, 6).astype("f") * 0.3, "fc1_bias": np.zeros(8, "f"),
              "fc2_weight": rs.randn(3, 8).astype("f") * 0.3, "fc2_bias": np.zeros(3, "f")}
    mod = mx.mod.BucketingModule(lambda k: _bucket_sym(mx, k), default_bucket_key=4,
                                 context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 6))], label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=(("learning_rate", 0.2),
                                                          ("momentum", 0.9)))
    outs = []
    for i, b in enumerate((4, 2, 4, 3)):
        x = rs.randn(b, 6).astype("f")
        y = rs.randint(0, 3, b).astype("f")
        batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)], pad=0,
                                bucket_key=b, provide_data=[("data", (b, 6))],
                                provide_label=[("softmax_label", (b,))])
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    args, _ = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in args.items()}, sorted(mod._buckets)


def test_bucketing_module_matches_jax_and_shares_parameters():
    """Buckets bound with shared_module share the default bucket's
    parameters: four steps over three bucket sizes give JAX's outputs and
    parameters."""
    with pt.cpu():
        got = _bucketing_run(pt)
    want = _bucketing_run(mxnet_tpu)
    assert got[2] == want[2] == [2, 3, 4]
    for o, w in zip(got[0], want[0]):
        np.testing.assert_allclose(o, w, rtol=RTOL, atol=ATOL)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=RTOL, atol=ATOL)


def _sequential_data():
    rs = np.random.RandomState(2)
    x = rs.randn(12, 5).astype("f")
    y = rs.randint(0, 4, 12).astype("f")
    params = {"h_weight": rs.randn(6, 5).astype("f") * 0.4, "h_bias": np.zeros(6, "f"),
              "o_weight": rs.randn(4, 6).astype("f") * 0.4, "o_bias": np.zeros(4, "f")}
    return x, y, params


def _two_nets(mx):
    S = mx.sym
    net1 = S.Activation(S.FullyConnected(S.Variable("data"), num_hidden=6, name="h"),
                        act_type="relu")
    net2 = S.SoftmaxOutput(S.FullyConnected(S.Variable("data"), num_hidden=4, name="o"),
                           name="softmax")
    return net1, net2


def _steps(mod, mx, x, y, epochs=2):
    outs = []
    for _ in range(epochs):
        for batch in mx.io.NDArrayIter(x, y, batch_size=4):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
    return outs


def _softmax_grad(scores, labels):
    s, lab = scores.asnumpy(), labels.asnumpy().astype(int)
    g = s.copy()
    g[np.arange(len(lab)), lab] -= 1.0
    return g


def test_sequential_and_python_loss_modules_match_jax():
    """The port's SequentialModule of two Modules (the second takes the
    labels, auto-wired) against the same chain run by hand in JAX: its
    Modules forward, backward (the second's input gradient into the
    first) and update in turn. JAX's own SequentialModule cannot bind such
    a chain: its ``Module.output_shapes`` is empty before the first
    forward (``mxnet_tpu/module/module.py:100``), where the port's infers
    the shapes. Then a PythonLossModule on the outputs in both."""
    x, y, params = _sequential_data()
    opt_params = (("learning_rate", 0.3), ("momentum", 0.9))
    with pt.cpu():
        n1, n2 = _two_nets(pt)
        seq = pt.mod.SequentialModule()
        seq.add(pt.mod.Module(n1, label_names=None, context=pt.cpu()))
        seq.add(pt.mod.Module(n2, context=pt.cpu()), take_labels=True, auto_wiring=True)
        seq.bind(data_shapes=[("data", (4, 5))], label_shapes=[("softmax_label", (4,))])
        seq.init_params(arg_params={k: pt.nd.array(v) for k, v in params.items()})
        seq.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
        got_outs = _steps(seq, pt, x, y)
        got = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}

    mx = mxnet_tpu
    n1, n2 = _two_nets(mx)
    m1 = mx.mod.Module(n1, label_names=None, context=mx.cpu())
    m1.bind(data_shapes=[("data", (4, 5))], for_training=True)
    m2 = mx.mod.Module(n2, context=mx.cpu())
    m2.bind(data_shapes=[("data", (4, 6))], label_shapes=[("softmax_label", (4,))],
            inputs_need_grad=True)
    for m in (m1, m2):
        m.init_params(arg_params={k: mx.nd.array(v) for k, v in params.items()},
                      allow_missing=True)
        m.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
    want_outs = []
    for _ in range(2):
        for batch in mx.io.NDArrayIter(x, y, batch_size=4):
            m1.forward(batch, is_train=True)
            m2.forward(mx.io.DataBatch(data=m1.get_outputs(), label=batch.label),
                       is_train=True)
            m2.backward()
            m1.backward(m2.get_input_grads())
            m1.update()
            m2.update()
            want_outs.append(m2.get_outputs()[0].asnumpy())
    want = dict(m1.get_params()[0], **m2.get_params()[0])
    assert set(got) == set(want) == set(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].asnumpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    assert len(got_outs) == len(want_outs) == 6
    for g, w in zip(got_outs, want_outs):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)

    losses = []
    for pkg in (pt, mx):
        with (pt.cpu() if pkg is pt else contextlib.nullcontext()):
            loss = pkg.mod.PythonLossModule(grad_func=_softmax_grad)
            loss.bind(data_shapes=[("data", (4, 4))], label_shapes=[("softmax_label", (4,))])
            loss.forward(pkg.io.DataBatch(data=[pkg.nd.array(want_outs[-1])],
                                          label=[pkg.nd.array(y[:4])]))
            loss.backward()
            losses.append((loss.get_outputs()[0].asnumpy(),
                           loss.get_input_grads()[0].asnumpy()))
    for g, w in zip(*losses):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# ----------------------------------------------- a JAX checkpoint, resumed
def _jax_states_as_numpy(updater):
    def one(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(one(x) for x in v)
        return v.asnumpy()

    return {k: one(v) for k, v in updater.states.items()}


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains 3 steps of mlp and saves a checkpoint with its optimizer
    states; ``Module.load`` of its files in the port plus
    ``updater_states_from_numpy`` of its states take the next 5 steps as
    JAX takes them."""
    x, y = _mnist_like(160, seed=4, flat=False)
    prefix = str(tmp_path / "mlp")
    opt_params = (("learning_rate", 0.05), ("momentum", 0.9), ("wd", 1e-3))
    net = mxnet_tpu.models.mlp.get_symbol(num_classes=10)
    mod = mxnet_tpu.mod.Module(net, context=mxnet_tpu.cpu())
    it = mxnet_tpu.io.NDArrayIter(x[:60], y[:60], batch_size=20)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: mxnet_tpu.nd.array(v)
                                for k, v in _init_params(net, 20, (1, 28, 28)).items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
    for batch in it:
        mod.forward_backward(batch)
        mod.update()
    mod.save_checkpoint(prefix, 3)
    states = _jax_states_as_numpy(mod._updater)
    finals = []
    for pkg in (mxnet_tpu, pt):
        with (pt.cpu() if pkg is pt else contextlib.nullcontext()):
            m = pkg.mod.Module.load(prefix, 3, context=pkg.cpu())
            rest = pkg.io.NDArrayIter(x[60:], y[60:], batch_size=20)
            m.bind(data_shapes=rest.provide_data, label_shapes=rest.provide_label)
            m.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
            m._updater.states = (pt.updater_states_from_numpy(states, pt.cpu())
                                 if pkg is pt else dict(mod._updater.states))
            outs = []
            for batch in rest:
                m.forward_backward(batch)
                m.update()
                outs.append(m.get_outputs()[0].asnumpy())
            args, _ = m.get_params()
            finals.append((outs, {k: v.asnumpy() for k, v in args.items()}))
    (want_o, want_p), (got_o, got_p) = finals
    assert len(got_o) == len(want_o) == 5
    for o, w in zip(got_o, want_o):
        np.testing.assert_allclose(o, w, rtol=RTOL, atol=ATOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=RTOL, atol=ATOL, err_msg=k)
