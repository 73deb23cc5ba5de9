"""Training support of the port against the JAX package's: initializers,
metrics, callbacks, the monitor and the samplers on the CPU generator.

The deterministic initializers give the same bits as JAX's; the random ones
(their draws are the port's own) are held to the same bounds and moments
at the same shapes and scales. Every metric gives JAX's value within 1e-6
on the same labels and predictions. ``do_checkpoint`` and
``module_checkpoint`` write files byte-identical to JAX's on ``cpu()``;
``Speedometer`` and ``log_train_metric`` log the same lines; ``Monitor``
collects the same statistics of the same executor outputs.
"""
import contextlib
import logging
import math
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

SHAPE = (64, 32, 3, 3)  # fan_in 288, fan_out 576


def _init(pkg, init, name, shape=SHAPE, fill=0.0):
    if pkg is pt:
        with pt.cpu():
            arr = pt.nd.full(shape, fill)
            init(name if isinstance(name, str) else name(pt), arr)
            return arr.asnumpy()
    arr = mx.nd.full(shape, fill)
    init(name if isinstance(name, str) else name(mx), arr)
    return arr.asnumpy()


DETERMINISTIC = [
    ("zero", lambda p: p.init.Zero(), "conv_weight"),
    ("one", lambda p: p.init.One(), "conv_weight"),
    ("constant", lambda p: p.init.Constant(0.375), "conv_weight"),
    ("bilinear", lambda p: p.init.Bilinear(), "up_weight"),
    ("upsampling_name", lambda p: p.init.Xavier(), "x_upsampling"),
    ("lstm_bias", lambda p: p.init.LSTMBias(forget_bias=2.0), "lstm_bias"),
    ("bias", lambda p: p.init.Xavier(), "fc_bias"),
    ("gamma", lambda p: p.init.Uniform(), "bn_gamma"),
    ("beta", lambda p: p.init.Normal(), "bn_beta"),
    ("moving_mean", lambda p: p.init.Xavier(), "bn_moving_mean"),
    ("moving_var", lambda p: p.init.Xavier(), "bn_moving_var"),
    ("label", lambda p: p.init.Xavier(), "softmax_label"),
    ("load", lambda p: p.init.Load({"arg:w_weight": np.arange(np.prod(SHAPE), dtype="f")
                                    .reshape(SHAPE)}), "w_weight"),
    ("mixed", lambda p: p.init.Mixed([".*bias", ".*"], [p.init.One(), p.init.Constant(2.0)]),
     "z_weight"),
    ("init_attr", lambda p: p.init.Uniform(),
     lambda p: p.init.InitDesc("w_weight", {"__init__": p.init.Constant(-1.5).dumps()})),
]


@pytest.mark.parametrize("case", DETERMINISTIC, ids=[c[0] for c in DETERMINISTIC])
def test_deterministic_initializers_match_jax_bitwise(case):
    _, make, name = case
    shape = (8, 1, 4, 4) if case[0] in ("bilinear", "upsampling_name") else \
        (16,) if case[0] == "lstm_bias" else SHAPE
    got = _init(pt, make(pt), name, shape, fill=9.0)
    want = _init(mx, make(mx), name, shape, fill=9.0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _moments_ok(x, mean, std):
    n = x.size
    return (abs(x.mean() - mean) < 5 * std / math.sqrt(n)
            and abs(x.std() - std) < 5 * std / math.sqrt(2 * n))


# (id, initializer maker, its bound or None, its standard deviation)
RANDOM = [
    ("uniform", lambda p: p.init.Uniform(0.2), 0.2, 0.2 / math.sqrt(3)),
    ("normal", lambda p: p.init.Normal(0.05), None, 0.05),
    ("xavier_avg", lambda p: p.init.Xavier(), math.sqrt(3 / 432.0), math.sqrt(1 / 432.0)),
    ("xavier_in_gauss", lambda p: p.init.Xavier(rnd_type="gaussian", factor_type="in",
                                                magnitude=2), None, math.sqrt(2 / 288.0)),
    ("xavier_out", lambda p: p.init.Xavier(factor_type="out", magnitude=4),
     math.sqrt(4 / 576.0), math.sqrt(4 / 576.0 / 3)),
    ("msra", lambda p: p.init.MSRAPrelu(factor_type="in", slope=0.5), None,
     math.sqrt(2.0 / 1.25 / 288)),
]


@pytest.mark.parametrize("case", RANDOM, ids=[c[0] for c in RANDOM])
def test_random_initializers_match_jax_in_bound_and_moments(case):
    _, make, bound, std = case
    pt.random.seed(0)
    for pkg in (pt, mx):
        x = _init(pkg, make(pkg), "c_weight").astype(np.float64)
        if bound is not None:
            assert np.abs(x).max() <= bound * (1 + 1e-6)
        assert _moments_ok(x, 0.0, std), (pkg.__name__, x.mean(), x.std(), std)


def test_orthogonal_matches_jax_in_kind():
    for pkg in (pt, mx):
        for shape, rt in (((10, 30), "uniform"), ((30, 10), "normal")):
            a = _init(pkg, pkg.init.Orthogonal(scale=1.5, rand_type=rt), "q_weight", shape)
            q = a @ a.T if shape[0] <= shape[1] else a.T @ a
            np.testing.assert_allclose(q, 2.25 * np.eye(min(shape)), atol=1e-4)


def test_initializer_registry_and_dumps_match_jax():
    for name, kw in (("xavier", {"magnitude": 2}), ("uniform", {"scale": 0.3}),
                     ("constant", {"value": 2.0}), ("msraprelu", {})):
        assert pt.init.create(name, **kw).dumps() == mx.init.create(name, **kw).dumps()
    f = pt.init.FusedRNN(pt.init.Xavier(), 8, 1, "lstm")
    assert f.dumps() == mx.init.FusedRNN(mx.init.Xavier(), 8, 1, "lstm").dumps()
    # the packed vector of a one-layer LSTM over 4 inputs, through the
    # rnn/ package's unpack and pack: JAX's bits where the inner init draws
    # nothing
    n = pt.ops.rnn.rnn_param_size(1, 4, 8, False, "lstm")
    got = pt.nd.zeros((n,), ctx=pt.cpu())
    want = mx.nd.zeros((n,))
    pt.init.FusedRNN(pt.init.Constant(0.5), 8, 1, "lstm")("lstm_weight", got)
    mx.init.FusedRNN(mx.init.Constant(0.5), 8, 1, "lstm")("lstm_weight", want)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


# ------------------------------------------------------------------ metrics
def _metric_inputs():
    rs = np.random.RandomState(3)
    probs = rs.dirichlet(np.ones(4), 30).astype("f")
    labels = rs.randint(0, 4, 30).astype("f")
    binp = rs.dirichlet(np.ones(2), 30).astype("f")
    binl = rs.randint(0, 2, 30).astype("f")
    reg_p, reg_l = rs.randn(30, 1).astype("f"), rs.randn(30).astype("f")
    seq_p = rs.dirichlet(np.ones(5), (6, 7)).astype("f")
    seq_l = rs.randint(0, 5, (6, 7)).astype("f")
    return probs, labels, binp, binl, reg_p, reg_l, seq_p, seq_l


def _metric_cases(p):
    probs, labels, binp, binl, reg_p, reg_l, seq_p, seq_l = _metric_inputs()

    def feval(label, pred):
        return float(np.abs(label - pred.argmax(1)).sum()), label.size

    return [
        ("acc", p.metric.create("acc"), [labels], [probs]),
        ("top_k", p.metric.create("top_k_accuracy", top_k=3), [labels], [probs]),
        ("f1", p.metric.F1(), [binl], [binp]),
        ("perplexity", p.metric.Perplexity(ignore_label=0), [seq_l], [seq_p]),
        ("perplexity_none", p.metric.create("perplexity", ignore_label=None), [seq_l], [seq_p]),
        ("mae", p.metric.MAE(), [reg_l], [reg_p]),
        ("mse", p.metric.MSE(), [reg_l], [reg_p]),
        ("rmse", p.metric.RMSE(), [reg_l], [reg_p]),
        ("ce", p.metric.create("ce"), [labels], [probs]),
        ("loss", p.metric.Loss(), [labels], [probs]),
        ("torch", p.metric.Torch(), [labels], [probs]),
        ("caffe", p.metric.Caffe(), [labels], [probs]),
        ("custom", p.metric.CustomMetric(feval, name="l1"), [labels], [probs]),
        ("np", p.metric.np(feval), [labels], [probs]),
        ("composite", p.metric.create(["acc", "ce", p.metric.MSE()]), [labels], [probs]),
    ]


@pytest.mark.parametrize("idx", range(15), ids=[c[0] for c in _metric_cases(mx)])
def test_every_metric_matches_jax(idx):
    vals = []
    for pkg in (pt, mx):
        with (pt.cpu() if pkg is pt else contextlib.nullcontext()):
            name, m, labels, preds = _metric_cases(pkg)[idx]
            for _ in range(2):  # two updates, then a reset and one more
                m.update([pkg.nd.array(a) for a in labels], [pkg.nd.array(a) for a in preds])
            first = m.get_name_value()
            m.reset()
            m.update([pkg.nd.array(a) for a in labels], [pkg.nd.array(a) for a in preds])
            vals.append((first, m.get_name_value(), str(m)))
    (g1, g2, gs), (w1, w2, ws) = vals
    for got, want in ((g1, w1), (g2, w2)):
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------- callbacks
def _tiny_net(pkg):
    with pkg.name.NameManager():
        return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                                            num_hidden=3, name="fc"),
                                     name="softmax")


def _tiny_params():
    rs = np.random.RandomState(8)
    return {"fc_weight": rs.randn(3, 4).astype("f"), "fc_bias": rs.randn(3).astype("f")}


def test_do_checkpoint_writes_the_same_bytes_as_jax(tmp_path):
    files = {}
    for pkg in (pt, mx):
        prefix = str(tmp_path / pkg.__name__ / "net")
        os.makedirs(os.path.dirname(prefix))
        with (pt.cpu() if pkg is pt else contextlib.nullcontext()):
            args = {k: pkg.nd.array(v) for k, v in _tiny_params().items()}
            cb = pkg.callback.do_checkpoint(prefix, period=2)
            for epoch in range(4):
                cb(epoch, _tiny_net(pkg), args, {})
        assert pkg.model.find_last_checkpoint(prefix) == 4  # drains JAX's queued write
        names = sorted(os.listdir(os.path.dirname(prefix)))
        assert names == ["net-0002.params", "net-0004.params", "net-symbol.json"]
        files[pkg] = [open(os.path.join(os.path.dirname(prefix), f), "rb").read()
                      for f in names]
    assert files[pt] == files[mx]


def test_prefix_retention_keeps_what_jax_keeps(tmp_path):
    """keep-last-K over the same epoch files (the JAX callback queues its
    writes, so its retention runs on the files already there)."""
    kept = {}
    for pkg in (pt, mx):
        prefix = str(tmp_path / pkg.__name__ / "net")
        os.makedirs(os.path.dirname(prefix))
        for ep in (1, 2, 3, 5):
            for suffix in (".params", ".states"):
                open("%s-%04d%s" % (prefix, ep, suffix), "wb").close()
        assert pkg.checkpoint.prefix_retention(prefix, 2) == [1, 2]
        kept[pkg] = sorted(os.listdir(os.path.dirname(prefix)))
    assert kept[pt] == kept[mx] == ["net-0003.params", "net-0003.states", "net-0005.params",
                                    "net-0005.states"]


def test_module_checkpoint_writes_the_same_bytes_as_jax(tmp_path):
    out = {}
    for pkg in (pt, mx):
        prefix = str(tmp_path / pkg.__name__ / "mod")
        os.makedirs(os.path.dirname(prefix))
        with (pt.cpu() if pkg is pt else contextlib.nullcontext()):
            mod = pkg.mod.Module(_tiny_net(pkg), context=pkg.cpu())
            mod.bind(data_shapes=[("data", (2, 4))], label_shapes=[("softmax_label", (2,))])
            mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in _tiny_params().items()})
            mod.init_optimizer(optimizer="sgd", optimizer_params=(("learning_rate", 0.1),))
            cb = pkg.callback.module_checkpoint(mod, prefix, period=1, keep=1)
            cb(0)
            cb(1)
        names = sorted(os.listdir(os.path.dirname(prefix)))
        assert names == ["mod-0002.params", "mod-symbol.json"]
        out[pkg] = [open(os.path.join(os.path.dirname(prefix), f), "rb").read() for f in names]
    assert out[pt] == out[mx]


def _log_lines(caplog, run):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        run()
    return [r.getMessage() for r in caplog.records if r.name == "root"]


def test_speedometer_and_log_train_metric_log_as_jax(caplog):
    def lines(pkg):
        metric = pkg.metric.create("acc")
        metric.update([pkg.nd.array(np.array([0, 1, 1], "f"))],
                      [pkg.nd.array(np.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]], "f"))])
        speed = pkg.callback.Speedometer(batch_size=4, frequent=2)
        logm = pkg.callback.log_train_metric(period=2)

        def run():
            for nbatch in range(5):
                p = pkg.module.BatchEndParam(epoch=1, nbatch=nbatch, eval_metric=metric,
                                             locals=None)
                logm(p)
                speed(p)
        return _log_lines(caplog, run)

    with pt.cpu():
        got = lines(pt)
    want = lines(mx)
    assert len(got) == len(want) == 5

    def stripped(msg):  # the measured speed and step time differ run to run
        return msg.split("Speed:")[0] + msg.split("\t")[-1] if "Speed:" in msg else msg

    assert [stripped(m) for m in got] == [stripped(m) for m in want]
    assert all("MFU" not in m for m in got)  # no flops given: no MFU


def test_speedometer_mfu_reads_the_cards_dense_bf16_peak(monkeypatch):
    assert pt.device_info.bf16_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert pt.device_info.bf16_peak_flops("NVIDIA H100 PCIe 80GB") == 756.5e12
    assert pt.device_info.bf16_peak_flops("TPU v5 lite") is None
    speed = pt.callback.Speedometer(batch_size=8, flops_per_sample=1e9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert speed._mfu(1000.0) is None  # no card, no MFU
    speed = pt.callback.Speedometer(batch_size=8, flops_per_sample=1e9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert speed._mfu(989.4e3) == pytest.approx(1.0)


def test_monitor_collects_jaxs_statistics():
    stats = []
    for pkg in (pt, mx):
        with (pt.cpu() if pkg is pt else contextlib.nullcontext()):
            mod = pkg.mod.Module(_tiny_net(pkg), context=pkg.cpu())
            mod.bind(data_shapes=[("data", (2, 4))], label_shapes=[("softmax_label", (2,))])
            mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in _tiny_params().items()})
            mon = pkg.monitor.Monitor(interval=1, pattern=".*")
            mod.install_monitor(mon)
            x = np.random.RandomState(2).randn(2, 4).astype("f")
            batch = pkg.io.DataBatch(data=[pkg.nd.array(x)], label=[pkg.nd.array([0, 2])])
            mon.tic()
            mod.forward(batch, is_train=False)
            stats.append(mon.toc())
    (got, want) = stats
    assert [(n, k) for n, k, _ in got] == [(n, k) for n, k, _ in want] and got
    np.testing.assert_allclose([float(v) for _, _, v in got], [float(v) for _, _, v in want],
                               rtol=1e-6)


@pytest.mark.parametrize("op", ["random_uniform", "random_normal"])
def test_samplers_on_the_cpu_generator(op):
    """``random.seed`` seeds the CPU generator: the same seed, the same
    draws; another seed, others; the moments are the distribution's."""
    attrs = {"shape": (50000,)}
    pt.random.seed(1)
    a = pt.nd.random_uniform(ctx=pt.cpu(), **attrs) if op == "random_uniform" else \
        pt.random.normal(ctx=pt.cpu(), **attrs)
    pt.random.seed(1)
    b = getattr(pt.nd, op)(ctx=pt.cpu(), **attrs)
    pt.random.seed(2)
    c = getattr(pt.nd, op)(ctx=pt.cpu(), **attrs)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert not np.array_equal(a.asnumpy(), c.asnumpy())
    x = c.asnumpy().astype(np.float64)
    mean, std = (0.5, 1 / math.sqrt(12)) if op == "random_uniform" else (0.0, 1.0)
    assert _moments_ok(x, mean, std)
