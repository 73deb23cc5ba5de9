"""Training megasteps of the port (``SPMDTrainer.step_many`` and the
adapter's ``MXNET_TRAIN_MEGASTEP_N`` buffering), the cases of
``tests/test_train_megastep.py``: N steps a dispatch give bitwise the
weights of N single steps (a NaN-guard skipped step included), dispatches
drop N-fold, and ``Module.fit``'s metric drains through the buffered
seams. On the CPU the N steps run one after another; on the card they are
one CUDA graph (``tests/test_torch_cuda.py``). The N = 4 megastep is also
held against the JAX package's ``lax.scan`` megastep from the same numpy
weights (rtol 2e-4, atol 2e-5, the fused step's tolerance).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import parallel, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.module.spmd_adapter import train_megastep_n

torch.set_num_threads(1)


@pytest.fixture
def tm():
    telemetry.reset()
    telemetry.clear_events()
    saved = telemetry.current_override()
    yield telemetry
    telemetry.set_mode(saved)
    telemetry.reset()
    telemetry.clear_events()


def _mlp(mx=pt, hidden=32, classes=4):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, name="fc1", num_hidden=hidden)
    h = mx.sym.Activation(h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(h, name="fc2", num_hidden=classes)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _host_batches(n, batch=16, feat=8, classes=4, seed=0, nan_step=None):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rs.rand(batch, feat).astype("float32")
        if i == nan_step:
            x[0, 0] = np.nan
        y = rs.randint(0, classes, (batch,)).astype("float32")
        out.append(({"data": x}, {"softmax_label": y}))
    return out


def _trainer(seed=5):
    mesh = parallel.make_mesh((2,), ("data",), [pt.cpu(0), pt.cpu(1)])
    tr = parallel.SPMDTrainer(
        _mlp(), mesh, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    tr.init_params({"data": (16, 8)}, {"softmax_label": (16,)}, seed=seed)
    return tr


LRS = [0.1, 0.09, 0.08, 0.07]


# ------------------------------------------------------------------ knobs
def test_train_megastep_n_env(monkeypatch):
    monkeypatch.delenv("MXNET_TRAIN_MEGASTEP_N", raising=False)
    assert train_megastep_n() == 1
    monkeypatch.setenv("MXNET_TRAIN_MEGASTEP_N", "4")
    assert train_megastep_n() == 4
    monkeypatch.setenv("MXNET_TRAIN_MEGASTEP_N", "junk")
    assert train_megastep_n() == 1
    monkeypatch.setenv("MXNET_TRAIN_MEGASTEP_N", "0")
    assert train_megastep_n() == 1


# ----------------------------------------------------------------- parity
def test_step_many_bitwise_parity():
    """One N=4 megastep gives bitwise the weights of 4 single steps with
    the same per-step lrs."""
    batches = _host_batches(4)
    tr1 = _trainer()
    for (d, l), lr in zip(batches, LRS):
        tr1.step(d, l, lr=lr)
    tr2 = _trainer()
    tr2.step_many([d for d, _ in batches], [l for _, l in batches], lrs=LRS)
    p1, _ = tr1.get_params()
    p2, _ = tr2.get_params()
    assert set(p1) == set(p2)
    for k in p1:
        assert np.array_equal(p1[k], p2[k]), "param %s not bitwise identical" % k


def test_step_many_matches_the_jax_megastep():
    import jax

    batches = _host_batches(4)
    jmesh = mxnet_tpu.parallel.make_mesh((2,), ("data",), jax.devices()[:2])
    jt = mxnet_tpu.parallel.SPMDTrainer(
        _mlp(mxnet_tpu), jmesh, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    jt.init_params({"data": (16, 8)}, {"softmax_label": (16,)}, seed=5)
    start, _ = jt.get_params()
    tr = _trainer()
    tr.set_params(start)
    jouts = jt.step_many([d for d, _ in batches], [l for _, l in batches], lrs=LRS)
    pouts = tr.step_many([d for d, _ in batches], [l for _, l in batches], lrs=LRS)
    jp, _ = jt.get_params()
    pp, _ = tr.get_params()
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], rtol=2e-4, atol=2e-5, err_msg=k)
    for j, p in zip(jouts, pouts):
        np.testing.assert_allclose(p[0].numpy(), np.asarray(j[0]), rtol=1e-4, atol=1e-5)
    assert int(tr.opt_state["t"]) == int(np.asarray(jt.opt_state["t"])) == 4


def test_step_many_nan_guard_skip_parity(monkeypatch):
    """A NaN-poisoned batch inside the megastep keeps the old state exactly
    like the single-step skip: same skip count, bitwise weights, and the
    counter does not advance for the skipped step."""
    monkeypatch.setenv("MXNET_ANOMALY_GUARD", "skip")
    batches = _host_batches(4, nan_step=2)
    tr1 = _trainer()
    for (d, l), lr in zip(batches, LRS):
        tr1.step(d, l, lr=lr)
    tr2 = _trainer()
    tr2.step_many([d for d, _ in batches], [l for _, l in batches], lrs=LRS)
    assert tr1.skipped_steps == 1
    assert tr2.skipped_steps == 1
    assert int(tr1.opt_state["t"]) == int(tr2.opt_state["t"]) == 3
    p1, _ = tr1.get_params()
    p2, _ = tr2.get_params()
    for k in p1:
        assert np.array_equal(p1[k], p2[k]), "param %s diverged across the skipped step" % k


def test_guard_skip_leaves_params_aux_and_state_bitwise(monkeypatch):
    monkeypatch.setenv("MXNET_ANOMALY_GUARD", "skip")
    tr = _trainer()
    (d, l), = _host_batches(1)
    tr.step(d, l)
    before = tr.get_params()[0], {k: v.clone() for k, v in tr.opt_state["mom"].items()}
    d = {"data": d["data"].copy()}
    d["data"][3, 1] = np.nan
    tr.step(d, l)
    assert tr.skipped_steps == 1
    for k, v in tr.get_params()[0].items():
        assert np.array_equal(v, before[0][k])
    for k, v in tr.opt_state["mom"].items():
        assert torch.equal(v, before[1][k])
    monkeypatch.setenv("MXNET_ANOMALY_GUARD", "raise")
    tr2 = _trainer()
    with pytest.raises(MXNetError, match="anomaly guard"):
        tr2.step(d, l)


def test_step_many_outputs_match_per_step():
    batches = _host_batches(2)
    tr1 = _trainer()
    want = [tr1.step(d, l, lr=0.1) for d, l in batches]
    tr2 = _trainer()
    got = tr2.step_many([d for d, _ in batches], [l for _, l in batches], lrs=[0.1, 0.1])
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_step_many_dispatch_counters(tm):
    """8 batches at N=4: trainer.step counts 8 both ways, but dispatches
    drop 8 -> 2."""
    tm.set_mode("counters")
    batches = _host_batches(8)
    tr1 = _trainer()
    c0 = tm.counters()
    for d, l in batches:
        tr1.step(d, l, lr=0.1)
    c1 = tm.counters()
    assert c1.get("trainer.step", 0) - c0.get("trainer.step", 0) == 8
    assert c1.get("trainer.dispatches", 0) - c0.get("trainer.dispatches", 0) == 8

    tr2 = _trainer()
    c2 = tm.counters()
    for i in range(0, 8, 4):
        tr2.step_many([d for d, _ in batches[i:i + 4]], [l for _, l in batches[i:i + 4]],
                      lrs=[0.1] * 4)
    c3 = tm.counters()
    assert c3.get("trainer.step", 0) - c2.get("trainer.step", 0) == 8
    assert c3.get("trainer.dispatches", 0) - c2.get("trainer.dispatches", 0) == 2
    assert c3.get("trainer.megastep", 0) - c2.get("trainer.megastep", 0) == 2
    assert tm.gauge("train.steps_per_dispatch").value == 4


def test_step_many_single_degenerates_to_step():
    tr = _trainer()
    (d, l), = _host_batches(1)
    outs = tr.step_many([d], [l], lrs=[0.1])
    assert len(outs) == 1
    assert tr._step_count == 1  # one single step, no N-step program


def test_step_many_empty_and_unbuilt():
    tr = _trainer()
    assert tr.step_many([]) == []
    mesh = parallel.make_mesh((2,), ("data",), [pt.cpu(0), pt.cpu(1)])
    tr2 = parallel.SPMDTrainer(_mlp(), mesh)
    with pytest.raises(MXNetError):
        tr2.step_many([b[0] for b in _host_batches(2)], [b[1] for b in _host_batches(2)])


# ------------------------------------------------------------ module seam
def _fit_mod(batches, megastep_n, monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    if megastep_n is None:
        monkeypatch.delenv("MXNET_TRAIN_MEGASTEP_N", raising=False)
    else:
        monkeypatch.setenv("MXNET_TRAIN_MEGASTEP_N", str(megastep_n))
    with pt.cpu():
        pt.random.seed(7)
        mod = pt.mod.Module(_mlp(), context=[pt.cpu(i) for i in range(4)])
        b0 = batches[0]
        mod.bind(data_shapes=[("data", b0.data[0].shape)],
                 label_shapes=[("softmax_label", b0.label[0].shape)])
        mod.init_params(initializer=pt.init.Xavier(magnitude=2.0))
        mod.init_optimizer(kvstore="local", optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
        metric = pt.metric.Accuracy()
        for b in batches:
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
        mod.flush_pending_steps(metric)
        args, _ = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}, metric.get(), mod


def _nd_batches(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.rand(16, 8).astype("float32")
        y = rs.randint(0, 4, (16,)).astype("float32")
        out.append(pt.io.DataBatch(data=[pt.nd.array(x, ctx=pt.cpu())],
                                   label=[pt.nd.array(y, ctx=pt.cpu())]))
    return out


def test_module_megastep_bitwise_and_metric_parity(monkeypatch):
    """Module-level N=4 buffering (6 batches: one full flush + a partial
    tail flush) matches N=1 bitwise in weights AND in the metric."""
    batches = _nd_batches(6)
    p1, m1, _ = _fit_mod(batches, None, monkeypatch)
    p4, m4, mod = _fit_mod(batches, 4, monkeypatch)
    assert mod._spmd is not None and mod._spmd._megastep_n == 4
    for k in p1:
        assert np.array_equal(p1[k], p4[k]), "param %s diverged" % k
    assert m1 == m4


def test_module_megastep_fit_converges(monkeypatch):
    """fit() with the megastep on: the epoch-tail flush and score() both
    work, and the model still converges."""
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    monkeypatch.setenv("MXNET_TRAIN_MEGASTEP_N", "4")
    rs = np.random.RandomState(0)
    n, feat = 256, 16
    w = rs.randn(feat, 2).astype("float32")
    x = rs.randn(n, feat).astype("float32")
    y = np.argmax(x @ w, axis=1).astype("float32")
    with pt.cpu():
        it = pt.io.NDArrayIter(x, y, batch_size=32, shuffle=False, label_name="softmax_label")
        mod = pt.mod.Module(_mlp(hidden=32, classes=2), context=[pt.cpu(i) for i in range(8)])
        mod.fit(it, num_epoch=12, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.5), ("momentum", 0.9)),
                initializer=pt.init.Xavier(magnitude=2.0), eval_metric="acc", kvstore="local")
        assert mod._spmd is not None and mod._spmd._megastep_n == 4
        it.reset()
        score = mod.score(it, pt.metric.Accuracy())
    assert dict(score)["accuracy"] > 0.95


def test_module_megastep_checkpoint_flushes(monkeypatch):
    """get_params after a partial buffer flushes first: the weights include
    the buffered batches."""
    batches = _nd_batches(2)
    p1, _, _ = _fit_mod(batches, None, monkeypatch)
    p4, _, mod = _fit_mod(batches, 4, monkeypatch)
    assert mod._spmd._buf == []  # export drained the buffer
    for k in p1:
        assert np.array_equal(p1[k], p4[k]), "param %s diverged" % k
