"""The port's parallel core (``mxnet_tpu_torch/parallel``) held against the
JAX package's: the cases of ``tests/test_parallel.py`` that one process (a
card, or the CPU) can run. Meshes of several logical contexts run the
global batch as one step, so data and tensor parallelism must give the
single-device numbers; each also runs against the JAX trainer over its
virtual CPUs from the same numpy weights (rtol 2e-4, atol 2e-5, the fused
step's tolerance). The functional optimizers are held step by step against
``make_functional_optimizer`` on the same numpy dicts (rtol 1e-5, atol
1e-6: the same float32 expressions, in another order).
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import models, parallel

torch.set_num_threads(1)


def _jax_start(mesh_devices, opt, seed=7):
    """The JAX trainer's initial params for the mlp (numpy)."""
    mesh = mxnet_tpu.parallel.make_mesh({"data": len(mesh_devices)}, devices=mesh_devices)
    tr = mxnet_tpu.parallel.SPMDTrainer(
        mxnet_tpu.models.get_symbol("mlp", num_classes=10), mesh, optimizer=opt,
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    tr.init_params({"data": (8, 784)}, {"softmax_label": (8,)}, seed=seed)
    return tr


def _batch():
    rs = np.random.RandomState(0)
    return rs.rand(8, 784).astype("float32"), rs.randint(0, 10, (8,)).astype("float32")


def _train(mesh_shape, steps=3, remat=False, opt="sgd", start=None, net="mlp"):
    n = int(np.prod(list(mesh_shape.values())))
    mesh = parallel.make_mesh(mesh_shape, devices=[pt.cpu(i) for i in range(n)])
    tr = parallel.SPMDTrainer(
        models.get_symbol(net, num_classes=10), mesh, optimizer=opt,
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9}, remat=remat)
    tr.init_params({"data": (8, 784)}, {"softmax_label": (8,)}, seed=7)
    if start is not None:
        tr.set_params(start)
    x, y = _batch()
    for _ in range(steps):
        tr.step({"data": x}, {"softmax_label": y})
    p, _ = tr.get_params()
    return p


def test_make_mesh_shapes():
    devs = [pt.cpu(i) for i in range(8)]
    m = parallel.make_mesh({"data": 4, "model": 2}, devices=devs)
    assert m.shape["data"] == 4 and m.shape["model"] == 2
    assert m.devices.shape == (4, 2) and m.process_count == 1
    m2 = parallel.make_mesh((-1,), axis_names=("data",), devices=devs)
    assert m2.shape["data"] == 8
    with pytest.raises(ValueError):
        parallel.make_mesh({"data": 3}, devices=devs)
    with pt.cpu():
        assert parallel.make_mesh().shape == {"data": 1, "model": 1}
        assert parallel.local_mesh(4).shape == {"data": 4}
    spec = parallel.parse_mesh_spec("dp=8,model=2")
    assert spec.shape == mxnet_tpu.parallel.parse_mesh_spec("dp=8,model=2").shape


def test_sharding_rules_match_the_reference():
    """The same specs (as tuples) and the same divisibility decisions."""
    jm = mxnet_tpu.parallel.make_mesh({"data": 4, "model": 2})
    pm = parallel.make_mesh({"data": 4, "model": 2}, devices=[pt.cpu(i) for i in range(8)])
    jr, pr = mxnet_tpu.parallel.ShardingRules(jm), parallel.ShardingRules(pm)
    for name, shape in [("fc_weight", (512, 256)), ("fc_weight", (511, 256)),
                        ("fc_weight", (511, 255)), ("fc_bias", (512,)),
                        ("conv_weight", (64, 3, 3, 3)), ("small_weight", (16, 16))]:
        assert pr.param_spec(name, shape) == tuple(jr.param_spec(name, shape)), (name, shape)
        assert parallel.shardable_dims(shape, 2) == mxnet_tpu.parallel.shardable_dims(shape, 2)
    assert pr.batch_spec((8, 784)) == tuple(jr.batch_spec((8, 784)))
    assert pr.data_parallel_size == 4 and pr.model_parallel_size == 2
    with pytest.raises(pt.MXNetError, match="does not split evenly"):
        pr.check((6, 784), pr.batch_spec((6, 784)))


def test_dp_matches_single_device():
    single = _train({"data": 1})
    dp = _train({"data": 8})
    for k in single:
        np.testing.assert_allclose(single[k], dp[k], rtol=2e-5, atol=1e-5)


def test_tp_matches_dp():
    dp = _train({"data": 8})
    tp = _train({"data": 4, "model": 2})
    for k in dp:
        np.testing.assert_allclose(dp[k], tp[k], rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dp_matches_the_jax_trainer(opt):
    jt = _jax_start(jax.devices()[:8], opt)
    start, _ = jt.get_params()
    x, y = _batch()
    for _ in range(3):
        jt.step({"data": x}, {"softmax_label": y})
    want, _ = jt.get_params()
    got = _train({"data": 8}, opt=opt, start=start)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)


def test_adam_spmd_runs():
    p = _train({"data": 4}, opt="adam")
    assert all(np.isfinite(v).all() for v in p.values())


@pytest.mark.parametrize("mode", [True, "nothing", "dots"])
def test_remat_matches_plain(mode):
    plain = _train({"data": 4})
    remat = _train({"data": 4}, remat=mode)
    for k in plain:
        np.testing.assert_allclose(plain[k], remat[k], rtol=1e-5, atol=1e-6)


def test_trainer_remat_policies_match_plain_on_lenet():
    rs = np.random.RandomState(0)
    x = rs.rand(8, 1, 28, 28).astype("float32")
    y = rs.randint(0, 10, (8,)).astype("float32")

    def run(remat):
        mesh = parallel.make_mesh((2,), ("data",), [pt.cpu(0), pt.cpu(1)])
        tr = parallel.SPMDTrainer(models.get_symbol("lenet", num_classes=10), mesh,
                                  optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                                  remat=remat)
        tr.init_params({"data": (8, 1, 28, 28)}, {"softmax_label": (8,)}, seed=0)
        for _ in range(3):
            tr.step({"data": x}, {"softmax_label": y})
        return tr.get_params()[0]

    base = run(False)
    for mode in (True, "dots", "nothing"):
        got = run(mode)
        for k in base:
            np.testing.assert_allclose(got[k], base[k], rtol=1e-5, atol=1e-5,
                                       err_msg="remat=%r diverged on %s" % (mode, k))


def test_cost_analysis_reports_flops_and_bytes():
    """cost_analysis runs nothing on the device, returns positive flops and
    bytes, and leaves the trainer able to keep stepping; its flops are the
    mlp's products, forward and backward (2·B·(784·128 + 128·64 + 64·10)
    forward, twice that backward, without the input's gradient)."""
    mesh = parallel.make_mesh({"data": 1}, devices=[pt.cpu()])
    tr = parallel.SPMDTrainer(models.get_symbol("mlp", num_classes=10), mesh)
    tr.init_params({"data": (8, 784)}, {"softmax_label": (8,)}, seed=0)
    d = {"data": np.ones((8, 784), "float32")}
    lab = {"softmax_label": np.zeros((8,), "float32")}
    tr.step(d, lab)
    before = tr.get_params()[0]
    cost = tr.cost_analysis(d, lab)
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    products = 2 * 8 * (784 * 128 + 128 * 64 + 64 * 10)
    assert 3 * products - 2 * 8 * 784 * 128 <= cost["flops"] - 5 * 2 * sum(
        v.size for v in before.values()) <= 3 * products
    for k, v in tr.get_params()[0].items():
        assert np.array_equal(v, before[k])  # nothing stepped
    tr.step(d, lab)


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.125,
                 clip_gradient=0.5, lr_mult={"a": 0.5}, wd_mult={"b": 0.0})),
    ("sgd", dict(learning_rate=0.05, momentum=0.0, wd=1e-4)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3, lr_mult={"b": 2.0})),
    ("nag", dict(learning_rate=0.1, momentum=0.0)),
    ("adam", dict(learning_rate=0.01, wd=1e-3, beta1=0.8, beta2=0.99, epsilon=1e-6,
                  rescale_grad=0.5, wd_mult={"a": 2.0})),
])
def test_functional_optimizers_match_the_reference_step_by_step(name, kwargs):
    import jax.numpy as jnp

    rs = np.random.RandomState(5)
    params = {"a": rs.randn(6, 4).astype("f"), "b": rs.randn(5).astype("f")}
    j_init, j_apply = mxnet_tpu.parallel.make_functional_optimizer(name, **kwargs)
    p_init, p_apply = parallel.make_functional_optimizer(name, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = j_init(jp), p_init(pp)
    assert set(js) == set(ps)
    for step in range(4):
        grads = {k: (rs.randn(*v.shape) * 2).astype("f") for k, v in params.items()}
        lr = None if step == 0 else 0.1 / (step + 1)
        jp, js = j_apply(jp, {k: jnp.asarray(g) for k, g in grads.items()}, js,
                         lr=None if lr is None else jnp.asarray(lr, "float32"))
        pp, ps = p_apply(pp, {k: torch.from_numpy(g) for k, g in grads.items()}, ps,
                         lr=None if lr is None else torch.tensor(lr))
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg="%s step %d %s" % (name, step, k))
        assert int(ps["t"]) == int(np.asarray(js["t"])) == step + 1
        for s in set(js) - {"t"}:
            for k in params:
                np.testing.assert_allclose(ps[s][k].numpy(), np.asarray(js[s][k]),
                                           rtol=1e-5, atol=1e-6)


def test_functional_from_optimizer_matches_the_reference():
    opt_kw = dict(learning_rate=0.2, momentum=0.9, wd=1e-3, rescale_grad=0.25,
                  param_idx2name={0: "a", 1: "b"})
    jo = mxnet_tpu.optimizer.create("sgd", **opt_kw)
    po = pt.optimizer.create("sgd", **opt_kw)
    jo.set_lr_mult({"a": 0.5})
    po.set_lr_mult({"a": 0.5})
    j_init, j_apply, j_lr = mxnet_tpu.parallel.optim.functional_from_optimizer(jo, {"a", "b"})
    p_init, p_apply, p_lr = parallel.optim.functional_from_optimizer(po, {"a", "b"})
    fo = p_apply.__self__
    assert fo.lr_mult == {"a": 0.5}
    assert fo.wd_mult == {k: float(v) for k, v in jo.wd_mult.items() if k in ("a", "b")}
    assert [p_lr(t) for t in (1, 5)] == [j_lr(t) for t in (1, 5)]
    assert parallel.optim.functional_from_optimizer(pt.optimizer.create("rmsprop"),
                                                    {"a"}) is None
