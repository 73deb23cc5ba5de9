"""The port's optimizers, schedules and updater against the JAX package's.

Every optimizer takes 5 updates of the same weights with the same
gradients in both packages (float32 elementwise arithmetic on the CPU:
within rtol 1e-5, atol 1e-6), with rescale, clipping, weight decay and, for
some, a schedule. SGLD's noise is the port's own draw: its deterministic
part is held to JAX's with the noise taken out of both, and its draws to
N(0, lr) by their moments. Then the schedulers, the multipliers read from a
symbol's attributes, and the updater's ``get_states``/``set_states``.
"""
import math
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (6, 5)


def _sched(pkg, kind):
    if kind == "factor":
        return pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    if kind == "multi":
        return pkg.lr_scheduler.MultiFactorScheduler(step=[1, 3], factor=0.3)
    return None


# (name, kwargs, scheduler)
CASES = [
    ("sgd", dict(learning_rate=0.1), None),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01, clip_gradient=0.5,
                 rescale_grad=0.5), "factor"),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01), None),
    ("nag", dict(learning_rate=0.1, clip_gradient=0.3), "multi"),
    ("ccsgd", dict(learning_rate=0.05, momentum=0.5), None),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.1, wd=0.01), None),
    ("dcasgd", dict(learning_rate=0.1, clip_gradient=0.4), "factor"),
    ("adam", dict(learning_rate=0.01, wd=0.01, clip_gradient=1.0), None),
    ("adam", dict(learning_rate=0.01, beta1=0.8, beta2=0.99, rescale_grad=0.5), "multi"),
    ("adagrad", dict(learning_rate=0.1, wd=0.01), None),
    ("adagrad", dict(learning_rate=0.1, eps=1e-5, clip_gradient=0.5), "factor"),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01), None),
    ("rmsprop", dict(learning_rate=0.01, gamma1=0.8, clip_weights=0.4, clip_gradient=0.5),
     "factor"),
    ("rmsprop", dict(learning_rate=0.01, centered=True, gamma2=0.8, wd=0.01), None),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=0.5), "multi"),
    ("adadelta", dict(rho=0.9, epsilon=1e-5, wd=0.01), None),
    ("adadelta", dict(rho=0.8, clip_gradient=0.5), None),
    ("test", dict(rescale_grad=0.5), None),
    ("sgld", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5), None),
]


def _values(seed=0):
    rs = np.random.RandomState(seed)
    w = {"fc_weight": rs.randn(*SHAPE).astype("f"), "fc_bias": rs.randn(SHAPE[0]).astype("f")}
    grads = [{k: rs.randn(*v.shape).astype("f") for k, v in w.items()} for _ in range(5)]
    return w, grads


def _run(pkg, name, kwargs, sched, steps=5, updater=None):
    """5 updates of fc_weight (index 0) and fc_bias (index 1) through an
    Updater; returns the weights and the updater."""
    w, grads = _values()
    opt = pkg.optimizer.create(name, param_idx2name={0: "fc_weight", 1: "fc_bias"},
                               lr_scheduler=_sched(pkg, sched), **kwargs)
    upd = updater or pkg.optimizer.get_updater(opt)
    arrs = {k: pkg.nd.array(v) for k, v in w.items()}
    for g in grads[:steps]:
        for i, k in enumerate(("fc_weight", "fc_bias")):
            upd(i, pkg.nd.array(g[k]), arrs[k])
    return {k: a.asnumpy() for k, a in arrs.items()}, upd


def _no_noise(monkeypatch):
    """SGLD's deterministic part: its noise draw returns zeros."""
    for pkg in (mx, pt):
        monkeypatch.setattr(pkg.optimizer.nd, "random_normal",
                            lambda loc, scale, shape, ctx, _p=pkg: _p.nd.zeros(shape, ctx=ctx))


@pytest.mark.parametrize("name,kwargs,sched", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_optimizer_matches_jax_over_five_updates(name, kwargs, sched, monkeypatch):
    if name == "sgld":
        _no_noise(monkeypatch)
    want, jupd = _run(mx, name, kwargs, sched)
    with pt.cpu():
        got, upd = _run(pt, name, kwargs, sched)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert upd.optimizer.num_update == jupd.optimizer.num_update == (0 if name == "test" else 5)


def test_sgld_noise_has_the_references_moments():
    """One SGLD step from zero weights with a zero gradient leaves only the
    noise: N(0, lr) on the weight's device, from its generator."""
    lr, n = 0.04, 40000
    pt.random.seed(5)
    with pt.cpu():
        w = pt.nd.zeros((n,))
        opt = pt.optimizer.create("sgld", learning_rate=lr)
        opt.update(0, w, pt.nd.zeros((n,)), None)
    x = w.asnumpy().astype(np.float64)
    std = math.sqrt(lr)
    assert abs(x.mean()) < 5 * std / math.sqrt(n)
    assert abs(x.std() - std) < 5 * std / math.sqrt(2 * n)


@pytest.mark.parametrize("kind", ["factor", "multi", "poly"])
def test_lr_schedulers_match_jax(kind):
    def seq(pkg):
        if kind == "poly":
            s = pkg.lr_scheduler.PolyScheduler(max_update=20, power=2.0, base_lr=0.3)
        elif kind == "factor":
            s = pkg.lr_scheduler.FactorScheduler(step=3, factor=0.7, stop_factor_lr=0.05)
            s.base_lr = 0.3
        else:
            s = pkg.lr_scheduler.MultiFactorScheduler(step=[2, 5, 11], factor=0.5)
            s.base_lr = 0.3
        return [s(t) for t in range(25)]

    assert seq(pt) == seq(mx)


def test_multipliers_from_symbol_attributes_match_jax():
    def build(pkg):
        with pkg.name.NameManager():
            S = pkg.sym
            w = S.Variable("fc1_weight", lr_mult=0.5, wd_mult=3.0)
            b = S.Variable("fc1_bias", lr_mult=2.0)
            net = S.FullyConnected(S.Variable("data"), weight=w, bias=b, num_hidden=4,
                                   name="fc1")
            net = S.FullyConnected(net, num_hidden=3, name="fc2")
            net = S.SoftmaxOutput(net, name="softmax")
        names = [n for n in net.list_arguments() if n not in ("data", "softmax_label")]
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, wd=0.01, sym=net,
                                   param_idx2name=dict(enumerate(names)))
        opt.set_lr_mult({"fc2_weight": 0.25})
        return opt, names

    (ro, names), (po, _) = build(mx), build(pt)
    assert po.lr_mult == ro.lr_mult == {"fc1_weight": 0.5, "fc1_bias": 2.0, "fc2_weight": 0.25}
    assert po.wd_mult == ro.wd_mult
    assert po.wd_mult["fc1_weight"] == 3.0 and po.wd_mult["fc2_bias"] == 0.0
    for i in range(len(names)):
        assert po._get_lr(i) == ro._get_lr(i) and po._get_wd(i) == ro._get_wd(i)


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "dcasgd"])
def test_updater_states_round_trip_through_a_pickle(name):
    """2 updates, ``get_states``, a fresh updater ``set_states``, 3 more:
    the same weights as 5 updates in one go; the pickle holds the port's
    NDArrays with their context."""
    kwargs = dict(learning_rate=0.05, momentum=0.9) if name in ("sgd", "dcasgd") else \
        dict(learning_rate=0.01)
    with pt.cpu():
        want, _ = _run(pt, name, kwargs, None)
        w, grads = _values()
        opt = pt.optimizer.create(name, param_idx2name={0: "fc_weight", 1: "fc_bias"}, **kwargs)
        upd = pt.optimizer.get_updater(opt)
        arrs = {k: pt.nd.array(v) for k, v in w.items()}
        for step, g in enumerate(grads):
            if step == 2:
                blob = upd.get_states()
                restored = pickle.loads(blob)
                flat = [s for v in restored.values()
                        for s in (v if isinstance(v, tuple) else (v,)) if s is not None]
                assert flat and all(isinstance(s, pt.nd.NDArray) and s.context == pt.cpu()
                                    for s in flat)
                upd = pt.optimizer.get_updater(opt)
                upd.set_states(blob)
            for i, k in enumerate(("fc_weight", "fc_bias")):
                upd(i, pt.nd.array(g[k]), arrs[k])
    for k in want:
        np.testing.assert_array_equal(arrs[k].asnumpy(), want[k])


def test_flat_and_row_sparse_paths_raise_naming_their_sections():
    """These paths raised, naming ROADMAP.md section 1.4, until its first
    half landed; now each gives the JAX package's result: the flat specs,
    the flat kernels, the lazy row update (rtol 1e-5, atol 1e-6; untouched
    rows bitwise) and the updater's row-sparse state."""
    for name, kw in (("sgd", {"momentum": 0.9}), ("sgd", {}), ("adam", {}), ("nag", {}),
                     ("rmsprop", {})):
        assert pt.optimizer.create(name, learning_rate=0.1, **kw).flat_update_spec() == \
            mx.optimizer.create(name, learning_rate=0.1, **kw).flat_update_spec()
    assert callable(pt.optimizer.flat_kernel("sgd", {"momentum": 0.0, "rescale_grad": 1.0,
                                                     "clip_gradient": 0.0}))
    rs = np.random.RandomState(3)
    w0 = rs.rand(*SHAPE).astype("f")
    rows, vals = np.array([1, 4]), rs.rand(2, SHAPE[1]).astype("f")
    got = {}
    for pkg in (mx, pt):
        ctx = {"ctx": pkg.cpu()} if pkg is pt else {}
        opt = pkg.optimizer.create("adam", learning_rate=0.1, wd=0.01)
        upd = pkg.optimizer.get_updater(opt)
        w = pkg.nd.array(w0, **ctx)
        for _ in range(2):
            upd(0, pkg.sparse.row_sparse_array((pkg.nd.array(vals, **ctx), rows), SHAPE), w)
        st = upd.states[0]
        assert type(st).__name__ == "RowSparseState" and st.indices.tolist() == [1, 4]
        got[pkg.__name__] = (w.asnumpy(), st.rows)
    (wj, sj), (wp, sp) = got["mxnet_tpu"], got["mxnet_tpu_torch"]
    np.testing.assert_allclose(wp, wj, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(wp[[0, 2, 3, 5]], w0[[0, 2, 3, 5]])
    for a, b in zip(sp, sj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)