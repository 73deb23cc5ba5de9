"""Model parallelism by context groups (``group2ctx``) and NDArray's
``writable`` flag in the port, held against the JAX package.

Every case of ``tests/test_model_parallel.py`` runs on both packages
(fixture ``mx``, the port inside ``with cpu():``), and the two packages'
values are compared (rtol 1e-5, atol 1e-6, the reference test's own).
``example/model-parallel-lstm/lstm_layer_split.py``'s symbol and training
loop run in both packages from the example's own functions, split against
unsplit. On the CPU ``cpu(0)`` and ``cpu(1)`` are one physical device, so
nothing moves; the crossing itself (a value copied to another device, its
gradient back, a boundary the fusion plan keeps materialized) runs here
with ``cpu(1)`` taken as the distinct torch device ``cpu:1`` (a ``.to``
onto it is a real copy). The card case, ``gpu(0)`` beside ``cpu(0)``, is
in ``tests/test_torch_cuda.py``.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


def _build_net(mx):
    with mx.AttrScope(ctx_group="dev1"):
        data = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act1 = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    with mx.AttrScope(ctx_group="dev2"):
        fc2 = mx.sym.FullyConnected(act1, num_hidden=4, name="fc2")
        net = mx.sym.LinearRegressionOutput(fc2, mx.sym.Variable("label"), name="loss")
    return net


def _arrays(net, shapes, seed=0):
    rs = np.random.RandomState(seed)
    return {n: rs.rand(*s).astype("float32")
            for n, s in zip(net.list_arguments(), net.infer_shape(**shapes)[0])}


def _run(mx, net, arrays, shapes, group2ctx):
    exe = net.simple_bind(mx.cpu(0), grad_req="write", group2ctx=group2ctx, **shapes)
    for k, v in arrays.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    out = exe.outputs[0].asnumpy()
    exe.backward()
    grads = {k: g.asnumpy() for k, g in exe.grad_dict.items() if g is not None}
    return out, grads, exe


def test_ctxgroup_attr_propagates(mx):
    net = _build_net(mx)
    topo_attrs = {node.name: node.attrs.get("__ctx_group__") for node in net._topo() if node.op}
    assert topo_attrs["fc1"] == "dev1" and topo_attrs["relu1"] == "dev1"
    assert topo_attrs["fc2"] == "dev2"


SHAPES = {"data": (8, 10), "label": (8, 4)}


def test_model_parallel_forward_backward_matches_single_device(mx):
    net = _build_net(mx)
    arrays = _arrays(net, SHAPES)
    out_single, grads_single, _ = _run(mx, net, arrays, SHAPES, None)
    out_mp, grads_mp, _ = _run(mx, net, arrays, SHAPES, {"dev1": mx.cpu(0), "dev2": mx.cpu(1)})
    np.testing.assert_allclose(out_mp, out_single, rtol=RTOL, atol=ATOL)
    for k in grads_single:
        np.testing.assert_allclose(grads_mp[k], grads_single[k], rtol=RTOL, atol=ATOL)


def test_model_parallel_split_matches_across_packages():
    """The split bind's outputs and gradients in the port equal JAX's."""
    got = []
    for mx in (mxnet_tpu, pt):
        with pt.cpu():
            net = _build_net(mx)
            got.append(_run(mx, net, _arrays(net, SHAPES), SHAPES,
                            {"dev1": mx.cpu(0), "dev2": mx.cpu(1)})[:2])
    (jo, jg), (po, pg) = got
    np.testing.assert_allclose(po, jo, rtol=RTOL, atol=ATOL)
    assert sorted(pg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_model_parallel_trains(mx):
    """2-group net trains end-to-end (placement is invisible to the
    training API, as in the reference)."""
    net = _build_net(mx)
    rs = np.random.RandomState(1)
    x = rs.rand(32, 10).astype("float32")
    w = rs.rand(10, 4).astype("float32")
    y = x @ w
    exe = net.simple_bind(mx.cpu(0), grad_req="write",
                          group2ctx={"dev1": mx.cpu(0), "dev2": mx.cpu(1)},
                          data=(32, 10), label=(32, 4))
    for name in exe.arg_dict:
        if name not in ("data", "label"):
            exe.arg_dict[name][:] = rs.uniform(-0.3, 0.3, exe.arg_dict[name].shape)
    exe.arg_dict["data"][:] = x
    exe.arg_dict["label"][:] = y
    losses = []
    for _ in range(60):
        exe.forward(is_train=True)
        losses.append(float(np.square(exe.outputs[0].asnumpy() - y).mean()))
        exe.backward()
        for name, grad in exe.grad_dict.items():
            if grad is not None and name not in ("data", "label"):
                exe.arg_dict[name][:] = exe.arg_dict[name].asnumpy() - 0.05 * grad.asnumpy()
    assert losses[-1] < losses[0] * 0.5, losses[::20]


@pytest.fixture
def cpu1_apart(monkeypatch):
    """``cpu(i)`` for i > 0 as the torch device ``cpu:i``, which a placement
    tells apart from ``cpu``: a value crossing to it is copied."""
    plain = pt.Context.torch_device

    def torch_device(self):
        if self.device_type == "cpu" and self.device_id > 0:
            return torch.device("cpu", self.device_id)
        return plain.fget(self)

    monkeypatch.setattr(pt.Context, "torch_device", property(torch_device))


def test_a_crossing_copies_the_value_and_brings_the_gradient_back(cpu1_apart):
    """With dev2 on another device the boundary is a differentiable copy:
    outputs and gradients equal the single bind's (rtol 1e-5, atol 1e-6),
    the loss head's output lies on dev2's context, the value crossing the
    boundary (relu1's) is kept materialized by the fusion plan, and dev1's
    nodes stay on the bind's device."""
    with pt.cpu():
        net = _build_net(pt)
        arrays = _arrays(net, SHAPES)
        out_single, grads_single, _ = _run(pt, net, arrays, SHAPES, None)
        out_mp, grads_mp, exe = _run(pt, net, arrays, SHAPES,
                                     {"dev1": pt.cpu(0), "dev2": pt.cpu(1)})
    prog = exe._prog
    devices = {n.name: prog.node_devices[id(n)] for n in prog.topo if not n.is_variable}
    assert devices["fc1"] == torch.device("cpu") and devices["fc2"] == torch.device("cpu", 1)
    assert exe.outputs[0].context == pt.cpu(1)
    np.testing.assert_allclose(out_mp, out_single, rtol=RTOL, atol=ATOL)
    for k in grads_single:
        np.testing.assert_allclose(grads_mp[k], grads_single[k], rtol=RTOL, atol=ATOL)
    # the crossing value stays out of any fused site on the far side
    relu = next(n for n in prog.topo if n.name == "relu1")
    assert prog.fusion_plan.get(id(relu), {}).get("kind") != "lazy"


def test_group2ctx_is_carried_by_reshape_simple_bind_and_shared_exec(cpu1_apart):
    """``reshape`` keeps the placement; ``shared_exec`` lends its program
    only to a bind with the same ``group2ctx``; a bind of one physical
    device (``cpu(0)`` and ``cpu(0)``) places nothing."""
    g2c = {"dev1": pt.cpu(0), "dev2": pt.cpu(1)}
    with pt.cpu():
        net = _build_net(pt)
        exe = net.simple_bind(pt.cpu(), grad_req="write", group2ctx=g2c, **SHAPES)
        big = exe.reshape(allow_up_sizing=True, data=(16, 10), label=(16, 4))
        assert big._prog is exe._prog and big._prog.group2ctx == g2c
        big.forward(is_train=False)
        assert big.outputs[0].context == pt.cpu(1) and big.outputs[0].shape == (16, 4)
        same = net.simple_bind(pt.cpu(), grad_req="write", group2ctx=g2c, shared_exec=exe,
                               **SHAPES)
        assert same._prog is exe._prog
        other = net.simple_bind(pt.cpu(), grad_req="write", shared_exec=exe, **SHAPES)
        assert other._prog is not exe._prog and not other._prog.node_devices
        flat = net.simple_bind(pt.cpu(), grad_req="write",
                               group2ctx={"dev1": pt.cpu(0), "dev2": pt.cpu(0)}, **SHAPES)
        assert not flat._prog.node_devices


def test_a_group_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    with pt.cpu():
        net = _build_net(pt)
        with pytest.raises(pt.MXNetError, match="CUDA is not available"):
            net.simple_bind(pt.cpu(), grad_req="write", group2ctx={"dev2": pt.gpu(0)}, **SHAPES)


# ------------------------------------------------- the model-parallel LSTM
def _example():
    """``example/model-parallel-lstm/lstm_layer_split.py`` as a module."""
    path = ROOT / "example" / "model-parallel-lstm" / "lstm_layer_split.py"
    spec = importlib.util.spec_from_file_location("lstm_layer_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_package(fn, pkg):
    """The example's function with ``mx`` bound to ``pkg``."""
    return types.FunctionType(fn.__code__, dict(fn.__globals__, mx=pkg), fn.__name__,
                              fn.__defaults__)


def test_lstm_layer_split_symbol_and_training_match_unsplit_and_jax(cpu1_apart):
    """The example's two-layer LSTM at its defaults (seq 8, vocab 30, embed
    24, hidden 32, batch 16) on a training set of 64: the symbol's JSON is
    JAX's; in each package the split's per-epoch losses over 2 epochs
    equal the single bind's (step 0 within 1e-6, the example asserts 1e-4,
    the rest within 1e-5); the port's equal JAX's (rtol 1e-5). The port's
    split crosses devices here (``cpu:1``)."""
    ex = _example()
    rs = np.random.RandomState(7)
    x = rs.randint(1, 30, (64, 8)).astype("float32")
    y = np.roll(x, -1, axis=1)
    losses = {}
    for pkg in (mxnet_tpu, pt):
        # a fresh name scope: the auto-named nodes' JSON does not depend on
        # what earlier tests in the process built
        with pt.cpu(), pkg.name.NameManager():
            net = _with_package(ex.build_symbol, pkg)(8, 30, 24, 32)
            train = _with_package(ex.train, pkg)
            split = train(net, x, y, {"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)}, 2, 0.05, 16)
            single = train(net, x, y, None, 2, 0.05, 16)
        assert abs(split[0] - single[0]) < 1e-6, (pkg.__name__, split, single)
        np.testing.assert_allclose(split, single, rtol=1e-5, atol=0)
        losses[pkg] = (net.tojson(), split)
    assert losses[pt][0] == losses[mxnet_tpu][0]
    np.testing.assert_allclose(losses[pt][1], losses[mxnet_tpu][1], rtol=1e-5, atol=0)


# ---------------------------------------------------------- NDArray.writable
def test_writable_flag_in_both_packages(mx):
    """A read-only array refuses assignments, slices and ``out=``; its
    views, reshapes and slices carry the flag; a writable one takes them."""
    ro = mx.nd.NDArray(np.arange(6, dtype="float32").reshape(2, 3), ctx=mx.cpu(),
                       writable=False)
    assert not ro.writable
    for view in (ro.reshape((3, 2)), ro[0:1], ro[1], ro.slice(0, 1)):
        assert not view.writable
        with pytest.raises(mx.base.MXNetError, match="trying to write to a read-only NDArray"):
            view[:] = 1.0
    for write in (lambda: ro.__setitem__(slice(None), 0.0),
                  lambda: ro.__setitem__(0, 0.0),
                  lambda: mx.nd.ones((2, 3), ctx=mx.cpu()).copyto(ro),
                  lambda: mx.nd.elemwise_add(ro, ro, out=ro)):
        with pytest.raises(mx.base.MXNetError, match="trying to write to a read-only NDArray"):
            write()
    np.testing.assert_array_equal(ro.asnumpy(), np.arange(6).reshape(2, 3))
    rw = mx.nd.NDArray(np.zeros((2, 3), "float32"), ctx=mx.cpu())
    assert rw.writable and rw[0:1].writable and rw.reshape((6,)).writable
    rw[0:1] = 2.0
    np.testing.assert_array_equal(rw.asnumpy()[0], [2.0, 2.0, 2.0])
