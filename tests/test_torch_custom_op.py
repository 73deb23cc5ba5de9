"""The port's ``Custom`` op, ``operator`` module and imperative ``autograd``
against the JAX package.

Every case of the reference's own ``tests/test_custom_op.py`` runs here on
BOTH packages (fixture ``mx``: the JAX package, or the port inside ``with
cpu():``), with the same user operators registered in each under op types
of this file's own (a package's registry refuses a second registration of
one op type). Then: the user's code runs on the port's NDArrays on the
inputs' device; a Custom node with aux states passes them through; the
op's shape inference asks the prop, not the user's forward; and under
CUDA-graph capture the op raises, naming its op type.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu.autograd  # noqa: F401
import mxnet_tpu.operator  # noqa: F401
import mxnet_tpu.test_utils  # noqa: F401
import mxnet_tpu_torch as pt

torch.set_num_threads(1)


def _register(pkg):
    op = pkg.operator

    @op.register("torch_test_sigmoid")
    class SigmoidProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SigmoidOp()

    class SigmoidOp(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], g * y * (1.0 - y))

    @op.register("torch_test_scale2")
    class Scale2Prop(op.CustomOpProp):
        def __init__(self, factor="2.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            prop = self

            class ScaleOp(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0].asnumpy() * prop.factor)

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * prop.factor)

            return ScaleOp()

    @op.register("torch_test_counted")
    class CountedProp(op.CustomOpProp):
        """x + count, with an aux state ``count`` and two outputs."""

        def list_outputs(self):
            return ["output", "twice"]

        def list_auxiliary_states(self):
            return ["count"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], [[1]]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Counted(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    y = in_data[0].asnumpy() + aux[0].asnumpy()
                    self.assign(out_data[0], req[0], y)
                    self.assign(out_data[1], req[1], 2 * y)
                    CountedProp.seen.append(type(in_data[0]).__module__)

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    g = out_grad[0].asnumpy() + 2 * out_grad[1].asnumpy()
                    self.assign(in_grad[0], req[0], g)

            return Counted()

    CountedProp.seen = []
    return CountedProp


_COUNTED = {mxnet_tpu: _register(mxnet_tpu), pt: _register(pt)}


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


# -------------------------------------- tests/test_custom_op.py, both packages
def test_custom_imperative(mx):
    x = np.random.uniform(-1, 1, (3, 4)).astype("float32")
    out = mx.nd.Custom(mx.nd.array(x), op_type="torch_test_sigmoid").asnumpy()
    np.testing.assert_allclose(out, 1 / (1 + np.exp(-x)), rtol=1e-6)


def test_custom_attr_passthrough(mx):
    x = np.random.uniform(-1, 1, (2, 2)).astype("float32")
    out = mx.nd.Custom(mx.nd.array(x), op_type="torch_test_scale2", factor="3.0").asnumpy()
    np.testing.assert_allclose(out, 3.0 * x, rtol=1e-6)


def test_custom_symbolic_forward_backward(mx):
    tu, sym = mx.test_utils, mx.symbol
    x = np.random.uniform(-1, 1, (3, 3)).astype("float32")
    out = sym.Custom(sym.Variable("data"), op_type="torch_test_sigmoid")
    s = 1 / (1 + np.exp(-x))
    tu.check_symbolic_forward(out, {"data": x}, [s], check_eps=1e-5)
    g = np.full((3, 3), 2.0, "float32")
    tu.check_symbolic_backward(out, {"data": x}, [g],
                               {"data": g * s * (1 - s)}, check_eps=1e-4)


def test_custom_composes_in_graph(mx):
    tu, sym = mx.test_utils, mx.symbol
    x = np.random.uniform(-1, 1, (4, 2)).astype("float32")
    d = sym.Variable("data")
    out = sym.sum(sym.Custom(d * 2.0, op_type="torch_test_sigmoid"))
    tu.check_numeric_gradient(out, {"data": x}, numeric_eps=1e-3, check_eps=2e-2)


def test_custom_under_autograd(mx):
    ag = mx.autograd
    x = mx.nd.array(np.random.uniform(-1, 1, (2, 3)).astype("float32"))
    grads = ag.grad(lambda a: mx.nd.Custom(a, op_type="torch_test_sigmoid"))(x)
    s = 1 / (1 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(grads[0].asnumpy(), s * (1 - s), rtol=1e-5)


# --------------------------------------------------------------- the port's own
def test_aux_states_pass_through_and_outputs_match_jax(mx):
    """Two outputs, an aux state read by the user's forward and left as it
    was; the gradient sums both heads' (JAX's custom_vjp does the same)."""
    sym = mx.symbol
    x = np.random.RandomState(3).randn(2, 3).astype("float32")
    net = sym.Custom(sym.Variable("data"), op_type="torch_test_counted", name="c")
    assert net.list_auxiliary_states() == ["c_count"]
    # both packages number a Custom node's outputs (the reference names them
    # by the prop's list_outputs)
    assert net.list_outputs() == ["c_output0", "c_output1"]
    exe = mx.executor.bind(net, mx.cpu(), {"data": mx.nd.array(x)},
                           args_grad={"data": mx.nd.zeros((2, 3))},
                           aux_states={"c_count": mx.nd.array(np.array([0.5], "float32"))})
    y, y2 = (o.asnumpy() for o in exe.forward(is_train=True))
    exe.backward([mx.nd.array(np.ones((2, 3), "float32"))] * 2)
    np.testing.assert_allclose(y, x + 0.5, rtol=1e-6)
    np.testing.assert_allclose(y2, 2 * (x + 0.5), rtol=1e-6)
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(), np.full((2, 3), 3.0))
    np.testing.assert_array_equal(exe.aux_dict["c_count"].asnumpy(), [0.5])
    # no shape rule reads a Custom prop's aux shapes, in either package
    assert net.infer_shape(data=(5, 7)) == (None, None, None)
    _, out_shapes, _ = net.infer_shape(data=(5, 7), c_count=(1,))
    assert [tuple(s) for s in out_shapes] == [(5, 7), (5, 7)]


def test_the_users_code_gets_the_ports_ndarrays():
    _COUNTED[pt].seen.clear()
    with pt.cpu():
        pt.nd.Custom(pt.nd.array(np.zeros((2, 2), "float32")),
                     pt.nd.array(np.zeros(1, "float32")), op_type="torch_test_counted")
    assert _COUNTED[pt].seen == ["mxnet_tpu_torch.ndarray"]


def test_a_custom_node_under_graph_capture_raises_naming_its_op_type(monkeypatch):
    from mxnet_tpu_torch.ops import custom

    monkeypatch.setattr(custom, "_capturing", lambda: True)
    with pt.cpu():
        x = pt.nd.array(np.zeros((2, 2), "float32"))
        with pytest.raises(pt.MXNetError, match="torch_test_sigmoid.*CUDA-graph capture"):
            pt.nd.Custom(x, op_type="torch_test_sigmoid")
