"""The port's training slice against the JAX executor: the zoo transformer's
outputs and every gradient, the grad_req forms, the executor's forward /
backward paths, SoftmaxOutput's loss gradient, and the optimizers.

The JAX reference runs in the forced setting (MXNET_GRAPHREWRITE=on with the
attention, matmul_bias_act and norm_residual lowerings forced), so its
gradients come through the Pallas backward kernels in interpret mode. The
port runs on the CPU, through its kernels' plain versions. Parameters and
inputs are made with numpy from one seed and handed to both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import name as jname
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.ops.registry import parse_attrs as jparse_attrs
from mxnet_tpu_torch import optimizer as popt
from mxnet_tpu_torch.models import transformer as ptf
from mxnet_tpu_torch.ops import norm_residual as nr
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from mxnet_tpu_torch.ops.registry import parse_attrs as pparse_attrs

torch.set_num_threads(1)

CFG = dict(vocab_size=256, num_layers=2, num_heads=2, model_dim=128, ffn_dim=256)
SEQ, BATCH = 16, 8
FORCED = {"MXNET_GRAPHREWRITE": "on",
          "MXNET_FUSED_PATTERNS": "attention=pallas_flash,matmul_bias_act=pallas,"
                                  "norm_residual=pallas"}
INPUTS = ("data", "softmax_label")


def _values(names_shapes, seed=0):
    """Inputs (token ids) and parameters, from one numpy seed."""
    rs = np.random.RandomState(seed)
    out = {}
    for n, shape in names_shapes:
        if n in INPUTS:
            out[n] = rs.randint(0, CFG["vocab_size"], shape).astype(np.float32)
        else:
            out[n] = (rs.randn(*shape) * 0.1).astype(np.float32)
    return out


def _symbols(fn="get_symbol", **kw):
    with jname.NameManager():
        js = getattr(jtf, fn)(**CFG, **kw)
    with pt.NameManager():
        ps = getattr(ptf, fn)(**CFG, **kw)
    return js, ps


@pytest.fixture(scope="module")
def reference():
    """The JAX executor's forward_backward under grad_req write: the values,
    the output and every gradient."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in FORCED.items():
            mp.setenv(k, v)
        mp.delenv("MXNET_FUSED_PATTERNS_INFER", raising=False)
        js, _ = _symbols(seq_len=SEQ)
        exe = js.simple_bind(mx.cpu(), data=(BATCH, SEQ), softmax_label=(BATCH, SEQ))
        vals = _values([(n, a.shape) for n, a in exe.arg_dict.items()])
        for n, a in exe.arg_dict.items():
            a[:] = vals[n]
        out = exe.forward_backward()[0].asnumpy()
        grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()}
    return vals, out, grads


def _port_exe(vals, grad_req="write", ctx=None):
    _, ps = _symbols(seq_len=SEQ)
    exe = ps.simple_bind(ctx or pt.cpu(), grad_req=grad_req, data=(BATCH, SEQ),
                         softmax_label=(BATCH, SEQ))
    for n, a in exe.arg_dict.items():
        a[:] = vals[n]
    return exe


def _assert_grads(got, want, names):
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-5, err_msg=n)


def test_outputs_and_gradients_match_the_jax_executor(reference):
    vals, jout, jgrads = reference
    exe = _port_exe(vals)
    assert exe._prog.pattern_sites == {"attention": 2, "matmul_bias_act": 2,
                                       "norm_residual": 5}
    out = exe.forward_backward()[0].asnumpy()
    np.testing.assert_allclose(out, jout, atol=1e-5, rtol=0)
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()}
    assert set(grads) == set(jgrads)
    _assert_grads(grads, jgrads, [n for n in grads if n not in INPUTS])
    for n in INPUTS:  # float token ids and labels: zeros, as JAX writes them
        assert not grads[n].any() and not jgrads[n].any()


def test_grad_req_add_accumulates(reference):
    vals, _, jgrads = reference
    exe = _port_exe(vals, grad_req="add")
    exe.forward(is_train=True)
    exe.backward()
    exe.backward()  # no graph left: runs the training forward again first
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()}
    _assert_grads(grads, {n: 2 * g for n, g in jgrads.items()},
                  [n for n in grads if n not in INPUTS])


def test_grad_req_null_leaves_the_array_alone(reference):
    vals, _, jgrads = reference
    _, ps = _symbols(seq_len=SEQ)
    args = _port_exe(vals).arg_dict
    sentinel = {n: pt.ndarray.zeros(a.shape, ctx=pt.cpu()) for n, a in args.items()}
    for a in sentinel.values():
        a[:] = 7.0
    reqs = ["null" if n.startswith("layer1_") else "write" for n in ps.list_arguments()]
    exe = ps.bind(pt.cpu(), args, args_grad=sentinel, grad_req=reqs)
    exe.forward_backward()
    for n, g in exe.grad_dict.items():
        if n.startswith("layer1_"):
            assert (g.asnumpy() == 7.0).all(), n
        elif n not in INPUTS:
            np.testing.assert_allclose(g.asnumpy(), jgrads[n], rtol=1e-4, atol=1e-5,
                                       err_msg=n)


def test_grad_req_dict_form(reference):
    vals, _, jgrads = reference
    wanted = {"lm_head_weight": "write", "layer0_ln1_gamma": "write", "data": "write"}
    exe = _port_exe(vals, grad_req=wanted)
    exe.forward_backward()
    assert {n for n, g in exe.grad_dict.items() if g is not None} == set(wanted)
    _assert_grads({n: exe.grad_dict[n].asnumpy() for n in wanted}, jgrads,
                  ["lm_head_weight", "layer0_ln1_gamma"])
    assert not exe.grad_dict["data"].asnumpy().any()


def test_forward_then_backward_equals_forward_backward(reference):
    vals, _, _ = reference
    a, b = _port_exe(vals), _port_exe(vals)
    out_a = a.forward(is_train=True)[0].asnumpy()
    a.backward()
    out_b = b.forward_backward()[0].asnumpy()
    np.testing.assert_array_equal(out_a, out_b)
    for n in a.grad_dict:
        np.testing.assert_array_equal(a.grad_dict[n].asnumpy(), b.grad_dict[n].asnumpy())


def test_inference_forward_keeps_no_graph(reference):
    vals, jout, _ = reference
    exe = _port_exe(vals)
    out = exe.forward(is_train=False)[0]
    assert exe._graph is None and not out._tensor().requires_grad
    np.testing.assert_allclose(out.asnumpy(), jout, atol=1e-5, rtol=0)


def test_backward_with_head_gradients_on_a_graph_without_a_loss(monkeypatch):
    """The prefill graph's outputs are logits and every layer's K and V: the
    head gradients come from the caller, one per output."""
    for k, v in FORCED.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MXNET_FUSED_PATTERNS_INFER", raising=False)
    js, ps = _symbols("get_prefill_symbol", prefill_len=SEQ)
    jexe = js.simple_bind(mx.cpu(), data=(2, SEQ))
    pexe = ps.simple_bind(pt.cpu(), data=(2, SEQ))
    vals = _values([(n, a.shape) for n, a in jexe.arg_dict.items()], seed=1)
    for exe in (jexe, pexe):
        for n, a in exe.arg_dict.items():
            a[:] = vals[n]
    outs = jexe.forward(is_train=True)
    rs = np.random.RandomState(2)
    heads = [rs.randn(*o.shape).astype(np.float32) for o in outs]
    jexe.backward([mx.nd.array(h) for h in heads])
    pouts = pexe.forward(is_train=True)
    for po, jo in zip(pouts, outs):
        np.testing.assert_allclose(po.asnumpy(), jo.asnumpy(), atol=1e-5, rtol=0)
    pexe.backward([pt.ndarray.NDArray(torch.from_numpy(h), pt.cpu()) for h in heads])
    for n in pexe.grad_dict:
        np.testing.assert_allclose(pexe.grad_dict[n].asnumpy(), jexe.grad_dict[n].asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_gradient_flows_through_a_site_that_runs_unfused():
    """A CPU LayerNorm site whose rows the kernel does not take (1100 wide)
    runs the unfused ops: its interior nodes materialise outside the pattern
    and still carry their gradients."""
    net = ptf._layer_norm(pt.sym.Variable("x"), "ln", 1100)
    exe = net.simple_bind(pt.cpu(), x=(4, 1100))
    assert exe._prog.pattern_sites == {"norm_residual": 1}
    rs = np.random.RandomState(5)
    vals = {n: rs.randn(*a.shape).astype(np.float32) for n, a in exe.arg_dict.items()}
    for n, a in exe.arg_dict.items():
        a[:] = vals[n]
    head = rs.randn(4, 1100).astype(np.float32)
    exe.forward(is_train=True)
    exe.backward([pt.ndarray.NDArray(torch.from_numpy(head), pt.cpu())])
    x, g, b = (torch.from_numpy(vals[n]).requires_grad_(True) for n in ("x", "ln_gamma",
                                                                        "ln_beta"))
    y, _, _ = nr.layer_norm_affine_plain(x, g, b)
    y.backward(torch.from_numpy(head))
    for n, t in (("x", x), ("ln_gamma", g), ("ln_beta", b)):
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(), t.grad.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("attrs", [
    dict(),
    dict(normalization="batch"),
    dict(normalization="valid", use_ignore=True, ignore_label=3.0),
    dict(normalization="null", use_ignore=True, ignore_label=3.0, grad_scale=0.25),
    dict(normalization="batch", use_ignore=True, ignore_label=3.0),
    dict(normalization="valid", multi_output=True),
], ids=["null", "batch", "ignore_valid", "ignore_null", "ignore_batch", "multi_output"])
def test_softmax_output_gradient_matches_the_jax_op(attrs):
    rs = np.random.RandomState(6)
    if attrs.get("multi_output"):
        data = rs.randn(4, 5, 3).astype(np.float32)
        label = rs.randint(0, 5, (4, 3)).astype(np.float32)
    else:
        data = rs.randn(12, 5).astype(np.float32)
        label = rs.randint(0, 5, (12,)).astype(np.float32)
    head = rs.randn(*data.shape).astype(np.float32)  # ignored by both
    jop = jget_op("SoftmaxOutput")
    jprob, vjp = jax.vjp(lambda d: jop.fn(jparse_attrs(jop, attrs), d, jnp.asarray(label)),
                         jnp.asarray(data))
    (jgrad,) = vjp(jnp.asarray(head))
    pop = pget_op("SoftmaxOutput")
    d = torch.from_numpy(data).requires_grad_(True)
    (prob,), _ = pop.apply(pparse_attrs(pop, attrs), [d, torch.from_numpy(label)])
    prob.backward(torch.from_numpy(head))
    np.testing.assert_allclose(prob.detach().numpy(), np.asarray(jprob), atol=1e-6, rtol=0)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=0)


def _optimizer_run(make, steps=3):
    """``steps`` updates of the same parameters and gradients through the JAX
    updater and the port's; returns both packages' final weights."""
    rs = np.random.RandomState(7)
    names = ["fc_weight", "fc_bias", "ln_gamma", "ln_beta"]
    shapes = [(6, 4), (6,), (4,), (4,)]
    init = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) * 3 for s in shapes] for _ in range(steps)]
    idx2name = dict(enumerate(names))
    out = []
    for pkg, nd in ((mx.optimizer, None), (popt, pt.ndarray)):
        updater = pkg.get_updater(make(pkg, idx2name))
        if nd is None:
            weights = [mx.nd.array(w) for w in init]
            wrap = mx.nd.array
        else:
            weights = [nd.NDArray(torch.from_numpy(w.copy()), pt.cpu()) for w in init]
            wrap = lambda g: nd.NDArray(torch.from_numpy(g), pt.cpu())  # noqa: E731
        for step in grads:
            for i, g in enumerate(step):
                updater(i, wrap(g), weights[i])
        out.append([w.asnumpy() for w in weights])
    return out


@pytest.mark.parametrize("kind", ["sgd_momentum_wd", "sgd_clip", "adam_wd"])
def test_optimizer_steps_match_the_jax_package(kind):
    def make(pkg, idx2name):
        if kind == "sgd_momentum_wd":
            return pkg.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-2,
                              rescale_grad=1.0 / 8, param_idx2name=idx2name)
        if kind == "sgd_clip":
            return pkg.create("sgd", learning_rate=0.1, clip_gradient=0.5,
                              param_idx2name=idx2name)
        return pkg.create("adam", learning_rate=0.01, wd=1e-2, rescale_grad=0.5,
                          param_idx2name=idx2name)

    jw, pw = _optimizer_run(make)
    for j, p in zip(jw, pw):
        np.testing.assert_allclose(p, j, atol=1e-5, rtol=0)
