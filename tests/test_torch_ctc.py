"""The port's ``WarpCTC`` op and ``ctc_nll`` (``ops/ctc.py``) against the JAX
package.

Every case of the reference's own ``tests/test_ctc.py`` runs here on BOTH
packages (fixture ``mx``: the JAX package, or the port inside ``with
cpu():``; ``ctc_nll`` on each package's arrays). Then parity on the same
numpy inputs: the per-sample loss (rtol 1e-5) and the op's gradient
(atol = rtol = 1e-5) with padded labels, repeats and an infeasible row.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu
import mxnet_tpu_torch as pt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg

torch.set_num_threads(1)


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


def _ctc_nll(mx, lp, lab, lens):
    """The package's ``ctc_nll`` on its own arrays, as numpy."""
    if mx is pt:
        from mxnet_tpu_torch.ops.ctc import ctc_nll

        return ctc_nll(torch.from_numpy(lp), torch.from_numpy(lab),
                       torch.as_tensor(np.asarray(lens))).numpy()
    from mxnet_tpu.ops.ctc import ctc_nll

    return np.asarray(ctc_nll(jnp.asarray(lp), jnp.asarray(lab), jnp.asarray(lens)))


# -------------------------------------------- tests/test_ctc.py, both packages
def _brute_force_nll(log_probs, label, blank=0):
    """-log P(label) by enumerating every length-T path and collapsing it
    (remove repeats, then blanks)."""
    T, C = log_probs.shape
    total = -np.inf
    for path in itertools.product(range(C), repeat=T):
        collapsed = []
        prev = None
        for s in path:
            if s != prev and s != blank:
                collapsed.append(s)
            prev = s
        if collapsed == list(label):
            lp = sum(log_probs[t, s] for t, s in enumerate(path))
            total = np.logaddexp(total, lp)
    return -total


@pytest.mark.parametrize("label", [[1, 2], [1, 1], [2], []])
def test_ctc_nll_matches_brute_force(mx, label):
    rs = np.random.RandomState(0)
    T, C = 4, 3
    logits = rs.randn(T, 1, C).astype("float32")
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    L = max(len(label), 1)
    lab = np.zeros((1, L), "int32")
    lab[0, : len(label)] = label
    got = float(_ctc_nll(mx, lp, lab, [len(label)])[0])
    want = _brute_force_nll(lp[:, 0], label)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ctc_nll_batch_and_padding(mx):
    """Padded rows must match their unpadded singletons."""
    rs = np.random.RandomState(1)
    T, C = 5, 4
    logits = rs.randn(T, 2, C).astype("float32")
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lab = np.array([[1, 2, 3], [2, 0, 0]], "int32")
    lens = np.array([3, 1])
    got = _ctc_nll(mx, lp, lab, lens)
    for b in (0, 1):
        want = _brute_force_nll(lp[:, b], list(lab[b][: lens[b]]))
        np.testing.assert_allclose(got[b], want, rtol=1e-5)


def _bind(mx, T, B, C, L):
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    out = mx.sym.WarpCTC(data=data, label=label, input_length=T, label_length=L)
    return out.simple_bind(ctx=mx.cpu(), data=(T * B, C), label=(B, L), grad_req="write")


def test_forward_is_softmax(mx):
    T, B, C, L = 3, 2, 4, 2
    ex = _bind(mx, T, B, C, L)
    rs = np.random.RandomState(0)
    x = rs.randn(T * B, C).astype("float32")
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = np.array([[1, 2], [3, 0]], "float32")
    ex.forward(is_train=False)
    p = ex.outputs[0].asnumpy()
    want = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    np.testing.assert_allclose(p, want, rtol=1e-5)


def test_gradient_matches_finite_difference(mx):
    T, B, C, L = 4, 2, 3, 2
    rs = np.random.RandomState(2)
    x = rs.randn(T * B, C).astype("float64").astype("float32")
    lab = np.array([[1, 2], [2, 0]], "float32")

    ex = _bind(mx, T, B, C, L)
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = lab
    ex.forward(is_train=True)
    ex.backward()
    g = ex.grad_dict["data"].asnumpy()

    def nll(xv):
        lp = xv.reshape(T, B, C)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        tot = 0.0
        for b in range(B):
            labels = [int(v) for v in lab[b] if v != 0]
            tot += _brute_force_nll(lp[:, b], labels)
        return tot

    eps = 1e-3
    for idx in [(0, 0), (3, 2), (5, 1)]:
        xp = x.copy(); xp[idx] += eps
        xm = x.copy(); xm[idx] -= eps
        fd = (nll(xp) - nll(xm)) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=2e-2, atol=2e-3)


def test_toy_ocr_converges(mx):
    """A linear model on fixed per-frame features must learn a target
    transcription (the warpctc toy example's economics)."""
    T, B, C, L = 6, 4, 5, 3
    rs = np.random.RandomState(3)
    X = rs.randn(B, T, 8).astype("float32")
    Y = np.zeros((B, L), "float32")
    for b in range(B):
        Y[b] = rs.choice(np.arange(1, C), L, replace=False)

    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    net = mx.sym.FullyConnected(data, num_hidden=C, name="fc")
    net = mx.sym.WarpCTC(data=net, label=label, input_length=T, label_length=L)
    ex = net.simple_bind(ctx=mx.cpu(), data=(T * B, 8), label=(B, L), grad_req="write")
    rs2 = np.random.RandomState(0)
    for k, v in ex.arg_dict.items():
        if k not in ("data", "label"):
            v[:] = rs2.normal(0, 0.1, v.shape)
    x_flat = X.transpose(1, 0, 2).reshape(T * B, 8)  # time-major rows
    ex.arg_dict["data"][:] = x_flat
    ex.arg_dict["label"][:] = Y
    for step in range(300):
        ex.forward(is_train=True)
        ex.backward()
        for k, g in ex.grad_dict.items():
            if k not in ("data", "label") and g is not None:
                ex.arg_dict[k][:] = ex.arg_dict[k].asnumpy() - 0.5 * g.asnumpy()
    ex.forward(is_train=False)
    p = ex.outputs[0].asnumpy().reshape(T, B, C)
    hits = 0
    for b in range(B):
        path = p[:, b].argmax(-1)
        dec = []
        prev = None
        for s in path:
            if s != prev and s != 0:
                dec.append(s)
            prev = s
        hits += dec == [int(v) for v in Y[b]]
    assert hits >= B - 1, "toy CTC training failed: %d/%d decoded" % (hits, B)


def test_infeasible_label_gets_zero_gradient(mx):
    """warp-ctc contract: a label needing more frames than input_length
    contributes zero loss and zero gradient."""
    T, B, C, L = 2, 1, 3, 2
    ex = _bind(mx, T, B, C, L)
    rs = np.random.RandomState(4)
    ex.arg_dict["data"][:] = rs.randn(T * B, C).astype("float32")
    ex.arg_dict["label"][:] = np.array([[1, 1]], "float32")  # needs T>=3
    ex.forward(is_train=True)
    ex.backward()
    g = ex.grad_dict["data"].asnumpy()
    np.testing.assert_allclose(g, 0.0, atol=1e-8)


# ------------------------------------------------------------- parity with JAX
def test_loss_and_gradient_match_jax_with_padding_repeats_and_an_infeasible_row():
    T, B, C, L = 6, 4, 6, 4
    rs = np.random.RandomState(9)
    x = rs.randn(T * B, C).astype(np.float32)
    # blanks inside and at the end, a repeat, a full row, and a row that needs
    # 7 frames (4 symbols, 3 blanks between the repeats): infeasible at T = 6
    lab = np.array([[1, 0, 2, 0], [3, 3, 0, 0], [1, 2, 3, 4], [5, 5, 5, 5]], np.float32)
    from mxnet_tpu.ops.ctc import _compact_labels as jcompact, ctc_nll as jnll
    from mxnet_tpu_torch.ops.ctc import _compact_labels as pcompact, ctc_nll as pnll

    lp = x.reshape(T, B, C) - np.log(np.exp(x.reshape(T, B, C)).sum(-1, keepdims=True))
    jc, jl = jcompact(jnp.asarray(lab.astype(np.int32)), 0)
    pc, pl = pcompact(torch.from_numpy(lab.astype(np.int32)), 0)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(pnll(torch.from_numpy(lp), pc, pl).numpy(),
                               np.asarray(jnll(jnp.asarray(lp), jc, jl)), rtol=1e-5)
    attrs = {"input_length": str(T), "label_length": str(L)}
    jop, pop = jreg.get_op("WarpCTC"), preg.get_op("WarpCTC")
    _, vjp = jax.vjp(lambda d: jop.apply(jreg.parse_attrs(jop, attrs),
                                         [d, jnp.asarray(lab)])[0][0], jnp.asarray(x))
    head = rs.randn(T * B, C).astype(np.float32)  # ignored by both
    (jg,) = vjp(jnp.asarray(head))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out = pop.apply(preg.parse_attrs(pop, attrs), [xt, torch.from_numpy(lab)])[0][0]
    (pg,) = torch.autograd.grad(out, [xt], torch.from_numpy(head))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5)
    assert not pg.numpy()[3::B].any()  # the infeasible row: no gradient
