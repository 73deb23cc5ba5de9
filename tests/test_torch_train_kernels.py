"""The port's backward kernels' plain versions and its autograd Functions
(mxnet_tpu_torch/ops/{flash_attention,norm_residual,matmul_bias_act}.py,
ops/nn.py SoftmaxOutput) against the JAX package's Pallas backward kernels
and custom_vjps.

On the CPU each dispatcher runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do. The
inputs are made with numpy from a seed and handed to both. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu.ops import pallas_matmul_bias_act as pm
from mxnet_tpu.ops import pallas_norm_residual as pn
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import matmul_bias_act as mba
from mxnet_tpu_torch.ops import nn as pnn
from mxnet_tpu_torch.ops import norm_residual as nr
from mxnet_tpu_torch.ops.registry import get_op, parse_attrs

torch.set_num_threads(1)  # the tier-1 run shares the host's cores between workers


def _f32(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("T,S,causal", [(16, 16, True), (16, 40, True), (24, 40, False)],
                         ids=["causal_T_eq_S", "causal_S_gt_T", "noncausal"])
def test_flash_attention_bwd_plain_matches_pallas(T, S, causal):
    rs = np.random.RandomState(10)
    BH, D = 4, 32
    q, k, v = _f32(rs, BH, T, D), _f32(rs, BH, S, D), _f32(rs, BH, S, D)
    do = _f32(rs, BH, T, D)
    scale = float(1.0 / np.sqrt(D))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = pa._fwd_call(jq, jk, jv, causal, scale, 8, 8, True)
    jdq, jdk, jdv = pa._bwd_call(jq, jk, jv, jo, jlse, jdo, causal, scale, 8, 8, True)
    before = (fa.dq_launches, fa.dkv_launches)
    dq, dk, dv = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse)[..., 0], _t(do),
                                        causal=causal, scale=scale)
    assert (fa.dq_launches, fa.dkv_launches) == before  # a CPU tensor never launches
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("R", [64, 8], ids=["many_row_blocks", "one_row_block"])
def test_layer_norm_bwd_plain_matches_pallas(R):
    rs = np.random.RandomState(11)
    D = 128
    x, dy = _f32(rs, R, D), _f32(rs, R, D)
    g = rs.uniform(0.5, 1.5, (D,)).astype(np.float32)
    b = rs.uniform(-0.2, 0.2, (D,)).astype(np.float32)
    br = 8  # several partial rows at R = 64, as the TPU grid has them
    _, jmean, jrstd = pn._fwd_call(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5, br,
                                   True)
    ref = pn._bwd_call(jnp.asarray(x), jnp.asarray(g), jmean, jrstd, jnp.asarray(dy), br, True)
    before = nr.bwd_launches
    got = nr.layer_norm_affine_bwd(_t(x), _t(g), _t(jmean)[:, 0], _t(jrstd)[:, 0], _t(dy))
    assert nr.bwd_launches == before
    # the bar of tests/test_pallas_norm_residual.py:49 (f32)
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
        r = np.asarray(r)
        err = np.max(np.abs(a.numpy() - r))
        assert err / (np.max(np.abs(r)) + 1e-9) <= 1e-5, (name, err)


@pytest.mark.parametrize("act", mba.ACTIVATIONS)
def test_matmul_bias_act_bwd_matches_jax_vjp(act):
    rs = np.random.RandomState(12)
    M, K, N = 16, 64, 256
    a, w, b = _f32(rs, M, K), _f32(rs, N, K, scale=0.2), _f32(rs, N, scale=0.1)
    dy = _f32(rs, M, N)
    jy, vjp = jax.vjp(lambda a, w, b: pm.matmul_bias_act(a, w, b, act, 128, 256),
                      jnp.asarray(a), jnp.asarray(w), jnp.asarray(b))
    ta, tw, tb = (_t(x).requires_grad_(True) for x in (a, w, b))
    y = mba.MatmulBiasAct.apply(ta, tw, tb, act)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    for got, want in zip((ta.grad, tw.grad, tb.grad), vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _f64(rs, *shape, scale=1.0):
    return torch.from_numpy(rs.randn(*shape) * scale).requires_grad_(True)


@pytest.mark.parametrize("causal,T,S", [(True, 5, 5), (True, 3, 6), (False, 4, 6)])
def test_flash_attention_function_gradcheck(causal, T, S):
    rs = np.random.RandomState(13)
    q, k, v = _f64(rs, 2, T, 4), _f64(rs, 2, S, 4), _f64(rs, 2, S, 4)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttention.apply(q, k, v, causal, 0.0), (q, k, v))


def test_layer_norm_affine_function_gradcheck():
    rs = np.random.RandomState(14)
    x, g, b = _f64(rs, 5, 7), _f64(rs, 7), _f64(rs, 7)
    assert torch.autograd.gradcheck(lambda x, g, b: nr.LayerNormAffine.apply(x, g, b, 1e-5),
                                    (x, g, b))


@pytest.mark.parametrize("act", mba.ACTIVATIONS)
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_matmul_bias_act_function_gradcheck(act, bias):
    rs = np.random.RandomState(15)
    # relu's kink: keep pre-activations away from 0 so finite differences hold
    a, w = _f64(rs, 4, 3), _f64(rs, 5, 3)
    b = torch.from_numpy(np.sign(rs.randn(5)) * 3.0).requires_grad_(True) if bias else None
    inputs = (a, w, b) if bias else (a, w)
    assert torch.autograd.gradcheck(
        lambda a, w, b=None: mba.MatmulBiasAct.apply(a, w, b, act), inputs)


_SM_CASES = [
    dict(),
    dict(use_ignore=True, ignore_label=2.0, normalization="valid"),
    dict(use_ignore=True, ignore_label=2.0, normalization="batch", grad_scale=0.5),
    dict(multi_output=True, normalization="valid"),
]


@pytest.mark.parametrize("attrs", _SM_CASES, ids=["plain", "ignore_valid", "ignore_batch",
                                                  "multi_output"])
def test_softmax_output_loss_gradient_matches_finite_differences(attrs):
    """SoftmaxOutput's backward ignores its head gradient and returns the
    gradient of the cross-entropy loss it stands for. ``gradcheck`` itself
    requires a backward proportional to the head gradient, so this holds the
    backward against central differences of that loss, in float64, at
    gradcheck's own step and tolerances."""
    rs = np.random.RandomState(16)
    parsed = parse_attrs(get_op("SoftmaxOutput"), attrs)
    if parsed["multi_output"]:
        data, label = _f64(rs, 3, 4, 2), torch.from_numpy(rs.randint(0, 4, (3, 2)) * 1.0)
        axis = 1
    else:
        data, label = _f64(rs, 6, 4), torch.from_numpy(rs.randint(0, 4, (6,)) * 1.0)
        axis = -1

    def loss(d):
        picked = torch.gather(torch.log_softmax(d, dim=axis), axis,
                              label.long().unsqueeze(axis)).squeeze(axis)
        keep = torch.ones_like(label)
        if parsed["use_ignore"]:
            keep = (label != parsed["ignore_label"]).double()
        value = -(picked * keep).sum() * parsed["grad_scale"]
        if parsed["normalization"] == "batch":
            value = value / label.shape[0]
        elif parsed["normalization"] == "valid":
            value = value / keep.sum().clamp(min=1.0)
        return value

    prob = pnn._softmax_output(parsed, data, label)
    head = torch.from_numpy(rs.randn(*prob.shape))  # ignored by the backward
    (got,) = torch.autograd.grad(prob, data, head)
    flat, eps = data.detach().clone().reshape(-1), 1e-6
    want = torch.empty(data.numel(), dtype=torch.float64)
    for i in range(flat.numel()):
        up, down = flat.clone(), flat.clone()
        up[i] += eps
        down[i] -= eps
        want[i] = (loss(up.reshape(data.shape)) - loss(down.reshape(data.shape))) / (2 * eps)
    torch.testing.assert_close(got.reshape(-1), want, rtol=1e-3, atol=1e-5)
