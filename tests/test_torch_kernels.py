"""The port's kernel modules (mxnet_tpu_torch/ops/{flash_attention,
norm_residual,matmul_bias_act}.py) against the JAX package's Pallas kernels.

On the CPU each dispatcher runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode, as its own tests do. The
inputs are made with numpy from a seed and handed to both. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu.ops import pallas_matmul_bias_act as pm
from mxnet_tpu.ops import pallas_norm_residual as pn
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import matmul_bias_act as mba
from mxnet_tpu_torch.ops import norm_residual as nr

torch.set_num_threads(1)  # the tier-1 run shares the host's cores between workers


def _f32(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("T,S,causal", [(16, 16, True), (16, 40, True), (24, 40, False)],
                         ids=["causal_T_eq_S", "causal_S_gt_T", "noncausal"])
def test_flash_attention_plain_matches_pallas(T, S, causal):
    rs = np.random.RandomState(0)
    BH, D = 4, 32
    q, k, v = _f32(rs, BH, T, D), _f32(rs, BH, S, D), _f32(rs, BH, S, D)
    scale = 1.0 / np.sqrt(D)
    jo, jlse = pa._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                            float(scale), 8, 8, True)
    before = fa.launches
    o, lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    assert fa.launches == before  # a CPU tensor never launches the kernel
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("R", [64, 8], ids=["prefill_rows", "decode_rows"])
def test_layer_norm_plain_matches_pallas(R):
    rs = np.random.RandomState(1)
    D = 128
    x = _f32(rs, R, D)
    g = rs.uniform(0.5, 1.5, (D,)).astype(np.float32)
    b = rs.uniform(-0.2, 0.2, (D,)).astype(np.float32)
    br = pn.choose_block_rows((R, D), 4)
    jy, jmean, jrstd = pn._fwd_call(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                    1e-5, br, True)
    y, mean, rstd = nr.layer_norm_affine(torch.from_numpy(x), torch.from_numpy(g),
                                         torch.from_numpy(b), 1e-5)
    # the bar of tests/test_pallas_norm_residual.py (f32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-6, rtol=0)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0], atol=2e-6, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0], atol=2e-6, rtol=0)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu"])
@pytest.mark.parametrize("M", [128, 8], ids=["prefill_rows", "decode_rows"])
def test_matmul_bias_act_plain_matches_pallas(act, M):
    rs = np.random.RandomState(2)
    K, N = 64, 256
    a, w, b = _f32(rs, M, K), _f32(rs, N, K, scale=0.2), _f32(rs, N, scale=0.1)
    jy = pm.matmul_bias_act(jnp.asarray(a), jnp.asarray(w), jnp.asarray(b), act, 128, 256)
    y = mba.matmul_bias_act(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(b), act)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)


def test_dispatchers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card is refused: the
    dispatchers run the plain version for CPU tensors only."""
    q = torch.zeros((2, 8, 16), device="meta")
    with pytest.raises(MXNetError):
        fa.flash_attention(q, q, q, causal=True)
    x, g = torch.zeros((4, 16), device="meta"), torch.zeros((16,), device="meta")
    with pytest.raises(MXNetError):
        nr.layer_norm_affine(x, g, g)
    with pytest.raises(MXNetError):
        mba.matmul_bias_act(x, torch.zeros((8, 16), device="meta"), None, "relu")


def test_kernel_shape_gates():
    assert fa.supported((4, 16, 128), (4, 16, 128), causal=True)
    assert not fa.supported((4, 16, 129), (4, 16, 129), causal=False)
    assert not fa.supported((4, 16, 64), (4, 8, 64), causal=True)  # causal needs S >= T
    assert nr.supported((7, 1024)) and not nr.supported((7, 1025))
    with pytest.raises(MXNetError):
        fa.flash_attention(torch.zeros(2, 16, 8), torch.zeros(2, 8, 8), torch.zeros(2, 8, 8),
                           causal=True)
