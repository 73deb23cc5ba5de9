"""The port's fused conv+BN (mxnet_tpu_torch/ops/conv_bn.py) and the
BatchNorm autograd Functions (ops/nn.py, fusion.py) against the JAX
package's Pallas kernels and custom_vjps.

On the CPU each dispatcher runs its kernel's plain PyTorch version; the JAX
side runs ``_conv_block_fwd_impl`` and ``_conv_block_bwd_impl`` in interpret
mode, as its own tests do. The inputs are made with numpy from a seed and
handed to both. The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_conv_bn as pcb
from mxnet_tpu_torch import fusion as pfusion
from mxnet_tpu_torch.ops import conv_bn as cb
from mxnet_tpu_torch.ops import nn as pnn

torch.set_num_threads(1)  # the tier-1 run shares the host's cores between workers

B, K, N = 2, 16, 24


def _case(kernel, stride, prologue, res, seed=0):
    """Inputs of one call, from a numpy seed: x (B, K, H, W) with an odd grid
    for stride 2 (the ceil-div path), He-scaled w, and the optional
    scale/shift (K,) and residual."""
    rs = np.random.RandomState(seed)
    H = W = 9 if stride == 2 else 8
    x = rs.randn(B, K, H, W).astype(np.float32)
    w = (rs.randn(N, K, kernel, kernel) / np.sqrt(K * kernel * kernel)).astype(np.float32)
    scale = shift = r = None
    if prologue != "none":
        scale = rs.uniform(0.5, 1.5, K).astype(np.float32)
        shift = rs.uniform(-0.3, 0.3, K).astype(np.float32)
    Ho, Wo = pcb.strided_dims(H, W, (stride, stride)) if kernel == 1 else (H, W)
    if res:
        r = rs.randn(B, N, Ho, Wo).astype(np.float32)
    cots = (rs.randn(B, N, Ho, Wo).astype(np.float32), rs.randn(N).astype(np.float32),
            (rs.randn(N) * 0.1).astype(np.float32))
    return x, w, scale, shift, r, cots


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# (kernel, stride) the gate takes x prologue (none, affine, affine + relu) x residual
CASES = [pytest.param(k, s, p, r, id="%dx%d-s%d-%s-%s" % (k, k, s, p, "res" if r else "nores"))
         for k, s in ((1, 1), (1, 2), (3, 1))
         for p in ("none", "relu") for r in (False, True)]
CASES += [pytest.param(3, 1, "affine", True, id="3x3-s1-affine-res"),
          pytest.param(1, 2, "affine", False, id="1x1-s2-affine-nores")]


@pytest.mark.parametrize("kernel,stride,prologue,res", CASES)
def test_conv_block_plain_matches_pallas(kernel, stride, prologue, res):
    x, w, scale, shift, r, (dc, ds, dq) = _case(kernel, stride, prologue, res)
    st, relu = (stride, stride), prologue == "relu"
    kw = dict(kernel_hw=(kernel, kernel), stride=st, relu=relu, interpret=True)
    jc, js, jq = pcb._conv_block_fwd_impl(_j(x), _j(w), _j(scale), _j(shift), _j(r), **kw)
    before = (cb.launches, cb.infer_launches, cb.bwd_launches)
    c, s, q = cb.conv_block(_t(x), _t(w), _t(scale), _t(shift), _t(r), st, relu)
    # c: K·taps-long f32 dot products (at most 144 terms); the statistics:
    # B·H'W'-long f32 sums (at most 162 terms) of values up to ~10
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-4)
    if not res:  # the stats-free variant (emit_stats=False, conv_block_infer)
        ji = pcb._conv_block_fwd_impl(_j(x), _j(w), _j(scale), _j(shift), None,
                                      emit_stats=False, **kw)
        ci = cb.conv_block_infer(_t(x), _t(w), _t(scale), _t(shift), st, relu)
        np.testing.assert_allclose(ci.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    jb = pcb._conv_block_bwd_impl(_j(x), _j(w), _j(scale), _j(shift), jc, _j(dc), _j(ds),
                                  _j(dq), None, kernel_hw=(kernel, kernel), stride=st,
                                  relu=relu, has_res=res, interpret=True)
    pb = cb.conv_block_bwd(_t(x), _t(w), _t(scale), _t(shift), _t(np.asarray(jc)), _t(dc),
                           _t(ds), _t(dq), st, relu, res)
    assert (cb.launches, cb.infer_launches, cb.bwd_launches) == before  # CPU: no launch
    # dx: N·taps-long sums; dw, dscale, dshift: B·H'W'-long sums of products
    # of values up to ~10; dres: elementwise
    for name, got, want in zip(("dx", "dw", "dscale", "dshift", "dres"), pb, jb):
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4,
                                       err_msg=name)
    if stride == 2:  # dx lives on the sampled positions only
        assert not pb[0].numpy()[:, :, 1::2].any() and not pb[0].numpy()[:, :, :, 1::2].any()


@pytest.mark.parametrize("kernel,stride,prologue,res", [
    (3, 1, "relu", True), (1, 2, "relu", False), (1, 1, "none", True)],
    ids=["3x3-relu-res", "1x1-s2-relu", "1x1-bare-res"])
def test_conv_block_function_gradcheck(kernel, stride, prologue, res):
    """ConvBlock's backward (the plain backward on the CPU) is the gradient
    of its forward, all three outputs, in float64."""
    x, w, scale, shift, r, _ = _case(kernel, stride, prologue, res, seed=3)
    x = x[:, :8]  # K = 8: a small gradcheck
    w = w[:, :8, :, :][:6]
    scale = None if scale is None else scale[:8]
    shift = None if shift is None else shift[:8]
    r = None if r is None else r[:, :6]
    ins = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
           for a in (x, w, scale, shift, r) if a is not None]
    st, relu = (stride, stride), prologue == "relu"

    def fn(*a):
        it = iter(a)
        xx, ww = next(it), next(it)
        sc = next(it) if scale is not None else None
        sh = next(it) if scale is not None else None
        rr = next(it) if r is not None else None
        return cb.ConvBlock.apply(xx, ww, sc, sh, rr, st, relu)

    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-5)


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_and_normalize_functions_gradcheck(fix_gamma):
    rs = np.random.RandomState(4)
    x, g, b = (torch.from_numpy(a).requires_grad_(True) for a in
               (rs.randn(3, 4, 5, 2), rs.uniform(0.5, 1.5, 4), rs.randn(4)))
    assert torch.autograd.gradcheck(
        lambda x, g, b: pnn._BatchNormTrain.apply(x, g, b, 1e-3, fix_gamma), (x, g, b))
    assert torch.autograd.gradcheck(pfusion._Normalize.apply, (x, g, b))


# (x, w, stride): the gate's edges at small shapes; JAX's VMEM budget admits
# every one its structural gate admits here (N a multiple of 8, as JAX's
# channel stripes need and the zoo's widths are)
GATE = [((2, 8, 8, 8), (16, 8, 1, 1), (1, 1)), ((2, 8, 9, 9), (16, 8, 1, 1), (2, 2)),
        ((2, 16, 8, 8), (8, 16, 3, 3), (1, 1)), ((2, 64, 7, 7), (256, 64, 1, 1), (1, 1)),
        ((1, 8, 3, 3), (8, 8, 1, 1), (1, 1)), ((1, 8, 4, 4), (8, 8, 1, 1), (2, 2)),
        ((1, 8, 5, 5), (8, 8, 1, 1), (2, 2)), ((2, 12, 8, 8), (16, 12, 1, 1), (1, 1)),
        ((2, 3, 32, 32), (64, 3, 3, 3), (1, 1)), ((2, 8, 8, 8), (16, 8, 3, 3), (2, 2)),
        ((2, 8, 8, 8), (16, 8, 1, 1), (3, 3)), ((2, 8, 8, 8), (16, 8, 5, 5), (1, 1)),
        ((2, 8, 8, 8), (16, 8, 1, 3), (1, 1)), ((2, 8, 2, 2), (16, 8, 3, 3), (1, 1))]


@pytest.mark.parametrize("x_shape,w_shape,stride", GATE)
def test_shape_gate_matches_jax_plan_blocks(x_shape, w_shape, stride):
    want = [pcb.plan_blocks(x_shape, w_shape, stride, itemsize=4, prologue=p, res=r) is not None
            for p in (False, True) for r in (False, True)]
    assert want == [cb.supported(x_shape, w_shape, stride)] * 4
