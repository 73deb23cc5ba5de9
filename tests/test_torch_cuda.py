"""The port's CUDA kernels on the card: each against its plain version at
ragged shapes, and the dispatchers' refusals. Marked ``cuda``; on a host
without a card every test skips. This file imports nothing of JAX, so on a
card host without JAX it runs with the JAX suite's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ptf
from mxnet_tpu_torch.ops import conv_bn as cb
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import matmul_bias_act as mba
from mxnet_tpu_torch.ops import matmul_stats as ms
from mxnet_tpu_torch.ops import norm_residual as nr

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _randn(dev, *shape, scale=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + seed)
    return torch.randn(*shape, generator=gen, device=dev) * scale


# ragged tiles, the prefill's (64, 128, 128, 64) and the training step's
# (64, 256, 256, 64) causal shapes, head widths that are not a multiple of 8
# (36) and not of 4 (13: 4-byte copies), both widths the kernel is built
# for (64 and 128), and bases 4 bytes past 16-byte alignment (4-byte copies)
@pytest.mark.parametrize("BH,T,S,D,causal,offset", [
    (2, 1, 1, 8, True, 0), (3, 33, 33, 64, True, 0), (2, 17, 95, 128, True, 0),
    (2, 40, 9, 72, False, 0), (64, 128, 128, 64, True, 0), (64, 256, 256, 64, True, 0),
    (3, 70, 70, 36, True, 0), (2, 45, 77, 13, True, 0), (2, 29, 50, 13, False, 0),
    (3, 75, 75, 56, True, 1), (3, 75, 41, 100, False, 1)])
def test_flash_attention_kernel_matches_plain(dev, BH, T, S, D, causal, offset):
    q, k, v = (_shifted(x, offset) for x in (_randn(dev, BH, T, D), _randn(dev, BH, S, D),
                                              _randn(dev, BH, S, D)))
    before = fa.launches
    o, lse = fa.flash_attention(q, k, v, causal=causal)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
    assert fa.launches == before + 1
    torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("R,D", [(1, 1), (3, 31), (65, 513), (9, 1024)])
def test_layer_norm_kernel_matches_plain(dev, R, D):
    x, g, b = _randn(dev, R, D), _randn(dev, D), _randn(dev, D)
    for got, want in zip(nr.layer_norm_affine(x, g, b), nr.layer_norm_affine_plain(x, g, b)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (8, 512, 2048), (65, 17, 129)])
@pytest.mark.parametrize("act", mba.ACTIVATIONS)
def test_matmul_bias_act_kernel_matches_plain(dev, M, K, N, act):
    a, w, b = _randn(dev, M, K), _randn(dev, N, K, scale=1 / math.sqrt(K)), _randn(dev, N)
    for bias in (b, None):
        torch.testing.assert_close(mba.matmul_bias_act(a, w, bias, act),
                                   mba.matmul_bias_act_plain(a, w, bias, act),
                                   atol=1e-4, rtol=1e-5)


# (M, K, N): decode, M around the small-M schedule's 32-row groups and around
# the crossover, the prefill; K % 4 != 0 on both sides (4-byte copies), N not
# a multiple of the tile
@pytest.mark.parametrize("M,K,N", [(8, 512, 2048), (31, 512, 300), (32, 130, 64),
                                   (33, 512, 2048), (mba.SMALL_M_MAX, 512, 2048),
                                   (mba.SMALL_M_MAX + 1, 512, 2048), (1024, 512, 2048),
                                   (5, 33, 70), (130, 65, 3), (64, 70, 129), (77, 200, 130)])
def test_matmul_bias_act_schedules_match_plain(dev, M, K, N):
    a, w, b = _randn(dev, M, K), _randn(dev, N, K, scale=1 / math.sqrt(K)), _randn(dev, N)
    want = mba.matmul_bias_act_plain(a, w, b, "relu")
    from mxnet_tpu_torch import ops
    ops.reset_launch_counts()
    got = mba.matmul_bias_act(a, w, b, "relu")
    picked = mba._schedule(M, N, K)
    assert ops.schedule_counts()["matmul_bias_act." + picked] == 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    # the schedule the dispatcher did not pick, where it takes the shape
    for other in mba.SCHEDULES:
        if other != picked and (other == "tiles" or mba._small_m_takes(M, K)):
            c = torch.empty_like(want)
            torch.testing.assert_close(mba._launch(a, w, b, "relu", c, other), want, atol=1e-4,
                                       rtol=1e-5)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = _randn(dev, 8, 16)
    with pytest.raises(MXNetError, match="contiguous"):
        mba.matmul_bias_act(_randn(dev, 16, 8).t(), x, None, "relu")
    with pytest.raises(MXNetError, match="float32"):
        nr.layer_norm_affine(x.double(), x[0].double(), x[0].double())
    q = _randn(dev, 2, 8, 16)
    with pytest.raises(MXNetError, match="one CUDA device"):
        fa.flash_attention(q, q.cpu(), q, causal=False)


@pytest.mark.parametrize("which", ["attention", "norm_residual"])
def test_bound_site_the_kernel_does_not_take_raises(dev, which):
    """A matched site whose shapes the kernel does not take (head width
    160, rows of 1100) raises on the card; it never runs unfused there."""
    if which == "attention":
        q, k, v = (pt.sym.Variable(n) for n in "qkv")
        net = pt.sym.MultiHeadAttention(query=q, key=k, value=v, causal=True)
        shapes = {n: (1, 2, 8, 160) for n in "qkv"}
    else:
        net, shapes = ptf._layer_norm(pt.sym.Variable("x"), "ln", 1100), {"x": (4, 1100)}
    exe = net.simple_bind(pt.gpu(0), **shapes)
    assert exe._prog.pattern_sites == {which: 1}
    with pytest.raises(MXNetError, match="not taken"):
        exe.forward()


def _shifted(x, offset):
    """``x`` copied into a view ``offset`` floats into its storage (for
    ``offset`` 1, a base that is not 16-byte aligned)."""
    buf = torch.empty(x.numel() + offset, device=x.device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(x.shape)


def _bwd_inputs(dev, BH, T, S, D, causal, offset=0):
    """q, k, v, dO (each ``_shifted`` by ``offset``) and the forward
    kernel's O and lse."""
    q, k, v, do = (_shifted(_randn(dev, BH, n, D, seed=i), offset)
                   for i, n in enumerate((T, S, S, T)))
    o, lse = fa.flash_attention(q, k, v, causal=causal)
    return q, k, v, o, lse, do


def _bwd_case(dev, BH, T, S, D, causal, offset=0):
    """Inputs of one backward pass (``_bwd_inputs``'s, with δ and the scale)."""
    q, k, v, o, lse, do = _bwd_inputs(dev, BH, T, S, D, causal, offset)
    delta = (do * o).sum(dim=-1)
    return (q, k, v, lse, do, delta, causal, 1.0 / math.sqrt(D))


# the training step's shape (64, 256, 256, 64) causal, ragged tiles, head
# widths that are not a multiple of 8 (36, 56, 100) and not of 4 (13, 4-byte
# copies), both widths the kernels are built for (64 and 128) on ragged
# causal and non-causal shapes, and bases 4 bytes past 16-byte alignment
# (4-byte copies)
@pytest.mark.parametrize("BH,T,S,D,causal,offset", [
    (2, 1, 1, 8, True, 0), (3, 33, 33, 64, True, 0), (2, 17, 95, 128, True, 0),
    (2, 40, 9, 72, False, 0), (2, 64, 64, 64, True, 0), (64, 256, 256, 64, True, 0),
    (3, 70, 70, 36, True, 0), (2, 45, 77, 13, True, 0), (2, 29, 50, 13, False, 0),
    (3, 75, 75, 56, True, 0), (3, 75, 41, 56, False, 0), (3, 75, 75, 56, True, 1),
    (3, 75, 75, 100, True, 0), (3, 75, 41, 100, False, 0), (3, 75, 75, 100, True, 1)])
def test_flash_attention_bwd_kernels_match_plain(dev, BH, T, S, D, causal, offset):
    q, k, v, o, lse, do = _bwd_inputs(dev, BH, T, S, D, causal, offset)
    before = (fa.dq_launches, fa.dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


def test_flash_attention_bwd_kernels_match_float64(dev):
    """The training shape against the plain version in float64 on the same
    inputs (q, k, v, dO and the forward kernel's O and lse): dQ, dK and dV
    within 1e-5, a tenth of the smoke's 1e-4. The kernels' products are
    3xTF32 with a fresh accumulator a step, as accurate as f32 ones: the
    numpy emulation of their arithmetic (test_torch_tf32x3.py) keeps them
    within a tenth of 1e-4 of float64 at this shape, where one TF32 pass
    misses 1e-4."""
    BH, T, D = 64, 256, 64
    q, k, v, do = (_randn(dev, BH, T, D, seed=i) for i in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(*(t.double() for t in (q, k, v, o, lse, do)),
                                        causal=True)
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 1e-5


def test_flash_attention_kernel_matches_float64(dev):
    """The training shape against the plain version in float64 on the same
    inputs: O and lse within 1e-6, a tenth of the smoke's 1e-5. The kernel's
    products are 3xTF32 with a fresh accumulator a step, as accurate as f32
    ones: the numpy emulation of its arithmetic (test_torch_tf32x3.py) keeps
    them within a tenth of 1e-5 of float64 at this shape, where one TF32
    pass misses 1e-5."""
    BH, T, D = 64, 256, 64
    q, k, v = (_randn(dev, BH, T, D, seed=i) for i in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(*(t.double() for t in (q, k, v)), causal=True)
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 1e-6


def test_flash_attention_and_layer_norm_bwd_kernels_are_deterministic(dev):
    """No atomics: the flash forward at the training shape (its two groups'
    states merged in a fixed order) and the LayerNorm backward at the
    training rows (its partial rows added in a fixed order) give the same
    bits twice."""
    q, k, v = (_randn(dev, 64, 256, 64, seed=i) for i in range(3))
    first, second = fa.flash_attention(q, k, v, causal=True), fa.flash_attention(q, k, v,
                                                                                  causal=True)
    x, dy, g = _randn(dev, 2048, 512), _randn(dev, 2048, 512, seed=1), _randn(dev, 512)
    _, mean, rstd = nr.layer_norm_affine(x, g, _randn(dev, 512, seed=1))
    first += nr.layer_norm_affine_bwd(x, g, mean, rstd, dy)
    second += nr.layer_norm_affine_bwd(x, g, mean, rstd, dy)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("BH,T,S,D,causal", [(64, 256, 256, 64, True), (3, 50, 131, 128, True),
                                             (4, 33, 70, 13, False)])
def test_flash_attention_bwd_kernels_are_deterministic(dev, BH, T, S, D, causal):
    """Two passes, each owning its output, no atomics: the same bits twice."""
    args = _bwd_case(dev, BH, T, S, D, causal)
    first = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    second = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R,D", [(1, 1), (3, 31), (65, 513), (9, 1024), (2048, 512)])
def test_layer_norm_bwd_kernel_matches_plain(dev, R, D):
    x, dy = _randn(dev, R, D), _randn(dev, R, D, seed=1)
    g, b = _randn(dev, D), _randn(dev, D, seed=1)
    _, mean, rstd = nr.layer_norm_affine(x, g, b)
    before = nr.bwd_launches
    got = nr.layer_norm_affine_bwd(x, g, mean, rstd, dy)
    assert nr.bwd_launches == before + 1
    for a, w in zip(got, nr.layer_norm_affine_bwd_plain(x, g, mean, rstd, dy)):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-5)


def test_training_step_on_the_card_launches_every_kernel_and_matches_the_cpu(dev):
    """One forward_backward of a small zoo transformer bound on the card: the
    launch counts are the path's, and the gradients are the CPU's."""
    from mxnet_tpu_torch import ops

    L, seq, B = 2, 16, 4
    net = ptf.get_symbol(vocab_size=64, num_layers=L, num_heads=2, model_dim=64, ffn_dim=128,
                         seq_len=seq)
    reqs = {n: "write" for n in net.list_arguments() if n not in ("data", "softmax_label")}
    exes = [net.simple_bind(ctx, grad_req=reqs, data=(B, seq), softmax_label=(B, seq))
            for ctx in (pt.gpu(0), pt.cpu())]
    gen = torch.Generator().manual_seed(3)
    for n, a in exes[0].arg_dict.items():
        if n in ("data", "softmax_label"):
            v = torch.randint(0, 64, a.shape, generator=gen).float()
        else:
            v = torch.randn(a.shape, generator=gen) * 0.1
        for exe in exes:
            exe.arg_dict[n][:] = v
    ops.reset_launch_counts()
    exes[0].forward_backward()
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": L, "flash_attention_dq": L,
                                   "flash_attention_dkv": L, "norm_residual": 2 * L + 1,
                                   "norm_residual_bwd": 2 * L + 1, "matmul_bias_act": L,
                                   "conv_bn": 0, "conv_bn_infer": 0, "conv_bn_bwd": 0,
                                   "matmul_stats": 0, "rtc": 0}
    exes[1].forward_backward()
    for n in reqs:
        got, want = exes[0].grad_dict[n].asnumpy(), exes[1].grad_dict[n].asnumpy()
        torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want), rtol=1e-3,
                                   atol=1e-3 * float(abs(want).max()))


def test_training_site_the_kernels_do_not_take_raises(dev):
    """Head width 160: a training bind on the card raises at the forward,
    before any backward could run unfused."""
    q, k, v = (pt.sym.Variable(n) for n in "qkv")
    net = pt.sym.MultiHeadAttention(query=q, key=k, value=v, causal=True)
    exe = net.simple_bind(pt.gpu(0), grad_req="write", **{n: (1, 2, 8, 160) for n in "qkv"})
    assert exe._prog.pattern_sites == {"attention": 1}
    with pytest.raises(MXNetError, match="not taken"):
        exe.forward(is_train=True)
    with pytest.raises(MXNetError, match="not taken"):
        fa.flash_attention_bwd_dq(*(_randn(dev, 2, 8, 160) for _ in range(3)),
                                  torch.zeros(2, 8, device=dev), _randn(dev, 2, 8, 160),
                                  torch.zeros(2, 8, device=dev), causal=True)


def _conv_case(dev, B, K, H, W, N, kernel, stride, variant, seed=0):
    x = _randn(dev, B, K, H, W, seed=seed)
    w = _randn(dev, N, K, kernel, kernel, scale=1 / math.sqrt(K * kernel * kernel), seed=seed)
    scale = shift = res = None
    if variant != "bare":
        scale = 0.5 + _randn(dev, K, seed=seed + 1).abs()
        shift = _randn(dev, K, scale=0.5, seed=seed + 2)
    Ho, Wo = cb.strided_dims(H, W, (stride, stride)) if kernel == 1 else (H, W)
    if variant == "prologue_res":
        res = _randn(dev, B, N, Ho, Wo, seed=seed + 3)
    return x, w, scale, shift, res, (Ho, Wo)


def _close(got, want, rtol):
    """float32 on both sides, summed in other orders: within rtol of the
    largest magnitude of the plain result."""
    torch.testing.assert_close(got, want, rtol=0, atol=rtol * max(1.0, float(want.abs().max())))


# (B, K, H, W, N, kernel, stride): ragged 3x3 (9 x 9 is two 8-pixel tiles a
# side), a 64-channel 3x3, 1x1 stride 2 on an odd grid, N not a multiple of
# the 64-channel tile, the smallest grid the gate takes (3 x 3), K of 1032
CONV_SHAPES = [(2, 8, 9, 9, 16, 3, 1), (2, 64, 14, 14, 64, 3, 1), (2, 16, 9, 9, 24, 1, 2),
               (3, 32, 7, 7, 72, 1, 1), (1, 8, 3, 3, 10, 1, 1), (2, 1032, 4, 4, 8, 1, 1)]
# the forward's tilings: 3x3 at 7 x 7 and 14 x 14 (one and four 8 x 8 tiles
# an image), 1x1 at 14 x 14 (16-byte copies) and at 7 x 7 (4-byte copies,
# 128-position tiles spanning images), stride 2 with odd H; K not a multiple
# of the 32-channel chunk
FWD_SHAPES = [(66, 16, 7, 7, 512, 3, 1), (33, 24, 14, 14, 256, 3, 1),
              (22, 16, 14, 14, 1024, 1, 1), (65, 40, 7, 7, 1536, 1, 1), (3, 32, 13, 11, 48, 1, 2)]


@pytest.mark.parametrize("B,K,H,W,N,kernel,stride", CONV_SHAPES)
@pytest.mark.parametrize("variant", ["bare", "prologue", "prologue_res"])
def test_conv_bn_kernels_match_plain(dev, B, K, H, W, N, kernel, stride, variant):
    x, w, scale, shift, res, (Ho, Wo) = _conv_case(dev, B, K, H, W, N, kernel, stride, variant)
    st, relu = (stride, stride), variant != "bare"
    before = (cb.launches, cb.infer_launches, cb.bwd_launches)
    got = cb.conv_block(x, w, scale, shift, res, st, relu)
    want = cb.conv_block_plain(x, w, scale, shift, res, st, relu)
    # c: K·taps-long dot products; the sums: B·H'W'-long
    for g, p, tol in zip(got, want, (1e-5, 1e-5, 1e-5)):
        _close(g, p, tol)
    _close(cb.conv_block_infer(x, w, scale, shift, st, relu),
           cb.conv_block_infer_plain(x, w, scale, shift, st, relu), 1e-5)
    dc = _randn(dev, B, N, Ho, Wo, seed=7)
    ds, dq = _randn(dev, N, seed=8), _randn(dev, N, scale=0.1, seed=9)
    args = (x, w, scale, shift, got[0], dc, ds, dq, st, relu, res is not None)
    gb, pb = cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*args)
    assert (cb.launches, cb.infer_launches, cb.bwd_launches) == tuple(v + 1 for v in before)
    # dx: N·taps-long sums; dw, dscale, dshift: B·H'W'-long; dres: elementwise
    for g, p in zip(gb, pb):
        assert (g is None) == (p is None)
        if g is not None:
            _close(g, p, 1e-5)


@pytest.mark.parametrize("B,K,H,W,N,kernel,stride", FWD_SHAPES)
@pytest.mark.parametrize("variant", ["bare", "prologue", "prologue_res"])
def test_conv_bn_forward_tilings_match_plain(dev, B, K, H, W, N, kernel, stride, variant):
    x, w, scale, shift, res, _ = _conv_case(dev, B, K, H, W, N, kernel, stride, variant)
    st, relu = (stride, stride), variant != "bare"
    before = (cb.launches, cb.infer_launches)
    got = cb.conv_block(x, w, scale, shift, res, st, relu)
    for g, p in zip(got, cb.conv_block_plain(x, w, scale, shift, res, st, relu)):
        _close(g, p, 1e-5)
    _close(cb.conv_block_infer(x, w, scale, shift, st, relu),
           cb.conv_block_infer_plain(x, w, scale, shift, st, relu), 1e-5)
    assert (cb.launches, cb.infer_launches) == (before[0] + 1, before[1] + 1)


# 3x3 in 8 x 8 tiles; 1x1 at the forward's flattened tiling, where a tile
# spans images (7 x 7), over 2 and 22 blocks of 64 channels
@pytest.mark.parametrize("B,K,H,W,N,kernel", [(4, 64, 28, 28, 64, 3), (9, 64, 7, 7, 96, 1),
                                              (64, 32, 7, 7, 1408, 1)])
def test_conv_bn_kernels_are_deterministic(dev, B, K, H, W, N, kernel):
    x, w, scale, shift, res, (Ho, Wo) = _conv_case(dev, B, K, H, W, N, kernel, 1,
                                                   "prologue_res")
    a = cb.conv_block(x, w, scale, shift, res, (1, 1), True)
    b = cb.conv_block(x, w, scale, shift, res, (1, 1), True)
    assert torch.equal(cb.conv_block_infer(x, w, scale, shift, (1, 1), True),
                       cb.conv_block_infer(x, w, scale, shift, (1, 1), True))
    dc, ds, dq = _randn(dev, B, N, Ho, Wo), _randn(dev, N), _randn(dev, N)
    ga = cb.conv_block_bwd(x, w, scale, shift, a[0], dc, ds, dq, (1, 1), True, True)
    gb = cb.conv_block_bwd(x, w, scale, shift, a[0], dc, ds, dq, (1, 1), True, True)
    for u, v in zip(a + ga, b + gb):
        assert torch.equal(u, v)


# 3x3 sites whose long sums the plain float32 version (cuDNN) rounds
# otherwise: stage 4's 3x3 of ResNet-50 at batch 32 (dx sums N·taps = 4608
# terms), and the forward tilings' shapes (dw sums B·H'W' = 3234 to 12936
# terms); the kernels against the plain version in float64 on the same inputs
@pytest.mark.parametrize("B,K,H,W,N,variant", [(32, 512, 7, 7, 512, "bare"),
                                               (32, 512, 7, 7, 512, "prologue"),
                                               (66, 16, 7, 7, 512, "bare"),
                                               (33, 24, 14, 14, 256, "bare"),
                                               (264, 16, 7, 7, 128, "bare")])
def test_conv_bn_kernels_match_float64(dev, B, K, H, W, N, variant):
    x, w, scale, shift, _, (Ho, Wo) = _conv_case(dev, B, K, H, W, N, 3, 1, variant)
    relu = variant != "bare"
    c = cb.conv_block(x, w, scale, shift, None, (1, 1), relu)[0]
    dc = _randn(dev, B, N, Ho, Wo, seed=7)
    ds, dq = _randn(dev, N, seed=8), _randn(dev, N, scale=0.1, seed=9)
    args = (x, w, scale, shift, c, dc, ds, dq, (1, 1), relu, False)
    f64 = [t.double() if isinstance(t, torch.Tensor) else t for t in args]
    _close(c.double(), cb.conv_block_plain(*f64[:4], None, (1, 1), relu)[0], 1e-5)
    for g, e in zip(cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*f64)):
        assert (g is None) == (e is None)
        if e is not None:
            _close(g.double(), e, 1e-5)


# the backward's tiling edges: a 3x3 site whose input channels fill neither
# the dgrad's 64-row tile nor the 3x3 wgrad's 32-channel tile (K = 40); a 1x1
# at 7 x 7 whose 128-position dgrad tiles and 32-position wgrad stages span
# images; a stride-2 1x1 with odd H and W, whose dx the kernel writes in
# full, zeros off the sampled positions included
BWD_EDGE_SHAPES = [(2, 40, 10, 10, 24, 3, 1), (5, 32, 7, 7, 96, 1, 1), (3, 16, 13, 11, 48, 1, 2)]


@pytest.mark.parametrize("B,K,H,W,N,kernel,stride", BWD_EDGE_SHAPES)
@pytest.mark.parametrize("variant", ["bare", "prologue", "prologue_res"])
def test_conv_bn_bwd_tiling_edges_match_plain(dev, B, K, H, W, N, kernel, stride, variant):
    x, w, scale, shift, res, (Ho, Wo) = _conv_case(dev, B, K, H, W, N, kernel, stride, variant)
    st, relu = (stride, stride), variant != "bare"
    c = cb.conv_block(x, w, scale, shift, res, st, relu)[0]
    dc = _randn(dev, B, N, Ho, Wo, seed=7)
    ds, dq = _randn(dev, N, seed=8), _randn(dev, N, scale=0.1, seed=9)
    args = (x, w, scale, shift, c, dc, ds, dq, st, relu, res is not None)
    # NaNs in the block the allocator hands back for dx: any element the
    # kernel leaves unwritten shows
    poison = torch.full_like(x, float("nan"))
    del poison
    before = cb.bwd_launches
    gb, pb = cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*args)
    assert cb.bwd_launches == before + 1
    for g, p in zip(gb, pb):
        assert (g is None) == (p is None)
        if g is not None:
            _close(g, p, 1e-5)
    if stride == 2:
        off = torch.ones_like(gb[0], dtype=torch.bool)
        off[:, :, ::2, ::2] = False
        assert torch.equal(gb[0][off], torch.zeros_like(gb[0][off]))


@pytest.mark.parametrize("variant", ["bare", "prologue"])
def test_conv_bn_bwd_longest_dw_sum_matches_float64(dev, variant):
    """Stage 1's 3x3 of ResNet-50 at batch 32: dw sums B·H'W' = 100 352
    terms, the longest of the net, over the wgrad's splits; the backward
    against the plain version in float64 on the same inputs."""
    B, K, H, W, N = 32, 64, 56, 56, 64
    x, w, scale, shift, _, _ = _conv_case(dev, B, K, H, W, N, 3, 1, variant)
    relu = variant != "bare"
    c = cb.conv_block(x, w, scale, shift, None, (1, 1), relu)[0]
    dc = _randn(dev, B, N, H, W, seed=7)
    ds, dq = _randn(dev, N, seed=8), _randn(dev, N, scale=0.1, seed=9)
    args = (x, w, scale, shift, c, dc, ds, dq, (1, 1), relu, False)
    f64 = [t.double() if isinstance(t, torch.Tensor) else t for t in args]
    for g, e in zip(cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*f64)):
        assert (g is None) == (e is None)
        if e is not None:
            _close(g.double(), e, 1e-5)


def test_conv_bn_bwd_refuses_a_misaligned_view(dev):
    """The backward's 16-byte copies take what the forward's take: a view 4
    bytes past an aligned address is refused, not copied."""
    x, w = _randn(dev, 2, 16, 8, 8), _randn(dev, 16, 16, 1, 1)
    c = cb.conv_block(x, w, None, None)[0]
    dc, ds, dq = _randn(dev, *c.shape), torch.zeros(16, device=dev), torch.zeros(16, device=dev)
    xm = _randn(dev, 1 + x.numel())[1:].view(x.shape)
    with pytest.raises(MXNetError, match="misaligned"):
        cb.conv_block_bwd(xm, w, None, None, c, dc, ds, dq)


def test_conv_bn_refuses_what_it_does_not_take(dev):
    x, w = _randn(dev, 2, 12, 8, 8), _randn(dev, 16, 12, 3, 3)
    with pytest.raises(MXNetError, match="does not take"):
        cb.conv_block(x, w, None, None)  # K = 12 is not a multiple of 8
    x = _randn(dev, 2, 16, 8, 8)
    with pytest.raises(MXNetError, match="does not take"):
        cb.conv_block(x, _randn(dev, 16, 16, 3, 3), None, None, stride=(2, 2))
    with pytest.raises(MXNetError, match="float32"):
        cb.conv_block(x.double(), _randn(dev, 16, 16, 1, 1).double(), None, None)
    # contiguous, but 4 bytes past an aligned address: the kernel's 16-byte
    # copies do not take it
    xm = _randn(dev, 1 + x.numel())[1:].view(x.shape)
    with pytest.raises(MXNetError, match="misaligned"):
        cb.conv_block(xm, _randn(dev, 16, 16, 1, 1), None, None)


# (M, K, N): one tile, ragged everywhere (scalar loads of A and B), K and N
# multiples of 4 with ragged M (float4 loads), many M tiles, a single row
@pytest.mark.parametrize("M,K,N", [(128, 16, 64), (1000, 70, 200), (300, 64, 132),
                                   (5000, 32, 8), (1, 3, 1)])
def test_matmul_stats_kernel_matches_plain(dev, M, K, N):
    a, b = _randn(dev, M, K), _randn(dev, K, N, scale=1 / math.sqrt(K), seed=1)
    before = ms.launches
    got = ms.matmul_with_stats(a, b)
    assert ms.launches == before + 1
    want = ms.matmul_with_stats_plain(a, b)
    # c: K-long dot products; the sums: M-long, in another order than torch.sum's
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, tol)


def test_matmul_stats_kernel_is_deterministic_and_refuses_what_it_does_not_take(dev):
    a, b = _randn(dev, 3000, 96), _randn(dev, 96, 200, seed=1)
    for u, v in zip(ms.matmul_with_stats(a, b), ms.matmul_with_stats(a, b)):
        assert torch.equal(u, v)
    with pytest.raises(MXNetError, match="float32"):
        ms.matmul_with_stats(a.bfloat16(), b.bfloat16())
    with pytest.raises(MXNetError, match="contiguous"):
        ms.matmul_with_stats(_randn(dev, 96, 3000).t(), b)
    with pytest.raises(MXNetError, match="one CUDA device"):
        ms.matmul_with_stats(a, b.cpu())


# the three kernels of tests/test_deploy.py's rtc cases, in CUDA, beside a
# per-channel image normalisation; sizes are written into the source
_NORMALISE = r"""
extern "C" __global__ void kernel(const float* x, const float* mean, const float* stdv,
                                  float* y) {
  const int HW = %(hw)d, C = %(c)d, n = %(n)d;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int ch = (i / HW) %% C;
    y[i] = (x[i] - mean[ch]) / stdv[ch];
  }
}
"""
_FMA = r"""
extern "C" __global__ void fma3(const float* a, const float* b, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < %(n)d) o[i] = a[i] + b[i] * 3.0f;
}
"""
_SPLIT = r"""
extern "C" __global__ void kernel(const float* x, float* o1, float* o2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < %(n)d) { o1[i] = x[i] + 1.0f; o2[i] = x[i] - 1.0f; }
}
"""


def _nd(dev, *shape, seed=0):
    return pt.nd.NDArray(_randn(dev, *shape, seed=seed), pt.gpu(0))


def test_rtc_normalise_kernel_two_geometries_and_no_recompile(dev):
    x = _nd(dev, 2, 3, 5, 7)
    mean, std = np.array([0.4, 0.5, 0.6], np.float32), np.array([0.2, 0.3, 0.4], np.float32)
    k = pt.rtc.Rtc("normalise", _NORMALISE % dict(hw=35, c=3, n=210), grid=(2,), block=(64,))
    (y,) = k.push([x, mean, std], out_shapes=[x.shape])  # numpy inputs go to x's context
    torch.cuda.synchronize()
    assert k.compiles <= 1 and k.launches == 1 and y.context == pt.gpu(0)
    want = (x._tensor() - torch.tensor(mean, device=dev).view(1, 3, 1, 1)) \
        / torch.tensor(std, device=dev).view(1, 3, 1, 1)
    torch.testing.assert_close(y._tensor(), want, rtol=1e-6, atol=1e-6)
    compiles = k.compiles
    (y2,) = k.push([x, mean, std], out_shapes=[x.shape], grid_dims=(1, 1, 1), block_dims=32)
    torch.cuda.synchronize()
    assert k.compiles == compiles and k.launches == 2  # the second push compiles nothing
    assert torch.equal(y2._tensor(), y._tensor())


def test_rtc_two_inputs_and_more_outputs_than_inputs(dev):
    a, b = _nd(dev, 4, 4), _nd(dev, 4, 4, seed=1)
    k = pt.rtc.Rtc("fma", _FMA % dict(n=16), kernel_name="fma3")
    (y,) = k.push([a, b], out_shapes=[(4, 4)], grid_dims=1, block_dims=16)
    torch.testing.assert_close(y._tensor(), a._tensor() + b._tensor() * 3.0, rtol=1e-6, atol=1e-6)
    k2 = pt.rtc.Rtc("split", _SPLIT % dict(n=16), grid=1, block=32)
    y1, y2 = k2.push([a], out_shapes=[(4, 4), (16,)])
    assert y1.shape == (4, 4) and y2.shape == (16,) and y2.dtype == np.float32
    torch.testing.assert_close(y1._tensor(), a._tensor() + 1.0)
    torch.testing.assert_close(y2._tensor(), a._tensor().reshape(16) - 1.0)
    from mxnet_tpu_torch import ops
    ops.reset_launch_counts()
    k2.push([a], out_shapes=[(4, 4), (16,)])
    assert ops.launch_counts()["rtc"] == 1


def test_rtc_bad_source_raises_with_the_compilers_message(dev):
    k = pt.rtc.Rtc("broken", 'extern "C" __global__ void kernel(float* y) { y[0] = nope; }',
                   grid=1, block=1)
    with pytest.raises(MXNetError, match="nope"):
        k.push([], out_shapes=[(1,)])
    k = pt.rtc.Rtc("too_wide", _SPLIT % dict(n=16), grid=1, block=2048)
    with pytest.raises(MXNetError, match="cuLaunchKernel"):  # more threads than a block holds
        k.push([_nd(dev, 16)], out_shapes=[(16,), (16,)])


def test_predictor_on_the_card_matches_the_cpu(dev, tmp_path):
    """A BatchNorm model saved with model.save_checkpoint and served by
    Predictor on the card (through the fused conv_bn kernel) and on the CPU."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.models import resnet

    net = resnet.get_symbol(num_classes=10, num_layers=18, image_shape="3,32,32")
    arg_shapes, _, aux_shapes = net.infer_shape(data=(2, 3, 32, 32), softmax_label=(2,))
    rs = np.random.RandomState(0)
    args = {n: (rs.standard_normal(s) * (0.1 if len(s) > 1 else 1.0)).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes) if n not in ("data", "softmax_label")}
    aux = {n: rs.uniform(0.5, 1.5, s).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    prefix = str(tmp_path / "r18")
    pt.model.save_checkpoint(prefix, 3, net, args, aux)
    json_str, blob = open(prefix + "-symbol.json").read(), open(prefix + "-0003.params", "rb").read()
    x = rs.standard_normal((2, 3, 32, 32)).astype(np.float32)
    outs = []
    for ctx in (pt.gpu(0), pt.cpu()):
        pred = pt.predictor.Predictor(json_str, blob, {"data": (2, 3, 32, 32)}, ctx=ctx)
        ops.reset_launch_counts()
        pred.forward(data=pt.nd.array(x, ctx=ctx))
        outs.append(pred.get_output(0))
        assert (ops.launch_counts()["conv_bn_infer"] > 0) == (ctx == pt.gpu(0))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-3, atol=1e-6)
