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


# the decode's, prefill's and training step's rows (one row a warp, then two),
# a D that is no multiple of 4 (4-byte loads), and operands one float past
# 16-byte alignment (x alone, then x, gamma and beta)
@pytest.mark.parametrize("R,D,offset", [(8, 512, 0), (1024, 512, 0), (2048, 512, 0),
                                        (37, 300, 0), (2049, 130, 0), (64, 512, 1),
                                        (2048, 512, 1)])
def test_layer_norm_forward_launch_shapes_match_plain(dev, R, D, offset):
    x = _shifted(_randn(dev, R, D), offset)
    g, b = _randn(dev, D, seed=1), _randn(dev, D, seed=2)
    if R == 2048 and offset:
        g, b = _shifted(g, offset), _shifted(b, offset)
    before = nr.launches
    got = nr.layer_norm_affine(x, g, b)
    assert nr.launches == before + 1
    for a, w in zip(got, nr.layer_norm_affine_plain(x, g, b)):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


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


# the deploy tap (short K: persistent blocks, B's slab resident) and stage
# 4's 2048 -> 512 (long K: one tile a block); C's dot products and the
# 100 352- and 1568-long column sums against float64 on the same inputs
@pytest.mark.parametrize("M,K,N", [(100352, 64, 256), (1568, 2048, 512)])
def test_matmul_stats_kernel_matches_float64(dev, M, K, N):
    a, b = _randn(dev, M, K), _randn(dev, K, N, scale=1 / math.sqrt(K), seed=1)
    c64 = a.double() @ b.double()
    got = ms.matmul_with_stats(a, b)
    for g, w, tol in zip(got, (c64, c64.sum(dim=0), (c64 * c64).sum(dim=0)), (1e-5, 1e-4, 1e-4)):
        _close(g.double(), w, tol)


@pytest.mark.parametrize("M,K,N", [(20000, 64, 256), (3000, 512, 200)], ids=["short_k", "long_k"])
def test_matmul_stats_schedules_give_the_same_bits_twice(dev, M, K, N):
    a, b = _randn(dev, M, K), _randn(dev, K, N, scale=1 / math.sqrt(K), seed=1)
    assert ms._schedule(M, K, N).kind == ("short_k" if K <= ms.SHORT_K_MAX else "long_k")
    for u, v in zip(ms.matmul_with_stats(a, b), ms.matmul_with_stats(a, b)):
        assert torch.equal(u, v)


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


def test_rtc_bad_source_raises_with_the_compilers_message(dev, monkeypatch):
    # no input: the push runs on the default context, the card when no
    # variable names another (tests/conftest.py sets one for JAX)
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
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
    pt.nd.waitall()  # the write is queued on the engine
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


# ------------------------------------------------------------ megastep graphs
_LM = dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64)


def _lm_params(seed=0, S=32):
    net = ptf.get_symbol(seq_len=S, **_LM)
    shapes = net.infer_shape(data=(1, S), softmax_label=(1, S))[0]
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes) if n not in ("data", "softmax_label")}


def _ring(params, B=4, **kw):
    from mxnet_tpu_torch.serving import KVCacheDecoder

    return KVCacheDecoder(params, ctx=pt.gpu(0), max_len=32, prefill_len=8, pos_len=32,
                          batch=B, **_LM, **kw)


def _paged(params):
    from mxnet_tpu_torch.serving import PagedKVDecoder

    return PagedKVDecoder(params, ctx=pt.gpu(0), max_len=32, page_size=4, lanes=4,
                          prefill_len=8, pos_len=32, **_LM)


def _prompt(B=4, L=6, seed=3):
    return np.random.RandomState(seed).randint(1, _LM["vocab_size"], (B, L))


def test_megastep_graph_matches_the_same_steps_run_eagerly(dev):
    """One replay of the captured K-step graph gives the tokens and KV
    buffers (bitwise) of the same K steps run eagerly on the card from the
    same state; a replay adds K steps' launches to the counters."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving.kv_decode import _NEG

    K, B = 4, 4
    dec = _ring(_lm_params())
    tok = np.argmax(dec.prefill(_prompt()), axis=-1)
    dec.decode_megastep(tok, k=K)  # captures
    prog = dec._megasteps[(K, ("greedy", 1.0, 0))]
    assert prog._graph is not None
    assert prog.replay_launches[0]["norm_residual"] == K * (2 * _LM["num_layers"] + 1)
    assert prog.replay_launches[0]["matmul_bias_act"] == K * _LM["num_layers"]
    tok = np.argmax(dec.prefill(_prompt()), axis=-1)
    p, S = dec.position, dec.max_len
    before = [dec._kv(n).clone() for n in prog.kv_names]
    ops.reset_launch_counts()
    graphed = dec.decode_megastep(tok, k=K)
    assert ops.launch_counts() == prog.replay_launches[0]
    after = [dec._kv(n).clone() for n in prog.kv_names]
    for buf, v in zip((dec._kv(n) for n in prog.kv_names), before):
        buf.copy_(v)
    slots = np.tile((np.arange(p, p + K) % S).astype(np.int32), (B, 1))
    base_mask = np.broadcast_to(np.where(np.arange(S) < p, np.float32(0), _NEG),
                                (B, S)).astype(np.float32).copy()
    inputs = (tok.astype(np.int32), np.full((B,), p, np.int32), slots, base_mask,
              np.zeros((B,), bool), 0, -1)
    weights, kvs = prog._bound_tensors(dec)
    with torch.no_grad():
        eager = prog._steps(weights, kvs, *prog._tensors(inputs, dev))
    torch.testing.assert_close(torch.from_numpy(graphed.T), eager[0].cpu(), rtol=0, atol=0)
    for a, b in zip(after, kvs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("decoder", ["ring", "paged"])
def test_megastep_interleaved_with_single_steps_matches_single_steps(dev, decoder):
    """Three single steps, a K=4 replay, two single steps: the tokens of
    nine single steps, for the lockstep ring and the paged pool (its lanes
    at different positions, crossing pages)."""
    params = _lm_params()
    if decoder == "ring":
        def run(plan):
            dec = _ring(params)
            tok = np.argmax(dec.prefill(_prompt()), axis=-1)
            out = []
            for k in plan:
                ids = dec.decode_megastep(tok, k=k) if k > 1 else dec.greedy_step(tok)[:, None]
                out.append(ids)
                tok = ids[:, -1]
            return np.concatenate(out, axis=1)
    else:
        prompts = [_prompt(1, L, seed=L)[0] for L in (2, 5, 3)]

        def run(plan):
            dec = _paged(params)
            cur = {}
            for p_ in prompts:
                sid, lg = dec.admit(p_)
                cur[sid] = int(np.argmax(lg))
            out = []
            for k in plan:
                if k > 1:
                    ids = dec.step_megastep(cur, k=k)
                else:
                    ids = {s: np.array([int(np.argmax(v))]) for s, v in dec.step(cur).items()}
                out.append(np.stack([ids[s] for s in sorted(ids)]))
                cur = {s: int(v[-1]) for s, v in ids.items()}
            return np.concatenate(out, axis=1)

    np.testing.assert_array_equal(run([1, 1, 1, 4, 1, 1]), run([1] * 9))


def test_megastep_topk_draws_are_the_same_for_any_partition_into_k(dev):
    """Seeded top-k draws depend on (seed, position, lane) alone: one K=4
    replay gives the tokens of two K=2 replays and of four K=1 replays."""
    params = _lm_params()
    kw = dict(sample="topk", temperature=0.8, top_k=5)
    got = []
    for plan in ([4], [2, 2], [1, 1, 1, 1]):
        dec = _ring(params, sample_seed=11)
        tok = np.argmax(dec.prefill(_prompt()), axis=-1)
        out = []
        for k in plan:
            out.append(dec.decode_megastep(tok, k=k, **kw))
            tok = out[-1][:, -1]
        got.append(np.concatenate(out, axis=1))
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], got[2])


def test_megastep_refuses_a_drifted_signature_and_replaced_buffers(dev):
    """After capture, other input shapes raise rather than capture again, and
    so do weights or KV buffers that are not the captured tensors."""
    dec = _ring(_lm_params())
    tok = np.argmax(dec.prefill(_prompt()), axis=-1)
    dec.decode_megastep(tok, k=2)
    prog = dec._megasteps[(2, ("greedy", 1.0, 0))]
    tok0, pos, slots, mask, done = prog._zero_inputs()
    with pytest.raises(MXNetError, match="signature drifted"):
        prog.run(dec, np.zeros((5,), np.int32), pos, slots, mask, done, -1)
    arr = dec._dec_exe.arg_dict["kv_k_0"]
    arr._set_tensor(arr._tensor().clone())
    with pytest.raises(MXNetError, match="captured on"):
        dec.decode_megastep(tok, k=2)


# ------------------------------------------------------------ serving engine
def test_engine_on_the_card_matches_direct_runs_and_binds_nothing_after_warmup(dev):
    """InferenceEngine over a small conv+BN net on the card: concurrent
    requests equal their rows of a direct ``cache.run`` of the same padded
    batch, and no executor is bound after warmup."""
    import threading

    from mxnet_tpu_torch.serving import InferenceEngine, PersistentExecutableCache

    S = pt.sym
    x = S.Variable("data")
    c = S.Convolution(x, num_filter=8, kernel=(3, 3), pad=(1, 1), no_bias=True, name="c0")
    b = S.BatchNorm(c, fix_gamma=False, name="bn0")
    net = S.FullyConnected(S.Flatten(S.Activation(b, act_type="relu")), num_hidden=5, name="fc")
    rs = np.random.RandomState(0)
    shapes, _, aux_shapes = net.infer_shape(data=(1, 3, 8, 8))
    args = {n: (rs.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes) if n != "data"}
    aux = {n: (np.abs(rs.randn(*s)) + 0.5).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    cache = PersistentExecutableCache(net, args, aux, ctx=pt.gpu(0))
    seen = []
    run = cache.run

    def recording_run(inputs):
        outs = run(inputs)
        seen.append((inputs["data"].copy(), outs[0]))
        return outs

    cache.run = recording_run
    eng = InferenceEngine(cache, {"data": (3, 8, 8)}, buckets=(1, 2, 4, 8), max_delay_ms=2)
    eng.start()
    binds = cache.binds
    got = {}

    def client(i):
        r = np.random.RandomState(10 + i)
        for j in range(4):
            xs = r.randn(1 + (i + j) % 3, 3, 8, 8).astype(np.float32)
            got[(i, j)] = (xs, eng.infer({"data": xs}, timeout=60)[0])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    eng.close()
    assert cache.binds == binds and len(got) == 16
    for xs, out in got.values():
        hits = [(inp, o) for inp, o in seen
                for k in range(inp.shape[0] - xs.shape[0] + 1)
                if np.array_equal(inp[k:k + xs.shape[0]], xs)]
        assert hits, "a request's rows are in no dispatched batch"
        inp, o = hits[0]
        k = next(k for k in range(inp.shape[0]) if np.array_equal(inp[k:k + xs.shape[0]], xs))
        np.testing.assert_array_equal(out, o[k:k + xs.shape[0]])
        np.testing.assert_allclose(out, run({"data": inp})[0][k:k + xs.shape[0]],
                                   rtol=1e-5, atol=1e-7)


def test_decoder_reload_lands_in_the_next_megastep_without_a_new_capture(dev):
    """``swap_params`` on a decoder's caches writes into the captured
    weight tensors: the next K=4 replay gives a fresh decoder's tokens for
    the new weights, and no graph is captured again."""
    old, new = _lm_params(0), _lm_params(5)
    dec = _ring(old)
    tok = np.argmax(dec.prefill(_prompt()), axis=-1)
    dec.decode_megastep(tok, k=4)
    prog = dec._megasteps[(4, ("greedy", 1.0, 0))]
    graph = prog._graph
    dec._pf_cache.swap_params(new)
    dec._dec_cache.swap_params(new)
    want = _ring(new).greedy(_prompt(), 9, k=4)
    got = dec.greedy(_prompt(), 9, k=4)
    np.testing.assert_array_equal(got, want)
    assert dec._megasteps[(4, ("greedy", 1.0, 0))] is prog and prog._graph is graph


# ------------------------------------------------------------ Module.fit trunk
@pytest.mark.parametrize("op", ["random_uniform", "random_normal"])
def test_random_ops_draw_on_the_card(dev, op):
    """A draw on gpu(0) runs on the card from its generator: the same seed,
    the same draws; the moments are the distribution's."""
    pt.random.seed(7)
    a = getattr(pt.nd, op)(shape=(100000,), ctx=pt.gpu(0))
    assert a._tensor().is_cuda and pt.random.generator(dev).device == dev
    pt.random.seed(7)
    b = getattr(pt.nd, op)(shape=(100000,), ctx=pt.gpu(0))
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    x = a.asnumpy().astype(np.float64)
    mean, std = (0.5, 1 / math.sqrt(12)) if op == "random_uniform" else (0.0, 1.0)
    assert abs(x.mean() - mean) < 5 * std / math.sqrt(x.size)
    assert abs(x.std() - std) < 5 * std / math.sqrt(2 * x.size)


@pytest.mark.parametrize("on_card", [False, True])
def test_device_prefetch_iter_on_the_card_gives_the_unwrapped_bits(dev, on_card):
    """Host batches through the pinned staging buffer, card batches copied on
    the side stream: each batch the unwrapped iterator's, bitwise, on gpu(0)."""
    rs = np.random.RandomState(0)
    x, y = rs.randn(50, 3, 8, 8).astype("f"), rs.randint(0, 10, 50).astype("f")
    with (pt.gpu(0) if on_card else pt.cpu()):
        plain = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                 for b in pt.io.NDArrayIter(x, y, batch_size=8)]
        it = pt.io.DevicePrefetchIter(pt.io.NDArrayIter(x, y, batch_size=8), device=pt.gpu(0))
    for _ in range(2):
        got = []
        for b in it:
            assert b.data[0].context == pt.gpu(0) and b.data[0]._tensor().is_cuda
            got.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
        assert len(got) == len(plain) == 7
        for (gd, gl, gp), (wd, wl, wp) in zip(got, plain):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp


def test_module_fit_through_device_prefetch_gives_the_same_bits(dev, monkeypatch):
    """``MXNET_IO_DEVICE_PREFETCH=1``: ``Module.fit`` on gpu(0) over a host
    iterator, wrapped in a DevicePrefetchIter, trains to the same bits as
    without it."""
    rs = np.random.RandomState(3)
    x, y = rs.randn(64, 20).astype("f"), rs.randint(0, 5, 64).astype("f")
    w = {"fc_weight": rs.randn(5, 20).astype("f") * 0.1, "fc_bias": np.zeros(5, "f")}

    def fit():
        net = pt.sym.SoftmaxOutput(pt.sym.FullyConnected(pt.sym.Variable("data"), num_hidden=5,
                                                         name="fc"), name="softmax")
        with pt.cpu():
            train = pt.io.NDArrayIter(x, y, batch_size=16)
        mod = pt.mod.Module(net, context=pt.gpu(0))
        mod.fit(train, optimizer="sgd", optimizer_params=(("learning_rate", 0.1),
                                                          ("momentum", 0.9)),
                arg_params=w, num_epoch=3)
        return mod.get_params()[0]["fc_weight"].asnumpy()

    plain = fit()
    monkeypatch.setenv("MXNET_IO_DEVICE_PREFETCH", "1")
    np.testing.assert_array_equal(fit(), plain)


# Inception's fused sites (batch 2): 1x1 to N = 48 and 80 (ragged against the
# 64-channel tile), 32 at 35 x 35 (4-byte copies), 1x1 from K = 1280 and 2048
# at 8 x 8 (one 128-position tile spans two images), 3x3 448 -> 384 at 8 x 8
# with a prologue, the stem's 3x3 32 -> 64 at an odd grid
INCEPTION_SHAPES = [(2, 192, 35, 35, 48, 1, 1, "bare"), (2, 64, 21, 21, 80, 1, 1, "bare"),
                    (2, 192, 35, 35, 32, 1, 1, "bare"), (2, 1280, 8, 8, 320, 1, 1, "bare"),
                    (2, 2048, 8, 8, 448, 1, 1, "bare"), (2, 448, 8, 8, 384, 3, 1, "prologue"),
                    (2, 32, 19, 19, 64, 3, 1, "prologue")]


@pytest.mark.parametrize("B,K,H,W,N,kernel,stride,variant", INCEPTION_SHAPES)
def test_conv_bn_kernels_match_plain_at_inception_shapes(dev, B, K, H, W, N, kernel, stride,
                                                         variant):
    x, w, scale, shift, res, (Ho, Wo) = _conv_case(dev, B, K, H, W, N, kernel, stride, variant)
    st, relu = (stride, stride), variant != "bare"
    got = cb.conv_block(x, w, scale, shift, res, st, relu)
    for g, p in zip(got, cb.conv_block_plain(x, w, scale, shift, res, st, relu)):
        _close(g, p, 1e-5)
    _close(cb.conv_block_infer(x, w, scale, shift, st, relu),
           cb.conv_block_infer_plain(x, w, scale, shift, st, relu), 1e-5)
    dc = _randn(dev, B, N, Ho, Wo, seed=7)
    ds, dq = _randn(dev, N, seed=8), _randn(dev, N, scale=0.1, seed=9)
    args = (x, w, scale, shift, got[0], dc, ds, dq, st, relu, False)
    for g, p in zip(cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*args)):
        assert (g is None) == (p is None)
        if g is not None:
            _close(g, p, 1e-5)


def test_dropout_draws_its_mask_on_the_cards_generator(dev):
    """A training Dropout on a card tensor draws on the card from the
    card's generator: y = x·m/(1 − p), dx = dy·m/(1 − p), the kept share
    within 4σ of 1 − p, the same seed the same mask."""
    op = pt.ops.registry.get_op("Dropout")
    attrs = pt.ops.registry.parse_attrs(op, {"p": "0.3"})
    x = _randn(dev, 256, 512).abs() + 0.5
    pt.random.seed(4)
    xg = x.clone().requires_grad_(True)
    y = op.apply(attrs, [xg], is_train=True, rng=pt.random.generator(dev))[0][0]
    assert y.device == dev
    m = y != 0
    torch.testing.assert_close(y[m], x[m] / 0.7, rtol=1e-6, atol=0)
    assert abs(float(m.float().mean()) - 0.7) <= 4 * math.sqrt(0.21 / m.numel())
    (dx,) = torch.autograd.grad(y, xg, torch.ones_like(y))
    torch.testing.assert_close(dx, m.float() / 0.7, rtol=1e-6, atol=0)
    pt.random.seed(4)
    y2 = op.apply(attrs, [x], is_train=True, rng=pt.random.generator(dev))[0][0]
    assert torch.equal(y, y2.detach())
    assert torch.equal(op.apply(attrs, [x], is_train=False)[0][0], x)


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", True), ("rnn_tanh", False)])
def test_rnn_op_on_the_card_matches_the_cpu(dev, mode, bidir):
    """The fused RNN op's outputs and gradients on the card against the CPU
    (float32 both, TF32 off): the same loop over the same projections."""
    op = pt.ops.registry.get_op("RNN")
    attrs = pt.ops.registry.parse_attrs(op, {"mode": mode, "state_size": "32",
                                             "num_layers": "2", "bidirectional": str(bidir),
                                             "state_outputs": "True"})
    d, n_in = (2 if bidir else 1), len(op.input_names(attrs))
    rs = np.random.RandomState(0)
    ins = [rs.uniform(-1, 1, (12, 4, 24)),
           rs.uniform(-0.2, 0.2, (pt.ops.rnn.rnn_param_size(2, 24, 32, bidir, mode),))]
    ins += [rs.uniform(-0.5, 0.5, (2 * d, 4, 32)) for _ in range(n_in - 2)]
    runs = []
    for device in (dev, torch.device("cpu")):
        leaves = [torch.tensor(a, dtype=torch.float32, device=device, requires_grad=True)
                  for a in ins]
        outs = op.apply(attrs, leaves)[0]
        grads = torch.autograd.grad([o.sum() for o in outs], leaves)
        runs.append([t.detach().cpu() for t in list(outs) + list(grads)])
    for g, c in zip(*runs):
        _close(g, c, 1e-5)


# ------------------------------------------- the rest of the operator library
def _card_vs_cpu(dev, op, attrs, inputs, grad=True, tol=dict(rtol=1e-5, atol=1e-5)):
    """The op forward (and backward at a seeded cotangent) on the card and
    on the CPU from the same numpy inputs."""
    from mxnet_tpu_torch.ops import registry as reg

    opdef = reg.get_op(op)
    pa = reg.parse_attrs(opdef, attrs)
    n_in = len(opdef.input_names(pa))
    rs, cots, runs = np.random.RandomState(1), None, []
    for d in (torch.device("cpu"), dev):
        xs = [torch.from_numpy(x).to(d) for x in inputs]
        leaves = [x.requires_grad_(grad) for x in xs[:n_in]]
        with torch.enable_grad():
            outs, _ = opdef.apply(pa, leaves, aux=xs[n_in:])
        cots = cots or [rs.standard_normal(tuple(o.shape)).astype(np.float32) for o in outs]
        heads = [(o, torch.from_numpy(c).to(d)) for o, c in zip(outs, cots) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in heads], leaves, [c for _, c in heads],
                                    allow_unused=True) if heads else []
        runs.append(([o.detach().cpu() for o in outs],
                     [None if g is None else g.cpu() for g in grads]))
    for got, want in zip(runs[1][0], runs[0][0]):
        torch.testing.assert_close(got, want, **tol)
    for got, want in zip(runs[1][1], runs[0][1]):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _anchors(n):
    rs = np.random.RandomState(n)
    xy = rs.uniform(0, 0.8, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(0.05, 0.2, (n, 2))], 1).astype(np.float32)[None]


@pytest.mark.parametrize("case", [
    ("Deconvolution", {"kernel": "(3, 3)", "num_filter": "4", "stride": "(2, 2)", "pad": "(1, 1)",
                       "adj": "(1, 1)"}, [(2, 3, 5, 5), (3, 4, 3, 3), (4,)]),
    ("L2Normalization", {"mode": "channel"}, [(2, 512, 38, 38)]),
    ("SoftmaxActivation", {"mode": "channel"}, [(8, 21, 8732)]),
    ("ROIPooling", {"pooled_size": "(2, 3)", "spatial_scale": "1.0"}, None),
    ("BilinearSampler", {}, [(2, 3, 5, 6), (2, 2, 4, 5)]),
    ("UpSampling", {"scale": "2", "sample_type": "bilinear"}, [(2, 3, 3, 4)]),
    ("WarpCTC", {"input_length": "6", "label_length": "2"}, None),
    ("MultiBoxPrior", {"sizes": "[0.1, 0.141]", "ratios": "[1, 2, 0.5]"}, [(1, 3, 38, 38)]),
], ids=lambda c: c[0])
def test_new_ops_match_the_cpu_on_the_card(dev, case):
    op, attrs, shapes = case
    rs = np.random.RandomState(0)
    if op == "ROIPooling":
        inputs = [rs.randn(2, 3, 8, 8).astype(np.float32),
                  np.array([[0, 1, 2, 6, 7], [1, 0, 0, 7, 7]], np.float32)]
    elif op == "WarpCTC":
        inputs = [rs.randn(12, 5).astype(np.float32), np.array([[1, 2], [3, 0]], np.float32)]
    else:
        inputs = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    _card_vs_cpu(dev, op, attrs, inputs)


def test_multibox_ops_match_the_cpu_on_the_card_at_ssd_size(dev):
    """8732 anchors, 8 images: the targets (mining included) and the
    detections from the same inputs, decisions equal (random inputs at this
    seed hold no near-tie)."""
    rs = np.random.RandomState(3)
    N, B = 8732, 8
    anchors = _anchors(N)
    label = -np.ones((B, 4, 5), np.float32)
    for b in range(B):
        for j in range(rs.randint(1, 5)):
            x0, y0 = rs.uniform(0, 0.6, 2)
            label[b, j] = [rs.randint(20), x0, y0, x0 + rs.uniform(0.2, 0.4),
                           y0 + rs.uniform(0.2, 0.4)]
    preds = rs.randn(B, 21, N).astype(np.float32)
    mining = {"negative_mining_ratio": "3", "negative_mining_thresh": "0.5"}
    _card_vs_cpu(dev, "MultiBoxTarget", mining, [anchors, label, preds], grad=False,
                 tol=dict(rtol=1e-5, atol=1e-6))
    probs = np.exp(preds) / np.exp(preds).sum(axis=1, keepdims=True)
    _card_vs_cpu(dev, "MultiBoxDetection", {"nms_topk": "400"},
                 [probs.astype(np.float32), rs.randn(B, 4 * N).astype(np.float32) * 0.1, anchors],
                 grad=False, tol=dict(rtol=1e-5, atol=1e-6))


def test_a_custom_node_under_graph_capture_raises(dev):
    @pt.operator.register("card_capture_probe")
    class Prop(pt.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(pt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0].asnumpy())

            return Op()

    x = pt.nd.array(np.ones((2, 2), np.float32), ctx=pt.gpu(0))
    pt.nd.Custom(x, op_type="card_capture_probe")  # outside a capture it runs
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(MXNetError, match="card_capture_probe"):
        with torch.cuda.graph(graph):
            pt.nd.Custom(x, op_type="card_capture_probe")


def test_ssd_loss_tail_training_step_on_the_card_matches_the_cpu(dev):
    """example/ssd's mini backbone (without BatchNorm) at 64 x 64, batch 2,
    with the port's multibox_layer and ssd_losses: outputs and every
    gradient card vs CPU (rtol 1e-3, atol 1e-3 of the largest magnitude)."""
    from mxnet_tpu_torch.models.vgg16_ssd import multibox_layer, ssd_losses

    sym = pt.sym
    x = sym.Variable("data")
    feats = []
    for i, nf in enumerate((32, 64, 128)):
        x = sym.Activation(sym.Convolution(x, num_filter=nf, kernel=(3, 3), pad=(1, 1),
                                           name="conv%d" % i), act_type="relu")
        x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        feats.append(x)
    cls, loc, anc = multibox_layer(feats, 3, [(0.2, 0.3), (0.4, 0.5), (0.7, 0.9)],
                                   [(1.0, 2.0, 0.5)] * 3)
    net = ssd_losses(cls, loc, anc, sym.Variable("label"))
    rs = np.random.RandomState(5)
    label = -np.ones((2, 4, 5), np.float32)
    label[:, 0] = [[1, 0.1, 0.1, 0.5, 0.6], [2, 0.3, 0.2, 0.9, 0.7]]
    arg_shapes, _, _ = net.infer_shape(data=(2, 3, 64, 64), label=label.shape)
    args = {n: (rs.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes) if n not in ("data", "label")}
    args["data"] = rs.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    args["label"] = label
    runs = []
    for ctx in (pt.cpu(), pt.gpu(0)):
        arrays = {k: pt.nd.array(v, ctx=ctx) for k, v in args.items()}
        grads = {k: pt.nd.zeros(v.shape, ctx=ctx) for k, v in args.items()
                 if k not in ("data", "label")}
        exe = pt.executor.bind(net, ctx, arrays, args_grad=grads)
        exe.forward_backward()
        runs.append(([o.asnumpy() for o in exe.outputs],
                     {k: g.asnumpy() for k, g in grads.items()}))
    np.testing.assert_array_equal(runs[1][0][2], runs[0][0][2])  # the class targets
    for got, want in zip(runs[1][0][:2], runs[0][0][:2]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for k, want in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k], want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()), err_msg=k)


# the recommender's four FC+relu sites (ROADMAP.md section 1.4a), per executor
# of 256 rows and on one context of 512; top_fc0's K = 193 takes the
# kernel's 4-byte-copy route
@pytest.mark.parametrize("M", [256, 512])
@pytest.mark.parametrize("K,N", [(16, 128), (128, 64), (193, 512), (512, 256)])
def test_matmul_bias_act_at_the_recommender_shapes(dev, M, K, N):
    a, w = _randn(dev, M, K), _randn(dev, N, K, scale=1.0 / math.sqrt(K), seed=1)
    b = _randn(dev, N, scale=0.1, seed=2)
    got, want = mba.matmul_bias_act(a, w, b, "relu"), mba.matmul_bias_act_plain(a, w, b, "relu")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_sparse_embedding_gradient_is_the_same_bits_twice_on_the_card(dev):
    """The table gradient that from_dense scans: F.embedding's backward,
    sorted, so two runs give the same bits."""
    rs = np.random.RandomState(0)
    ids = torch.tensor(rs.randint(0, 1000, 4096), device=dev, dtype=torch.float32)
    og = _randn(dev, 4096, 64)
    fn = pt.ops.registry.get_op("SparseEmbedding").fn
    grads = []
    for _ in range(2):
        w = torch.zeros(1000, 64, device=dev, requires_grad=True)
        fn({"input_dim": 1000, "output_dim": 64}, ids, w).backward(og)
        grads.append(w.grad.clone())
    assert torch.equal(grads[0], grads[1])
    rsp = pt.sparse.from_dense(pt.nd.NDArray(grads[0], ctx=pt.gpu(0)))
    assert np.array_equal(rsp.host_indices(), np.unique(ids.cpu().numpy().astype(np.int64)))


def test_two_contexts_on_one_card_match_one_context(dev):
    """The MNIST mlp over [gpu(0)] at batch 40 and [gpu(0), gpu(0)] at
    20 + 20 with a device store: three steps agree within rtol 1e-4,
    atol 1e-5, and the two contexts hold tensors of their own."""
    net = pt.models.get_symbol("mlp", num_classes=10)
    rs = np.random.RandomState(1)
    x = rs.rand(120, 784).astype(np.float32)
    y = rs.randint(0, 10, 120).astype(np.float32)
    shapes, _, _ = net.infer_shape(data=(40, 784))
    params = {n: (rs.randn(*s) * 0.05).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes) if n not in ("data", "softmax_label")}
    results = []
    for ctxs in ([pt.gpu(0)], [pt.gpu(0), pt.gpu(0)]):
        mod = pt.mod.Module(net, context=ctxs)
        mod.bind(data_shapes=[("data", (40, 784))], label_shapes=[("softmax_label", (40,))])
        mod.init_params(arg_params={k: pt.nd.array(v, ctx=pt.cpu()) for k, v in params.items()})
        mod.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
        assert len({a._tensor().data_ptr() for a in mod._exec_group.param_arrays[0]}) == len(ctxs)
        for i in range(3):
            sl = slice(40 * i, 40 * i + 40)
            mod.forward_backward(pt.io.DataBatch(data=[pt.nd.array(x[sl], ctx=pt.gpu(0))],
                                                 label=[pt.nd.array(y[sl], ctx=pt.gpu(0))],
                                                 pad=0, index=None))
            mod.update()
        args, _ = mod.get_params()
        results.append({k: v.asnumpy() for k, v in args.items()})
    for k in results[0]:
        np.testing.assert_allclose(results[1][k], results[0][k], rtol=1e-4, atol=1e-5)


# ------------------------------------------------ the fused step's CUDA graph
def _mlp_trainer(dev_ctx, seed=5, opt="sgd", **opt_params):
    mesh = pt.parallel.make_mesh((1,), ("data",), [dev_ctx])
    net = pt.models.get_symbol("mlp", num_classes=10)
    tr = pt.parallel.SPMDTrainer(net, mesh, optimizer=opt,
                                 optimizer_params=opt_params or {"learning_rate": 0.1,
                                                                 "momentum": 0.9,
                                                                 "rescale_grad": 1.0 / 32})
    tr.init_params({"data": (32, 784)}, {"softmax_label": (32,)}, seed=seed)
    return tr


def _mlp_batches(n, seed=2):
    rs = np.random.RandomState(seed)
    return [({"data": rs.rand(32, 784).astype(np.float32)},
             {"softmax_label": rs.randint(0, 10, 32).astype(np.float32)}) for _ in range(n)]


def test_fused_step_is_one_cuda_graph_and_matches_the_cpu(dev):
    """The first step runs eagerly and captures the graph; the next four
    replay it, with kernel 6's launches counted at each replay. The card's
    params after 5 steps equal the CPU trainer's (rtol 1e-4, atol 1e-5)."""
    from mxnet_tpu_torch import ops

    card, cpu = _mlp_trainer(pt.gpu(0)), _mlp_trainer(pt.cpu())
    cpu.set_params(card.get_params()[0])
    batches = _mlp_batches(5)
    ops.reset_launch_counts()
    card.step(*batches[0])
    torch.cuda.synchronize()
    first = ops.launch_counts()["matmul_bias_act"]
    assert first == 2 and len(card._graphs) == 1
    (graph,) = card._graphs.values()
    assert graph.replay_launches[0]["matmul_bias_act"] == 2
    for d, lab in batches[1:]:
        card.step(d, lab)
    torch.cuda.synchronize()
    assert graph.replays == 4
    assert ops.launch_counts()["matmul_bias_act"] == first + 4 * 2
    for d, lab in batches:
        cpu.step(d, lab)
    want = cpu.get_params()[0]
    for k, v in card.get_params()[0].items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # a replaced state tensor is refused, not silently ignored
    card._state.aux["x"] = torch.zeros(1, device=dev)
    with pytest.raises(MXNetError, match="captured on"):
        card.step(*batches[0])


def _mlp_reference64(params, batches, opt, opt_params):
    """The ``mlp`` trained in float64 by torch autograd on the CPU, with
    the fused step's update (``optimizer.FLAT_KERNELS``' formulas: SGD
    with momentum, Adam with its bias-corrected lr)."""
    p = opt_params
    w = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in params.items()}
    states = {k: [torch.zeros_like(v), torch.zeros_like(v)] for k, v in w.items()}
    for t, (d, lab) in enumerate(batches, 1):
        h = torch.tensor(d["data"], dtype=torch.float64)
        for i in (1, 2, 3):
            h = h @ w["fc%d_weight" % i].T + w["fc%d_bias" % i]
            h = torch.relu(h) if i < 3 else h
        loss = torch.nn.functional.cross_entropy(
            h, torch.tensor(lab["softmax_label"]).long(), reduction="sum")
        grads = torch.autograd.grad(loss, list(w.values()))
        with torch.no_grad():
            for (k, v), g in zip(w.items(), grads):
                g = g * p["rescale_grad"] + p.get("wd", 0.0) * v
                m, s = states[k]
                if opt == "adam":
                    m.mul_(0.9).add_(0.1 * g)
                    s.mul_(0.999).add_(0.001 * g * g)
                    lr = p["learning_rate"] * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
                    v -= lr * m / (torch.sqrt(s) + 1e-8)
                else:
                    m.mul_(p["momentum"]).sub_(p["learning_rate"] * g)
                    v += m
    return {k: v.detach().numpy() for k, v in w.items()}


# how much farther from float64 than the CPU's float32 params the card's
# may lie where the two miss rtol 1e-4, atol 1e-5 of each other. Adam
# divides by sqrt(v), so a gradient near zero (a sum that cancels) turns a
# float32 rounding difference into an update of up to lr: the CPU's own
# params miss float64 at that tolerance in a few elements, and so do the
# CPU's with the batch rows summed in another order. The factor is the one
# chip_smoke.py holds a chaotic gradient to (RESNET_F64_FACTOR)
F64_FACTOR = 8.0


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0 / 32}),
    ("adam", {"learning_rate": 0.01, "rescale_grad": 1.0 / 32})])
@pytest.mark.parametrize("seed", [3, 7, 11, 19])
def test_fused_step_matches_the_cpu_over_seeds_and_optimizers(dev, seed, opt, opt_params):
    """Eight card steps (one eager, seven replays) against the CPU trainer
    from the same weights and batches, for each seed and optimizer: each
    param within rtol 1e-4, atol 1e-5 of the CPU's (the test above's
    tolerance), or, where it is not, no farther from a float64 run than
    F64_FACTOR times the CPU's own distance."""
    card = _mlp_trainer(pt.gpu(0), seed=seed, opt=opt, **opt_params)
    cpu = _mlp_trainer(pt.cpu(), seed=seed, opt=opt, **opt_params)
    init = card.get_params()[0]
    cpu.set_params(init)
    batches = _mlp_batches(8, seed=seed + 1)
    for d, lab in batches:
        card.step(d, lab)
        cpu.step(d, lab)
    (graph,) = card._graphs.values()
    assert graph.replays == 7
    got, want = card.get_params()[0], cpu.get_params()[0]
    ref = _mlp_reference64(init, batches, opt, opt_params)
    for k in want:
        if np.allclose(got[k], want[k], rtol=1e-4, atol=1e-5):
            continue
        card64, cpu64 = np.abs(got[k] - ref[k]).max(), np.abs(want[k] - ref[k]).max()
        assert card64 <= F64_FACTOR * cpu64, (k, card64, cpu64)


def test_fused_step_schedule_moves_inside_the_graph(dev, monkeypatch):
    """lr is a device tensor read inside the graph: a FactorScheduler that
    drops it by 1e-8 after step 1 freezes the params on the card as on the
    CPU (atol 1e-6)."""
    sched = pt.lr_scheduler.FactorScheduler(step=1, factor=1e-8)
    net = pt.models.get_symbol("mlp", num_classes=10)
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    mod = pt.mod.Module(net, context=pt.gpu(0))
    mod.bind(data_shapes=[("data", (32, 784))], label_shapes=[("softmax_label", (32,))])
    mod.init_params(initializer=pt.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.5), ("momentum", 0.0), ("lr_scheduler", sched)))
    monkeypatch.delenv("MXNET_MODULE_FUSED_STEP")
    assert mod._spmd is not None
    batches = [pt.io.DataBatch(data=[pt.nd.array(d["data"], ctx=pt.gpu(0))],
                               label=[pt.nd.array(lab["softmax_label"], ctx=pt.gpu(0))])
               for d, lab in _mlp_batches(4, seed=3)]
    mod.forward_backward(batches[0])
    mod.update()
    after_1 = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    for b in batches[1:]:
        mod.forward_backward(b)
        mod.update()
    assert next(iter(mod._spmd.trainer._graphs.values())).replays == 3
    for k, v in mod.get_params()[0].items():
        np.testing.assert_allclose(v.asnumpy(), after_1[k], rtol=0, atol=1e-6)


def test_step_many_n4_is_bitwise_eight_single_steps_on_the_card(dev):
    batches = _mlp_batches(8)
    lrs = [0.1 - 0.01 * i for i in range(8)]
    one, four = _mlp_trainer(pt.gpu(0)), _mlp_trainer(pt.gpu(0))
    for (d, lab), lr in zip(batches, lrs):
        one.step(d, lab, lr=lr)
    for i in (0, 4):
        four.step_many([d for d, _ in batches[i:i + 4]], [lab for _, lab in batches[i:i + 4]],
                       lrs=lrs[i:i + 4])
    (graph,) = [g for key, g in four._graphs.items() if key[0] == 4]
    assert graph.replays == 1 and len(four._graphs) == 1
    want = one.get_params()[0]
    for k, v in four.get_params()[0].items():
        assert np.array_equal(v, want[k]), k


# ----------------------------------------------- checkpoints off the step path
def test_a_save_frozen_between_replays_writes_its_steps_bytes(dev, tmp_path, monkeypatch):
    """The fused ResNet step replays its CUDA graph over the same state
    tensors. A save frozen after step 2 and held behind a busy writer while
    three more replays run still writes step 2's weights, moving stats and
    momentum: the freeze is a clone ordered on the stream after the step."""
    import pickle
    import threading

    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch.models import resnet

    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    net = resnet.get_symbol(num_classes=10, num_layers=18, image_shape="3,32,32")
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (5 * 8, 3, 32, 32)).astype(np.float32)
    y = rs.randint(0, 10, 5 * 8).astype(np.float32)
    mod = pt.mod.Module(net, context=pt.gpu(0))
    mod.bind(data_shapes=[("data", (8, 3, 32, 32))], label_shapes=[("softmax_label", (8,))])
    pt.random.seed(5)
    mod.init_params(initializer=pt.init.Xavier(magnitude=2.0))
    mod.init_optimizer(optimizer="sgd", optimizer_params=(("learning_rate", 0.05),
                                                          ("momentum", 0.9), ("wd", 1e-4)))
    batches = [pt.io.DataBatch(data=[pt.nd.array(x[i * 8:(i + 1) * 8], ctx=pt.gpu(0))],
                               label=[pt.nd.array(y[i * 8:(i + 1) * 8], ctx=pt.gpu(0))])
               for i in range(5)]
    for b in batches[:2]:
        mod.forward_backward(b)
        mod.update()
    (graph,) = mod._spmd.trainer._graphs.values()
    args, aux = (({k: v.asnumpy().copy() for k, v in d.items()}) for d in mod.get_params())
    states = pickle.loads(mod._spmd.get_states())
    writer = ckpt.Checkpointer(str(tmp_path))
    gate = threading.Event()
    writer._submit(gate.wait, step=0, block=False)
    weights, frozen_states = mod._spmd.freeze()
    writer.save_replicated(2, weights, states_bytes=frozen_states)
    replays = graph.replays
    for b in batches[2:]:
        mod.forward_backward(b)
        mod.update()
    torch.cuda.synchronize()
    assert graph.replays == replays + 3
    moved = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert any(not np.array_equal(moved[k], args[k]) for k in args)
    gate.set()
    writer.close()
    d = ckpt.step_dir(str(tmp_path), 2)
    blob = ckpt._load_npz_checked(d + "/weights.npz")
    for k, v in args.items():
        assert np.array_equal(blob["arg:" + k], v), k
    for k, v in aux.items():
        assert np.array_equal(blob["aux:" + k], v), k
    with open(d + "/states.bin", "rb") as f:
        written = pickle.load(f)
    assert int(written["t"]) == int(states["t"]) == 2
    for k, v in states["mom"].items():
        assert np.array_equal(written["mom"][k], v), k


def test_sharded_save_and_resume_on_one_nccl_rank(dev, tmp_path, monkeypatch):
    """The MNIST mlp on one NCCL rank of dist_sync with the sharded update:
    the flat shards live on the card, ``save_sharded`` every 2 steps, and a
    fresh module seeded by ``load_sharded_checkpoint`` continues to the
    uninterrupted run's bits, kernel 6 launching on both. The uninterrupted
    run ends on the weights of the same steps through the per-key Updater
    (``MXNET_KVSTORE_UPDATE=replicated``, the path the JAX package takes for
    one process) within rtol 1e-5, atol 1e-6."""
    import socket

    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch import ops

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"MXNET_TPU_COORDINATOR": "127.0.0.1:%d" % port, "MXNET_TPU_NUM_WORKERS": "1",
                 "MXNET_TPU_WORKER_ID": "0", "MXNET_MODULE_FUSED_STEP": "0",
                 "MXNET_KVSTORE_UPDATE": "sharded", "MXNET_DEFAULT_CONTEXT": "gpu"}.items():
        monkeypatch.setenv(k, v)
    net = pt.models.get_symbol("mlp", num_classes=10)
    rs = np.random.RandomState(6)
    x = rs.rand(6 * 40, 784).astype(np.float32)
    y = rs.randint(0, 10, 6 * 40).astype(np.float32)
    shapes, _, _ = net.infer_shape(data=(40, 784))
    params = {n: (rs.randn(*s) * 0.05).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes) if n not in ("data", "softmax_label")}
    batches = [pt.io.DataBatch(data=[pt.nd.array(x[i * 40:(i + 1) * 40], ctx=pt.gpu(0))],
                               label=[pt.nd.array(y[i * 40:(i + 1) * 40], ctx=pt.gpu(0))])
               for i in range(6)]

    def module():
        m = pt.mod.Module(net, context=pt.gpu(0))
        m.bind(data_shapes=[("data", (40, 784))], label_shapes=[("softmax_label", (40,))])
        m.init_params(arg_params={k: pt.nd.array(v, ctx=pt.cpu()) for k, v in params.items()})
        m.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                         optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
        return m

    try:
        m = module()
        kv = m._kvstore
        assert pt.dist.backend() == "nccl" and kv.num_workers == 1
        writer = ckpt.Checkpointer(str(tmp_path))
        ops.reset_launch_counts()
        for i, b in enumerate(batches):
            m.forward_backward(b)
            m.update()
            if (i + 1) % 2 == 0 and i + 1 < 6:
                assert kv._bucket_engine.mode == "sharded"
                writer.save_sharded(kv, i + 1)
        writer.close()
        assert ops.launch_counts()["matmul_bias_act"] == 2 * 6
        want = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
        step, manifest = ckpt.latest_complete(str(tmp_path))
        assert step == 4 and manifest["kind"] == "sharded"
        m2 = module()
        loaded, weights = m2._kvstore.load_sharded_checkpoint(str(tmp_path))
        names = m2._param_names
        m2.set_params({names[k]: pt.nd.array(v, ctx=pt.gpu(0)) for k, v in weights.items()}, {},
                      allow_missing=True)
        ops.reset_launch_counts()
        for b in batches[4:]:
            m2.forward_backward(b)
            m2.update()
        assert ops.launch_counts()["matmul_bias_act"] == 2 * 2
        got = {k: v.asnumpy() for k, v in m2.get_params()[0].items()}
        monkeypatch.setenv("MXNET_KVSTORE_UPDATE", "replicated")
        m3 = module()
        for b in batches:
            m3.forward_backward(b)
            m3.update()
        assert m3._kvstore._bucket_engine is None
        per_key = {k: v.asnumpy() for k, v in m3.get_params()[0].items()}
    finally:
        pt.dist.shutdown()
    assert loaded == 4
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        np.testing.assert_allclose(want[k], per_key[k], rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------ the pipeline, the sharded stats
def _narrow_resnet():
    from mxnet_tpu_torch.models import resnet

    with pt.name.NameManager():
        body = resnet.residual_unit(pt.sym.Variable("data"), 32, (1, 1), False, "u1")
        body = resnet.residual_unit(body, 32, (2, 2), False, "u2")
        body = resnet.residual_unit(body, 32, (1, 1), True, "u3")
        bn = pt.sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn")
        relu = pt.sym.Activation(data=bn, act_type="relu", name="relu")
        pool = pt.sym.Pooling(data=relu, global_pool=True, kernel=(8, 8), pool_type="avg",
                              name="pool")
        fc = pt.sym.FullyConnected(data=pt.sym.Flatten(data=pool), num_hidden=10, name="fc")
        return pt.sym.SoftmaxOutput(data=fc, name="softmax")


def test_resnet_pipeline_on_the_card_matches_the_cpu(dev):
    """A ResNet-shaped net (three bottlenecks from the zoo's
    ``residual_unit``) through ``PipelineExecutorGroup`` (two stages, two
    microbatches of 4) on the card and on the CPU from the same weights:
    the conv+BN kernels launch once a site a microbatch in the forward
    phase and again in the recompute, the backward kernel once; gradients
    and moving stats agree with the CPU's (rtol 1e-3, atol 1e-3·max|g|)."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.module import PipelineExecutorGroup

    net = _narrow_resnet()
    B, mu, shape = 8, 2, (8, 16, 16, 16)
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape)
    rs = np.random.RandomState(0)
    args = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("_gamma") else rs.randn(*s) * 0.2
                ).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes) if n not in ("data", "softmax_label")}
    aux = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("_var") else rs.uniform(-0.1, 0.1, s)
               ).astype(np.float32) for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    x = rs.uniform(-1, 1, shape).astype(np.float32)
    y = rs.randint(0, 10, B).astype(np.float32)
    got = []
    for ctx in (pt.gpu(0), pt.cpu()):
        pg = PipelineExecutorGroup(net, ctx, [("data", shape)], [("softmax_label", (B,))],
                                   num_stages=2, microbatches=mu)
        pg.set_params(args, aux)
        sites = sum(sum(1 for d in ex._prog.fusion_plan.values() if d["kind"] == "conv")
                    for ex in pg.execs)
        batch = pt.io.DataBatch(data=[pt.nd.array(x, ctx=ctx)], label=[pt.nd.array(y, ctx=ctx)])
        ops.reset_launch_counts()
        pg.forward_backward(batch)
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert sites == 10
            assert counts["conv_bn"] == 2 * sites * mu and counts["conv_bn_bwd"] == sites * mu
        a, x_ = {}, {}
        pg.get_params(a, x_)
        got.append(({n: pg._owner(n).grad_dict[n].asnumpy() for n in args},
                    {n: v.asnumpy() for n, v in x_.items()}))
    for n in args:
        want = got[1][0][n]
        torch.testing.assert_close(torch.from_numpy(got[0][0][n]), torch.from_numpy(want),
                                   rtol=1e-3, atol=1e-3 * float(abs(want).max()))
    for n in aux:
        torch.testing.assert_close(torch.from_numpy(got[0][1][n]), torch.from_numpy(got[1][1][n]),
                                   rtol=1e-3, atol=1e-5)


def test_conv_block_sharded_on_one_nccl_rank_is_bitwise_conv_block(dev):
    """``fusion._conv_block_sharded`` over a one-rank NCCL group: outputs,
    statistics and every gradient bitwise those of ``ConvBlock`` (the
    all_reduce of one rank copies), one forward and one backward launch
    each; the group destroyed after."""
    import socket

    import torch.distributed as tdist

    from mxnet_tpu_torch import fusion, ops
    from mxnet_tpu_torch.parallel.mesh import Mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    store = tdist.TCPStore("127.0.0.1", port, 1, is_master=True)
    tdist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = Mesh(np.array([pt.gpu(0)], dtype=object), ("data",), 1, tdist.group.WORLD)
        x, w = _randn(dev, 4, 64, 28, 28), _randn(dev, 64, 64, 3, 3, scale=0.05)
        scale, shift = _randn(dev, 64).abs() + 0.5, _randn(dev, 64, scale=0.1, seed=1)
        res = _randn(dev, 4, 64, 28, 28, seed=2)
        cots = [_randn(dev, 4, 64, 28, 28, seed=3), _randn(dev, 64, seed=4),
                _randn(dev, 64, seed=5)]
        results = []
        for sharded in (True, False):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, scale, shift, res)]
            ops.reset_launch_counts()
            if sharded:
                outs = fusion._conv_block_sharded(mesh, *leaves, (1, 1), True)
            else:
                outs = cb.ConvBlock.apply(*leaves, (1, 1), True)
            grads = torch.autograd.grad(outs, leaves, grad_outputs=cots)
            torch.cuda.synchronize()
            results.append(([o.detach() for o in outs] + list(grads), ops.launch_counts()))
    finally:
        tdist.destroy_process_group()
    assert not tdist.is_initialized()
    for a, b in zip(results[0][0], results[1][0]):
        assert torch.equal(a, b)
    assert results[0][1]["conv_bn"] == results[0][1]["conv_bn_bwd"] == 1


# ------------------------------------------------------------ native runtime
def _image_pack(tmp_path, n=20, size=40):
    from mxnet_tpu_torch import recordio

    rs = np.random.RandomState(0)
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "p.idx"), str(tmp_path / "p.rec"), "w")
    for i in range(n):
        img = rs.randint(0, 255, (size, size, 3), np.uint8)
        rec.write_idx(i, recordio.pack_img((0, float(i), i, 0), img))
    rec.close()
    return str(tmp_path / "p.rec"), str(tmp_path / "p.idx")


def test_image_batches_reach_the_card_through_two_page_locked_buffers(dev, tmp_path):
    """ImageRecordIter on the card writes each batch into one of two
    page-locked buffers in turn and copies it without blocking: the batches
    on the card equal the CPU iterator's (whichever decode path runs), and
    a batch stays whole after its buffer was written again."""
    from mxnet_tpu_torch import image

    rec, idx = _image_pack(tmp_path)
    kw = dict(data_shape=(3, 32, 32), batch_size=4, mean_r=120.0, mean_g=110.0,
              mean_b=100.0, preprocess_threads=1, path_imgidx=idx)
    with pt.gpu(0):
        it = image.ImageRecordIter(rec, **kw)
        card = [b for b in it]
    with pt.cpu():
        host = [b for b in image.ImageRecordIter(rec, **kw)]
    staging = it._staging
    assert staging is not None and staging._pinned
    assert all(t.is_pinned() for bufs in staging._sets for t in bufs)
    assert staging._sets[0][0].data_ptr() != staging._sets[1][0].data_ptr()
    assert len(card) == len(host) == 5
    for c, h in zip(card, host):
        assert c.data[0].context == pt.gpu(0) and c.label[0].context == pt.gpu(0)
        np.testing.assert_array_equal(c.data[0].asnumpy(), h.data[0].asnumpy())
        np.testing.assert_array_equal(c.label[0].asnumpy(), h.label[0].asnumpy())


def test_c_abis_at_dev_type_2_place_arrays_and_predictors_on_the_card(dev, tmp_path):
    """Driven in this process through ctypes: ``MXNDArrayCreate`` at
    dev_type 2 makes an array on the card, 1 on the CPU; ``MXPredCreate``
    at dev_type 2 serves on the card, equal to the in-process Predictor."""
    import ctypes

    from mxnet_tpu_torch import c_api, predict_api

    lib = ctypes.CDLL(c_api.build())
    lib.MXNDArrayCreate.argtypes = [ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_void_p)]
    lib.MXGetLastError.restype = ctypes.c_char_p
    for dev_type, want in ((2, pt.gpu(0)), (1, pt.cpu())):
        handle = ctypes.c_void_p()
        assert lib.MXNDArrayCreate((ctypes.c_uint32 * 2)(2, 3), 2, dev_type, 0, 0,
                                   ctypes.byref(handle)) == 0, lib.MXGetLastError()
        arr = ctypes.cast(handle, ctypes.POINTER(ctypes.py_object))[0]  # the handle's array
        assert arr.context == want and arr.shape == (2, 3)
        assert lib.MXNDArrayFree(handle) == 0

    rs = np.random.RandomState(0)
    net = pt.sym.SoftmaxOutput(pt.sym.FullyConnected(pt.sym.Variable("data"), num_hidden=5,
                                                     name="fc"), name="softmax")
    pt.nd.save(str(tmp_path / "m.params"),
               {"arg:fc_weight": pt.nd.array(rs.randn(5, 8).astype(np.float32), ctx=pt.cpu()),
                "arg:fc_bias": pt.nd.array(rs.randn(5).astype(np.float32), ctx=pt.cpu())})
    params = (tmp_path / "m.params").read_bytes()
    x = rs.rand(4, 8).astype(np.float32)
    plib = ctypes.CDLL(predict_api.build())
    handle = ctypes.c_void_p()
    keys = (ctypes.c_char_p * 1)(b"data")
    assert plib.MXPredCreate(net.tojson().encode(), params, len(params), 2, 0, 1, keys,
                             (ctypes.c_uint32 * 2)(0, 2), (ctypes.c_uint32 * 2)(4, 8),
                             ctypes.byref(handle)) == 0
    pred = ctypes.cast(handle, ctypes.POINTER(ctypes.py_object))[0]
    assert pred._ctx == pt.gpu(0)
    assert plib.MXPredSetInput(handle, b"data", x.ctypes.data_as(ctypes.c_void_p), x.size) == 0
    assert plib.MXPredForward(handle) == 0
    got = np.zeros((4, 5), np.float32)
    assert plib.MXPredGetOutput(handle, 0, got.ctypes.data_as(ctypes.c_void_p), got.size) == 0
    assert plib.MXPredFree(handle) == 0
    want = pt.predictor.Predictor(net.tojson(), params, {"data": (4, 8)})
    want.forward(data=x)
    np.testing.assert_allclose(got, want.get_output(0), rtol=1e-5, atol=1e-6)


def test_one_replica_fleet_of_resnet18_is_bitwise_the_in_process_cache(dev, tmp_path,
                                                                        monkeypatch):
    """A replica process binds ``gpu(0)`` by default, builds nothing the
    parent built, and serves resnet-18 through the Router with the bits
    of a cache in this process."""
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.serving import PersistentExecutableCache
    from mxnet_tpu_torch.serving.fleet import Fleet, save_params_npz

    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    cuda_build.library()
    kw = dict(num_layers=18, num_classes=10, image_shape="3,32,32")
    net = pt.models.get_symbol("resnet", **kw)
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1, 3, 32, 32), softmax_label=(1,))
    rs = np.random.RandomState(0)
    args = {n: (rs.randn(*s) * (0.5 if n.endswith(("gamma", "beta")) else
                                math.sqrt(2.0 / max(1, np.prod(s[1:]))))).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    path = tmp_path / "params.npz"
    save_params_npz(str(path), args, aux)
    x = rs.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    want = PersistentExecutableCache(net, args, aux, ctx=pt.gpu(0)).run({"data": x})[0]
    spec = {"model": "resnet", "model_kwargs": kw, "item_shapes": {"data": [3, 32, 32]},
            "buckets": [1, 2, 4], "params": str(path)}
    with Fleet(spec, n_replicas=1, workdir=str(tmp_path / "fleet"),
               ready_timeout_s=300) as fl:
        got = fl.router.infer({"data": x}, timeout=120)[0]
        assert fl.supervisor.states()[0]["restarts"] == 0
    assert got.shape == (4, 10) and np.array_equal(got, want)


def test_profiler_summarizes_the_cards_kernels(dev, tmp_path):
    """On the card the profiler's device rows are the kernels the window
    launched: a conv_bn launch shows by its kernel's name."""
    from mxnet_tpu_torch import profiler

    x, w = _randn(dev, 2, 64, 14, 14), _randn(dev, 64, 64, 3, 3, scale=0.05)
    scale, shift = _randn(dev, 64).abs() + 0.5, _randn(dev, 64, scale=0.1)
    cb.conv_block_infer(x, w, scale, shift, relu=True)  # built and loaded before the window
    torch.cuda.synchronize()
    profiler.profiler_set_config(mode="all", filename=str(tmp_path / "p.json"))
    profiler.profiler_set_state("run")
    before = cb.infer_launches
    for _ in range(3):
        cb.conv_block_infer(x, w, scale, shift, relu=True)
    torch.cuda.synchronize()
    profiler.profiler_set_state("stop")
    assert cb.infer_launches == before + 3
    rows = profiler.summarize(top=100)
    conv = [r for r in rows if "conv_bn" in r["name"]]
    assert conv and sum(r["count"] for r in conv) >= 3, rows
    assert all(r["ms"] >= 0 for r in rows)
    path = profiler.dump_profile()
    assert path and profiler.trace_files()[0] == path
