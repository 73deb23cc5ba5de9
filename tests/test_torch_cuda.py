"""The port's CUDA kernels on the card: each against its plain version at
ragged shapes, and the dispatchers' refusals. Marked ``cuda``; on a host
without a card every test skips. This file imports nothing of JAX, so on a
card host without JAX it runs with the JAX suite's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import math

import pytest
import torch

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ptf
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import matmul_bias_act as mba
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


@pytest.mark.parametrize("BH,T,S,D,causal", [(2, 1, 1, 8, True), (3, 33, 33, 64, True),
                                             (2, 17, 95, 128, True), (2, 40, 9, 72, False)])
def test_flash_attention_kernel_matches_plain(dev, BH, T, S, D, causal):
    q, k, v = _randn(dev, BH, T, D), _randn(dev, BH, S, D), _randn(dev, BH, S, D)
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


@pytest.mark.parametrize("BH,T,S,D,causal", [(2, 1, 1, 8, True), (3, 33, 33, 64, True),
                                             (2, 17, 95, 128, True), (2, 40, 9, 72, False),
                                             (2, 64, 64, 64, True)])
def test_flash_attention_bwd_kernels_match_plain(dev, BH, T, S, D, causal):
    q, k, v, do = (_randn(dev, BH, n, D, seed=i) for i, n in enumerate((T, S, S, T)))
    o, lse = fa.flash_attention(q, k, v, causal=causal)
    before = (fa.dq_launches, fa.dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


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
                                   "norm_residual_bwd": 2 * L + 1, "matmul_bias_act": L}
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
