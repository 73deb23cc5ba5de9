"""Matmul + bias + activation: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mxnet_tpu/ops/pallas_matmul_bias_act.py``
``_fwd_call`` (:67) → ``_kernel`` (:57): C = act(A·Wᵀ + b) with A (M, K), W
(N, K) in the FullyConnected layout, b (N,), and the bias and activation
applied on the f32 accumulator.

The kernel is ``csrc/matmul_bias_act.cu``: a shared-memory-tiled f32 GEMM
that contracts both operands along their contiguous K axis, masks ragged M
and N, and runs the epilogue before its one store. On an H100 the
prefill's ffn1 is bound by operations, the decode's (M = 8) by bytes.

``matmul_bias_act`` is the dispatcher: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches.

``MatmulBiasAct`` is the autograd Function. Its backward is ``_mba_bwd``
(:136) as the JAX package has it, which is no Pallas kernel: dpre comes from
the activated output (relu: y > 0; sigmoid: y(1 − y); tanh: 1 − y²;
softrelu: 1 − e^{−y}), then three products, da = dpre·W, dW = dpreᵀ·a and
db = Σ dpre, which stay ``torch.matmul`` and a sum as JAX leaves them to XLA.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_build
from .nn import _ACTS

__all__ = ["matmul_bias_act", "matmul_bias_act_plain", "MatmulBiasAct", "ACTIVATIONS"]

#: the kernel's activation codes, by position
ACTIVATIONS = ("relu", "sigmoid", "tanh", "softrelu")

#: each activation's derivative, from the ACTIVATED output y
_DERIVATIVES = {
    "relu": lambda y: (y > 0).to(y.dtype),
    "sigmoid": lambda y: y * (1.0 - y),
    "tanh": lambda y: 1.0 - y * y,
    # y = log(1 + e^p)  =>  act'(p) = sigmoid(p) = 1 - e^{-y}
    "softrelu": lambda y: 1.0 - torch.exp(-y),
}

launches = 0


def matmul_bias_act_plain(a, w, b, act="relu"):
    """The kernel's function in plain PyTorch."""
    p = torch.matmul(a, w.t())
    if b is not None:
        p = p + b
    return _ACTS[act](p)


def matmul_bias_act(a, w, b, act="relu"):
    """``act(a @ w.T + b)`` for a (M, K), w (N, K) and b (N,) or None."""
    if act not in ACTIVATIONS:
        raise MXNetError("matmul_bias_act: act must be one of %s, got %r" % (ACTIVATIONS, act))
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[1] \
            or (b is not None and b.shape != (w.shape[0],)):
        raise MXNetError("matmul_bias_act: want a (M, K), w (N, K), b (N,), got %s, %s, %s"
                         % (tuple(a.shape), tuple(w.shape),
                            None if b is None else tuple(b.shape)))
    if a.device.type == "cpu":
        return matmul_bias_act_plain(a, w, b, act)
    operands = (a, w) if b is None else (a, w, b)
    cuda_build.check_operands("matmul_bias_act", *operands)
    M, K = a.shape
    N = w.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    lib = cuda_build.library()
    global launches
    with torch.cuda.device(a.device):
        code = lib.mxt_matmul_bias_act_fwd(
            a.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            c.data_ptr(), M, N, K, ACTIVATIONS.index(act),
            torch.cuda.current_stream(a.device).cuda_stream)
        launches += 1
    cuda_build.check(code, "matmul_bias_act")
    return c


class MatmulBiasAct(torch.autograd.Function):
    """y = matmul_bias_act(a, w, b, act); saves (a, w, y) and recovers the
    pre-activation gradient from y, as ``_mba_fwd``/``_mba_bwd`` (:131-146) do."""

    @staticmethod
    def forward(ctx, a, w, b, act):
        y = matmul_bias_act(a, w, b, act)
        ctx.save_for_backward(a, w, y)
        ctx.act, ctx.has_bias = act, b is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        a, w, y = ctx.saved_tensors
        dpre = dy * _DERIVATIVES[ctx.act](y)
        da = torch.matmul(dpre, w)
        dw = torch.matmul(dpre.t(), a)
        db = dpre.sum(dim=0) if ctx.has_bias else None
        return da, dw, db, None
