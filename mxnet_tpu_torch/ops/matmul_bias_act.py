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
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_build
from .nn import _ACTS

__all__ = ["matmul_bias_act", "matmul_bias_act_plain", "ACTIVATIONS"]

#: the kernel's activation codes, by position
ACTIVATIONS = ("relu", "sigmoid", "tanh", "softrelu")

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
