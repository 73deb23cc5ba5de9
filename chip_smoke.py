#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. Device and build: print the card's name and power limit, build the
   CUDA kernels from ``mxnet_tpu_torch/csrc``.
2. Kernel checks: each kernel (and three kernels compiled at run time
   through ``rtc``) against its plain PyTorch version on the card, at the
   serving, training and deploy paths' shapes and at ragged ones, with its
   time, the plain version's, a PyTorch library call's, and the least time
   the card could take (one JSON line per kernel and shape); matmul_bias_act's
   two schedules timed against each other over M; the conv kernels and their
   float32 plain versions against float64 at stage 4's 3x3.
3. Serving: full-width Transformer-base greedy decode through
   ``KVCacheDecoder`` on the card, with the kernel launch counts of that run
   checked against the path's expected counts (matmul_bias_act's small-M
   schedule at each decode step, its tiles at the prefill), then the same tokens
   teacher-forced through the port on the card and on the CPU, whose logits
   must agree.
4. Training: the same model bound for training (``simple_bind``,
   ``forward_backward``, an SGD-momentum updater) on one fixed batch. One
   step at batch 2 gives the same loss and gradients on the card and on the
   CPU; then timed steps at batch 8 whose launch counts must be the path's
   and whose loss must fall, with a profiler breakdown of one step.
5. ResNet-50 serving: the zoo's ResNet-50 v2 at its ImageNet widths, random
   weights from a numpy seed, bound with ``grad_req="null"`` and run with
   ``forward(is_train=False)`` at batch 32 and at batch 1 (median latency,
   images/s, a profiler breakdown); the stats-free conv_bn kernel's
   launches are the plan's 49 a forward; card and CPU probabilities agree
   at batch 2.
6. ResNet-50 training: the same symbol bound for training at batch 32, one
   fixed batch, SGD-momentum: one step at batch 2 gives the same loss,
   gradients and new moving stats on the card and on the CPU; then timed
   steps whose conv_bn and conv_bn_bwd launches are the plan's 49 each a
   step, whose loss must fall and whose moving stats must change, with a
   profiler breakdown of one step. TF32 must be off in both ResNet phases.
7. Deploy: ResNet-50's symbol, weights and moving stats are written with
   ``model.save_checkpoint``, read back as a string and bytes, and served by
   ``Predictor`` on the default context; raw images are normalised on the
   card by a CUDA kernel compiled at run time through ``rtc``; the
   probabilities must agree with a direct ``bind``; ``reshape`` to batch 1
   and back binds nothing the second time; a second predictor over the
   symbol's internals taps the input of stage 1's 1x1 shortcut convolution,
   and ``matmul_with_stats`` gives that convolution's output and its
   per-channel statistics from the checkpoint's weight, held against
   ``F.conv2d``. Latencies of ``forward`` + ``get_output`` at batch 32 and 1.
8. A ``{"kernels": [...]}`` line of ten kernels, then the card's
   name/power line, then the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# Transformer-base LM (the defaults of models/transformer.get_symbol) and the
# serving shape this smoke drives: prompts of 100 tokens, 64 greedy tokens.
MODEL = dict(vocab_size=32000, num_layers=6, num_heads=8, model_dim=512, ffn_dim=2048)
SERVE = dict(batch=8, prefill_len=128, max_len=256, pos_len=256)
PROMPT_LEN, NEW_TOKENS, SEED = 100, 64, 0
# the training step this smoke drives: 8 sequences of 256 tokens (2048 a
# step), SGD with momentum and rescale_grad = 1/batch as Module sets it
TRAIN = dict(batch=8, seq_len=256, check_batch=2, warmup_steps=2, steps=10, lr=0.002,
             momentum=0.9, wd=1e-4)

# ResNet-50 v2 (models/resnet.get_symbol's ImageNet widths: filters
# 64/256/512/1024/2048, units 3/4/6/3, 1000 classes), f32, TF32 off; not cut.
# Served at batch 32 and 1; trained at batch 32 on one fixed batch with
# SGD-momentum, rescale_grad = 1/batch as Module sets it.
RESNET = dict(num_classes=1000, num_layers=50, image_shape="3,224,224")
RESNET_SERVE = dict(batches=(32, 1), check_batch=2, iters=20)
RESNET_TRAIN = dict(batch=32, check_batch=2, warmup_steps=2, steps=10, lr=0.01, momentum=0.9,
                    wd=1e-4)
# the plan's fused conv sites (49 of the 53 convolutions; conv0 and the three
# 3x3 stride-2 convs stay F.conv2d): one launch each a forward, and one
# backward launch each a training step
RESNET_SITES = 49
# the batch-2 card vs CPU training check: a gradient that misses rtol 1e-3,
# atol 1e-3·max|grad| of the CPU's float32 one must lie as close to the
# CPU's float64 gradient as this many times the CPU's float32 one does (the
# randomly initialised net is chaotic there, PERF.md §6, PR 3)
RESNET_F64_FACTOR = 8.0

# The deploy phase: ResNet-50 served by Predictor from a checkpoint on disk at
# batch 32 and 1; raw images in U(0, 255) are normalised on the card with
# ImageNet's per-channel mean and standard deviation by an rtc kernel.
DEPLOY = dict(batch=32, epoch=10, iters=20, mean=(123.68, 116.78, 103.94),
              std=(58.40, 57.12, 57.38), tap="stage1_unit1_relu1_output",
              tap_weight="stage1_unit1_sc_weight")
# matmul_with_stats: ResNet-50's 1x1 convolutions at batch 32 as (M, K, N)
# matrices (stage 1's 64->256 and 256->64 at 56 x 56, stage 2's 512->128 at
# 28 x 28, stage 4's 2048->512 at 7 x 7), then a ragged one
MATMUL_STATS_SHAPES = [(100352, 64, 256, ""), (100352, 256, 64, "k256_"),
                       (25088, 512, 128, "k512_"), (1568, 2048, 512, "k2048_"),
                       (1000, 70, 200, None)]

# The user kernels rtc compiles at run time. The parameters are the inputs'
# device pointers in order, then the outputs'; sizes are written into the
# source. Beside each stands its plain version, a torch expression.
RTC_NORMALISE = r"""
extern "C" __global__ void rtc_normalise(const float* x, const float* mean, const float* stdv,
                                         float* y) {
  const int HW = %(hw)d, C = %(c)d, n = %(n)d;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int ch = (i / HW) %% C;
    y[i] = (x[i] - mean[ch]) / stdv[ch];
  }
}
"""
RTC_FMA = r"""
extern "C" __global__ void rtc_fma(const float* a, const float* b, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < %(n)d) o[i] = a[i] + b[i] * 3.0f;
}
"""
RTC_SPLIT = r"""
extern "C" __global__ void rtc_split(const float* x, float* o1, float* o2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < %(n)d) { o1[i] = x[i] + 1.0f; o2[i] = x[i] - 1.0f; }
}
"""
# the tensor cores' own rate through mma.sync (m16n8k8, TF32): a block's
# warps each run CHAINS independent accumulators for ITERS rounds, with no
# memory traffic; %(step)s is one accumulator's work a round, one product or
# the kernels' 3xTF32 step (tf32x3.cuh mma3: three products), into a fresh
# accumulator added to the running sum. Each chain has its own A and B
# changes every round, so the compiler can neither merge chains nor hoist a
# product out of the loop.
RTC_MMA_RATE = r"""
#define MMA(D, A) asm volatile( \
    "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%%0, %%1, %%2, %%3}, " \
    "{%%4, %%5, %%6, %%7}, {%%8, %%9}, {%%0, %%1, %%2, %%3};\n" \
    : "+f"(D[0]), "+f"(D[1]), "+f"(D[2]), "+f"(D[3]) \
    : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(b0), "r"(b1))
extern "C" __global__ void rtc_mma_rate(const float* in, float* out) {
  const int lane = threadIdx.x & 31;
  unsigned a[%(chains)d][4];
  for (int c = 0; c < %(chains)d; ++c)
    for (int i = 0; i < 4; ++i)
      a[c][i] = __float_as_uint(in[(lane + 8 * i + c) %% 64]) & 0xffffe000u;
  const unsigned b = __float_as_uint(in[(lane + 5) %% 64]) & 0xffffe000u;
  float acc[%(chains)d][4] = {};
  for (int it = 0; it < %(iters)d; ++it) {
    const unsigned b0 = b ^ ((it & 7u) << 13), b1 = b0 ^ 0x2000u;
#pragma unroll
    for (int c = 0; c < %(chains)d; ++c) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      %(step)s
      for (int i = 0; i < 4; ++i) acc[c][i] += d[i];
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""
MMA_RATE_STEPS = {"tf32": (1, "MMA(d, a[c]);"),
                  "mma3": (3, "MMA(d, a[c]); MMA(d, a[c]); MMA(d, a[c]);")}
MMA_RATE = dict(chains=8, iters=4096, blocks_per_sm=2, threads=256)

# Published peaks, dense, from NVIDIA's H100 data sheet: float32 outside the
# tensor cores, TF32 on the tensor cores (half the sheet's figure with
# sparsity) and HBM bandwidth.
PEAKS = {"PCIe": dict(f32=51e12, tf32=378e12, bytes=2.0e12),
         "NVL": dict(f32=60e12, tf32=417.5e12, bytes=3.9e12),
         "SXM": dict(f32=67e12, tf32=495e12, bytes=3.35e12)}
# matmul_bias_act's small-M schedule against its tiles at the decode's K and
# N, on both sides of the crossover (ops/matmul_bias_act.py SMALL_M_MAX)
CROSSOVER_M = (8, 16, 32, 48, 64, 96, 128, 160, 192, 256)

# kernel checks: the largest absolute difference of each kernel from its
# plain version (f32, TF32 off; the two sum in other orders: K-long dot
# products for the GEMM, S-long ones for dq, T-long ones for dk/dv, and
# 2048-row column sums for LayerNorm's dgamma and dbeta)
TOL = {"flash_attention": 1e-5, "norm_residual": 1e-5, "matmul_bias_act": 1e-4,
       "flash_attention_dq": 1e-4, "flash_attention_dkv": 1e-4, "norm_residual_bwd": 1e-4}
# the conv kernels: each output's largest difference from the plain version
# over the plain version's largest magnitude. c and dx are K·taps- and
# N·taps-long f32 dot products (up to 4608 terms); ssum, ssq, dw, dscale and
# dshift are B·H'W'-long f32 sums (up to 100 352 terms), taken in another
# order than cuDNN's and torch.sum's
CONV_TOL = {"elementwise": 1e-5, "sums": 1e-4}

# the conv_bn_bwd call's kernels (csrc/conv_bn_bwd.cu), timed one by one
BWD_PARTS = ("fold", "wflip", "dgrad", "wgrad", "partials_sum")

# name -> (source, the TPU kernel it replaces, its symbol in the profiler)
KERNELS = {
    "flash_attention": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                        "mxnet_tpu/ops/pallas_attention.py:81", "flash_fwd_kernel"),
    "flash_attention_dq": ("mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                           "mxnet_tpu/ops/pallas_attention.py:118", "flash_bwd_dq_kernel"),
    "flash_attention_dkv": ("mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                            "mxnet_tpu/ops/pallas_attention.py:151", "flash_bwd_dkv_kernel"),
    "norm_residual": ("mxnet_tpu_torch/csrc/norm_residual.cu",
                      "mxnet_tpu/ops/pallas_norm_residual.py:78", "layer_norm_fwd_kernel"),
    # both of its kernels: layer_norm_bwd_kernel and layer_norm_bwd_sums_kernel
    "norm_residual_bwd": ("mxnet_tpu_torch/csrc/norm_residual.cu",
                          "mxnet_tpu/ops/pallas_norm_residual.py:92", "layer_norm_bwd"),
    "matmul_bias_act": ("mxnet_tpu_torch/csrc/matmul_bias_act.cu",
                        "mxnet_tpu/ops/pallas_matmul_bias_act.py:57", "matmul_bias_act"),
    "conv_bn": ("mxnet_tpu_torch/csrc/conv_bn.cu", "mxnet_tpu/ops/pallas_conv_bn.py:240",
                "conv_bn_fwd"),
    "conv_bn_bwd": ("mxnet_tpu_torch/csrc/conv_bn_bwd.cu", "mxnet_tpu/ops/pallas_conv_bn.py:511",
                    "conv_bn_bwd"),
    "matmul_stats": ("mxnet_tpu_torch/csrc/matmul_stats.cu",
                     "mxnet_tpu/ops/pallas_matmul_stats.py:47", "matmul_stats"),
    # the mechanism is rtc.py; the kernels it launches here are the strings above
    "rtc": ("mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:65", "rtc_"),
}


def check(cond, what):
    """Fail the run (also under python -O, which strips asserts)."""
    if not cond:
        raise RuntimeError("chip_smoke check failed: %r" % (what,))


def log(obj):
    print(json.dumps(obj), flush=True)


def with_zeros(expected):
    """An expected launch-count dict over every counter of the port, 0 where
    ``expected`` names none."""
    from mxnet_tpu_torch import ops

    return {k: expected.get(k, 0) for k in ops.KERNELS}


def peaks_for(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def device_events(fn, iters=30):
    """The profiler's device time per call of each kernel ``fn`` runs on the
    card, {name: ms}. Fails the run when the profiler shows none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # now and then the profiler hands back a window without any device event
    # (one window in some ten runs of this script): such a window is taken
    # again, and the run fails when three in a row show nothing
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = {}
        for evt in prof.key_averages():
            if str(getattr(evt, "device_type", "")).endswith("CUDA"):
                us[evt.key] = us.get(evt.key, 0.0) + float(
                    getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total",
                                                                   0.0)))
        if sum(us.values()) > 0:
            break
    check(sum(us.values()) > 0, "the profiler shows no device time")
    return {k: v / 1e3 / iters for k, v in us.items()}


def device_ms(fn, iters=30, key=None):
    """Device time per call of everything ``fn`` runs on the card (or of the
    events whose name holds ``key``), from the profiler's CUDA events. Fails
    the run when that is none: every time this script reports is that one
    measure, but for ``event_ms``."""
    ms = sum(v for k, v in device_events(fn, iters).items() if key is None or key in k)
    check(ms > 0, ("the profiler shows no device time", key))
    return ms


def event_ms(fn, iters=30):
    """Time per call of ``fn`` between two CUDA events around ``iters``
    calls on the current stream, after a warm-up: the cross-check of the
    profiler's time. The calls are queued behind a sleep on the card that
    outlasts their queueing (checked, and the sleep made longer until it
    does), so the window holds the card's time and none of the host's."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    for _ in range(6):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_first = not start.query()  # the card still slept when the last call was queued
        torch.cuda.synchronize()
        if queued_first:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("event_ms: the host did not queue %d calls within a sleep of %d cycles"
                       % (iters, cycles // 4))


def bound(flops, nbytes, peaks, products=False):
    """The least time (ms) for ``flops`` operations on ``nbytes`` bytes, and
    what bounds it. ``products``: the work is products that must keep f32
    accuracy, so the operations count three times at the TF32 tensor-core
    rate (3xTF32); otherwise at the f32 rate."""
    t_ops = (3.0 * flops / peaks["tf32"] if products else flops / peaks["f32"]) * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def product_bound(flops, nbytes, peaks):
    """A product kernel's bound on the tensor cores and, as ``f32_bound_ms``,
    its bound on the f32 CUDA cores (the figure earlier slices reported)."""
    b_ms, b_by = bound(flops, nbytes, peaks, products=True)
    return b_ms, b_by, bound(flops, nbytes, peaks)[0]


def entry(name, **fields):
    source, replaces, _ = KERNELS[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces, **fields)


def check_kernels(peaks):
    """Phase 2: each kernel against its plain version; returns the kernels line's
    entries (main-path shape) keyed by kernel name."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import matmul_bias_act as mba
    from mxnet_tpu_torch.ops import norm_residual as nr

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    entries, worst = {}, {}
    L, H = MODEL["num_layers"], MODEL["num_heads"]
    B, P, M = SERVE["batch"], SERVE["prefill_len"], MODEL["model_dim"]
    dh, FF = M // H, MODEL["ffn_dim"]
    BT, T0 = TRAIN["batch"], TRAIN["seq_len"]

    def record(name, prefix, **times):
        """The kernels line's entry: the first timed shape, then others'
        times under their prefix."""
        if not prefix:
            entries[name] = entry(name, **times)
        else:
            entries[name].update({prefix + k: v for k, v in times.items()
                                  if k not in ("bound_by", "shape")})

    # ---- flash attention: (BH, T, S, D, causal); the prefill's, the training
    # step's (also between CUDA events), then ragged
    timed = {0: "", 1: "train_"}
    for i, (BH, T, S, D, causal) in enumerate([(B * H, P, P, dh, True),
                                                (BT * H, T0, T0, dh, True),
                                                (5, 77, 77, 40, True),
                                                (3, 50, 131, 128, True),
                                                (4, 33, 70, 96, False)]):
        q, k, v = randn(BH, T, D), randn(BH, S, D), randn(BH, S, D)
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max(float((o - po).abs().max()), float((lse - plse).abs().max()))
        check(math.isfinite(err) and err <= TOL["flash_attention"],
              ("flash_attention", BH, T, S, D, err))
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0), err)
        rec = {"phase": "kernel", "name": "flash_attention", "shape": [BH, T, S, D],
               "causal": causal, "max_abs_err": err}
        if i in timed:
            pairs = causal_pairs(T, S, causal)
            ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
            plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal))
            q4, k4, v4 = (t.reshape(BH // H, H, -1, D) for t in (q, k, v))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
            b_ms, b_by, f32_ms = product_bound(
                4.0 * D * pairs * BH, 4.0 * (2 * BH * T * D + 2 * BH * S * D + BH * T), peaks)
            # f32_work_tflops: the products' f32 work a second, against
            # mma_sync_rate's ceiling
            times = dict(plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         f32_bound_ms=f32_ms, f32_work_tflops=4.0 * D * pairs * BH / ms / 1e9)
            rec.update(kernel_ms=ms, **times)
            if timed[i] == "train_":
                # the call alone between two CUDA events: the profiler's cross-check
                times["event_ms"] = event_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
                rec["flash_attention_event_ms"] = times["event_ms"]
            record("flash_attention", timed[i], ms=ms, **times,
                   shape="prefill q,k,v (%d,%d,%d) causal" % (BH, T, D))
        log(rec)

    # ---- LayerNorm + affine: (R, D); prefill rows, decode rows, training rows, ragged
    timed = {0: "", 1: "decode_", 2: "train_"}
    for i, (R, D) in enumerate([(B * P, M), (B, M), (BT * T0, M), (37, 300), (5, 1000)]):
        x, g, bb = randn(R, D), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
        y, mean, rstd = nr.layer_norm_affine(x, g, bb)
        py, pmean, prstd = nr.layer_norm_affine_plain(x, g, bb)
        torch.cuda.synchronize()
        err = max(float((y - py).abs().max()), float((mean - pmean).abs().max()),
                  float((rstd - prstd).abs().max()))
        check(math.isfinite(err) and err <= TOL["norm_residual"], ("norm_residual", R, D, err))
        worst["norm_residual"] = max(worst.get("norm_residual", 0.0), err)
        rec = {"phase": "kernel", "name": "norm_residual", "shape": [R, D], "max_abs_err": err}
        if i in timed:
            ms = device_ms(lambda: nr.layer_norm_affine(x, g, bb))
            plain_ms = device_ms(lambda: nr.layer_norm_affine_plain(x, g, bb))
            lib_ms = device_ms(lambda: F.layer_norm(x, (D,), g, bb, 1e-5))
            b_ms, b_by = bound(7.0 * R * D, 4.0 * (2 * R * D + 2 * D + 2 * R), peaks)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            record("norm_residual", timed[i], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, shape="prefill x (%d,%d)" % (R, D))
        log(rec)

    # ---- matmul + bias + act: (M, K, N, act, bias); prefill ffn1, decode ffn1,
    # training ffn1, ragged
    timed = {0: "", 1: "decode_", 2: "train_"}
    cases = [(B * P, M, FF, "relu", True), (B, M, FF, "relu", True),
             (BT * T0, M, FF, "relu", True),
             (77, 200, 130, "sigmoid", True), (77, 200, 130, "tanh", False),
             (5, 33, 70, "softrelu", True), (130, 65, 3, "relu", True)]
    for i, (Mr, K, N, act, has_b) in enumerate(cases):
        a, w = randn(Mr, K), randn(N, K, scale=1.0 / math.sqrt(K))
        b = randn(N, scale=0.1) if has_b else None
        c = mba.matmul_bias_act(a, w, b, act)
        pc = mba.matmul_bias_act_plain(a, w, b, act)
        torch.cuda.synchronize()
        err = float((c - pc).abs().max())
        check(math.isfinite(err) and err <= TOL["matmul_bias_act"],
              ("matmul_bias_act", Mr, K, N, act, err))
        worst["matmul_bias_act"] = max(worst.get("matmul_bias_act", 0.0), err)
        rec = {"phase": "kernel", "name": "matmul_bias_act", "shape": [Mr, K, N], "act": act,
               "bias": has_b, "max_abs_err": err}
        if i in timed:
            ms = device_ms(lambda: mba.matmul_bias_act(a, w, b, act))
            plain_ms = device_ms(lambda: mba.matmul_bias_act_plain(a, w, b, act))
            lib_ms = device_ms(lambda: torch.relu(torch.addmm(b, a, w.t())))
            b_ms, b_by, f32_ms = product_bound(2.0 * Mr * N * K + 2.0 * Mr * N,
                                               4.0 * (Mr * K + N * K + N + Mr * N), peaks)
            sched = mba._schedule(Mr, N, K)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, f32_bound_ms=f32_ms, schedule=sched)
            record("matmul_bias_act", timed[i], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, f32_bound_ms=f32_ms, library_ms=lib_ms, schedule=sched,
                   shape="prefill ffn1 a (%d,%d) w (%d,%d) relu" % (Mr, K, N, K))
        log(rec)
    check_crossover(randn, M, FF)
    check_backward_kernels(randn, peaks, entries, worst)
    check_conv_kernels(randn, peaks, entries, worst)
    check_deploy_kernels(randn, peaks, entries, worst)
    check_mma_rate(randn, peaks)
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
    return entries


def check_crossover(randn, K, N):
    """matmul_bias_act's two schedules timed against each other at the
    decode's K and N and a range of M: where the small-M schedule stops
    winning is the crossover (SMALL_M_MAX)."""
    from mxnet_tpu_torch.ops import matmul_bias_act as mba

    w, b = randn(N, K, scale=1.0 / math.sqrt(K)), randn(N, scale=0.1)
    rows = []
    for M in CROSSOVER_M:
        a = randn(M, K)
        c = torch.empty(M, N, device=a.device)
        want = mba.matmul_bias_act_plain(a, w, b, "relu")
        row = {"M": M, "picked": mba._schedule(M, N, K)}
        for sched in mba.SCHEDULES:
            if sched == "small_m" and not mba._small_m_takes(M, K):
                continue
            mba._launch(a, w, b, "relu", c, sched)
            torch.cuda.synchronize()
            err = float((c - want).abs().max())
            check(math.isfinite(err) and err <= TOL["matmul_bias_act"],
                  ("matmul_bias_act crossover", M, sched, err))
            row[sched + "_ms"] = device_ms(lambda: mba._launch(a, w, b, "relu", c, sched))
        row["library_ms"] = device_ms(lambda: torch.relu(torch.addmm(b, a, w.t())))
        rows.append(row)
    log({"phase": "kernel", "name": "matmul_bias_act_crossover", "K": K, "N": N,
         "small_m_max": mba.SMALL_M_MAX, "rows": rows})


def causal_pairs(T, S, causal):
    """The (query, key) pairs a bottom-right causal mask leaves visible."""
    return sum(min(S, r + (S - T) + 1) for r in range(T)) if causal else T * S


def check_backward_kernels(randn, peaks, entries, worst):
    """Phase 2, the training path's kernels: flash dq and dk/dv, LayerNorm
    backward, each against its plain version; the first shape of each is the
    training step's, and is timed."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import norm_residual as nr

    H, M = MODEL["num_heads"], MODEL["model_dim"]
    B, T0, dh = TRAIN["batch"], TRAIN["seq_len"], M // H

    # ---- flash backward: (BH, T, S, D, causal)
    for i, (BH, T, S, D, causal) in enumerate([(B * H, T0, T0, dh, True),
                                                (5, 77, 77, 40, True),
                                                (3, 50, 131, 128, True),
                                                (4, 33, 70, 96, False)]):
        q, k, v, do = randn(BH, T, D), randn(BH, S, D), randn(BH, S, D), randn(BH, T, D)
        scale = 1.0 / math.sqrt(D)
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        delta = (do * o).sum(dim=-1)
        args = (q, k, v, lse, do, delta, causal, scale)
        dq, (dk, dv) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
        pdq = fa.flash_attention_bwd_dq_plain(*args)
        pdk, pdv = fa.flash_attention_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        err = {"flash_attention_dq": float((dq - pdq).abs().max()),
               "flash_attention_dkv": max(float((dk - pdk).abs().max()),
                                          float((dv - pdv).abs().max()))}
        for name, e in err.items():
            check(math.isfinite(e) and e <= TOL[name], (name, BH, T, S, D, e))
            worst[name] = max(worst.get(name, 0.0), e)
        rec = {"phase": "kernel", "name": "flash_attention_bwd", "shape": [BH, T, S, D],
               "causal": causal, "max_abs_err_dq": err["flash_attention_dq"],
               "max_abs_err_dkv": err["flash_attention_dkv"]}
        if i == 0:
            pairs = causal_pairs(T, S, causal) * BH
            reads = 4.0 * (2 * BH * T * D + 2 * BH * S * D + 2 * BH * T)
            q4, k4, v4 = (t.reshape(B, H, -1, D).detach().requires_grad_(True)
                          for t in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            do4 = do.reshape(B, H, T, D)
            # one library call computes dq, dk and dv together: SDPA's backward
            lib_ms = device_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                           retain_graph=True))
            for name, fn, plain, flops, writes in (
                    ("flash_attention_dq", fa.flash_attention_bwd_dq,
                     fa.flash_attention_bwd_dq_plain, 6.0 * D * pairs, 4.0 * BH * T * D),
                    ("flash_attention_dkv", fa.flash_attention_bwd_dkv,
                     fa.flash_attention_bwd_dkv_plain, 8.0 * D * pairs, 8.0 * BH * S * D)):
                ms = device_ms(lambda: fn(*args))
                # the pass alone between two CUDA events: the profiler's cross-check
                ev_ms = event_ms(lambda: fn(*args))
                plain_ms = device_ms(lambda: plain(*args))
                b_ms, b_by, f32_ms = product_bound(flops, reads + writes, peaks)
                rec.update({name + "_ms": ms, name + "_event_ms": ev_ms,
                            name + "_plain_ms": plain_ms, name + "_bound_ms": b_ms,
                            name + "_f32_bound_ms": f32_ms})
                entries[name] = entry(
                    name, ms=ms, event_ms=ev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, f32_bound_ms=f32_ms,
                    library_ms=lib_ms, library="SDPA backward (dq, dk and dv together)",
                    shape="train q,k,v,dO (%d,%d,%d) causal" % (BH, T, D))
            # the whole call (δ, dq, dk/dv) and its δ = rowsum(dO∘O) alone
            # between two CUDA events
            bwd_event_ms = event_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                                   causal=causal))
            delta_event_ms = event_ms(lambda: (do * o).sum(dim=-1))
            rec.update(library_ms=lib_ms, dq_plus_dkv_ms=entries["flash_attention_dq"]["ms"]
                       + entries["flash_attention_dkv"]["ms"], bwd_event_ms=bwd_event_ms,
                       delta_event_ms=delta_event_ms)
            entries["flash_attention_dq"]["bwd_event_ms"] = bwd_event_ms
        log(rec)

    # ---- LayerNorm backward: (R, D); the training step's rows, then ragged
    for i, (R, D) in enumerate([(B * T0, M), (8, M), (37, 300), (5, 1000)]):
        x, g, bb, dy = randn(R, D), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1), randn(R, D)
        _, mean, rstd = nr.layer_norm_affine(x, g, bb)
        got = nr.layer_norm_affine_bwd(x, g, mean, rstd, dy)
        want = nr.layer_norm_affine_bwd_plain(x, g, mean, rstd, dy)
        torch.cuda.synchronize()
        err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        check(math.isfinite(err) and err <= TOL["norm_residual_bwd"],
              ("norm_residual_bwd", R, D, err))
        worst["norm_residual_bwd"] = max(worst.get("norm_residual_bwd", 0.0), err)
        rec = {"phase": "kernel", "name": "norm_residual_bwd", "shape": [R, D],
               "max_abs_err": err}
        if i == 0:
            fn = lambda: nr.layer_norm_affine_bwd(x, g, mean, rstd, dy)  # noqa: E731
            ms = device_ms(fn)  # the whole call: the kernel and the partial rows' sums
            kernel_only_ms = device_ms(fn, key="layer_norm_bwd_kernel")
            plain_ms = device_ms(lambda: nr.layer_norm_affine_bwd_plain(x, g, mean, rstd, dy))
            xr, gr, br = (t.detach().requires_grad_(True) for t in (x, g, bb))
            yr = F.layer_norm(xr, (D,), gr, br, 1e-5)
            lib_ms = device_ms(lambda: torch.autograd.grad(yr, (xr, gr, br), dy,
                                                           retain_graph=True))
            # the function's bytes: x and dy read, dx written, mean, rstd and
            # gamma read, dgamma and dbeta written (the partial rows are the
            # design's, not the function's)
            b_ms, b_by = bound(10.0 * R * D, 4.0 * (3 * R * D + 2 * R + 3 * D), peaks)
            rec.update(kernel_ms=ms, kernel_only_ms=kernel_only_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            entries["norm_residual_bwd"] = entry(
                "norm_residual_bwd", ms=ms, kernel_only_ms=kernel_only_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape="train x, dy (%d,%d)" % (R, D))
        log(rec)


def conv_case(randn, B, K, H, W, N, kernel, stride, prologue, res):
    """One fused conv's inputs on the card: x, He-scaled w, scale in
    [0.5, 1.5), small shift, and a residual."""
    x = randn(B, K, H, W)
    w = randn(N, K, kernel, kernel, scale=math.sqrt(2.0 / (K * kernel * kernel)))
    scale = shift = r = None
    if prologue:
        scale = 0.5 + torch.rand(K, device=x.device)
        shift = randn(K, scale=0.1)
    Ho, Wo = (-(-H // stride), -(-W // stride)) if kernel == 1 else (H, W)
    if res:
        r = randn(B, N, Ho, Wo)
    return x, w, scale, shift, r, (Ho, Wo)


def rel_err(got, want):
    """Largest |got − want| over the plain result's largest magnitude."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def conv_bytes(*tensors):
    return 4.0 * sum(t.numel() for t in tensors if t is not None)


def read_of_x(x, kernel, stride):
    """The part of x a conv must read: a strided 1x1 kernel reads only the
    sampled positions x[:, :, ::s, ::s] (a view; only its size is used)."""
    return x[:, :, ::stride, ::stride] if kernel == 1 else x


def check_conv_kernels(randn, peaks, entries, worst):
    """Phase 2, the ResNet path's kernels: the fused conv+BN forward (with
    its statistics, and the stats-free inference variant) and backward,
    each against its plain version, at the path's shapes and ragged ones.
    The first five shapes are the training step's (batch 32) and are
    timed: stage 1's 3x3 64->64 56x56 with a prologue, stage 1's 1x1 64->256
    with a prologue and the residual, stage 2's 1x1 stride-2 256->512
    shortcut, stage 3's 3x3 256->256 at 14x14 and stage 4's 1x1 512->2048
    with the residual at 7x7 (the grids the forward's tiling was cut for)."""
    from mxnet_tpu_torch.ops import conv_bn as cb

    Bt = RESNET_TRAIN["batch"]
    shapes = [  # (B, K, H, W, N, kernel, stride, prologue, res, prefix)
        (Bt, 64, 56, 56, 64, 3, 1, True, False, ""),
        (Bt, 64, 56, 56, 256, 1, 1, True, True, "res1x1_"),
        (Bt, 256, 56, 56, 512, 1, 2, True, False, "s2_"),
        (Bt, 256, 14, 14, 256, 3, 1, True, False, "s3_3x3_"),
        (Bt, 512, 7, 7, 2048, 1, 1, True, True, "s4_res1x1_"),
        (3, 16, 9, 9, 24, 3, 1, True, True, None),
        (2, 16, 9, 9, 40, 1, 2, True, False, None),
        (2, 8, 5, 7, 16, 1, 1, False, True, None),
        (1, 64, 7, 7, 200, 3, 1, False, False, None)]
    for B, K, H, W, N, kernel, stride, prologue, res, prefix in shapes:
        x, w, scale, shift, r, (Ho, Wo) = conv_case(randn, B, K, H, W, N, kernel, stride,
                                                    prologue, res)
        st = (stride, stride)
        got = cb.conv_block(x, w, scale, shift, r, st, prologue)
        want = cb.conv_block_plain(x, w, scale, shift, r, st, prologue)
        infer = cb.conv_block_infer(x, w, scale, shift, st, prologue)
        infer_want = cb.conv_block_infer_plain(x, w, scale, shift, st, prologue)
        dc, ds, dq = randn(B, N, Ho, Wo), randn(N, scale=0.01), randn(N, scale=1e-3)
        args = (x, w, scale, shift, want[0], dc, ds, dq, st, prologue, res)
        gb, pb = cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {"c": rel_err(got[0], want[0]), "c_infer": rel_err(infer, infer_want),
                "ssum": rel_err(got[1], want[1]), "ssq": rel_err(got[2], want[2])}
        for name, g, p in zip(("dx", "dw", "dscale", "dshift", "dres"), gb, pb):
            check((g is None) == (p is None), ("conv_bn_bwd outputs", name))
            if g is not None:
                errs[name] = rel_err(g, p)
        for name, e in errs.items():
            tol = CONV_TOL["elementwise" if name in ("c", "c_infer", "dx", "dres") else "sums"]
            check(math.isfinite(e) and e <= tol, ("conv kernels", name, B, K, H, W, N, kernel,
                                                  stride, e))
        fwd_abs = max(float((got[0] - want[0]).abs().max()), float((infer - infer_want).abs().max()))
        bwd_abs = float((gb[0] - pb[0]).abs().max())
        worst["conv_bn"] = max(worst.get("conv_bn", 0.0), fwd_abs)
        worst["conv_bn_bwd"] = max(worst.get("conv_bn_bwd", 0.0), bwd_abs)
        rec = {"phase": "kernel", "name": "conv_bn", "shape": [B, K, H, W, N, kernel, stride],
               "prologue": prologue, "res": res, "rel_err": errs,
               "max_abs_err_c": fwd_abs, "max_abs_err_dx": bwd_abs}
        if prefix is not None:
            flops = cb.flops(x.shape, w.shape, st)
            c = got[0]
            fwd_ms = device_ms(lambda: cb.conv_block(x, w, scale, shift, r, st, prologue),
                               key=KERNELS["conv_bn"][2])
            infer_ms = device_ms(lambda: cb.conv_block_infer(x, w, scale, shift, st, prologue),
                                 key=KERNELS["conv_bn"][2])
            fwd_plain = device_ms(lambda: cb.conv_block_plain(x, w, scale, shift, r, st,
                                                              prologue))
            xn = cb._prologue(x, scale, shift, prologue)
            pad = (kernel - 1) // 2
            fwd_lib = device_ms(lambda: F.conv2d(xn, w, stride=st, padding=pad))
            xr = read_of_x(x, kernel, stride)
            fb, fby, ff32 = product_bound(flops, conv_bytes(xr, w, scale, shift, r, c) + 8.0 * N,
                                          peaks)
            if stride > 1:
                # the same product through the stride-1 kernel on the sampled
                # input made contiguous: its 16-byte copies move only the
                # elements the strided conv reads, the least any staging of x
                # could move
                xs = x[:, :, ::stride, ::stride].contiguous()
                rec["presampled_ms"] = device_ms(
                    lambda: cb.conv_block(xs, w, scale, shift, r, (1, 1), prologue),
                    key=KERNELS["conv_bn"][2])
            per_kernel = device_events(lambda: cb.conv_block_bwd(*args))
            bwd_ms = sum(v for k, v in per_kernel.items() if KERNELS["conv_bn_bwd"][2] in k)
            check(bwd_ms > 0, ("the profiler shows no conv_bn_bwd kernel", prefix))
            # the backward's kernels one by one, and the whole call between
            # two CUDA events (with its allocations, as bwd_with_allocs_ms)
            rec["bwd_kernels_ms"] = {part: sum(v for k, v in per_kernel.items()
                                               if "conv_bn_bwd_" + part in k)
                                     for part in BWD_PARTS}
            bwd_event_ms = event_ms(lambda: cb.conv_block_bwd(*args))
            bwd_call_ms = device_ms(lambda: cb.conv_block_bwd(*args))
            bwd_plain = device_ms(lambda: cb.conv_block_bwd_plain(*args))
            dce = dc + ds.reshape(1, -1, 1, 1) + 2.0 * c * dq.reshape(1, -1, 1, 1)
            bwd_lib = device_ms(lambda: torch.ops.aten.convolution_backward(
                dce, xn, w, None, list(st), [pad, pad], [1, 1], False, [0, 0], 1,
                [True, True, False]))
            bb, bby, bf32 = product_bound(
                2.0 * flops, conv_bytes(xr, w, scale, shift, c, dc, ds, dq, *gb), peaks)
            rec.update(kernel_ms=fwd_ms, infer_ms=infer_ms, plain_ms=fwd_plain,
                       library_ms=fwd_lib, bound_ms=fb, bound_by=fby, f32_bound_ms=ff32,
                       bwd_kernel_ms=bwd_ms, bwd_with_allocs_ms=bwd_call_ms,
                       bwd_event_ms=bwd_event_ms,
                       bwd_plain_ms=bwd_plain, bwd_library_ms=bwd_lib, bwd_bound_ms=bb,
                       bwd_bound_by=bby, bwd_f32_bound_ms=bf32)
            label = "x (%d,%d,%d,%d) w (%d,%d,%d,%d) stride %d%s%s" % (
                B, K, H, W, N, K, kernel, kernel, stride, " prologue" if prologue else "",
                " + res" if res else "")
            fwd = dict(ms=fwd_ms, infer_ms=infer_ms, plain_ms=fwd_plain, bound_ms=fb,
                       bound_by=fby, f32_bound_ms=ff32, library_ms=fwd_lib)
            bwd = dict(ms=bwd_ms, with_allocs_ms=bwd_call_ms, event_ms=bwd_event_ms,
                       plain_ms=bwd_plain, bound_ms=bb, bound_by=bby, f32_bound_ms=bf32,
                       library_ms=bwd_lib)
            if not prefix:
                entries["conv_bn"] = entry(
                    "conv_bn", library="F.conv2d of the normalised input (the product alone)",
                    shape=label, **fwd)
                entries["conv_bn_bwd"] = entry(
                    "conv_bn_bwd", library="aten.convolution_backward (dgrad + wgrad)",
                    shape=label, **bwd)
            else:
                entries["conv_bn"].update({prefix + k: v for k, v in fwd.items()})
                entries["conv_bn_bwd"].update({prefix + k: v for k, v in bwd.items()})
        log(rec)
    check_conv_f64(randn, cb)


def check_conv_f64(randn, cb):
    """Stage 4's 3x3 (512 -> 512 at 7 x 7: N·taps = 4608-long dx sums) and
    stage 1's (64 -> 64 at 56 x 56: B·H'W' = 100 352-long dw sums, the
    longest), at batch 32, with and without a prologue: the forward and
    backward kernels and their float32 plain versions (cuDNN), each against
    the same function in float64 on the same inputs (with the float32
    prologue's ReLU decisions, conv_f64_pinned). Each kernel output must lie
    within the CONV_TOL of the float64 result."""
    B = RESNET_TRAIN["batch"]
    for K, H, N in ((512, 7, 512), (64, 56, 64)):
        for prologue in (False, True):
            check_conv_f64_case(randn, cb, B, K, H, H, N, prologue)


def check_conv_f64_case(randn, cb, B, K, H, W, N, prologue):
    x, w, scale, shift, _, _ = conv_case(randn, B, K, H, W, N, 3, 1, prologue, False)
    st = (1, 1)
    dc, ds, dq = randn(B, N, H, W), randn(N, scale=0.01), randn(N, scale=1e-3)
    c = cb.conv_block(x, w, scale, shift, None, st, prologue)[0]
    args = (x, w, scale, shift, c, dc, ds, dq, st, prologue, False)
    outs = {"kernel": (c, *cb.conv_block_bwd(*args)),
            "plain_f32": (cb.conv_block_plain(x, w, scale, shift, None, st, prologue)[0],
                          *cb.conv_block_bwd_plain(*args))}
    exact, kinks = conv_f64_pinned(cb, *args[:8], st, prologue)
    names = ("c", "dx", "dw", "dscale", "dshift")
    rec = {"phase": "kernel", "name": "conv_bn_f64", "shape": [B, K, H, W, N, 3, 1],
           "prologue": prologue, "relu_kinks_pinned": kinks}
    for who, got in outs.items():
        rec[who] = {n: rel_err(g.double(), e) for n, g, e in zip(names, got, exact)
                    if e is not None}
    log(rec)
    for n, e in rec["kernel"].items():
        tol = CONV_TOL["elementwise" if n in ("c", "dx") else "sums"]
        check(math.isfinite(e) and e <= tol, ("conv kernels against float64", n, B, K, H, N,
                                              prologue, e))


def conv_f64_pinned(cb, x, w, scale, shift, c, dc, ds, dq, st, relu):
    """The 3x3 conv's forward c and backward (dx, dw, dscale, dshift) in
    float64 on these inputs, but for the ReLU's decisions, which are the
    float32 prologue's as the kernels and the plain version take them: a
    pre-activation within float32 rounding of 0 may fall on the other side
    of the kink in float64 (at stage 1's 3x3, 6.4 million of them, about
    one a run), and its dx then differs by a whole term. So the comparison
    holds the products' long sums alone. Returns the outputs and the count
    of decisions that float64 would have taken otherwise."""
    f, b = torch.float64, (1, -1, 1, 1)
    x64, w64 = x.to(f), w.to(f)
    if scale is None:
        xn, keep, kinks = x64, None, 0
    else:
        pre = x64 * scale.to(f).reshape(b) + shift.to(f).reshape(b)
        keep = (cb._prologue(x, scale, shift, False) > 0).to(f) if relu else None
        kinks = int(((pre > 0).to(f) != keep).sum()) if relu else 0
        xn = pre * keep if relu else pre
    out = F.conv2d(xn, w64, padding=1)
    dce = dc.to(f) + ds.to(f).reshape(b) + 2.0 * c.to(f) * dq.to(f).reshape(b)
    dxn = torch.nn.grad.conv2d_input(x.shape, w64, dce, stride=st, padding=1)
    dw = torch.nn.grad.conv2d_weight(xn, w.shape, dce, stride=st, padding=1)
    if scale is None:
        return (out, dxn, dw, None, None), kinks
    if relu:
        dxn = dxn * keep
    return (out, dxn * scale.to(f).reshape(b), dw, (dxn * x64).sum(dim=(0, 2, 3)),
            dxn.sum(dim=(0, 2, 3))), kinks


def normalise_kernel(pt, shape):
    """The rtc image-normalisation kernel for NCHW ``shape``, with a
    grid-stride launch that fills the card."""
    B, C, H, W = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pt.rtc.Rtc("rtc_normalise", RTC_NORMALISE % dict(hw=H * W, c=C, n=B * C * H * W),
                      kernel_name="rtc_normalise", grid=(8 * sms,), block=(256,))


def check_deploy_kernels(randn, peaks, entries, worst):
    """Phase 2, the deploy path's kernels: matmul_with_stats against its
    plain version at ResNet-50's 1x1 convolutions and a ragged shape, and
    three kernels compiled at run time through rtc against their torch
    expressions."""
    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch.ops import matmul_stats as ms

    for M, K, N, prefix in MATMUL_STATS_SHAPES:
        a, b = randn(M, K), randn(K, N, scale=1.0 / math.sqrt(K))
        got, again = ms.matmul_with_stats(a, b), ms.matmul_with_stats(a, b)
        want = ms.matmul_with_stats_plain(a, b)
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              ("matmul_stats: two runs differ", M, K, N))
        errs = {n: rel_err(g, w) for n, g, w in zip(("c", "col_sum", "col_sumsq"), got, want)}
        for n, e in errs.items():
            check(math.isfinite(e) and e <= CONV_TOL["elementwise" if n == "c" else "sums"],
                  ("matmul_stats", n, M, K, N, e))
        abs_err = float((got[0] - want[0]).abs().max())
        worst["matmul_stats"] = max(worst.get("matmul_stats", 0.0), abs_err)
        rec = {"phase": "kernel", "name": "matmul_stats", "shape": [M, K, N], "rel_err": errs,
               "max_abs_err": abs_err, "bitwise_repeatable": True}
        if prefix is not None:
            ms_ = device_ms(lambda: ms.matmul_with_stats(a, b), key=KERNELS["matmul_stats"][2])
            plain_ms = device_ms(lambda: ms.matmul_with_stats_plain(a, b))

            def library():
                c = torch.mm(a, b)
                return c, c.sum(dim=0), (c * c).sum(dim=0)

            lib_ms = device_ms(library)
            mm_ms = device_ms(lambda: torch.mm(a, b))
            b_ms, b_by, f32_ms = product_bound(2.0 * M * K * N + 3.0 * M * N,
                                               4.0 * (M * K + K * N + M * N + 2 * N), peaks)
            times = dict(ms=ms_, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         f32_bound_ms=f32_ms, library_ms=lib_ms, mm_alone_ms=mm_ms)
            rec.update(times)
            if not prefix:
                entries["matmul_stats"] = entry(
                    "matmul_stats", library="torch.mm + c.sum(0) + (c*c).sum(0)",
                    shape="a (%d,%d) b (%d,%d)" % (M, K, K, N), **times)
            else:
                entries["matmul_stats"].update({prefix + k: v for k, v in times.items()
                                                if k != "bound_by"})
        log(rec)

    # ---- rtc: (a) per-channel normalisation at the deploy batch, (b) a + 3b,
    # (c) one input and two outputs; each synchronised and checked after its push
    gpu = pt.gpu(0)

    def nd(t):
        return pt.nd.NDArray(t, gpu)

    shape = (DEPLOY["batch"],) + image_shape()
    x = torch.rand(*shape, device="cuda") * 255.0
    mean = torch.tensor(DEPLOY["mean"], device="cuda")
    std = torch.tensor(DEPLOY["std"], device="cuda")
    k = normalise_kernel(pt, shape)
    t0 = time.perf_counter()
    (y,) = k.push([nd(x), nd(mean), nd(std)], out_shapes=[shape])
    torch.cuda.synchronize()
    first_push_s = time.perf_counter() - t0
    compiled = k.compiles  # 0 when build/torch_kernels/rtc/ already held the image
    check(compiled <= 1 and k.launches == 1, ("rtc compiles/launches", compiled, k.launches))

    def plain():
        return (x - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)

    want = plain()
    err = float((y._tensor() - want).abs().max())
    # the kernel does the same two IEEE operations an element: equal up to rounding
    check(math.isfinite(err) and err <= 1e-6 * float(want.abs().max()), ("rtc_normalise", err))
    (y2,) = k.push([nd(x), nd(mean), nd(std)], out_shapes=[shape], grid_dims=(1024, 1, 1),
                   block_dims=(128,))
    torch.cuda.synchronize()
    check(k.compiles == compiled and torch.equal(y2._tensor(), y._tensor()),
          "rtc: a second geometry recompiled or changed the result")
    args = [nd(x), nd(mean), nd(std)]
    host_us = []
    for _ in range(50):
        t0 = time.perf_counter()
        k.push(args, out_shapes=[shape])
        host_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    ms_ = device_ms(lambda: k.push(args, out_shapes=[shape]), key="rtc_normalise")
    plain_ms = device_ms(plain)
    n = x.numel()
    b_ms, b_by = bound(2.0 * n, 4.0 * (2 * n + 2 * len(DEPLOY["mean"])), peaks)
    worst["rtc"] = err
    entries["rtc"] = entry("rtc", ms=ms_, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=None, library="no single PyTorch call computes it",
                           shape="rtc_normalise x %s" % (shape,), first_push_s=first_push_s,
                           first_push_compiled=bool(compiled),
                           push_host_us_p50=float(np.median(host_us)))
    log({"phase": "kernel", "name": "rtc_normalise", "shape": list(shape), "max_abs_err": err,
         "bitwise": bool(torch.equal(y._tensor(), want)), "kernel_ms": ms_, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "first_push_s": first_push_s,
         "first_push_compiled": bool(compiled),
         "push_host_us_p50": float(np.median(host_us)),
         "push_host_us_p80": float(np.percentile(host_us, 80))})

    a, b = randn(1000, 333), randn(1000, 333)
    n = a.numel()
    fma = pt.rtc.Rtc("rtc_fma", RTC_FMA % dict(n=n), kernel_name="rtc_fma")
    (o,) = fma.push([nd(a), nd(b)], out_shapes=[a.shape], grid_dims=(-(-n // 256),),
                    block_dims=(256,))
    torch.cuda.synchronize()
    want = a + b * 3.0
    err_fma = float((o._tensor() - want).abs().max())
    # the compiler may fuse the multiply into the add: one rounding fewer
    check(err_fma <= 1e-6 * float(want.abs().max()), ("rtc_fma", err_fma))
    split = pt.rtc.Rtc("rtc_split", RTC_SPLIT % dict(n=n), kernel_name="rtc_split",
                       grid=(-(-n // 128),), block=(128,))
    o1, o2 = split.push([nd(a)], out_shapes=[a.shape, (n,)])
    torch.cuda.synchronize()
    check(o2.shape == (n,) and o2.dtype == np.float32, ("rtc_split output", o2.shape, o2.dtype))
    err_split = max(float((o1._tensor() - (a + 1.0)).abs().max()),
                    float((o2._tensor() - (a - 1.0).reshape(-1)).abs().max()))
    check(err_split == 0.0, ("rtc_split", err_split))
    worst["rtc"] = max(worst["rtc"], err_fma, err_split)
    for name, e in (("rtc_fma", err_fma), ("rtc_split", err_split)):
        log({"phase": "kernel", "name": name, "shape": list(a.shape), "max_abs_err": e})


def check_mma_rate(randn, peaks):
    """The rate mma.sync reaches on this card with nothing else to do: one
    TF32 product alone, and the kernels' 3xTF32 step (its rate counted in
    f32 work, a third of the products'), against the published TF32 peak.
    The ceiling for the product kernels' mma.sync core."""
    import mxnet_tpu_torch as pt

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid, block = sms * MMA_RATE["blocks_per_sm"], MMA_RATE["threads"]
    x = pt.nd.NDArray(randn(64, scale=1e-3), pt.gpu(0))
    rec = {"phase": "kernel", "name": "mma_sync_rate", **MMA_RATE, "sms": sms}
    for name, (per, step) in MMA_RATE_STEPS.items():
        probe = pt.rtc.Rtc("rtc_mma_rate_" + name, RTC_MMA_RATE % dict(step=step, **MMA_RATE),
                           kernel_name="rtc_mma_rate", grid=(grid,), block=(block,))
        (out,) = probe.push([x], out_shapes=[(grid * block,)])
        check(bool(torch.isfinite(out._tensor()).all()), ("mma_sync_rate output", name))
        ms = device_ms(lambda: probe.push([x], out_shapes=[(grid * block,)]), iters=10,
                       key="rtc_mma_rate")
        mmas = grid * block / 32 * MMA_RATE["iters"] * MMA_RATE["chains"] * per
        tflops = mmas * 2 * 16 * 8 * 8 / per / (ms * 1e-3) / 1e12
        rec[name] = {"ms": ms, "tflops": tflops,
                     "share_of_tf32_peak": tflops * per / (peaks["tf32"] / 1e12)}
    log(rec)


def random_params():
    """Random weights from the seed, named and shaped by the training symbol."""
    from mxnet_tpu_torch.models import transformer

    net = transformer.get_symbol(seq_len=SERVE["pos_len"], **MODEL)
    arg_shapes = net.infer_shape(data=(1, SERVE["pos_len"]), softmax_label=(1, SERVE["pos_len"]))[0]
    rs = np.random.RandomState(SEED)
    return {n: (rs.standard_normal(s) * 0.05).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def profile_window(fn, per=1):
    """Host wall time of ``fn`` (ending in a synchronize) against the card's
    busy time in it (the profiler's device events), and the device time of
    the port's kernels against the rest, in all and by kernel; per call,
    ``fn`` running ``per``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, port, n_kernels, top = 0.0, 0.0, 0, {}
    by_kernel = dict.fromkeys(KERNELS, 0.0)
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = float(getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0)))
        busy += us
        n_kernels += int(evt.count)
        owner = [name for name, (_, _, sym) in KERNELS.items() if sym in evt.key]
        if owner:
            port += us
            by_kernel[owner[0]] += us
        top[evt.key[:60]] = top.get(evt.key[:60], 0.0) + us
    return {"wall_ms": wall_ms / per, "device_busy_ms": busy / 1e3 / per,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms if wall_ms else None,
            "port_kernels_ms": port / 1e3 / per,
            "port_kernels_share_of_busy": port / busy if busy else None,
            "port_kernel_ms": {k: v / 1e3 / per for k, v in by_kernel.items() if v},
            "device_events_per_call": n_kernels / per,
            "top_device_ms": {k: v / 1e3 / per for k, v in
                              sorted(top.items(), key=lambda kv: -kv[1])[:8]}}


def breakdown(dec, prompt, steps=8):
    """Where one prefill and ``steps`` greedy decode steps spend their time."""
    dec.reset()
    nxt = np.argmax(dec.prefill(prompt), axis=-1)

    def prefill():
        dec.reset()
        dec.prefill(prompt)

    def decode():
        n = nxt
        for _ in range(steps):
            n = dec.greedy_step(n)

    out = {"prefill": profile_window(prefill)}
    dec.reset()
    dec.prefill(prompt)
    out["decode"] = profile_window(decode, per=steps)
    return out


def teacher_forced_logits(dec, prompt, tokens):
    dec.reset()
    out = [dec.prefill(prompt)]
    for t in range(tokens.shape[1] - 1):
        out.append(dec.decode_step(tokens[:, t]))
    return np.stack(out, axis=1)  # (B, n, vocab)


def run_slice(pt):
    """Phase 3: full-width greedy decode on the card, launch counts, and the
    teacher-forced comparison with the port's CPU path."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving import KVCacheDecoder

    params = random_params()
    rs = np.random.RandomState(SEED + 1)
    prompt = rs.randint(1, MODEL["vocab_size"], (SERVE["batch"], PROMPT_LEN))
    dec = KVCacheDecoder(params, ctx=pt.gpu(0), **MODEL, **SERVE)
    t0 = time.perf_counter()
    dec.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = dec.greedy(prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    schedules = ops.schedule_counts()

    L, steps = MODEL["num_layers"], NEW_TOKENS - 1
    expected = {"flash_attention": L, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                "norm_residual": (2 * L + 1) * (1 + steps), "norm_residual_bwd": 0,
                "matmul_bias_act": L * (1 + steps)}
    check(launches == with_zeros(expected), ("launch counts", launches, expected))
    # the prefill's ffn1 (M = batch · prefill_len) on the tiles, each decode
    # step's (M = batch) on the small-M schedule
    expected_schedules = {"matmul_bias_act.small_m": L * steps, "matmul_bias_act.tiles": L}
    check(schedules == expected_schedules, ("schedule counts", schedules, expected_schedules))
    check(tokens.shape == (SERVE["batch"], NEW_TOKENS), ("token shape", tokens.shape))
    check(((tokens >= 0) & (tokens < MODEL["vocab_size"])).all(), "token ids out of range")
    greedy_s = [greedy_s]
    for _ in range(2):  # the spread of the host clock; the tokens must repeat exactly
        t0 = time.perf_counter()
        again = dec.greedy(prompt, NEW_TOKENS)
        greedy_s.append(time.perf_counter() - t0)
        check((again == tokens).all(), "greedy decode is not deterministic")
    # host-clock latencies: 20 prefills, and each of the 63 greedy steps of
    # one sequence (a step ends with its (B,) token ids on the host)
    prefill_ms = []
    for _ in range(20):
        dec.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt = np.argmax(dec.prefill(prompt), axis=-1)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        nxt = dec.greedy_step(nxt)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()  # a greedy call after the loops: does the host clock drift?
    dec.greedy(prompt, NEW_TOKENS)
    greedy_after_s = time.perf_counter() - t0

    gpu_logits = teacher_forced_logits(dec, prompt, tokens)
    check(np.isfinite(gpu_logits).all(), "non-finite card logits")
    # the card's greedy tokens are the argmax of its own teacher-forced logits
    check((np.argmax(gpu_logits, axis=-1) == tokens).all(), "greedy != teacher-forced argmax")
    cpu_dec = KVCacheDecoder(params, ctx=pt.cpu(), **MODEL, **SERVE)
    t0 = time.perf_counter()
    cpu_logits = teacher_forced_logits(cpu_dec, prompt, tokens)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(gpu_logits - cpu_logits).max())
    # f32 on both sides, TF32 off; sums run in other orders on the card
    check(np.allclose(gpu_logits, cpu_logits, atol=1e-3, rtol=1e-3), ("card vs CPU logits", err))
    agree = float((np.argmax(cpu_logits, axis=-1) == tokens).mean())
    log({"phase": "breakdown", **breakdown(dec, prompt)})
    step_p50 = float(np.percentile(step_ms, 50))
    log({"phase": "slice", "model": MODEL, "serve": SERVE, "prompt_len": PROMPT_LEN,
         "new_tokens": NEW_TOKENS, "launches": launches, "expected_launches": expected,
         "schedule_launches": schedules,
         "warmup_s": warmup_s, "greedy_s": greedy_s, "greedy_after_loops_s": greedy_after_s,
         "prefill_ms_p50": float(np.median(prefill_ms)), "prefill_ms_max": max(prefill_ms),
         "prefill_samples": len(prefill_ms),
         "decode_step_ms_p50": step_p50, "decode_step_ms_p80": float(np.percentile(step_ms, 80)),
         "decode_step_samples": len(step_ms),
         "tokens_per_s": SERVE["batch"] * NEW_TOKENS / float(np.median(greedy_s)),
         "decode_tokens_per_s": SERVE["batch"] * 1e3 / step_p50,
         "card_vs_cpu_max_abs_err": err, "cpu_argmax_token_agreement": agree,
         "cpu_reference_s": cpu_s})
    return launches


@contextlib.contextmanager
def relu_decisions(record=None, pinned=None):
    """Record the output of every matmul_bias_act site of a run (``record``),
    or pin a run's ReLU decisions to recorded ones (``pinned``), and yield
    the list of (decisions that differed, largest |Δy| among them) per site.

    Where a pre-activation lies within rounding of 0, the card and the CPU,
    summing in other orders, can land on the two sides of the ReLU, and the
    gradient jumps there by the whole upstream gradient. A pinned run takes
    the recorded side at such kinks (a value of 0, or the smallest normal
    float), and its own values everywhere else."""
    from mxnet_tpu_torch.ops import matmul_bias_act as mba

    orig = mba.MatmulBiasAct.forward
    flips, ys = [], iter(pinned or ())

    def forward(ctx, a, w, b, act):
        y = orig(ctx, a, w, b, act)
        if record is not None:
            record.append(y.detach().cpu())
        if pinned is not None:
            check(act == "relu", ("pinned decisions need relu", act))
            ref = next(ys).to(y.device)
            flip = (ref > 0) != (y > 0)
            flips.append((int(flip.sum()),
                          float((ref - y).abs()[flip].max()) if flip.any() else 0.0))
            # in place: the Function saved this y, and its backward reads y > 0
            y.copy_(torch.where(ref > 0, y.clamp_min(torch.finfo(y.dtype).tiny),
                                torch.zeros_like(y)))
        return y

    mba.MatmulBiasAct.forward = staticmethod(forward)
    try:
        yield flips
    finally:
        mba.MatmulBiasAct.forward = orig


def train_model(params):
    """The training phase's symbol, its fixed batch of tokens (from the
    seed) and a bind of it: ``(net, batch, bind)``, ``bind(ctx, rows)``
    giving an executor on the batch's first ``rows`` sequences."""
    from mxnet_tpu_torch.models import transformer

    B, T = TRAIN["batch"], TRAIN["seq_len"]
    net = transformer.get_symbol(seq_len=T, **MODEL)
    rs = np.random.RandomState(SEED + 2)
    tokens = rs.randint(0, MODEL["vocab_size"], (B, T + 1)).astype(np.float32)
    batch = {"data": tokens[:, :-1], "softmax_label": tokens[:, 1:]}
    reqs = {n: "write" for n in params}  # data and labels: null

    def bind(ctx, rows):
        exe = net.simple_bind(ctx, grad_req=reqs, data=(rows, T), softmax_label=(rows, T))
        for n, a in exe.arg_dict.items():
            a[:] = params[n] if n in params else batch[n][:rows]
        return exe

    return net, batch, bind


def train_step_fn(net, params, exe):
    """One training step on ``exe``: forward_backward, the SGD-momentum
    update of every parameter, a synchronize."""
    from mxnet_tpu_torch import optimizer

    names = [n for n in net.list_arguments() if n in params]
    opt = optimizer.create("sgd", learning_rate=TRAIN["lr"], momentum=TRAIN["momentum"],
                           wd=TRAIN["wd"], rescale_grad=1.0 / TRAIN["batch"],
                           param_idx2name=dict(enumerate(names)))
    updater = optimizer.get_updater(opt)

    def step():
        exe.forward_backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
        torch.cuda.synchronize()

    return step


def run_train(pt, params):
    """Phase 4: training the full-width model on one fixed batch."""
    from mxnet_tpu_torch import ops

    B, T, L = TRAIN["batch"], TRAIN["seq_len"], MODEL["num_layers"]
    net, batch, bind = train_model(params)

    def loss_of(exe, rows):
        """SoftmaxOutput's cross-entropy on the batch, from its probabilities."""
        prob = exe.outputs[0]._tensor()
        lab = torch.as_tensor(batch["softmax_label"][:rows].reshape(-1, 1),
                              device=prob.device).long()
        return float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean())

    # (c) one step at batch 2, from the same weights, on the card and the CPU;
    # the CPU takes the card's side at every ReLU kink the two split
    small = [bind(ctx, TRAIN["check_batch"]) for ctx in (pt.gpu(0), pt.cpu())]
    card_ys = []
    with relu_decisions(record=card_ys):
        small[0].forward_backward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with relu_decisions(pinned=card_ys) as flips:
        small[1].forward_backward()
    cpu_s = time.perf_counter() - t0
    n_flips = sum(n for n, _ in flips)
    flip_dy = max(d for _, d in flips)
    # a split decision is a kink: both sides' values are within rounding of 0
    check(n_flips <= 1e-5 * sum(y.numel() for y in card_ys) and flip_dy <= 1e-5,
          ("ReLU decisions that differ beyond kinks", n_flips, flip_dy))
    small_loss = [loss_of(e, TRAIN["check_batch"]) for e in small]
    check(abs(small_loss[0] - small_loss[1]) <= 1e-3 * max(1.0, abs(small_loss[1])),
          ("card vs CPU loss", small_loss))
    worst_name, worst_rel = None, 0.0
    for n in params:
        got, want = small[0].grad_dict[n].asnumpy(), small[1].grad_dict[n].asnumpy()
        scale = float(np.abs(want).max())
        check(np.isfinite(got).all(), ("non-finite card gradient", n))
        # f32 on both sides, TF32 off; sums run in other orders on the card
        check(np.allclose(got, want, rtol=1e-3, atol=1e-3 * scale), ("card vs CPU grad", n))
        rel = float(np.abs(got - want).max()) / (scale or 1.0)
        if rel >= worst_rel:
            worst_name, worst_rel = n, rel
    log({"phase": "train_check", "batch": TRAIN["check_batch"], "loss_card": small_loss[0],
         "loss_cpu": small_loss[1], "worst_grad": worst_name,
         "worst_grad_abs_err_over_max": worst_rel, "relu_kinks_pinned": n_flips,
         "relu_kink_max_abs_dy": flip_dy, "relu_outputs": sum(y.numel() for y in card_ys),
         "cpu_step_s": cpu_s})
    del small

    exe = bind(pt.gpu(0), B)
    step = train_step_fn(net, params, exe)
    losses = []
    for _ in range(TRAIN["warmup_steps"]):
        step()
        losses.append(loss_of(exe, B))
    expected = {"flash_attention": L, "flash_attention_dq": L, "flash_attention_dkv": L,
                "norm_residual": 2 * L + 1, "norm_residual_bwd": 2 * L + 1,
                "matmul_bias_act": L}
    ops.reset_launch_counts()
    step_ms = []
    for i in range(TRAIN["steps"]):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            check(ops.launch_counts() == with_zeros(expected),
                  ("one step's launch counts", ops.launch_counts(), expected))
        losses.append(loss_of(exe, B))
    launches = ops.launch_counts()
    check(launches == with_zeros({k: v * TRAIN["steps"] for k, v in expected.items()}),
          ("training launch counts", launches))
    schedules = ops.schedule_counts()  # ffn1 at M = batch · seq_len: the tiles
    check(schedules == {"matmul_bias_act.small_m": 0, "matmul_bias_act.tiles": L * TRAIN["steps"]},
          ("training schedule counts", schedules))
    check(all(math.isfinite(x) for x in losses), ("non-finite loss", losses))
    check(losses[-1] < losses[0], ("the loss did not fall", losses))
    log({"phase": "train_breakdown", **profile_window(step)})
    p50 = float(np.percentile(step_ms, 50))
    log({"phase": "train", "model": MODEL, "train": TRAIN, "tokens_per_step": B * T,
         "launches_per_step": expected, "launches": launches, "schedule_launches": schedules,
         "losses": losses, "step_ms_p50": p50, "step_ms_p80": float(np.percentile(step_ms, 80)),
         "step_ms": step_ms, "tokens_per_s": B * T * 1e3 / p50,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def check_tf32_off():
    """The unfused convs go through cuDNN, whose float32 default is TF32:
    the port switches it off at import, and nothing may switch it back."""
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          ("TF32 is on", torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32))


def resnet_values(net):
    """Random ResNet weights from the seed: He-scaled conv and fc weights,
    γ in U(0.5, 1.5), β in U(-0.1, 0.1), fc bias 0; moving means 0 and
    variances 1, as a fresh model has them."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1,) + image_shape(), softmax_label=(1,))
    rs = np.random.RandomState(SEED + 3)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = rs.uniform(0.5, 1.5, s)
        elif n.endswith("_beta"):
            v = rs.uniform(-0.1, 0.1, s)
        elif n.endswith("_bias"):
            v = np.zeros(s)
        else:
            v = rs.standard_normal(s) * math.sqrt(2.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def image_shape():
    return tuple(int(v) for v in RESNET["image_shape"].split(","))


def resnet_batch(B):
    """One fixed batch: images in U(-1, 1), labels uniform over the classes."""
    rs = np.random.RandomState(SEED + 4)
    return (rs.uniform(-1, 1, (B,) + image_shape()).astype(np.float32),
            rs.randint(0, RESNET["num_classes"], (B,)).astype(np.float32))


def resnet_bind(pt, net, ctx, B, args, aux, grad_req, images, labels, dtype="float32"):
    types = {n: dtype for n in net.list_arguments() + net.list_auxiliary_states()}
    exe = net.simple_bind(ctx, grad_req=grad_req, type_dict=types, data=(B,) + image_shape(),
                          softmax_label=(B,))
    exe.copy_params_from(dict(args, data=images[:B], softmax_label=labels[:B]), aux)
    return exe


def run_resnet_serve(pt, net, args, aux):
    """Phase 5: ResNet-50 inference on the card at batch 32 and 1: launch
    counts, latency and images/s, a breakdown; card vs CPU at batch 2."""
    from mxnet_tpu_torch import ops

    check_tf32_off()
    images, labels = resnet_batch(max(RESNET_SERVE["batches"]))
    out = {"phase": "resnet_serve", "model": RESNET}
    for B in RESNET_SERVE["batches"]:
        exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, "null", images, labels)
        for _ in range(3):
            exe.forward(is_train=False)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        prob = exe.forward(is_train=False)[0]
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check(launches == with_zeros({"conv_bn_infer": RESNET_SITES}),
              ("inference launch counts", B, launches))
        p = prob.asnumpy()
        check(p.shape == (B, RESNET["num_classes"]) and np.isfinite(p).all(),
              ("inference output", B, p.shape))
        check(np.allclose(p.sum(axis=1), 1.0, atol=1e-4), ("probabilities", B))
        lat = []
        for _ in range(RESNET_SERVE["iters"]):
            t0 = time.perf_counter()
            exe.forward(is_train=False)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(lat))
        out["batch%d" % B] = {"launches": launches, "latency_ms_p50": med,
                              "latency_ms_p80": float(np.percentile(lat, 80)),
                              "latency_ms": lat, "images_per_s": B * 1e3 / med}
        torch.cuda.reset_peak_memory_stats()
        log({"phase": "resnet_serve_breakdown", "batch": B,
             **profile_window(lambda: exe.forward(is_train=False)),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        del exe
    Bc = RESNET_SERVE["check_batch"]
    probs = []
    for ctx in (pt.gpu(0), pt.cpu()):
        exe = resnet_bind(pt, net, ctx, Bc, args, aux, "null", images, labels)
        probs.append(exe.forward(is_train=False)[0].asnumpy())
    err = float(np.abs(probs[0] - probs[1]).max())
    # f32 on both sides, TF32 off; sums in other orders on the card
    check(np.allclose(probs[0], probs[1], rtol=1e-3, atol=1e-6), ("card vs CPU probs", err))
    out.update(card_vs_cpu_max_abs_err=err, card_vs_cpu_batch=Bc,
               argmax_agree=bool((probs[0].argmax(1) == probs[1].argmax(1)).all()))
    log(out)
    return out["batch%d" % max(RESNET_SERVE["batches"])]["launches"]


@contextlib.contextmanager
def relu_kinks(record=None, compare=None, pin=False):
    """Record every ReLU decision of a ResNet run (``record``), or compare a
    run's ReLU decisions with recorded ones (``compare``) and, with ``pin``,
    pin them to the recorded side; yields the list of (decisions that
    differed, largest |pre-activation| among them) per ReLU: the fused
    convs' prologues and the unfused ``Activation`` ReLUs, in the order the
    forward reaches them.

    Where a pre-activation lies within rounding of 0, the card and the CPU,
    summing in other orders, can put it on the two sides of the ReLU, and
    the gradient there jumps by the whole upstream gradient; at batch 2 a
    late stage's weight gradient sums a few hundred positions, so one such
    jump moves it by percents. A pinned run (the CPU's, through the
    kernels' plain versions) takes the recorded side at such a kink, a
    value of 0 or the smallest normal float, and its own values everywhere
    else, in the prologue's forward and in its backward's recomputation
    alike. The kernel's prologue rounds x·scale and the sum as the torch
    ops here do, so the card's recorded decisions are the kernel's."""
    from mxnet_tpu_torch.ops import conv_bn as cb
    from mxnet_tpu_torch.ops import nn as pnn

    orig_apply, orig_prologue, orig_relu = cb.ConvBlock.apply, cb._prologue, pnn._ACTS["relu"]
    flips, refs, masks, state = [], iter(compare or ()), {}, {"forward": False}

    def decide(pre):
        """The recorded decision and the flipped elements, or None."""
        if record is not None:
            record.append((pre > 0).cpu())
        if compare is None:
            return None
        want = next(refs).to(pre.device)
        flip = want != (pre > 0)
        flips.append((int(flip.sum()), float(pre.abs()[flip].max()) if flip.any() else 0.0))
        return want, flip

    def pinned(pre, want_flip):
        want, flip = want_flip
        tiny = torch.full_like(pre, torch.finfo(pre.dtype).tiny)
        return torch.where(flip, torch.where(want, tiny, torch.zeros_like(pre)), pre)

    def conv_block(x, w, scale, shift, res, stride, relu):
        if record is not None and scale is not None and relu:
            b = (1, -1, 1, 1)
            decide(x.detach() * scale.detach().reshape(b) + shift.detach().reshape(b))
        state["forward"] = True
        try:
            return orig_apply(x, w, scale, shift, res, stride, relu)
        finally:
            state["forward"] = False

    def prologue(x, scale, shift, relu):
        if scale is None or not relu or compare is None:
            return orig_prologue(x, scale, shift, relu)
        b = (1, -1, 1, 1)
        pre = x * scale.to(x.dtype).reshape(b) + shift.to(x.dtype).reshape(b)
        key = (x.data_ptr(), scale.data_ptr(), shift.data_ptr())
        if state["forward"]:  # the forward's call; the backward recomputes
            masks[key] = decide(pre)
        return torch.relu(pinned(pre, masks[key]) if pin else pre)

    def relu(data):
        got = decide(data.detach()) if (record is not None or compare is not None) else None
        if pin and got is not None and got[1].any():
            data = data + (pinned(data.detach(), got) - data.detach())
        return orig_relu(data)

    cb.ConvBlock.apply, cb._prologue, pnn._ACTS["relu"] = conv_block, prologue, relu
    try:
        yield flips
    finally:
        cb.ConvBlock.apply, cb._prologue, pnn._ACTS["relu"] = orig_apply, orig_prologue, orig_relu


def run_resnet_train(pt, net, args, aux):
    """Phase 6: ResNet-50 training on one fixed batch: card vs CPU at batch
    2, then timed steps at batch 32 with launch counts, a falling loss and
    changed moving stats."""
    from mxnet_tpu_torch import ops, optimizer

    check_tf32_off()
    B = RESNET_TRAIN["batch"]
    images, labels = resnet_batch(B)
    reqs = {n: "write" for n in args}  # data and labels: null

    def loss_of(exe, rows):
        prob = exe.outputs[0]._tensor()
        lab = torch.as_tensor(labels[:rows].reshape(-1, 1), device=prob.device).long()
        return float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean())

    # one step at batch 2 from the same weights on the card, and on the CPU
    # in float32 and in float64, the CPU runs pinned to the card's side at
    # every ReLU kink they split. At batch 2 this randomly initialised
    # ResNet is chaotic: a 1e-7 relative change of the images moves deep
    # gradients by percents with every ReLU pinned (PERF.md §6, PR 3). So a
    # gradient passes within rtol 1e-3, atol 1e-3·max|grad| of the CPU's
    # float32 one, or when it lies as close to the float64 gradient as
    # RESNET_F64_FACTOR times the float32 CPU's own distance from it
    Bc = RESNET_TRAIN["check_batch"]
    card = []
    exe = resnet_bind(pt, net, pt.gpu(0), Bc, args, aux, reqs, images, labels)
    with relu_kinks(record=card):
        exe.forward_backward()
    torch.cuda.synchronize()
    got = ({n: exe.grad_dict[n].asnumpy() for n in args},
           {n: exe.aux_dict[n].asnumpy() for n in aux}, loss_of(exe, Bc))
    del exe

    def cpu_step(dtype):
        e = resnet_bind(pt, net, pt.cpu(), Bc, args, aux, reqs, images, labels, dtype)
        with relu_kinks(compare=card, pin=True) as flips:
            e.forward_backward()
        return ({n: e.grad_dict[n].asnumpy() for n in args},
                {n: e.aux_dict[n].asnumpy() for n in aux}, loss_of(e, Bc)), flips

    t0 = time.perf_counter()
    want, flips = cpu_step("float32")
    cpu_s = time.perf_counter() - t0
    exact, flips64 = cpu_step("float64")

    def rel(a, b):
        return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)

    n_flips, flip_pre = sum(n for n, _ in flips), max(d for _, d in flips)
    n_decisions = sum(int(d.numel()) for d in card)
    strict = [n for n in args if np.allclose(got[0][n], want[0][n], rtol=1e-3,
                                             atol=1e-3 * float(np.abs(want[0][n]).max()))]
    card64 = {n: rel(got[0][n], exact[0][n]) for n in args}
    cpu64 = {n: rel(want[0][n], exact[0][n]) for n in args}
    ratio = {n: card64[n] / max(cpu64[n], 1e-30) for n in args}
    loose = [n for n in args if n not in strict]
    worst = max(loose, key=lambda n: ratio[n]) if loose else None
    aux_rel = max(rel(got[1][n], want[1][n]) for n in aux)
    log({"phase": "resnet_train_check", "batch": Bc, "loss_card": got[2], "loss_cpu": want[2],
         "loss_cpu_f64": exact[2], "relu_kinks_pinned": n_flips, "relu_kink_max_abs_pre": flip_pre,
         "relu_kinks_pinned_f64": sum(n for n, _ in flips64), "relu_decisions": n_decisions,
         "grads": len(args), "grads_within_1e-3_of_cpu": len(strict),
         "card_vs_cpu_worst": max(rel(got[0][n], want[0][n]) for n in args),
         "card_vs_f64_worst": max(card64.values()), "cpu_vs_f64_worst": max(cpu64.values()),
         "card_vs_f64_median": float(np.median(list(card64.values()))),
         "cpu_vs_f64_median": float(np.median(list(cpu64.values()))),
         "worst_ratio_grad": worst, "worst_ratio": ratio[worst] if worst else None,
         "ratios_over_2": sorted(n for n in loose if ratio[n] > 2),
         "worst_aux_abs_err_over_max": aux_rel, "cpu_step_s": cpu_s})
    check(abs(got[2] - want[2]) <= 1e-3 * max(1.0, abs(want[2])), ("card vs CPU loss", got[2],
                                                                    want[2]))
    # a split decision is a kink: within rounding of 0 on both sides, and rare
    check(n_flips <= 1e-5 * n_decisions and flip_pre <= 1e-3,
          ("ReLU decisions that differ beyond kinks", n_flips, flip_pre))
    for n in args:
        check(np.isfinite(got[0][n]).all(), ("non-finite card gradient", n))
        check(n in strict or card64[n] <= RESNET_F64_FACTOR * cpu64[n],
              ("card vs CPU grad", n, card64[n], cpu64[n]))
    check(aux_rel <= 1e-3, ("card vs CPU moving stats", aux_rel))

    exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, reqs, images, labels)
    names = [n for n in net.list_arguments() if n in args]
    opt = optimizer.create("sgd", learning_rate=RESNET_TRAIN["lr"],
                           momentum=RESNET_TRAIN["momentum"], wd=RESNET_TRAIN["wd"],
                           rescale_grad=1.0 / B, param_idx2name=dict(enumerate(names)))
    updater = optimizer.get_updater(opt)

    def step():
        exe.forward_backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
        torch.cuda.synchronize()

    losses = []
    for _ in range(RESNET_TRAIN["warmup_steps"]):
        step()
        losses.append(loss_of(exe, B))
    expected = {"conv_bn": RESNET_SITES, "conv_bn_bwd": RESNET_SITES}
    ops.reset_launch_counts()
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(RESNET_TRAIN["steps"]):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            check(ops.launch_counts() == with_zeros(expected),
                  ("one ResNet step's launch counts", ops.launch_counts()))
        losses.append(loss_of(exe, B))
    launches = ops.launch_counts()
    check(launches == with_zeros({k: v * RESNET_TRAIN["steps"] for k, v in expected.items()}),
          ("ResNet training launch counts", launches))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses), ("non-finite loss", losses))
    check(losses[-1] < losses[0], ("the ResNet loss did not fall", losses))
    moved = {n: float(np.abs(a.asnumpy() - aux[n]).max()) for n, a in exe.aux_dict.items()}
    check(all(v > 0 for v in moved.values()),
          ("moving stats that did not change", [n for n, v in moved.items() if v == 0]))
    check_tf32_off()
    log({"phase": "resnet_train_breakdown", **profile_window(step)})
    p50 = float(np.percentile(step_ms, 50))
    log({"phase": "resnet_train", "model": RESNET, "train": RESNET_TRAIN,
         "launches_per_step": expected, "launches": launches, "losses": losses,
         "step_ms_p50": p50, "step_ms_p80": float(np.percentile(step_ms, 80)),
         "step_ms": step_ms, "images_per_s": B * 1e3 / p50, "peak_memory_gb": peak_gb,
         "aux_moved_min": min(moved.values())})
    return launches


def run_deploy(pt, net, args, aux):
    """Phase 7: the deploy surface at ResNet-50's full width."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.predictor import Predictor, load_ndarray_file

    check_tf32_off()
    B, shape1 = DEPLOY["batch"], (1,) + image_shape()
    shape = (B,) + image_shape()
    out = {"phase": "deploy", "model": RESNET, "batch": B}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = tmp + "/resnet50"
        t0 = time.perf_counter()
        pt.model.save_checkpoint(prefix, DEPLOY["epoch"], net, args, aux)
        out["save_checkpoint_s"] = time.perf_counter() - t0
        with open(prefix + "-symbol.json") as f:
            json_str = f.read()
        with open("%s-%04d.params" % (prefix, DEPLOY["epoch"]), "rb") as f:
            blob = f.read()
        check(pt.model.find_last_checkpoint(prefix) == DEPLOY["epoch"], "find_last_checkpoint")
    out["checkpoint_bytes"] = len(blob)
    t0 = time.perf_counter()
    loaded = load_ndarray_file(blob)  # onto the default context, the card
    torch.cuda.synchronize()
    out["load_params_s"] = time.perf_counter() - t0
    check(set(loaded) == {"arg:" + n for n in args} | {"aux:" + n for n in aux},
          "the checkpoint's names")
    for tag, values in (("arg:", args), ("aux:", aux)):
        for n, v in values.items():
            arr = loaded[tag + n]
            check(arr.context == pt.gpu(0) and np.array_equal(arr.asnumpy(), v),
                  ("the .params file does not load back equal", n))

    t0 = time.perf_counter()
    pred = Predictor(json_str, blob, {"data": shape})
    torch.cuda.synchronize()
    out["predictor_create_s"] = time.perf_counter() - t0
    check(pred.executables_bound == 1, "the predictor binds its first shape once")

    rs = np.random.RandomState(SEED + 5)
    raw = pt.nd.array(rs.uniform(0, 255, shape).astype(np.float32))
    mean, std = pt.nd.array(np.array(DEPLOY["mean"], np.float32)), \
        pt.nd.array(np.array(DEPLOY["std"], np.float32))
    kernel = normalise_kernel(pt, shape)
    kernel.push([raw, mean, std], out_shapes=[shape])  # loads the image (built in phase 2)
    torch.cuda.synchronize()
    tap = Predictor(pt.sym.load_json(json_str).get_internals()[DEPLOY["tap"]].tojson(), blob,
                    {"data": shape})
    w_sc = loaded["arg:" + DEPLOY["tap_weight"]]  # (256, 64, 1, 1)

    # ---- the main path, with the counts set to 0 just before and read just after
    ops.reset_launch_counts()
    (x,) = kernel.push([raw, mean, std], out_shapes=[shape])
    torch.cuda.synchronize()  # a fault inside the pushed kernel shows here
    pred.forward(data=x)
    probs = pred.get_output(0)
    tap.forward(data=x)
    feat = pt.nd.array(tap.get_output(0))  # (B, 64, 56, 56)
    a = pt.nd.transpose(feat, axes=(0, 2, 3, 1)).reshape((-1, feat.shape[1]))
    b = w_sc.reshape(w_sc.shape[:2]).T
    c, col_sum, col_sumsq = ms.matmul_with_stats(a._tensor(), b._tensor())
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = {"rtc": 1, "conv_bn_infer": RESNET_SITES, "matmul_stats": 1}
    check(launches == with_zeros(expected), ("deploy launch counts", launches))

    # ---- what came out
    check(probs.shape == (B, RESNET["num_classes"]) and np.isfinite(probs).all(),
          ("deploy output", probs.shape))
    check(np.allclose(probs.sum(axis=1), 1.0, atol=1e-4), "deploy probabilities")
    xn = x.asnumpy()
    want_x = (raw.asnumpy() - np.array(DEPLOY["mean"], np.float32).reshape(1, -1, 1, 1)) \
        / np.array(DEPLOY["std"], np.float32).reshape(1, -1, 1, 1)
    check(np.allclose(xn, want_x, rtol=1e-6, atol=1e-6), "rtc normalisation vs numpy")
    exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, "null", xn, np.zeros((B,), np.float32))
    direct = exe.forward(is_train=False)[0].asnumpy()
    del exe
    err = float(np.abs(probs - direct).max())
    # the same kernels on the same inputs
    check(np.allclose(probs, direct, rtol=1e-5, atol=1e-7)
          and (probs.argmax(1) == direct.argmax(1)).all(), ("predictor vs a direct bind", err))
    out.update(predictor_vs_bind_max_abs_err=err,
               predictor_vs_bind_bitwise=bool(np.array_equal(probs, direct)))
    # matmul_with_stats is the 1x1 shortcut convolution and its statistics
    ft = feat._tensor()
    conv = F.conv2d(ft, w_sc._tensor())
    M = a.shape[0]
    stats_err = {"c": rel_err(c, conv.permute(0, 2, 3, 1).reshape(M, -1)),
                 "col_sum": rel_err(col_sum, conv.sum(dim=(0, 2, 3))),
                 "col_sumsq": rel_err(col_sumsq, (conv * conv).sum(dim=(0, 2, 3)))}
    for n, e in stats_err.items():
        check(math.isfinite(e) and e <= CONV_TOL["elementwise" if n == "c" else "sums"],
              ("deploy matmul_with_stats vs conv2d", n, e))
    out.update(matmul_stats_shape=[M, a.shape[1], b.shape[1]], matmul_stats_vs_conv2d=stats_err)

    # ---- reshape to batch 1 and back
    pred.reshape({"data": shape1})
    check(pred.executables_bound == 2, "reshape to a new shape binds once")
    pred.forward(data=x[0:1])  # a view of the batch
    one = pred.get_output(0)
    # one image through the same kernels at another grid; cuBLAS may pick
    # another algorithm for the classifier
    check(np.allclose(one, probs[:1], rtol=1e-4, atol=1e-7), "batch 1 vs batch 32")
    lat1 = []
    for _ in range(DEPLOY["iters"]):
        t0 = time.perf_counter()
        pred.forward(data=x[0:1])
        pred.get_output(0)
        lat1.append((time.perf_counter() - t0) * 1e3)
    pred.reshape({"data": shape})
    check(pred.executables_bound == 2, "reshape back to a seen shape bound an executor")
    ops.reset_launch_counts()
    pred.forward(data=x)
    again = pred.get_output(0)
    check(ops.launch_counts() == with_zeros({"conv_bn_infer": RESNET_SITES}),
          ("a forward's launch counts", ops.launch_counts()))
    check(np.array_equal(again, probs), "the first probabilities do not repeat after reshape")
    lat = []
    for _ in range(DEPLOY["iters"]):
        t0 = time.perf_counter()
        pred.forward(data=x)
        pred.get_output(0)
        lat.append((time.perf_counter() - t0) * 1e3)

    def call():
        pred.forward(data=x)
        pred.get_output(0)

    log({"phase": "deploy_breakdown", "batch": B, **profile_window(call)})
    for tag, samples, n in (("batch%d" % B, lat, B), ("batch1", lat1, 1)):
        med = float(np.median(samples))
        out[tag] = {"latency_ms_p50": med, "latency_ms_p80": float(np.percentile(samples, 80)),
                    "latency_ms": samples, "images_per_s": n * 1e3 / med}
    out.update(launches=launches, executables_bound=pred.executables_bound,
               rtc_compiles=kernel.compiles, rtc_launches=kernel.launches)
    log(out)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    log({"phase": "device", "name": name, "nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "peak_f32_flops": peaks["f32"],
         "peak_tf32_flops": peaks["tf32"], "peak_bytes_per_s": peaks["bytes"]})
    t0 = time.perf_counter()
    lib_path = cuda_build.build_library()
    cuda_build.library()
    log({"phase": "build", "library": str(lib_path.name), "seconds": time.perf_counter() - t0})

    entries = check_kernels(peaks)
    serve_launches = run_slice(pt)
    train_launches = run_train(pt, random_params())
    from mxnet_tpu_torch.models import resnet

    net = resnet.get_symbol(**RESNET)
    args, aux = resnet_values(net)
    resnet_serve_launches = run_resnet_serve(pt, net, args, aux)
    resnet_train_launches = run_resnet_train(pt, net, args, aux)
    deploy_launches = run_deploy(pt, net, args, aux)
    for name_, e in entries.items():
        if name_ in ("matmul_stats", "rtc"):
            e.update(launches=deploy_launches[name_])  # the deploy phase's main path
        elif name_.startswith("conv_bn"):
            # launches: the ResNet's timed training steps; the stats-free
            # variant's: one batch-32 inference forward
            e.update(launches=resnet_train_launches[name_])
            if name_ == "conv_bn":
                e.update(infer_launches=resnet_serve_launches["conv_bn_infer"],
                         deploy_infer_launches=deploy_launches["conv_bn_infer"])
        else:
            # launches: the transformer's timed training steps, the path that
            # runs all six of its kernels
            e.update(launches=train_launches[name_], serve_launches=serve_launches[name_])
    log({"kernels": [entries[k] for k in KERNELS]})
    print(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
