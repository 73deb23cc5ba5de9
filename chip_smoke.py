#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. Device and build: print the card's name and power limit, build the
   CUDA kernels from ``mxnet_tpu_torch/csrc``.
2. Kernel checks: each kernel against its plain PyTorch version on the card,
   at the serving and training paths' shapes and at ragged ones, with its
   time, the plain version's, a PyTorch library call's, and the least time
   the card could take (one JSON line per kernel and shape).
3. Serving: full-width Transformer-base greedy decode through
   ``KVCacheDecoder`` on the card, with the kernel launch counts of that run
   checked against the path's expected counts, then the same tokens
   teacher-forced through the port on the card and on the CPU, whose logits
   must agree.
4. Training: the same model bound for training (``simple_bind``,
   ``forward_backward``, an SGD-momentum updater) on one fixed batch. One
   step at batch 2 gives the same loss and gradients on the card and on the
   CPU; then timed steps at batch 8 whose launch counts must be the path's
   and whose loss must fall, with a profiler breakdown of one step.
5. A ``{"kernels": [...]}`` line, then the card's name/power line, then the
   last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
import contextlib
import json
import math
import subprocess
import sys
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

# Published peaks, dense, from NVIDIA's H100 data sheet: float32 outside the
# tensor cores (the kernels' arithmetic, TF32 off) and HBM bandwidth.
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}

# kernel checks: the largest absolute difference of each kernel from its
# plain version (f32, TF32 off; the two sum in other orders: K-long dot
# products for the GEMM, S-long ones for dq, T-long ones for dk/dv, and
# 2048-row column sums for LayerNorm's dgamma and dbeta)
TOL = {"flash_attention": 1e-5, "norm_residual": 1e-5, "matmul_bias_act": 1e-4,
       "flash_attention_dq": 1e-4, "flash_attention_dkv": 1e-4, "norm_residual_bwd": 1e-4}

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
    "norm_residual_bwd": ("mxnet_tpu_torch/csrc/norm_residual.cu",
                          "mxnet_tpu/ops/pallas_norm_residual.py:92", "layer_norm_bwd_kernel"),
    "matmul_bias_act": ("mxnet_tpu_torch/csrc/matmul_bias_act.cu",
                        "mxnet_tpu/ops/pallas_matmul_bias_act.py:57", "matmul_bias_act_kernel"),
}


def check(cond, what):
    """Fail the run (also under python -O, which strips asserts)."""
    if not cond:
        raise RuntimeError("chip_smoke check failed: %r" % (what,))


def log(obj):
    print(json.dumps(obj), flush=True)


def peaks_for(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def device_ms(fn, iters=30, key=None):
    """Device time per call of everything ``fn`` runs on the card (or of the
    events whose name holds ``key``), from the profiler's CUDA events. Fails
    the run when the profiler shows none: every time this script reports is
    that one measure."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA") \
                and (key is None or key in evt.key):
            total_us += float(getattr(evt, "self_device_time_total",
                                      getattr(evt, "self_cuda_time_total", 0.0)))
    check(total_us > 0, ("the profiler shows no device time", key))
    return total_us / 1e3 / iters


def bound(flops, nbytes, peaks):
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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
    # step's, then ragged
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
            b_ms, b_by = bound(4.0 * D * pairs * BH,
                               4.0 * (2 * BH * T * D + 2 * BH * S * D + BH * T), peaks)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            record("flash_attention", timed[i], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms,
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
            b_ms, b_by = bound(2.0 * Mr * N * K + 2.0 * Mr * N,
                               4.0 * (Mr * K + N * K + N + Mr * N), peaks)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            record("matmul_bias_act", timed[i], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms,
                   shape="prefill ffn1 a (%d,%d) w (%d,%d) relu" % (Mr, K, N, K))
        log(rec)
    check_backward_kernels(randn, peaks, entries, worst)
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
    return entries


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
                plain_ms = device_ms(lambda: plain(*args))
                b_ms, b_by = bound(flops, reads + writes, peaks)
                rec.update({name + "_ms": ms, name + "_plain_ms": plain_ms,
                            name + "_bound_ms": b_ms})
                entries[name] = entry(
                    name, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, library="SDPA backward (dq, dk and dv together)",
                    shape="train q,k,v,dO (%d,%d,%d) causal" % (BH, T, D))
            rec.update(library_ms=lib_ms, dq_plus_dkv_ms=entries["flash_attention_dq"]["ms"]
                       + entries["flash_attention_dkv"]["ms"])
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
            ms = device_ms(fn, key=KERNELS["norm_residual_bwd"][2])
            with_sums_ms = device_ms(fn)  # the kernel plus the two partial sums
            plain_ms = device_ms(lambda: nr.layer_norm_affine_bwd_plain(x, g, mean, rstd, dy))
            xr, gr, br = (t.detach().requires_grad_(True) for t in (x, g, bb))
            yr = F.layer_norm(xr, (D,), gr, br, 1e-5)
            lib_ms = device_ms(lambda: torch.autograd.grad(yr, (xr, gr, br), dy,
                                                           retain_graph=True))
            nb = -(-R // nr.BWD_ROWS_PER_BLOCK)
            b_ms, b_by = bound(10.0 * R * D, 4.0 * (3 * R * D + 2 * R + D + 2 * nb * D), peaks)
            rec.update(kernel_ms=ms, with_partial_sums_ms=with_sums_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            entries["norm_residual_bwd"] = entry(
                "norm_residual_bwd", ms=ms, with_partial_sums_ms=with_sums_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape="train x, dy (%d,%d)" % (R, D))
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
    the port's kernels against the rest; per call, ``fn`` running ``per``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    port_symbols = tuple(sym for _, _, sym in KERNELS.values())
    busy, port, n_kernels, top = 0.0, 0.0, 0, {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = float(getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0)))
        busy += us
        n_kernels += int(evt.count)
        if any(k in evt.key for k in port_symbols):
            port += us
        top[evt.key[:60]] = top.get(evt.key[:60], 0.0) + us
    return {"wall_ms": wall_ms / per, "device_busy_ms": busy / 1e3 / per,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms if wall_ms else None,
            "port_kernels_ms": port / 1e3 / per,
            "port_kernels_share_of_busy": port / busy if busy else None,
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

    L, steps = MODEL["num_layers"], NEW_TOKENS - 1
    expected = {"flash_attention": L, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                "norm_residual": (2 * L + 1) * (1 + steps), "norm_residual_bwd": 0,
                "matmul_bias_act": L * (1 + steps)}
    check(launches == expected, ("launch counts", launches, expected))
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


def run_train(pt, params):
    """Phase 4: training the full-width model on one fixed batch."""
    from mxnet_tpu_torch import ops, optimizer
    from mxnet_tpu_torch.models import transformer

    B, T, L = TRAIN["batch"], TRAIN["seq_len"], MODEL["num_layers"]
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
    names = [n for n in net.list_arguments() if n in params]
    opt = optimizer.create("sgd", learning_rate=TRAIN["lr"], momentum=TRAIN["momentum"],
                           wd=TRAIN["wd"], rescale_grad=1.0 / B,
                           param_idx2name=dict(enumerate(names)))
    updater = optimizer.get_updater(opt)

    def step():
        exe.forward_backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
        torch.cuda.synchronize()

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
            check(ops.launch_counts() == expected, ("one step's launch counts",
                                                    ops.launch_counts(), expected))
        losses.append(loss_of(exe, B))
    launches = ops.launch_counts()
    check(launches == {k: v * TRAIN["steps"] for k, v in expected.items()},
          ("training launch counts", launches))
    check(all(math.isfinite(x) for x in losses), ("non-finite loss", losses))
    check(losses[-1] < losses[0], ("the loss did not fall", losses))
    log({"phase": "train_breakdown", **profile_window(step)})
    p50 = float(np.percentile(step_ms, 50))
    log({"phase": "train", "model": MODEL, "train": TRAIN, "tokens_per_step": B * T,
         "launches_per_step": expected, "launches": launches, "losses": losses,
         "step_ms_p50": p50, "step_ms_p80": float(np.percentile(step_ms, 80)),
         "step_ms": step_ms, "tokens_per_s": B * T * 1e3 / p50,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
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
         "cuda": torch.version.cuda, "peak_f32_flops": peaks[0], "peak_bytes_per_s": peaks[1]})
    t0 = time.perf_counter()
    lib_path = cuda_build.build_library()
    cuda_build.library()
    log({"phase": "build", "library": str(lib_path.name), "seconds": time.perf_counter() - t0})

    entries = check_kernels(peaks)
    serve_launches = run_slice(pt)
    train_launches = run_train(pt, random_params())
    for name_, e in entries.items():
        # launches: the timed training steps, the path that runs all six
        e.update(launches=train_launches[name_], serve_launches=serve_launches[name_])
    log({"kernels": [entries[k] for k in KERNELS]})
    print(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
