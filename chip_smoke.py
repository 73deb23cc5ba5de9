#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. Device and build: print the card's name and power limit, build the
   CUDA kernels from ``mxnet_tpu_torch/csrc``.
2. Kernel checks: each kernel against its plain PyTorch version on the card,
   at the serving slice's shapes and at ragged ones, with its time, the
   plain version's, a PyTorch library call's, and the least time the card
   could take (one JSON line per kernel and shape).
3. The slice: full-width Transformer-base greedy decode through
   ``KVCacheDecoder`` on the card, with the kernel launch counts of that run
   checked against the path's expected counts, then the same tokens
   teacher-forced through the port on the card and on the CPU, whose logits
   must agree.
4. A ``{"kernels": [...]}`` line, then the card's name/power line, then the
   last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
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

# Published peaks, dense, from NVIDIA's H100 data sheet: float32 outside the
# tensor cores (the kernels' arithmetic, TF32 off) and HBM bandwidth.
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}

# kernel checks: the tolerance of each kernel against its plain version (f32;
# the two sum in other orders: K-long dot products for the GEMM)
TOL = {"flash_attention": 1e-5, "norm_residual": 1e-5, "matmul_bias_act": 1e-4}


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


def device_ms(fn, iters=30):
    """Device time per call of everything ``fn`` runs on the card, from the
    profiler's CUDA events. Fails the run when the profiler shows none: every
    time this script reports is that one measure."""
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
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            total_us += float(getattr(evt, "self_device_time_total",
                                      getattr(evt, "self_cuda_time_total", 0.0)))
    check(total_us > 0, "the profiler shows no device time")
    return total_us / 1e3 / iters


def bound(flops, nbytes, peaks):
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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

    # ---- flash attention: (BH, T, S, D, causal); first is the prefill's
    for i, (BH, T, S, D, causal) in enumerate([(B * H, P, P, dh, True),
                                                (5, 77, 77, 40, True),
                                                (3, 50, 131, 128, True),
                                                (4, 33, 70, 96, False)]):
        q, k, v = randn(BH, T, D), randn(BH, S, D), randn(BH, S, D)
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max(float((o - po).abs().max()), float((lse - plse).abs().max()))
        check(math.isfinite(err) and err <= TOL["flash_attention"], ("flash_attention", BH, T, S, D, err))
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0), err)
        rec = {"phase": "kernel", "name": "flash_attention", "shape": [BH, T, S, D],
               "causal": causal, "max_abs_err": err}
        if i == 0:
            pairs = sum(min(S, r + (S - T) + 1) for r in range(T)) if causal else T * S
            ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
            plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal))
            q4, k4, v4 = (t.reshape(B, H, -1, D) for t in (q, k, v))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
            b_ms, b_by = bound(4.0 * D * pairs * BH,
                               4.0 * (2 * BH * T * D + 2 * BH * S * D + BH * T), peaks)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            entries["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="mxnet_tpu_torch/csrc/flash_attention.cu",
                replaces="mxnet_tpu/ops/pallas_attention.py:81", ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape="prefill q,k,v (%d,%d,%d) causal" % (BH, T, D))
        log(rec)

    # ---- LayerNorm + affine: (R, D); prefill rows, decode rows, ragged
    for i, (R, D) in enumerate([(B * P, M), (B, M), (37, 300), (5, 1000)]):
        x, g, bb = randn(R, D), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
        y, mean, rstd = nr.layer_norm_affine(x, g, bb)
        py, pmean, prstd = nr.layer_norm_affine_plain(x, g, bb)
        torch.cuda.synchronize()
        err = max(float((y - py).abs().max()), float((mean - pmean).abs().max()),
                  float((rstd - prstd).abs().max()))
        check(math.isfinite(err) and err <= TOL["norm_residual"], ("norm_residual", R, D, err))
        worst["norm_residual"] = max(worst.get("norm_residual", 0.0), err)
        rec = {"phase": "kernel", "name": "norm_residual", "shape": [R, D], "max_abs_err": err}
        if i < 2:
            ms = device_ms(lambda: nr.layer_norm_affine(x, g, bb))
            plain_ms = device_ms(lambda: nr.layer_norm_affine_plain(x, g, bb))
            lib_ms = device_ms(lambda: F.layer_norm(x, (D,), g, bb, 1e-5))
            b_ms, b_by = bound(7.0 * R * D, 4.0 * (2 * R * D + 2 * D + 2 * R), peaks)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            if i == 0:
                entries["norm_residual"] = dict(
                    name="norm_residual", route="cuda",
                    source="mxnet_tpu_torch/csrc/norm_residual.cu",
                    replaces="mxnet_tpu/ops/pallas_norm_residual.py:78", ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    shape="prefill x (%d,%d)" % (R, D))
            else:
                entries["norm_residual"].update(decode_ms=ms, decode_plain_ms=plain_ms,
                                                decode_library_ms=lib_ms, decode_bound_ms=b_ms)
        log(rec)

    # ---- matmul + bias + act: (M, K, N, act, bias); prefill ffn1, decode ffn1, ragged
    cases = [(B * P, M, FF, "relu", True), (B, M, FF, "relu", True),
             (77, 200, 130, "sigmoid", True), (77, 200, 130, "tanh", False),
             (5, 33, 70, "softrelu", True), (130, 65, 3, "relu", True)]
    for i, (Mr, K, N, act, has_b) in enumerate(cases):
        a, w = randn(Mr, K), randn(N, K, scale=1.0 / math.sqrt(K))
        b = randn(N, scale=0.1) if has_b else None
        c = mba.matmul_bias_act(a, w, b, act)
        pc = mba.matmul_bias_act_plain(a, w, b, act)
        torch.cuda.synchronize()
        err = float((c - pc).abs().max())
        check(math.isfinite(err) and err <= TOL["matmul_bias_act"], ("matmul_bias_act", Mr, K, N, act, err))
        worst["matmul_bias_act"] = max(worst.get("matmul_bias_act", 0.0), err)
        rec = {"phase": "kernel", "name": "matmul_bias_act", "shape": [Mr, K, N], "act": act,
               "bias": has_b, "max_abs_err": err}
        if i < 2:
            ms = device_ms(lambda: mba.matmul_bias_act(a, w, b, act))
            plain_ms = device_ms(lambda: mba.matmul_bias_act_plain(a, w, b, act))
            lib_ms = device_ms(lambda: torch.relu(torch.addmm(b, a, w.t())))
            b_ms, b_by = bound(2.0 * Mr * N * K + 2.0 * Mr * N,
                               4.0 * (Mr * K + N * K + N + Mr * N), peaks)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            if i == 0:
                entries["matmul_bias_act"] = dict(
                    name="matmul_bias_act", route="cuda",
                    source="mxnet_tpu_torch/csrc/matmul_bias_act.cu",
                    replaces="mxnet_tpu/ops/pallas_matmul_bias_act.py:57", ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    shape="prefill ffn1 a (%d,%d) w (%d,%d) relu" % (Mr, K, N, K))
            else:
                entries["matmul_bias_act"].update(decode_ms=ms, decode_plain_ms=plain_ms,
                                                  decode_library_ms=lib_ms, decode_bound_ms=b_ms)
        log(rec)
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
    return entries


def random_params():
    """Random weights from the seed, named and shaped by the training symbol."""
    from mxnet_tpu_torch.models import transformer

    net = transformer.get_symbol(seq_len=SERVE["pos_len"], **MODEL)
    arg_shapes = net.infer_shape(data=(1, SERVE["pos_len"]), softmax_label=(1, SERVE["pos_len"]))[0]
    rs = np.random.RandomState(SEED)
    return {n: (rs.standard_normal(s) * 0.05).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def breakdown(dec, prompt, steps=8):
    """Where one prefill and ``steps`` greedy decode steps spend their time:
    host wall time against the card's busy time (the profiler's device
    events), and the device time of the port's kernels against the rest."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for phase in ("prefill", "decode"):
        dec.reset()
        nxt = np.argmax(dec.prefill(prompt), axis=-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                dec.reset()
                dec.prefill(prompt)
            else:
                for _ in range(steps):
                    nxt = dec.greedy_step(nxt)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy, port, n_kernels, top = 0.0, 0.0, 0, {}
        for evt in prof.key_averages():
            if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
                continue
            us = float(getattr(evt, "self_device_time_total",
                               getattr(evt, "self_cuda_time_total", 0.0)))
            busy += us
            n_kernels += int(evt.count)
            if any(k in evt.key for k in ("flash_fwd_kernel", "layer_norm_fwd_kernel",
                                          "matmul_bias_act_kernel")):
                port += us
            top[evt.key[:60]] = top.get(evt.key[:60], 0.0) + us
        per = 1 if phase == "prefill" else steps
        out[phase] = {"wall_ms": wall_ms / per, "device_busy_ms": busy / 1e3 / per,
                      "device_idle_share": 1.0 - busy / 1e3 / wall_ms if wall_ms else None,
                      "port_kernels_ms": port / 1e3 / per,
                      "device_events_per_call": n_kernels / per,
                      "top_device_ms": {k: v / 1e3 / per for k, v in
                                        sorted(top.items(), key=lambda kv: -kv[1])[:6]}}
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
    expected = {"flash_attention": L,
                "norm_residual": (2 * L + 1) * (1 + steps),
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
    launches = run_slice(pt)
    for name_, e in entries.items():
        e["launches"] = launches[name_]
    log({"kernels": [entries[k] for k in ("flash_attention", "norm_residual", "matmul_bias_act")]})
    print(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
