#!/usr/bin/env python3
"""Card time and latency of the PyTorch/CUDA port's main paths, for one
checkout of it.

    python3 tools/torch_card_times.py [--repo DIR]

Imports ``mxnet_tpu_torch`` from ``DIR`` (default: this checkout), builds its
kernels there, and prints one JSON line: the profiler's device time of its
``matmul_with_stats`` at the smoke's timed shapes and of its LayerNorm
forward at the decode's, prefill's and training step's rows, of a
ResNet-50 forward at batch 32 and 1, of the conv kernels in a ResNet-50
training step at batch 32 (and of the backward's, conv_bn_bwd, among them),
of a transformer prefill (and of its flash-attention forward kernel) and of
a decode step, of a transformer training step (and of its flash-attention
forward and backward kernels, dq and dk/dv, and of its LayerNorm backward,
among them, that backward's whole calls too), the LayerNorm forward's share
and launches in the prefill, the decode step and the training step, of a
deploy request (a ResNet-50 ``Predictor`` made from a checkpoint's bytes,
forward and ``get_output`` at batch 32, as the smoke's ``deploy_breakdown``
times it) and of its ``matmul_with_stats`` on the tapped activation of stage
1's shortcut, the host-clock median latency of the
ResNet-50 forwards, the prefill, the decode step and the transformer training
step, and the card's name and power limit. The models, shapes and
helpers are ``chip_smoke.py``'s of this checkout. To compare two checkouts,
run it on them in turns (A, B, B, A) on the same card, one after another.
Needs one CUDA card; exits 2 without one.
"""
import argparse
import importlib.util
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
LATENCY_ITERS = 20


def median_ms(fn, iters=LATENCY_ITERS):
    """Host-clock median of ``fn`` (which must end on the host or in a
    synchronize), in ms."""
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def layer_norm_bwd_call_ms(step):
    """The LayerNorm backward's whole calls in one ``step`` on the card, ms,
    and their count: each launch of its first kernel (``layer_norm_bwd_kernel``)
    with what finishes its dγ and dβ right after it, from the profiler's
    device events in the order they ran: the sums kernel of a checkout that
    has one, else the torch reductions (``reduce_kernel``, two a call) that
    a checkout without one runs there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
    us, calls = 0.0, 0
    for i, e in enumerate(kernels):
        if "layer_norm_bwd_kernel" not in e.name:
            continue
        after = kernels[i + 1:i + 3]
        if after and "layer_norm_bwd_sums" in after[0].name:
            after = after[:1]
        else:
            after = list(itertools.takewhile(lambda f: "reduce_kernel" in f.name, after))
        us += sum(f.time_range.elapsed_us() for f in [e] + after)
        calls += 1
    return us / 1e3, calls


def kernel_times(smoke):
    """The profiler's device time a call of the checkout's ``matmul_with_stats``
    at the smoke's timed shapes and of its LayerNorm forward at the decode's,
    prefill's and training step's rows, through their public wrappers (ms,
    keyed by shape)."""
    import torch

    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.ops import norm_residual as nr

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    out = {}
    for M, K, N, prefix in smoke.MATMUL_STATS_SHAPES:
        if prefix is None:
            continue
        a, b = randn(M, K), randn(K, N, scale=K ** -0.5)
        out["matmul_stats_%d_%d_%d_ms" % (M, K, N)] = smoke.device_ms(
            lambda: ms.matmul_with_stats(a, b), key=smoke.KERNELS["matmul_stats"][2])
    D = smoke.MODEL["model_dim"]
    for R in (smoke.SERVE["batch"], smoke.SERVE["batch"] * smoke.SERVE["prefill_len"],
              smoke.TRAIN["batch"] * smoke.TRAIN["seq_len"]):
        x, g, b = randn(R, D), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
        out["layer_norm_fwd_%d_%d_ms" % (R, D)] = smoke.device_ms(
            lambda: nr.layer_norm_affine(x, g, b), key=smoke.KERNELS["norm_residual"][2])
    return out


def card_times(smoke, pt):
    """The card time (ms a call, from the profiler's device events over a
    short window) and the host-clock median latency of the paths the
    tensor-core kernels serve: a ResNet-50 forward at batch 32 and 1, the
    conv kernels' share of a training step at batch 32, a transformer
    prefill, a decode step and a training step (batch 8 of 256 tokens, with
    the flash backward's kernels apart). Uses the package's public entry
    points only."""
    import torch

    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.ops import norm_residual as nr
    from mxnet_tpu_torch.serving import KVCacheDecoder

    def ln_launches(fn):
        """The LayerNorm forward launches of one call of ``fn``."""
        before = nr.launches
        fn()
        return nr.launches - before

    out = {}
    rs = np.random.RandomState(smoke.SEED + 1)
    prompt = rs.randint(1, smoke.MODEL["vocab_size"], (smoke.SERVE["batch"], smoke.PROMPT_LEN))
    dec = KVCacheDecoder(smoke.random_params(), ctx=pt.gpu(0), **smoke.MODEL, **smoke.SERVE)
    dec.warmup()
    steps = smoke.breakdown(dec, prompt)
    for name in ("prefill", "decode"):
        out[name + "_ms"] = steps[name]["device_busy_ms"]
        out[name + "_port_kernels_ms"] = steps[name]["port_kernels_ms"]
        out[name + "_norm_residual_ms"] = steps[name]["port_kernel_ms"].get("norm_residual", 0.0)
    out["prefill_flash_attention_ms"] = steps["prefill"]["port_kernel_ms"].get(
        "flash_attention", 0.0)

    def prefill():
        dec.reset()
        return dec.prefill(prompt)  # logits on the host

    out["prefill_latency_ms_p50"] = median_ms(prefill)
    out["prefill_norm_residual_launches"] = ln_launches(prefill)
    nxt = np.argmax(prefill(), axis=-1)
    out["decode_latency_ms_p50"] = median_ms(lambda: dec.greedy_step(nxt))
    out["decode_norm_residual_launches"] = ln_launches(lambda: dec.greedy_step(nxt))
    del dec
    params = smoke.random_params()
    net, _, bind = smoke.train_model(params)
    step = smoke.train_step_fn(net, params, bind(pt.gpu(0), smoke.TRAIN["batch"]))
    for _ in range(smoke.TRAIN["warmup_steps"]):
        step()
    w = smoke.profile_window(step)
    out["train_step_ms"] = w["device_busy_ms"]
    out["train_step_port_kernels_ms"] = w["port_kernels_ms"]
    # a kernel's ms is that of the profiler's events that chip_smoke.KERNELS
    # names for it: for the LayerNorm backward, the events named for it (a
    # checkout that summed its partial rows with torch: its first kernel
    # only), and its whole calls with the sums that follow each
    for name in ("flash_attention", "flash_attention_dq", "flash_attention_dkv",
                 "norm_residual", "norm_residual_bwd"):
        out["train_step_%s_ms" % name] = w["port_kernel_ms"].get(name, 0.0)
    out["train_step_norm_residual_launches"] = ln_launches(step)
    (out["train_step_norm_residual_bwd_call_ms"],
     out["train_step_norm_residual_bwd_calls"]) = layer_norm_bwd_call_ms(step)
    out["train_step_latency_ms_p50"] = median_ms(step)
    del step
    net = resnet.get_symbol(**smoke.RESNET)
    args, aux = smoke.resnet_values(net)
    images, labels = smoke.resnet_batch(smoke.RESNET_TRAIN["batch"])
    for B in smoke.RESNET_SERVE["batches"]:
        exe = smoke.resnet_bind(pt, net, pt.gpu(0), B, args, aux, "null", images, labels)
        for _ in range(3):
            exe.forward(is_train=False)

        def forwards(exe=exe):
            for _ in range(3):
                exe.forward(is_train=False)

        def forward(exe=exe):
            exe.forward(is_train=False)
            torch.cuda.synchronize()

        w = smoke.profile_window(forwards, per=3)
        out["resnet_forward_b%d_ms" % B] = w["device_busy_ms"]
        out["resnet_forward_b%d_conv_ms" % B] = w["port_kernels_ms"]
        out["resnet_forward_b%d_latency_ms_p50" % B] = median_ms(forward)
        del exe
    from mxnet_tpu_torch.predictor import Predictor

    with tempfile.TemporaryDirectory() as tmp:
        prefix, epoch = tmp + "/resnet50", smoke.DEPLOY["epoch"]
        pt.model.save_checkpoint(prefix, epoch, net, args, aux)
        pt.nd.waitall()  # the write is queued on the engine
        json_str = Path(prefix + "-symbol.json").read_text()
        blob = Path("%s-%04d.params" % (prefix, epoch)).read_bytes()
    B = smoke.DEPLOY["batch"]
    pred = Predictor(json_str, blob, {"data": (B,) + smoke.image_shape()})
    x = pt.nd.array(images[:B])

    def request():
        pred.forward(data=x)
        pred.get_output(0)

    request()
    out["deploy_request_ms"] = smoke.profile_window(request)["device_busy_ms"]
    del pred
    # the request's matmul_with_stats: stage 1's 1x1 shortcut convolution on
    # the tapped activation, as the smoke's deploy phase runs it
    tap = Predictor(pt.sym.load_json(json_str).get_internals()[smoke.DEPLOY["tap"]].tojson(),
                    blob, {"data": (B,) + smoke.image_shape()})
    tap.forward(data=x)
    feat = pt.nd.array(tap.get_output(0))
    a = pt.nd.transpose(feat, axes=(0, 2, 3, 1)).reshape((-1, feat.shape[1]))._tensor()
    w_sc = args[smoke.DEPLOY["tap_weight"]]
    b = torch.from_numpy(np.ascontiguousarray(w_sc.reshape(w_sc.shape[:2]).T)).cuda()
    del tap
    ms.matmul_with_stats(a, b)
    w = smoke.profile_window(lambda: ms.matmul_with_stats(a, b))
    out["deploy_matmul_stats_ms"] = w["port_kernel_ms"].get("matmul_stats", 0.0)
    out["deploy_matmul_stats_shape"] = [a.shape[0], a.shape[1], b.shape[1]]
    del a, b, feat
    B = smoke.RESNET_TRAIN["batch"]
    exe = smoke.resnet_bind(pt, net, pt.gpu(0), B, args, aux, {n: "write" for n in args},
                            images, labels)
    for _ in range(2):
        exe.forward_backward()
    w = smoke.profile_window(exe.forward_backward)
    out["resnet_train_step_ms"] = w["device_busy_ms"]
    out["resnet_train_step_conv_ms"] = w["port_kernels_ms"]
    out["resnet_train_step_conv_bn_bwd_ms"] = w["port_kernel_ms"].get("conv_bn_bwd", 0.0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout whose mxnet_tpu_torch to time")
    repo = Path(ap.parse_args().repo).resolve()
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        print("torch_card_times: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import mxnet_tpu_torch as pt

    if Path(pt.__file__).resolve().parents[1] != repo:
        raise RuntimeError("imported %s, not the one under %s" % (pt.__file__, repo))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"repo": str(repo), "nvidia_smi": smi, **kernel_times(smoke),
                      **card_times(smoke, pt)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
