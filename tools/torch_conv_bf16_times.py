"""Card time of the bf16 conv+BN kernels (rows 8 and 9 of PERF.md's kernel
table) at ResNet-50's five timed shapes at batch 32, for one checkout.

Run it for two checkouts in turns in one call on one card to compare them
(parent, tree, tree, parent):

    python3 tools/torch_conv_bf16_times.py --repo build/parent
    python3 tools/torch_conv_bf16_times.py --repo .

Each form is timed by CUDA events around ``--iters`` calls queued behind a
sleep on the card (so the window holds the card's time and none of the
host's): the stats-free serving forward on float32 operands
(``conv_block_infer(..., compute="bfloat16")``), the training forward, the
stash forward, the backward and the stash backward, all on bf16 operands.
The two backwards are also split by pass (fold, wflip, dgrad, wgrad,
partials_sum) from the profiler's device time of their kernels. One JSON
line a shape, with the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# (B, K, H, W, N, kernel, stride, residual, label): chip_smoke.py's
# BF16_TRAIN_TIMED
SHAPES = [(32, 64, 56, 56, 64, 3, 1, False, "s1_3x3"),
          (32, 64, 56, 56, 256, 1, 1, True, "s1_res1x1"),
          (32, 256, 56, 56, 512, 1, 2, False, "s2_1x1_s2"),
          (32, 256, 14, 14, 256, 3, 1, False, "s3_3x3"),
          (32, 512, 7, 7, 2048, 1, 1, True, "s4_res1x1")]
PARTS = ("fold", "wflip", "dgrad", "wgrad", "partials_sum")


def event_ms(fn, iters):
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
        queued_first = not start.query()
        torch.cuda.synchronize()
        if queued_first:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("the host did not queue the calls within the sleep")


def split_ms(fn, prefix, iters):
    """The profiler's device ms a call of each of the backward's passes."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for attempt in range(6):
        if attempt:
            time.sleep(0.3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = {}
        for evt in prof.key_averages():
            if prefix in evt.key:
                us = float(getattr(evt, "self_device_time_total",
                                   getattr(evt, "self_cuda_time_total", 0.0)))
                part = next((p for p in PARTS if prefix + p in evt.key), None)
                if part is not None:
                    ms[part] = ms.get(part, 0.0) + us / 1e3 / iters
        if len(ms) == len(PARTS):
            return ms
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=".", help="the checkout whose mxnet_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no card")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from mxnet_tpu_torch.ops import conv_bn as cb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev, b16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for B, K, H, W, N, kernel, stride, res, label in SHAPES:
        Ho, Wo = (cb.strided_dims(H, W, (stride, stride)) if kernel == 1 else (H, W))
        x = randn(B, K, H, W)
        w = randn(N, K, kernel, kernel, scale=(2.0 / (K * kernel * kernel)) ** 0.5)
        scale, shift = 0.5 + torch.rand(K, generator=gen, device=dev), randn(K, scale=0.1)
        r = randn(B, N, Ho, Wo).to(b16) if res else None
        xb, wb = x.to(b16), w.to(b16)
        dc, ds, dq = randn(B, N, Ho, Wo).to(b16), randn(N, scale=0.01), randn(N, scale=1e-3)
        st = (stride, stride)
        c, _, _, xn = cb.conv_block(xb, wb, scale, shift, r, st, True, emit_xn=True)
        bargs = (xb, wb, scale, shift, c, dc, ds, dq, st, True, res)
        rec = {"repo": args.label or args.repo, "card": card, "shape": label,
               "serve_event_ms": event_ms(lambda: cb.conv_block_infer(
                   x, w, scale, shift, st, True, compute="bfloat16"), args.iters),
               "fwd_event_ms": event_ms(lambda: cb.conv_block(xb, wb, scale, shift, r, st, True),
                                        args.iters),
               "stash_fwd_event_ms": event_ms(lambda: cb.conv_block(
                   xb, wb, scale, shift, r, st, True, emit_xn=True), args.iters),
               "bwd_event_ms": event_ms(lambda: cb.conv_block_bwd(*bargs), args.iters),
               "stash_bwd_event_ms": event_ms(lambda: cb.conv_block_bwd(*bargs, xn=xn),
                                              args.iters),
               "bwd_kernels_ms": split_ms(lambda: cb.conv_block_bwd(*bargs),
                                          "conv_bn_bf16_bwd_", args.iters),
               "stash_bwd_kernels_ms": split_ms(lambda: cb.conv_block_bwd(*bargs, xn=xn),
                                                "conv_bn_stash_bf16_bwd_", args.iters)}
        print(json.dumps(rec), flush=True)
        del x, w, xb, wb, r, dc, c, xn, bargs


if __name__ == "__main__":
    main()
