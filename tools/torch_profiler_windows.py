#!/usr/bin/env python3
"""How often a ``torch.profiler`` window on the card comes back without a
single device event, and what brings the events back.

    python3 tools/torch_profiler_windows.py [--seconds 300] [--iters 30]

Opens profiler windows (CUDA activity only, as ``chip_smoke.py``'s
``device_events`` does; every tenth one CPU and CUDA, as its
``profile_window`` does) one after another for ``--seconds``, each around
``--iters`` calls of one of the smoke's workloads: the port's LayerNorm
forward at the decode shape (8, 512), its matmul_bias_act at (8, 512, 2048)
and ``torch.addmm`` at the same shape. When a window shows no device event,
it tries in turn: the same window again at once; again after a synchronize
and a 0.2 s pause; a window with CPU and CUDA activity; and CUDA events
around the calls (which need no profiler). It notes which of them shows the
card's time, and whether the next ordinary window has events again.
Prints one JSON line with the counts and the card's name and power limit,
and writes it to ``chiprun_out/profiler_windows.json``. Needs one CUDA
card; exits 2 without one.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def window(fn, iters, cpu=False):
    """Device events (count, microseconds) in one profiler window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            n += int(evt.count)
            us += float(getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0)))
    return n, us


def events_ms(fn, iters):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_windows: needs a CUDA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.ops import matmul_bias_act as mba
    from mxnet_tpu_torch.ops import norm_residual as nr

    cuda_build.build_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 512, device=dev, generator=gen)
    g, b = torch.randn(512, device=dev, generator=gen), torch.randn(512, device=dev, generator=gen)
    w, bias = torch.randn(2048, 512, device=dev, generator=gen), torch.randn(2048, device=dev,
                                                                           generator=gen)
    work = [("layer_norm", lambda: nr.layer_norm_affine(x, g, b)),
            ("matmul_bias_act", lambda: mba.matmul_bias_act(x, w, bias, "relu")),
            ("addmm", lambda: torch.addmm(bias, x, w.t()))]
    for _, fn in work:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()

    windows, empty, incidents = 0, 0, []
    pending = None
    t_end = time.perf_counter() + args.seconds
    while time.perf_counter() < t_end:
        name, fn = work[windows % len(work)]
        cpu = windows % 10 == 9
        n, _ = window(fn, args.iters, cpu)
        windows += 1
        if pending is not None:
            pending["next_window_events"] = n
            pending = None
        if n:
            continue
        empty += 1
        inc = {"window": windows, "work": name, "cpu_activity": cpu,
               "at_s": args.seconds - (t_end - time.perf_counter())}
        inc["again_events"] = window(fn, args.iters)[0]
        torch.cuda.synchronize()
        time.sleep(0.2)
        inc["after_pause_events"] = window(fn, args.iters)[0]
        inc["cpu_and_cuda_events"] = window(fn, args.iters, cpu=True)[0]
        inc["events_ms"] = events_ms(fn, args.iters)
        incidents.append(inc)
        pending = inc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"windows": windows, "empty_windows": empty, "iters": args.iters,
           "seconds": args.seconds, "incidents": incidents[:50], "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvidia_smi": smi}
    line = json.dumps(out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profiler_windows.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
