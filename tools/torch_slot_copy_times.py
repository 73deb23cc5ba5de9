#!/usr/bin/env python3
"""Card time of the ways a decode step can copy its KV writes back into the
decoders' fixed KV buffers.

    python3 tools/torch_slot_copy_times.py

A step's graph returns every layer's whole K and V buffers, of which it
changed one slot a lane. At the smoke's full width (``chip_smoke.py``'s
MODEL, SERVE and PAGED: 2L = 12 buffers) this times, by the profiler's
device events over 20 steps, copying them back: whole buffers, or only the
written slots, for the paged decoder's pool (H, lanes * max_len, dh) with
one scattered slot a lane (``index_select`` + ``index_copy_``, advanced
indexing, one slice copy a slot) and for the lockstep decoder's ring
(B, H, max_len, dh), where every lane writes the same slot (one slice
copy). Prints one JSON line with the card's name and power limit. Needs
one CUDA card; exits 2 without one.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def device_ms(fn, iters=20):
    """Device time of one call of ``fn``, and its kernels a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us += float(getattr(evt, "self_device_time_total", 0.0))
            n += int(evt.count)
    return {"ms": us / 1e3 / iters, "kernels": n / iters}


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_slot_copy_times: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as smoke

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    L, H = smoke.MODEL["num_layers"], smoke.MODEL["num_heads"]
    dh = smoke.MODEL["model_dim"] // H
    lanes, S = smoke.PAGED["lanes"], smoke.PAGED["lanes"] * smoke.PAGED["max_len"]
    B, R = smoke.SERVE["batch"], smoke.SERVE["max_len"]

    def buffers(shape):
        return ([torch.randn(*shape, device=dev, generator=gen) for _ in range(2 * L)],
                [torch.randn(*shape, device=dev, generator=gen) for _ in range(2 * L)])

    bufs, news = buffers((H, S, dh))
    phys = np.random.RandomState(smoke.SEED).choice(S, lanes, replace=False).tolist()
    idx = torch.tensor(phys, device=dev)

    def pool_whole():
        for b, n in zip(bufs, news):
            b.copy_(n)

    def pool_index():
        for b, n in zip(bufs, news):
            b.index_copy_(1, idx, n.index_select(1, idx))

    def pool_advanced():
        for b, n in zip(bufs, news):
            b[:, idx] = n[:, idx]

    def pool_slices():
        for b, n in zip(bufs, news):
            for s in phys:
                b[:, s:s + 1].copy_(n[:, s:s + 1])

    out = {"pool_shape": [H, S, dh], "ring_shape": [B, H, R, dh], "buffers": 2 * L,
           "pool_slots": lanes}
    for name, fn in (("pool_whole", pool_whole), ("pool_index_select_index_copy", pool_index),
                     ("pool_advanced_indexing", pool_advanced),
                     ("pool_slice_copy_a_slot", pool_slices)):
        out[name] = device_ms(fn)
    bufs, news = buffers((B, H, R, dh))
    s = R // 3

    def ring_whole():
        for b, n in zip(bufs, news):
            b.copy_(n)

    def ring_slot():
        for b, n in zip(bufs, news):
            b[:, :, s:s + 1, :].copy_(n[:, :, s:s + 1, :])

    out["ring_whole"] = device_ms(ring_whole)
    out["ring_slot"] = device_ms(ring_slot)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
