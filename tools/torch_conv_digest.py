#!/usr/bin/env python3
"""Digests of the float32 conv+BN forward kernel's output at two seeded sites.

    python3 tools/torch_conv_digest.py                     # this checkout
    python3 tools/torch_conv_digest.py --repo build/parent # another tree

Needs one card. It builds the kernel library of the tree it imports (the
checkout, or ``--repo``'s ``mxnet_tpu_torch``) and prints one JSON line:
the tree, the card's name, and for each site a sha256 (first 16 hex
digits) of the bytes of ``conv_block``'s (c, ssum, ssq) and of
``conv_block_infer``'s c on the card. The sites are ResNet-50's stage-1 3x3
(x (2, 64, 56, 56), w (64, 64, 3, 3)) and its stage-2 1x1 (x (2, 256, 56, 56),
w (128, 256, 1, 1)), both with the BatchNorm prologue and its ReLU, their
values made by numpy from a seed. Two trees whose digests agree compute
the float32 kernel to the same bits; ``tests/test_torch_cuda.py`` holds
the checkout to the digests recorded for the tree before the kernel gained
its bf16 variant.
"""
import argparse
import hashlib
import json
import os
import sys

#: site name -> (x shape, w shape, seed)
SITES = {"3x3": ((2, 64, 56, 56), (64, 64, 3, 3), 31),
         "1x1": ((2, 256, 56, 56), (128, 256, 1, 1), 32)}


def site_values(name):
    """The site's x, w, scale and shift as float32 numpy arrays."""
    import numpy as np

    xs, ws, seed = SITES[name]
    rs = np.random.RandomState(seed)
    x = rs.randn(*xs).astype(np.float32)
    w = (rs.randn(*ws) * np.sqrt(2.0 / (ws[1] * ws[2] * ws[3]))).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, xs[1]).astype(np.float32)
    shift = rs.uniform(-0.5, 0.5, xs[1]).astype(np.float32)
    return x, w, scale, shift


def digests(cb, device):
    """{site: {"conv_block": hex, "conv_block_infer": hex}} of the float32
    kernels of the conv_bn module ``cb`` on ``device``."""
    import torch

    out = {}
    for name in SITES:
        x, w, scale, shift = (torch.from_numpy(a).to(device) for a in site_values(name))
        c, s, q = cb.conv_block(x, w, scale, shift, None, (1, 1), True)
        ci = cb.conv_block_infer(x, w, scale, shift, (1, 1), True)
        torch.cuda.synchronize(device)
        out[name] = {k: hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)
                                       ).hexdigest()[:16]
                     for k, ts in (("conv_block", (c, s, q)), ("conv_block_infer", (ci,)))}
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    from mxnet_tpu_torch.ops import conv_bn as cb

    if not torch.cuda.is_available():
        print("torch_conv_digest: needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.abspath(cb.__file__).startswith(repo + os.sep):
        print("torch_conv_digest: imported %s, not the tree %s" % (cb.__file__, repo),
              file=sys.stderr)
        return 1
    print(json.dumps({"tree": args.repo, "card": torch.cuda.get_device_name(0),
                      "digests": digests(cb, torch.device("cuda", 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
