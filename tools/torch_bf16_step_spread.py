#!/usr/bin/env python3
"""How far the bf16 training step's parameters part after a few steps: the
port's against the JAX package's compiled step, the port's against the JAX
package's step evaluated op by op (``jax.disable_jit``), and the JAX
package's two evaluations against each other.

    JAX_PLATFORMS=cpu python3 tools/torch_bf16_step_spread.py [--steps 3]

Runs on the CPU (about a minute; the op-by-op steps take most of it). The
net, batch, weights and switches are ``tests/test_torch_train_bf16.py``'s
(two residual units of the package's ResNet on 16 channels, batch 4, SGD
with momentum, ``MXNET_FUSED_CONV_BN=1``, ``MXNET_FUSED_CONV_BN_BWD=
recompute``). Prints one JSON line: each step's loss under the three
evaluations, and for each parameter the largest difference of each pair
over that parameter's largest magnitude after the steps. The bounds of
that test's whole-step comparison are twice the largest spread between the
JAX package's own two evaluations.
"""
import argparse
import json
import os
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["MXNET_FUSED_CONV_BN"] = "1"
    os.environ["MXNET_FUSED_CONV_BN_BWD"] = "recompute"
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "tests")]
    import jax
    import numpy as np

    import mxnet_tpu
    import mxnet_tpu_torch as pt
    import test_torch_train_bf16 as T

    rs = np.random.RandomState(0)
    x = rs.rand(4, 16, 8, 8).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.float32)
    feed = ({"data": x}, {"softmax_label": y})
    params, losses, start = {}, {}, None
    for mode in ("compiled", "op_by_op"):
        tr = T._trainer(mxnet_tpu, mxnet_tpu.parallel.make_mesh(
            {"data": 1}, devices=jax.devices()[:1]))
        tr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
        if start is None:
            start = [{k: np.asarray(v) for k, v in d.items()} for d in tr.get_params()]
        losses[mode] = []
        for _ in range(args.steps):
            if mode == "compiled":
                out = tr.step(*feed)[0]
            else:
                with jax.disable_jit():
                    out = tr.step(*feed)[0]
            losses[mode].append(T._xent(T._t(out), y))
        params[mode] = {k: np.asarray(v) for k, v in tr.get_params()[0].items()}
    tr = T._trainer(pt, pt.parallel.make_mesh((1,), ("data",), [pt.cpu()]))
    tr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
    tr.set_params(*start)
    losses["port"] = [T._xent(tr.step(*feed)[0].float(), y) for _ in range(args.steps)]
    params["port"] = tr.get_params()[0]
    spread = {}
    for k in sorted(params["compiled"]):
        scale = float(np.abs(params["compiled"][k]).max()) or 1.0
        spread[k] = {
            "starts_at_zero": not np.abs(start[0][k]).any(),
            "port_vs_compiled": float(np.abs(params["port"][k] - params["compiled"][k]).max())
            / scale,
            "port_vs_op_by_op": float(np.abs(params["port"][k] - params["op_by_op"][k]).max())
            / scale,
            "op_by_op_vs_compiled": float(
                np.abs(params["op_by_op"][k] - params["compiled"][k]).max()) / scale}
    print(json.dumps({"steps": args.steps, "losses": losses, "spread": spread}))


if __name__ == "__main__":
    main()
