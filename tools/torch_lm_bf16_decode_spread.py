#!/usr/bin/env python3
"""Where the bf16 LM decoders' logits part: the port's ``KVCacheDecoder(dtype=
'bfloat16')`` against the JAX package's, compiled (its executables jit) and
evaluated op by op (``jax.disable_jit``), on bf16 weights.

    JAX_PLATFORMS=cpu python3 tools/torch_lm_bf16_decode_spread.py [--steps 4]

Runs on the CPU (about a minute; the op-by-op run takes most of it). The
model, batch, prompt, weights and switches are
``tests/test_torch_serve_lm_bf16.py``'s (2 layers, width 128, vocabulary 200,
batch 8, the JAX side's Pallas kernels forced and interpreted). JAX's
op-by-op run picks the greedy tokens; the compiled run and the port are fed
them. Prints one JSON line: for the prefill and each step, the share of
logits the port gives bit for bit like each JAX evaluation, the largest
absolute difference, and the logits' largest magnitude.
"""
import argparse
import json
import os
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "tests")]
    import jax
    import numpy as np
    import torch

    import mxnet_tpu as mx
    import mxnet_tpu_torch as pt
    import test_torch_serve_lm_bf16 as T

    os.environ["MXNET_GRAPHREWRITE"] = "on"
    os.environ["MXNET_FUSED_PATTERNS_INFER"] = T.FORCED_INFER
    host = {n: v.astype(T.BF16) for n, v in T._params().items()}
    prompt = T._prompts()

    def run(dec, tokens=None):
        out = [np.asarray(dec.prefill(prompt), np.float32)]
        fed = []
        for i in range(args.steps):
            tok = np.argmax(out[-1], axis=-1) if tokens is None else tokens[i]
            fed.append(tok)
            out.append(np.asarray(dec.decode_step(tok), np.float32))
        return np.stack(out), fed

    def jax_decoder():
        return T.JaxDecoder(host, ctx=mx.cpu(), dtype="bfloat16", **T.CFG, **T.LOCKSTEP)

    with jax.disable_jit():
        op_by_op, tokens = run(jax_decoder())
    compiled, _ = run(jax_decoder(), tokens)
    port, _ = run(T.KVCacheDecoder(pt.params_from_numpy(host, ctx=pt.cpu()), ctx=pt.cpu(),
                                   dtype="bfloat16", **T.CFG, **T.LOCKSTEP), tokens)

    def spread(ref):
        return {"bitwise_share": [float((port[i] == ref[i]).mean()) for i in range(len(ref))],
                "max_abs_diff": [float(np.abs(port[i] - ref[i]).max())
                                 for i in range(len(ref))]}

    print(json.dumps({"positions": ["prefill"] + ["step %d" % (i + 1) for i in range(args.steps)],
                      "port_vs_jax_op_by_op": spread(op_by_op),
                      "port_vs_jax_compiled": spread(compiled),
                      "jax_compiled_vs_op_by_op_bitwise_share":
                          [float((compiled[i] == op_by_op[i]).mean())
                           for i in range(len(op_by_op))],
                      "logit_max_abs": float(np.abs(op_by_op).max()),
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
