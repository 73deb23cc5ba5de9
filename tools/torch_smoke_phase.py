#!/usr/bin/env python3
"""Run one phase of ``chip_smoke.py`` alone on the card.

    python3 tools/torch_smoke_phase.py bind      # phase 20, the bind-time control plane
    python3 tools/torch_smoke_phase.py analysis  # phase 21, the analysis lint families
    python3 tools/torch_smoke_phase.py layouts   # phase 22, ring attention and ctx groups
    python3 tools/torch_smoke_phase.py train_bf16  # phase 23, the bf16 training step
    python3 tools/torch_smoke_phase.py serve_lm_bf16  # phase 24, the LM served in bf16
    python3 tools/torch_smoke_phase.py conv_stash  # phase 26, the conv+BN stash policy

It builds the port's kernel library from the checkout, prints the card's
name and power limit, then calls ``chip_smoke.run_<phase>(pt, smi)``: the
phases that take nothing else (``conv_stash``, ``serve_lm_bf16``, ``train_bf16``, ``layouts``,
``analysis``,
``bind``, ``fleet``, ``checkpoint``, ``planner``, ``native``). The phase prints its JSON lines as in the whole
smoke; the script exits nonzero where a check fails.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("conv_stash", "serve_lm_bf16", "train_bf16", "layouts", "analysis", "bind", "fleet", "checkpoint", "planner",
          "native")


def main(argv):
    if len(argv) != 1 or argv[0] not in PHASES:
        print("usage: torch_smoke_phase.py {%s}" % "|".join(PHASES), file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.build_library()
    cuda_build.library()
    chip_smoke.log({"phase": "build", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    getattr(chip_smoke, "run_" + argv[0])(pt, smi)
    chip_smoke.log({"phase": argv[0] + "_alone", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
