#!/usr/bin/env python3
"""The SSD loss of VGG16-SSD-300 through ``Module.fit`` by learning rate.

    python3 tools/torch_ssd_lr.py

``chip_smoke.py``'s SSD phase at its widths and data (``SSD``: batch 8, two
fixed ``SyntheticDetIter`` batches, SGD momentum 0.9, wd 5e-4, Xavier
weights from one seed) trained for 5 epochs at each learning rate of
``RATES`` (``example/ssd/train_ssd.py``'s 0.01 first, then smaller ones, and
0.01 with gradients clipped at 10), the SSD loss of every step
(``models.vgg16_ssd.ssd_objective``) on one JSON line a rate, then the card's name
and power limit. Needs one CUDA card; exits 2 without one.
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

RATES = ((0.01, None), (0.004, None), (0.002, None), (0.001, None), (0.01, 10.0))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_ssd_lr: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.models import vgg16_ssd as ssd

    cfg = cs.SSD
    net = models.get_symbol("vgg16-ssd-300-train", num_classes=cfg["num_classes"])
    with pt.gpu(0):
        train = ssd.SyntheticDetIter(cfg["batch"], cfg["image"], cfg["num_classes"],
                                     cfg["fit_batches"], max_objects=cfg["max_objects"],
                                     seed=cs.SEED + 63)
    for lr, clip in RATES:
        mod = pt.mod.Module(net, data_names=("data",), label_names=("label",),
                            context=pt.gpu(0))
        loss = []
        opt = [("learning_rate", lr), ("momentum", cfg["momentum"]), ("wd", cfg["wd"])]
        if clip:
            opt.append(("clip_gradient", clip))
        pt.random.seed(cs.SEED + 65)
        train.reset()
        mod.fit(train, eval_metric=pt.metric.Loss(), optimizer="sgd",
                optimizer_params=tuple(opt), initializer=pt.init.Xavier(),
                batch_end_callback=lambda p: loss.append(ssd.ssd_objective(mod.get_outputs())),
                num_epoch=5)
        print(json.dumps({"lr": lr, "clip_gradient": clip, "ssd_loss": loss}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
