#!/usr/bin/env python3
"""Parameters and forward operations of the port's models, on the CPU.

    python3 tools/model_flops.py [config.yaml ...]

Builds each config (nc=3) with the port's `DetectionModel`, moves it to the
meta device and counts the floating-point operations of one 640x640 image's
forward with `torch.utils.flop_counter` (two a multiply-add of the
convolutions and matrix products; elementwise work is not counted). No
data is touched, so it runs in seconds on any machine.
"""

import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from yolo_dbl_tpu_torch import DetectionModel  # noqa: E402

CONFIGS = ("yolov13s_DBL.yaml", "yolov13l_DBL2.yaml", "yolov13s.yaml")


def main(names):
    for name in names:
        model = DetectionModel(name, nc=3, device="cpu").to("meta")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(torch.zeros((1, 640, 640, 3), device="meta"))
        print(f"{name}: {sum(p.numel() for p in model.parameters()):,} parameters, "
              f"{counter.get_total_flops() / 1e9:.2f} GFLOP an image at 640")


if __name__ == "__main__":
    main(sys.argv[1:] or CONFIGS)
