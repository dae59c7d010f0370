#!/usr/bin/env python3
"""How far float32 reaches float64 on LDA-DBL's seeded train step, on the
CPU, with and without the tap cells pinned.

    python3 tools/exp_lda_conditioning.py [--scale s] [--imgsz 256]
        [--weight-seed 0] [--batch-seed 2] [--threads 8]

LDA-DBL (tests/torch_fixtures.py `lda_dbl`, nc=3), its weights drawn from
`--weight-seed` with chip_smoke.py's settings (FullPAD gates at 0.5, the
Detect class biases 0, dropout off), on the first train-parity batch that
chip_smoke.py draws from `--batch-seed` (batch 2). The defaults are
chip_smoke.py's train_parity_lda. Prints one JSON line each for YOLO-DBL at
the same scale and for LDA-DBL, unpinned and pinned:

- the loss in float32 and float64;
- over the leaves whose float64 gradient is not 0 (its largest above
  1e-10 of the model's), the count whose float32 gradient parts from the
  float64 one by more than 1e-3 of the leaf's largest, and the five worst;
- unpinned: K2's coordinates (DySample's or LDA_AQU's) in float32 against
  float64, call by call: the largest |Δ| in pixels, the largest
  |coordinate|, and the taps whose cell (the floor of a coordinate)
  differs;
- pinned (LDA-DBL): the float64 run's K2 taps held to the float32 run's
  cells (chip_smoke.py `pinned_cells`), with the taps moved a call and the
  largest move in pixels.

Bilinear sampling's gradient in its coordinates jumps where a tap crosses
a pixel boundary, and a tap that float32 and float64 (or two devices'
float32 sum orders) place on either side of one moves the offset network's
gradient by percents. chip_smoke.py's train_parity_lda pins the card's and
the float64 reference's cells to the CPU's, each move at most LDA_PIN_PX.
"""

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tests.torch_fixtures import lda_dbl  # noqa: E402
from yolo_dbl_tpu_torch import DetectionModel  # noqa: E402
from yolo_dbl_tpu_torch.cfg import get_cfg  # noqa: E402
from yolo_dbl_tpu_torch.engine.trainer import train_loss  # noqa: E402
from yolo_dbl_tpu_torch.nn.blocks import FullPAD_Tunnel  # noqa: E402


def seeded(cfg, seed):
    model = DetectionModel(cfg, nc=3, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, FullPAD_Tunnel):
                mod.gate.fill_(0.5)
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        model.zero_class_biases()
    return model


def step(model, batch, dtype, cells=None):
    """(loss, {name: gradient}, pinned_cells record, K2's calls as sampled
    before any pin) of one train-mode step."""
    model = copy.deepcopy(model).to(dtype)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    names, params = zip(*model.named_parameters())
    with cs.pinned_cells(cells) as seen, cs.recording_sampler() as calls:
        loss, _ = train_loss(model, get_cfg(), b)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return float(loss.detach()), dict(zip(names, grads)), seen, calls


def compare(name, g32, g64):
    g_max = max(float(g.abs().max()) for g in g64.values())
    rel = {n: float((g32[n].double() - g64[n]).abs().max()) / float(g64[n].abs().max())
           for n in g64 if float(g64[n].abs().max()) > 1e-10 * g_max}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    return {"run": name, "leaves": len(rel), "past_1e-3": sum(v > 1e-3 for v in rel.values()),
            "worst": worst}


def coordinates(calls32, calls64):
    """K2's float32 coordinates against float64, call by call."""
    out = []
    for (_, gy32, gx32, _), (_, gy64, gx64, _) in zip(calls32, calls64):
        d = max(float((a.double() - b).abs().max()) for a, b in ((gy32, gy64), (gx32, gx64)))
        cells = sum(int((torch.floor(a.double()) != torch.floor(b)).sum())
                    for a, b in ((gy32, gy64), (gx32, gx64)))
        out.append({"largest_delta_px": d, "taps": gy32.numel(), "cells_differ": cells,
                    "largest_abs_px": max(float(gy64.abs().max()), float(gx64.abs().max()))})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="s")
    ap.add_argument("--imgsz", type=int, default=256)
    ap.add_argument("--weight-seed", type=int, default=0)
    ap.add_argument("--batch-seed", type=int, default=2)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    seeds = {"weight_seed": args.weight_seed, "batch_seed": args.batch_seed,
             "threads": args.threads}
    batch = cs.train_batches(np.random.default_rng(args.batch_seed), 1, b=2, imgsz=args.imgsz,
                             nc=3)[0]
    for label, cfg in ((f"DBL-{args.scale}", f"yolov13{args.scale}_DBL.yaml"),
                       (f"LDA-DBL-{args.scale}", lda_dbl(args.scale))):
        model = seeded(cfg, args.weight_seed)
        l32, g32, rec, calls32 = step(model, batch, torch.float32)
        l64, g64, _, calls64 = step(model, batch, torch.float64)
        print(json.dumps({**compare(f"{label} unpinned", g32, g64), "loss": [l32, l64],
                          "coordinates": coordinates(calls32, calls64), **seeds}), flush=True)
        if label.startswith("LDA"):
            l64p, g64p, moved, _ = step(model, batch, torch.float64, rec)
            print(json.dumps({**compare(f"{label} float64 pinned to float32's cells", g32, g64p),
                              "loss": [l32, l64p], "moved": [m for _, m, _ in moved],
                              "largest_move_px": max(d for _, _, d in moved), **seeds}),
                  flush=True)


if __name__ == "__main__":
    main()
