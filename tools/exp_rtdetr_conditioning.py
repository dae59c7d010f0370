#!/usr/bin/env python3
"""How far float32 can reach float64 on RT-DETR-l's seeded train step, on
the CPU.

    python3 tools/exp_rtdetr_conditioning.py [--imgsz 256] [--batch 2]

For RT-DETR-l (nc=80, chip_smoke.py's seeded weights) on chip_smoke.py's
first train-parity batch (seed 2), prints one JSON line each:

- `trunk_gain`: the largest change of the trunk's outputs (P5 and the
  neck's last RepC3) over their largest, in float64, when the input is
  multiplied by 1 + 1e-7 noise, in train mode and in eval mode;
- `whole_step` (seeded, then with `rtdetr_anchor_boxes`): the train-mode
  loss and backward in float32 in 8 threads and in 1 thread (under the
  8-thread run's query selection and matchings) against float64: the loss
  items' relative distances, and over the leaves whose float64 gradient is
  not 0 (its largest above 1e-12 of the model's), the largest and the
  median distance of each run over the leaf's largest, and the count past
  1e-3;
- `decoder_alone` (the same two weights): the decoder and rtdetr_loss on
  the float32 trunk's train-mode pyramid, every side fed the same tensors,
  likewise over the decoder's leaves and each level's input gradient.

chip_smoke.py's train_parity_rtdetr and train_parity_decoder_rtdetr hold
the card at the bars these distances allow.
"""

import argparse
import copy
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from yolo_dbl_tpu_torch.cfg import get_cfg  # noqa: E402
from yolo_dbl_tpu_torch.engine.trainer import train_loss  # noqa: E402
from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize  # noqa: E402
from yolo_dbl_tpu_torch.losses.detr import rtdetr_loss  # noqa: E402


def trunk_outputs(model, x, train):
    """{row: output} of P5 (m9) and the neck's last RepC3 (m27)."""
    out, hooks = {}, []
    for i in (9, 27):
        hooks.append(getattr(model, f"m{i}").register_forward_hook(
            lambda mod, args, o, i=i: [out.setdefault(i, o), None][1]))
    model.train(train)
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return out


def trunk_gain(model, img):
    ref64 = copy.deepcopy(model).double()
    x = device_normalize(img, torch.float64)
    noise = 1 + 1e-7 * torch.randn(x.shape, generator=torch.Generator().manual_seed(1),
                                   dtype=torch.float64)
    gain = {}
    for mode, train in (("train", True), ("eval", False)):
        a, b = trunk_outputs(copy.deepcopy(ref64), x, train), trunk_outputs(
            copy.deepcopy(ref64), x * noise, train)
        gain[mode] = {f"m{i}": float((b[i] - a[i]).abs().max() / a[i].abs().max()) for i in a}
    return gain


def distances(runs, ref, floor):
    """Over the leaves whose largest |ref| exceeds `floor`: each run's
    largest, median and count past 1e-3 of the leaf's largest."""
    out = {}
    for name, g in runs.items():
        rel = [float((g[n].double() - r).abs().max()) / float(r.abs().max())
               for n, r in ref.items() if float(r.abs().max()) > floor]
        out[name] = {"worst": max(rel), "median": statistics.median(rel),
                     "past_1e-3": sum(v > 1e-3 for v in rel), "leaves": len(rel)}
    return out


def items_rel(items, ref):
    return {k: abs(items[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ref}


def step(model, fn, threads, pins=(None, None)):
    """(items, {leaf: gradient}, pins) of `fn(model)`'s loss in `threads`."""
    torch.set_num_threads(threads)
    with S.pinned_queries(pins[0]) as sq, S.pinned_matching(pins[1]) as sm:
        loss, items, leaves = fn(model)
    grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    return (dict(loss=float(loss.detach()), **{k: float(v.detach())
                                               for k, v in items._asdict().items()}),
            dict(zip(leaves, grads)), (sq[0][0], sm[0][0]))


def compare(model, fn, threads):
    """8 (or `threads`) threads, 1 thread and float64 of one step."""
    i8, g8, pins = step(copy.deepcopy(model), fn, threads)
    i1, g1, _ = step(copy.deepcopy(model), fn, 1, pins)
    i64, g64, _ = step(copy.deepcopy(model).double(), fn, threads, pins)
    floor = 1e-12 * max(float(g.abs().max()) for g in g64.values())
    return {"items": {f"{threads}_threads": items_rel(i8, i64), "1_thread": items_rel(i1, i64)},
            "leaves": distances({f"{threads}_threads": g8, "1_thread": g1}, g64, floor)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--imgsz", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    threads = torch.get_num_threads()
    model = S.seeded_model(S.RTDETR)
    batch = S.train_batches(np.random.default_rng(2), 1, b=args.batch, imgsz=args.imgsz,
                            nc=S.RTDETR[1])[0]
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    print(json.dumps({"trunk_gain": trunk_gain(model, batch["img"]),
                      "imgsz": args.imgsz, "batch": args.batch}), flush=True)
    cfg = get_cfg()

    def whole(m):
        loss, items = train_loss(m, cfg, batch)
        return loss, items, dict(m.named_parameters())

    for weights in ("seeded", "rtdetr_anchor_boxes"):
        if weights == "rtdetr_anchor_boxes":
            S.rtdetr_anchor_boxes(model)
        print(json.dumps({"whole_step": weights, **compare(model, whole, threads)}), flush=True)
        pyramid = []
        trunk = copy.deepcopy(model).train()
        hook = trunk.detect.register_forward_pre_hook(lambda mod, a: pyramid.extend(a[0]))
        with torch.no_grad():
            trunk(device_normalize(batch["img"], torch.float32))
        hook.remove()

        def decoder(dec):
            feats = [f.to(next(dec.parameters()).dtype).requires_grad_() for f in pyramid]
            loss, items = rtdetr_loss(dec.train()(feats), batch, S.RTDETR[1])
            return loss, items, {**dict(dec.named_parameters()), "P3": feats[0], "P4": feats[1],
                                 "P5": feats[2]}

        print(json.dumps({"decoder_alone": weights,
                          **compare(model.detect, decoder, threads)}), flush=True)


if __name__ == "__main__":
    main()
