#!/usr/bin/env python3
"""Where a bfloat16 train-mode forward on the card parts from the CPU's,
layer by layer, on one GPU.

    python3 tools/exp_bf16_loss_layers.py

For YOLOv12-s and YOLOv13-s (nc=80, chip_smoke.py's seeded weights,
FullPAD gates 0.5, Detect class biases 0) on chip_smoke.py's first
train-parity batch (2 images at 256 px), dropout off, runs the train-mode
forward and loss of a float64 copy of the float32 model on the CPU (the reference), of
the bfloat16 model on the CPU (plain versions), of its copy on the card
(kernels, TF32 off), and of the card's copy again with the plain area
attention in place of the K3 kernels. Prints one JSON line a model: the
four runs' loss items, and for each top-level layer the largest distance
of each bfloat16 run's output from the reference over the reference's
largest, and the mean distance over the reference's standard deviation
(a shift common to the layer's outputs).
"""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from yolo_dbl_tpu_torch.cfg import get_cfg  # noqa: E402
from yolo_dbl_tpu_torch.engine.trainer import train_loss  # noqa: E402
from yolo_dbl_tpu_torch.kernels import attention as KA  # noqa: E402
from yolo_dbl_tpu_torch.kernels import build  # noqa: E402
from yolo_dbl_tpu_torch.nn import blocks as NB  # noqa: E402


def run(model, batch, cfg):
    """({layer index: its output flattened to float64 on the CPU}, loss items)."""
    outs, hooks = {}, []
    for layer in model.spec.layers:
        name = f"m{layer.i}" if layer.n == 1 else f"m{layer.i}_{layer.n - 1}"
        if hasattr(model, name):
            hooks.append(getattr(model, name).register_forward_hook(
                lambda m, a, o, i=layer.i: outs.__setitem__(i, torch.cat(
                    [t.detach().flatten().double().cpu()
                     for t in (o if isinstance(o, (list, tuple)) else [o])]))))
    b = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
    if model.dtype == torch.float64:
        b = {k: v.double() if v.is_floating_point() else v for k, v in b.items()}
    try:
        with torch.no_grad():
            _, items = train_loss(model, cfg, b)
    finally:
        for h in hooks:
            h.remove()
    return outs, {k: float(v) for k, v in items._asdict().items()}


def main():
    if not torch.cuda.is_available():
        print("exp_bf16_loss_layers: needs one GPU", file=sys.stderr)
        return 2
    build.build()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_cfg()
    for model_cfg in (S.V12, S.V13):
        cpu32, _ = S.build_models(model_cfg)
        cpu16, gpu16 = S.build_models(model_cfg, S.BF16)
        for model in (cpu32, cpu16, gpu16):  # as in train_parity: the devices draw other bits
            for mod in model.modules():
                if isinstance(mod, torch.nn.Dropout):
                    mod.p = 0.0
        batch = S.train_batches(np.random.default_rng(2), 1, b=2, imgsz=256,
                                nc=model_cfg[1])[0]
        ref, l64 = run(copy.deepcopy(cpu32).double(), batch, cfg)
        runs = {"cpu_bf16": run(cpu16, batch, cfg), "card_bf16": run(gpu16, batch, cfg)}
        kernel = NB.area_attention
        NB.area_attention = KA.area_attention_plain
        try:
            runs["card_bf16_plain_attention"] = run(copy.deepcopy(gpu16), batch, cfg)
        finally:
            NB.area_attention = kernel
        layers = []
        for i, r in sorted(ref.items()):
            row = {"i": i, "module": cpu16.spec.layers[i].name}
            for key, (outs, _) in runs.items():
                d = outs[i] - r
                row[key] = {"max_rel": float(d.abs().max() / r.abs().max()),
                            "mean_shift": float(d.mean() / r.std())}
            layers.append(row)
        S.emit({"model": model_cfg[0], "loss_float64": l64,
                **{f"loss_{k}": v[1] for k, v in runs.items()}, "layers": layers})
    return 0


if __name__ == "__main__":
    sys.exit(main())
