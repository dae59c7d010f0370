#!/usr/bin/env python3
"""Where a bfloat16 train-mode forward on the card parts from the CPU's,
layer by layer, on one GPU.

    python3 tools/exp_bf16_loss_layers.py [v12 v13 v10 ...] [--seeds N]

For YOLOv12-s and YOLOv13-s (or the models named by their chip_smoke.py
suffix; nc=80, chip_smoke.py's seeded weights, FullPAD gates 0.5, Detect
class biases 0) on chip_smoke.py's first
train-parity batch (2 images at 256 px), dropout off, runs the train-mode
forward and loss of a float64 copy of the float32 model on the CPU (the reference), of
the bfloat16 model on the CPU (plain versions), of its copy on the card
(kernels, TF32 off), and of the card's copy again with the plain area
attention in place of the K3 kernels. Prints one JSON line a model: the
four runs' loss items, and for each top-level layer the largest distance
of each bfloat16 run's output from the reference over the reference's
largest, and the mean distance over the reference's standard deviation
(a shift common to the layer's outputs). With `--seeds N`, also the loss
items' distances from the reference of the bfloat16 runs on the CPU and the
card over the batches of seeds 2 to N + 1 (train_parity_bf16's batches are
seeds 2, 3, 4), without the layers, and their medians.
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


def _tensors(out):
    """The tensors of a layer's output: a map, a tuple or list of maps, or
    v10Detect's dict of two lists."""
    if isinstance(out, dict):
        return [t for v in out.values() for t in _tensors(v)]
    return [t for o in out for t in _tensors(o)] if isinstance(out, (list, tuple)) else [out]


def run(model, batch, cfg):
    """({layer index: its output flattened to float64 on the CPU}, loss items)."""
    outs, hooks = {}, []
    for layer in model.spec.layers:
        name = f"m{layer.i}" if layer.n == 1 else f"m{layer.i}_{layer.n - 1}"
        if hasattr(model, name):
            hooks.append(getattr(model, name).register_forward_hook(
                lambda m, a, o, i=layer.i: outs.__setitem__(i, torch.cat(
                    [t.detach().flatten().double().cpu() for t in _tensors(o)]))))
    b = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
    if model.dtype == torch.float64:
        b = {k: v.double() if v.is_floating_point() else v for k, v in b.items()}
    try:
        with torch.no_grad():
            loss, items = train_loss(model, cfg, b)
    finally:
        for h in hooks:
            h.remove()
    return outs, {"loss": float(loss), **{k: float(v) for k, v in items._asdict().items()}}


def seed_sweep(models, cfg, nc, n):
    """{item: {run: [distance from the float64 run a seed], run_median: x}}."""
    ref, cpu16, gpu16 = models
    dist = {}
    for seed in range(2, n + 2):
        batch = S.train_batches(np.random.default_rng(seed), 1, b=2, imgsz=256, nc=nc)[0]
        want = run(ref, batch, cfg)[1]
        for key, model in (("cpu_bf16", cpu16), ("card_bf16", gpu16)):
            for item, v in run(model, batch, cfg)[1].items():
                dist.setdefault(item, {}).setdefault(key, []).append(abs(v - want[item]))
    for e in dist.values():
        for key in list(e):
            e[key + "_median"] = float(np.median(e[key]))
    return dist


def main():
    if not torch.cuda.is_available():
        print("exp_bf16_loss_layers: needs one GPU", file=sys.stderr)
        return 2
    build.build()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_cfg()
    args = sys.argv[1:]
    n_seeds = int(args[args.index("--seeds") + 1]) if "--seeds" in args else 0
    names = [a for a in args if not a.startswith("--") and not a.isdigit()] or ["v12", "v13"]
    by_suffix = {suffix.lstrip("_"): model for model, suffix in S.SUFFIX.items()}
    for model_cfg in (by_suffix[n] for n in names):
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
        if n_seeds:
            S.emit({"model": model_cfg[0], "seeds": list(range(2, n_seeds + 2)),
                    "loss_distance_from_float64": seed_sweep(
                        (copy.deepcopy(cpu32).double(), cpu16, gpu16), cfg, model_cfg[1],
                        n_seeds)})
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
