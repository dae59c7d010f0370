"""Command line: `python -m yolo_dbl_tpu_torch [task] <mode> key=value ...`
(port of yolo_dbl_tpu/cli.py; console script `yolo-dbl-torch`).

Modes: train, val, predict, tune, checks (torch and its CUDA devices) and
settings. track, export, benchmark and solutions are not ported yet and exit
non-zero. `device=cpu` runs on the CPU; without it the model runs on the card.
"""

from __future__ import annotations

import ast
import sys
from typing import Dict, List

NOT_PORTED = {
    "track": "ROADMAP Queue 1 item 6 (trackers)",
    "export": "ROADMAP Queue 1 item 6 (exporter)",
    "benchmark": "ROADMAP Queue 1 item 1 (the port's benchmark)",
    "solutions": "ROADMAP Queue 1 item 6 (solutions)",
}


def parse_kv(args: List[str]) -> Dict:
    out = {}
    for a in args:
        if "=" not in a:
            raise SystemExit(f"expected key=value, got '{a}'")
        k, v = a.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


HELP = """yolo_dbl_tpu_torch CLI: the PyTorch/CUDA port of yolo_dbl_tpu

usage: python -m yolo_dbl_tpu_torch [task] [mode] [key=value ...]

tasks: detect (the default and, for now, the only one)
modes: train, val, predict, tune; not ported yet: track, export, benchmark

examples:
  python -m yolo_dbl_tpu_torch detect train data=path/to/dataset model=yolov13s_DBL.yaml epochs=100
  python -m yolo_dbl_tpu_torch detect val model=runs/train/best.ckpt data=path/to/dataset
  python -m yolo_dbl_tpu_torch detect predict model=best.ckpt source=images/
  python -m yolo_dbl_tpu_torch detect predict model=best.ckpt source=images/ device=cpu
  python -m yolo_dbl_tpu_torch detect tune model=yolov8n.yaml data=path/to/dataset iterations=10
  python -m yolo_dbl_tpu_torch checks
  python -m yolo_dbl_tpu_torch settings [key=value ...]
"""


def entrypoint(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "--help", "-h"):
        print(HELP)
        return
    if argv[0] == "checks":
        import torch

        from . import __version__

        print("torch:", torch.__version__, "cuda:", torch.version.cuda)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print("cuda devices:", [torch.cuda.get_device_name(i) for i in range(n)])
        print("yolo_dbl_tpu_torch:", __version__)
        return
    if argv[0] == "settings":
        from .utils.settings import SETTINGS

        for k, v in parse_kv(argv[1:]).items():
            SETTINGS[k] = v
        for k, v in dict(SETTINGS).items():
            print(f"{k}={v}")
        return

    task = "detect"
    if argv[0] in ("detect", "segment", "pose", "obb", "classify"):
        task = argv.pop(0)
    if not argv:
        raise SystemExit("missing mode; " + HELP)
    mode = argv.pop(0)
    if task != "detect":
        raise SystemExit(f"task '{task}' is not ported yet: ROADMAP Queue 1 item 6 (other heads)")
    if mode in NOT_PORTED:
        raise SystemExit(f"mode '{mode}' is not ported yet: {NOT_PORTED[mode]}")
    kv = parse_kv(argv)

    from .engine.model import YOLO

    y = YOLO(kv.pop("model", "yolov13s_DBL.yaml"), nc=kv.pop("nc", None),
             device=kv.pop("device", None))
    if mode == "train":
        out = y.train(kv.pop("data"), **kv)
        print(f"best fitness: {out['best_fitness']:.4f}  run dir: {out['run_dir']}")
    elif mode == "val":
        stats = y.val(kv.pop("data"), **kv)
        keys = ("mAP50", "mAP50-95", "precision", "recall")
        print({k: round(stats[k], 4) for k in keys if k in stats})
        if "coco_stats" in stats:
            print({k: round(v, 4) for k, v in stats["coco_stats"].items()})
    elif mode == "predict":
        for r in y.predict(kv.pop("source"), **kv):
            print(r.path, len(r), "detections")
            for d in r.to_json_dicts():
                print("  ", d)
    elif mode == "tune":
        data = kv.pop("data")
        out = y.tune(data, iterations=kv.pop("iterations", 10), **kv)
        print("best fitness:", round(out["best_fitness"], 4))
        print("best hyp:", out["best_hyp"])
    else:
        raise SystemExit(f"unknown mode '{mode}'; " + HELP)


if __name__ == "__main__":
    entrypoint()
