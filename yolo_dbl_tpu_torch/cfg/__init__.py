"""Config (port of yolo_dbl_tpu/cfg/__init__.py).

`default.yaml` here is a byte copy of the JAX package's, read with the
port's small YAML reader: the same keys with the same defaults. `get_cfg`
merges overrides, rejects unknown keys and checks types as the JAX
`get_cfg`/`check_cfg` do (cfg/__init__.py:101, :48).
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

CFG_DIR = Path(__file__).resolve().parent
DEFAULT_CFG_PATH = CFG_DIR / "default.yaml"

_FLOAT_KEYS = {
    "lr0", "lrf", "momentum", "weight_decay", "warmup_epochs", "warmup_momentum",
    "warmup_bias_lr", "box", "cls", "dfl", "pose", "kobj", "label_smoothing",
    "hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
    "perspective", "flipud", "fliplr", "bgr", "mosaic", "mixup", "copy_paste",
    "erasing", "crop_fraction", "fraction", "conf", "iou",
}
_INT_KEYS = {"epochs", "patience", "workers", "seed", "close_mosaic", "max_det", "nbs",
             "save_period", "vid_stride"}
_BOOL_KEYS = {
    "save", "exist_ok", "pretrained", "verbose", "deterministic", "single_cls",
    "rect", "cos_lr", "resume", "amp", "profile", "multi_scale", "val", "save_json",
    "half", "plots", "augment", "grad_accumulate", "agnostic_nms", "dynamic", "simplify", "nms",
    "overlap_mask",
}


def load_default_cfg() -> Dict:
    from ..utils.yaml_subset import load_yaml

    return load_yaml(DEFAULT_CFG_PATH.read_text())


def check_cfg(cfg: Dict) -> Dict:
    """Cast float and int keys, and require bools where a bool is meant."""
    out = {}
    for k, v in cfg.items():
        if v is None:
            out[k] = v
        elif k in _FLOAT_KEYS:
            out[k] = float(v)
        elif k in _INT_KEYS:
            out[k] = int(v)
        elif k in _BOOL_KEYS:
            if not isinstance(v, bool):
                raise TypeError(f"cfg key '{k}' expects bool, got {type(v).__name__}={v!r}")
            out[k] = v
        elif k == "cache":
            if not (isinstance(v, bool) or v in ("ram", "disk")):
                raise TypeError(f"cfg key 'cache' expects bool or 'ram'/'disk', got {v!r}")
            out[k] = v
        else:
            out[k] = v
    return out


def get_cfg(cfg: Optional[Dict] = None, overrides: Optional[Dict] = None) -> SimpleNamespace:
    """The defaults, updated by `cfg` and then by `overrides`, as a namespace.
    An override whose key is not in default.yaml raises KeyError."""
    merged = load_default_cfg()
    if cfg:
        merged.update(dict(cfg))
    if overrides:
        unknown = set(overrides) - set(merged)
        if unknown:
            raise KeyError(f"unknown cfg keys: {sorted(unknown)}; valid keys come from default.yaml")
        merged.update(overrides)
    return SimpleNamespace(**check_cfg(merged))
