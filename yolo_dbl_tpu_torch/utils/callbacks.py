"""Event callbacks and logger sinks (port of yolo_dbl_tpu/utils/callbacks.py).

The same hook names, `Callbacks.add/run/integrate`, and the same sinks: the
JSONL tracker always works; the tensorboard sink writes through tensorflow
and does nothing when tensorflow is missing; the other named integrations
do nothing when their package is missing, as in the JAX package.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, List

HOOKS = [
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "optimizer_step",
    "on_before_zero_grad",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_params_update",
    "teardown",
    "on_val_start",
    "on_val_batch_start",
    "on_val_batch_end",
    "on_val_end",
    "on_predict_start",
    "on_predict_batch_start",
    "on_predict_batch_end",
    "on_predict_postprocess_end",
    "on_predict_end",
    "on_export_start",
    "on_export_end",
]


def get_default_callbacks() -> Dict[str, List[Callable]]:
    return {h: [] for h in HOOKS}


class Callbacks:
    def __init__(self):
        self._hooks: Dict[str, List[Callable]] = get_default_callbacks()

    def add(self, hook: str, fn: Callable):
        if hook not in self._hooks:
            raise KeyError(f"unknown hook '{hook}'; valid: {HOOKS}")
        self._hooks[hook].append(fn)

    def run(self, hook: str, *args, **kwargs):
        for fn in self._hooks.get(hook, []):
            fn(*args, **kwargs)

    def integrate(self, name: str, **kwargs):
        """Attach a logger integration by name."""
        loader = _INTEGRATIONS.get(name)
        if loader is None:
            raise KeyError(f"unknown integration '{name}'; valid: {sorted(_INTEGRATIONS)}")
        loader(self, **kwargs)


class JSONLTracker:
    """Always-available metrics sink: one JSON line per event."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, payload: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps({"time": time.time(), **payload}, default=float) + "\n")


def _jsonl_integration(cb: Callbacks, path="runs/metrics.jsonl", **_):
    tracker = JSONLTracker(path)
    cb.add("on_fit_epoch_end", lambda metrics=None, **kw: tracker({"event": "epoch", **(metrics or {})}))
    cb.add("on_train_end", lambda metrics=None, **kw: tracker({"event": "train_end", **(metrics or {})}))


def _tensorboard_integration(cb: Callbacks, log_dir="runs/tb", **_):
    try:
        import tensorflow as tf
    except ImportError:
        return
    writer = tf.summary.create_file_writer(str(log_dir))
    step = {"n": 0}

    def log(metrics=None, **kw):
        if not metrics:
            return
        with writer.as_default():
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    tf.summary.scalar(k, v, step=step["n"])
        step["n"] += 1

    cb.add("on_fit_epoch_end", log)


def _noop_if_missing(module_name):
    def loader(cb: Callbacks, **kwargs):
        try:
            __import__(module_name)
        except ImportError:
            return  # the logger's package is not installed: nothing to attach

    return loader


_INTEGRATIONS = {
    "jsonl": _jsonl_integration,
    "tensorboard": _tensorboard_integration,
    # loggers of the torch ecosystem: each does nothing when its package is missing
    "wandb": _noop_if_missing("wandb"),
    "mlflow": _noop_if_missing("mlflow"),
    "comet": _noop_if_missing("comet_ml"),
    "clearml": _noop_if_missing("clearml"),
    "neptune": _noop_if_missing("neptune"),
    "dvc": _noop_if_missing("dvclive"),
}
