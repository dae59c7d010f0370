"""Training and deploy checkpoints (port of yolo_dbl_tpu/utils/checkpoint.py).

The port's `.ckpt` is its own format: one `torch.save` blob with the JAX
package's keys. A training checkpoint (`last.ckpt`, `epoch{N}.ckpt`) holds
`step`, `ema_updates`, `best_fitness`, `epoch`, `best_epoch`, `params`,
`ema_params`, `batch_stats`, `opt_state`, `train_args`, `metrics` and
`version`; a deploy checkpoint (`best.ckpt`) holds `variables` (the EMA
parameters and the BatchNorm statistics), `model_yaml`, `nc` and `version`.
The values are tensors by parameter or buffer name, numbers, strings,
lists and dicts, so every file loads with `torch.load(..., weights_only=True)`.
A model trained by the JAX package comes across through utils/convert.py;
flax checkpoints are not read here.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

VERSION = 1


def _plain(x):
    """`x` with its tensors on the CPU and numpy values as Python numbers and
    lists: the types `torch.load(weights_only=True)` reads."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, Path):
        return str(x)
    return x


def _save(path, blob: Dict):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_plain(blob), path)


def _load(path) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(path, state: Dict, best_fitness: float = 0.0, train_args: Optional[Dict] = None,
                    metrics: Optional[Dict] = None, epoch: int = -1, best_epoch: int = -1):
    """Write the full training state (`Trainer.state_dict()`), resume-capable."""
    _save(path, {
        "step": int(state["step"]),
        "ema_updates": float(state["ema_updates"]),
        "best_fitness": float(best_fitness),
        "epoch": int(epoch),
        "best_epoch": int(best_epoch),
        "params": state["params"],
        "ema_params": state["ema_params"],
        "batch_stats": state["batch_stats"],
        "opt_state": state["opt_state"],
        "train_args": train_args or {},
        "metrics": metrics or {},
        "version": VERSION,
    })


def _meta(blob: Dict) -> Dict:
    return {"best_fitness": blob["best_fitness"], "train_args": blob.get("train_args") or {},
            "metrics": blob.get("metrics") or {}, "epoch": blob.get("epoch", -1),
            "best_epoch": blob.get("best_epoch", -1)}


def peek_checkpoint_meta(path) -> Dict:
    """{best_fitness, train_args, metrics, epoch, best_epoch} of a training
    checkpoint, read before any model or loader is built (the train args of
    a resumed run are merged first)."""
    return _meta(_load(path))


def load_checkpoint(path) -> Tuple[Dict, Dict]:
    """(state for `Trainer.load_state_dict`, meta) of a training checkpoint;
    the tensors are on the CPU."""
    blob = _load(path)
    state = {k: blob[k] for k in ("step", "ema_updates", "params", "ema_params", "batch_stats",
                                  "opt_state")}
    return state, _meta(blob)


def save_deploy(path, variables: Dict[str, Dict[str, torch.Tensor]],
                model_yaml: Optional[Dict] = None, nc: Optional[int] = None):
    """Deploy checkpoint: inference weights only, `variables` =
    {"params": {name: tensor}, "batch_stats": {name: tensor}}."""
    _save(path, {"variables": variables, "model_yaml": model_yaml or {}, "nc": nc,
                 "version": VERSION})


def load_deploy(path) -> Tuple[Dict, Dict]:
    """(variables, blob) of a deploy checkpoint."""
    blob = _load(path)
    return blob["variables"], blob
