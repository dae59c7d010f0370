"""Persistent user settings (port of yolo_dbl_tpu/utils/settings.py).

The port keeps its own file, `~/.config/yolo_dbl_tpu_torch/settings.json`,
with the JAX package's keys and defaults, so the two packages never share
one. The file is read or written only when the settings are first used.
"""

from __future__ import annotations

import json
from pathlib import Path


DEFAULT_SETTINGS = {
    "settings_version": "1.0.0",
    "datasets_dir": "datasets",
    "weights_dir": "weights",
    "runs_dir": "runs",
    "sync": False,
    "tensorboard": False,
    "wandb": False,
    "mlflow": False,
}


class SettingsManager(dict):
    """A settings dict kept in a JSON file."""

    def __init__(self, path: str = "~/.config/yolo_dbl_tpu_torch/settings.json"):
        super().__init__()
        self.path = Path(path).expanduser()
        self.update(DEFAULT_SETTINGS)
        if self.path.is_file():
            try:
                with open(self.path) as f:
                    self.update(json.load(f))
            except (json.JSONDecodeError, OSError):
                pass
        else:
            self.save()

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(dict(self), f, indent=2)

    def update(self, *args, **kwargs):
        super().update(*args, **kwargs)

    def reset(self):
        self.clear()
        self.update(DEFAULT_SETTINGS)
        self.save()


# Made on first use: importing the module touches no file.
class _LazySettings:
    _inst: SettingsManager | None = None

    def _get(self) -> SettingsManager:
        if _LazySettings._inst is None:
            _LazySettings._inst = SettingsManager()
        return _LazySettings._inst

    def __getitem__(self, k):
        return self._get()[k]

    def __setitem__(self, k, v):
        s = self._get()
        s[k] = v
        s.save()

    def __iter__(self):
        return iter(self._get())

    def __len__(self):
        return len(self._get())

    def keys(self):
        return self._get().keys()

    def items(self):
        return self._get().items()

    def __repr__(self):
        return repr(dict(self._get()))


SETTINGS = _LazySettings()
