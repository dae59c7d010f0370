"""Mutation-based hyperparameter evolution (port of yolo_dbl_tpu/engine/tuner.py).

Each iteration mutates the best hyperparameters so far with per-key gaussian
gains inside a search space, trains through `train_fn`, and logs the fitness
to `tune_results.csv`.
"""

from __future__ import annotations

import csv
import random
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

# (min, max, gain) of each hyperparameter's mutation
DEFAULT_SPACE = {
    "lr0": (1e-5, 1e-1, 1.0),
    "lrf": (0.0001, 0.1, 1.0),
    "momentum": (0.7, 0.98, 0.3),
    "weight_decay": (0.0, 0.001, 1.0),
    "warmup_epochs": (0.0, 5.0, 1.0),
    "box": (1.0, 20.0, 1.0),
    "cls": (0.2, 4.0, 1.0),
    "dfl": (0.4, 6.0, 1.0),
    "hsv_h": (0.0, 0.1, 1.0),
    "hsv_s": (0.0, 0.9, 1.0),
    "hsv_v": (0.0, 0.9, 1.0),
    "degrees": (0.0, 45.0, 1.0),
    "translate": (0.0, 0.9, 1.0),
    "scale": (0.0, 0.95, 1.0),
    "shear": (0.0, 10.0, 1.0),
    "fliplr": (0.0, 1.0, 1.0),
    "mosaic": (0.0, 1.0, 1.0),
    "mixup": (0.0, 1.0, 1.0),
    "copy_paste": (0.0, 1.0, 1.0),
}


class Tuner:
    def __init__(self, train_fn: Callable[[Dict], float], space: Optional[Dict] = None,
                 save_dir: str = "runs/tune", seed: int = 0):
        """train_fn(hyp_dict) -> fitness (higher better)."""
        self.train_fn = train_fn
        self.space = space or dict(DEFAULT_SPACE)
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.rng = random.Random(seed)
        self.results: list = []

    def _mutate(self, base: Dict, mutation: float = 0.8, sigma: float = 0.2) -> Dict:
        """Gaussian mutation with per-key gains, clipped to the space."""
        hyp = dict(base)
        while True:
            changed = False
            for k, (lo, hi, gain) in self.space.items():
                if self.rng.random() < mutation:
                    factor = 1.0 + self.rng.gauss(0, sigma) * gain
                    hyp[k] = min(max(base.get(k, (lo + hi) / 2) * factor, lo), hi)
                    changed = changed or hyp[k] != base.get(k)
            if changed or not self.results:
                return hyp

    def __call__(self, iterations: int = 10, initial: Optional[Dict] = None) -> Tuple[Dict, float]:
        best_hyp = dict(initial or {k: (lo + hi) / 2 for k, (lo, hi, _) in self.space.items()})
        best_fit = -float("inf")
        csv_path = self.save_dir / "tune_results.csv"
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["iteration", "fitness", *self.space.keys()])
            for i in range(iterations):
                hyp = self._mutate(best_hyp) if i else dict(best_hyp)
                fitness = float(self.train_fn(hyp))
                self.results.append((fitness, hyp))
                writer.writerow([i, fitness, *[hyp[k] for k in self.space]])
                f.flush()
                if fitness > best_fit:
                    best_fit, best_hyp = fitness, hyp
        return best_hyp, best_fit
