"""JPEG frames for the port's predictor tests and chip_smoke.py's facade phase."""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

# fill colours of the shapes set's classes (tests/fixtures.py), RGB
COLOURS = ((230, 200, 60), (60, 220, 220), (10, 10, 120))


def write_jpeg_frames(directory, sizes, n, seed=0):
    """`n` seeded JPEG frames cycling through the (h, w) `sizes`, each a
    noise background with 1-3 filled rectangles of the shapes set's colours.
    Returns their paths, in name order."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img = rng.integers(30, 70, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            bh, bw = int(rng.integers(h // 10, h // 3)), int(rng.integers(w // 10, w // 3))
            y, x = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            img[y:y + bh, x:x + bw] = COLOURS[int(rng.integers(0, 3))]
        paths.append(directory / f"frame{i:02d}.jpg")
        cv2.imwrite(str(paths[-1]), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return paths
