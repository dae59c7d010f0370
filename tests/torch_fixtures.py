"""Shared pieces of the port's tests: one torch thread for a test module,
JPEG frames for the predictor tests and chip_smoke.py's facade phases, and
LDA-DBL's model dict for tests/test_torch_zoo_lda.py and chip_smoke.py."""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

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


def lda_dbl(scale="s"):
    """YOLO-DBL at `scale` with its three `DySample, []` rows written as
    `LDA_AQU, []`: the model dict, from the port's copy of yolov13_DBL.yaml."""
    from yolo_dbl_tpu_torch.nn.tasks import yaml_model_load

    d = yaml_model_load(f"yolov13{scale}_DBL.yaml")
    for part in ("backbone", "head"):
        d[part] = [[f, n, "LDA_AQU" if m == "DySample" else m, args] for f, n, m, args in d[part]]
    return d


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU runs in the tests are small (64-128 px): one intra-op
    thread. Under the parallel test lane, 8 spinning OpenMP threads a worker
    stall thousands of tiny parallel regions on a saturated machine (a resume
    test took 597 s there against 5 s alone). Import it into a test module
    to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
