"""Shared pieces of the port's tests: one torch thread for a test module,
JPEG frames for the predictor tests and chip_smoke.py's facade phases,
LDA-DBL's model dict for tests/test_torch_zoo_lda.py and chip_smoke.py, and
Swin-T-Giraffe's for tests/test_torch_zoo_structures.py and chip_smoke.py."""

from __future__ import annotations

import contextlib
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


def swin_giraffe(nc=3, embed=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window=7,
                 neck=(128, 256, 512), depth=1.0, hidden_ratio=0.75):
    """Swin-T-Giraffe's model dict: a Swin-T backbone (Liu et al. 2021,
    arXiv:2103.14030 §3.3: C = 96, depths 2-2-6-2, heads 3-6-12-24, window 7,
    patch 4) whose stride 8, 16 and 32 stages feed a GiraffeNeckV2 with
    DAMO-YOLO-S's neck settings (tinyvision/DAMO-YOLO
    configs/damoyolo_tinynasL25_S.py: out channels 128-256-512, depth 1.0,
    hidden ratio 0.75, silu), each level picked by an ExtractLayer row into a
    Detect head. The defaults are the published widths; the arguments narrow
    it for the CPU tests."""
    c = embed
    return {"nc": nc,
            "backbone": [[-1, 1, "PatchEmbed", [c, 4]],
                         [-1, 1, "SwinStage", [c, depths[0], heads[0], window]],
                         [-1, 1, "PatchMerging", [2 * c]],
                         [-1, 1, "SwinStage", [2 * c, depths[1], heads[1], window]],
                         [-1, 1, "PatchMerging", [4 * c]],
                         [-1, 1, "SwinStage", [4 * c, depths[2], heads[2], window]],
                         [-1, 1, "PatchMerging", [8 * c]],
                         [-1, 1, "SwinStage", [8 * c, depths[3], heads[3], window]]],
            "head": [[[3, 5, 7], 1, "GiraffeNeckV2", [list(neck), depth, hidden_ratio]],
                     [8, 1, "ExtractLayer", [0]],
                     [8, 1, "ExtractLayer", [1]],
                     [8, 1, "ExtractLayer", [2]],
                     [[9, 10, 11], 1, "Detect", ["nc"]]]}


@contextlib.contextmanager
def torch_threads(n=1):
    """`n` intra-op threads inside the block. The port's CPU runs in the
    tests are small (64-128 px): under the parallel test lane, 8 spinning
    OpenMP threads a worker stall thousands of tiny parallel regions on a
    saturated machine (a resume test took 597 s there against 5 s alone). A
    test whose bars a float32 sum order decides keeps the default threads
    and takes this only around its runs that no such bar reads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a whole test module (`torch_threads`).
    Import it into a test module to apply it there."""
    with torch_threads(1):
        yield
