"""Rect batching and bucketed multi-scale sizes on the host (port of
yolo_dbl_tpu/data/rect.py).

`multi_scale_sizes` is a fixed ladder of stride-aligned sizes in [lo, hi] x
imgsz that the facade samples one size of per batch (`multi_scale=True`);
`resize_batch` resizes a batch to it with cv2. `rect_group_indices` groups
images into batches by aspect ratio, each with a shape from a small set of
stride-aligned buckets.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def multi_scale_sizes(imgsz: int, stride: int = 32, lo: float = 0.5, hi: float = 1.5,
                      n_buckets: int = 5) -> List[int]:
    """Stride-aligned size ladder covering [lo, hi]·imgsz."""
    sizes = np.linspace(lo * imgsz, hi * imgsz, n_buckets)
    return sorted({int(round(s / stride) * stride) for s in sizes})


def sample_scale(sizes: Sequence[int], rng: np.random.Generator) -> int:
    return int(sizes[rng.integers(0, len(sizes))])


def resize_batch(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear-resize an NHWC float batch to (size, size) on the host."""
    import cv2

    if img.shape[1] == size:
        return img
    out = np.empty((img.shape[0], size, size, img.shape[3]), img.dtype)
    for i in range(img.shape[0]):
        out[i] = cv2.resize(img[i], (size, size), interpolation=cv2.INTER_LINEAR)
    return out


def rect_shapes(aspect_ratios: Sequence[float], imgsz: int, stride: int = 32,
                n_buckets: int = 4) -> List[Tuple[int, int]]:
    """Quantized (h, w) bucket shapes for a set of image aspect ratios."""
    shapes = set()
    qs = np.quantile(np.asarray(aspect_ratios), np.linspace(0, 1, n_buckets)) if len(aspect_ratios) else [1.0]
    for ar in qs:  # ar = h / w
        if ar < 1:
            h, w = imgsz * ar, imgsz
        else:
            h, w = imgsz, imgsz / ar
        shapes.add((int(np.ceil(h / stride) * stride), int(np.ceil(w / stride) * stride)))
    return sorted(shapes)


def assign_rect_bucket(ar: float, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Pick the bucket whose aspect best matches ar = h/w."""
    best = min(buckets, key=lambda hw: abs(hw[0] / hw[1] - ar))
    return best


def rect_group_indices(aspect_ratios: Sequence[float], imgsz: int, batch_size: int,
                       stride: int = 32, n_buckets: int = 4):
    """Group dataset indices into rect batches: [(indices, (h, w))]."""
    buckets = rect_shapes(aspect_ratios, imgsz, stride, n_buckets)
    groups = {b: [] for b in buckets}
    for i, ar in enumerate(aspect_ratios):
        groups[assign_rect_bucket(ar, buckets)].append(i)
    batches = []
    for shape, idxs in groups.items():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s : s + batch_size]
            if chunk:
                batches.append((chunk, shape))
    return batches
