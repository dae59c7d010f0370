"""Box and instance containers, numpy only (a copy of yolo_dbl_tpu/utils/instance.py).

`Bboxes` stores boxes in one of the formats xyxy, xywh and ltwh and
converts, scales, clips, flips and indexes them; `Instances` carries boxes
with their segments and keypoints through the same operations.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

_FORMATS = ("xyxy", "xywh", "ltwh")


def _convert(boxes: np.ndarray, src: str, dst: str) -> np.ndarray:
    if src == dst or len(boxes) == 0:
        return boxes.copy()
    b = boxes.astype(np.float64)
    if src == "xywh":
        cx, cy, w, h = b.T
        x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
    elif src == "ltwh":
        x1, y1, w, h = b.T
        x2, y2 = x1 + w, y1 + h
    else:
        x1, y1, x2, y2 = b.T
    if dst == "xyxy":
        out = np.stack([x1, y1, x2, y2], 1)
    elif dst == "xywh":
        out = np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1)
    else:
        out = np.stack([x1, y1, x2 - x1, y2 - y1], 1)
    return out.astype(boxes.dtype)


class Bboxes:
    """Format-aware box container (reference instance.py Bboxes)."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy"):
        assert format in _FORMATS, format
        bboxes = np.asarray(bboxes, dtype=np.float32).reshape(-1, 4)
        self.bboxes = bboxes
        self.format = format

    def convert(self, format: str):
        assert format in _FORMATS
        self.bboxes = _convert(self.bboxes, self.format, format)
        self.format = format
        return self

    def areas(self) -> np.ndarray:
        b = _convert(self.bboxes, self.format, "xyxy")
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def mul(self, scale):
        """Per-coordinate multiply (sx, sy, sx2, sy2) or scalar."""
        s = np.asarray(scale if hasattr(scale, "__len__") else [scale] * 4, np.float32)
        self.bboxes = self.bboxes * s
        return self

    def add(self, offset):
        o = np.asarray(offset if hasattr(offset, "__len__") else [offset] * 4, np.float32)
        self.bboxes = self.bboxes + o
        return self

    def __len__(self):
        return len(self.bboxes)

    def __getitem__(self, idx):
        return Bboxes(self.bboxes[idx], self.format)

    @classmethod
    def concatenate(cls, lst: List["Bboxes"], axis=0) -> "Bboxes":
        assert lst
        fmt = lst[0].format
        return cls(np.concatenate([b.convert(fmt).bboxes for b in lst], axis=axis), fmt)


class Instances:
    """Boxes + optional segments/keypoints moving together through augments
    (reference instance.py Instances)."""

    def __init__(self, bboxes, segments=None, keypoints=None, bbox_format="xyxy", normalized=False):
        self._bboxes = Bboxes(bboxes, bbox_format)
        self.segments = segments if segments is not None else np.zeros((len(self._bboxes), 0, 2), np.float32)
        self.keypoints = keypoints
        self.normalized = normalized

    @property
    def bboxes(self):
        return self._bboxes.bboxes

    @property
    def bbox_areas(self):
        return self._bboxes.areas()

    def convert_bbox(self, format):
        self._bboxes.convert(format)
        return self

    def scale(self, sx, sy, bbox_only=False):
        self._bboxes.mul((sx, sy, sx, sy))
        if not bbox_only:
            if self.segments.size:
                self.segments[..., 0] *= sx
                self.segments[..., 1] *= sy
            if self.keypoints is not None:
                self.keypoints[..., 0] *= sx
                self.keypoints[..., 1] *= sy
        return self

    def denormalize(self, w, h):
        if self.normalized:
            self.scale(w, h)
            self.normalized = False
        return self

    def normalize(self, w, h):
        if not self.normalized:
            self.scale(1 / w, 1 / h)
            self.normalized = True
        return self

    def add_padding(self, padw, padh):
        assert not self.normalized, "pad in pixel space"
        self._bboxes.add((padw, padh, padw, padh))
        if self.segments.size:
            self.segments[..., 0] += padw
            self.segments[..., 1] += padh
        return self

    def flipud(self, h):
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        b = self._bboxes.bboxes
        y1, y2 = b[:, 1].copy(), b[:, 3].copy()
        b[:, 1], b[:, 3] = h - y2, h - y1
        self.convert_bbox(fmt)
        return self

    def fliplr(self, w):
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        b = self._bboxes.bboxes
        x1, x2 = b[:, 0].copy(), b[:, 2].copy()
        b[:, 0], b[:, 2] = w - x2, w - x1
        self.convert_bbox(fmt)
        return self

    def clip(self, w, h):
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        b = self._bboxes.bboxes
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        self.convert_bbox(fmt)
        return self

    def remove_zero_area_boxes(self):
        good = self.bbox_areas > 0
        return good

    def __len__(self):
        return len(self._bboxes)

    def __getitem__(self, idx):
        return Instances(
            self.bboxes[idx],
            self.segments[idx] if self.segments.size else None,
            self.keypoints[idx] if self.keypoints is not None else None,
            self._bboxes.format,
            self.normalized,
        )
