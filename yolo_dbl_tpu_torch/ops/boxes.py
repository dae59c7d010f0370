"""Box format conversion and pairwise IoU (port of yolo_dbl_tpu/ops/boxes.py)."""

from __future__ import annotations

import torch


def xywh2xyxy(x):
    """(cx, cy, w, h) → (x1, y1, x2, y2) (boxes.py:14)."""
    cx, cy, w, h = x.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def box_iou(box1, box2, eps=1e-7):
    """Pairwise IoU of (..., N, 4) and (..., M, 4) xyxy boxes → (..., N, M)
    (boxes.py:43), same operations in the same order."""
    b1x1, b1y1 = box1[..., :, None, 0], box1[..., :, None, 1]
    b1x2, b1y2 = box1[..., :, None, 2], box1[..., :, None, 3]
    b2x1, b2y1 = box2[..., None, :, 0], box2[..., None, :, 1]
    b2x2, b2y2 = box2[..., None, :, 2], box2[..., None, :, 3]
    iw = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0.0)
    ih = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0.0)
    inter = iw * ih
    area1 = (b1x2 - b1x1) * (b1y2 - b1y1)
    area2 = (b2x2 - b2x1) * (b2y2 - b2y1)
    return inter / (area1 + area2 - inter + eps)
