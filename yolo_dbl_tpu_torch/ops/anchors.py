"""Anchor-free grid anchors and the distance ↔ box codecs (port of yolo_dbl_tpu/ops/anchors.py)."""

from __future__ import annotations

import torch


def make_anchors(feat_shapes, strides, dtype=torch.float32, device=None):
    """Anchor cell centres for per-level (h, w) shapes (anchors.py:13).

    Returns anchor_points (A, 2) xy in grid units and stride_tensor (A, 1).
    """
    anchor_points, stride_tensor = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + 0.5
        sy = torch.arange(h, dtype=dtype, device=device) + 0.5
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_tensor.append(torch.full((h * w, 1), s, dtype=dtype, device=device))
    return torch.cat(anchor_points), torch.cat(stride_tensor)


def dist2bbox(distance, anchor_points, xywh=True):
    """Decode (l, t, r, b) distances from anchor points into xywh (or xyxy)
    boxes (anchors.py:35)."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(anchor_points, bbox, reg_max):
    """Encode xyxy boxes as (l, t, r, b) distances clipped to [0, reg_max -
    0.01] for the DFL targets (anchors.py:47)."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return torch.minimum(torch.maximum(dist, torch.zeros((), dtype=dist.dtype, device=dist.device)),
                         torch.full((), reg_max - 0.01, dtype=dist.dtype, device=dist.device))


def dist2rbox(pred_dist, pred_angle, anchor_points):
    """DFL distances (..., 4) and an angle (..., 1) → rotated xywh boxes
    (anchors.py:54): the ltrb centre offset turned by the angle, added to
    the anchor; w, h = l + r, t + b."""
    lt, rb = pred_dist[..., :2], pred_dist[..., 2:]
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf = (rb[..., :1] - lt[..., :1]) / 2
    yf = (rb[..., 1:] - lt[..., 1:]) / 2
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)
