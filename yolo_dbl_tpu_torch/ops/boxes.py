"""Box format conversion and IoU families (port of yolo_dbl_tpu/ops/boxes.py).

Where the JAX package takes jnp.maximum/jnp.minimum/jnp.clip on a path that
is differentiated, this takes torch.maximum/torch.minimum: both split the
gradient of a tie 0.5/0.5, where torch.clamp passes all of it.
"""

from __future__ import annotations

import math

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


def bbox_iou(box1, box2, xywh=True, GIoU=False, DIoU=False, CIoU=False, eps=1e-7):
    """Elementwise IoU/GIoU/DIoU/CIoU of broadcastable (..., 4) boxes → (...,)
    (boxes.py:66), same operations in the same order; CIoU's alpha is
    detached, as the JAX package's stop_gradient (boxes.py:101)."""
    if xywh:
        x1, y1, w1, h1 = box1.split(1, dim=-1)
        x2, y2, w2, h2 = box2.split(1, dim=-1)
        w1_, h1_, w2_, h2_ = w1 / 2, h1 / 2, w2 / 2, h2 / 2
        b1x1, b1x2, b1y1, b1y2 = x1 - w1_, x1 + w1_, y1 - h1_, y1 + h1_
        b2x1, b2x2, b2y1, b2y2 = x2 - w2_, x2 + w2_, y2 - h2_, y2 + h2_
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.split(1, dim=-1)
        b2x1, b2y1, b2x2, b2y2 = box2.split(1, dim=-1)
        w1, h1 = b1x2 - b1x1, (b1y2 - b1y1) + eps
        w2, h2 = b2x2 - b2x1, (b2y2 - b2y1) + eps

    zero = torch.zeros((), dtype=b1x1.dtype, device=b1x1.device)
    inter = (torch.maximum(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1), zero)
             * torch.maximum(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1), zero))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if CIoU or DIoU or GIoU:
        cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # convex width
        ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # convex height
        if CIoU or DIoU:
            c2 = cw**2 + ch**2 + eps
            rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
            if CIoU:
                v = (4 / math.pi**2) * (torch.arctan(w2 / h2) - torch.arctan(w1 / h1)) ** 2
                alpha = (v / (v - iou + (1 + eps))).detach()
                out = iou - (rho2 / c2 + v * alpha)
            else:
                out = iou - rho2 / c2
        else:
            c_area = cw * ch + eps
            out = iou - (c_area - union) / c_area
    else:
        out = iou
    return out.squeeze(-1)


def xywhr2xyxyxyxy(rboxes):
    """Rotated (cx, cy, w, h, angle) boxes → their 4 corners (boxes.py:146):
    (..., 5) → (..., 4, 2), in the order ctr ± the half-width and
    half-height vectors (+ +, + -, - -, - +)."""
    ctr = rboxes[..., :2]
    w, h, angle = rboxes[..., 2:3], rboxes[..., 3:4], rboxes[..., 4:5]
    cos, sin = torch.cos(angle), torch.sin(angle)
    vec1 = torch.cat([w / 2 * cos, w / 2 * sin], dim=-1)
    vec2 = torch.cat([-h / 2 * sin, h / 2 * cos], dim=-1)
    return torch.stack([ctr + vec1 + vec2, ctr + vec1 - vec2, ctr - vec1 - vec2,
                        ctr - vec1 + vec2], dim=-2)
