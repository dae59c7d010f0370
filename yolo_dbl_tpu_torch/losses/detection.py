"""YOLO detection loss: BCE classification + CIoU box + DFL (port of
yolo_dbl_tpu/losses/detection.py).

The same operations in the same order as the JAX package: padded GTs and
masks instead of boolean indexing, the assigner under no_grad on detached
inputs, gains box/cls/dfl = 7.5/0.5/1.5 and the total scaled by the batch.

Batch contract (the JAX package's, losses/detection.py:8-12):
    img:      (B, H, W, 3)
    gt_boxes: (B, M, 4) normalized xywh, zero-padded
    gt_cls:   (B, M) int
    gt_mask:  (B, M) 1.0 for real boxes
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch.nn import functional as F

from ..nn.heads import flatten_levels
from ..ops.anchors import bbox2dist, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou, xywh2xyxy
from .tal import task_aligned_assign


class LossItems(NamedTuple):
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _bce_with_logits(logits, targets):
    """Elementwise BCE with logits, the JAX package's formula (detection.py:34)."""
    return (torch.maximum(logits, torch.zeros((), dtype=logits.dtype, device=logits.device))
            - logits * targets + torch.log1p(torch.exp(-logits.abs())))


def _df_loss(pred_dist, target, reg_max=16):
    """Distribution-focal cross-entropy on the two integer bins beside each
    target (detection.py:39). pred_dist (..., 4, reg_max), target (..., 4)
    → (...,), the mean over the 4 sides. The targets are constants."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = torch.floor(target)
    wl = tl + 1.0 - target
    logp = F.log_softmax(pred_dist, dim=-1)
    right = torch.minimum(tl + 1.0, torch.full((), reg_max - 1.0, device=tl.device))
    ce_l = -logp.gather(-1, tl.long()[..., None])[..., 0]
    ce_r = -logp.gather(-1, right.long()[..., None])[..., 0]
    return (ce_l * wl + ce_r * (1.0 - wl)).mean(dim=-1)


def detection_loss(feats: Sequence[torch.Tensor], batch, strides: Tuple[int, ...], nc: int,
                   reg_max: int = 16, box_gain: float = 7.5, cls_gain: float = 0.5,
                   dfl_gain: float = 1.5, tal_topk: int = 10, mesh=None):
    """Total detection loss and its LossItems from raw per-level NHWC Detect
    maps (detection.py:63): targets scaled to input pixels, predictions
    decoded in grid units, TAL assignment on stride-scaled boxes.

    Under a `mesh` (parallel/mesh.py) `feats` and `batch` hold this rank's
    rows of the global batch: the normalizer `target_scores_sum` is summed
    over the ranks before its clamp, the total is scaled by the global batch,
    and the total and items are this rank's shares of JAX's global values
    (they sum to them over the ranks). The assigner works per image."""
    b = feats[0].shape[0]
    imgsz_h = feats[0].shape[1] * strides[0]
    imgsz_w = feats[0].shape[2] * strides[0]
    shapes = [f.shape[1:3] for f in feats]
    dev = feats[0].device
    anchor_points, stride_tensor = make_anchors(shapes, strides, device=dev)  # (A,2), (A,1)

    x = flatten_levels(feats).float()  # (B, A, 4*reg_max+nc)
    pred_distri, pred_scores = x[..., : 4 * reg_max], x[..., 4 * reg_max:]

    # decode pred boxes in grid units
    pd = pred_distri.reshape(b, -1, 4, reg_max)
    proj = torch.arange(reg_max, dtype=torch.float32, device=dev)
    dist = (torch.softmax(pd, dim=-1) * proj).sum(-1)  # (B, A, 4)
    pred_bboxes = dist2bbox(dist, anchor_points[None], xywh=False)  # xyxy, grid units

    # targets → input pixels, xyxy
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32, device=dev)
    gt_bboxes = xywh2xyxy(batch["gt_boxes"].float() * scale)  # (B, M, 4)
    gt_labels = batch["gt_cls"].long()
    mask_gt = batch["gt_mask"].float()

    with torch.no_grad():
        _, target_bboxes, target_scores, fg_mask, _ = task_aligned_assign(
            torch.sigmoid(pred_scores.detach()), pred_bboxes.detach() * stride_tensor[None],
            anchor_points * stride_tensor, gt_labels, gt_bboxes, mask_gt, topk=tal_topk,
            num_classes=nc)
    target_bboxes = target_bboxes / stride_tensor[None]
    fg = fg_mask.float()

    target_scores_sum = target_scores.sum()
    if mesh is not None:
        mesh.all_reduce(target_scores_sum)
    target_scores_sum = torch.clamp(target_scores_sum, min=1.0)

    # classification BCE over all anchors
    loss_cls = _bce_with_logits(pred_scores, target_scores).sum() / target_scores_sum

    # box CIoU on foreground, weighted by the soft target score
    weight = target_scores.sum(-1) * fg  # (B, A)
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)  # (B, A)
    loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum

    # DFL on foreground
    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max)
    target_ltrb = target_ltrb.clamp(0, reg_max - 1 - 0.01)
    dfl = _df_loss(pd, target_ltrb, reg_max)  # (B, A)
    loss_dfl = (dfl * weight).sum() / target_scores_sum

    items = LossItems(box=loss_box * box_gain, cls=loss_cls * cls_gain, dfl=loss_dfl * dfl_gain)
    total = (items.box + items.cls + items.dfl) * (b * (1 if mesh is None else mesh.world))
    return total, items
