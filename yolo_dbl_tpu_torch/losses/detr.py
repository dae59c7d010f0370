"""RT-DETR's set-prediction loss: Hungarian matching, varifocal, L1 and GIoU
(port of yolo_dbl_tpu/losses/detr.py).

The GTs are padded to M with a mask, as in the detection loss's batch
contract (gt_boxes (B, M, 4) normalized xywh, gt_cls (B, M), gt_mask (B, M)).
The matching costs of every decoder layer and image are formed on the
device; the (L+1)·B cost matrices and the GT counts go to the host in one
copy, scipy's `linear_sum_assignment` solves each there (`_lsa_host`, as
JAX's host callback), and the matched query indices come back as one
tensor. Everything else, the costs, the varifocal loss, L1 and GIoU, runs
on the device. JAX models no denoising queries, and neither does the port.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ..ops.boxes import bbox_iou
from .detection import _bce_with_logits

COST_GAIN = {"class": 2.0, "bbox": 5.0, "giou": 2.0}
LOSS_GAIN = {"class": 1.0, "bbox": 5.0, "giou": 2.0}


class DETRItems(NamedTuple):
    """The final decoder layer's loss items (detr.py:157): GIoU, class, L1."""

    giou: torch.Tensor
    cls: torch.Tensor
    l1: torch.Tensor


def _lsa_host(cost: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """cost (N, Q, M) float32, counts (N,) → (N, M) int64: each real GT's
    query (detr.py:31); padded columns 0. Non-finite costs count as 0."""
    from scipy.optimize import linear_sum_assignment

    n, _, m = cost.shape
    out = np.zeros((n, m), np.int64)
    for i in range(n):
        k = int(counts[i])
        if k:
            c = np.nan_to_num(cost[i, :, :k], nan=0.0, posinf=0.0, neginf=0.0)
            rows, cols = linear_sum_assignment(c)
            out[i, cols] = rows
    return out


def assign(cost, counts):
    """The host solve of (N, Q, M) costs with (N,) GT counts: one copy to the
    host (the costs in float32, as JAX hands them to its callback), scipy,
    and the (N, M) query indices back on the costs' device in one copy."""
    n, q, m = cost.shape
    host = torch.cat([cost.float().reshape(-1), counts.float()]).cpu().numpy()
    idx = _lsa_host(host[:-n].reshape(n, q, m), host[-n:])
    return torch.from_numpy(idx).to(cost.device)


@torch.no_grad()
def hungarian_match(pred_boxes, pred_scores, gt_boxes, gt_cls, gt_mask, alpha=0.25, gamma=2.0):
    """(N, M) matched query index of each GT row (padded rows 0), from the
    focal class cost at the GT's class, the L1 and the GIoU cost
    (detr.py:52) of detached predictions: pred_boxes (N, Q, 4) normalized
    xywh, pred_scores (N, Q, nc) logits."""
    ps = torch.sigmoid(pred_scores)
    nc = ps.shape[-1]
    labels = gt_cls.clamp(0, nc - 1).long()
    p = torch.gather(ps, 2, labels[:, None, :].expand(-1, ps.shape[1], -1))  # (N, Q, M)
    neg = (1 - alpha) * (p ** gamma) * (-torch.log(1 - p + 1e-8))
    pos = alpha * ((1 - p) ** gamma) * (-torch.log(p + 1e-8))
    cost_class = pos - neg
    cost_bbox = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou = bbox_iou(pred_boxes[:, :, None, :], gt_boxes[:, None, :, :], xywh=True, GIoU=True)
    cost = (COST_GAIN["class"] * cost_class + COST_GAIN["bbox"] * cost_bbox
            + COST_GAIN["giou"] * (1.0 - giou))
    return assign(cost, gt_mask.sum(-1))


def _layer_loss(pred_boxes, pred_scores, gt_boxes, gt_cls, gt_mask, q_idx, num_gts,
                alpha=0.75, gamma=2.0) -> Dict[str, torch.Tensor]:
    """Varifocal class, L1 and GIoU losses of one decoder layer under its
    matching (detr.py:103)."""
    b, q, nc = pred_scores.shape
    oh_q = F.one_hot(q_idx, q).to(gt_mask.dtype) * gt_mask[..., None]  # (B, M, Q)
    oh_c = F.one_hot(gt_cls.clamp(0, nc - 1).long(), nc).to(gt_mask.dtype)  # (B, M, nc)
    one_hot = torch.einsum("bmq,bmc->bqc", oh_q, oh_c)
    matched = torch.gather(pred_boxes, 1, q_idx[..., None].expand(-1, -1, 4))  # (B, M, 4)
    iou = bbox_iou(matched.detach(), gt_boxes, xywh=True).clamp(min=0.0)
    gt_scores = torch.einsum("bmq,bm->bq", oh_q, iou * gt_mask)[..., None] * one_hot
    p = torch.sigmoid(pred_scores)
    weight = alpha * p ** gamma * (1 - one_hot) + gt_scores * one_hot
    bce = _bce_with_logits(pred_scores, gt_scores)
    norm = torch.clamp(num_gts, min=1.0)
    loss_cls = (bce * weight).sum() * q / norm
    l1 = ((matched - gt_boxes).abs().sum(-1) * gt_mask).sum() / norm
    giou = bbox_iou(matched, gt_boxes, xywh=True, GIoU=True)
    loss_giou = ((1.0 - giou) * gt_mask).sum() / norm
    return {"class": LOSS_GAIN["class"] * loss_cls, "bbox": LOSS_GAIN["bbox"] * l1,
            "giou": LOSS_GAIN["giou"] * loss_giou}


def rtdetr_loss(outputs: Tuple, batch: Dict, nc: int) -> Tuple[torch.Tensor, DETRItems]:
    """(total, DETRItems) of RTDETRDecoder's training outputs (detr.py:125):
    the encoder's selected proposals as layer 0, then each decoder layer,
    each matched on its own; the total sums every layer, the items are the
    final layer's."""
    dec_bboxes, dec_scores, enc_bboxes, enc_scores = outputs
    layers_b = torch.cat([enc_bboxes[:, None], dec_bboxes], 1)  # (B, L+1, Q, 4)
    layers_s = torch.cat([enc_scores[:, None], dec_scores], 1)
    # float32 targets, as JAX's; float64 beside a float64 reference's outputs
    ft = torch.promote_types(layers_b.dtype, torch.float32)
    gt_boxes = batch["gt_boxes"].to(ft)
    gt_cls = batch["gt_cls"].long()
    gt_mask = batch["gt_mask"].to(ft)
    b, n_layers, q, _ = layers_b.shape
    m = gt_boxes.shape[1]
    num_gts = gt_mask.sum()

    def rep(t):
        return t[:, None].expand(b, n_layers, *t.shape[1:]).reshape(b * n_layers, *t.shape[1:])

    q_idx = hungarian_match(layers_b.detach().reshape(b * n_layers, q, 4),
                            layers_s.detach().reshape(b * n_layers, q, -1),
                            rep(gt_boxes), rep(gt_cls), rep(gt_mask)).reshape(b, n_layers, m)
    total, items = 0.0, None
    for i in range(n_layers):
        items = _layer_loss(layers_b[:, i], layers_s[:, i], gt_boxes, gt_cls, gt_mask,
                            q_idx[:, i], num_gts)
        total = total + items["class"] + items["bbox"] + items["giou"]
    return total, DETRItems(giou=items["giou"], cls=items["class"], l1=items["bbox"])
