"""Task-Aligned Assigner (port of yolo_dbl_tpu/losses/tal.py).

Fixed-shape and masked, as in the JAX package: ground truths come in as
(B, M, ...) with a validity mask, anchors as (A, 2), and every intermediate
is a dense (B, M, A) tensor. The callers run it under no_grad.

Only the exact top-k form (tal.py:124-130) is ported: the threshold form
and `_kth_largest` (:22) avoid a sort that is slow on the TPU. The k
largest metrics per GT are taken with a stable descending sort, so ties
(many in-GT anchors have metric exactly 0 at random init) go to the lower
anchor index, as `lax.top_k` gives them; `torch.topk` promises no order
among ties on CUDA.

The rotated assigner (tal.py:165-250) is the same with probiou overlaps
and the rotated containment test. JAX runs it only in the threshold form
(the k-th largest distinct metric, and metrics > eps); here the same
stable sort takes the k largest, of which those > eps count. The two keep
the same anchors unless two positive metrics of one GT tie, where JAX keeps
every tied anchor.
"""

from __future__ import annotations

import torch

from ..ops.boxes import bbox_iou, xywhr2xyxyxyxy


def select_candidates_in_gts(anc_points, gt_bboxes, eps=1e-9):
    """(B, M, A) float mask of the anchors (A, 2) whose centre lies strictly
    inside each xyxy GT box (B, M, 4) (tal.py:43)."""
    lt = anc_points[None, None] - gt_bboxes[..., None, :2]  # (B, M, A, 2)
    rb = gt_bboxes[..., None, 2:] - anc_points[None, None]
    deltas = torch.cat([lt, rb], dim=-1)
    return (deltas.amin(dim=-1) > eps).float()


def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                        topk=10, num_classes=80, alpha=0.5, beta=6.0, eps=1e-9):
    """Assign GTs to anchors by the task-aligned metric score^α · CIoU^β (tal.py:59).

    pd_scores (B, A, nc) sigmoided, pd_bboxes (B, A, 4) xyxy, anc_points
    (A, 2), gt_labels (B, M) int, gt_bboxes (B, M, 4) xyxy zero-padded,
    mask_gt (B, M). Returns target_labels (B, A), target_bboxes (B, A, 4),
    target_scores (B, A, nc), fg_mask (B, A) bool, target_gt_idx (B, A).
    """
    b, a, nc = pd_scores.shape
    m = gt_bboxes.shape[1]
    mask_gt = mask_gt.float()

    # positive candidate mask
    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)  # (B, M, A)
    valid = mask_in_gts * mask_gt[..., None]

    # per-(gt, anchor) class score: pd_scores[b, a, gt_label[b, m]]
    ps = pd_scores.transpose(1, 2)  # (B, nc, A)
    labels = gt_labels.clamp(0, nc - 1).long()
    bbox_scores = torch.gather(ps, 1, labels[..., None].expand(b, m, a)) * valid  # (B, M, A)

    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, CIoU=True)
    overlaps = overlaps.clamp(min=0.0) * valid

    align_metric = bbox_scores**alpha * overlaps**beta

    # exact top-k per GT, ties toward the lower anchor index
    k = min(topk, a)
    topk_idxs = torch.sort(align_metric, dim=-1, descending=True, stable=True).indices[..., :k]
    mask_topk = torch.zeros_like(align_metric).scatter_(-1, topk_idxs, 1.0)
    mask_pos = mask_topk * valid  # (B, M, A)

    # anchors claimed by several GTs keep the GT of largest overlap
    fg_counts = mask_pos.sum(dim=-2)  # (B, A)
    max_overlap_gt = overlaps.argmax(dim=1)  # (B, A)
    is_max = (torch.arange(m, device=overlaps.device)[None, :, None]
              == max_overlap_gt[:, None, :]).to(mask_pos.dtype)
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=-2) > 0  # (B, A)
    target_gt_idx = mask_pos.argmax(dim=-2)  # (B, A)

    # gather targets
    target_labels = torch.gather(labels, 1, target_gt_idx)  # (B, A)
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))
    target_scores = torch.nn.functional.one_hot(target_labels, nc).to(pd_scores.dtype)
    target_scores = target_scores * fg_mask[..., None]

    # normalize: scale the one-hot by align metric / per-GT max
    align_metric = align_metric * mask_pos
    pos_align_metrics = align_metric.amax(dim=-1, keepdim=True)  # (B, M, 1)
    pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)  # (B, M, 1)
    norm_align = (align_metric * pos_overlaps / (pos_align_metrics + eps)).amax(dim=-2)  # (B, A)
    target_scores = target_scores * norm_align[..., None]

    return target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx


def select_candidates_in_rotated_gts(anc_points, gt_rboxes):
    """(B, M, A) float mask of the anchors (A, 2) inside each rotated GT
    (B, M, 5) xywhr, edges included (tal.py:165): the anchor's projections
    on the edges ab and ad from corner a lie within them."""
    corners = xywhr2xyxyxyxy(gt_rboxes)  # (B, M, 4, 2)
    a, b_, d = corners[..., 0, :], corners[..., 1, :], corners[..., 3, :]
    ab = (b_ - a)[:, :, None, :]
    ad = (d - a)[:, :, None, :]
    ap = anc_points[None, None] - a[:, :, None, :]  # (B, M, A, 2)
    norm_ab, norm_ad = (ab * ab).sum(-1), (ad * ad).sum(-1)
    ap_ab, ap_ad = (ap * ab).sum(-1), (ap * ad).sum(-1)
    return ((ap_ab >= 0) & (ap_ab <= norm_ab) & (ap_ad >= 0) & (ap_ad <= norm_ad)).float()


def rotated_task_aligned_assign(pd_scores, pd_rboxes, anc_points, gt_labels, gt_rboxes, mask_gt,
                                topk=10, num_classes=80, alpha=0.5, beta=6.0, eps=1e-9):
    """`task_aligned_assign` for rotated boxes (tal.py:192): probiou
    overlaps, the rotated containment test, and of each GT's k largest
    metrics those > eps. pd_rboxes (B, A, 5) and gt_rboxes (B, M, 5) xywhr
    in one unit; returns target_labels, target_rboxes (B, A, 5),
    target_scores, fg_mask, target_gt_idx."""
    from .extra import probiou

    b, a, nc = pd_scores.shape
    m = gt_rboxes.shape[1]
    valid = select_candidates_in_rotated_gts(anc_points, gt_rboxes) * mask_gt.float()[..., None]
    ps = pd_scores.transpose(1, 2)
    labels = gt_labels.clamp(0, nc - 1).long()
    bbox_scores = torch.gather(ps, 1, labels[..., None].expand(b, m, a)) * valid
    overlaps = probiou(gt_rboxes[:, :, None, :], pd_rboxes[:, None, :, :]).clamp(min=0.0) * valid
    align_metric = bbox_scores**alpha * overlaps**beta

    k = min(topk, a)
    topk_idxs = torch.sort(align_metric, dim=-1, descending=True, stable=True).indices[..., :k]
    mask_topk = torch.zeros_like(align_metric).scatter_(-1, topk_idxs, 1.0)
    mask_pos = mask_topk * (align_metric > eps) * valid

    fg_counts = mask_pos.sum(dim=-2)
    max_overlap_gt = overlaps.argmax(dim=1)
    is_max = (torch.arange(m, device=overlaps.device)[None, :, None]
              == max_overlap_gt[:, None, :]).to(mask_pos.dtype)
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=-2) > 0
    target_gt_idx = mask_pos.argmax(dim=-2)

    target_labels = torch.gather(labels, 1, target_gt_idx)
    target_rboxes = torch.gather(gt_rboxes, 1, target_gt_idx[..., None].expand(b, a, 5))
    target_scores = torch.nn.functional.one_hot(target_labels, nc).to(pd_scores.dtype)
    target_scores = target_scores * fg_mask[..., None]

    align_metric = align_metric * mask_pos
    pos_align_metrics = align_metric.amax(dim=-1, keepdim=True)
    pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm_align = (align_metric * pos_overlaps / (pos_align_metrics + eps)).amax(dim=-2)
    return target_labels, target_rboxes, target_scores * norm_align[..., None], fg_mask, \
        target_gt_idx
