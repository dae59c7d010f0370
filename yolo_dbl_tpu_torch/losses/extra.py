"""Task losses beyond plain detection (port of yolo_dbl_tpu/losses/extra.py):
YOLOv10's end-to-end loss, the classification loss, the segmentation loss,
the pose loss and the rotated (OBB) loss, with their helpers (`probiou`).

Each loss computes in float32 for float32 and bfloat16 maps, as the JAX
losses cast to it. The segment, pose and OBB terms keep float64 maps in
float64 (`loss_dtype`), the reference that tests hold float32 runs to; their
`detection_loss` term is float32 whatever the maps' type, as JAX's
detection loss casts to it (JAX's losses/detection.py:87).

`segmentation_loss` is JAX's function computed over the foreground anchors
only. JAX forms the (B, A, Hm, Wm) product of every anchor's coefficients
with its image's prototypes and the (B, A, Hm, Wm) gather of its GT mask
(extra.py:186-190), 13.8 GB each in float32 at batch 16 and 640, and then
weights every non-foreground row by 0. The port gathers the foreground
rows first (Ultralytics' per-image `single_mask_loss` does the same): the
same terms, at most B x max_gt x TAL's top-k rows.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..nn.heads import dfl_expectation, flatten_levels, kpts_decode
from ..ops.anchors import bbox2dist, dist2bbox, dist2rbox, make_anchors
from ..ops.boxes import xywh2xyxy
from .detection import LossItems, _bce_with_logits, _df_loss, detection_loss
from .tal import rotated_task_aligned_assign, task_aligned_assign


class SegItems(NamedTuple):
    """The segmentation loss's items (extra.py:198): LossItems and `mask`."""
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor
    mask: torch.Tensor


class PoseItems(NamedTuple):
    """The pose loss's items (extra.py:317): LossItems, `kpt` and `kobj`,
    each with its gain."""
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor
    kpt: torch.Tensor
    kobj: torch.Tensor


# COCO-17 keypoint sigmas (extra.py:57), float32 as in JAX
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07,
                      1.07, 0.87, 0.87, 0.89, 0.89], np.float32) / 10.0


def loss_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for float32 and bfloat16 maps, float64 for float64 maps."""
    return torch.promote_types(x.dtype, torch.float32)


def _sigmas(k: int, dtype, device) -> torch.Tensor:
    """OKS_SIGMA for 17 keypoints, in float32 as JAX keeps it (a numpy
    float32 array, so its squares are float32 whatever the loss's type),
    else 1/k each in `dtype` (extra.py:69, :275)."""
    if k == 17:
        return torch.as_tensor(OKS_SIGMA, device=device)
    return torch.full((k,), 1.0 / k, dtype=dtype, device=device)


def e2e_detect_loss(feats: Dict[str, Sequence[torch.Tensor]], batch, strides: Tuple[int, ...],
                    nc: int, **kw) -> Tuple[torch.Tensor, Dict[str, LossItems]]:
    """v10Detect's loss (extra.py:22): `detection_loss` of the one2many maps
    with TAL top-10 plus that of the one2one maps with TAL top-1; returns the
    sum and {"one2many": items, "one2one": items}. `kw` goes to both terms
    (the gains, and `mesh`, whose global normalizer each term takes)."""
    l_many, items_many = detection_loss(feats["one2many"], batch, strides, nc, tal_topk=10, **kw)
    l_one, items_one = detection_loss(feats["one2one"], batch, strides, nc, tal_topk=1, **kw)
    return l_many + l_one, {"one2many": items_many, "one2one": items_one}


def classification_loss(logits, labels, label_smoothing: float = 0.0):
    """Mean cross-entropy of (B, nc) logits against integer labels, with
    label smoothing (extra.py:31). The JAX trainer does not call it."""
    nc = logits.shape[-1]
    targets = torch.nn.functional.one_hot(labels.long(), nc).to(logits.dtype)
    if label_smoothing:
        targets = targets * (1 - label_smoothing) + label_smoothing / nc
    return -(targets * torch.log_softmax(logits, -1)).sum(-1).mean()


def _inside(boxes, hm: int, wm: int):
    """(N, Hm, Wm) mask of the pixels with x1 <= col < x2, y1 <= row < y2."""
    cols = torch.arange(wm, device=boxes.device)[None, None, :]
    rows = torch.arange(hm, device=boxes.device)[None, :, None]
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    return (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)


def crop_mask_loss(pred_masks, gt_masks, boxes_xyxy_mask_space, fg_weight):
    """Each row's BCE of its mask logits against its GT mask, summed inside
    its box (mask pixels) and divided by the box's area clipped to 1, then
    the fg_weight-weighted mean (extra.py:41). pred_masks, gt_masks
    (N, Hm, Wm); boxes (N, 4); fg_weight (N,)."""
    _, hm, wm = pred_masks.shape
    ce = _bce_with_logits(pred_masks, gt_masks)
    b = boxes_xyxy_mask_space
    area = torch.clamp((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), min=1.0)
    per = (ce * _inside(b, hm, wm)).sum((1, 2)) / area
    return (per * fg_weight).sum() / torch.clamp(fg_weight.sum(), min=1.0)


def keypoint_loss(pred_kpts, gt_kpts, kpt_mask, area, sigmas=None):
    """OKS-style keypoint location loss (extra.py:69): pred_kpts, gt_kpts
    (N, K, 2), kpt_mask (N, K), area (N,). It divides by 2σ², where
    `pose_loss` divides by (2σ)², as the JAX package writes each. The JAX
    trainer does not call it."""
    _, k, _ = pred_kpts.shape
    sig = _sigmas(k, pred_kpts.dtype, pred_kpts.device) if sigmas is None else sigmas
    d2 = ((pred_kpts - gt_kpts) ** 2).sum(-1)
    factor = k / torch.clamp(kpt_mask.sum(-1, keepdim=True), min=1.0)
    e = d2 / (2 * sig[None] ** 2).to(d2.dtype) / torch.clamp(area[:, None], min=1e-9) / 2
    loss = (factor * (1 - torch.exp(-e)) * kpt_mask).sum(-1)
    return loss.sum() / torch.clamp((kpt_mask.sum(-1) > 0).sum(), min=1.0)


def exclusive_instance_masks(gm):
    """Each pixel kept by the smallest instance that covers it (extra.py:133),
    as the original's overlap index mask renders instances largest first.
    gm (B, M, Hm, Wm) binary; an instance's priority is its rank in
    descending area (a stable sort, as jnp.argsort), padded rows none."""
    areas = gm.sum((-1, -2))
    order = torch.sort(-areas, dim=1, stable=True).indices
    rank = torch.sort(order, dim=1, stable=True).indices.to(gm.dtype)
    pri = (rank + 1.0) * (areas > 0)
    pri_m = gm * pri[:, :, None, None]
    return gm * (pri_m == pri_m.amax(1, keepdim=True))


def _assign(x, batch, anchor_points, stride_t, gt_xyxy, nc):
    """The JAX task losses' second TAL (extra.py:171, :254): (target boxes
    in pixels, fg mask, target GT index) from the detached scores and
    decoded pixel boxes of x (B, A, 64 + nc)."""
    with torch.no_grad():
        x = x.detach()
        dist = dfl_expectation(x[..., :64], 16)
        pd_boxes = dist2bbox(dist, anchor_points[None], xywh=False) * stride_t[None]
        _, tgt_boxes, _, fg_mask, tgt_idx = task_aligned_assign(
            torch.sigmoid(x[..., 64:]), pd_boxes, anchor_points * stride_t,
            batch["gt_cls"].long(), gt_xyxy, batch["gt_mask"].to(x.dtype), num_classes=nc)
    return tgt_boxes, fg_mask, tgt_idx


def segmentation_loss(feats, coeffs, protos, batch, strides, nc, overlap_masks=True, **kw):
    """`detection_loss` plus the prototype mask loss (extra.py:150):
    `crop_mask_loss` of each foreground anchor's coefficients · its image's
    prototypes against its GT's mask (made exclusive with `overlap_masks`),
    cropped to the GT box in mask pixels, times the batch size. No gain
    scales the mask term (extra.py:197). feats, coeffs: per-level NHWC maps;
    protos (B, Hm, Wm, nm); batch["gt_masks"] (B, M, Hm, Wm). Returns (total,
    SegItems)."""
    total_det, items = detection_loss(feats, batch, strides, nc, **kw)
    b = feats[0].shape[0]
    dev = feats[0].device
    anchor_points, stride_t = make_anchors([f.shape[1:3] for f in feats], strides, device=dev)
    x = flatten_levels(feats)
    x = x.to(loss_dtype(x))
    dt = x.dtype
    imgsz = feats[0].shape[1] * strides[0]
    gt_xyxy = xywh2xyxy(batch["gt_boxes"].to(dt)) * imgsz
    tgt_boxes, fg_mask, tgt_idx = _assign(x, batch, anchor_points, stride_t, gt_xyxy, nc)

    coeff = flatten_levels(coeffs).to(dt)  # (B, A, nm)
    protos = protos.to(dt)
    hm, wm = protos.shape[1:3]
    gm = batch["gt_masks"].to(dt)
    if overlap_masks:
        gm = exclusive_instance_masks(gm)
    img, anchor = fg_mask.nonzero(as_tuple=True)  # by image, then anchor
    per_image = fg_mask.sum(1).tolist()
    rows = coeff[img, anchor].split(per_image)
    pred_m = torch.cat([r @ protos[i].reshape(-1, protos.shape[-1]).T
                        for i, r in enumerate(rows)]).view(-1, hm, wm)
    gt_m = gm[img, tgt_idx[img, anchor]]
    scale = torch.tensor([wm, hm, wm, hm], dtype=dt, device=dev) / imgsz
    boxes_m = tgt_boxes[img, anchor] * scale
    loss_mask = crop_mask_loss(pred_m, gt_m, boxes_m, torch.ones(len(img), dtype=dt, device=dev))
    return total_det + loss_mask * b, SegItems(*items, loss_mask)


def pose_loss(feats, kpt_maps, batch, strides, nc, kpt_shape=(17, 3), pose_gain=12.0,
              kobj_gain=1.0, **kw):
    """`detection_loss` plus the keypoint location term and, with a
    visibility channel, the visibility BCE of its raw logit (extra.py:208):
    each a mean over foreground anchors and keypoints, times its gain, then
    times the batch size. It divides the squared distance by (2σ)² · 2 ·
    area. batch["gt_kpts"] (B, M, K, nd) with xy in [0, 1]. Returns (total,
    PoseItems)."""
    total_det, items = detection_loss(feats, batch, strides, nc, **kw)
    b = feats[0].shape[0]
    nk, nd = kpt_shape
    dev = feats[0].device
    anchor_points, stride_t = make_anchors([f.shape[1:3] for f in feats], strides, device=dev)
    imgsz_h = feats[0].shape[1] * strides[0]
    imgsz_w = feats[0].shape[2] * strides[0]
    x = flatten_levels(feats)
    x = x.to(loss_dtype(x))
    dt = x.dtype
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=dt, device=dev)
    gt_xyxy = xywh2xyxy(batch["gt_boxes"].to(dt) * scale)
    tgt_boxes, fg_mask, tgt_idx = _assign(x, batch, anchor_points, stride_t, gt_xyxy, nc)
    fg = fg_mask.to(dt)
    tgt_boxes = tgt_boxes / stride_t[None]  # grid units

    pk = flatten_levels(kpt_maps).to(dt).reshape(b, -1, nk, nd)
    pred_kpts = kpts_decode(anchor_points, pk)
    kscale = torch.tensor([imgsz_w, imgsz_h] + [1.0] * (nd - 2), dtype=dt, device=dev)
    gk = batch["gt_kpts"].to(dt) * kscale
    sel = gk.gather(1, tgt_idx[:, :, None, None].expand(-1, -1, nk, nd))  # (B, A, K, nd)
    kdiv = torch.ones((1, sel.shape[1], 1, nd), dtype=dt, device=dev)
    kdiv[..., :2] = stride_t[None, :, :, None]
    sel = sel / kdiv

    area = torch.clamp((tgt_boxes[..., 2] - tgt_boxes[..., 0])
                       * (tgt_boxes[..., 3] - tgt_boxes[..., 1]), min=0)
    kpt_mask = (sel[..., 2] != 0).to(dt) if nd == 3 else torch.ones(sel.shape[:-1], dtype=dt,
                                                                     device=dev)
    sig = _sigmas(nk, dt, dev)
    d2 = ((pred_kpts[..., :2] - sel[..., :2]) ** 2).sum(-1)
    factor = nk / (kpt_mask.sum(-1, keepdim=True) + 1e-9)
    e = d2 / (((2 * sig[None, None]) ** 2).to(dt) * (area[..., None] + 1e-9) * 2)
    per_elem = factor * (1 - torch.exp(-e)) * kpt_mask
    n_fg = torch.clamp(fg.sum(), min=1.0)
    loss_kpt = (per_elem * fg[..., None]).sum() / (n_fg * nk)
    if nd == 3:
        kobj = _bce_with_logits(pk[..., 2], kpt_mask)
        loss_kobj = (kobj * fg[..., None]).sum() / (n_fg * nk)
    else:
        loss_kobj = torch.zeros((), dtype=dt, device=dev)
    total = total_det + (loss_kpt * pose_gain + loss_kobj * kobj_gain) * b
    return total, PoseItems(*items, loss_kpt * pose_gain, loss_kobj * kobj_gain)


def probiou(obb1, obb2, eps=1e-7):
    """Probabilistic IoU of broadcastable (..., 5) rotated boxes (cx, cy, w,
    h, angle) → (...,) in [0, 1] (extra.py:84): one minus the Hellinger
    distance of the boxes' Gaussians, the same operations in the same order.
    A box of w or h 0 has a zero covariance determinant, whose square root's
    gradient is infinite here as in JAX."""
    x1, y1, w1, h1, r1 = obb1.unbind(-1)
    x2, y2, w2, h2, r2 = obb2.unbind(-1)

    def cov(w, h, r):
        a = (w**2 / 12) * torch.cos(r) ** 2 + (h**2 / 12) * torch.sin(r) ** 2
        b = (w**2 / 12) * torch.sin(r) ** 2 + (h**2 / 12) * torch.cos(r) ** 2
        c = ((w**2 - h**2) / 12) * torch.cos(r) * torch.sin(r)
        return a, b, c

    a1, b1, c1 = cov(w1, h1, r1)
    a2, b2, c2 = cov(w2, h2, r2)
    zero = torch.zeros((), dtype=a1.dtype, device=a1.device)
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / (
        (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps) * 0.5
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
                   / (4 * torch.sqrt(torch.maximum(a1 * b1 - c1**2, zero)
                                     * torch.maximum(a2 * b2 - c2**2, zero)) + eps) + eps) * 0.5
    bd = torch.minimum(torch.maximum(t1 + t2 + t3, torch.full_like(zero, eps)),
                       torch.full_like(zero, 100.0))
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1.0 - hd


def obb_loss(feats, angle_maps, batch, strides, nc, reg_max=16, box_gain=7.5, cls_gain=0.5,
             dfl_gain=1.5):
    """The rotated detection loss (extra.py:285): BCE classes, the probiou
    box term and DFL against the target's axis-aligned box, with the rotated
    TAL on the detached predictions. feats: per-level NHWC Detect maps;
    angle_maps: the head's per-level angles (B, H, W, 1); batch["gt_boxes"]
    (B, M, 5): xywh normalized to [0, 1] and the angle in radians. GTs under
    2 px on a side are dropped. Returns (total, LossItems), the total times
    the batch size."""
    b = feats[0].shape[0]
    dev = feats[0].device
    imgsz_h = feats[0].shape[1] * strides[0]
    imgsz_w = feats[0].shape[2] * strides[0]
    anchor_points, stride_t = make_anchors([f.shape[1:3] for f in feats], strides, device=dev)
    x = flatten_levels(feats)
    dt = loss_dtype(x)
    x = x.to(dt)
    anchor_points, stride_t = anchor_points.to(dt), stride_t.to(dt)
    pred_distri, pred_scores = x[..., : 4 * reg_max], x[..., 4 * reg_max:]
    pred_angle = flatten_levels(angle_maps).to(dt)  # (B, A, 1)
    pd = pred_distri.reshape(b, -1, 4, reg_max)
    dist = dfl_expectation(pred_distri, reg_max)
    pred_rboxes = torch.cat([dist2rbox(dist, pred_angle, anchor_points[None]), pred_angle], -1)

    gt = batch["gt_boxes"].to(dt)
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=dt, device=dev)
    gt_rboxes = torch.cat([gt[..., :4] * scale, gt[..., 4:5]], -1)
    size_ok = (gt_rboxes[..., 2] >= 2) & (gt_rboxes[..., 3] >= 2)  # (extra.py:318)
    mask_gt = batch["gt_mask"].to(dt) * size_ok.to(dt)

    with torch.no_grad():
        assign = pred_rboxes.detach().clone()
        assign[..., :4] *= stride_t[None]
        _, tgt_rboxes, tgt_scores, fg_mask, _ = rotated_task_aligned_assign(
            torch.sigmoid(pred_scores.detach()), assign, anchor_points * stride_t,
            batch["gt_cls"].long(), gt_rboxes, mask_gt, num_classes=nc)
        tgt_rboxes = torch.cat([tgt_rboxes[..., :4] / stride_t[None], tgt_rboxes[..., 4:]], -1)
    fg = fg_mask.to(dt)
    tss = torch.clamp(tgt_scores.sum(), min=1.0)

    loss_cls = _bce_with_logits(pred_scores, tgt_scores).sum() / tss
    weight = tgt_scores.sum(-1) * fg
    iou = torch.maximum(probiou(pred_rboxes, tgt_rboxes), torch.zeros((), dtype=dt, device=dev))
    loss_box = ((1.0 - iou) * weight).sum() / tss
    tgt_ltrb = bbox2dist(anchor_points[None], xywh2xyxy(tgt_rboxes[..., :4]), reg_max)
    tgt_ltrb = tgt_ltrb.clamp(0, reg_max - 1 - 0.01)
    loss_dfl = (_df_loss(pd, tgt_ltrb, reg_max) * weight).sum() / tss
    items = LossItems(box=loss_box * box_gain, cls=loss_cls * cls_gain, dfl=loss_dfl * dfl_gain)
    return (items.box + items.cls + items.dfl) * b, items
