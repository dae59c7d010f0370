"""Fixed-shape, batched non-maximum suppression (port of yolo_dbl_tpu/ops/nms.py).

The JAX package builds NMS from XLA operations, not from a Pallas kernel,
so this is plain PyTorch. The contract is the JAX one: multi-label (anchor,
class) candidates above `conf_thres` (strict >), the top `pre_nms_topk`,
exact greedy suppression at strict IoU > `iou_thres` with class offsets
(MAX_WH; none with `class_agnostic`), then the top `max_det` rows, zero-padded to (B, max_det, 6) plus counts.
The class indices are float32, as in the JAX package (nms.py:144,151), so
bfloat16 predictions are suppressed with float32 class offsets and come
out as float32 rows: in bfloat16, 79 x MAX_WH would be 4,096 pixels apart
from its neighbours.

`non_max_suppression_rotated` (nms.py:182) is another algorithm, the JAX
package's single-pass fast-NMS for an OBB decode: a candidate dies when a
higher-scoring live candidate's probiou with it reaches `iou_thres`,
whether or not that one survives itself, and no class offset keeps classes
apart (mirrored, ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from .boxes import box_iou, xywh2xyxy

MAX_WH = 7680.0  # class-offset magnitude (nms.py:28)


def _topk(x, k: int):
    """Top-k along the last axis, equal values in index order, as lax.top_k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress(boxes, scores, iou_thres):
    """Greedy NMS over score-sorted (B, K, 4) boxes → keep mask (B, K) (nms.py:31).

    The exact greedy result, computed as the JAX package's monotone fixpoint:
    each round every undecided box with an earlier kept overlap dies, and
    every undecided box whose earlier overlaps are all dead is kept.
    """
    k = boxes.shape[-2]
    earlier = torch.ones((k, k), dtype=torch.bool, device=boxes.device).tril(-1)
    # [i, j]: j is earlier (higher score) than i and overlaps it
    overlap = (earlier & (box_iou(boxes, boxes) > iou_thres)).float()
    alive = scores > -torch.inf
    kept = torch.zeros_like(alive)
    dead = ~alive  # below-threshold candidates are decided from the start
    while True:
        undecided = ~(kept | dead)
        if not bool(undecided.any()):
            break
        counts = overlap @ torch.stack([kept, undecided], dim=-1).float()  # (B, K, 2)
        has_kept_earlier = counts[..., 0] > 0.5
        has_undecided_earlier = counts[..., 1] > 0.5
        dead = dead | (undecided & has_kept_earlier)
        kept = kept | (undecided & ~has_kept_earlier & ~has_undecided_earlier)
    return kept & alive


def mask_classes(pred, classes, nc):
    """Zero the score channels of the classes not in `classes` (the
    predictor's `classes` filter, predictor.py:386): they can never pass
    conf_thres. pred: (B, 4+nc, A), channels after 4+nc kept."""
    if classes is None:
        return pred
    keep = torch.zeros(nc, dtype=pred.dtype, device=pred.device)
    keep[list(classes)] = 1
    return torch.cat([pred[:, :4], pred[:, 4:4 + nc] * keep[None, :, None], pred[:, 4 + nc:]], 1)


def non_max_suppression(prediction, conf_thres=0.25, iou_thres=0.45, max_det=300,
                        pre_nms_topk=1024, nc=None, multi_label=True, class_agnostic=False,
                        return_idx=False):
    """Batched fixed-shape NMS (nms.py:96), class-aware unless
    `class_agnostic`, which suppresses across classes (no class offset).

    prediction: (B, 4+nc, A) decoded xywh + class scores (the Detect decode
    layout); `nc` defaults to all channels after the box.
    Returns dets (B, max_det, 6) [x1, y1, x2, y2, conf, cls], zero-padded,
    and counts (B,) int32; with `return_idx` also each row's anchor index
    (B, max_det) int32, 0 on padded rows, for gathering the task heads'
    side channels (mask coefficients, keypoints) of the kept rows.
    """
    prediction = prediction.transpose(-1, -2)
    b, a, no = prediction.shape
    nc = no - 4 if nc is None else nc
    boxes = xywh2xyxy(prediction[..., :4])
    scores_all = prediction[..., 4:4 + nc]
    ninf = torch.tensor(-torch.inf, dtype=prediction.dtype, device=prediction.device)
    k = min(pre_nms_topk, a * nc if multi_label else a)

    if multi_label:
        flat = scores_all.reshape(b, a * nc)
        top_scores, top_idx = _topk(torch.where(flat > conf_thres, flat, ninf), k)
        anchor_idx = top_idx // nc
        cls_idx = (top_idx % nc).float()
    else:
        best_score = scores_all.amax(-1)
        best_cls = scores_all.argmax(-1)
        top_scores, anchor_idx = _topk(torch.where(best_score > conf_thres, best_score, ninf), k)
        cls_idx = best_cls.gather(1, anchor_idx).float()
    cand_boxes = boxes.gather(1, anchor_idx[..., None].expand(b, k, 4))

    offset = 0.0 if class_agnostic else cls_idx[..., None] * MAX_WH
    keep = _suppress(cand_boxes + offset, top_scores, iou_thres)

    n_out = min(max_det, k)
    final_scores, order = _topk(torch.where(keep, top_scores, ninf), n_out)
    valid = final_scores > -torch.inf
    final_boxes = cand_boxes.gather(1, order[..., None].expand(b, n_out, 4))
    dets = torch.cat([
        torch.where(valid[..., None], final_boxes, 0.0),
        torch.where(valid, final_scores, 0.0)[..., None],
        torch.where(valid, cls_idx.gather(1, order), 0.0)[..., None],
    ], dim=-1)
    counts = valid.sum(-1).to(torch.int32)
    if n_out < max_det:
        dets = torch.nn.functional.pad(dets, (0, 0, 0, max_det - n_out))
    if not return_idx:
        return dets, counts
    kept = torch.where(valid, anchor_idx.gather(1, order), 0).to(torch.int32)
    return dets, counts, torch.nn.functional.pad(kept, (0, max_det - n_out))


def non_max_suppression_rotated(prediction, conf_thres=0.25, iou_thres=0.45, max_det=300,
                                pre_nms_topk=1024, nc=None):
    """Fixed-shape rotated fast-NMS (nms.py:182). prediction: (B, 4+nc+1, A)
    `decode_obb` output (xywh, scores, angle). Each anchor's best class
    score >= `conf_thres` makes it a candidate; of the top `pre_nms_topk`,
    a candidate is kept when no higher-scoring candidate overlaps it with
    probiou >= `iou_thres`; then the top `max_det` kept. Computes in float32
    for a bfloat16 decode (a departure: JAX's would take probiou's log and
    square root in bfloat16). Returns dets (B, max_det, 7) [x, y, w, h,
    angle, conf, cls], zero-padded, and counts (B,) int32."""
    from ..losses.extra import probiou

    pred = prediction.transpose(-1, -2)
    pred = pred.to(torch.promote_types(pred.dtype, torch.float32))
    b, a, no = pred.shape
    nc = no - 5 if nc is None else nc
    boxes, scores, angle = pred[..., :4], pred[..., 4:4 + nc], pred[..., 4 + nc:]
    ninf = torch.tensor(-torch.inf, dtype=pred.dtype, device=pred.device)
    conf = scores.amax(-1)
    cls = scores.argmax(-1).float()
    k = min(pre_nms_topk, a)
    top_conf, idx = _topk(torch.where(conf >= conf_thres, conf, ninf), k)
    rb = torch.cat([boxes, angle], -1).gather(1, idx[..., None].expand(b, k, 5))  # (B, K, 5)
    iou = probiou(rb[:, :, None, :], rb[:, None, :, :])  # (B, K, K)
    live = torch.isfinite(top_conf)
    later = torch.ones((k, k), dtype=torch.bool, device=pred.device).triu(1)  # [i, j]: i before j
    overlap = torch.where(later & live[:, None, :] & live[:, :, None], iou, 0.0)
    keep = (overlap.amax(1) < iou_thres) & live
    n_out = min(max_det, k)
    out_s, out_i = _topk(torch.where(keep, top_conf, ninf), n_out)
    valid = torch.isfinite(out_s)
    dets = torch.cat([rb.gather(1, out_i[..., None].expand(b, n_out, 5)), out_s[..., None],
                      cls.gather(1, idx).gather(1, out_i)[..., None]], -1)
    dets = torch.where(valid[..., None], dets, 0.0)
    if n_out < max_det:
        dets = torch.nn.functional.pad(dets, (0, 0, 0, max_det - n_out))
    return dets, valid.sum(-1).to(torch.int32)
