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


def non_max_suppression(prediction, conf_thres=0.25, iou_thres=0.45, max_det=300,
                        pre_nms_topk=1024, multi_label=True, class_agnostic=False):
    """Batched fixed-shape NMS (nms.py:96), class-aware unless
    `class_agnostic`, which suppresses across classes (no class offset).

    prediction: (B, 4+nc, A) decoded xywh + class scores (the Detect decode layout).
    Returns dets (B, max_det, 6) [x1, y1, x2, y2, conf, cls], zero-padded,
    and counts (B,) int32.
    """
    prediction = prediction.transpose(-1, -2)
    b, a, no = prediction.shape
    nc = no - 4
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
    if n_out < max_det:
        dets = torch.nn.functional.pad(dets, (0, 0, 0, max_det - n_out))
    return dets, valid.sum(-1).to(torch.int32)
