"""Detection metrics: AP, mAP, the COCO 12 stats, the confusion matrix (numpy).

A copy of yolo_dbl_tpu/utils/metrics.py, which is numpy only:
`box_iou_np`, `match_predictions`, `match_from_iou`, the task affinities
`mask_iou_np` and `kpt_oks_np` (OKS with `OKS_SIGMA_NP`), `compute_ap`
(101-point interpolation), `ap_per_class`, `DetMetrics` (fitness =
mAP50-95), `TaskMetrics` (box and mask or pose mAP, fitness their mean),
`COCOEvaluator` (the COCO 12 stats in numpy, in place of pycocotools) and
`ConfusionMatrix`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps=1e-7) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy → (N, M) IoU."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = (np.minimum(a2, b2) - np.maximum(a1, b1)).clip(0).prod(2)
    area1 = (a2 - a1).prod(2)
    area2 = (b2 - b1).prod(2)
    return inter / (area1 + area2 - inter + eps)


def match_predictions(
    pred_boxes: np.ndarray, pred_cls: np.ndarray, gt_boxes: np.ndarray, gt_cls: np.ndarray,
    iou_thresholds: np.ndarray,
) -> np.ndarray:
    """Per-image TP matrix over IoU thresholds (reference detect/val.py:209
    _process_batch → utils/metrics.py match_predictions): greedy one-to-one
    matching, class-consistent, highest IoU first.

    Returns (n_pred, n_thr) bool.
    """
    iou = box_iou_np(gt_boxes, pred_boxes)  # (n_gt, n_pred)
    return match_from_iou(iou, pred_cls, gt_cls, iou_thresholds)


def match_from_iou(iou: np.ndarray, pred_cls: np.ndarray, gt_cls: np.ndarray,
                   iou_thresholds: np.ndarray) -> np.ndarray:
    """Greedy one-to-one matching from a precomputed (n_gt, n_pred) affinity
    matrix — shared by box IoU, mask IoU, keypoint OKS and rotated probiou."""
    n_pred, n_thr = len(pred_cls), len(iou_thresholds)
    correct = np.zeros((n_pred, n_thr), dtype=bool)
    if len(gt_cls) == 0 or n_pred == 0:
        return correct
    correct_class = np.asarray(gt_cls)[:, None] == np.asarray(pred_cls)[None, :]
    iou = iou * correct_class
    for t, thr in enumerate(iou_thresholds):
        matches = np.argwhere(iou >= thr)  # (k, 2) [gt, pred]
        if matches.shape[0]:
            vals = iou[matches[:, 0], matches[:, 1]]
            order = vals.argsort()[::-1]
            matches = matches[order]
            # unique pred then unique gt, keeping highest IoU
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1], t] = True
    return correct


def mask_iou_np(gt_masks: np.ndarray, pred_masks: np.ndarray, eps=1e-7) -> np.ndarray:
    """(n_gt, H, W) × (n_pred, H, W) binary masks → (n_gt, n_pred) IoU
    (reference utils/metrics.py mask_iou)."""
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float64)
    p = pred_masks.reshape(len(pred_masks), -1).astype(np.float64)
    inter = g @ p.T
    union = g.sum(1)[:, None] + p.sum(1)[None] - inter
    return inter / (union + eps)


def kpt_oks_np(gt_kpts: np.ndarray, pred_kpts: np.ndarray, area: np.ndarray,
               sigmas: Optional[np.ndarray] = None, eps=1e-7) -> np.ndarray:
    """(n_gt, K, 3) × (n_pred, K, 2|3) keypoints → (n_gt, n_pred) OKS
    (reference utils/metrics.py kpt_iou). `area` is per-GT box area."""
    k = gt_kpts.shape[1]
    if sigmas is None:
        sigmas = (OKS_SIGMA_NP if k == 17 else np.full(k, 1.0 / k))
    d2 = ((gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2
          + (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2)  # (g, p, K)
    vis = (gt_kpts[..., 2] > 0).astype(np.float64)  # (g, K)
    e = d2 / (2 * sigmas[None, None]) ** 2 / (area[:, None, None] + eps) / 2
    oks = (np.exp(-e) * vis[:, None]).sum(-1) / (vis.sum(-1, keepdims=True) + eps)
    return oks


OKS_SIGMA_NP = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
     1.07, 1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (reference metrics.py compute_ap, method='interp')."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray,
    eps: float = 1e-16,
) -> Dict[str, np.ndarray]:
    """AP/P/R per class over IoU thresholds (reference metrics.py:537).

    Args:
        tp: (n_pred, n_thr) bool TP matrix.
        conf, pred_cls: (n_pred,).
        target_cls: (n_gt,).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    n_thr = tp.shape[1] if tp.ndim == 2 else 1
    ap = np.zeros((nc, n_thr))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    x = np.linspace(0, 1, 1000)
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l, n_p = nt[ci], i.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r[ci] = np.interp(-x, -conf[i], recall[:, 0], left=0)
        p[ci] = np.interp(-x, -conf[i], precision[:, 0], left=1)
        for t in range(n_thr):
            ap[ci, t], _, _ = compute_ap(recall[:, t], precision[:, t])
    f1 = 2 * p * r / (p + r + eps)
    i_best = f1.mean(0).argmax() if nc else 0
    return {
        "ap": ap,  # (nc, n_thr)
        "ap50": ap[:, 0] if n_thr else np.zeros(nc),
        "precision": p[:, i_best] if nc else np.zeros(0),
        "recall": r[:, i_best] if nc else np.zeros(0),
        "f1": f1[:, i_best] if nc else np.zeros(0),
        "classes": unique_classes.astype(int),
        "nt": nt,
    }


class DetMetrics:
    """Accumulates per-image stats and produces mAP (reference metrics.py:808).

    Usage: update(dets, gts) per image; results() at the end.
    `dets`: (n, 6) [x1,y1,x2,y2,conf,cls]; `gts`: dict boxes (m,4) xyxy, cls (m,).
    """

    IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)

    def __init__(self, nc: int, names: Optional[Dict[int, str]] = None):
        self.nc = nc
        self.names = names or {}
        self.stats: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []

    def update(self, dets: np.ndarray, gt_boxes: np.ndarray, gt_cls: np.ndarray):
        dets = np.asarray(dets, dtype=np.float64)
        tp = match_predictions(dets[:, :4], dets[:, 5], gt_boxes, gt_cls, self.IOU_THRESHOLDS)
        self.stats.append((tp, dets[:, 4], dets[:, 5], np.asarray(gt_cls)))

    def results(self) -> Dict[str, float]:
        if not self.stats:
            return {"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50-95": 0.0, "fitness": 0.0}
        tp = np.concatenate([s[0] for s in self.stats])
        conf = np.concatenate([s[1] for s in self.stats])
        pred_cls = np.concatenate([s[2] for s in self.stats])
        target_cls = np.concatenate([s[3] for s in self.stats])
        res = ap_per_class(tp, conf, pred_cls, target_cls)
        map50 = float(res["ap50"].mean()) if len(res["ap50"]) else 0.0
        map50_95 = float(res["ap"].mean()) if res["ap"].size else 0.0
        out = {
            "precision": float(res["precision"].mean()) if len(res["precision"]) else 0.0,
            "recall": float(res["recall"].mean()) if len(res["recall"]) else 0.0,
            "mAP50": map50,
            "mAP50-95": map50_95,
            # fitness = mAP50-95 (reference weight vector [0,0,0,0,1.0])
            "fitness": map50_95,
        }
        out["per_class_ap50_95"] = {int(c): float(res["ap"][i].mean()) for i, c in enumerate(res["classes"])}
        return out


class TaskMetrics(DetMetrics):
    """Two-branch metrics: box mAP plus a task affinity (mask IoU / OKS /
    probiou) mAP (reference SegmentMetrics / PoseMetrics / OBBMetrics)."""

    def __init__(self, nc: int, names=None, task_key: str = "mask"):
        super().__init__(nc, names)
        self.task_key = task_key
        self.task_stats: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []

    def update_task(self, dets: np.ndarray, affinity: np.ndarray, gt_cls: np.ndarray):
        """`affinity`: (n_gt, n_pred) precomputed task IoU/OKS matrix."""
        dets = np.asarray(dets, dtype=np.float64)
        tp = match_from_iou(affinity, dets[:, 5], gt_cls, self.IOU_THRESHOLDS)
        self.task_stats.append((tp, dets[:, 4], dets[:, 5], np.asarray(gt_cls)))

    def results(self) -> Dict[str, float]:
        out = super().results()
        box_fitness = out["fitness"]
        if self.task_stats:
            tp = np.concatenate([s[0] for s in self.task_stats])
            conf = np.concatenate([s[1] for s in self.task_stats])
            pred_cls = np.concatenate([s[2] for s in self.task_stats])
            target_cls = np.concatenate([s[3] for s in self.task_stats])
            res = ap_per_class(tp, conf, pred_cls, target_cls)
            m50 = float(res["ap50"].mean()) if len(res["ap50"]) else 0.0
            m5095 = float(res["ap"].mean()) if res["ap"].size else 0.0
        else:
            m50 = m5095 = 0.0
        out[f"{self.task_key}_mAP50"] = m50
        out[f"{self.task_key}_mAP50-95"] = m5095
        # reference fitness averages box and task branches
        out["fitness"] = (box_fitness + m5095) / 2
        return out


COCO_STAT_NAMES = [
    "AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge",
    "AR1", "AR10", "AR100", "ARsmall", "ARmedium", "ARlarge",
]


class COCOEvaluator:
    """COCO-style 12-stat evaluation in pure numpy (replaces pycocotools).

    Mirrors global_utils/coco.py:73 COCOEvaluator semantics: 10 IoU
    thresholds 0.5:0.95, 101-point recall interpolation, area ranges
    all/small(<32²)/medium/large(>96²), maxDets 1/10/100.
    """

    IOU_THRS = np.linspace(0.5, 0.95, 10)
    RECALL_THRS = np.linspace(0.0, 1.0, 101)
    AREA_RANGES = {
        "all": (0.0, 1e10),
        "small": (0.0, 32.0**2),
        "medium": (32.0**2, 96.0**2),
        "large": (96.0**2, 1e10),
    }
    MAX_DETS = (1, 10, 100)

    def __init__(self, nc: int, min_score: float = 0.01):
        self.nc = nc
        self.min_score = min_score
        self.images: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def update(self, dets: np.ndarray, gt_boxes: np.ndarray, gt_cls: np.ndarray):
        """dets (n, 6) [xyxy conf cls]; gts xyxy + cls; one call per image."""
        dets = np.asarray(dets, dtype=np.float64)
        dets = dets[dets[:, 4] >= self.min_score]
        self.images.append((dets, np.asarray(gt_boxes, np.float64), np.asarray(gt_cls)))

    def _eval_class_area(self, c: int, area_rng: Tuple[float, float], max_det: int):
        """Returns per-image match records for (class, area, maxdet)."""
        all_scores, all_matched, n_gt = [], [], 0
        t = len(self.IOU_THRS)
        for dets, gt_boxes, gt_cls in self.images:
            g_mask = gt_cls == c
            g = gt_boxes[g_mask]
            g_area = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
            g_ignore = (g_area < area_rng[0]) | (g_area >= area_rng[1])
            d = dets[dets[:, 5] == c]
            d = d[np.argsort(-d[:, 4])][:max_det]
            d_area = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
            d_out_of_rng = (d_area < area_rng[0]) | (d_area >= area_rng[1])
            n_gt += int((~g_ignore).sum())
            if len(d) == 0:
                continue
            matched = np.zeros((t, len(d)), dtype=np.int8)  # 1 tp, -1 ignore
            if len(g):
                iou = box_iou_np(d[:, :4], g)  # (nd, ng)
                for ti, thr in enumerate(self.IOU_THRS):
                    taken = np.zeros(len(g), dtype=bool)
                    for di in range(len(d)):
                        # prefer non-ignored gts; fall back to ignored
                        best, best_iou = -1, thr - 1e-10
                        for gi in range(len(g)):
                            if taken[gi]:
                                continue
                            if best > -1 and not g_ignore[best] and g_ignore[gi]:
                                break  # remaining are worse (not sorted; COCO sorts ignored last)
                            if iou[di, gi] >= best_iou:
                                best_iou = iou[di, gi]
                                best = gi
                        if best > -1:
                            taken[best] = True
                            matched[ti, di] = -1 if g_ignore[best] else 1
            # unmatched dets outside the area range are ignored
            for ti in range(t):
                um = matched[ti] == 0
                matched[ti, um & d_out_of_rng] = -1
            all_scores.append(d[:, 4])
            all_matched.append(matched)
        if not all_scores:
            return None, n_gt
        scores = np.concatenate(all_scores)
        matched = np.concatenate(all_matched, axis=1)  # (t, nd_total)
        order = np.argsort(-scores, kind="mergesort")
        return matched[:, order], n_gt

    def _pr_at(self, matched, n_gt):
        """precision (t, 101) and recall (t,) from sorted match records."""
        t = len(self.IOU_THRS)
        prec = np.zeros((t, len(self.RECALL_THRS)))
        rec = np.zeros(t)
        if matched is None or n_gt == 0:
            return None, None
        for ti in range(t):
            keep = matched[ti] != -1
            tps = (matched[ti][keep] == 1).astype(np.float64)
            if tps.size == 0:
                continue
            tp_cum = tps.cumsum()
            fp_cum = (1 - tps).cumsum()
            rc = tp_cum / n_gt
            pr = tp_cum / (tp_cum + fp_cum + 1e-16)
            # monotone precision envelope
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            idx = np.searchsorted(rc, self.RECALL_THRS, side="left")
            valid = idx < len(pr)
            prec[ti, valid] = pr[idx[valid]]
            rec[ti] = rc[-1]
        return prec, rec

    def summarize(self) -> Dict[str, float]:
        classes = range(self.nc)
        # AP over areas
        stats = {}
        ap_all, ap_small, ap_med, ap_large = [], [], [], []
        ar1, ar10, ar100 = [], [], []
        ar_small, ar_med, ar_large = [], [], []
        for c in classes:
            for area_name, bucket in [("all", ap_all), ("small", ap_small), ("medium", ap_med), ("large", ap_large)]:
                matched, n_gt = self._eval_class_area(c, self.AREA_RANGES[area_name], 100)
                prec, _ = self._pr_at(matched, n_gt)
                if prec is not None:
                    bucket.append(prec)
            for md, bucket in [(1, ar1), (10, ar10), (100, ar100)]:
                matched, n_gt = self._eval_class_area(c, self.AREA_RANGES["all"], md)
                _, rec = self._pr_at(matched, n_gt)
                if rec is not None:
                    bucket.append(rec)
            for area_name, bucket in [("small", ar_small), ("medium", ar_med), ("large", ar_large)]:
                matched, n_gt = self._eval_class_area(c, self.AREA_RANGES[area_name], 100)
                _, rec = self._pr_at(matched, n_gt)
                if rec is not None:
                    bucket.append(rec)

        def mean_ap(bucket, thr_idx=None):
            if not bucket:
                return -1.0
            arr = np.stack(bucket)  # (ncls, t, 101)
            return float(arr.mean() if thr_idx is None else arr[:, thr_idx].mean())

        def mean_ar(bucket):
            if not bucket:
                return -1.0
            return float(np.stack(bucket).mean())

        stats["AP"] = mean_ap(ap_all)
        stats["AP50"] = mean_ap(ap_all, 0)
        stats["AP75"] = mean_ap(ap_all, 5)
        stats["APsmall"] = mean_ap(ap_small)
        stats["APmedium"] = mean_ap(ap_med)
        stats["APlarge"] = mean_ap(ap_large)
        stats["AR1"] = mean_ar(ar1)
        stats["AR10"] = mean_ar(ar10)
        stats["AR100"] = mean_ar(ar100)
        stats["ARsmall"] = mean_ar(ar_small)
        stats["ARmedium"] = mean_ar(ar_med)
        stats["ARlarge"] = mean_ar(ar_large)
        return stats


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:294)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(self, dets: np.ndarray, gt_boxes: np.ndarray, gt_cls: np.ndarray):
        if dets is None or len(dets) == 0:
            for c in gt_cls:
                self.matrix[self.nc, int(c)] += 1  # background FN
            return
        dets = dets[dets[:, 4] > self.conf]
        if len(gt_cls) == 0:
            for c in dets[:, 5]:
                self.matrix[int(c), self.nc] += 1  # background FP
            return
        iou = box_iou_np(gt_boxes, dets[:, :4])
        matches = np.argwhere(iou > self.iou_thres)
        if matches.shape[0]:
            vals = iou[matches[:, 0], matches[:, 1]]
            matches = matches[vals.argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        matched_gt = set(matches[:, 0].tolist()) if matches.shape[0] else set()
        matched_det = set(matches[:, 1].tolist()) if matches.shape[0] else set()
        for gi, di in matches:
            self.matrix[int(dets[di, 5]), int(gt_cls[gi])] += 1
        for gi in range(len(gt_cls)):
            if gi not in matched_gt:
                self.matrix[self.nc, int(gt_cls[gi])] += 1
        for di in range(len(dets)):
            if di not in matched_det:
                self.matrix[int(dets[di, 5]), self.nc] += 1
