"""Host-side image augmentations, numpy and cv2 (a copy of yolo_dbl_tpu/data/augment.py).

Mosaic, random perspective, MixUp, copy-paste, HSV, flips, the
Albumentations-style pixel extras and the letterbox, composed as
`TrainTransforms` and `ValTransforms`. The functions and the order of their
draws from the `np.random.Generator` are the JAX package's, so a seeded run
gives its batches bit for bit (tests/test_torch_data.py). The device
normalizes the uint8 batches (`kernels.preprocess.device_normalize`).

All functions take and return HWC uint8 RGB images and label dicts:
    {"boxes": (N, 4) float32 xyxy in pixels, "cls": (N,) int32}
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np


def letterbox(
    img: np.ndarray,
    new_shape: Tuple[int, int] = (640, 640),
    color: int = 114,
    scaleup: bool = True,
    center: bool = True,
) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Aspect-preserving resize + pad (reference augment.py:1477 LetterBox).

    Returns (image, gain, (pad_w, pad_h)).
    """
    shape = img.shape[:2]  # h, w
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (round(shape[1] * r), round(shape[0] * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if center:
        dw /= 2
        dh /= 2
    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    img = cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=(color,) * 3)
    return img, r, (left, top)


def apply_letterbox_to_boxes(boxes: np.ndarray, gain: float, pad: Tuple[float, float]) -> np.ndarray:
    out = boxes.copy()
    out[:, [0, 2]] = out[:, [0, 2]] * gain + pad[0]
    out[:, [1, 3]] = out[:, [1, 3]] * gain + pad[1]
    return out


def random_hsv(img: np.ndarray, rng: np.random.Generator, hgain=0.015, sgain=0.7, vgain=0.4) -> np.ndarray:
    """HSV jitter via LUTs (reference augment.py RandomHSV)."""
    if hgain == 0 and sgain == 0 and vgain == 0:
        return img
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    im_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val)))
    return cv2.cvtColor(im_hsv, cv2.COLOR_HSV2RGB)


def random_flip(img: np.ndarray, labels: Dict, rng: np.random.Generator, fliplr=0.5, flipud=0.0,
                flip_idx=None):
    h, w = img.shape[:2]
    labels = dict(labels)
    if flipud and rng.random() < flipud:
        img = np.flipud(img)
        boxes = labels["boxes"].copy()
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        labels["boxes"] = boxes
        if labels.get("segments"):
            labels["segments"] = [np.stack([s[:, 0], h - s[:, 1]], 1) for s in labels["segments"]]
        if "keypoints" in labels and len(labels["keypoints"]):
            kp = labels["keypoints"].copy()
            kp[..., 1] = np.where(kp[..., 2] > 0, h - kp[..., 1], kp[..., 1])
            labels["keypoints"] = kp
    if fliplr and rng.random() < fliplr:
        img = np.fliplr(img)
        boxes = labels["boxes"].copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        labels["boxes"] = boxes
        if labels.get("segments"):
            labels["segments"] = [np.stack([w - s[:, 0], s[:, 1]], 1) for s in labels["segments"]]
        if "keypoints" in labels and len(labels["keypoints"]):
            kp = labels["keypoints"].copy()
            kp[..., 0] = np.where(kp[..., 2] > 0, w - kp[..., 0], kp[..., 0])
            if flip_idx is not None:
                kp = kp[:, list(flip_idx)]  # left/right keypoint swap (reference RandomFlip)
            labels["keypoints"] = kp
    return np.ascontiguousarray(img), labels


def random_perspective(
    img: np.ndarray,
    labels: Dict,
    rng: np.random.Generator,
    degrees=0.0,
    translate=0.1,
    scale=0.5,
    shear=0.0,
    perspective=0.0,
    border: Tuple[int, int] = (0, 0),
):
    """Affine/perspective warp with box transform + candidate filtering
    (reference augment.py:952 RandomPerspective)."""
    h = img.shape[0] + border[0] * 2
    w = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(w, h), borderValue=(114, 114, 114))
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(w, h), borderValue=(114, 114, 114))

    def warp_points(pts):
        """Apply M to (k, 2) points."""
        xy = np.ones((len(pts), 3))
        xy[:, :2] = pts
        xy = xy @ M.T
        return xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]

    boxes = labels["boxes"]
    n = len(boxes)
    if n:
        segments = labels.get("segments")
        if segments:
            # segment-derived boxes after warp (reference apply_segments):
            # clip the warped polygon to the canvas, box = its extent
            new_segments = []
            new = np.zeros((n, 4), np.float32)
            for i, seg in enumerate(segments):
                pts = warp_points(seg)
                pts[:, 0] = pts[:, 0].clip(0, w)
                pts[:, 1] = pts[:, 1].clip(0, h)
                new_segments.append(pts.astype(np.float32))
                new[i] = [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
            labels = {**labels, "segments": new_segments}
        else:
            xy = warp_points(boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)).reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        if "keypoints" in labels and len(labels["keypoints"]):
            kp = labels["keypoints"].copy()
            k = kp.shape[1]
            flat = warp_points(kp[..., :2].reshape(-1, 2)).reshape(n, k, 2)
            inb = (flat[..., 0] >= 0) & (flat[..., 0] < w) & (flat[..., 1] >= 0) & (flat[..., 1] < h)
            kp[..., :2] = flat
            kp[..., 2] = np.where(inb, kp[..., 2], 0.0)
            labels = {**labels, "keypoints": kp}
        keep = _box_candidates(boxes.T * s, new.T, area_thr=0.01 if segments else 0.1)
        labels = _filter_label_fields({**labels, "boxes": new.astype(np.float32)}, keep)
    return img, labels


def _box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Filter warped boxes (reference augment.py box_candidates)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2 area, (N, M) (reference utils/metrics.py:20)."""
    ix = (np.minimum(box1[:, None, 2], box2[None, :, 2]) - np.maximum(box1[:, None, 0], box2[None, :, 0])).clip(0)
    iy = (np.minimum(box1[:, None, 3], box2[None, :, 3]) - np.maximum(box1[:, None, 1], box2[None, :, 1])).clip(0)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return ix * iy / (area2[None, :] + eps)


def _filter_label_fields(labels: Dict, keep: np.ndarray) -> Dict:
    """Apply a boolean/index selection to all per-instance label fields."""
    out = dict(labels)
    out["boxes"] = labels["boxes"][keep]
    out["cls"] = labels["cls"][keep]
    if "segments" in labels:
        idx = np.flatnonzero(keep) if keep.dtype == bool else keep
        out["segments"] = [labels["segments"][i] for i in idx]
    if "keypoints" in labels and len(labels["keypoints"]):
        out["keypoints"] = labels["keypoints"][keep]
    return out


def copy_paste(img: np.ndarray, labels: Dict, rng: np.random.Generator, p: float = 0.5,
               mode: str = "flip", donor: Optional[Tuple[np.ndarray, Dict]] = None):
    """Segment copy-paste (reference augment.py:1634 CopyPaste).

    Pastes object segments onto `img`: in 'flip' mode the donors are the
    horizontally-mirrored segments of the same image; in 'mixup' mode they
    come from another (already-augmented) image passed as `donor`. Only
    donors whose box overlaps every existing box by < 0.30 IoA are eligible;
    the round(p * n) least-overlapping ones are pasted. No-op when the
    labels carry no segments (detect-only datasets — same as the reference).
    """
    segments = labels.get("segments")
    if not segments or p == 0:
        return img, labels
    h, w = img.shape[:2]
    boxes = labels["boxes"]

    if mode == "flip" or donor is None:
        src_img = np.fliplr(img)
        d_segments = [np.stack([w - s[:, 0], s[:, 1]], axis=1) for s in segments]
        d_boxes = boxes.copy()
        d_boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        d_cls = labels["cls"]
        d_kpts = None
    else:
        src_img, d_labels = donor
        d_segments = d_labels.get("segments", [])
        if not d_segments:
            return img, labels
        d_boxes = d_labels["boxes"]
        d_cls = d_labels["cls"]
        d_kpts = d_labels.get("keypoints")
        if src_img.shape[:2] != (h, w):
            return img, labels

    if len(boxes):
        ioa = bbox_ioa(d_boxes, boxes)  # (N_donor, M_existing)
        eligible = np.flatnonzero((ioa < 0.30).all(1))
        eligible = eligible[np.argsort(ioa.max(1)[eligible])]
    else:
        eligible = np.arange(len(d_boxes))
    n_paste = round(p * len(eligible))
    if n_paste == 0:
        return img, labels

    chosen = eligible[:n_paste]
    mask = np.zeros((h, w), np.uint8)
    for j in chosen:
        cv2.fillPoly(mask, [d_segments[j].astype(np.int32)], 1)
    m = mask.astype(bool)
    img = img.copy()
    img[m] = src_img[m]

    out = dict(labels)
    out["boxes"] = np.concatenate([boxes, d_boxes[chosen]], 0).astype(np.float32)
    out["cls"] = np.concatenate([labels["cls"], d_cls[chosen]], 0)
    out["segments"] = list(segments) + [d_segments[j] for j in chosen]
    if "keypoints" in labels and len(labels["keypoints"]) and d_kpts is not None and len(d_kpts):
        out["keypoints"] = np.concatenate([labels["keypoints"], d_kpts[chosen]], 0)
    return img, out


def random_erasing(img: np.ndarray, rng: np.random.Generator, p: float = 0.0,
                   scale=(0.02, 0.33), ratio=(0.3, 3.3)) -> np.ndarray:
    """Random rectangle erasing (torchvision RandomErasing semantics; the
    reference uses it in classify train transforms, augment.py:2500)."""
    if p == 0 or rng.random() >= p:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        eh = int(round(math.sqrt(target * ar)))
        ew = int(round(math.sqrt(target / ar)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            y = int(rng.integers(0, h - eh + 1))
            x = int(rng.integers(0, w - ew + 1))
            img = img.copy()
            img[y : y + eh, x : x + ew] = rng.integers(0, 256, (eh, ew, img.shape[2]), dtype=np.uint8)
            return img
    return img


def albumentations_extras(img: np.ndarray, rng: np.random.Generator, p: float = 0.01) -> np.ndarray:
    """Pixel-level extras of the reference's Albumentations block
    (augment.py:1735, p=0.01 each): Blur, MedianBlur, ToGray, CLAHE —
    reimplemented on cv2 directly (the albumentations package itself is a
    thin wrapper over these same calls)."""
    import cv2

    if p <= 0:
        return img
    if rng.random() < p:  # box blur, ksize 3..7 like A.Blur(blur_limit=7)
        k = int(rng.integers(1, 4)) * 2 + 1
        img = cv2.blur(img, (k, k))
    if rng.random() < p:  # median blur
        k = int(rng.integers(1, 4)) * 2 + 1
        img = cv2.medianBlur(img, k)
    if rng.random() < p:  # to gray (kept 3-channel)
        g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        img = cv2.cvtColor(g, cv2.COLOR_GRAY2RGB)
    if rng.random() < p:  # CLAHE on the L channel, clip 1..4, 8x8 tiles
        lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=float(rng.uniform(1.0, 4.0)), tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        img = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    return np.ascontiguousarray(img)


def mosaic4(
    items: List[Tuple[np.ndarray, Dict]],
    imgsz: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, Dict]:
    """2×2 mosaic on a 2× canvas (reference augment.py:490 Mosaic._mosaic4)."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    all_boxes, all_cls, all_segments, all_kpts = [], [], [], []
    for i, (img, labels) in enumerate(items[:4]):
        h, w = img.shape[:2]
        if i == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(labels["boxes"]):
            b = labels["boxes"].copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            all_boxes.append(b)
            all_cls.append(labels["cls"])
            shift = np.array([padw, padh], np.float32)
            all_segments.extend(seg + shift for seg in labels.get("segments", []))
            if "keypoints" in labels and len(labels["keypoints"]):
                kp = labels["keypoints"].copy()
                kp[..., :2] += shift
                all_kpts.append(kp)
    boxes = np.concatenate(all_boxes, 0) if all_boxes else np.zeros((0, 4), np.float32)
    cls = np.concatenate(all_cls, 0) if all_cls else np.zeros((0,), np.int32)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    out = {"boxes": boxes.astype(np.float32), "cls": cls}
    if any("segments" in lab for _, lab in items[:4]):
        out["segments"] = [np.clip(seg, 0, 2 * s) for seg in all_segments]
    if all_kpts:
        out["keypoints"] = np.concatenate(all_kpts, 0)
    return canvas, out


def mixup(img1, labels1, img2, labels2, rng: np.random.Generator):
    """Beta(32, 32) image blend (reference augment.py:867 MixUp)."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    labels = {
        "boxes": np.concatenate([labels1["boxes"], labels2["boxes"]], 0),
        "cls": np.concatenate([labels1["cls"], labels2["cls"]], 0),
    }
    if "segments" in labels1 or "segments" in labels2:
        labels["segments"] = list(labels1.get("segments", [])) + list(labels2.get("segments", []))
    if "keypoints" in labels1 and "keypoints" in labels2:
        labels["keypoints"] = np.concatenate([labels1["keypoints"], labels2["keypoints"]], 0)
    return img, labels


class TrainTransforms:
    """Composed train-time pipeline (reference augment.py:2278 v8_transforms):
    Mosaic → CopyPaste → RandomPerspective → MixUp → Albumentations-style
    pixel extras (blur/median/gray/CLAHE at p=0.01) → HSV → flips → BGR,
    then normalized-xywh label formatting. CopyPaste follows the reference's
    two modes: 'flip' pastes mirrored segments of the same image before the
    affine; 'mixup' pastes segments from an independently mosaic+affine'd
    donor image after the affine (v8_transforms wiring, augment.py:2313)."""

    def __init__(self, imgsz=640, hyp=None):
        hyp = hyp or {}
        self.imgsz = imgsz
        self.mosaic = hyp.get("mosaic", 1.0)
        self.mixup = hyp.get("mixup", 0.0)
        self.copy_paste = hyp.get("copy_paste", 0.0)
        self.copy_paste_mode = hyp.get("copy_paste_mode", "flip")
        self.degrees = hyp.get("degrees", 0.0)
        self.translate = hyp.get("translate", 0.1)
        self.scale = hyp.get("scale", 0.5)
        self.shear = hyp.get("shear", 0.0)
        self.perspective = hyp.get("perspective", 0.0)
        self.hsv_h = hyp.get("hsv_h", 0.015)
        self.hsv_s = hyp.get("hsv_s", 0.7)
        self.hsv_v = hyp.get("hsv_v", 0.4)
        self.fliplr = hyp.get("fliplr", 0.5)
        self.flipud = hyp.get("flipud", 0.0)
        self.bgr = hyp.get("bgr", 0.0)
        self.erasing = hyp.get("erasing", 0.0)
        self.flip_idx = hyp.get("flip_idx")
        self.mosaic_enabled = True

    def close_mosaic(self):
        self.mosaic_enabled = False

    def _geometry(self, dataset, index, rng, with_copy_paste: bool):
        """Mosaic (or letterbox) + optional flip-mode CopyPaste + affine."""
        use_mosaic = self.mosaic_enabled and self.mosaic > 0 and rng.random() < self.mosaic
        if use_mosaic:
            idxs = [index] + list(rng.integers(0, len(dataset), 3))
            items = [dataset.load_resized(i, self.imgsz) for i in idxs]
            img, labels = mosaic4(items, self.imgsz, rng)
            border = (-self.imgsz // 2, -self.imgsz // 2)
        else:
            img, labels = dataset.load_resized(index, self.imgsz)
            img, gain, pad = letterbox(img, (self.imgsz, self.imgsz))
            labels = {**labels, "boxes": apply_letterbox_to_boxes(labels["boxes"], gain, pad)}
            if labels.get("segments"):
                labels["segments"] = [s * gain + np.asarray(pad, np.float32) for s in labels["segments"]]
            if "keypoints" in labels and len(labels["keypoints"]):
                kp = labels["keypoints"].copy()
                kp[..., 0] = kp[..., 0] * gain + pad[0]
                kp[..., 1] = kp[..., 1] * gain + pad[1]
                labels["keypoints"] = kp
            border = (0, 0)
        if with_copy_paste and self.copy_paste > 0 and self.copy_paste_mode == "flip":
            img, labels = copy_paste(img, labels, rng, p=self.copy_paste, mode="flip")
        img, labels = random_perspective(
            img, labels, rng,
            degrees=self.degrees, translate=self.translate, scale=self.scale,
            shear=self.shear, perspective=self.perspective, border=border,
        )
        return img, labels, use_mosaic

    def __call__(self, dataset, index, rng: np.random.Generator):
        img, labels, use_mosaic = self._geometry(dataset, index, rng, with_copy_paste=True)
        if self.copy_paste > 0 and self.copy_paste_mode == "mixup":
            j = int(rng.integers(0, len(dataset)))
            donor_img, donor_labels, _ = self._geometry(dataset, j, rng, with_copy_paste=False)
            img, labels = copy_paste(
                img, labels, rng, p=self.copy_paste, mode="mixup", donor=(donor_img, donor_labels)
            )
        if use_mosaic and self.mixup > 0 and rng.random() < self.mixup:
            j = int(rng.integers(0, len(dataset)))
            img2, labels2, _ = self._geometry(dataset, j, rng, with_copy_paste=True)
            img, labels = mixup(img, labels, img2, labels2, rng)
        img = albumentations_extras(img, rng, p=0.01)
        img = random_hsv(img, rng, self.hsv_h, self.hsv_s, self.hsv_v)
        img, labels = random_flip(img, labels, rng, fliplr=self.fliplr, flipud=self.flipud,
                                  flip_idx=self.flip_idx)
        if self.bgr > 0 and rng.random() < self.bgr:
            img = np.ascontiguousarray(img[:, :, ::-1])  # RGB→BGR channel augmentation
        img = random_erasing(img, rng, self.erasing)
        return img, labels


class ValTransforms:
    """Letterbox-only eval path (reference dataset.py build_transforms, augment off)."""

    def __init__(self, imgsz=640):
        self.imgsz = imgsz

    def __call__(self, dataset, index, rng=None):
        img, labels = dataset.load_resized(index, self.imgsz)
        h_pre, w_pre = img.shape[:2]
        img, gain, pad = letterbox(img, (self.imgsz, self.imgsz), scaleup=False)
        labels = {**labels, "boxes": apply_letterbox_to_boxes(labels["boxes"], gain, pad),
                  "ratio_pad": (gain, pad)}
        # task side channels follow the same affine
        if "segments" in labels:
            labels["segments"] = [p * gain + np.asarray(pad, np.float32) for p in labels["segments"]]
        if "keypoints" in labels and len(labels["keypoints"]):
            kp = labels["keypoints"].copy()
            kp[..., 0] = kp[..., 0] * gain + pad[0]
            kp[..., 1] = kp[..., 1] * gain + pad[1]
            labels["keypoints"] = kp
        if "rboxes" in labels and len(labels["rboxes"]):
            rb = labels["rboxes"].copy()  # normalized xywhr on the source img
            rb[:, 0] = (rb[:, 0] * w_pre * gain + pad[0]) / self.imgsz
            rb[:, 1] = (rb[:, 1] * h_pre * gain + pad[1]) / self.imgsz
            rb[:, 2] = rb[:, 2] * w_pre * gain / self.imgsz
            rb[:, 3] = rb[:, 3] * h_pre * gain / self.imgsz
            labels["rboxes"] = rb
        return img, labels
