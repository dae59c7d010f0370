"""Predictors and their `Results` (port of yolo_dbl_tpu/engine/predictor.py:
`Boxes` :27, `Masks` :71, `Keypoints` :101, `Probs` :117, `OBB` :142,
`Results` :183, `_load_source` :334, `BasePredictor` :354, the detect,
segment, pose, obb and classify predictors :456-597).

`predict(source)` (JAX's `predictor(variables, source)`) makes one `Results`
per image of a source: a path or directory of images, a list of RGB frames,
or one frame. `predictor(frames)` is the device lane alone on a (B, H, W, 3)
uint8 batch of one size, returning per-image arrays of rows. uint8 frames take the device lane
(`device_preprocess=True`, :424-443): they are bucketed by frame size, each
bucket is sent to the model's device in chunks of `batch_size` as uint8, and
the K1 kernel letterboxes and normalizes a chunk there (scaleup=False) before
the forward. Other sources take the host lane (:412-422): `data/augment.py`
`letterbox` on the host, /255, then the forward. `classes` zeroes the scores
of the other classes before NMS (`ops.nms.mask_classes`, :386), `agnostic_nms`
suppresses across classes, and the boxes are mapped back to each source
frame by its letterbox gain and padding.

`SegmentationPredictor` gathers the kept rows' mask coefficients by the
anchor index NMS returns and makes their masks on the device: at prototype
resolution (`decode_masks`), resized bilinearly to the letterboxed input,
the padding cut off, resized to the frame, > 0.5 (JAX does the two resizes
with cv2's INTER_LINEAR on the host, :489-507). `PosePredictor` gathers the
decoded keypoints (visibility sigmoided) and un-letterboxes them;
`OBBPredictor` keeps rotated rows by the rotated NMS and maps their centres
and sizes back to the frame (`Results.obb`; the angle unchanged, the rows
not clipped); `ClassificationPredictor` gives each frame's class
probabilities of its letterboxed canvas (JAX's letterbox, not a centre crop).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels.preprocess import letterbox_geometry, letterbox_normalize
from ..nn.heads import decode_masks
from ..ops.nms import mask_classes, non_max_suppression, non_max_suppression_rotated


@dataclass
class Boxes:
    """Detection boxes: data (n, 6) [x1, y1, x2, y2, conf, cls], or (n, 7)
    with a track id before conf."""

    data: np.ndarray

    @property
    def is_track(self):
        return self.data.shape[-1] == 7

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def id(self):
        return self.data[:, 4] if self.is_track else None

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.stack(
            [(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1
        )

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Boxes(self.data[idx].reshape(-1, self.data.shape[-1]))


@dataclass
class Masks:
    """Instance masks at the source frame's resolution: data (n, H, W) bool."""

    data: np.ndarray

    @property
    def xy(self) -> List[np.ndarray]:
        """Each instance's largest external contour, (m, 2) float32 pixels."""
        import cv2

        out = []
        for m in self.data.astype(np.uint8):
            contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            if contours:
                c = max(contours, key=cv2.contourArea).reshape(-1, 2).astype(np.float32)
            else:
                c = np.zeros((0, 2), np.float32)
            out.append(c)
        return out

    @property
    def xyn(self) -> List[np.ndarray]:
        h, w = self.data.shape[1:]
        return [p / np.array([w, h], np.float32) for p in self.xy]

    def __len__(self):
        return len(self.data)


@dataclass
class Keypoints:
    """Keypoints in source-frame pixels: data (n, K, 3) x, y, visibility."""

    data: np.ndarray

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def conf(self):
        return self.data[..., 2]

    def __len__(self):
        return len(self.data)


@dataclass
class Probs:
    """Class probabilities of one image: data (nc,)."""

    data: np.ndarray

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> List[int]:
        return self.data.argsort()[::-1][:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())

    @property
    def top5conf(self):
        return np.sort(self.data)[::-1][:5]


@dataclass
class OBB:
    """Rotated boxes in source-frame pixels: data (n, 7) [cx, cy, w, h,
    angle (radians), conf, cls]."""

    data: np.ndarray

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, 5]

    @property
    def cls(self):
        return self.data[:, 6]

    @property
    def xyxyxyxy(self):
        """(n, 4, 2) corners: centre ± the half-width and half-height
        vectors (+ +, - +, - -, + -)."""
        cx, cy, w, h, a = (self.data[:, i] for i in range(5))
        cos, sin = np.cos(a), np.sin(a)
        c = np.stack([cx, cy], -1)[:, None]
        d1 = np.stack([(w / 2) * cos, (w / 2) * sin], -1)[:, None]
        d2 = np.stack([-(h / 2) * sin, (h / 2) * cos], -1)[:, None]
        return np.concatenate([c + d1 + d2, c - d1 + d2, c - d1 - d2, c + d1 - d2], axis=1)

    @property
    def xyxy(self):
        """The rotated boxes' axis-aligned envelopes (n, 4)."""
        pts = self.xyxyxyxy
        return np.concatenate([pts.min(1), pts.max(1)], axis=1)

    def __len__(self):
        return len(self.data)


@dataclass
class Results:
    """The result of one image, in its own pixels: boxes, and the masks or
    keypoints of the same rows, or rotated boxes, or a classifier's
    probabilities."""

    boxes: Optional[Boxes]
    orig_shape: tuple
    path: Optional[str] = None
    names: Dict[int, str] = field(default_factory=dict)
    masks: Optional[Masks] = None
    keypoints: Optional[Keypoints] = None
    probs: Optional[Probs] = None
    obb: Optional[OBB] = None
    orig_img: Optional[np.ndarray] = None

    def __len__(self):
        for attr in (self.boxes, self.obb, self.masks, self.keypoints):
            if attr is not None:
                return len(attr)
        return 0

    def to_json_dicts(self) -> List[Dict]:
        if self.probs is not None:
            return [{"name": self.names.get(self.probs.top1, str(self.probs.top1)),
                     "class": self.probs.top1, "confidence": self.probs.top1conf}]
        if self.obb is not None:
            return [{"name": self.names.get(int(row[6]), str(int(row[6]))), "class": int(row[6]),
                     "confidence": float(row[5]),
                     "box": {"x": float(row[0]), "y": float(row[1]), "w": float(row[2]),
                             "h": float(row[3]), "angle": float(row[4])}}
                    for row in self.obb.data]
        out = []
        segs = self.masks.xy if self.masks is not None else []
        for i, row in enumerate(self.boxes.data):
            rec = {
                "name": self.names.get(int(row[-1]), str(int(row[-1]))),
                "class": int(row[-1]),
                "confidence": float(row[-2]),
                "box": {"x1": float(row[0]), "y1": float(row[1]), "x2": float(row[2]), "y2": float(row[3])},
            }
            if self.boxes.is_track:
                rec["track_id"] = int(row[4])
            if i < len(segs):
                rec["segments"] = segs[i].tolist()
            if self.keypoints is not None and i < len(self.keypoints):
                rec["keypoints"] = self.keypoints.data[i].tolist()
            out.append(rec)
        return out

    def verbose(self) -> str:
        """A summary such as '2 0s, 1 1' (count and class name), or a
        classifier's top 5 with their probabilities."""
        if self.probs is not None:
            return ", ".join(f"{self.names.get(i, i)} {self.probs.data[i]:.2f}"
                             for i in self.probs.top5)
        src = self.obb if self.obb is not None else self.boxes
        if src is None or len(src) == 0:
            return "(no detections)"
        counts: Dict[str, int] = {}
        for c in src.cls:
            name = self.names.get(int(c), str(int(c)))
            counts[name] = counts.get(name, 0) + 1
        return ", ".join(f"{n} {k}{'s' if n > 1 else ''}" for k, n in counts.items())

    def save_txt(self, path, save_conf: bool = True):
        """YOLO-format rows: class, normalized xywh, and conf; rotated boxes
        as class and their 4 normalized corners (DOTA style), and conf; a
        classifier's top 5 as 'probability name'."""
        h, w = self.orig_shape
        lines = []
        if self.probs is not None:
            lines = [f"{self.probs.data[i]:.2f} {self.names.get(i, i)}" for i in self.probs.top5]
        elif self.obb is not None:
            for row, pts in zip(self.obb.data, self.obb.xyxyxyxy / np.array([w, h])):
                coords = " ".join(f"{v:.6f}" for v in pts.reshape(-1))
                lines.append(f"{int(row[6])} {coords}" + (f" {row[5]:.6f}" if save_conf else ""))
        else:
            for row in self.boxes.data:
                x1, y1, x2, y2 = row[:4]
                xywhn = ((x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h)
                line = f"{int(row[-1])} " + " ".join(f"{v:.6f}" for v in xywhn)
                if save_conf:
                    line += f" {row[-2]:.6f}"
                lines.append(line)
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))
        return path

    def save_crop(self, save_dir, file_name: Optional[str] = None):
        """Each detection's crop as save_dir/<class name>/<stem>_<i>.jpg."""
        import cv2

        if self.orig_img is None or self.boxes is None:
            return []
        stem = Path(file_name or self.path or "im").stem
        saved = []
        h, w = self.orig_shape
        segs = self.masks.xy if self.masks is not None else []
        for i, row in enumerate(self.boxes.data):
            x1, y1, x2, y2 = (int(np.clip(v, 0, lim)) for v, lim in
                              zip(row[:4], (w, h, w, h)))
            if x2 <= x1 or y2 <= y1:
                continue
            name = self.names.get(int(row[-1]), str(int(row[-1])))
            d = Path(save_dir) / name
            d.mkdir(parents=True, exist_ok=True)
            out = d / f"{stem}_{i}.jpg"
            cv2.imwrite(str(out), cv2.cvtColor(self.orig_img[y1:y2, x1:x2], cv2.COLOR_RGB2BGR))
            saved.append(out)
        return saved

    def plot(self, img: Optional[np.ndarray] = None, color=(255, 64, 64), kpt_radius: int = 3):
        """The result drawn on a copy of the image: masks blended in, boxes
        and labels, keypoints of visibility > 0.25, rotated boxes as
        polygons with labels, or the top-1 class."""
        import cv2

        if img is None:
            img = self.orig_img
        canvas = img.copy() if img is not None else np.zeros((*self.orig_shape, 3), np.uint8)
        if self.probs is not None:
            label = f"{self.names.get(self.probs.top1, self.probs.top1)} {self.probs.top1conf:.2f}"
            cv2.putText(canvas, label, (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.7, color, 2)
            return canvas
        if self.masks is not None and len(self.masks):
            overlay = canvas.copy()
            for j, m in enumerate(self.masks.data):
                cc = tuple(int(v) for v in np.array(color) * (0.5 + 0.5 * ((j % 3) / 2)))
                overlay[m.astype(bool)] = cc
            canvas = cv2.addWeighted(canvas, 0.6, overlay, 0.4, 0)
        if self.obb is not None:
            for row, pts in zip(self.obb.data, self.obb.xyxyxyxy):
                cv2.polylines(canvas, [pts.astype(np.int32)], True, color, 2)
                label = f"{self.names.get(int(row[6]), int(row[6]))} {row[5]:.2f}"
                cv2.putText(canvas, label, (int(pts[0, 0]), max(int(pts[0, 1]) - 4, 12)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
            return canvas
        if self.boxes is not None:
            for row in self.boxes.data:
                x1, y1, x2, y2 = (int(v) for v in row[:4])
                cv2.rectangle(canvas, (x1, y1), (x2, y2), color, 2)
                label = f"{self.names.get(int(row[-1]), int(row[-1]))} {row[-2]:.2f}"
                if self.boxes.is_track:
                    label = f"id:{int(row[4])} " + label
                cv2.putText(canvas, label, (x1, max(y1 - 4, 12)), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                            color, 1)
        if self.keypoints is not None:
            for kp in self.keypoints.data:
                for x, y, c in kp:
                    if c > 0.25:
                        cv2.circle(canvas, (int(x), int(y)), kpt_radius, color, -1)
        return canvas


def refuse_rtdetr(model, what: str):
    """Raise for an RT-DETR model: the JAX package's predictor and validator
    hand `rtdetr_postprocess`'s sorted (B, Q, 6) rows to NMS as if they were
    a (B, 4+nc, A) decode, which keeps rows that are none of the decode's
    (ROADMAP Queue 3). The port refuses rather than mirror it;
    `DetectionModel.predict` serves RT-DETR's rows."""
    if getattr(model, "head_name", None) == "RTDETRDecoder":
        raise NotImplementedError(
            f"RT-DETR has no {what} in the port: the JAX package's runs NMS over "
            "rtdetr_postprocess's (B, Q, 6) rows as a (B, 4+nc, A) decode (ROADMAP Queue 3); "
            "DetectionModel.predict returns RT-DETR's rows")


def _load_source(source):
    """A predict source as ([RGB images], [paths])."""
    import cv2

    if isinstance(source, (str, Path)):
        p = Path(source)
        paths = sorted(p.glob("*")) if p.is_dir() else [p]
        imgs, names = [], []
        for f in paths:
            im = cv2.imread(str(f))
            if im is not None:
                imgs.append(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
                names.append(str(f))
        return imgs, names
    if isinstance(source, np.ndarray):
        return [source], [None]
    src = list(source)
    return src, [None] * len(src)


class BasePredictor:
    """Batching, the two preprocessing lanes and the box rescale shared by
    the task predictors; `infer_images` and `build_result` are the task's."""

    def __init__(self, model, conf: float = 0.25, iou: float = 0.45, max_det: int = 300,
                 imgsz: int = 640, device_preprocess: bool = True, agnostic_nms: bool = False,
                 classes=None):
        refuse_rtdetr(model, "predictor")
        self.model = model
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.imgsz = imgsz
        self.agnostic_nms = bool(agnostic_nms)
        if classes is None:
            self.classes = None
        else:
            self.classes = tuple(int(c) for c in (classes if isinstance(classes, (list, tuple)) else [classes]))
        self.device_preprocess = device_preprocess

    kpt_shape = None

    @torch.inference_mode()
    def infer_images(self, img: torch.Tensor):
        """Letterboxed images → `DetectionModel.kept_rows` on the device: the
        kept rows and their coefficients and prototypes, or their keypoints
        (the detect and classify predictors override it)."""
        return self.model.kept_rows(img, self.conf, self.iou, self.max_det, self.agnostic_nms,
                                    self.classes, self.kpt_shape)

    @torch.inference_mode()
    def infer(self, frames_u8: torch.Tensor):
        """(B, H, W, 3) uint8 frames on the model's device → `infer_images`
        of their letterboxed canvas. K1 writes the model's type: JAX hands flax the
        float32 canvas and flax rounds it to bfloat16 (:400-405), and K1's
        bfloat16 output is its float32 value rounded once, the same bits."""
        img = letterbox_normalize(frames_u8, (self.imgsz, self.imgsz), scaleup=False,
                                  out_dtype=self.model.dtype)
        return self.infer_images(img)

    def _to_host(self, out, geometry):
        """The device outputs of a chunk as host arrays; `geometry` holds each
        image's (gain, (left, top) padding, frame (h, w)) for the tasks whose
        outputs are made at the frame's size on the device."""
        return [t.cpu().numpy() for t in out]

    def _infer_frames(self, frames):
        """uint8 frames of one size through the device lane: (host outputs,
        gain, (left, top) padding)."""
        frames = torch.as_tensor(frames)
        if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
            raise ValueError(f"expected uint8 (B, H, W, 3) frames, got {frames.dtype} "
                             f"{tuple(frames.shape)}")
        h, w = frames.shape[1:3]
        gain, _, _, top, left = letterbox_geometry(h, w, self.imgsz, self.imgsz, scaleup=False)
        out = self.infer(frames.to(self.model.device).contiguous())
        pad = (float(left), float(top))
        return self._to_host(out, [(gain, pad, (h, w))] * len(frames)), gain, pad

    def predict(self, source, batch_size: int = 16) -> List[Results]:
        """One `Results` per image of `source` (JAX's `__call__`, :407)."""
        images, paths = _load_source(source)
        if self.device_preprocess and all(
                im.dtype == np.uint8 and im.ndim == 3 for im in images):
            return self._call_device_preprocess(images, paths, batch_size)
        from ..data.augment import letterbox

        results: List[Results] = []
        for start in range(0, len(images), batch_size):
            chunk = images[start : start + batch_size]
            lb = [letterbox(im, (self.imgsz, self.imgsz), scaleup=False) for im in chunk]
            batch = np.stack([b[0] for b in lb]).astype(np.float32) / 255.0
            out = self._to_host(self.infer_images(torch.from_numpy(batch).to(self.model.device)),
                                [(g, pad, im.shape[:2]) for (_, g, pad), im in zip(lb, chunk)])
            for i, im in enumerate(chunk):
                results.append(self.build_result(out, i, im, lb[i][1], lb[i][2], paths[start + i]))
        return results

    def _call_device_preprocess(self, images, paths, batch_size: int) -> List[Results]:
        """Bucket the frames by (H, W); each chunk of a bucket goes to the
        device as uint8 and K1 letterboxes it there."""
        buckets: Dict[tuple, List[int]] = {}
        for i, im in enumerate(images):
            buckets.setdefault(im.shape[:2], []).append(i)
        by_idx: Dict[int, Results] = {}
        for idxs in buckets.values():
            for start in range(0, len(idxs), batch_size):
                ids = idxs[start : start + batch_size]
                out, gain, pad = self._infer_frames(np.stack([images[j] for j in ids]))
                for bi, j in enumerate(ids):
                    by_idx[j] = self.build_result(out, bi, images[j], gain, pad, paths[j])
        return [by_idx[i] for i in range(len(images))]

    @staticmethod
    def _rescale_boxes(d, gain, pad, shape):
        """Letterboxed xyxy → source-frame pixels, clipped (:446)."""
        d = np.asarray(d, dtype=np.float64).copy()
        d[:, [0, 2]] = (d[:, [0, 2]] - pad[0]) / gain
        d[:, [1, 3]] = (d[:, [1, 3]] - pad[1]) / gain
        h, w = shape
        d[:, [0, 2]] = d[:, [0, 2]].clip(0, w)
        d[:, [1, 3]] = d[:, [1, 3]].clip(0, h)
        return d


class DetectionPredictor(BasePredictor):
    """Decode, class mask and NMS on the device; `Results` on the host."""

    @torch.inference_mode()
    def infer_images(self, img: torch.Tensor):
        """Letterboxed images on the model's device → NMS output (dets
        (B, max_det, 6), counts (B,)) in letterboxed pixels. The decode's
        type goes to NMS, as in JAX (:459-464)."""
        pred = mask_classes(self.model.predict(img), self.classes, self.model.nc)
        return non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, class_agnostic=self.agnostic_nms)

    def __call__(self, frames) -> List[np.ndarray]:
        """The device lane alone: uint8 (B, H, W, 3) frames of one size →
        per-image (n, 6) float64 arrays [x1, y1, x2, y2, conf, cls] in
        source-frame pixels."""
        (dets, counts), gain, pad = self._infer_frames(frames)
        hw = tuple(frames.shape[1:3])
        return [self._rescale_boxes(dets[i, : int(counts[i])], gain, pad, hw)
                for i in range(len(dets))]

    def build_result(self, out, i, im, gain, pad, path):
        dets, num = out
        d = self._rescale_boxes(dets[i][: int(num[i])], gain, pad, im.shape[:2])
        return Results(Boxes(d), orig_shape=im.shape[:2], path=path,
                       names=self.model.names, orig_img=im)


def frame_masks(coeffs, protos, boxes, imgsz: int, pad, hw):
    """(k, H, W) bool masks in the source frame of k kept rows (:489-507):
    `decode_masks` at prototype resolution, bilinear to the letterboxed
    imgsz canvas, the (left, top) padding cut off both sides, bilinear to
    the frame's (h, w), > 0.5."""
    pm = decode_masks(coeffs, protos, boxes, (imgsz, imgsz)).float()
    if len(pm) == 0:
        return torch.zeros((0, *hw), dtype=torch.bool, device=pm.device)
    m = torch.nn.functional.interpolate(pm[None], size=(imgsz, imgsz), mode="bilinear",
                                        align_corners=False)[0]
    x0, y0 = int(round(pad[0])), int(round(pad[1]))
    m = m[:, y0:imgsz - y0 or imgsz, x0:imgsz - x0 or imgsz]
    return torch.nn.functional.interpolate(m[None], size=tuple(hw), mode="bilinear",
                                           align_corners=False)[0] > 0.5


class SegmentationPredictor(BasePredictor):
    """Boxes and their instance masks (:473)."""

    @torch.inference_mode()
    def _to_host(self, out, geometry):
        dets, num, kept, protos = out
        masks = [frame_masks(kept[i, :k], protos[i], dets[i, :k, :4], self.imgsz, pad, hw)
                 .cpu().numpy() for i, (k, (_, pad, hw)) in enumerate(zip(num.tolist(), geometry))]
        return dets.cpu().numpy(), num.cpu().numpy(), masks

    def __call__(self, frames) -> List[tuple]:
        """The device lane alone: uint8 (B, H, W, 3) frames of one size →
        per image ((n, 6) float64 rows in frame pixels, (n, H, W) bool masks)."""
        (dets, counts, masks), gain, pad = self._infer_frames(frames)
        hw = tuple(frames.shape[1:3])
        return [(self._rescale_boxes(dets[i, : int(counts[i])], gain, pad, hw), masks[i])
                for i in range(len(dets))]

    def build_result(self, out, i, im, gain, pad, path):
        dets, num, masks = out
        d = self._rescale_boxes(dets[i][: int(num[i])], gain, pad, im.shape[:2])
        return Results(Boxes(d), orig_shape=im.shape[:2], path=path, names=self.model.names,
                       masks=Masks(masks[i]), orig_img=im)


class PosePredictor(BasePredictor):
    """Boxes and their keypoints (:516); `kpt_shape` defaults to the head's."""

    def __init__(self, model, kpt_shape=None, **kw):
        super().__init__(model, **kw)
        self.kpt_shape = tuple(kpt_shape or model.detect.kpt_shape)

    @staticmethod
    def _frame_keypoints(kept, gain, pad):
        """Letterboxed keypoints → frame pixels (n, K, 3); without a
        visibility channel, visibility 1."""
        kp = np.asarray(kept, np.float64).copy()
        kp[..., 0] = (kp[..., 0] - pad[0]) / gain
        kp[..., 1] = (kp[..., 1] - pad[1]) / gain
        if kp.shape[-1] == 2:
            kp = np.concatenate([kp, np.ones((*kp.shape[:-1], 1))], -1)
        return kp

    def __call__(self, frames) -> List[tuple]:
        """The device lane alone: uint8 (B, H, W, 3) frames of one size →
        per image ((n, 6) float64 rows, (n, K, 3) keypoints) in frame pixels."""
        (dets, counts, kept), gain, pad = self._infer_frames(frames)
        hw = tuple(frames.shape[1:3])
        return [(self._rescale_boxes(dets[i, : int(counts[i])], gain, pad, hw),
                 self._frame_keypoints(kept[i, : int(counts[i])], gain, pad))
                for i in range(len(dets))]

    def build_result(self, out, i, im, gain, pad, path):
        dets, num, kept = out
        k = int(num[i])
        return Results(Boxes(self._rescale_boxes(dets[i][:k], gain, pad, im.shape[:2])),
                       orig_shape=im.shape[:2], path=path, names=self.model.names,
                       keypoints=Keypoints(self._frame_keypoints(kept[i][:k], gain, pad)),
                       orig_img=im)


class OBBPredictor(BasePredictor):
    """Rotated boxes (:561): the rotated NMS on the device, the rows mapped
    back to the frame by the letterbox gain and padding."""

    @torch.inference_mode()
    def infer_images(self, img: torch.Tensor):
        """Letterboxed images → rotated NMS output (dets (B, max_det, 7),
        counts (B,)) in letterboxed pixels."""
        pred = mask_classes(self.model.predict(img), self.classes, self.model.nc)
        return non_max_suppression_rotated(pred, conf_thres=self.conf, iou_thres=self.iou,
                                           max_det=self.max_det, nc=self.model.nc)

    @staticmethod
    def _frame_rows(d, gain, pad):
        """Letterboxed [x, y, w, h, angle, conf, cls] rows → frame pixels,
        float64 (:571-574)."""
        d = np.asarray(d, np.float64).copy()
        d[:, 0] = (d[:, 0] - pad[0]) / gain
        d[:, 1] = (d[:, 1] - pad[1]) / gain
        d[:, 2:4] /= gain
        return d

    def __call__(self, frames) -> List[np.ndarray]:
        """The device lane alone: uint8 (B, H, W, 3) frames of one size →
        per-image (n, 7) float64 rows [x, y, w, h, angle, conf, cls] in
        frame pixels."""
        (dets, counts), gain, pad = self._infer_frames(frames)
        return [self._frame_rows(dets[i, : int(counts[i])], gain, pad) for i in range(len(dets))]

    def build_result(self, out, i, im, gain, pad, path):
        dets, num = out
        return Results(None, orig_shape=im.shape[:2], path=path, names=self.model.names,
                       obb=OBB(self._frame_rows(dets[i][: int(num[i])], gain, pad)), orig_img=im)


class ClassificationPredictor(BasePredictor):
    """Class probabilities (:581): the softmax of the Classify head."""

    @torch.inference_mode()
    def infer_images(self, img: torch.Tensor):
        return (self.model.predict(img),)

    def __call__(self, frames) -> np.ndarray:
        """The device lane alone: uint8 (B, H, W, 3) frames of one size →
        (B, nc) probabilities."""
        (probs,), _, _ = self._infer_frames(frames)
        return probs

    def build_result(self, out, i, im, gain, pad, path):
        return Results(None, orig_shape=im.shape[:2], path=path, names=self.model.names,
                       probs=Probs(np.asarray(out[0][i])), orig_img=im)


TASK_PREDICTORS = {"detect": DetectionPredictor, "segment": SegmentationPredictor,
                   "pose": PosePredictor, "obb": OBBPredictor,
                   "classify": ClassificationPredictor}
