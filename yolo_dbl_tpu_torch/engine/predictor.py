"""Detection predictor and its `Results` (port of the detect parts of
yolo_dbl_tpu/engine/predictor.py: `Boxes` :27, `Results` :183, `_load_source`
:334, `BasePredictor` :354, `DetectionPredictor` :456).

`predict(source)` (JAX's `predictor(variables, source)`) makes one `Results`
per image of a source: a path or directory of images, a list of RGB frames,
or one frame. `predictor(frames)` is the device lane alone on a (B, H, W, 3)
uint8 batch of one size, returning per-image arrays of rows. uint8 frames take the device lane
(`device_preprocess=True`, :424-443): they are bucketed by frame size, each
bucket is sent to the model's device in chunks of `batch_size` as uint8, and
the K1 kernel letterboxes and normalizes a chunk there (scaleup=False) before
the forward. Other sources take the host lane (:412-422): `data/augment.py`
`letterbox` on the host, /255, then the forward. `classes` zeroes the scores
of the other classes before NMS (`_mask_classes`, :386), `agnostic_nms`
suppresses across classes, and the boxes are mapped back to each source
frame by its letterbox gain and padding. `Masks`, `Keypoints`, `Probs`,
`OBB` and the task predictors come with their heads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels.preprocess import letterbox_geometry, letterbox_normalize
from ..ops.nms import non_max_suppression


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
class Results:
    """The detections of one image, in its own pixels."""

    boxes: Boxes
    orig_shape: tuple
    path: Optional[str] = None
    names: Dict[int, str] = field(default_factory=dict)
    orig_img: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.boxes)

    def to_json_dicts(self) -> List[Dict]:
        out = []
        for row in self.boxes.data:
            rec = {
                "name": self.names.get(int(row[-1]), str(int(row[-1]))),
                "class": int(row[-1]),
                "confidence": float(row[-2]),
                "box": {"x1": float(row[0]), "y1": float(row[1]), "x2": float(row[2]), "y2": float(row[3])},
            }
            if self.boxes.is_track:
                rec["track_id"] = int(row[4])
            out.append(rec)
        return out

    def verbose(self) -> str:
        """A summary such as '2 0s, 1 1' (count and class name)."""
        if len(self.boxes) == 0:
            return "(no detections)"
        counts: Dict[str, int] = {}
        for c in self.boxes.cls:
            name = self.names.get(int(c), str(int(c)))
            counts[name] = counts.get(name, 0) + 1
        return ", ".join(f"{n} {k}{'s' if n > 1 else ''}" for k, n in counts.items())

    def save_txt(self, path, save_conf: bool = True):
        """YOLO-format rows: class, normalized xywh, and conf."""
        h, w = self.orig_shape
        lines = []
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

        if self.orig_img is None:
            return []
        stem = Path(file_name or self.path or "im").stem
        saved = []
        h, w = self.orig_shape
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

    def plot(self, img: Optional[np.ndarray] = None, color=(255, 64, 64)):
        """The detections drawn on a copy of the image."""
        import cv2

        if img is None:
            img = self.orig_img
        canvas = img.copy() if img is not None else np.zeros((*self.orig_shape, 3), np.uint8)
        for row in self.boxes.data:
            x1, y1, x2, y2 = (int(v) for v in row[:4])
            cv2.rectangle(canvas, (x1, y1), (x2, y2), color, 2)
            label = f"{self.names.get(int(row[-1]), int(row[-1]))} {row[-2]:.2f}"
            if self.boxes.is_track:
                label = f"id:{int(row[4])} " + label
            cv2.putText(canvas, label, (x1, max(y1 - 4, 12)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
        return canvas


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

    def infer_images(self, img: torch.Tensor):  # pragma: no cover - overridden
        raise NotImplementedError

    def _mask_classes(self, pred):
        """Zero the score channels of the classes not in `classes`: they can
        never pass conf_thres. pred: (B, 4+nc, A)."""
        if self.classes is None:
            return pred
        nc = self.model.nc
        keep = torch.zeros(nc, dtype=pred.dtype, device=pred.device)
        keep[list(self.classes)] = 1
        return torch.cat([pred[:, :4], pred[:, 4:4 + nc] * keep[None, :, None], pred[:, 4 + nc:]], 1)

    @torch.inference_mode()
    def infer(self, frames_u8: torch.Tensor):
        """(B, H, W, 3) uint8 frames on the model's device → `infer_images`
        of their letterboxed canvas. K1 writes the model's type: JAX hands flax the
        float32 canvas and flax rounds it to bfloat16 (:400-405), and K1's
        bfloat16 output is its float32 value rounded once, the same bits."""
        img = letterbox_normalize(frames_u8, (self.imgsz, self.imgsz), scaleup=False,
                                  out_dtype=self.model.dtype)
        return self.infer_images(img)

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
        return [t.cpu().numpy() for t in out], gain, (float(left), float(top))

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
            out = [t.cpu().numpy() for t in
                   self.infer_images(torch.from_numpy(batch).to(self.model.device))]
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
        pred = self._mask_classes(self.model.predict(img))
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
