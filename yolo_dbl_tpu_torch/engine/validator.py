"""Validation: inference and NMS on the model's device, metrics on the host
(port of yolo_dbl_tpu/engine/validator.py).

Each batch's uint8 images go to the model's device, where they are
normalized to the model's type (`device_normalize`), predicted and kept by
the fixed-shape NMS; the detections come back to the host, where
`DetMetrics`, the optional `COCOEvaluator` and the optional
`predictions.json` take them with the batch's ground truth. Batches are
consumed in order: the JAX validator consumes each one a batch behind its
dispatch, which gives the same results. The input is any iterable of batch
dicts (the port's `data.build.DataLoader`, or synthetic batches) holding
`img` and either `labels` (per-image `boxes` xyxy in pixels and `cls`) or
the `gt_boxes`/`gt_cls`/`gt_mask` arrays of the loss (normalized xywh). The
model decides the device: a model built with `device="cpu"` validates on the
CPU through the kernels' plain versions, and no model is built on a machine
without CUDA unless the caller asks for the CPU.

`SegmentationValidator` and `PoseValidator` (:126, :181) run the same loop
and score the box mAP and the mask or keypoint mAP (`TaskMetrics`) against
the batch arrays (`gt_boxes`, `gt_cls`, `gt_mask`, and `gt_masks` or
`gt_kpts`): `DetectionModel.kept_rows` keeps each row's anchor index and
gathers the kept rows' coefficients or decoded keypoints on the device, and the masks are decoded there at prototype
resolution (> 0.5); the mask IoU and the OKS (GT box area x 0.53) are
computed on the host. `OBBValidator` (:252) keeps rows by the rotated NMS
and scores the rotated boxes' axis-aligned extents [cx ± w/2, cy ± h/2]
as boxes and their probiou with the GT's rotated boxes as the task
affinity (`rbox_mAP50`, `rbox_mAP50-95`).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..kernels.preprocess import device_normalize
from ..losses.extra import probiou
from ..nn.heads import decode_masks
from ..nn.tasks import DetectionModel
from ..ops.boxes import xywh2xyxy
from ..ops.nms import non_max_suppression, non_max_suppression_rotated
from ..utils.metrics import COCOEvaluator, DetMetrics, TaskMetrics, kpt_oks_np, mask_iou_np
from .predictor import refuse_rtdetr


class DetectionValidator:
    """mAP50, mAP50-95, precision and recall (and the COCO 12 stats with
    `use_coco_stats`) of a DetectionModel over a loader (validator.py:26).
    The task validators below run the same loop: their `infer` also returns
    the kept rows' task outputs, and `_affinity` scores them per image."""

    task_key = ""  # TaskMetrics' name of the task mAP ("mask", "pose"); "" for boxes alone

    def __init__(self, model: DetectionModel, conf: float = 0.001, iou: float = 0.7,
                 max_det: int = 300, use_coco_stats: bool = False, save_json: bool = False,
                 save_dir=None):
        refuse_rtdetr(model, "validator")
        self.model = model
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.use_coco_stats = use_coco_stats
        self.save_json = save_json  # COCO result rows in predictions.json
        self.save_dir = save_dir

    @torch.inference_mode()
    def infer(self, img: torch.Tensor):
        """uint8 (or [0, 1] float) NHWC images on the model's device → NMS
        output: dets (B, max_det, 6) [x1, y1, x2, y2, conf, cls] and counts (B,)."""
        pred = self.model.predict(device_normalize(img, self.model.dtype))
        return non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det)

    @staticmethod
    def _box_rows(d):
        """An image's kept rows as [x1, y1, x2, y2, conf, cls] for the box metrics."""
        return d

    def _ground_truth(self, batch, i, imgsz):
        """Image i's GT: (mask over the batch's GT rows or None, xyxy boxes in
        pixels, classes), from `labels` where the batch has them."""
        labels = batch.get("labels")
        if labels is None:
            return _gt(batch, i, imgsz)
        return None, np.asarray(labels[i]["boxes"]), np.asarray(labels[i]["cls"])

    def __call__(self, loader: Iterable[Dict], max_batches: Optional[int] = None) -> Dict:
        if self.task_key:
            metrics = TaskMetrics(self.model.nc, self.model.names, task_key=self.task_key)
        else:
            metrics = DetMetrics(self.model.nc, self.model.names)
        coco = COCOEvaluator(self.model.nc) if self.use_coco_stats else None
        json_rows = [] if self.save_json else None
        speed = {"inference": 0.0, "postprocess": 0.0}
        n_images = 0
        dev = self.model.device
        for bi, batch in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            t0 = time.perf_counter()
            out = self.infer(torch.as_tensor(batch["img"]).to(dev))
            dets, num = out[0].cpu().numpy(), out[1].cpu().numpy()
            t1 = time.perf_counter()
            imgsz = batch["img"].shape[1]
            for i in range(len(dets)):
                k = int(num[i])
                d = self._box_rows(dets[i][:k])
                m, gt_boxes, gt_cls = self._ground_truth(batch, i, imgsz)
                metrics.update(d, gt_boxes, gt_cls)
                if self.task_key:
                    metrics.update_task(d, self._affinity(out, i, k, batch, m, gt_boxes, imgsz),
                                        gt_cls)
                if coco is not None:
                    coco.update(d, gt_boxes, gt_cls)
                if json_rows is not None:
                    # xyxy → ltwh in the letterboxed input space, where the mAP is computed
                    json_rows += [{"image_id": n_images, "category_id": int(row[5]),
                                   "bbox": [round(float(v), 3) for v in
                                            (row[0], row[1], row[2] - row[0], row[3] - row[1])],
                                   "score": round(float(row[4]), 5)} for row in d]
                n_images += 1
            speed["inference"] += t1 - t0
            speed["postprocess"] += time.perf_counter() - t1

        out = metrics.results()
        if coco is not None:
            out["coco_stats"] = coco.summarize()
        if json_rows is not None:
            save_dir = Path(self.save_dir or "runs/val")
            save_dir.mkdir(parents=True, exist_ok=True)
            (save_dir / "predictions.json").write_text(json.dumps(json_rows))
            out["predictions_json"] = str(save_dir / "predictions.json")
        out["speed_ms_per_image"] = {k: v / max(n_images, 1) * 1000 for k, v in speed.items()}
        out["images"] = n_images
        return out


def _gt(batch, i, imgsz):
    """Image i's GT rows of the batch arrays: (mask, xyxy boxes in pixels, classes)."""
    m = np.asarray(batch["gt_mask"][i]).astype(bool)
    boxes = xywh2xyxy(torch.as_tensor(np.asarray(batch["gt_boxes"][i])[m] * imgsz)).numpy()
    return m, boxes, np.asarray(batch["gt_cls"][i])[m]


class _TaskValidator(DetectionValidator):
    """The task validators' device half: `DetectionModel.kept_rows` of the
    normalized batch, and the GT of the batch arrays (as JAX, also where
    the batch has `labels`)."""

    kpt_shape = None

    @torch.inference_mode()
    def infer(self, img: torch.Tensor):
        """NHWC images on the model's device → `kept_rows`: (dets, counts,
        kept coefficients, prototypes) or (dets, counts, kept keypoints)."""
        return self.model.kept_rows(device_normalize(img, self.model.dtype), self.conf,
                                    self.iou, self.max_det, kpt_shape=self.kpt_shape)

    def _ground_truth(self, batch, i, imgsz):
        return _gt(batch, i, imgsz)


class SegmentationValidator(_TaskValidator):
    """Box and mask mAP (validator.py:126): the kept rows' masks at prototype
    resolution against the batch's `gt_masks` (the same resolution)."""

    task_key = "mask"

    def _affinity(self, out, i, k, batch, m, gt_boxes, imgsz):
        _, _, kept, protos = out
        pm = decode_masks(kept[i, :k], protos[i], out[0][i, :k, :4], (imgsz, imgsz)) > 0.5
        return mask_iou_np(np.asarray(batch["gt_masks"][i])[m].astype(bool), pm.cpu().numpy())


class PoseValidator(_TaskValidator):
    """Box and keypoint (OKS) mAP (validator.py:181): the kept rows'
    keypoints in input pixels against the batch's `gt_kpts`, with the GT
    box areas x 0.53 as OKS's scale. `kpt_shape` defaults to the head's."""

    task_key = "pose"

    def __init__(self, model: DetectionModel, conf: float = 0.001, iou: float = 0.7,
                 max_det: int = 300, kpt_shape=None):
        super().__init__(model, conf, iou, max_det)
        self.kpt_shape = tuple(kpt_shape or model.detect.kpt_shape)

    def _affinity(self, out, i, k, batch, m, gt_boxes, imgsz):
        gk = np.asarray(batch["gt_kpts"][i])[m].astype(np.float64).copy()
        gk[..., :2] *= imgsz
        area = np.clip((gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]),
                       1e-9, None) * 0.53
        return kpt_oks_np(gk, out[2][i, :k].float().cpu().numpy(), area)


def _extent(xywh):
    """[cx - w/2, cy - h/2, cx + w/2, cy + h/2] of (n, >= 4) numpy rows."""
    return np.concatenate([xywh[:, 0:1] - xywh[:, 2:3] / 2, xywh[:, 1:2] - xywh[:, 3:4] / 2,
                           xywh[:, 0:1] + xywh[:, 2:3] / 2, xywh[:, 1:2] + xywh[:, 3:4] / 2], 1)


def _gt_rboxes(batch, i, imgsz):
    """Image i's (mask, (n, 5) float64 rotated GT boxes in pixels, classes)."""
    m = np.asarray(batch["gt_mask"][i]).astype(bool)
    gt5 = np.asarray(batch["gt_boxes"][i])[m].astype(np.float64).copy()
    gt5[:, :4] *= imgsz
    return m, gt5, np.asarray(batch["gt_cls"][i])[m]


class OBBValidator(DetectionValidator):
    """Box and rotated-box (probiou) mAP (validator.py:252): the rotated NMS
    on the device; the box metrics take the kept rows' and the GT's
    axis-aligned extents, the task metrics the probiou of each GT with each
    kept row, in float32 (JAX's jnp arrays), on the host."""

    task_key = "rbox"

    @torch.inference_mode()
    def infer(self, img: torch.Tensor):
        """NHWC images on the model's device → rotated NMS output: dets
        (B, max_det, 7) [x, y, w, h, angle, conf, cls] and counts (B,)."""
        pred = self.model.predict(device_normalize(img, self.model.dtype))
        return non_max_suppression_rotated(pred, conf_thres=self.conf, iou_thres=self.iou,
                                           max_det=self.max_det, nc=self.model.nc)

    @staticmethod
    def _box_rows(d):
        return np.concatenate([_extent(d), d[:, 5:7]], 1)

    def _ground_truth(self, batch, i, imgsz):
        m, gt5, gt_cls = _gt_rboxes(batch, i, imgsz)
        return m, _extent(gt5), gt_cls

    def _affinity(self, out, i, k, batch, m, gt_boxes, imgsz):
        gt5 = _gt_rboxes(batch, i, imgsz)[1]
        if not (k and len(gt5)):
            return np.zeros((len(gt5), k))
        rows = out[0][i, :k, :5].float().cpu()
        return probiou(torch.as_tensor(gt5[:, None], dtype=torch.float32), rows[None]).numpy()
