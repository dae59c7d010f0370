"""Detection validation: inference and NMS on the model's device, metrics on
the host (port of yolo_dbl_tpu/engine/validator.py:26-118).

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
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..kernels.preprocess import device_normalize
from ..nn.tasks import DetectionModel
from ..ops.boxes import xywh2xyxy
from ..ops.nms import non_max_suppression
from ..utils.metrics import COCOEvaluator, DetMetrics


class DetectionValidator:
    """mAP50, mAP50-95, precision and recall (and the COCO 12 stats with
    `use_coco_stats`) of a DetectionModel over a loader (validator.py:26)."""

    def __init__(self, model: DetectionModel, conf: float = 0.001, iou: float = 0.7,
                 max_det: int = 300, use_coco_stats: bool = False, save_json: bool = False,
                 save_dir=None):
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

    def __call__(self, loader: Iterable[Dict], max_batches: Optional[int] = None) -> Dict:
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
            dets, num = self.infer(torch.as_tensor(batch["img"]).to(dev))
            dets, num = dets.cpu().numpy(), num.cpu().numpy()
            t1 = time.perf_counter()
            labels = batch.get("labels")
            imgsz = batch["img"].shape[1]
            for i in range(len(dets)):
                d = dets[i][: int(num[i])]
                if labels is not None:
                    gt_boxes, gt_cls = np.asarray(labels[i]["boxes"]), np.asarray(labels[i]["cls"])
                else:
                    m = np.asarray(batch["gt_mask"][i]).astype(bool)
                    gt_boxes = xywh2xyxy(torch.as_tensor(
                        np.asarray(batch["gt_boxes"][i])[m] * imgsz)).numpy()
                    gt_cls = np.asarray(batch["gt_cls"][i])[m]
                metrics.update(d, gt_boxes, gt_cls)
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
