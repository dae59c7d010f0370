"""uint8 frames → boxes: a minimal detection predictor.

Follows the u8 lane of yolo_dbl_tpu/engine/predictor.py
(`_infer_from_u8`, `_call_device_preprocess`, `_rescale_boxes`, :400-453):
frames of one size go to the model's device as uint8, the K1 kernel
letterboxes and normalizes them (scaleup=False), the model predicts, NMS
keeps the boxes, and the boxes are mapped back to the source frame by the
letterbox gain and padding. `Results` objects, plotting and tracking are
not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..kernels.preprocess import letterbox_geometry, letterbox_normalize
from ..ops.nms import non_max_suppression


class DetectionPredictor:
    """Runs a DetectionModel on batches of uint8 (B, H, W, 3) frames."""

    def __init__(self, model, conf: float = 0.25, iou: float = 0.45, max_det: int = 300,
                 imgsz: int = 640):
        self.model = model
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.imgsz = imgsz

    @torch.inference_mode()
    def infer(self, frames_u8: torch.Tensor):
        """Device-side pass: (B, H, W, 3) uint8 on the model's device → NMS
        output (dets (B, max_det, 6), counts (B,)) in letterboxed pixels."""
        # K1 writes the model's type. JAX's predictor hands flax the float32
        # canvas and flax rounds it to bfloat16 (predictor.py:400-405); K1's
        # bfloat16 output is its float32 value rounded once, the same bits.
        img = letterbox_normalize(frames_u8, (self.imgsz, self.imgsz), scaleup=False,
                                  out_dtype=self.model.dtype)
        pred = self.model.predict(img)
        # the decode's type goes to NMS, as in JAX (predictor.py:459-464)
        return non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det)

    def __call__(self, frames) -> List[np.ndarray]:
        """Frames of one size → per-image (n, 6) float64 arrays
        [x1, y1, x2, y2, conf, cls] in source-frame pixels."""
        frames = torch.as_tensor(frames)
        if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
            raise ValueError(f"expected uint8 (B, H, W, 3) frames, got {frames.dtype} "
                             f"{tuple(frames.shape)}")
        h, w = frames.shape[1:3]
        gain, _, _, top, left = letterbox_geometry(h, w, self.imgsz, self.imgsz, scaleup=False)
        dets, counts = self.infer(frames.to(self.model.device).contiguous())
        dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
        return [self._rescale_boxes(dets[i, : int(counts[i])], gain, (float(left), float(top)),
                                    (h, w)) for i in range(len(dets))]

    @staticmethod
    def _rescale_boxes(d, gain, pad, shape):
        """Letterboxed xyxy → source-frame pixels, clipped (predictor.py:446)."""
        d = np.asarray(d, dtype=np.float64).copy()
        d[:, [0, 2]] = (d[:, [0, 2]] - pad[0]) / gain
        d[:, [1, 3]] = (d[:, [1, 3]] - pad[1]) / gain
        h, w = shape
        d[:, [0, 2]] = d[:, [0, 2]].clip(0, w)
        d[:, [1, 3]] = d[:, [1, 3]].clip(0, h)
        return d
