"""Detection head and DFL decode (port of yolo_dbl_tpu/nn/heads.py).

`Detect` returns raw per-level NCHW maps; `decode_detections` takes the
JAX layout (per-level NHWC maps) and returns (B, 4+nc, A), channel-first,
as the JAX package does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.anchors import dist2bbox, make_anchors
from .common import Conv, Conv2d, DWConv


class Detect(nn.Module):
    """Anchor-free decoupled head (heads.py:24). The class branch is two 3x3
    Convs and a 1x1 Conv2d for v8 (`legacy=True`), or the DWConv branch of
    YOLO-DBL and YOLOv13 (`legacy=False`)."""

    def __init__(self, nc=80, ch=(), reg_max=16, legacy=False):
        super().__init__()
        self.nc, self.nl, self.reg_max, self.legacy = nc, len(ch), reg_max, legacy
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c1 in enumerate(ch):
            self.add_module(f"cv2_{i}_0", Conv(c1, c2, 3))
            self.add_module(f"cv2_{i}_1", Conv(c2, c2, 3))
            self.add_module(f"cv2_{i}_2", Conv2d(c2, 4 * reg_max, 1))
            if legacy:
                self.add_module(f"cv3_{i}_0", Conv(c1, c3, 3))
                self.add_module(f"cv3_{i}_1", Conv(c3, c3, 3))
            else:
                self.add_module(f"cv3_{i}_0_0", DWConv(c1, c1, 3))
                self.add_module(f"cv3_{i}_0_1", Conv(c1, c3, 1))
                self.add_module(f"cv3_{i}_1_0", DWConv(c3, c3, 3))
                self.add_module(f"cv3_{i}_1_1", Conv(c3, c3, 1))
            self.add_module(f"cv3_{i}_2", Conv2d(c3, nc, 1))

    def forward(self, xs):
        cls_names = (("cv3_{}_0", "cv3_{}_1", "cv3_{}_2") if self.legacy else
                     ("cv3_{}_0_0", "cv3_{}_0_1", "cv3_{}_1_0", "cv3_{}_1_1", "cv3_{}_2"))
        outs = []
        for i, x in enumerate(xs):
            box = x
            for name in ("cv2_{}_0", "cv2_{}_1", "cv2_{}_2"):
                box = getattr(self, name.format(i))(box)
            cls = x
            for name in cls_names:
                cls = getattr(self, name.format(i))(cls)
            outs.append(torch.cat([box, cls], 1))
        return outs


def dfl_expectation(box_logits, reg_max=16):
    """E[softmax(bins)] per side: (..., A, 4*reg_max) → (..., A, 4) (heads.py:229)."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    proj = torch.arange(reg_max, dtype=x.dtype, device=x.device)
    return (torch.softmax(x, dim=-1) * proj).sum(-1)


def flatten_levels(feats):
    """Per-level NHWC maps → (B, A, C), concatenated over levels (heads.py:308)."""
    b = feats[0].shape[0]
    return torch.cat([f.reshape(b, -1, f.shape[-1]) for f in feats], dim=1)


def decode_detections(feats, strides, nc, reg_max=16):
    """Raw NHWC Detect maps → (B, 4+nc, A) xywh + sigmoid scores in input
    pixels (heads.py:314), in the maps' type: float32 anchors and strides
    cast to it, as the JAX decode does."""
    shapes = [f.shape[1:3] for f in feats]
    x = flatten_levels(feats)
    anchors, stride_t = make_anchors(shapes, strides, device=x.device)
    box_logits, cls_logits = x[..., : 4 * reg_max], x[..., 4 * reg_max:]
    dist = dfl_expectation(box_logits, reg_max)
    dbox = dist2bbox(dist, anchors[None].to(dist.dtype)) * stride_t[None].to(dist.dtype)
    return torch.cat([dbox, torch.sigmoid(cls_logits)], dim=-1).transpose(-1, -2)
