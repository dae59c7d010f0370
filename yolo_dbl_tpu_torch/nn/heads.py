"""Detection heads and their decodes (port of yolo_dbl_tpu/nn/heads.py).

`Detect` returns raw per-level NCHW maps, `V10Detect` a dict of two such
lists (its one2many and one2one branches), `IDetect` (YOLOv7) raw NCHW maps
of na * (5 + nc) channels; `decode_detections` and `decode_v7` take the JAX
layout (per-level NHWC maps, IDetect's as (B, H, W, na, 5 + nc)) and return
(B, 4+nc, A), channel-first, as the JAX package does. `v10_postprocess` is
the NMS-free top-k selection of a decoded one2one output.

The task heads nest a Detect as `detect` and return tuples: `Segment`
(Detect maps, per-level mask coefficients, the prototypes of `Proto`),
`Pose` (Detect maps, per-level raw keypoint maps), `OBB` (Detect maps,
per-level angles); `Classify` returns (B, nc) logits. `decode_masks` turns
kept coefficients into box-cropped mask probabilities at prototype
resolution; `decode_obb` decodes an OBB head to rotated boxes.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.anchors import dist2bbox, dist2rbox, make_anchors
from ..ops.boxes import xywh2xyxy
from .common import Conv, Conv2d, DWConv, conv2d, linear


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


class V10Detect(nn.Module):
    """YOLOv10's NMS-free head (heads.py:60): two Detect(legacy=False)
    branches, `one2many` (trained with TAL top-10) and `one2one` (top-1, the
    one deployed). one2one reads detached features, as JAX's stop_gradient:
    its loss does not reach the trunk. Returns {"one2many": [...],
    "one2one": [...]} of raw NCHW maps."""

    def __init__(self, nc=80, ch=()):
        super().__init__()
        self.nc, self.nl = nc, len(ch)
        self.one2many = Detect(nc, ch, legacy=False)
        self.one2one = Detect(nc, ch, legacy=False)

    def forward(self, xs):
        return {"one2many": self.one2many(xs), "one2one": self.one2one([x.detach() for x in xs])}


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values, as lax.top_k orders them (torch.topk
    promises no order on ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def v10_postprocess(pred, max_det=300, nc=80):
    """NMS-free top-k selection (heads.py:83): a decoded one2one (B, 4+nc, A)
    → (B, max_det, 6) of xyxy box, score, class. The max_det anchors of
    highest best score, then the max_det (anchor, class) pairs of highest
    score among them."""
    pred = pred.transpose(-1, -2)
    boxes, scores = pred[..., :4], pred[..., 4:]
    k = min(max_det, scores.shape[1])
    _, idx = _top_k(scores.amax(-1), k)
    sel_boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    sel_scores = scores.gather(1, idx[..., None].expand(-1, -1, scores.shape[-1]))
    top, idx2 = _top_k(sel_scores.reshape(pred.shape[0], -1), k)
    anchor_idx = idx2 // scores.shape[-1]
    cls_idx = (idx2 % scores.shape[-1]).to(pred.dtype)
    final_boxes = sel_boxes.gather(1, anchor_idx[..., None].expand(-1, -1, 4))
    return torch.cat([xywh2xyxy(final_boxes), top[..., None], cls_idx[..., None]], -1)


class IDetect(nn.Module):
    """YOLOv7's anchor-based head with implicit knowledge (heads.py:243):
    per level, `m{i}`(x + `ia{i}`) * `im{i}`, a bare biased 1 x 1 conv to
    na * (5 + nc) channels. `ia{i}` (1, C, 1, 1) starts N(0, .02) and
    `im{i}` (1, na * (5 + nc), 1, 1) 1 + N(0, .02) (utils/convert.py maps
    JAX's (1, 1, 1, C)). Both are float32 parameters: a bfloat16 input is
    promoted by the add and the product, as in JAX, so the conv computes in
    the input's type and the maps come out float32. Returns raw NCHW maps."""

    def __init__(self, nc, anchors, ch):
        super().__init__()
        self.nc, self.nl = nc, len(ch)
        self.anchors = tuple(tuple(a) for a in anchors)
        self.na = len(self.anchors[0]) // 2
        no = self.na * (nc + 5)
        for i, c in enumerate(ch):
            self.register_parameter(f"ia{i}", nn.Parameter(torch.zeros(1, c, 1, 1)))
            self.register_parameter(f"im{i}", nn.Parameter(torch.ones(1, no, 1, 1)))
            self.add_module(f"m{i}", nn.Conv2d(c, no, 1, bias=True))

    def forward(self, xs):
        return [conv2d(getattr(self, f"m{i}"), (x + getattr(self, f"ia{i}")).to(x.dtype))
                * getattr(self, f"im{i}") for i, x in enumerate(xs)]


def decode_v7(feats, strides, anchors, nc):
    """IDetect maps (B, H, W, na, 5 + nc) → (B, 4+nc, A) in float32
    (heads.py:270): xy = (2σ - 0.5 + grid) * stride, wh = (2σ)² * anchor,
    score = σ(obj) * σ(cls)."""
    b = feats[0].shape[0]
    rows = []
    for x, s, anc in zip(feats, strides, anchors):
        _, h, w, na, _ = x.shape
        sig = torch.sigmoid(x.float())
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                                torch.arange(w, dtype=torch.float32, device=x.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
        awh = torch.tensor(anc, dtype=torch.float32, device=x.device).reshape(na, 2)
        xy = (sig[..., :2] * 2.0 - 0.5 + grid) * s
        wh = (sig[..., 2:4] * 2.0) ** 2 * awh
        score = sig[..., 5:] * sig[..., 4:5]
        rows.append(torch.cat([xy, wh, score], -1).reshape(b, -1, 4 + nc))
    return torch.cat(rows, 1).transpose(-1, -2)


class Proto(nn.Module):
    """Mask prototypes (heads.py:106): `cv1` Conv 3x3, `upsample` a biased
    2x2 stride-2 transposed conv, `cv2` Conv 3x3, `cv3` Conv 1x1 to c2
    prototypes. flax's raw `nn.ConvTranspose` with its default SAME padding
    is, at k = s = 2, (in - 1) * 2 + 2 = 2 in outputs with no crop, and puts
    kernel tap 1 - d at output offset d of each input pixel: torch's
    ConvTranspose2d with the kernel flipped in space, the rule
    utils/convert.py applies to every nn.ConvTranspose2d by type."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        up = self.upsample
        y = nn.functional.conv_transpose2d(y, up.weight.to(y.dtype), up.bias.to(y.dtype), 2)
        return self.cv3(self.cv2(y))


def _side_branch(head: nn.Module, ch, c4: int, c_out: int):
    """Register each level's `cv4_{i}_0`, `cv4_{i}_1` (Conv 3x3 to c4) and
    `cv4_{i}_2` (biased 1x1 Conv2d to c_out) on `head`."""
    for i, c1 in enumerate(ch):
        head.add_module(f"cv4_{i}_0", Conv(c1, c4, 3))
        head.add_module(f"cv4_{i}_1", Conv(c4, c4, 3))
        head.add_module(f"cv4_{i}_2", Conv2d(c4, c_out, 1))


def _run_side_branch(head: nn.Module, xs):
    return [getattr(head, f"cv4_{i}_2")(getattr(head, f"cv4_{i}_1")(getattr(head, f"cv4_{i}_0")(x)))
            for i, x in enumerate(xs)]


class Segment(nn.Module):
    """Segmentation head (heads.py:122): a nested `detect` Detect, `proto`
    on the first level, and per level nm mask coefficients through
    `cv4_{i}_*` (c4 = max(ch[0] // 4, nm)). Returns (Detect maps, coefficient
    maps, prototypes), NCHW."""

    def __init__(self, nc=80, nm=32, npr=256, ch=(), legacy=False):
        super().__init__()
        self.nc, self.nl, self.nm = nc, len(ch), nm
        self.detect = Detect(nc, ch, legacy=legacy)
        self.proto = Proto(ch[0], npr, nm)
        _side_branch(self, ch, max(ch[0] // 4, nm), nm)

    def forward(self, xs):
        return self.detect(xs), _run_side_branch(self, xs), self.proto(xs[0])


class Pose(nn.Module):
    """Keypoint head (heads.py:147): a nested `detect` Detect and per level
    nk = kpt_shape[0] * kpt_shape[1] raw channels through `cv4_{i}_*`
    (c4 = max(ch[0] // 4, nk)). Returns (Detect maps, keypoint maps), NCHW."""

    def __init__(self, nc=80, kpt_shape=(17, 3), ch=(), legacy=False):
        super().__init__()
        self.nc, self.nl, self.kpt_shape = nc, len(ch), tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.detect = Detect(nc, ch, legacy=legacy)
        _side_branch(self, ch, max(ch[0] // 4, nk), nk)

    def forward(self, xs):
        return self.detect(xs), _run_side_branch(self, xs)


class OBB(nn.Module):
    """Oriented-box head (heads.py:171): a nested `detect` Detect and per
    level ne angle channels through `cv4_{i}_*` (c4 = max(ch[0] // 4, ne)),
    mapped to [-π/4, 3π/4) as (σ - 0.25)·π. Returns (Detect maps, angle
    maps), NCHW."""

    def __init__(self, nc=80, ne=1, ch=(), legacy=False):
        super().__init__()
        self.nc, self.nl, self.ne = nc, len(ch), ne
        self.detect = Detect(nc, ch, legacy=legacy)
        _side_branch(self, ch, max(ch[0] // 4, ne), ne)

    def forward(self, xs):
        return self.detect(xs), [(torch.sigmoid(a) - 0.25) * math.pi
                                 for a in _run_side_branch(self, xs)]


class Classify(nn.Module):
    """Classification head (heads.py:194): `conv` Conv 1x1 to 1280, the
    global mean, then the Dense `linear` to c2 logits. JAX's dropout has rate
    0, the identity. A list input is concatenated on channels."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = Conv(c1, 1280, 1)
        self.linear = nn.Linear(1280, c2)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(x, 1)
        return linear(self.linear, self.conv(x).mean((2, 3)))


def decode_masks(coeffs, protos, boxes_xyxy, img_hw):
    """sigmoid(coeffs · protos) zeroed outside each box (heads.py:211), at
    prototype resolution: coeffs (N, nm), protos (Hm, Wm, nm), boxes xyxy
    in input-image pixels (N, 4), img_hw the input's (H, W). A pixel is
    inside when x1 <= col < x2 and y1 <= row < y2 in prototype pixels."""
    hm, wm = protos.shape[:2]
    masks = torch.sigmoid(torch.einsum("nk,hwk->nhw", coeffs, protos))
    sx, sy = wm / img_hw[1], hm / img_hw[0]
    x1, y1, x2, y2 = (boxes_xyxy[:, i, None, None] * s for i, s in enumerate((sx, sy, sx, sy)))
    cols = torch.arange(wm, device=masks.device)[None, None, :]
    rows = torch.arange(hm, device=masks.device)[None, :, None]
    inside = (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)
    return masks * inside


def kpts_decode(anchor_points, pred_kpts):
    """Raw keypoints (B, A, K, nd) → grid units (losses/extra.py:201): xy =
    raw * 2 + (anchor - 0.5); the visibility channel passes through."""
    xy = pred_kpts[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)
    return torch.cat([xy, pred_kpts[..., 2:]], -1)


def decode_keypoints(det_maps, kpt_maps, strides, kpt_shape):
    """A Pose head's keypoint maps → (B, A, K, nd) in input pixels, the
    visibility channel (nd 3) sigmoided, as the JAX predictor and validator
    decode them (engine/predictor.py:530-546)."""
    anchors, stride_t = make_anchors([f.shape[1:3] for f in det_maps], strides,
                                     device=det_maps[0].device)
    nk, nd = kpt_shape
    pk = flatten_levels(kpt_maps).reshape(det_maps[0].shape[0], -1, nk, nd)
    dec = kpts_decode(anchors, pk)
    xy = dec[..., :2] * stride_t[None, :, :, None]
    if nd == 3:
        return torch.cat([xy, torch.sigmoid(dec[..., 2:])], -1)
    return xy


def decode_obb(feats, angle_maps, strides, nc, reg_max=16):
    """OBB head maps (per-level NHWC) → (B, 4+nc+1, A) in the maps' type
    (heads.py:292): rotated xywh in input pixels, sigmoid scores, and the
    angle last."""
    x = flatten_levels(feats)
    anchors, stride_t = make_anchors([f.shape[1:3] for f in feats], strides, device=x.device)
    angle = flatten_levels(angle_maps)
    box_logits, cls_logits = x[..., : 4 * reg_max], x[..., 4 * reg_max:]
    dist = dfl_expectation(box_logits, reg_max)
    rbox = dist2rbox(dist, angle, anchors[None].to(dist.dtype)) * stride_t[None].to(dist.dtype)
    return torch.cat([rbox, torch.sigmoid(cls_logits), angle], dim=-1).transpose(-1, -2)


def gather_anchors(x, anchor_idx):
    """Rows of x (B, A, ...) at the anchors (B, K) NMS kept → (B, K, ...)."""
    idx = anchor_idx.long().view(*anchor_idx.shape, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(-1, -1, *x.shape[2:]))
