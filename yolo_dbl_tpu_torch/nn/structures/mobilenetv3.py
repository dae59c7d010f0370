"""MobileNetV3 (port of yolo_dbl_tpu/nn/structures/mobilenetv3.py).

h-sigmoid relu6(x + 3) / 6 and h-swish, the SE whose hidden width is
divisible by 8 (`MNV3SELayer`), the inverted residual (expand, depthwise,
SE, linear project, identity skip) and the large and small classifiers
(the stem, the blocks of the (k, t, c, use_se, use_hs, s) tables, a 1x1
head, the mean over (H, W), two Dense layers). NCHW images in, (B,
num_classes) logits out; the BatchNorms are flax's called directly
(nn/common.py `flax_batch_norm`). At width 1 and 1000 classes the large
model has 5,483,032 parameters and the small 2,542,856, torchvision's counts.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..common import linear
from .blocks import add_conv_bn, conv_bn


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def h_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def h_swish(x):
    return x * h_sigmoid(x)


def _add_conv_bn(owner, name, c1, c2, k, s=1, g=1):
    """flax's `{name}_conv` (bias-free, padding (k - 1) // 2 = k // 2: every
    kernel is odd) and `{name}_bn` on `owner`."""
    add_conv_bn(owner, name, c1, c2, k, s, g, conv="conv")


def _conv_bn(owner, name, x, act=None):
    return conv_bn(owner, name, x, act, conv="conv")


class MNV3SELayer(nn.Module):
    """SE with a hidden width of _make_divisible(C // reduction, 8) and an h-sigmoid gate."""

    def __init__(self, channel, reduction=4):
        super().__init__()
        hidden = _make_divisible(channel // reduction, 8)
        self.fc1 = nn.Linear(channel, hidden)
        self.fc2 = nn.Linear(hidden, channel)

    def forward(self, x):
        y = F.relu(linear(self.fc1, x.mean((2, 3))))
        return x * h_sigmoid(linear(self.fc2, y))[:, :, None, None]


class InvertedResidual(nn.Module):
    """MobileNetV3's inverted residual: a 1x1 expansion to `hidden_dim`
    where it differs from the input, a depthwise k x k with the stride, the
    SE (after the activation where nothing expands, before it otherwise), a
    linear 1x1 projection; identity where the stride is 1 and the width holds."""

    def __init__(self, inp, hidden_dim, oup, kernel_size=3, stride=1, use_se=True, use_hs=True):
        super().__init__()
        self.act = h_swish if use_hs else F.relu
        self.expand = inp != hidden_dim
        if self.expand:
            _add_conv_bn(self, "pw", inp, hidden_dim, 1)
        _add_conv_bn(self, "dw", hidden_dim, hidden_dim, kernel_size, stride, hidden_dim)
        self.use_se = use_se
        if use_se:
            self.se = MNV3SELayer(hidden_dim)
        _add_conv_bn(self, "pw_linear", hidden_dim, oup, 1)
        self.identity = stride == 1 and inp == oup

    def forward(self, x):
        y = _conv_bn(self, "pw", x, self.act) if self.expand else x
        y = _conv_bn(self, "dw", y)
        if self.expand:
            y = self.act(self.se(y) if self.use_se else y)
        else:
            y = self.act(y)
            y = self.se(y) if self.use_se else y
        y = _conv_bn(self, "pw_linear", y)
        return x + y if self.identity else y


# (k, t, c, use_se, use_hs, s) tables (mobilenetv3.py:96-109)
MOBILENETV3_LARGE_CFGS = (
    (3, 1, 16, 0, 0, 1), (3, 4, 24, 0, 0, 2), (3, 3, 24, 0, 0, 1),
    (5, 3, 40, 1, 0, 2), (5, 3, 40, 1, 0, 1), (5, 3, 40, 1, 0, 1),
    (3, 6, 80, 0, 1, 2), (3, 2.5, 80, 0, 1, 1), (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1), (3, 6, 112, 1, 1, 1), (3, 6, 112, 1, 1, 1),
    (5, 6, 160, 1, 1, 2), (5, 6, 160, 1, 1, 1), (5, 6, 160, 1, 1, 1),
)
MOBILENETV3_SMALL_CFGS = (
    (3, 1, 16, 1, 0, 2), (3, 4.5, 24, 0, 0, 2), (3, 3.67, 24, 0, 0, 1),
    (5, 4, 40, 1, 1, 2), (5, 6, 40, 1, 1, 1), (5, 6, 40, 1, 1, 1),
    (5, 3, 48, 1, 1, 1), (5, 3, 48, 1, 1, 1), (5, 6, 96, 1, 1, 2),
    (5, 6, 96, 1, 1, 1), (5, 6, 96, 1, 1, 1),
)


class MobileNetV3(nn.Module):
    """The classifier: an h-swish 3x3 stride-2 stem, the inverted
    residuals `ir{i}` of `cfgs`, an h-swish 1x1 head, the mean over (H, W),
    an h-swish Dense (1280 large, 1024 small) and the logits Dense."""

    def __init__(self, cfgs=MOBILENETV3_LARGE_CFGS, mode="large", num_classes=1000,
                 width_mult=1.0, c1=3):
        super().__init__()
        if mode not in ("large", "small"):
            raise ValueError(f"mode must be 'large' or 'small', got {mode!r}")
        c_in = _make_divisible(16 * width_mult, 8)
        _add_conv_bn(self, "stem", c1, c_in, 3, 2)
        self.n = len(cfgs)
        exp = c_in
        for i, (k, t, c, se, hs, s) in enumerate(cfgs):
            out = _make_divisible(c * width_mult, 8)
            exp = _make_divisible(c_in * t, 8)
            setattr(self, f"ir{i}", InvertedResidual(c_in, exp, out, int(k), int(s), bool(se),
                                                     bool(hs)))
            c_in = out
        _add_conv_bn(self, "head", c_in, exp, 1)
        out_ch = {"large": 1280, "small": 1024}[mode]
        if width_mult > 1.0:
            out_ch = _make_divisible(out_ch * width_mult, 8)
        self.cls_fc1 = nn.Linear(exp, out_ch)
        self.cls_fc2 = nn.Linear(out_ch, num_classes)

    def forward(self, x):
        x = _conv_bn(self, "stem", x, h_swish)
        for i in range(self.n):
            x = getattr(self, f"ir{i}")(x)
        x = _conv_bn(self, "head", x, h_swish).mean((2, 3))
        return linear(self.cls_fc2, h_swish(linear(self.cls_fc1, x)))


def mobilenetv3_large(**kw):
    return MobileNetV3(cfgs=MOBILENETV3_LARGE_CFGS, mode="large", **kw)


def mobilenetv3_small(**kw):
    return MobileNetV3(cfgs=MOBILENETV3_SMALL_CFGS, mode="small", **kw)
