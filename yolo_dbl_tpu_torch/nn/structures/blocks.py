"""Structure blocks (port of part of yolo_dbl_tpu/nn/structures/blocks.py):
FasterNet's `PConv` and `FasterBlock` (:42-73), which FFCA-YOLO-L's
C3_Faster chains, GhostNetV2's `GhostModuleV2` and `GhostBottleneckV2`
(:191-272), which C2f_PIG stacks beyond n = 3, and `TorchVision`, a
backbone taken from a model zoo (:502-560). Their BatchNorms are flax's
called directly (nn/common.py `flax_batch_norm`)."""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from ...models.backbones import ResNet18Features, ResNet50
from ...ops.resample import resize_nearest
from ..common import Conv, conv2d, flax_batch_norm, linear


class PConv(nn.Module):
    """FasterNet partial conv (blocks.py:42): a bias-free 3x3 conv on the
    first C/4 channels, the rest passed on, then flax's own BatchNorm and
    SiLU over the whole."""

    def __init__(self, dim):
        super().__init__()
        self.c3 = dim // 4
        self.partial_conv3 = nn.Conv2d(self.c3, self.c3, 3, padding=1, bias=False)
        self.bn = flax_batch_norm(dim)

    def forward(self, x):
        conv = self.partial_conv3
        x1 = F.conv2d(x[:, :self.c3], conv.weight.to(x.dtype), None, padding=1)
        return F.silu(self.bn(torch.cat([x1, x[:, self.c3:]], 1)))


class FasterBlock(nn.Module):
    """PConv, then a 1x1 Conv, residual when shapes allow (blocks.py:60)."""

    def __init__(self, c1, c2, shortcut=True):
        super().__init__()
        self.pconv = PConv(c1)
        self.conv1 = Conv(c1, c2, 1, 1)
        self.add = bool(shortcut) and c1 == c2

    def forward(self, x):
        y = self.conv1(self.pconv(x))
        return x + y if self.add else y


class GhostModuleV2(nn.Module):
    """Ghost module (blocks.py:191): a primary conv and a cheap depthwise
    conv, concatenated and cut to `oup`; in mode "attn" gated by DFC
    attention, the sigmoid of a 1x1 conv and 1x5, 5x1 depthwise convs on
    the 2x2-averaged input (an odd last row or column dropped), resized to
    the output by JAX's nearest rule."""

    def __init__(self, inp, oup, kernel_size=1, ratio=2, dw_size=3, stride=1, relu=True,
                 mode="original"):
        super().__init__()
        if mode not in ("original", "attn"):
            raise ValueError(f"mode must be 'original' or 'attn', got {mode!r}")
        init_c = math.ceil(oup / ratio)
        self.oup, self.relu, self.attn = oup, relu, mode == "attn"
        layers = {"primary": (inp, init_c, kernel_size, stride, 1, kernel_size // 2),
                  "cheap": (init_c, init_c * (ratio - 1), dw_size, 1, init_c, dw_size // 2)}
        if self.attn:
            layers.update(short1=(inp, oup, kernel_size, stride, 1, kernel_size // 2),
                          short2=(oup, oup, (1, 5), 1, oup, (0, 2)),
                          short3=(oup, oup, (5, 1), 1, oup, (2, 0)))
        # flax scopes `{name}_c` and `{name}_bn` (blocks.py:199, `conv_bn`)
        for name, (ci, co, k, s, g, p) in layers.items():
            setattr(self, f"{name}_c", nn.Conv2d(ci, co, k, s, p, groups=g, bias=False))
            setattr(self, f"{name}_bn", flax_batch_norm(co))

    def _cbn(self, name, x):
        return getattr(self, f"{name}_bn")(conv2d(getattr(self, f"{name}_c"), x))

    def forward(self, x):
        x1 = self._cbn("primary", x)
        x1 = F.relu(x1) if self.relu else x1
        x2 = self._cbn("cheap", x1)
        x2 = F.relu(x2) if self.relu else x2
        out = torch.cat([x1, x2], 1)[:, :self.oup]
        if not self.attn:
            return out
        b, c, h, w = x.shape
        ds = x[:, :, :h // 2 * 2, :w // 2 * 2].reshape(b, c, h // 2, 2, w // 2, 2).mean((3, 5))
        gate = torch.sigmoid(self._cbn("short3", self._cbn("short2", self._cbn("short1", ds))))
        gate = resize_nearest(gate.permute(0, 2, 3, 1), *out.shape[2:]).permute(0, 3, 1, 2)
        return out * gate


class GhostBottleneckV2(nn.Module):
    """GhostNetV2 bottleneck (blocks.py:226): ghost1 (DFC attention past
    layer 1), a strided depthwise conv, a hard-sigmoid SE, ghost2; the input
    added, or a depthwise and a 1x1 projection of it where the width or the
    size changes."""

    def __init__(self, in_chs, mid_chs, out_chs, dw_kernel_size=3, stride=1, se_ratio=0.0,
                 layer_id=2):
        super().__init__()
        k, p = dw_kernel_size, (dw_kernel_size - 1) // 2
        self.stride, self.se = stride, se_ratio > 0
        self.ghost1 = GhostModuleV2(in_chs, mid_chs, relu=True,
                                    mode="original" if layer_id <= 1 else "attn")
        if stride > 1:
            self.conv_dw = nn.Conv2d(mid_chs, mid_chs, k, stride, p, groups=mid_chs, bias=False)
            self.bn_dw = flax_batch_norm(mid_chs)
        if self.se:
            rd = max(1, int(mid_chs * se_ratio))
            self.se_fc1 = nn.Linear(mid_chs, rd)
            self.se_fc2 = nn.Linear(rd, mid_chs)
        self.ghost2 = GhostModuleV2(mid_chs, out_chs, relu=False)
        self.identity = in_chs == out_chs and stride == 1
        if not self.identity:
            self.sc_dw = nn.Conv2d(in_chs, in_chs, k, stride, p, groups=in_chs, bias=False)
            self.sc_bn1 = flax_batch_norm(in_chs)
            self.sc_pw = nn.Conv2d(in_chs, out_chs, 1, bias=False)
            self.sc_bn2 = flax_batch_norm(out_chs)

    def forward(self, x):
        y = self.ghost1(x)
        if self.stride > 1:
            y = self.bn_dw(conv2d(self.conv_dw, y))
        if self.se:
            s = F.relu(linear(self.se_fc1, y.mean((2, 3))))
            s = torch.clamp(linear(self.se_fc2, s) + 3, 0, 6) / 6
            y = y * s[:, :, None, None]
        y = self.ghost2(y)
        if self.identity:
            return x + y
        sc = self.sc_bn1(conv2d(self.sc_dw, x))
        return self.sc_bn2(conv2d(self.sc_pw, sc)) + y


TRUNKS = {"resnet18": ResNet18Features, "resnet50": ResNet50}


class TorchVision(nn.Module):
    """A native trunk `m` standing for a torchvision model (blocks.py:502):
    `weights` is accepted for the YAML and ignored (the weights are drawn
    from the seed); the output is the trunk's last map (`truncate` >= 2, or
    no `unwrap`), or its global mean kept as a 1x1 map (`unwrap` and
    `truncate` 1: torchvision's avgpool kept, its fc dropped)."""

    def __init__(self, c1: int, c2: int, model: str = "resnet18", weights: Any = "DEFAULT",
                 unwrap: bool = True, truncate: int = 2, split: bool = False):
        super().__init__()
        if model not in TRUNKS:
            raise NotImplementedError(f"TorchVision model '{model}' has no native trunk yet; "
                                      f"available: {sorted(TRUNKS)}")
        if split:
            raise NotImplementedError("TorchVision split=True is not supported")
        self.unwrap, self.truncate = unwrap, truncate
        self.m = TRUNKS[model](c1)

    def forward(self, x):
        y = self.m(x)["layer4"]
        if self.unwrap and self.truncate == 1:
            y = y.mean((2, 3), keepdim=True)
        return y
