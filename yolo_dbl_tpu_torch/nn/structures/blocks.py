"""Structure blocks (port of part of yolo_dbl_tpu/nn/structures/blocks.py):
FasterNet's `PConv` and `FasterBlock` (:42-73), which FFCA-YOLO-L's
C3_Faster chains, and `TorchVision`, a backbone taken from a model zoo
(:502-560)."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from ...models.backbones import ResNet18Features, ResNet50
from ..common import Conv, flax_batch_norm


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
