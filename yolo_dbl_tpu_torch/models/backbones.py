"""ResNet trunks in torchvision's layout (port of yolo_dbl_tpu/models/backbones.py:23-137).

These use flax's raw `nn.Conv` (no bias) and `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`, not the repo's `Conv`: here a bias-free nn.Conv2d named
`{name}_conv` and a `BatchNorm` named `{name}_bn` with eps 1e-5 and
momentum 0.1 (the torch form of flax's 0.9), so their statistics move ten
times as fast as every other layer's (nn/common.py `BN_MOMENTUM`). Each
trunk returns {"layer1": ..., "layer4": ...}, NCHW, at strides 4 to 32.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..nn.common import BatchNorm, conv2d
from ..ops.resample import max_pool

BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def _conv_bn(owner: nn.Module, name: str, c1: int, c2: int, k: int, s: int, p: int = 0):
    """Register the `{name}_conv` and `{name}_bn` pair of a trunk on `owner`."""
    owner.add_module(f"{name}_conv", nn.Conv2d(c1, c2, k, s, p, bias=False))
    owner.add_module(f"{name}_bn", BatchNorm(c2, eps=BN_EPS, momentum=BN_MOMENTUM))


def _run(owner: nn.Module, name: str, x):
    return getattr(owner, f"{name}_bn")(conv2d(getattr(owner, f"{name}_conv"), x))


class ResNetBottleneck(nn.Module):
    """torchvision's Bottleneck (backbones.py:23): 1x1 → 3x3 (stride) → 1x1
    to 4·planes, with a `down` projection; ReLU after each and on the sum."""

    def __init__(self, c1, planes, stride=1, downsample=False):
        super().__init__()
        self.downsample = downsample
        _conv_bn(self, "c1", c1, planes, 1, 1)
        _conv_bn(self, "c2", planes, planes, 3, stride, 1)
        _conv_bn(self, "c3", planes, planes * 4, 1, 1)
        if downsample:
            _conv_bn(self, "down", c1, planes * 4, 1, stride)

    def forward(self, x):
        y = torch.relu(_run(self, "c1", x))
        y = torch.relu(_run(self, "c2", y))
        y = _run(self, "c3", y)
        return torch.relu(y + (_run(self, "down", x) if self.downsample else x))


class ResNetBasicBlock(nn.Module):
    """torchvision's BasicBlock (backbones.py:49): 3x3 (stride) → 3x3, with
    a `down` projection; ReLU after the first and on the sum."""

    def __init__(self, c1, planes, stride=1, downsample=False):
        super().__init__()
        self.downsample = downsample
        _conv_bn(self, "c1", c1, planes, 3, stride, 1)
        _conv_bn(self, "c2", planes, planes, 3, 1, 1)
        if downsample:
            _conv_bn(self, "down", c1, planes, 1, stride)

    def forward(self, x):
        y = torch.relu(_run(self, "c1", x))
        y = _run(self, "c2", y)
        return torch.relu(y + (_run(self, "down", x) if self.downsample else x))


class _Trunk(nn.Module):
    """Stem (`conv1` 7x7 stride 2, `bn1`, ReLU, 3x3 stride-2 max pool) and
    blocks `layer{l}_{b}`; returns the last map of each layer."""

    layers = ()  # (planes, blocks, stride) per layer
    block = None
    expansion = 1
    first_layer_projects = False  # whether layer1's first block has a `down` projection

    def __init__(self, c1: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(c1, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, eps=BN_EPS, momentum=BN_MOMENTUM)
        c = 64
        for li, (planes, blocks, stride) in enumerate(self.layers, start=1):
            for bi in range(blocks):
                down = bi == 0 and (li > 1 or self.first_layer_projects)
                self.add_module(f"layer{li}_{bi}", self.block(c, planes, stride if bi == 0 else 1,
                                                              down))
                c = planes * self.expansion

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = torch.relu(self.bn1(conv2d(self.conv1, x)))
        y = max_pool(y.permute(0, 2, 3, 1), 3, 2, 1).permute(0, 3, 1, 2)
        feats = {}
        for li, (_, blocks, _) in enumerate(self.layers, start=1):
            for bi in range(blocks):
                y = getattr(self, f"layer{li}_{bi}")(y)
            feats[f"layer{li}"] = y
        return feats


class ResNet18Features(_Trunk):
    """ResNet-18 (backbones.py:73): BasicBlocks 2 a layer, 64/128/256/512
    channels; the first block of layers 2-4 projects."""

    layers = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))
    block = ResNetBasicBlock


class ResNet50(_Trunk):
    """ResNet-50 (backbones.py:107): Bottlenecks 3/4/6/3, 256/512/1024/2048
    channels; the first block of every layer projects."""

    layers = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
    block = ResNetBottleneck
    expansion = 4
    first_layer_projects = True
