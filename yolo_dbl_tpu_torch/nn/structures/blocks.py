"""`TorchVision`, a backbone taken from a model zoo (port of
yolo_dbl_tpu/nn/structures/blocks.py:502-560)."""

from __future__ import annotations

from typing import Any

from torch import nn

from ...models.backbones import ResNet18Features, ResNet50

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
