"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is
no silent CPU fallback: asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means "cuda"; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev
