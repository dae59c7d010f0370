"""Image-size check (port of `check_imgsz`, yolo_dbl_tpu/utils/checks.py:23).

The JAX module's `check_amp` compares a float32 and a bfloat16 JAX forward;
its bars are used by chip_smoke.py's bfloat16 parity phases, and it is not
ported as a function.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

from . import LOGGER


def check_imgsz(imgsz: Union[int, Sequence[int]], stride: int = 32,
                min_dim: int = 0, floor: int = 0) -> Union[int, list]:
    """Round image size(s) up to the nearest multiple of `stride`, warning
    when a size changes."""
    stride = int(stride)

    def fix(v: int) -> int:
        v = max(int(v), floor)
        new = max(math.ceil(v / stride) * stride, floor)
        if new != v:
            LOGGER.warning("imgsz=%d is not a multiple of max stride %d, updating to %d",
                           v, stride, new)
        return new

    if isinstance(imgsz, (list, tuple)):
        out = [fix(v) for v in imgsz]
        return out if min_dim != 1 else out[0]
    return fix(imgsz)
