"""YOLOv10's end-to-end loss (port of the e2e part of
yolo_dbl_tpu/losses/extra.py; its segment, pose, OBB and classification
losses wait for their heads, ROADMAP Queue 1 item 6.2)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .detection import LossItems, detection_loss


def e2e_detect_loss(feats: Dict[str, Sequence[torch.Tensor]], batch, strides: Tuple[int, ...],
                    nc: int, **kw) -> Tuple[torch.Tensor, Dict[str, LossItems]]:
    """v10Detect's loss (extra.py:22): `detection_loss` of the one2many maps
    with TAL top-10 plus that of the one2one maps with TAL top-1; returns the
    sum and {"one2many": items, "one2one": items}. `kw` goes to both terms
    (the gains, and `mesh`, whose global normalizer each term takes)."""
    l_many, items_many = detection_loss(feats["one2many"], batch, strides, nc, tal_topk=10, **kw)
    l_one, items_one = detection_loss(feats["one2one"], batch, strides, nc, tal_topk=1, **kw)
    return l_many + l_one, {"one2many": items_many, "one2one": items_one}
