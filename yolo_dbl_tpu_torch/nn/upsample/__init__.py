"""Upsamplers of the port beyond DySample (which lives in nn/blocks.py)."""

from .carafe import CARAFE, CARAFE_XiaLiPKU, CARAFE_simplified, CARAFEPack, DLU

__all__ = ["CARAFE", "CARAFE_XiaLiPKU", "CARAFE_simplified", "CARAFEPack", "DLU"]
