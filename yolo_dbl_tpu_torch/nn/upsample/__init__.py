"""Upsamplers and the pools' fusion blocks of the port beyond DySample (which
lives in nn/blocks.py): the CARAFE family (`carafe`), and the config-reachable
parts of JAX's `misc` and `batch3` pools (`misc`, `batch3`)."""

from .carafe import CARAFE, CARAFE_XiaLiPKU, CARAFE_simplified, CARAFEPack, DLU

__all__ = ["CARAFE", "CARAFE_XiaLiPKU", "CARAFE_simplified", "CARAFEPack", "DLU"]
