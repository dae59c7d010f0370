"""The package logger (port of yolo_dbl_tpu/utils/__init__.py).

`verbose=False` in the training config drops the engine's info messages and
keeps its warnings.
"""

from __future__ import annotations

import logging

LOGGER = logging.getLogger("yolo_dbl_tpu_torch")
if not LOGGER.handlers:  # idempotent under re-import
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
    LOGGER.propagate = False


def set_verbosity(verbose: bool) -> None:
    """Map the cfg `verbose` flag to the package logger level."""
    LOGGER.setLevel(logging.INFO if verbose else logging.WARNING)
