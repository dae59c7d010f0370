"""yolo_dbl_tpu_torch — the PyTorch/CUDA port of yolo_dbl_tpu.

This package runs the YOLO-DBL serving path (uint8 frames → letterbox →
YOLO-DBL forward → DFL decode → fixed-shape NMS → boxes) on an NVIDIA
Hopper card. The JAX package `yolo_dbl_tpu` is the frozen reference that
every module here is held to; nothing in this package imports it or JAX.

The TPU package's two Pallas kernels on this path are hand-written CUDA
kernels here (`csrc/`, bound by `kernels/`). On a CPU tensor each kernel
wrapper runs its plain PyTorch version instead, which is what the tests use.
"""

__version__ = "0.1.0"

from .nn.tasks import DetectionModel

__all__ = ["DetectionModel", "__version__"]
