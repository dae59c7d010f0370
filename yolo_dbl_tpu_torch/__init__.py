"""yolo_dbl_tpu_torch — the PyTorch/CUDA port of yolo_dbl_tpu.

This package runs the YOLO-DBL and stock YOLOv13 serving path (uint8
frames → letterbox → forward → DFL decode → fixed-shape NMS → boxes) and
their training path (uint8 batch → /255 → train-mode forward → TAL +
detection loss → backward → clip, optimizer, EMA; `engine/trainer.py`) on
an NVIDIA Hopper card. `engine/model.py` `YOLO` is the user's entry (train
with checkpoints and resume, val, predict with `Results`), and
`python -m yolo_dbl_tpu_torch` its command line. The JAX package `yolo_dbl_tpu` is
the frozen reference that every module here is held to; nothing in this
package imports it or JAX.

The TPU package's Pallas kernels on these paths are hand-written CUDA
kernels here (`csrc/`, bound by `kernels/`): the letterbox, the DySample
sampler with its backward, and YOLOv13's area attention with its backward. On a CPU tensor each kernel wrapper
runs its plain PyTorch version instead, which is what the tests use.
"""

__version__ = "0.1.0"

from .nn.tasks import DetectionModel

__all__ = ["DetectionModel", "__version__"]
