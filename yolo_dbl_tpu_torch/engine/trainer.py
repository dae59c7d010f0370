"""Training engine: the train step and the epoch loop, on one device (port of
yolo_dbl_tpu/engine/trainer.py).

The train step is the JAX `make_train_step` (:62): uint8 batch → /255 →
train-mode forward (BatchNorm on batch statistics) → `detection_loss` →
gradients → optimizer → EMA, with the metrics loss/box_loss/cls_loss/dfl_loss.
On the card the DySample samplers run the K2 kernels forward and backward.
A bfloat16 model runs its forward and backward in bfloat16; the loss, the
TAL assigner, the float32 parameters, their gradients, the optimizer and
the EMA stay float32, as in JAX.

Not ported, each for a reason of the TPU runtime or of the mesh:
`make_train_scan` (:111) runs K steps in one dispatch to amortize the TPU
runtime's per-call cost, which eager PyTorch does not pay in that form;
buffer donation (:170-181) works around an XLA runtime fault; the mesh
branches (:183-217) wait for DDP (ROADMAP Queue 1, data parallel).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import torch

from ..cfg import get_cfg
from ..kernels.preprocess import device_normalize
from ..losses.detection import detection_loss
from ..nn.tasks import DetectionModel
from .train_state import build_optimizer, ema_update


def train_loss(model: DetectionModel, cfg, batch: Dict[str, torch.Tensor]):
    """(loss, LossItems) of one batch with the model in train mode (BatchNorm
    on batch statistics, its running statistics updated); the model's mode is
    restored afterwards."""
    was_training = model.training
    model.train()
    try:
        feats = model(device_normalize(batch["img"], model.dtype))
        return detection_loss(feats, batch, model.strides, model.nc,
                              box_gain=cfg.box, cls_gain=cfg.cls, dfl_gain=cfg.dfl)
    finally:
        model.train(was_training)


def make_train_step(model: DetectionModel, cfg, optimizer, ema) -> Callable:
    """The train step (:62) over `model`, updating it, `optimizer` and the EMA
    tensors `ema` in place. Returns {name: 0-d tensor} metrics, left on the
    device."""
    params = [p for _, p in model.named_parameters()]
    ema_updates = 0.0

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        nonlocal ema_updates
        loss, items = train_loss(model, cfg, batch)
        grads = torch.autograd.grad(loss, params)
        optimizer.step(grads)
        ema_updates += 1.0
        ema_update(ema, params, ema_updates)
        return {"loss": loss.detach(), **{f"{k}_loss": v.detach() for k, v in items._asdict().items()}}

    return train_step


class Trainer:
    """Model + training config → optimizer, EMA, train step and epoch loop (:141).

    The model comes with its weights (the JAX Trainer initializes them in
    `setup`); `setup(steps_per_epoch)` builds the optimizer from them. Batches
    are dicts of the loss's batch contract, as numpy arrays or tensors; they
    are moved to the model's device.
    """

    def __init__(self, model: DetectionModel, overrides: Optional[Dict] = None):
        self.model = model
        self.cfg = get_cfg(overrides=overrides or {})
        self.optimizer = None
        self.lr_schedule = None
        self.ema = None
        self._step_fn = None

    def setup(self, steps_per_epoch: int) -> "Trainer":
        self.optimizer, self.lr_schedule = build_optimizer(self.model, self.model.nc, self.cfg,
                                                           steps_per_epoch)
        self.ema = [p.detach().clone() for p in self.model.parameters()]
        self._step_fn = make_train_step(self.model, self.cfg, self.optimizer, self.ema)
        return self

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        dev = self.model.device
        return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return self._step_fn(self.to_device(batch))

    def fit(self, train_iter: Iterable, epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, on_epoch_end: Optional[Callable] = None):
        """Epoch loop over an iterable of batch dicts; returns one dict of
        epoch-average metrics (plus `epoch`, `seconds`) per epoch (:265)."""
        epochs = epochs or self.cfg.epochs
        history = []
        for epoch in range(epochs):
            t0 = time.time()
            running: Dict[str, float] = {}
            count = 0
            for i, batch in enumerate(train_iter):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                for k, v in self.step(batch).items():
                    running[k] = running.get(k, 0.0) + float(v)
                count += 1
            avg = {k: v / max(count, 1) for k, v in running.items()}
            avg.update(epoch=epoch, seconds=time.time() - t0)
            history.append(avg)
            if on_epoch_end is not None and on_epoch_end(self, epoch, avg) is False:
                break
        return history
