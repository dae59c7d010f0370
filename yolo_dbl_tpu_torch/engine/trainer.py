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

import copy
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


class Trainer:
    """Model + training config → optimizer, EMA, train step and epoch loop (:141).

    `setup(steps_per_epoch)` builds the optimizer and the EMA from the
    model's weights; with `seed` it first draws the weights anew from that
    seed, as the JAX `setup` initializes them from `cfg.seed` (:162-164; the
    facade passes it). Batches are dicts of the loss's batch contract, as
    numpy arrays or tensors; they are moved to the model's device.

    The state is the JAX `TrainState`'s: the model's parameters and
    BatchNorm statistics, the optimizer's state, the EMA tensors (one per
    parameter, float32), `ema_updates` and the step count `steps`.
    `state_dict()` / `load_state_dict()` carry it to and from a checkpoint
    (utils/checkpoint.py), and `restore(path)` reads `last.ckpt` (:223).
    `ema_model()` is the model to validate: an eval copy holding the EMA
    parameters and the live model's BatchNorm statistics, as JAX validates
    `{ema_params, batch_stats}`; the training model's weights are never
    swapped. Dropout draws from torch's generator, which no checkpoint
    carries.
    """

    def __init__(self, model: DetectionModel, overrides: Optional[Dict] = None):
        self.model = model
        self.cfg = get_cfg(overrides=overrides or {})
        self.optimizer = None
        self.lr_schedule = None
        self.ema = None
        self.ema_updates = 0.0
        self.steps = 0
        self._params = None
        self._ema_model = None

    def setup(self, steps_per_epoch: int, seed: Optional[int] = None) -> "Trainer":
        if seed is not None:
            self.model.reset_weights(seed)
        self.optimizer, self.lr_schedule = build_optimizer(self.model, self.model.nc, self.cfg,
                                                           steps_per_epoch)
        self._params = [p for _, p in self.model.named_parameters()]
        self.ema = [p.detach().clone() for p in self._params]
        self.ema_updates, self.steps = 0.0, 0
        self._ema_model = None
        return self

    def state_dict(self) -> Dict:
        """{step, ema_updates, params, ema_params, batch_stats, opt_state}:
        tensors by parameter or buffer name, by reference."""
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(zip(names, self._params))
        return {"step": self.steps, "ema_updates": self.ema_updates, "params": params,
                "ema_params": dict(zip(names, self.ema)),
                "batch_stats": {k: v for k, v in self.model.state_dict().items() if k not in params},
                "opt_state": self.optimizer.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict):
        """Copy a `state_dict()` (of a run of the same model and config) in place."""
        self.model.load_state_dict({**state["params"], **state["batch_stats"]}, strict=True)
        names = [n for n, _ in self.model.named_parameters()]
        torch._foreach_copy_(self.ema, [state["ema_params"][n].to(e.device)
                                        for n, e in zip(names, self.ema)])
        self.optimizer.load_state_dict(state["opt_state"])
        self.steps, self.ema_updates = int(state["step"]), float(state["ema_updates"])

    def restore(self, path) -> Dict:
        """Load a training checkpoint after `setup`; returns its meta
        {epoch, best_fitness, best_epoch, train_args, metrics}."""
        from ..utils.checkpoint import load_checkpoint

        state, meta = load_checkpoint(path)
        self.load_state_dict(state)
        return meta

    @torch.no_grad()
    def ema_model(self) -> DetectionModel:
        """The eval copy of the model with the EMA parameters and the live
        BatchNorm statistics, refreshed at each call."""
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(self.model).eval()
        torch._foreach_copy_(list(self._ema_model.parameters()), self.ema)
        for dst, src in zip(self._ema_model.buffers(), self.model.buffers()):
            dst.copy_(src)
        return self._ema_model

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        dev = self.model.device
        return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The train step (:62): loss, gradients, optimizer, EMA. Returns
        {name: 0-d tensor} metrics, left on the device."""
        loss, items = train_loss(self.model, self.cfg, self.to_device(batch))
        grads = torch.autograd.grad(loss, self._params)
        self.optimizer.step(grads)
        self.steps += 1
        self.ema_updates += 1.0
        ema_update(self.ema, self._params, self.ema_updates)
        return {"loss": loss.detach(), **{f"{k}_loss": v.detach() for k, v in items._asdict().items()}}

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
