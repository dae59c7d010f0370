"""Training engine: the train step and the epoch loop, on one device (port of
yolo_dbl_tpu/engine/trainer.py).

The train step is the JAX `make_train_step` (:62): uint8 batch → /255 →
train-mode forward (BatchNorm on batch statistics) → `detection_loss` →
gradients → optimizer → EMA, with the metrics loss/box_loss/cls_loss/dfl_loss.
On the card the DySample samplers run the K2 kernels forward and backward.
A bfloat16 model runs its forward and backward in bfloat16; the loss, the
TAL assigner, the float32 parameters, their gradients, the optimizer and
the EMA stay float32, as in JAX.

The mesh branches (:183-217, 224-239): with a `mesh` (parallel/mesh.py)
each rank is a process holding the rows of its data coordinate, and a step
computes the one-device step on the global batch, as JAX's single SPMD
program does: BatchNorm takes its statistics over the 'data' axis's rows
(nn/common.py `cross_rank`), the loss normalizer and batch size are global
(losses/detection.py), each rank differentiates its share of the global
loss, and the gradients are summed over 'data' in buckets (one all-reduce a
bucket) before the clip, the optimizer and the EMA. Not DDP's mean of
per-rank losses: that is another function of the batch. `setup` broadcasts
rank 0's weights, so every rank starts from one draw, and the all-reduces
give every rank of an axis the same bits. With `n_model > 1` `setup` then
shards the model by parallel/shardings.py's specs (parallel/tensor.py,
JAX's `model_parallel_shardings` placement of the TrainState): each rank
keeps its shard of every sharded kernel, and the optimizer's moments and
the EMA are made from the shards; the replicated leaves' gradients are
completed over 'model' before the sum over 'data', the clip's global norm
counts each sharded leaf whole (a sum over 'model'), and the sliced
BatchNorms' running statistics are gathered after each step.
`state_dict()` gathers whole leaves in the one-process layout and
`load_state_dict` (and `restore`) shards them again.

Not ported, each for a reason of the TPU runtime: `make_train_scan` (:111)
runs K steps in one dispatch to amortize the TPU runtime's per-call cost,
which eager PyTorch does not pay in that form; buffer donation (:170-181)
works around an XLA runtime fault. Pipeline parallelism waits with
parallel/pipeline.py (ROADMAP Queue 1 item 6.5).
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from ..cfg import get_cfg
from ..kernels.preprocess import device_normalize
from ..losses.detection import detection_loss
from ..nn.common import cross_rank
from ..nn.tasks import DetectionModel
from ..parallel.mesh import Mesh, shard_batch
from ..parallel.tensor import shard_model
from .train_state import build_optimizer, ema_update

# bytes of gradient a bucket of the cross-rank sum holds (DDP's default)
BUCKET_BYTES = 25 * 2**20


def train_loss(model: DetectionModel, cfg, batch: Dict[str, torch.Tensor],
               mesh: Optional[Mesh] = None):
    """(loss, LossItems) of one batch with the model in train mode (BatchNorm
    on batch statistics, its running statistics updated); the model's mode is
    restored afterwards. Under a `mesh`, `batch` is this rank's rows and the
    loss is this rank's share of the global batch's."""
    was_training = model.training
    model.train()
    try:
        with cross_rank(model, mesh):
            feats = model(device_normalize(batch["img"], model.dtype))
        return detection_loss(feats, batch, model.strides, model.nc, box_gain=cfg.box,
                              cls_gain=cfg.cls, dfl_gain=cfg.dfl, mesh=mesh)
    finally:
        model.train(was_training)


def _buckets(tensors: Sequence[torch.Tensor], limit: int = BUCKET_BYTES) -> List[List[int]]:
    """Indices of `tensors` in buckets of one type and at most `limit` bytes
    (a larger tensor alone), in order within each type."""
    out = []
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        bucket, size = None, 0
        for i, t in enumerate(tensors):
            if t.dtype != dtype:
                continue
            n = t.numel() * t.element_size()
            if bucket is None or size + n > limit:
                bucket, size = [], 0
                out.append(bucket)
            bucket.append(i)
            size += n
    return out


@torch.no_grad()
def _coalesced(tensors: Sequence[torch.Tensor], collective: Callable):
    """Run the in-place `collective` on `tensors` one bucket at a time (one
    flat tensor a call) and copy its result back into each tensor, in
    place: each keeps its memory format (a channels_last gradient stays
    one, so the optimizer's multi-tensor updates keep their fast path)."""
    for idx in _buckets(tensors):
        flat = collective(torch.cat([tensors[i].reshape(-1) for i in idx]))
        parts = flat.split([tensors[i].numel() for i in idx])
        torch._foreach_copy_([tensors[i] for i in idx],
                             [part.view(tensors[i].shape) for i, part in zip(idx, parts)])


def all_reduce_coalesced(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum `tensors` over the ranks, in place; returns them."""
    tensors = list(tensors)
    _coalesced(tensors, mesh.all_reduce)
    return tensors


def broadcast_coalesced(mesh: Mesh, tensors: Sequence[torch.Tensor], src: int = 0):
    """Copy rank `src`'s `tensors` into every rank's, in place."""
    _coalesced(tensors, lambda flat: mesh.broadcast(flat, src))


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

    With a `mesh` the trainer is one rank of a parallel run (see the module
    note): the model must live on the mesh's device and be whole (`setup`
    shards it when the mesh has a 'model' axis), `cfg.batch` is the global
    batch, `step` takes the global batch (or, with `local=True`, this
    rank's rows of it) and returns the global metrics, and `state_dict()`
    is the same on every rank. `ema_model()` of a sharded model runs
    tensor-parallel on the EMA shards.
    """

    def __init__(self, model: DetectionModel, overrides: Optional[Dict] = None,
                 mesh: Optional[Mesh] = None):
        if mesh is not None and model.device != mesh.device:
            raise ValueError(f"the model lives on {model.device}, this rank's device is {mesh.device}")
        self.model = model
        self.mesh = mesh
        self.cfg = get_cfg(overrides=overrides or {})
        self.optimizer = None
        self.lr_schedule = None
        self.ema = None
        self.ema_updates = 0.0
        self.steps = 0
        self._params = None
        self._ema_model = None
        # under tensor parallelism, pass a column-parallel conv's slice straight
        # to its one row-parallel consumer (parallel/tensor.py); off gathers it
        self.pair = True

    @property
    def tp(self):
        """The model's tensor-parallel record (parallel/tensor.py), or None."""
        tp = getattr(self.model, "tp", None)
        return tp if tp is not None and tp.mesh.n_model > 1 else None

    def setup(self, steps_per_epoch: int, seed: Optional[int] = None) -> "Trainer":
        if getattr(self.model, "tp", None) is not None:
            raise ValueError("the Trainer shards the model itself: pass it whole")
        if seed is not None:
            self.model.reset_weights(seed)
        if self.mesh is not None:
            broadcast_coalesced(self.mesh, list(self.model.state_dict().values()))
            if self.mesh.n_model > 1:
                shard_model(self.model, self.mesh, pair=self.pair)
        self.optimizer, self.lr_schedule = build_optimizer(self.model, self.model.nc, self.cfg,
                                                           steps_per_epoch)
        if self.tp is not None:
            self.optimizer.model_parallel(self.mesh, [n in self.tp.dims for n, _ in
                                                      self.model.named_parameters()])
        self._params = [p for _, p in self.model.named_parameters()]
        self.ema = [p.detach().clone() for p in self._params]
        self.ema_updates, self.steps = 0.0, 0
        self._ema_model = None
        return self

    def state_dict(self) -> Dict:
        """{step, ema_updates, params, ema_params, batch_stats, opt_state}:
        tensors by parameter or buffer name, by reference; under tensor
        parallelism whole leaves gathered over 'model' (a collective: every
        rank calls it), the one-process layout."""
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(zip(names, self._params))
        buffers = {k: v for k, v in self.model.state_dict().items() if k not in params}
        opt = self.optimizer.state_dict()
        ema = dict(zip(names, self.ema))
        tp = self.tp
        if tp is not None:
            params = {n: tp.gather_leaf(n, t) for n, t in params.items()}
            ema = {n: tp.gather_leaf(n, t) for n, t in ema.items()}
            opt = {k: [tp.gather_leaf(n, t) for n, t in zip(names, v)] if isinstance(v, list) else v
                   for k, v in opt.items()}
        return {"step": self.steps, "ema_updates": self.ema_updates, "params": params,
                "ema_params": ema, "batch_stats": buffers, "opt_state": opt}

    @torch.no_grad()
    def load_state_dict(self, state: Dict):
        """Copy a `state_dict()` (of a run of the same model and config) in
        place; whole leaves are sharded again under tensor parallelism."""
        names = [n for n, _ in self.model.named_parameters()]
        tp = self.tp
        part = (lambda n, t: tp.shard_leaf(n, t)) if tp is not None else (lambda n, t: t)  # noqa: E731
        params = {n: part(n, state["params"][n]) for n in names}
        self.model.load_state_dict({**params, **state["batch_stats"]}, strict=True)
        torch._foreach_copy_(self.ema, [part(n, state["ema_params"][n]).to(e.device)
                                        for n, e in zip(names, self.ema)])
        self.optimizer.load_state_dict(
            {k: [part(n, t) for n, t in zip(names, v)] if isinstance(v, list) else v
             for k, v in state["opt_state"].items()})
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

    def to_device(self, batch: Dict, local: bool = False) -> Dict[str, torch.Tensor]:
        """The batch on the model's device; under a mesh, this rank's rows of
        a global batch (`local=True`: the batch holds only those rows)."""
        if self.mesh is not None and not local:
            return shard_batch(self.mesh, batch)
        dev = self.model.device
        return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sums over the 'data' axis of every rank's gradient of its
        share, the replicated leaves first completed over 'model'."""
        if self.tp is not None:
            self.tp.reduce_replicated([n for n, _ in self.model.named_parameters()], grads)
        return all_reduce_coalesced(self.mesh, grads)

    def step(self, batch: Dict, local: bool = False) -> Dict[str, torch.Tensor]:
        """The train step (:62): loss, gradients, optimizer, EMA. Returns
        {name: 0-d tensor} metrics, left on the device. A parameter that
        the loss does not reach (a YAML row whose output no later row reads,
        as in yolov13_v3edit5_attn and yolov13_v3edit6) gets a zero
        gradient, as under jax.grad. Under a mesh the gradients and metrics
        are the global batch's on every rank."""
        loss, items = train_loss(self.model, self.cfg, self.to_device(batch, local), self.mesh)
        grads = torch.autograd.grad(loss, self._params, materialize_grads=True)
        values = torch.stack([loss.detach(), *(v.detach() for v in items)])
        if self.mesh is not None:
            grads = self.all_reduce_grads(grads)
            self.mesh.all_reduce(values)
        self.optimizer.step(grads)
        self.steps += 1
        self.ema_updates += 1.0
        ema_update(self.ema, self._params, self.ema_updates)
        if self.tp is not None:
            self.tp.sync_statistics()
        names = ["loss", *(f"{k}_loss" for k in items._fields)]
        return dict(zip(names, values.unbind()))

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
