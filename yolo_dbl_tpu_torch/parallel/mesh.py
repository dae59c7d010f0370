"""The data-parallel mesh over torch.distributed ranks (port of
yolo_dbl_tpu/parallel/mesh.py).

The JAX package trains data-parallel as ONE SPMD program over a
`jax.sharding.Mesh` whose 'data' axis shards the batch: jit sees the global
batch, so XLA inserts the gradient all-reduce and BatchNorm's cross-replica
statistics. Here each rank is a process (`torchrun --nproc_per_node=N`, or
any launcher that sets torch.distributed's environment), and the collectives
are explicit: `Mesh.all_reduce` in cross-rank BatchNorm (nn/common.py), the
loss normalizer (losses/detection.py) and the gradient buckets
(engine/trainer.py). A step over the mesh computes the one-device step on
the global batch, as JAX's does.

NCCL serves ranks on cards and Gloo ranks on the CPU. The 'model' axis
(tensor, sequence and pipeline parallelism: parallel/shardings.py and
parallel/pipeline.py) is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

NOT_PORTED = ("a 'model' axis (tensor, sequence or pipeline parallelism) is not ported yet: "
              "ROADMAP Queue 1 item 4 (parallel/shardings.py, parallel/pipeline.py)")


@dataclass
class Mesh:
    """This rank's view of a ('data',) mesh: `rank` of `world` ranks, its
    `device`, and the process group (None for one process without a group,
    whose collectives are no-ops)."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.world, "model": 1}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over the ranks, in place; every rank gets the same bits."""
        if self.group is not None:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.group is not None:
            dist.broadcast(tensor, src, group=self.group)
        return tensor

    def broadcast_object(self, obj, src: int = 0):
        """`src`'s picklable `obj` on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src, group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self):
        if self.group is not None:
            if self.backend == "nccl":
                dist.barrier(group=self.group, device_ids=[self.device.index])
            else:
                dist.barrier(group=self.group)


def _local_device(devices) -> torch.device:
    """This rank's device: `devices` (one device for every rank, or a
    sequence indexed by the local rank), else cuda:{LOCAL_RANK}."""
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    if devices is None:
        resolve_device("cuda")  # raises without a card
        return torch.device("cuda", local % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
    else:
        dev = torch.device(list(devices)[local])
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Union[None, str, torch.device, Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """The ('data',) mesh of this process: one rank per data shard.

    Joins the process group from torchrun's environment (parallel/input.py
    `distributed_init`) unless one is up already; one process without a
    group is a mesh of one. The backend is NCCL on a card and Gloo on the
    CPU; NCCL without a card raises. `n_data`, when given, must be the
    number of ranks."""
    if n_model != 1:
        raise NotImplementedError(NOT_PORTED)
    dev = _local_device(devices)
    if dist.is_initialized():
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"backend {backend!r} asked for, the process group runs "
                             f"{dist.get_backend()!r}")
        backend = dist.get_backend()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and (dev.type != "cuda" or not torch.cuda.is_available()):
        raise RuntimeError(f"NCCL needs a CUDA card, this rank's device is {dev}; "
                           "use backend='gloo' on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from .input import distributed_init

    distributed_init(backend=backend)
    if dist.is_initialized():
        mesh = Mesh(dist.get_rank(), dist.get_world_size(), dev, backend, dist.group.WORLD)
    else:
        mesh = Mesh(0, 1, dev)
    if n_data is not None and n_data != mesh.world:
        raise ValueError(f"n_data={n_data}, but the process group has {mesh.world} ranks "
                         "(one rank a data shard)")
    return mesh


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of n global rows; raises unless the ranks divide n."""
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} rows does not split over {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def data_sharding(mesh: Mesh) -> Callable:
    """The placement P('data'): an array's rows of this rank (its first axis
    split evenly over the ranks, in rank order), as a tensor on its device."""

    def place(v):
        v = torch.as_tensor(v)
        return v[local_rows(mesh, v.shape[0])].to(mesh.device, non_blocking=True)

    return place


def replicated(mesh: Mesh) -> Callable:
    """The placement P(): the whole array on this rank's device."""

    def place(v):
        return torch.as_tensor(v).to(mesh.device, non_blocking=True)

    return place


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows of a global batch dict, on its device (0-d values
    whole). A batch that the ranks do not divide raises."""
    rows, whole = data_sharding(mesh), replicated(mesh)
    return {k: (rows(v) if np.ndim(v) >= 1 else whole(v)) if hasattr(v, "shape") else v
            for k, v in batch.items()}
