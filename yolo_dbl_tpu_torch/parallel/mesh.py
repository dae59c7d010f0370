"""The ('data', 'model') mesh over torch.distributed ranks (port of
yolo_dbl_tpu/parallel/mesh.py).

The JAX package trains and serves as ONE SPMD program over a
`jax.sharding.Mesh` of shape (n_data, n_model): the 'data' axis shards the
batch, the 'model' axis shards large kernels (tensor parallelism, TP) or
image rows (spatial parallelism, SP; parallel/shardings.py), and XLA
inserts the collectives. Here each rank is a process (`torchrun
--nproc_per_node=N`, or any launcher that sets torch.distributed's
environment) and the collectives are explicit, each naming its axis: the
'data' axis carries cross-rank BatchNorm (nn/common.py), the loss
normalizer (losses/detection.py) and the gradient buckets
(engine/trainer.py); the 'model' axis carries TP's collectives
(parallel/tensor.py) and SP's halos (parallel/spatial.py). Rank r sits at
(d, m) = divmod(r, n_model), where JAX's `devices.reshape(n_data, n_model)`
puts device r. A step over the mesh computes the one-device step on the
global batch, as JAX's does.

NCCL serves ranks on cards and Gloo ranks on the CPU (and several ranks on
one card, which NCCL refuses). Pipeline parallelism (parallel/pipeline.py)
is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

NOT_PORTED = ("pipeline parallelism is not ported yet: ROADMAP Queue 1 item 6.5 "
              "(parallel/pipeline.py comes with models/rtdetr_pp.py and models/sam_pp.py)")
AXES = ("data", "model")


@dataclass
class Mesh:
    """This rank's view of an (n_data, n_model) mesh: `rank` of `world`
    ranks, its `device`, the world's process group (None for one process
    without a group, whose collectives are no-ops) and a group for each
    axis: `groups[axis]` joins the ranks that differ from this one only in
    that axis's coordinate (a ('data',) mesh's data group is the world's).
    `collectives` counts the axis collectives this rank ran:
    {"<op>:<axis>": [calls, bytes this rank sent]}."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None
    n_model: int = 1
    groups: Optional[Dict[str, Any]] = None
    collectives: Dict[str, list] = field(default_factory=dict)

    def __post_init__(self):
        if self.n_model < 1 or self.world % self.n_model:
            raise ValueError(f"{self.world} ranks do not make a mesh with n_model={self.n_model}")
        if self.groups is None:
            self.groups = {"data": self.group, "model": self.group}

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinates, (d, m) = divmod(rank, n_model)."""
        d, m = divmod(self.rank, self.n_model)
        return {"data": d, "model": m}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __deepcopy__(self, memo):
        return self  # process groups are not copied: a model's copy runs on this mesh

    def _host(self, tensor: torch.Tensor) -> bool:
        """Whether a collective of `tensor` goes through a host copy: Gloo
        on a card (its CUDA support differs by collective and type)."""
        return self.backend == "gloo" and tensor.is_cuda

    def _group(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"the mesh's axes are {AXES}, got {axis!r}")
        return self.groups[axis] if self.shape[axis] > 1 else None

    def _count(self, op: str, axis: str, tensor: torch.Tensor):
        entry = self.collectives.setdefault(f"{op}:{axis}", [0, 0])
        entry[0] += 1
        entry[1] += tensor.numel() * tensor.element_size()

    def all_reduce(self, tensor: torch.Tensor, axis: str = "data",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce `tensor` over `axis` (a sum unless `op`), in place; every
        rank of the axis gets the same bits."""
        group = self._group(axis)
        if group is not None:
            self._count("all_reduce", axis, tensor)
            if self._host(tensor):
                host = tensor.cpu()
                dist.all_reduce(host, op=op, group=group)
                tensor.copy_(host)
            else:
                dist.all_reduce(tensor, op=op, group=group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str = "model", dim: int = 0) -> torch.Tensor:
        """The `axis` ranks' tensors (of one shape) joined along `dim` in the
        order of their coordinates."""
        group = self._group(axis)
        if group is None:
            return tensor
        self._count("all_gather", axis, tensor)
        src = tensor.cpu() if self._host(tensor) else tensor.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim).to(tensor.device)

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `tensor` on every rank of the world, in place."""
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


def _axis_groups(world: int, n_model: int) -> Dict[str, Any]:
    """This rank's group of each axis. Every rank creates every group, in
    one order (torch.distributed's `new_group` contract): first each data
    row's model group, then each model column's data group."""
    n_data = world // n_model
    rank = dist.get_rank()
    mine = {}
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        group = dist.group.WORLD if n_data == 1 else (dist.new_group(ranks) if n_model > 1 else None)
        if rank in ranks:
            mine["model"] = group
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        group = dist.group.WORLD if n_model == 1 else (dist.new_group(ranks) if n_data > 1 else None)
        if rank in ranks:
            mine["data"] = group
    return mine


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Union[None, str, torch.device, Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """The (n_data, n_model) mesh of this process.

    Joins the process group from torchrun's environment (parallel/input.py
    `distributed_init`) unless one is up already; one process without a
    group is a mesh of one. The backend is NCCL on a card and Gloo on the
    CPU; NCCL without a card raises. The ranks must fill the mesh: `n_data`,
    when given, times `n_model` is the number of ranks."""
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
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_model < 1 or world % n_model or (n_data is not None and n_data * n_model != world):
        raise ValueError(f"a mesh of n_data={n_data} x n_model={n_model}, but the process group "
                         f"has {world} ranks (one rank a mesh cell)")
    if not dist.is_initialized():
        return Mesh(0, 1, dev)
    return Mesh(dist.get_rank(), world, dev, backend, dist.group.WORLD, n_model,
                _axis_groups(world, n_model))


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of n global rows, by its data coordinate (the model
    ranks of one data coordinate hold the same rows); raises unless the data
    axis divides n."""
    n_data = mesh.n_data
    if n % n_data:
        raise ValueError(f"a global batch of {n} rows does not split over {n_data} ranks")
    per, d = n // n_data, mesh.coords["data"]
    return slice(d * per, (d + 1) * per)


def data_sharding(mesh: Mesh) -> Callable:
    """The placement P('data'): an array's rows of this rank's data
    coordinate (its first axis split evenly over the data axis, in order),
    as a tensor on its device."""

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
    whole). A batch that the data axis does not divide raises."""
    rows, whole = data_sharding(mesh), replicated(mesh)
    return {k: (rows(v) if np.ndim(v) >= 1 else whole(v)) if hasattr(v, "shape") else v
            for k, v in batch.items()}
