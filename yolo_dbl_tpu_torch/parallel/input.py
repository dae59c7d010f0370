"""The multi-rank input pipeline (port of yolo_dbl_tpu/parallel/input.py).

In JAX's multi-host form each host loads only its shard of every global
batch, and `jax.make_array_from_process_local_data` joins the shards into
one global array. Here a rank is a process and keeps its shard: the
collectives of the step (parallel/mesh.py) stand where the joined array
stood. The sample order, the padding and the shard bounds are JAX's, so
rank r of N holds what JAX's host r of N holds.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def distributed_init(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """`torch.distributed.init_process_group` from the arguments, or from
    torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT).
    A no-op when a group is up, or for one process given no `init_method`
    (JAX's `distributed_init` is a no-op for one process too)."""
    if dist.is_initialized():
        return
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    if world == 1 and init_method is None:
        return
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank)


def _rank_world(process_index, process_count):
    up = dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    return pi, pc


def host_shard_indices(n_samples: int, seed: int = 0, epoch: int = 0, shuffle: bool = True,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> np.ndarray:
    """This rank's sample indices for one epoch (the DistributedSampler
    contract: one permutation everywhere, disjoint contiguous shards, padded
    so that every rank sees the same count)."""
    pi, pc = _rank_world(process_index, process_count)
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n_samples) if shuffle else np.arange(n_samples)
    per = -(-n_samples // pc)  # ceil
    pad = per * pc - n_samples
    if pad:
        order = np.concatenate([order, order[:pad]])
    return order[pi * per:(pi + 1) * per]


def make_global_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                      data_axis: str = "data") -> Dict[str, torch.Tensor]:
    """This rank's LOCAL shard (global batch / world rows) as tensors on its
    device: the rank's part of JAX's global batch-sharded arrays."""
    if data_axis != "data":
        raise ValueError(f"the mesh has one axis, 'data'; got {data_axis!r}")
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device, non_blocking=True)
            for k, v in batch.items()}


class MultiHostLoader:
    """A per-sample dataset as rank-sharded global batches.

    Args:
        dataset: indexable yielding dicts of numpy arrays (fixed shapes).
        global_batch: total batch size across all ranks.
        mesh: the ('data',) mesh; each rank gets its rows, on its device.
    """

    def __init__(self, dataset, global_batch: int, mesh: Mesh, *, seed: int = 0,
                 shuffle: bool = True, collate=None, data_axis: str = "data"):
        if global_batch % mesh.world:
            raise ValueError(f"a global batch of {global_batch} does not split over "
                             f"{mesh.world} ranks")
        self.dataset = dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // mesh.world
        self.mesh = mesh
        self.seed = seed
        self.shuffle = shuffle
        self.collate = collate or (lambda samples: {
            k: np.stack([s[k] for s in samples]) for k in samples[0]
        })
        self.data_axis = data_axis
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        return host_shard_indices(len(self.dataset), self.seed, self.epoch, self.shuffle,
                                  self.mesh.rank, self.mesh.world)

    def __len__(self):
        return len(self._indices()) // self.local_batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = self._indices()
        for i in range(len(idx) // self.local_batch):
            rows = [self.dataset[int(j)] for j in idx[i * self.local_batch:(i + 1) * self.local_batch]]
            yield make_global_batch(self.collate(rows), self.mesh, self.data_axis)
