"""Data parallelism over torch.distributed ranks (port of yolo_dbl_tpu/parallel/,
its 'data' axis)."""

from .input import MultiHostLoader, distributed_init, host_shard_indices, make_global_batch
from .mesh import Mesh, data_sharding, local_rows, make_mesh, replicated, shard_batch

__all__ = ["Mesh", "MultiHostLoader", "data_sharding", "distributed_init", "host_shard_indices",
           "local_rows", "make_global_batch", "make_mesh", "replicated", "shard_batch"]
