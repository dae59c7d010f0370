"""Data, tensor and spatial parallelism over torch.distributed ranks (port of
yolo_dbl_tpu/parallel/: the ('data', 'model') mesh and its shardings)."""

from .input import MultiHostLoader, distributed_init, host_shard_indices, make_global_batch
from .mesh import Mesh, data_sharding, local_rows, make_mesh, replicated, shard_batch
from .shardings import model_axis_size, model_parallel_shardings, shard_variables, spatial_sharding

__all__ = ["Mesh", "MultiHostLoader", "data_sharding", "distributed_init", "host_shard_indices",
           "local_rows", "make_global_batch", "make_mesh", "model_axis_size",
           "model_parallel_shardings", "replicated", "shard_batch", "shard_variables",
           "spatial_sharding"]
