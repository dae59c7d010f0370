"""Tensor- and spatial-parallel sharding rules over the ('data', 'model') mesh
(port of yolo_dbl_tpu/parallel/shardings.py).

The rule is the JAX package's, leaf for leaf. Two modes ride the 'model'
axis:

- **TP (channel sharding)**: conv kernels of at least `min_size` elements
  shard alternately on their output-channel (HWIO minor) and input-channel
  dims in natural order of their JAX paths, Megatron column -> row style;
  dense kernels shard their output dim; everything smaller replicates.
  parallel/tensor.py runs a model under these specs, with explicit
  collectives where JAX's GSPMD inserts them.
- **SP (spatial sharding)**: NHWC image rows shard over 'model' and the
  batch over 'data' (`spatial_sharding`); parallel/spatial.py runs the
  forward on row shards with halo exchanges.

A spec is written as JAX writes its `PartitionSpec`, in the JAX package's
layouts: a conv kernel is HWIO (the port's `weight` is OIHW: JAX's I is
`weight.shape[1]`, its O `weight.shape[0]`), a dense kernel (in, out) (the
port's `Linear.weight` is (out, in)). `()` is replicated, so a spec
compares equal to `tuple(jax_partition_spec)`.
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping
from typing import Any, Dict, Tuple

import torch

from ..utils.convert import jax_param_paths, transposed_convs
from .mesh import Mesh, data_sharding  # noqa: F401 (the JAX module's export)
from .spatial import spatial_sharding  # noqa: F401 (the JAX module's export)

Spec = Tuple[Any, ...]
REPLICATED: Spec = ()
COL: Spec = (None, None, None, "model")  # conv kernel O-sharded: column-parallel
ROW: Spec = (None, None, "model", None)  # conv kernel I-sharded: row-parallel
DENSE_OUT: Spec = (None, "model")
# the containers of a training state whose leaves are copies of one
# parameter (params, EMA, optimizer moments): a leaf's canonical id is its
# path below them, as JAX's is the trailing run of dict keys below a
# TrainState's attributes
STATE_COPIES = ("params", "ema_params", "opt_state", "trace", "mu", "nu", "acc")


def model_axis_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def _natural_key(path: str):
    """Sort key treating digit runs numerically (layers_2 < layers_10)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", path)]


def _leaf_spec(path: str, shape: Tuple[int, ...], n_model: int, min_size: int,
               shard_in: bool = False) -> Spec:
    """The spec of one leaf of JAX-layout `shape`."""
    if len(shape) == 0 or math.prod(shape) < min_size:
        return REPLICATED
    if len(shape) == 4:  # conv kernel HWIO
        if shard_in and shape[2] % n_model == 0:
            return ROW  # row-parallel: contract + psum
        if shape[-1] % n_model == 0:
            return COL  # column-parallel
        return REPLICATED
    if shape[-1] % n_model != 0:
        return REPLICATED
    if len(shape) == 2:  # dense (in, out) -> shard out
        return DENSE_OUT
    if len(shape) == 1:  # bias / BN vectors follow their conv's O sharding
        return ("model",)
    return REPLICATED


def jax_shape(module: torch.nn.Module, name: str, tensor: torch.Tensor) -> Tuple[int, ...]:
    """The JAX layout's shape of parameter `name` of `module`."""
    if name == "weight" and isinstance(module, torch.nn.Conv2d):
        o, i, kh, kw = tensor.shape
        return (kh, kw, i, o)
    if name == "weight" and isinstance(module, torch.nn.Linear):
        return tuple(tensor.shape[::-1])
    return tuple(tensor.shape)


def _model_leaves(model: torch.nn.Module):
    """[(parameter name, canonical id, JAX path, JAX shape)] of a model."""
    paths = jax_param_paths(model)
    modules = dict(model.named_modules())
    out = []
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        path = paths[name]
        out.append((name, tuple(path.split("/")), path, jax_shape(modules[mod_name], leaf, p)))
    return out


def _tree_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _tree_leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _canonical_id(path: Tuple[str, ...]) -> Tuple[str, ...]:
    i = 0
    while i < len(path) - 1 and path[i] in STATE_COPIES:
        i += 1
    return path[i:]


def _set(tree: Dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def model_parallel_shardings(model_or_state, mesh: Mesh, min_size: int = 1 << 14,
                             alternate: bool = True):
    """Per-leaf specs for TP over the 'model' axis (shardings.py:67).

    Eligible conv kernels alternate column-parallel (O) / row-parallel (I)
    in natural path order; alternate=False keeps the uniform-O rule.
    Parameters smaller than `min_size` elements replicate. With n_model == 1
    everything replicates. The alternation is keyed on the kernel, so the
    copies of one kernel share its spec.

    `model_or_state` is a model ({parameter name: spec}, ordered by its JAX
    path) or a nested mapping of JAX-layout arrays (variables, or a
    training state whose copies sit under `STATE_COPIES` keys; a mapping of
    specs of the same structure)."""
    n_model = model_axis_size(mesh)
    if isinstance(model_or_state, torch.nn.Module):
        from ..nn.heads import OBB, Classify, IDetect, Pose, Segment
        from ..nn.tasks import POOL_MODULES, RTDETR_MODULES

        if n_model > 1 and any(isinstance(m, IDetect) for m in model_or_state.modules()):
            # its ia/im leaves are (1, C, 1, 1) here, (1, 1, 1, C) in JAX: no rule reads them
            raise NotImplementedError("IDetect's implicit leaves have no tensor-parallel rule yet "
                                      "(ROADMAP Queue 1 item 7)")
        task = next((m for m in model_or_state.modules()
                     if isinstance(m, (Segment, Pose, OBB, Classify))), None)
        if n_model > 1 and task is not None:
            # tuple and logit outputs, and Proto's transposed conv: not held to one process yet
            raise NotImplementedError(f"the {type(task).__name__} head has no tensor-parallel "
                                      "form yet (ROADMAP Queue 1 item 7)")
        pool = next((m for m in model_or_state.modules()
                     if isinstance(m, POOL_MODULES + RTDETR_MODULES)), None)
        if n_model > 1 and pool is not None:
            raise NotImplementedError(f"{type(pool).__name__} has no tensor-parallel form yet "
                                      "(ROADMAP Queue 1 item 7)")
        if n_model > 1 and transposed_convs(model_or_state):
            # its weight is (in, out, kh, kw): the rule below would shard the wrong axis
            raise NotImplementedError(
                f"ConvTranspose2d ({', '.join(sorted(transposed_convs(model_or_state)))}) has no "
                "tensor-parallel form yet (ROADMAP Queue 1 item 7)")
        leaves = _model_leaves(model_or_state)
    else:
        leaves = [(path, _canonical_id(path), "/".join(path), tuple(arr.shape))
                  for path, arr in _tree_leaves(model_or_state)]
    shard_ids = set()
    if alternate and n_model > 1:
        elig = {}
        for _, cid, _, shape in leaves:
            if len(shape) == 4 and math.prod(shape) >= min_size and shape[-1] % n_model == 0:
                elig.setdefault(cid, shape)
        parity = 0
        for cid in sorted(elig, key=lambda c: _natural_key("/".join(c))):
            if parity % 2 == 1 and elig[cid][2] % n_model == 0:
                shard_ids.add(cid)
            parity += 1
    specs = {}
    for key, cid, path, shape in leaves:
        specs[key] = (REPLICATED if n_model == 1 else
                      _leaf_spec(path, shape, n_model, min_size, shard_in=cid in shard_ids))
    if isinstance(model_or_state, torch.nn.Module):
        return specs
    out: Dict = {}
    for path, spec in specs.items():
        _set(out, path, spec)
    return out


def shard_variables(model: torch.nn.Module, mesh: Mesh, min_size: int = 1 << 14,
                    alternate: bool = True, pair: bool = True) -> torch.nn.Module:
    """Shard `model` in place by `model_parallel_shardings`: each layer with
    a sharded kernel keeps its shard and runs its collectives
    (parallel/tensor.py `shard_model`)."""
    from .tensor import shard_model

    return shard_model(model, mesh, min_size=min_size, alternate=alternate, pair=pair)
