"""Weight bridge: JAX `variables` (nested dicts of numpy arrays) → PyTorch state_dict.

Module and attribute names of the port are the flax scope names, so a leaf
`params/m9/m_0/cv1/conv/kernel` becomes `m9.m_0.cv1.conv.weight`. The rules:

- conv kernel HWIO → OIHW (depthwise (kh, kw, 1, C) → (C, 1, kh, kw));
- Dense kernel (I, O) → (O, I);
- BatchNorm params scale/bias → weight/bias, batch_stats mean/var →
  running_mean/running_var;
- `prototype_base`, the FullPAD `gate` and the A2C2f `gamma` are copied as
  they are.

Any leaf without a rule, and any key missing on either side, raises.

`params_from_jax` maps a tree shaped like JAX `params` (the params
themselves, EMA params, gradients) onto the port's parameter names, and
`jax_param_paths` names each of the port's parameters by its JAX path, for
rules written against JAX paths (the optimizer's decay and freeze masks).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

# BatchNorm's step counter exists only on the PyTorch side; it is set to 0.
TORCH_ONLY_SUFFIX = "num_batches_tracked"
# parameters whose name and layout are the same on both sides
COPIED_LEAVES = ("prototype_base", "gate", "gamma")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _torch_leaf(collection: str, path, arr: np.ndarray):
    *scopes, leaf = path
    if collection == "params":
        if leaf == "kernel" and arr.ndim == 4:
            return scopes, "weight", arr.transpose(3, 2, 0, 1)
        if leaf == "kernel" and arr.ndim == 2:
            return scopes, "weight", arr.T
        if leaf == "scale":
            return scopes, "weight", arr
        if leaf in ("bias",) + COPIED_LEAVES:
            return scopes, leaf, arr
    elif collection == "batch_stats":
        if leaf in ("mean", "var"):
            return scopes, f"running_{leaf}", arr
    raise KeyError(f"no rule for JAX leaf {collection}/{'/'.join(path)} {arr.shape}")


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """Map every leaf of a JAX variables tree to its state_dict entry, in
    float32 (float64 leaves stay float64)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            scopes, name, arr = _torch_leaf(collection, path, np.asarray(value))
            key = ".".join([*scopes, name])
            if key in out:
                raise KeyError(f"two JAX leaves map to {key}")
            dtype = np.float64 if arr.dtype == np.float64 else np.float32
            out[key] = torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
    return out


def load_jax_variables(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into `module`; raises on any key unmapped either way."""
    sd = state_dict_from_jax(variables)
    own = module.state_dict()
    torch_only = {k for k in own if k.endswith(TORCH_ONLY_SUFFIX)}
    missing = sorted(set(own) - set(sd) - torch_only)
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"weight bridge mismatch: {len(missing)} state_dict keys without a JAX "
                       f"leaf {missing[:8]}, {len(unexpected)} JAX leaves without a state_dict "
                       f"key {unexpected[:8]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: JAX {tuple(v.shape)} vs PyTorch {tuple(own[k].shape)}")
    for k in torch_only:
        sd[k] = torch.zeros_like(own[k])
    module.load_state_dict(sd, strict=True)
    return module


def params_from_jax(module: torch.nn.Module, tree) -> Dict[str, torch.Tensor]:
    """Map a params-shaped JAX tree leaf by leaf to {parameter name: tensor}
    in the port's layouts; raises unless it covers exactly the parameters of
    `module`."""
    out = state_dict_from_jax({"params": tree})
    own = dict(module.named_parameters())
    if set(out) != set(own):
        raise KeyError(f"params bridge mismatch: {sorted(set(own) - set(out))[:8]} without a JAX "
                       f"leaf, {sorted(set(out) - set(own))[:8]} without a parameter")
    for k, v in out.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: JAX {tuple(v.shape)} vs PyTorch {tuple(own[k].shape)}")
    return out


def jax_param_paths(module: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: its JAX params path}, e.g. `m9.m_0.cv1.conv.weight`
    → `m9/m_0/cv1/conv/kernel`: the inverse of the rules above."""
    paths = {}
    for mod_name, mod in module.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            leaf = name
            if name == "weight" and isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                leaf = "kernel"
            elif name == "weight" and isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                leaf = "scale"
            elif name not in ("bias",) + COPIED_LEAVES:
                raise KeyError(f"no JAX rule for parameter {mod_name}.{name}")
            key = f"{mod_name}.{name}" if mod_name else name
            paths[key] = "/".join([*mod_name.split("."), leaf] if mod_name else [leaf])
    return paths
