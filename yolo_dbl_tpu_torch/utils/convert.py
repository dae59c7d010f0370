"""Weight bridge: JAX `variables` (nested dicts of numpy arrays) → PyTorch state_dict.

Module and attribute names of the port are the flax scope names, so a leaf
`params/m9/m_0/cv1/conv/kernel` becomes `m9.m_0.cv1.conv.weight`. The rules:

- conv kernel HWIO → OIHW (depthwise (kh, kw, 1, C) → (C, 1, kh, kw));
- a transposed conv's kernel (kh, kw, in, out) → (in, out, kh, kw), flipped
  in space: flax's `nn.ConvTranspose` (transpose_kernel=False) correlates
  the dilated input with the kernel as it stands, torch's ConvTranspose2d
  with the kernel flipped. Only the owning module tells this rule from the
  conv's (the shapes agree when in == out), so the callers that hold the
  module pass the names of its transposed convs (`transposed_convs`);
- Dense kernel (I, O) → (O, I); a flax MultiHeadDotProductAttention's
  DenseGeneral kernels (MHSA's `query`, `key`, `value` (C, heads, hd) and
  `out` (heads, hd, C)) and their (heads, hd) biases → nn.Linear's (O, I)
  and (O,), the heads flattened head-major. Only the owning module tells a
  3-D Dense kernel from a 1-D conv's, so the callers that hold the module
  pass the names of its nn.Linear layers (`dense_layers`);
- a 1-D conv's kernel (k, in, out) → Conv1d's (out, in, k) (C3k2_EAMC's
  `reduce_conv`);
- BatchNorm, LayerNorm and GroupNorm params scale/bias → weight/bias, batch_stats
  mean/var → running_mean/running_var;
- `prototype_base`, the FullPAD `gate`, the A2C2f and M2C2f `gamma`, DyT's
  and FGM's `alpha` and `beta`, FFM's `w`, the contrastive heads'
  scalar `logit_scale`, RT-DETR's packed attention projection
  `in_proj_weight` (3C, C) and `in_proj_bias`, and the catalogue's bare
  tables (BoTAttention's `rel_height`/`rel_width`, AxialAttention's
  `relative`, FusedKQnA's `q_param`, `attn_scale` and `rpb_table`, Swin's
  `relative_position_bias_table`, ECALayer_ns's (C, k) `conv`) and the last
  pool rows' bare leaves (LDA_AQU's `rpb`, EdgeAwareAttentionV2's (N, 3, 3)
  `kx` and `ky`, WTConv2d's `base_scale` and `wavelet_scale`,
  ImplicitFeaturizer's `biases` (2, d, n), LoftUp's learnable `lr_pe` and
  the bare `weight` and `bias` of its channel LayerNorm), and the
  structures' (ScConv's hand-written GroupNorm `gn_scale` and `gn_bias`,
  MFA's `rms_scale`), already in torch's layout, are copied as they are;
- a flax `Embed`'s `embedding` (n, C) → nn.Embedding's `weight`, as it is
  (RT-DETR's `denoising_class_embed`);
- YOLOv7 IDetect's implicit leaves `ia{i}` and `im{i}`, (1, 1, 1, C) in
  NHWC, → (1, C, 1, 1); its per-level bare conv `m{i}` is a conv like any
  other (`m105/m0/kernel` → `m105.m0.weight`).

Any leaf without a rule, and any key missing on either side, raises. The
v13 family's other leaves take the same rules: a flax BatchNorm called
directly (the CARAFE body's `comp_bn`, `enc_bn`), a bias-free `nn.Conv`
(SLA's `out_proj`, a (1, 1, C, C) kernel) and an `nn.Dense` (SLA's
`proj_l`) sit where the port's `BatchNorm`, `nn.Conv2d` and `nn.Linear` of
the same names sit; so do the structures' (PatchMerging's bias-free
`reduction` Dense, RepConvG's `dense_*`, `pw_*` and `id_bn` branches,
G-Ghost's bias-free `merge_fc*`, RepViT's `_Conv2dBN` `c` and `bn`,
MobileNetV3's `cls_fc*` and SE Dense layers).

The compute type does not enter here: a bfloat16 model
(`DetectionModel(..., dtype=torch.bfloat16)`) keeps float32 parameters and
BatchNorm statistics, as JAX keeps them under its bfloat16 `dtype`, so one
variable tree loads into a model of either type.

`params_from_jax` maps a tree shaped like JAX `params` (the params
themselves, EMA params, gradients) onto the port's parameter names, and
`jax_param_paths` names each of the port's parameters by its JAX path, for
rules written against JAX paths (the optimizer's decay and freeze masks).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, FrozenSet

import numpy as np
import torch

# BatchNorm's step counter exists only on the PyTorch side; it is set to 0.
TORCH_ONLY_SUFFIX = "num_batches_tracked"
# parameters whose name and layout are the same on both sides
COPIED_LEAVES = ("prototype_base", "gate", "gamma", "alpha", "beta", "w", "logit_scale",
                 "in_proj_weight", "in_proj_bias", "rel_height", "rel_width", "relative",
                 "q_param", "attn_scale", "rpb_table", "relative_position_bias_table", "conv",
                 "rpb", "kx", "ky", "base_scale", "wavelet_scale", "biases", "lr_pe", "weight",
                 "gn_scale", "gn_bias", "rms_scale")
# IDetect's implicit-knowledge leaves: (1, 1, 1, C) in JAX, (1, C, 1, 1) here
IMPLICIT_LEAF = re.compile(r"i[am]\d+")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def transposed_convs(module: torch.nn.Module) -> FrozenSet[str]:
    """The names of `module`'s nn.ConvTranspose2d layers, whose kernels take
    the transposed rule."""
    return frozenset(name for name, m in module.named_modules()
                     if isinstance(m, torch.nn.ConvTranspose2d))


def dense_layers(module: torch.nn.Module) -> FrozenSet[str]:
    """The names of `module`'s nn.Linear layers, whose 3-D kernels take the
    DenseGeneral rule."""
    return frozenset(name for name, m in module.named_modules() if isinstance(m, torch.nn.Linear))


def _torch_leaf(collection: str, path, arr: np.ndarray, transposed: FrozenSet[str],
                dense: FrozenSet[str] = frozenset()):
    *scopes, leaf = path
    if collection == "params":
        if leaf == "kernel" and arr.ndim == 3 and ".".join(scopes) in dense:
            flat = arr.reshape(-1, arr.shape[-1]) if scopes[-1] == "out" \
                else arr.reshape(arr.shape[0], -1)
            return scopes, "weight", flat.T
        if leaf == "bias" and arr.ndim == 2 and ".".join(scopes) in dense:
            return scopes, leaf, arr.reshape(-1)
        if leaf == "kernel" and arr.ndim == 4 and ".".join(scopes) in transposed:
            return scopes, "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if leaf == "kernel" and arr.ndim == 4:
            return scopes, "weight", arr.transpose(3, 2, 0, 1)
        if leaf == "kernel" and arr.ndim == 2:
            return scopes, "weight", arr.T
        if leaf == "kernel" and arr.ndim == 3:
            return scopes, "weight", arr.transpose(2, 1, 0)
        if leaf in ("scale", "embedding"):
            return scopes, "weight", arr
        if IMPLICIT_LEAF.fullmatch(leaf) and arr.ndim == 4:
            return scopes, leaf, arr.transpose(0, 3, 1, 2)
        if leaf in ("bias",) + COPIED_LEAVES:
            return scopes, leaf, arr
    elif collection == "batch_stats":
        if leaf in ("mean", "var"):
            return scopes, f"running_{leaf}", arr
    raise KeyError(f"no rule for JAX leaf {collection}/{'/'.join(path)} {arr.shape}")


def state_dict_from_jax(variables, transposed: FrozenSet[str] = frozenset(),
                        dense: FrozenSet[str] = frozenset()) -> Dict[str, torch.Tensor]:
    """Map every leaf of a JAX variables tree to its state_dict entry, in
    float32 (float64 leaves stay float64). `transposed`: the module names
    whose kernel is a transposed conv's (`transposed_convs`); `dense`: those
    whose 3-D kernel is a DenseGeneral's (`dense_layers`)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            scopes, name, arr = _torch_leaf(collection, path, np.asarray(value), transposed,
                                            dense)
            key = ".".join([*scopes, name])
            if key in out:
                raise KeyError(f"two JAX leaves map to {key}")
            dtype = np.float64 if arr.dtype == np.float64 else np.float32
            out[key] = torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
    return out


def load_jax_variables(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into `module`; raises on any key unmapped either way."""
    sd = state_dict_from_jax(variables, transposed_convs(module), dense_layers(module))
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
    out = state_dict_from_jax({"params": tree}, transposed_convs(module), dense_layers(module))
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
            if name == "weight" and isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                                     torch.nn.Linear, torch.nn.Conv1d)):
                leaf = "kernel"
            elif name == "weight" and isinstance(mod, (torch.nn.modules.batchnorm._BatchNorm,
                                                       torch.nn.LayerNorm, torch.nn.GroupNorm)):
                leaf = "scale"
            elif name == "weight" and isinstance(mod, torch.nn.Embedding):
                leaf = "embedding"
            elif name not in ("bias",) + COPIED_LEAVES and not IMPLICIT_LEAF.fullmatch(name):
                raise KeyError(f"no JAX rule for parameter {mod_name}.{name}")
            key = f"{mod_name}.{name}" if mod_name else name
            paths[key] = "/".join([*mod_name.split("."), leaf] if mod_name else [leaf])
    return paths
