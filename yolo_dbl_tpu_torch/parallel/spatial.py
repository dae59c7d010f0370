"""Spatial parallelism (SP) for predict over the mesh's 'model' axis (the
port's own; the JAX package shards NHWC rows with `spatial_sharding`,
P('data', 'model'), and XLA inserts the halo exchanges).

Inside `spatial(model, mesh)` a forward of `model` takes the images of this
rank's data coordinate, keeps the image rows of its model coordinate and
runs on them:

- each conv runs on the rank's rows extended by a halo from its neighbours
  (`Spatial.halo`: one all-gather over 'model' of every rank's edge rows),
  zero rows only beyond the image's global border, and stride-aligned rows,
  so that it computes exactly the whole map's rows of this rank (a halo
  deeper than a rank's rows comes from the gathered whole map);
- SPPF's three k x k max-pools run on rows extended by 3 (k // 2) rows of
  the neighbours (none at the image's border, where the pool's own -inf
  padding is the global one) and are cropped back;
- nearest upsample, 2x2 average pool, concat, BatchNorm and the elementwise
  ops are local;
- the ops that read the whole map gather the rows, compute replicated and
  keep their rows: the hypergraph (AdaHGComputation), area attention
  (AAttn) and DySample;
- Detect's per-level maps are gathered at its output, so the anchors, the
  decode and the NMS run replicated on whole maps.

The rows a rank holds must divide by the model's largest stride at every
level; a size that does not divide raises (nothing is padded).
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
from torch import nn
from torch.nn import functional as F

from .mesh import Mesh, local_rows


def spatial_sharding(mesh: Mesh):
    """The placement P('data', 'model') of NHWC images: the batch rows of
    this rank's data coordinate and the image rows of its model coordinate."""

    def place(v):
        v = torch.as_tensor(v)
        v = v[local_rows(mesh, v.shape[0])]
        return v[:, _rows(mesh, v.shape[1])].to(mesh.device, non_blocking=True)

    return place


def _rows(mesh: Mesh, h: int) -> slice:
    n = mesh.n_model
    if h % n:
        raise ValueError(f"{h} rows do not split over {n} model ranks")
    per = h // n
    m = mesh.coords["model"]
    return slice(m * per, (m + 1) * per)


class _HaloConv:
    """A conv's `shard` inside `spatial`: halo rows, then the conv."""

    defer = False

    def __init__(self, sp: "Spatial"):
        self.sp = sp

    def conv(self, conv: nn.Conv2d, x):
        w = conv.weight.to(x.dtype)
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        if not self.sp.active:
            return F.conv2d(x, w, bias, conv.stride, conv.padding, conv.dilation, conv.groups)
        (k, _), (s, _), (p, pw), (d, _) = conv.kernel_size, conv.stride, conv.padding, conv.dilation
        if x.shape[2] % s:
            raise ValueError(f"{x.shape[2]} rows a rank do not align with a stride-{s} conv")
        top, bottom = p, d * (k - 1) + 1 - s - p
        x = self.sp.halo(x, top, max(bottom, 0), 0.0)
        if bottom < 0:
            x = x[:, :, :x.shape[2] + bottom]
        return F.conv2d(x, w, bias, conv.stride, (0, pw), conv.dilation, conv.groups)


class Spatial:
    """The state of a row-sharded forward: its mesh, whether the rows are
    sharded at this point of the forward (`active`; off inside an op that
    gathered them) and the bytes each rank sent for halos and gathers."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.depth = 0  # gathered ops entered and not yet left
        self.halo_bytes = 0
        self.gather_bytes = 0

    @property
    def active(self) -> bool:
        return self.depth == 0

    def halo(self, x, top: int, bottom: int, fill=0.0):
        """NCHW rows `x` of this rank extended by the last `top` rows of the
        rank above and the first `bottom` rows of the rank below; beyond the
        image's border `fill` rows, or none where `fill` is None."""
        n, m = self.mesh.n_model, self.mesh.coords["model"]
        h = x.shape[2]
        if top == 0 and bottom == 0:
            return x
        if top > h or bottom > h:  # a halo past the neighbours' rows: from the whole map
            whole = self.gather(x)
            lo, hi = m * h - top, (m + 1) * h + bottom
            b, c, _, w = x.shape
            above = [] if fill is None or lo >= 0 else [x.new_full((b, c, -lo, w), fill)]
            below = ([] if fill is None or hi <= n * h else
                     [x.new_full((b, c, hi - n * h, w), fill)])
            return torch.cat([*above, whole[:, :, max(lo, 0):min(hi, n * h)], *below], 2)
        edges = torch.cat([x[:, :, :bottom], x[:, :, h - top:]], 2)
        parts = self.mesh.all_gather(edges[None], axis="model", dim=0)
        self.halo_bytes += edges.numel() * edges.element_size()
        b, c, _, w = x.shape
        above = [parts[m - 1][:, :, bottom:]] if m > 0 else (
            [] if fill is None else [x.new_full((b, c, top, w), fill)])
        below = [parts[m + 1][:, :, :bottom]] if m < n - 1 else (
            [] if fill is None else [x.new_full((b, c, bottom, w), fill)])
        return torch.cat([*above, x, *below], 2)

    def gather(self, x):
        """The whole map's rows from every rank's NCHW rows."""
        self.gather_bytes += x.numel() * x.element_size()
        return self.mesh.all_gather(x, axis="model", dim=2)

    def rows(self, x):
        return x[:, :, _rows(self.mesh, x.shape[2])]


def _gathered(sp: Spatial, module: nn.Module) -> List:
    """Hooks making `module` read the whole map: its input rows gathered,
    its output's rows kept."""

    def pre(m, args):
        if not sp.active:
            return None
        m._sp_entered = True
        sp.depth += 1
        return (sp.gather(args[0]), *args[1:])

    def post(m, args, out):
        if not getattr(m, "_sp_entered", False):
            return None
        del m._sp_entered
        sp.depth -= 1
        return sp.rows(out)

    return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]


def _pooled(sp: Spatial, module: nn.Module, rows: int) -> List:
    """Hooks running SPPF on rows extended by `rows` rows of the neighbours
    (none at the image's border) and cropping them back."""

    def pre(m, args):
        if not sp.active:
            return None
        x = args[0]
        ext = sp.halo(x, rows, rows, None)
        m._sp_crop = (min(rows, sp.mesh.coords["model"] * x.shape[2]), ext.shape[2] - x.shape[2])
        sp.depth += 1
        return (ext, *args[1:])

    def post(m, args, out):
        crop = getattr(m, "_sp_crop", None)
        if crop is None:
            return None
        del m._sp_crop
        sp.depth -= 1
        top, extra = crop
        return out[:, :, top:out.shape[2] - (extra - top)]

    return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]


@contextlib.contextmanager
def spatial(model, mesh: Mesh):
    """Inside the block, `model` (a DetectionModel) runs its forward on the
    image rows of this rank's model coordinate (module note); yields the
    `Spatial` state, whose counters read the halo and gather bytes. The
    model's output is the whole map's, on every model rank."""
    from ..nn.attention import SLA
    from ..nn.blocks import SPPF, AAttn, AdaHGComputation, DySample
    from ..nn.heads import Detect
    from ..nn.upsample import carafe

    if getattr(model, "tp", None) is not None:
        raise ValueError("spatial parallelism runs a whole (unsharded) model")
    local_only = (SLA, carafe.CARAFE, carafe.CARAFEPack, carafe.CARAFE_XiaLiPKU,
                  carafe.CARAFE_simplified, carafe.DLU)
    sp = Spatial(mesh)
    stride = max(model.strides)
    hooks = []

    def enter(m, args):  # the first layer's NCHW input: the image
        x = args[0]
        if x.shape[2] % (mesh.n_model * stride):
            raise ValueError(f"{x.shape[2]} image rows do not split over {mesh.n_model} model "
                             f"ranks at stride {stride}")
        return (sp.rows(x), *args[1:])

    hooks.append(next(model.children()).register_forward_pre_hook(enter))
    convs = []
    for mod in model.modules():
        if isinstance(mod, local_only):
            raise NotImplementedError(f"{type(mod).__name__} has no spatial-parallel form yet")
        if isinstance(mod, (AdaHGComputation, AAttn, DySample)):
            hooks += _gathered(sp, mod)
        elif isinstance(mod, SPPF):
            hooks += _pooled(sp, mod, 3 * (mod.k // 2))
        elif isinstance(mod, Detect):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out: [sp.gather(o) for o in out]))
        elif isinstance(mod, nn.Conv2d):
            if getattr(mod, "shard", None) is not None:
                raise ValueError("the model has sharded layers")
            convs.append(mod)
    halo = _HaloConv(sp)
    for conv in convs:
        conv.shard = halo
    try:
        yield sp
    finally:
        for conv in convs:
            del conv.shard
        for h in hooks:
            h.remove()
