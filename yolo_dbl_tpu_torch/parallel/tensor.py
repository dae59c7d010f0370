"""Tensor parallelism over the mesh's 'model' axis: the layers and their
collectives (the port's own; the JAX package gets TP from GSPMD, which
inserts the collectives its sharding annotations imply).

`shard_model(model, mesh)` shards a model in place by
parallel/shardings.py's specs. Each layer whose kernel spec is sharded
keeps only its shard (`Shard`, read by nn/common.py `conv2d` and `linear`):

- column-parallel conv (JAX's O-sharded HWIO kernel): its output-channel
  slice of the kernel; the input is replicated (`copy`: identity forward,
  all-reduce backward). Inside `Conv`, `DWConv` and `DSConv` its BatchNorm
  and activation run on the slice (`BatchNorm.channels`);
- depthwise conv with an O-sharded kernel (its HWIO I is 1): the input is
  sliced to the same channels (`scatter`: slice forward, all-gather
  backward);
- row-parallel conv (I-sharded): its input-channel slice of the kernel; a
  replicated input is sliced (`scatter`), the partial sums are reduced over
  'model' (`reduce`: all-reduce forward, identity backward) and the bias is
  added once after the reduce;
- column-parallel dense (the hypergraph's (in, out) kernels, out-sharded).

Between layers the activation is replicated: a column-parallel output is
gathered (`gather`: all-gather forward, slice backward). The exception is a
column-parallel conv whose only consumer is a row-parallel conv (found by
one probing forward, `_probe_pairs`): its slice passes straight through, so
the pair costs one all-reduce forward and one backward, JAX's "one psum per
pair" (shardings.py:8-18). Every rank computes the whole loss on its data
coordinate's rows, so a replicated parameter's gradient is whole on every
model rank, except where a replicated vector is used by its slice (the
BatchNorm after a column-parallel conv, a column-parallel bias): those
gradients are zero outside the slice and are completed by a sum over
'model' (`TensorParallel.reduce_replicated`), which also keeps the whole
ones bit for bit equal on the model ranks. The forward and the gradients
are those of the one-process model, up to summation order.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .mesh import Mesh
from .shardings import COL, DENSE_OUT, REPLICATED, ROW, model_parallel_shardings


# ------------------------------------------------------------------ collectives


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce over 'model' backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                   axis="model"), None


class _Reduce(torch.autograd.Function):
    """All-reduce over 'model' forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), axis="model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` over 'model' forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.local = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, axis="model", dim=dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh.coords["model"]
        return g.narrow(ctx.dim, m * ctx.local, ctx.local), None, None


class _Scatter(torch.autograd.Function):
    """This rank's slice along `dim` forward, all-gather over 'model' backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        local = x.shape[dim] // mesh.n_model
        return x.narrow(dim, mesh.coords["model"] * local, local)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, axis="model", dim=ctx.dim), None, None


def copy(x, mesh: Mesh):
    return _Copy.apply(x, mesh)


def reduce(x, mesh: Mesh):
    return _Reduce.apply(x, mesh)


def gather(x, mesh: Mesh, dim: int):
    return _Gather.apply(x, mesh, dim)


def scatter(x, mesh: Mesh, dim: int):
    return _Scatter.apply(x, mesh, dim)


# ------------------------------------------------------------------ layers


@dataclass(eq=False)
class Shard:
    """A sharded layer's part: `kind` is "col" (a conv's output channels),
    "dw" (a depthwise conv's channels), "row" (a conv's input channels) or
    "dense" (a dense layer's outputs); `full` is the whole size of the
    sharded dim. With `defer`, the owning module runs its BatchNorm and
    activation on the slice and gathers after them (`finish`); with
    `passthrough`, the slice goes on to its one row-parallel consumer."""

    kind: str
    mesh: Mesh
    full: int
    defer: bool = False
    passthrough: bool = False

    @property
    def sl(self) -> slice:
        per = self.full // self.mesh.n_model
        m = self.mesh.coords["model"]
        return slice(m * per, (m + 1) * per)

    def conv(self, conv: nn.Conv2d, x):
        w = conv.weight.to(x.dtype)
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        mesh = self.mesh
        if self.kind == "row":
            if x.shape[1] == conv.in_channels:
                x = scatter(x, mesh, 1)
            elif x.shape[1] * mesh.n_model != conv.in_channels:
                raise ValueError(f"a row-parallel conv of {conv.in_channels} inputs got "
                                 f"{x.shape[1]} channels")
            y = reduce(F.conv2d(x, w, None, conv.stride, conv.padding, conv.dilation), mesh)
            return y if bias is None else y + bias.view(1, -1, 1, 1)
        x = copy(x, mesh) if self.kind == "col" else scatter(x, mesh, 1)
        groups = 1 if self.kind == "col" else w.shape[0]
        y = F.conv2d(x, w, None if bias is None else bias[self.sl], conv.stride, conv.padding,
                     conv.dilation, groups)
        return y if self.defer else self.finish(y)

    def finish(self, y):
        """A column-parallel unit's output: gathered, or the slice itself
        for its row-parallel consumer."""
        return y if self.passthrough else gather(y, self.mesh, 1)

    def linear(self, dense: nn.Linear, x):
        y = F.linear(copy(x, self.mesh), dense.weight.to(x.dtype),
                     dense.bias.to(x.dtype)[self.sl])
        return gather(y, self.mesh, -1)


@dataclass(eq=False)
class TensorParallel:
    """What `shard_model` did to a model (`model.tp`): the mesh, every
    parameter's spec, the torch dim each sharded parameter is split on,
    the replicated parameters used by their slice (`partial`) and the
    BatchNorm layers that run on a slice."""

    mesh: Mesh
    specs: Dict[str, tuple]
    dims: Dict[str, int]
    partial: List[str]
    sliced_bns: List[nn.Module] = field(default_factory=list)
    pairs: List[str] = field(default_factory=list)

    def gather_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf `name` from this rank's `t` (a collective)."""
        if name not in self.dims:
            return t
        return self.mesh.all_gather(t.detach(), axis="model", dim=self.dims[name])

    def shard_leaf(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf `name`."""
        if name not in self.dims:
            return whole
        dim = self.dims[name]
        per = whole.shape[dim] // self.mesh.n_model
        return whole.narrow(dim, self.mesh.coords["model"] * per, per)

    @torch.no_grad()
    def sync_statistics(self):
        """Every model rank's slice of the sliced BatchNorms' running
        statistics into every rank's buffers: one all-gather."""
        if not self.sliced_bns:
            return
        mine = torch.cat([t[bn.channels] for bn in self.sliced_bns
                          for t in (bn.running_mean, bn.running_var)])
        parts = self.mesh.all_gather(mine, axis="model").view(self.mesh.n_model, -1)
        offset = 0
        for bn in self.sliced_bns:
            for t in (bn.running_mean, bn.running_var):
                per = t.numel() // self.mesh.n_model
                t.copy_(parts[:, offset:offset + per].reshape(-1))
                offset += per

    @torch.no_grad()
    def reduce_replicated(self, names: Sequence[str], grads: Sequence[torch.Tensor]):
        """Complete the replicated leaves' gradients over 'model', in place
        and in one all-reduce: a `partial` one is summed (each rank holds
        its slice), a whole one averaged (equal bits stay equal; the model
        ranks agree even where the card's atomics ordered them apart)."""
        idx = [i for i, n in enumerate(names) if n not in self.dims]
        if not idx:
            return
        n = self.mesh.n_model
        partial = set(self.partial)
        flat = torch.cat([(grads[i] if names[i] in partial else grads[i] / n).reshape(-1).float()
                          for i in idx])
        self.mesh.all_reduce(flat, axis="model")
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i].copy_(part.view(grads[i].shape))


def _owners(model: nn.Module):
    """{name of a conv: (its module, the BatchNorm after it)} for the convs
    whose BatchNorm and activation belong to their module (Conv, DWConv,
    DSConv's pointwise conv)."""
    from ..nn.common import Conv, DSConv, DWConv

    out = {}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, (Conv, DWConv)):
            out[prefix + "conv"] = (mod, mod.bn)
        elif isinstance(mod, DSConv):
            out[prefix + "pw"] = (mod, mod.bn)
    return out


def _probe_pairs(model, plan: Dict[str, str], owners, imgsz: int) -> List[str]:
    """The column-parallel convs whose unit output (the owning module's
    output, else the conv's own) has one use in a forward, as the input of
    a row-parallel conv: one float32 eval forward of the whole model at
    `imgsz`, every torch call recorded (torch.overrides.TorchFunctionMode)."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_flatten

    modules = dict(model.named_modules())
    cols = [n for n, k in plan.items() if k in ("col", "dw")]
    rows = {modules[n].weight.data_ptr() for n, k in plan.items() if k == "row"}
    raw = {modules[n].weight.data_ptr(): n for n in cols if n not in owners}
    unit, uses, keep = {}, defaultdict(list), []
    handles = [owners[n][0].register_forward_hook(
        lambda m, a, out, n=n: unit.__setitem__(n, out)) for n in cols if n in owners]

    class Uses(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if any(isinstance(t, torch.Tensor) for t in tree_flatten(out)[0]):
                keep.append(out)
                for t in tree_flatten((args, kwargs))[0]:
                    if isinstance(t, torch.Tensor):
                        uses[id(t)].append((func, args))
                if func is F.conv2d and args[1].data_ptr() in raw:
                    unit[raw[args[1].data_ptr()]] = out
            return out

    was_training, dtype = model.training, model._dtype
    model.eval()
    model._dtype = torch.float32  # the kernels themselves reach conv2d
    try:
        with torch.no_grad(), Uses():
            model(torch.zeros((1, imgsz, imgsz, 3), device=model.device))
    finally:
        model._dtype = dtype
        model.train(was_training)
        for h in handles:
            h.remove()
    pairs = []
    for n, t in unit.items():
        u = uses.get(id(t), [])
        if (len(u) == 1 and u[0][0] is F.conv2d and u[0][1][0] is t
                and u[0][1][1].data_ptr() in rows):
            pairs.append(n)
    keep.clear()
    return sorted(pairs)


def _plan(model, specs) -> Dict[str, str]:
    """{module name: kind} of the layers whose kernel spec is sharded."""
    modules = dict(model.named_modules())
    plan = {}
    for name, spec in specs.items():
        if spec == REPLICATED:
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = modules[mod_name]
        if isinstance(mod, nn.Linear) and leaf == "weight" and spec == DENSE_OUT:
            plan[mod_name] = "dense"
        elif isinstance(mod, nn.Conv2d) and leaf == "weight" and spec == COL and mod.groups == 1:
            plan[mod_name] = "col"
        elif (isinstance(mod, nn.Conv2d) and leaf == "weight" and spec == COL
              and mod.groups == mod.in_channels == mod.out_channels):
            plan[mod_name] = "dw"
        elif isinstance(mod, nn.Conv2d) and leaf == "weight" and spec == ROW and mod.groups == 1:
            plan[mod_name] = "row"
        else:
            raise NotImplementedError(f"no tensor-parallel layer for {name} "
                                      f"({type(mod).__name__}, spec {spec})")
    return plan


@torch.no_grad()
def shard_model(model, mesh: Mesh, min_size: int = 1 << 14, alternate: bool = True,
                pair: bool = True):
    """Shard `model` (a DetectionModel) in place over `mesh`'s 'model' axis
    by `model_parallel_shardings`; returns it, with `model.tp` set. Every
    model rank must hold the same whole weights when it is called. With
    `pair` off, every column-parallel output is gathered (the comparison
    the pairing is measured against)."""
    if getattr(model, "tp", None) is not None:
        raise ValueError("the model is sharded already")
    specs = model_parallel_shardings(model, mesh, min_size, alternate)
    if mesh.n_model == 1:
        model.tp = TensorParallel(mesh, specs, {}, [])
        return model
    plan = _plan(model, specs)
    owners = _owners(model)
    pairs = _probe_pairs(model, plan, owners, 2 * max(model.strides)) if pair else []
    modules = dict(model.named_modules())
    dims, partial, bns = {}, [], []
    channels_last = model.device.type == "cuda"
    for mod_name, kind in plan.items():
        mod = modules[mod_name]
        dim = 1 if kind == "row" else 0
        full = mod.weight.shape[dim]
        if full % mesh.n_model:
            raise ValueError(f"{mod_name}: {full} channels do not split over {mesh.n_model}")
        shard = Shard(kind, mesh, full, defer=kind in ("col", "dw") and mod_name in owners,
                      passthrough=mod_name in pairs)
        w = mod.weight.narrow(dim, mesh.coords["model"] * (full // mesh.n_model),
                              full // mesh.n_model)
        fmt = torch.channels_last if channels_last and w.dim() == 4 else torch.contiguous_format
        mod.weight = nn.Parameter(w.clone(memory_format=fmt), requires_grad=mod.weight.requires_grad)
        mod.shard = shard
        prefix = f"{mod_name}."
        dims[prefix + "weight"] = dim
        if kind != "row" and mod.bias is not None:
            partial.append(prefix + "bias")
        if shard.defer:
            owner_bn = owners[mod_name][1]
            owner_bn.channels = shard.sl
            bns.append(owner_bn)
            bn_name = next(n for n, m in modules.items() if m is owner_bn)
            partial += [f"{bn_name}.weight", f"{bn_name}.bias"]
    model.tp = TensorParallel(mesh, specs, dims, partial, bns, pairs)
    return model
