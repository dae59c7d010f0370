"""Base convolution modules (NCHW inside, PyTorch).

Port of yolo_dbl_tpu/nn/common.py:33-363. Module and attribute names are
the flax scope names (`conv`, `bn`, `dw`, `pw`), so a JAX variable tree
maps onto a `state_dict` key by key (utils/convert.py).

- BatchNorm keeps the JAX package's eps=1e-3 (common.py:29-30), not
  PyTorch's 1e-5; momentum 0.03 is the torch form of flax's 0.97. In
  training it updates the running variance with the biased batch variance,
  as flax does (`BatchNorm` below).
- Under a mesh (`cross_rank`, entered by the trainer for a step)
  BatchNorm takes its statistics over the rows of the 'data' axis, as
  flax's does over JAX's global batch (`CrossRankBatchNorm`); without one
  the fused path below is unchanged. Under tensor parallelism
  (parallel/tensor.py) a BatchNorm after a column-parallel conv normalizes
  its channel slice (`BatchNorm.channels`) and `finish` gathers the
  module's output.
- The TPU-only concat fold (`Conv.call_parts`) and the fused s2d stem are
  not ported: plain concat + conv is the semantics they reproduce.
- Compute precision is flax's module `dtype` policy (common.py:13-14):
  parameters and BatchNorm statistics stay float32 and are cast to the
  compute type at the call, so autograd brings each gradient back to its
  float32 parameter. A module computes in its input's type and returns it,
  as a flax module with `dtype=None` does; `DetectionModel` casts its input
  once to its `dtype`, so every layer runs in it, as in the JAX model whose
  every module carries that `dtype`. A float64 copy (`.double()`) thus
  computes in float64, the CPU's reference for float32 runs. BatchNorm
  reduces and normalizes in float32 whatever its input's type (flax's
  `force_float32_reductions`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

BN_MOMENTUM = 0.03
BN_EPS = 1e-3


def finish(conv: nn.Conv2d, y):
    """The output of a module that owns `conv`, its BatchNorm and activation:
    `y`, or, where parallel/tensor.py ran them on a channel slice, the slice
    gathered (or passed on to its row-parallel consumer)."""
    shard = getattr(conv, "shard", None)
    return shard.finish(y) if shard is not None and shard.defer else y


def autopad(k, p=None, d=1):
    """'Same'-shape padding for torch-style symmetric padding (common.py:33)."""
    if d > 1:
        k = d * (k - 1) + 1 if isinstance(k, int) else [d * (x - 1) + 1 for x in k]
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p if isinstance(p, int) else tuple(p)


def conv2d(conv: nn.Conv2d, x):
    """`conv(x)` in `x`'s type: kernel and bias cast to it at the call. A
    conv that parallel/tensor.py sharded, or that parallel/spatial.py runs
    on row shards, computes through its `shard`."""
    shard = getattr(conv, "shard", None)
    if shard is not None:
        return shard.conv(conv, x)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return conv._conv_forward(x, conv.weight.to(x.dtype), bias)


def linear(dense: nn.Linear, x):
    """`dense(x)` in `x`'s type, as a flax Dense with that dtype (through its
    `shard` where parallel/tensor.py sharded it)."""
    shard = getattr(dense, "shard", None)
    if shard is not None:
        return shard.linear(dense, x)
    return nn.functional.linear(x, dense.weight.to(x.dtype), dense.bias.to(x.dtype))


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm` semantics in PyTorch.

    Evaluation is nn.BatchNorm2d's. In training, nn.BatchNorm2d normalizes
    with the biased batch variance but moves `running_var` toward the
    unbiased one, var * n / (n - 1); flax uses the biased one for both. Here
    the fused batch_norm moves a copy r1 = (1 - m) r0 + m var n / (n - 1) of
    the running variance r0, and r0 becomes flax's (1 - m) r0 + m var =
    r1 (1 - 1/n) + r0 (1 - m) / n. That costs a few ops on C-element
    vectors, where a second pass over the activation for the biased
    variance cost 14% of a YOLO-DBL-s train step on an H100.

    A bfloat16 input meets float32 statistics and affine parameters:
    batch_norm then reduces and normalizes in float32 and returns bfloat16,
    as flax's BatchNorm with a bfloat16 `dtype` does.
    """

    mesh = None  # a parallel.Mesh inside `cross_rank`: statistics over the data axis's rows
    # the channel slice this layer normalizes where it follows a column-parallel
    # conv (parallel/tensor.py): its parameters and statistics by that slice
    channels = None

    def forward(self, x):
        w, b, mean, var = self.weight, self.bias, self.running_mean, self.running_var
        if self.channels is not None:
            sl = self.channels
            w, b, mean, var = w[sl], b[sl], mean[sl], var[sl]
        if not self.training:
            return nn.functional.batch_norm(x, mean, var, w, b, False, 0.0, self.eps)
        if self.mesh is not None:
            return CrossRankBatchNorm.apply(x, w, b, mean, var, self.momentum, self.eps, self.mesh)
        r1 = var.clone()
        out = nn.functional.batch_norm(x, mean, r1, w, b, True, self.momentum, self.eps)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            var.mul_((1.0 - self.momentum) / n).add_(r1, alpha=1.0 - 1.0 / n)
        return out


class CrossRankBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every rank of a mesh, as flax's
    BatchNorm computes it over JAX's global batch: mean and
    var = max(E[x²] - E[x]², 0) in float32 (flax 0.12.3 `_compute_stats`,
    `use_fast_variance`), from one all-reduce of [Σx, Σx², n] a layer; the
    running variance moves toward this biased variance. The backward takes
    one all-reduce of [Σdy, Σdy·x̂] for the input's gradient, which then
    holds every rank's share of the loss, and returns this rank's Σdy·x̂ and
    Σdy as the weight's and bias's gradients (the trainer sums those over the
    ranks with the others). A bfloat16 input keeps float32 statistics and
    returns bfloat16; a float64 one computes in float64."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, mesh):
        acc = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        xf = x.to(acc)
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims), xf.new_full((1,), x.numel() // c)])
        mesh.all_reduce(stats, axis="data")
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (invstd * weight.to(acc)).view(shape) + bias.to(acc).view(shape)
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(mean.to(running_mean.dtype), alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(var.to(running_var.dtype), alpha=momentum)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mesh = mesh
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        dyf = dy.to(mean.dtype)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbias, dweight = local[:c].clone(), local[c:].clone()
        glob = ctx.mesh.all_reduce(local, axis="data") / n
        dx = (dyf - glob[:c].view(shape) - xhat * glob[c:].view(shape)) \
            * (invstd * weight.to(mean.dtype)).view(shape)
        return (dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype),
                None, None, None, None, None)


@contextlib.contextmanager
def cross_rank(model: nn.Module, mesh=None):
    """Inside the block, every BatchNorm of `model` in training takes its
    statistics over the rows of all of `mesh`'s ranks (`CrossRankBatchNorm`);
    with no mesh, nothing changes."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)] if mesh is not None else []
    for m in layers:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in layers:
            del m.mesh


def batch_norm(c: int) -> BatchNorm:
    return BatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def flax_batch_norm(c: int) -> BatchNorm:
    """A flax `nn.BatchNorm` called directly, with flax's own defaults
    (momentum 0.99, epsilon 1e-5), not through `Conv`."""
    return BatchNorm(c, eps=1e-5, momentum=0.01)


def _act(act) -> nn.Module:
    if act is True:
        return nn.SiLU()
    if isinstance(act, nn.Module):
        return act
    return nn.Identity()


class Conv(nn.Module):
    """Conv2d + BatchNorm + SiLU (common.py:118)."""

    def __init__(self, c1: int, c2: int, k: Union[int, Sequence[int]] = 1, s: int = 1,
                 p: Optional[int] = None, g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = batch_norm(c2)
        self.act = _act(act)

    def forward(self, x):
        return finish(self.conv, self.act(self.bn(conv2d(self.conv, x))))


class DWConv(nn.Module):
    """Depthwise conv: Conv with groups = gcd(c1, c2) (common.py:250)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, None, d), groups=math.gcd(c1, c2),
                              dilation=d, bias=False)
        self.bn = batch_norm(c2)
        self.act = _act(act)

    def forward(self, x):
        return finish(self.conv, self.act(self.bn(conv2d(self.conv, x))))


class DSConv(nn.Module):
    """Depthwise-separable conv: DW k×k → PW 1×1 → one BN → SiLU (common.py:294)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: Optional[int] = None, d: int = 1):
        super().__init__()
        p = p if p is not None else d * (k - 1) // 2
        self.dw = nn.Conv2d(c1, c1, k, s, p, groups=c1, dilation=d, bias=False)
        self.pw = nn.Conv2d(c1, c2, 1, bias=False)
        self.bn = batch_norm(c2)

    def forward(self, x):
        return finish(self.pw, nn.functional.silu(self.bn(conv2d(self.pw, conv2d(self.dw, x)))))


class Conv2d(nn.Module):
    """Bare conv, with a bias unless `bias=False`, no BN/act (common.py:333);
    `conv` level as in flax."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, d: int = 1, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=bias)

    def forward(self, x):
        return conv2d(self.conv, x)


def concat(xs, dim: int = 1):
    """Channel concat (common.py:361); dim 1 is the channel axis of NCHW."""
    return torch.cat(xs, dim=dim)
