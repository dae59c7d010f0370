"""RT-DETR's encoder layer and the pools' last attention rows (port of
yolo_dbl_tpu/nn/attention/extra.py).

`sincos_2d_position`, `TorchMHA` (multi-head attention in the parameter
layout of torch's `nn.MultiheadAttention`: the packed `in_proj_weight`
(3C, C), `in_proj_bias` and an `out_proj` Dense) and `AIFI`, the post-norm
transformer layer RT-DETR runs over its stride-32 map. The attention is
JAX's plain einsum and softmax, here `torch.matmul` and softmax: no Pallas
kernel runs there, so none runs here. Each module computes in its input's
type (nn/common.py).

The rows' modules (extra.py:99-231): ASFF and ASFFmobile (adaptive
fusion of three pyramid levels: its output width is `expand_c`, 1024,
512 or 256 by level, whatever its row's width), PSAModule (pyramid split
attention) and CPCA (channel-prior conv attention). They take and return
NCHW; their BatchNorms are flax's called directly (`flax_batch_norm`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.resample import max_pool, nearest_upsample
from ..common import Conv2d, flax_batch_norm, layer_norm, linear


def sincos_2d_position(h: int, w: int, dim: int, temperature: float = 10000.0, device=None):
    """2-D sine-cosine position embedding (extra.py:26): (1, h*w, dim) in
    float32, the first meshgrid axis (length w) varying slowest."""
    if dim % 4:
        raise ValueError(f"the embedding width must divide by 4, got {dim}")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32, device=device)
                                   / pos_dim))
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                            torch.arange(h, dtype=torch.float32, device=device), indexing="ij")
    out_w = gw.reshape(-1, 1) * omega[None]
    out_h = gh.reshape(-1, 1) * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None]


class TorchMHA(nn.Module):
    """Scaled dot-product multi-head attention with torch's packed input
    projection (extra.py:41): q, k, v (B, N, C) → (B, N, C)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)

    def init_own(self, generator: torch.Generator):
        """flax's initial values: xavier_uniform weight, zero bias."""
        nn.init.xavier_uniform_(self.in_proj_weight, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, q, k, v):
        b, n, c = q.shape
        nh = self.num_heads
        hd = c // nh
        w, bias = self.in_proj_weight.to(q.dtype), self.in_proj_bias.to(q.dtype)

        def heads(x, i):
            x = F.linear(x, w[i * c:(i + 1) * c], bias[i * c:(i + 1) * c])
            return x.reshape(b, -1, nh, hd).transpose(1, 2)

        qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
        attn = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd), -1)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(b, n, c)
        return linear(self.out_proj, out)


class AIFI(nn.Module):
    """RT-DETR's intra-scale encoder layer (extra.py:68) on an NCHW map:
    tokens in row-major order, the position embedding added to the queries
    and keys (built with w and h swapped, as JAX's call does), post-norm
    attention and an erf-GELU feed-forward."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = TorchMHA(c1, num_heads)
        self.norm1 = nn.LayerNorm(c1, eps=1e-5)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm2 = nn.LayerNorm(c1, eps=1e-5)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        pos = sincos_2d_position(w, h, c, device=x.device).to(tokens.dtype)
        q = tokens + pos
        tokens = layer_norm(self.norm1, tokens + self.ma(q, q, tokens))
        y = linear(self.fc2, F.gelu(linear(self.fc1, tokens)))
        tokens = layer_norm(self.norm2, tokens + y)
        return tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _AddConv(nn.Module):
    """A bias-free conv, flax's BatchNorm and LeakyReLU(0.1) (extra.py:99,
    ASFF's add_conv)."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s=s, p=(k - 1) // 2, bias=False)
        self.bn = flax_batch_norm(c2)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


def _nearest(x, s):
    return nearest_upsample(x.permute(0, 2, 3, 1), s).permute(0, 3, 1, 2)


class ASFF(nn.Module):
    """Adaptively spatial feature fusion (extra.py:114) of [x0 (P5), x1 (P4),
    x2 (P3)] at `level`: the other levels strided, max-pooled (-inf padding)
    or compressed and upsampled to this level's `dims[level]` channels, a
    per-pixel softmax over three 1x1 weight branches fuses them, then a 3x3
    `expand` to `expand_c` (1024, 512, 256 at level 0, 1, 2). `ch`: the
    widths of the three inputs (flax reads them from the inputs)."""

    DIMS = (512, 256, 256)
    EXPAND = (1024, 512, 256)

    def __init__(self, level, rfb=False, dims=None, ch=None):
        super().__init__()
        dims = tuple(dims or self.DIMS)
        c0, c1, c2 = ch or dims
        inter = dims[level]
        self.level, self.c2 = level, self.EXPAND[level]
        if level == 0:
            self.stride_l1 = _AddConv(c1, inter, 3, 2)
            self.stride_l2 = _AddConv(c2, inter, 3, 2)
        elif level == 1:
            self.compress_l0 = _AddConv(c0, inter, 1, 1)
            self.stride_l2 = _AddConv(c2, inter, 3, 2)
        else:
            self.compress_l0 = _AddConv(c0, inter, 1, 1)
            self.compress_l1 = _AddConv(c1, inter, 1, 1)
        cc = 8 if rfb else 16
        for i in range(3):
            setattr(self, f"w_l{i}", _AddConv(inter, cc, 1, 1))
        self.weight_levels = Conv2d(3 * cc, 3, 1)
        self.expand = _AddConv(inter, self.c2, 3, 1)

    def forward(self, xs):
        x0, x1, x2 = xs
        if self.level == 0:
            l0, l1 = x0, self.stride_l1(x1)
            l2 = self.stride_l2(max_pool(x2.permute(0, 2, 3, 1), 3, 2, 1).permute(0, 3, 1, 2))
        elif self.level == 1:
            l0, l1, l2 = _nearest(self.compress_l0(x0), 2), x1, self.stride_l2(x2)
        else:
            l0, l1, l2 = _nearest(self.compress_l0(x0), 4), _nearest(self.compress_l1(x1), 2), x2
        wgt = self.weight_levels(torch.cat([self.w_l0(l0), self.w_l1(l1), self.w_l2(l2)], 1))
        wgt = torch.softmax(wgt, 1)
        return self.expand(l0 * wgt[:, 0:1] + l1 * wgt[:, 1:2] + l2 * wgt[:, 2:3])


class ASFFmobile(ASFF):
    """ASFF with dims (512, 256, 128) (extra.py:158). JAX changes only the
    dims: its convs keep LeakyReLU(0.1)."""

    DIMS = (512, 256, 128)


class PSAModule(nn.Module):
    """Pyramid split attention (extra.py:163): four grouped convs (kernels
    3, 5, 7, 9; groups 1, 4, 8, 16) to planes / 4 each, one SE shared by the
    four branches, a softmax across the branches, the outputs laid out
    branch by branch."""

    def __init__(self, c1, planes, conv_kernels=(3, 5, 7, 9), stride=1,
                 conv_groups=(1, 4, 8, 16)):
        super().__init__()
        sc = planes // 4
        self.n = len(conv_kernels)
        for i, (k, g) in enumerate(zip(conv_kernels, conv_groups)):
            setattr(self, f"conv_{i + 1}", Conv2d(c1, sc, k, s=stride, p=k // 2, g=g, bias=False))
        self.se_fc1 = Conv2d(sc, max(sc // 16, 1), 1)
        self.se_fc2 = Conv2d(max(sc // 16, 1), sc, 1)

    def forward(self, x):
        feats = torch.stack([getattr(self, f"conv_{i + 1}")(x) for i in range(self.n)], 1)
        b, n, sc, h, w = feats.shape
        se = self.se_fc2(F.relu(self.se_fc1(feats.mean((3, 4)).reshape(b * n, sc, 1, 1))))
        att = torch.softmax(torch.sigmoid(se).reshape(b, n, sc, 1, 1), 1)
        return (feats * att).reshape(b, n * sc, h, w)


class CPCA(nn.Module):
    """Channel-prior conv attention (extra.py:198): one 1x1 `conv_shared`
    applied three times (after a 1x1 `trans` where c2 != c1): tanh GELU,
    the channel attention of the mean and max pooled maps through one MLP,
    then depthwise 5x5 and 1xk / kx1 strips (k = 7, 11, 21) summed."""

    def __init__(self, c1, c2=0, reduce=4):
        super().__init__()
        c = c2 or c1
        self.trans = Conv2d(c1, c, 1) if c != c1 else None
        self.conv_shared = Conv2d(c, c, 1)
        self.ca_fc1 = Conv2d(c, c // reduce, 1)
        self.ca_fc2 = Conv2d(c // reduce, c, 1)
        self.dconv5_5 = Conv2d(c, c, 5, p=2, g=c)
        for k in (7, 11, 21):
            setattr(self, f"dconv1_{k}", Conv2d(c, c, (1, k), p=(0, k // 2), g=c))
            setattr(self, f"dconv{k}_1", Conv2d(c, c, (k, 1), p=(k // 2, 0), g=c))

    def forward(self, x):
        if self.trans is not None:
            x = self.trans(x)
        shared = self.conv_shared
        x = F.gelu(shared(x), approximate="tanh")

        def channel(p):
            return torch.sigmoid(self.ca_fc2(F.relu(self.ca_fc1(p))))

        x = (channel(x.mean((2, 3), keepdim=True)) + channel(x.amax((2, 3), keepdim=True))) * x
        x_init = self.dconv5_5(x)
        x1, x2, x3 = (getattr(self, f"dconv{k}_1")(getattr(self, f"dconv1_{k}")(x_init))
                      for k in (7, 11, 21))
        return shared(shared(x1 + x2 + x3 + x_init) * x)
