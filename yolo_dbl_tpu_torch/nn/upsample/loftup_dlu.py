"""LoftUp's coordinate-network upsampler and the official DLUPack (port of
yolo_dbl_tpu/nn/upsample/loftup_dlu.py).

Modules take and return NCHW, as the rest of the port, and work on the
NHWC view in JAX's order inside. DLUPack samples its low-res kernel field
through `grid_sample_bilinear` (align corners, border padding), which is
K2 (kernels/sampling.py) on a CUDA tensor: one launch a call. LoftUp's
cross-attention is JAX's einsum and softmax, outside any Pallas call, so
here `torch.matmul` and softmax (nn/attention/spatial.py
`MultiHeadDotProductAttention`).

Where the frameworks part: the Fourier features reach frequencies of
exp(10) ≈ 22,026, so an ulp of a grid point or a frequency moves a sine by
up to ~2e-3. The grids and frequencies are formed by `jnp.linspace`'s own
formula (ops/resample.py `linspace`), not torch.linspace's; XLA on the CPU
still rounds some of its own points an ulp or two apart (tests hold
LoftUp in float64). The learnable position table is resized by JAX's
bicubic rule (ops/resample.py `resize_bicubic`), not F.interpolate's.
flax's `nn.gelu` is the tanh form.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.resample import (grid_sample_bilinear, linspace, nearest_upsample, pixel_shuffle,
                             resize_bicubic)
from ..attention.spatial import MultiHeadDotProductAttention
from ..common import conv2d, flax_batch_norm, layer_norm, linear
from .carafe import _unfold_patches


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def min_max_scale(x, eps=1e-4):
    """NHWC `x` scaled per channel by its min and max over the batch and
    the map to [-0.5, 0.5] (loftup_dlu.py:23)."""
    lo = x.amin((0, 1, 2), keepdim=True)
    hi = x.amax((0, 1, 2), keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=eps) - 0.5


def fourier_grid(h: int, w: int, dtype=torch.float32, device=None):
    """(H, W, 2) grid of (y, x) in [-1, 1] (loftup_dlu.py:42-44), formed on
    the CPU: every device takes the same points."""
    gy, gx = torch.meshgrid(linspace(-1, 1, h, dtype), linspace(-1, 1, w, dtype), indexing="ij")
    return torch.stack([gy, gx], -1).to(device)


def fourier_freqs(n_freqs: int, dtype=torch.float32, device=None):
    """exp of n_freqs points from -2 to 10 (loftup_dlu.py:48), formed on the
    CPU: an ulp of exp(10) moves a sine's argument by ~2e-3, so every
    device takes the same table."""
    return torch.exp(linspace(-2, 10, n_freqs, dtype)).to(device)


class ImplicitFeaturizer(nn.Module):
    """Fourier features of NHWC `x` (loftup_dlu.py:30): sin and cos of the
    grid (and the colours) times exp-spaced frequencies, plus learned
    phases `biases` (2, d, n), then the colours themselves. Takes and
    returns NHWC."""

    def __init__(self, color_feats=True, n_freqs=10, learn_bias=False, channels=3):
        super().__init__()
        self.color_feats, self.n_freqs = color_feats, n_freqs
        d = 2 + (channels if color_feats else 0)
        self.biases = nn.Parameter(torch.zeros(2, d, n_freqs)) if learn_bias else None

    def init_own(self, generator: torch.Generator):
        if self.biases is not None:
            self.biases.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        b, h, w, c = x.shape
        feats = fourier_grid(h, w, x.dtype, x.device)[None].expand(b, h, w, 2)
        if self.color_feats:
            feats = torch.cat([feats, x], -1)
        d = feats.shape[-1]
        f = feats[..., None, :] * fourier_freqs(self.n_freqs, x.dtype, x.device)[:, None]
        sin_f = cos_f = f  # (B, H, W, n, d)
        if self.biases is not None:
            sin_f = f + self.biases[0].t().to(x.dtype)
            cos_f = f + self.biases[1].t().to(x.dtype)
        parts = [torch.sin(sin_f).reshape(b, h, w, self.n_freqs * d),
                 torch.cos(cos_f).reshape(b, h, w, self.n_freqs * d)]
        return torch.cat(parts + ([x] if self.color_feats else []), -1)


class _ChannelLayerNorm(nn.Module):
    """ConvNeXt-style LayerNorm over the last axis of NHWC, eps 1e-6, with
    bare `weight` and `bias` (loftup_dlu.py:62)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def init_own(self, generator: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        u = x.mean(-1, keepdim=True)
        s = ((x - u) ** 2).mean(-1, keepdim=True)
        return (x - u) / torch.sqrt(s + 1e-6) * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class CATransformer(nn.Module):
    """depth x [the queries' LayerNorm cross-attending to the keys' (flax
    MultiHeadDotProductAttention), residual; LayerNorm, a tanh-GELU MLP,
    residual] (loftup_dlu.py:77) on (B, N, dim) tokens."""

    def __init__(self, dim, depth=2, heads=4, mlp_dim=128):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"l{i}_norm_q", nn.LayerNorm(dim, eps=1e-5))
            setattr(self, f"l{i}_norm_kv", nn.LayerNorm(dim, eps=1e-5))
            setattr(self, f"l{i}_attn", MultiHeadDotProductAttention(dim, heads))
            setattr(self, f"l{i}_ff_ln", nn.LayerNorm(dim, eps=1e-5))
            setattr(self, f"l{i}_ff1", nn.Linear(dim, mlp_dim))
            setattr(self, f"l{i}_ff2", nn.Linear(mlp_dim, dim))

    def forward(self, q, kv):
        for i in range(self.depth):
            kk = layer_norm(getattr(self, f"l{i}_norm_kv"), kv)
            q = getattr(self, f"l{i}_attn")(layer_norm(getattr(self, f"l{i}_norm_q"), q), kk) + q
            y = linear(getattr(self, f"l{i}_ff1"), layer_norm(getattr(self, f"l{i}_ff_ln"), q))
            q = linear(getattr(self, f"l{i}_ff2"), F.gelu(y, approximate="tanh")) + q
        return q


class LoftUp(nn.Module):
    """Coordinate-network feature upsampler (loftup_dlu.py:96): Fourier
    features of the min-max scaled image, two 3x3 convs with flax
    BatchNorms and ReLU, are the queries; the low-res features (with a sine
    PE, or plus a learned (1, lr_size², dim) table, resized by JAX's bicubic
    rule to another size) the keys and values of a cross-attention
    transformer; a 1x1 conv (sine PE) and a channel LayerNorm finish.
    `forward(lr_feats, img)`: NCHW (B, dim, h, w) and (B, C, H, W) → (B,
    dim, H, W)."""

    def __init__(self, dim, color_feats=True, n_freqs=20, num_heads=4, num_layers=2,
                 lr_pe_type="sine", lr_size=16, img_channels=3):
        super().__init__()
        if lr_pe_type not in ("sine", "learnable"):
            raise ValueError(f"lr_pe_type must be 'sine' or 'learnable', got {lr_pe_type!r}")
        self.sine, self.dim, self.lr_size = lr_pe_type == "sine", dim, lr_size
        dt = dim + (2 * 5 * 2 if self.sine else 0)
        self.fourier = ImplicitFeaturizer(color_feats, n_freqs, True, img_channels)
        c_in = 2 * n_freqs * (2 + (img_channels if color_feats else 0)) \
            + (img_channels if color_feats else 0)
        self.cn = _ChannelLayerNorm(c_in)
        for i in range(2):
            setattr(self, f"fc{i}", nn.Conv2d(c_in if i == 0 else dt, dt, 3, padding=1))
            setattr(self, f"fbn{i}", flax_batch_norm(dt))
        if self.sine:
            self.lr_pe = ImplicitFeaturizer(False, 5, True)
        else:
            self.lr_pe = nn.Parameter(torch.zeros(1, lr_size * lr_size, dim))
        self.ca = CATransformer(dt, num_layers, num_heads, dim)
        self.final_conv = nn.Conv2d(dt, dim, 1) if self.sine else None
        self.final_ln = _ChannelLayerNorm(dim)

    def init_own(self, generator: torch.Generator):
        if not self.sine:
            self.lr_pe.normal_(0.0, 1.0, generator=generator)

    def forward(self, lr_feats, img):
        x = self.cn(self.fourier(min_max_scale(_nhwc(img))))
        x = _nchw(x)
        for i in range(2):
            x = F.relu(getattr(self, f"fbn{i}")(conv2d(getattr(self, f"fc{i}"), x)))
        b, dt, h, w = x.shape
        q = _nhwc(x).reshape(b, h * w, dt)
        lr = _nhwc(lr_feats)
        bl, hl, wl, cl = lr.shape
        if self.sine:
            kv = torch.cat([lr, self.lr_pe(lr)], -1).reshape(bl, hl * wl, dt)
        else:
            pe = self.lr_pe.to(lr.dtype)
            if hl * wl != pe.shape[1]:
                side = int(math.isqrt(pe.shape[1]))
                pe = resize_bicubic(pe.reshape(1, side, side, self.dim), hl, wl)
                pe = pe.reshape(1, hl * wl, self.dim)
            kv = lr.reshape(bl, hl * wl, cl) + pe
        y = _nchw(self.ca(q, kv).reshape(b, h, w, dt))
        if self.final_conv is not None:
            y = conv2d(self.final_conv, y)
        return _nchw(self.final_ln(_nhwc(y)))


def carafe_apply(x_lo, kernels_hi, k: int, scale: int):
    """Reassembly of NHWC `x_lo`'s k x k patches (nearest-upsampled) by the
    hi-res (B, sH, sW, k²) kernels (fade_sapa.py:29)."""
    b, h, w, c = x_lo.shape
    patches = _unfold_patches(x_lo, k, 1).reshape(b, h, w, c * k * k)
    patches = nearest_upsample(patches, scale).reshape(b, h * scale, w * scale, c, k * k)
    return torch.einsum("bhwck,bhwk->bhwc", patches, kernels_hi)


class DLUPack(nn.Module):
    """The official deformable-lattice upsampler (loftup_dlu.py:160): CARAFE
    whose hi-res kernels are sampled (K2: align corners, border) from the
    softmaxed low-res k² kernel field at an align-corners base grid plus
    learned offsets (`conv_offset`, zero at init: the lookup then starts
    nearest)."""

    def __init__(self, channels, scale_factor=2, up_kernel=5, up_group=1, encoder_kernel=3,
                 compressed_channels=64):
        super().__init__()
        s, k, p = scale_factor, up_kernel, encoder_kernel // 2
        self.s, self.k = s, k
        self.channel_compressor = nn.Conv2d(channels, compressed_channels, 1)
        self.kernel_space_generator = nn.Conv2d(compressed_channels, k * k * up_group,
                                                encoder_kernel, padding=p)
        self.conv_offset = nn.Conv2d(compressed_channels, 2 * s * s * up_group, encoder_kernel,
                                     padding=p)
        # flax's kernel_init: normal(0.001) and zeros (nn/tasks.py init_flax_defaults)
        self.kernel_space_generator.normal_std = 0.001
        self.conv_offset.zero_init = True

    def forward(self, x):
        b, c, h, w = x.shape
        s, k = self.s, self.k
        comp = conv2d(self.channel_compressor, x)
        mask = torch.softmax(_nhwc(conv2d(self.kernel_space_generator, comp)), -1)  # (B, H, W, k²)
        off = pixel_shuffle(_nhwc(conv2d(self.conv_offset, comp)), s)  # (B, sH, sW, 2), xy
        off = torch.stack([off[..., 0] * 2.0 / (w - 1), off[..., 1] * 2.0 / (h - 1)], -1)
        gy = linspace(-1, 1, h, off.dtype, off.device).repeat_interleave(s)
        gx = linspace(-1, 1, w, off.dtype, off.device).repeat_interleave(s)
        base = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), -1)  # (sH, sW, 2)
        mask_hi = grid_sample_bilinear(mask, base[None] + off, "border", align_corners=True)
        return _nchw(carafe_apply(_nhwc(x), mask_hi, k, s))
