"""Swin Transformer's stages (port of yolo_dbl_tpu/nn/structures/swin.py).

`window_partition`, `window_reverse`, `_relative_position_index`,
`_shift_mask`, WindowAttention (W-MSA with the relative position bias
table), SwinTransformerBlock (LN → (S)W-MSA → LN → MLP, both residual,
tanh GELU as flax's `nn.gelu`), SwinStage (blocks alternating the shift),
PatchEmbed (the patch conv and LayerNorm) and PatchMerging (2x2 concat,
LayerNorm, bias-free reduction to 2C). The window helpers work on NHWC
tensors, as JAX's; the modules take and return NCHW, as the rest of the
port. The shift mask and the bias index are built from static shapes on
the host, as JAX folds them into its program.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..common import conv2d, layer_norm, linear


def window_partition(x, ws: int):
    """(B, H, W, C) → (B·nW, ws, ws, C) (swin.py:23)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.transpose(2, 3).reshape(-1, ws, ws, c)


def window_reverse(wins, ws: int, h: int, w: int):
    """(B·nW, ws, ws, C) → (B, H, W, C) (swin.py:30)."""
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.transpose(2, 3).reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws-1)² bias table (swin.py:36)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) SW-MSA mask, -100 between different regions (swin.py:45)."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss, :] = cnt
            cnt += 1
    wins = img.reshape(1, h // ws, ws, w // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    wins = wins.reshape(-1, ws * ws)
    return np.where(wins[:, None, :] - wins[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias (swin.py:58) on (B·nW, ws², C)
    tokens; `mask` (nW, ws², ws²) or None."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", self._index(), persistent=False)

    def _index(self, device=None):
        return torch.from_numpy(_relative_position_index(self.window_size).reshape(-1)).to(device)

    def init_buffers(self):
        self.index = self._index(self.index.device)

    def init_own(self, generator: torch.Generator):
        """flax's normal(0.02) for the bias table."""
        self.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, mask=None):
        bnw, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(self.qkv, x).reshape(bnw, n, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (BnW, nh, n, hd)
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        bias = self.relative_position_bias_table[self.index].reshape(n, n, nh).permute(2, 0, 1)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bnw // nw, nw, nh, n, n) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bnw, nh, n, n)
        out = torch.matmul(torch.softmax(attn, -1), v).transpose(1, 2).reshape(bnw, n, c)
        return linear(self.proj, out)


def shifted_window_attention(attn: WindowAttention, y, ws: int, shift: int):
    """(S)W-MSA over the NHWC map `y`: padded to a multiple of the window on
    the bottom and right, rolled by -shift (with the static mask), windowed,
    attended, rolled back and cropped (swin.py:116-130; DAT's
    ShiftWindowAttention, bigarch.py:433-452)."""
    b, h, w, c = y.shape
    shift = shift if min(h, w) > ws else 0
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    mask = None
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
        mask = torch.from_numpy(_shift_mask(hp, wp, ws, shift)).to(y.device)
    wins = attn(window_partition(y, ws).reshape(-1, ws * ws, c), mask)
    y = window_reverse(wins.reshape(-1, ws, ws, c), ws, hp, wp)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y[:, :h, :w]


class SwinTransformerBlock(nn.Module):
    """LN → (S)W-MSA → LN → MLP, both residual (swin.py:95), on NCHW."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        y = shifted_window_attention(self.attn, layer_norm(self.norm1, x), self.window_size,
                                     self.shift_size)
        x = x + y
        z = F.gelu(linear(self.mlp_fc1, layer_norm(self.norm2, x)), approximate="tanh")
        return (x + linear(self.mlp_fc2, z)).permute(0, 3, 1, 2)


class SwinStage(nn.Module):
    """`depth` SwinTransformerBlocks `blk{i}`, the odd ones shifted by half a
    window (swin.py:136); the width is kept (dim == c2)."""

    def __init__(self, dim: int, c2: int, depth: int, num_heads: int, window_size: int):
        super().__init__()
        if dim != c2:
            raise ValueError(f"SwinStage keeps channels: dim {dim} != c2 {c2}")
        self.depth = depth
        for i in range(depth):
            setattr(self, f"blk{i}", SwinTransformerBlock(
                dim, num_heads, window_size, shift_size=0 if i % 2 == 0 else window_size // 2))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"blk{i}")(x)
        return x


class PatchEmbed(nn.Module):
    """The input padded right and bottom to a multiple of the patch, a
    biased patch x patch conv with that stride, LayerNorm over the
    channels (swin.py:158)."""

    def __init__(self, c1: int, embed_dim: int = 96, patch_size: int = 4):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(c1, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        p = self.patch_size
        h, w = x.shape[2:]
        y = conv2d(self.proj, F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p)))
        return layer_norm(self.norm, y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class PatchMerging(nn.Module):
    """An odd side padded at the bottom or right, the 2x2 neighbours x0 (0::2,
    0::2), x1 (1::2, 0::2), x2 (0::2, 1::2), x3 (1::2, 1::2) concatenated in
    that order on the channels, LayerNorm, a bias-free Dense to 2C (swin.py:176)."""

    def __init__(self, dim: int, c2: int):
        super().__init__()
        if c2 != 2 * dim:
            raise ValueError(f"PatchMerging doubles the width: c2 {c2} != 2 x {dim}")
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[2:]
        x = F.pad(x, (0, w % 2, 0, h % 2)).permute(0, 2, 3, 1)
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return linear(self.reduction, layer_norm(self.norm, y)).permute(0, 3, 1, 2)
