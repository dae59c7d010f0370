"""YOLOv10/11 attention blocks (NCHW inside, PyTorch).

Port of the part of yolo_dbl_tpu/nn/v9v10.py that yolo11 needs:
V10Attention, PSABlock and C2PSA. The attention is two products and a
softmax over every token of the map, in plain PyTorch as in JAX (no Pallas
kernel there, so no hand kernel here). Attribute names are the flax scope
names, so JAX variables load key by key (utils/convert.py).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv


class V10Attention(nn.Module):
    """Multi-head self-attention over the H*W tokens with a 3x3 depthwise
    position encoding of v (v9v10.py:236). The qkv conv's channels are read
    from its NHWC view as (B, H*W, heads, 2*kd + hd), split at kd and 2*kd,
    as flax's reshape of an NHWC map reads them."""

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)
        self.proj = Conv(dim, dim, 1, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, hd, kd = self.num_heads, self.head_dim, self.key_dim
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, nh, 2 * kd + hd)
        q, k, v = qkv.split([kd, kd, hd], -1)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, N, d)
        attn = torch.softmax(torch.matmul(q * kd ** -0.5, k.transpose(-1, -2)), -1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        v = v.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v))


class PSABlock(nn.Module):
    """V10Attention and a 2-conv FFN, each residual with `shortcut` (v9v10.py:260)."""

    def __init__(self, c, attn_ratio=0.5, num_heads=4, shortcut=True):
        super().__init__()
        self.shortcut = shortcut
        self.attn = V10Attention(c, num_heads, attn_ratio)
        self.ffn_0 = Conv(c, 2 * c, 1)
        self.ffn_1 = Conv(2 * c, c, 1, act=False)

    def forward(self, x):
        a = self.attn(x)
        x = x + a if self.shortcut else a
        f = self.ffn_1(self.ffn_0(x))
        return x + f if self.shortcut else f


class C2PSA(nn.Module):
    """cv1 split in two, n PSABlocks (heads of 64 channels) on the second
    part, cv2 over both (v9v10.py:297)."""

    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m_{i}", PSABlock(c, 0.5, max(c // 64, 1)))
        self.cv2 = Conv(2 * c, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.c], y[:, self.c:]
        for i in range(self.n):
            b = getattr(self, f"m_{i}")(b)
        return self.cv2(torch.cat([a, b], 1))
