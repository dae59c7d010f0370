"""RT-DETR's encoder layer (port of yolo_dbl_tpu/nn/attention/extra.py:26-96).

`sincos_2d_position`, `TorchMHA` (multi-head attention in the parameter
layout of torch's `nn.MultiheadAttention`: the packed `in_proj_weight`
(3C, C), `in_proj_bias` and an `out_proj` Dense) and `AIFI`, the post-norm
transformer layer RT-DETR runs over its stride-32 map. The attention is
JAX's plain einsum and softmax, here `torch.matmul` and softmax: no Pallas
kernel runs there, so none runs here. Each module computes in its input's
type (nn/common.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..common import layer_norm, linear


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
