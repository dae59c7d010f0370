"""Sparse-linear attention (port of yolo_dbl_tpu/nn/attention/sla.py).

The JAX module computes SLA in its masked dense form, and so does the port:
a per-query-block top-k of key blocks selects where softmax attention runs
(o_s, the other scores masked to -inf), and feature-mapped linear attention
runs over the complement blocks (o_l, zero where a row has no complement).
No block is skipped: every product is a plain `torch.matmul` over all L
tokens, as JAX leaves it to XLA, so the (B, H, L, L) scores are held whole
(at P3 of a 640 image, 6400 tokens: 0.66 GB an image a matrix in float32).

The block top-k is discrete: a near-tie between the k-th and (k+1)-th
block scores may fall either way on another device or in another order of
sums, and moves a whole key block between the two branches.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..common import Conv2d, conv2d, linear


def _block_pool(x, blk):
    """(B, H, L, D) → (B, H, ceil(L / blk), D): the mean over each block of
    blk tokens, the last block over its real tokens only (sla.py:37)."""
    b, h, l, d = x.shape
    nb = -(-l // blk)
    sums = F.pad(x, (0, 0, 0, nb * blk - l)).reshape(b, h, nb, blk, d).sum(3)
    starts = torch.arange(nb, device=x.device) * blk
    counts = ((starts + blk).clamp(max=l) - starts).clamp(1, blk).to(x.dtype)
    return sums / counts[None, None, :, None]


def block_mask(q, k, topk_ratio=0.1, blkq=64, blkk=64):
    """(B, H, Qb, Kb) bool: the top-k key blocks of each query block by the
    product of block-mean q and block-mean centred k (sla.py:58-65), and the
    scores it was chosen from."""
    kb = -(-k.shape[2] // blkk)
    score = _block_pool(q, blkq) @ _block_pool(k - k.mean(-2, keepdim=True), blkk).transpose(-1, -2)
    topk = max(1, min(kb, int(topk_ratio * kb)))
    lut = score.topk(topk, dim=-1).indices
    return torch.zeros_like(score, dtype=torch.bool).scatter_(-1, lut, True), score


def sparse_linear_attention(q, k, v, c_q, c_k, topk_ratio=0.1, blkq=64, blkk=64):
    """The SLA core (sla.py:50). q, k, v, c_q, c_k: (B, H, L, D). Returns (o_s, o_l)."""
    l, d = q.shape[2], q.shape[3]
    mask = block_mask(q, k, topk_ratio, blkq, blkk)[0]
    tok = mask.repeat_interleave(blkq, 2).repeat_interleave(blkk, 3)[:, :, :l, :l]
    s = (q @ k.transpose(-1, -2)) * d ** -0.5
    o_s = torch.softmax(s.masked_fill(~tok, float("-inf")), -1) @ v
    w = (c_q @ c_k.transpose(-1, -2)) * (~tok).to(q.dtype)
    denom = w.sum(-1, keepdim=True)
    o_l = (w @ v) / torch.where(denom > 0, denom, torch.full_like(denom, float("inf")))
    return o_s, o_l


_FEATURE_MAPS = {"softmax": lambda t: torch.softmax(t, -1), "elu": lambda t: F.elu(t) + 1,
                 "relu": F.relu}


class SLA(nn.Module):
    """Sparse-linear attention over the H x W tokens (sla.py:83): a 1x1 qkv
    projection without bias, a channel-major head split (channel = head *
    head_dim + d), the feature map of q and k for the linear branch, o_s +
    proj_l(o_l) (a Dense), and `out_proj`, a bias-free 1x1 conv. proj_l and
    out_proj start at zero (their `zero_init`), so the block starts inert."""

    def __init__(self, in_channels, num_heads=4, head_dim=0, topk=0.1, feature_map="softmax",
                 blkq=64, blkk=64):
        super().__init__()
        if feature_map not in _FEATURE_MAPS:
            raise NotImplementedError(feature_map)
        c = in_channels
        self.num_heads, self.head_dim = num_heads, head_dim or c // num_heads
        self.topk, self.feature_map, self.blkq, self.blkk = topk, feature_map, blkq, blkk
        self.qkv_proj = Conv2d(c, 3 * c, 1, bias=False)
        self.proj_l = nn.Linear(self.head_dim, self.head_dim)
        self.out_proj = nn.Conv2d(c, c, 1, bias=False)
        self.proj_l.zero_init = self.out_proj.zero_init = True

    def forward(self, x):
        b, c, hh, ww = x.shape
        heads, hd, l = self.num_heads, self.head_dim, hh * ww
        qkv = self.qkv_proj(x).flatten(2).transpose(1, 2)  # (B, L, 3C)
        q, k, v = (t.reshape(b, l, heads, hd).transpose(1, 2) for t in qkv.split(c, -1))
        fmap = _FEATURE_MAPS[self.feature_map]
        o_s, o_l = sparse_linear_attention(q, k, v, fmap(q), fmap(k), self.topk, self.blkq,
                                           self.blkk)
        o = (o_s + linear(self.proj_l, o_l)).transpose(2, 3).reshape(b, c, hh, ww)
        return conv2d(self.out_proj, o)
