"""The catalogue's large research attentions (port of
yolo_dbl_tpu/nn/attention/bigarch.py).

BiFormerNCHW (bi-level routing: detached region scores, top-k routing,
token attention over the routed regions, a depthwise LePE side path),
AxialAttention and AxialBlock{,_dynamic,_wopos} (MedT axial attention with
relative q/k/v embeddings and BatchNorm on the similarities),
ShiftWindowAttention, FusedKQnA (learned queries; the k x k aggregation as
grouped depthwise convs, as JAX writes it), DAttention (deformable
attention: k and v sampled at offset reference points), DAT,
DeBiAttentionBlock, DeBiAttention_YOLO, SwinTransformer, and VOLO's
OutlookAttention and Outlooker (the Outlooker_YOLO row). Modules take
and return NCHW and compute in their input's type (nn/common.py); the
token math runs on the NHWC view, in JAX's order.

DAttention samples its keys and values through `grid_sample_bilinear`,
which is K2 (kernels/sampling.py) on a CUDA tensor: one grouped launch of
the NHWC map with `n_groups` contiguous channel groups, where JAX samples
a (B·G, H, W, C/G) copy (bigarch.py:302-306); the numbers are the same.
The other attentions are JAX's einsum and softmax, outside any Pallas
call, so here `torch.matmul`/`einsum` and softmax.

Where JAX and torch part: `jax.lax.top_k` takes equal scores in index
order (`ops/nms.py` `_topk` keeps it); `jax.image.resize(..., "linear")`
of AxialAttention's embedding antialiases when it shrinks (torch's
`antialias=True`); flax's `nn.gelu` is the tanh form.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.nms import _topk
from ...ops.resample import grid_sample_bilinear
from ..common import Conv2d, conv2d, flax_batch_norm, layer_norm, linear
from ..upsample.carafe import _unfold_patches
from ..structures.swin import SwinTransformerBlock, WindowAttention, shifted_window_attention


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _bn_last(bn, t):
    """A BatchNorm over the last axis of `t` (flax's on channels-last)."""
    return bn(t.reshape(-1, t.shape[-1])).reshape(t.shape)


class BiFormerNCHW(nn.Module):
    """Bi-level routing attention (bigarch.py:39): the map padded to n_win x
    n_win regions after the qkv projection; each region attends to the
    tokens of its top-k regions by the detached pooled q·k score, scaled by
    dim^-0.5. `c1`: the input width (default `dim`; JAX reads it from the
    input and uses `dim` only in the scale)."""

    def __init__(self, dim: int, num_heads: int = 8, n_win: int = 7, topk: int = 4,
                 side_dwconv: int = 3, c1: int = 0):
        super().__init__()
        self.dim, self.num_heads, self.n_win, self.topk = dim, num_heads, n_win, topk
        c = c1 or dim
        self.qkv_linear = Conv2d(c, 3 * c, 1)
        self.lepe = Conv2d(c, c, side_dwconv, p=side_dwconv // 2, g=c)
        self.output_linear = Conv2d(c, c, 1)

    def region_mask(self, q, k):
        """(B, R, R): whether region j is among region i's top-k by the
        pooled q·k score (NHWC q, k padded to n_win x n_win regions)."""
        b, hp, wp, c = q.shape
        nw = self.n_win

        def pool(t):
            return t.detach().reshape(b, nw, hp // nw, nw, wp // nw, c).mean((2, 4)) \
                .reshape(b, nw * nw, c)

        a_r = torch.matmul(pool(q), pool(k).transpose(1, 2))
        _, idx = _topk(a_r, min(self.topk, nw * nw))
        return torch.zeros_like(a_r, dtype=torch.bool).scatter_(-1, idx, True)

    def forward(self, x):
        b, c, h, w = x.shape
        nw, nh = self.n_win, self.num_heads
        rh, rw = -(-h // nw), -(-w // nw)
        qkv = F.pad(_nhwc(self.qkv_linear(x)), (0, 0, 0, rw * nw - w, 0, rh * nw - h))
        hp, wp = rh * nw, rw * nw
        q, k, v = qkv.split(c, -1)
        mask = self.region_mask(q, k)

        def tokens(t):  # (B, heads, R·n, hd), region-major
            t = t.reshape(b, nw, rh, nw, rw, nh, c // nh).permute(0, 5, 1, 3, 2, 4, 6)
            return t.reshape(b, nh, nw * nw * rh * rw, c // nh)

        n = rh * rw
        sim = torch.matmul(tokens(q) * self.dim ** -0.5, tokens(k).transpose(-1, -2))
        sim = sim.reshape(b, nh, nw * nw, n, nw * nw, n)
        sim = sim.masked_fill(~mask[:, None, :, None, :, None], -torch.inf)
        attn = torch.softmax(sim.reshape(b, nh, nw * nw * n, -1), -1)
        out = torch.matmul(attn, tokens(v))  # (B, heads, R·n, hd)
        out = out.reshape(b, nh, nw, nw, rh, rw, c // nh).permute(0, 2, 4, 3, 5, 1, 6)
        out = out.reshape(b, hp, wp, c) + _nhwc(self.lepe(_nchw(v)))
        return self.output_linear(_nchw(out[:, :h, :w]))


class AxialAttention(nn.Module):
    """Attention along H (`width=False`) or W of an NHWC map, with relative
    q/k/v embeddings and BatchNorm on the stacked similarities
    (bigarch.py:134). `variant`: 'full', 'dynamic' (position terms x 0.1,
    bigarch.py:147-150) or 'wopos' (no embedding). The (2gp, K, K)
    embedding is resized to the axis length L where L != kernel_size."""

    def __init__(self, in_planes: int, out_planes: int, groups: int = 8, kernel_size: int = 56,
                 width: bool = False, variant: str = "full"):
        super().__init__()
        self.out_planes, self.groups, self.kernel_size = out_planes, groups, kernel_size
        self.width, self.variant = width, variant
        gp = out_planes // groups
        self.qkv = nn.Linear(in_planes, 2 * out_planes, bias=False)
        self.bn_qkv = flax_batch_norm(2 * out_planes)
        if variant == "wopos":
            self.bn_similarity = flax_batch_norm(groups)
            self.bn_output = flax_batch_norm(out_planes)
        else:
            self.relative = nn.Parameter(torch.empty(2 * gp, 2 * kernel_size - 1))
            self.bn_similarity = flax_batch_norm(3 * groups)
            self.bn_output = flax_batch_norm(2 * out_planes)
        self.register_buffer("index", self._index(), persistent=False)

    def _index(self, device=None):
        """index[a, b] = a - b + K - 1 (bigarch.py:195-197)."""
        r = torch.arange(self.kernel_size, device=device)
        return r[:, None] - r[None, :] + self.kernel_size - 1

    def init_buffers(self):
        self.index = self._index(self.index.device)

    def init_own(self, generator: torch.Generator):
        """flax's normal(1.0) for the relative table."""
        if self.variant != "wopos":
            self.relative.normal_(0.0, 1.0, generator=generator)

    def embedding(self, length: int):
        """(2gp, L, L): the relative table gathered to (2gp, K, K), resized to
        L as `jax.image.resize(..., "linear")` does (antialiased when L < K)."""
        emb = self.relative[:, self.index]
        k = self.kernel_size
        if length != k:
            emb = F.interpolate(emb[None], size=(length, length), mode="bilinear",
                                align_corners=False, antialias=length < k)[0]
        return emb

    def forward(self, x):
        """x: NHWC (B, H, W, C) → NHWC (B, H, W, out_planes)."""
        if self.width:
            x = x.transpose(1, 2)
        b, keep, l, _ = x.shape
        g, gp = self.groups, self.out_planes // self.groups
        qkv = _bn_last(self.bn_qkv, linear(self.qkv, x)).reshape(b * keep, l, g, 2 * gp)
        q, k, v = qkv.split([gp // 2, gp - gp // 2, gp], -1)
        qk = torch.einsum("nigc,njgc->ngij", q, k)
        if self.variant == "wopos":
            sim = _bn_last(self.bn_similarity, qk.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            out = torch.einsum("ngij,njgc->nigc", torch.softmax(sim, -1), v)
            out = _bn_last(self.bn_output, out.reshape(b * keep, l, self.out_planes))
            out = out.reshape(b, keep, l, self.out_planes)
            return out.transpose(1, 2) if self.width else out
        emb = self.embedding(l).to(x.dtype)
        q_emb, k_emb, v_emb = emb.split([gp // 2, gp - gp // 2, gp], 0)
        f_qr, f_kr, f_sv, f_sve = (0.1, 0.1, 1.0, 0.1) if self.variant == "dynamic" \
            else (1.0, 1.0, 1.0, 1.0)
        qr = torch.einsum("nigc,cij->ngij", q, q_emb) * f_qr
        kr = torch.einsum("njgc,cij->ngij", k, k_emb).transpose(2, 3) * f_kr
        stacked = torch.cat([qk, qr, kr], 1)  # (N, 3g, L, L)
        stacked = _bn_last(self.bn_similarity, stacked.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        attn = torch.softmax(stacked.reshape(b * keep, 3, g, l, l).sum(1), -1)
        sv = torch.einsum("ngij,njgc->nigc", attn, v) * f_sv
        sve = torch.einsum("ngij,cij->nigc", attn, v_emb) * f_sve
        out = torch.cat([sv, sve], -1).reshape(b * keep, l, 2 * self.out_planes)
        out = _bn_last(self.bn_output, out)
        # adjacent channel pairs summed, as JAX's reshape(..., out_planes, 2)
        out = out.reshape(b, keep, l, self.out_planes, 2).sum(-1)
        return out.transpose(1, 2) if self.width else out


class AxialBlock(nn.Module):
    """Axial bottleneck (bigarch.py:240): 1x1 down, H-axis then W-axis
    attention, ReLU, 1x1 up to 2 x planes, the input added (through a 1x1
    projection where c1 != 2 x planes), ReLU."""

    variant = "full"

    def __init__(self, c1: int, planes: int, groups: int = 1, kernel_size: int = 56):
        super().__init__()
        self.down_conv = nn.Conv2d(c1, planes, 1, bias=False)
        self.down_bn = flax_batch_norm(planes)
        self.hight = AxialAttention(planes, planes, groups, kernel_size, False, self.variant)
        self.width = AxialAttention(planes, planes, groups, kernel_size, True, self.variant)
        self.up_conv = nn.Conv2d(planes, 2 * planes, 1, bias=False)
        self.up_bn = flax_batch_norm(2 * planes)
        if c1 != 2 * planes:
            self.downsample_conv = nn.Conv2d(c1, 2 * planes, 1, bias=False)
            self.downsample_bn = flax_batch_norm(2 * planes)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.down_bn(conv2d(self.down_conv, x)))
        y = self.width(self.hight(_nhwc(y)))
        y = self.up_bn(conv2d(self.up_conv, F.relu(_nchw(y))))
        if self.downsample_conv is not None:
            x = self.downsample_bn(conv2d(self.downsample_conv, x))
        return F.relu(x + y)


class AxialBlock_dynamic(AxialBlock):
    """AxialBlock with the gated position terms (bigarch.py:274)."""

    variant = "dynamic"


class AxialBlock_wopos(AxialBlock):
    """AxialBlock without position embeddings (bigarch.py:280)."""

    variant = "wopos"


class DAttention(nn.Module):
    """Deformable attention (bigarch.py:286): per channel group, a strided
    depthwise conv, LayerNorm, tanh GELU and a 1x1 conv predict offsets,
    bounded by tanh · factor / (Hk, Wk), of a regular (Hk, Wk) grid of
    reference points; x is sampled there (border padding, the coordinates
    clipped to [-1, 1]) through K2, projected to keys and values, and every
    query attends to all of them."""

    def __init__(self, dim: int, n_heads: int = 4, n_groups: int = 2, stride: int = 2,
                 offset_range_factor: float = 2.0, ksize: int = 5):
        super().__init__()
        self.n_heads, self.n_groups, self.factor = n_heads, n_groups, offset_range_factor
        gc = dim // n_groups
        self.proj_q = Conv2d(dim, dim, 1)
        self.off_dw = Conv2d(gc, gc, ksize, s=stride, p=ksize // 2, g=gc)
        self.off_ln = nn.LayerNorm(gc, eps=1e-5)
        self.off_pw = Conv2d(gc, 2, 1, bias=False)
        self.proj_k = nn.Linear(dim, dim)
        self.proj_v = nn.Linear(dim, dim)
        self.proj_out = Conv2d(dim, dim, 1)

    def grid(self, q):
        """(B, Hk, Wk, 2, G) normalized xy sample points of each channel
        group, clipped to [-1, 1], from the NCHW queries (bigarch.py:291-306)."""
        b, c, h, w = q.shape
        g = self.n_groups
        off = self.off_dw(q.reshape(b * g, c // g, h, w))
        off = F.gelu(layer_norm(self.off_ln, _nhwc(off)), approximate="tanh")
        off = _nhwc(self.off_pw(_nchw(off)))  # (BG, Hk, Wk, 2), (y, x)
        hk, wk = off.shape[1:3]
        if self.factor > 0:
            rng = torch.tensor([1.0 / max(hk, 1), 1.0 / max(wk, 1)], dtype=off.dtype,
                               device=off.device)
            off = torch.tanh(off) * rng * self.factor
        ref_y = (torch.arange(hk, device=q.device, dtype=off.dtype) + 0.5) / hk * 2 - 1
        ref_x = (torch.arange(wk, device=q.device, dtype=off.dtype) + 0.5) / wk * 2 - 1
        gy, gx = torch.meshgrid(ref_y, ref_x, indexing="ij")
        grid = torch.stack([gx, gy], -1)[None] + off.flip(-1)
        return grid.clamp(-1, 1).reshape(b, g, hk, wk, 2).permute(0, 2, 3, 4, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        nh = self.n_heads
        hd = c // nh
        q = self.proj_q(x)
        grid = self.grid(q)
        hk, wk = grid.shape[1:3]
        sampled = grid_sample_bilinear(_nhwc(x), grid).reshape(b, hk * wk, c)
        kk = linear(self.proj_k, sampled).reshape(b, -1, nh, hd).transpose(1, 2)
        vv = linear(self.proj_v, sampled).reshape(b, -1, nh, hd).transpose(1, 2)
        qq = _nhwc(q).reshape(b, h * w, nh, hd).transpose(1, 2)
        attn = torch.softmax(torch.matmul(qq * hd ** -0.5, kk.transpose(-1, -2)), -1)
        out = torch.matmul(attn, vv).transpose(1, 2).reshape(b, h, w, c)
        return self.proj_out(_nchw(out))


class DAT(nn.Module):
    """DAT_YOLO (bigarch.py:318): depth x [LN → DAttention → LN → MLP (4x,
    tanh GELU)], both residual, then a 3x3 conv, the input added."""

    def __init__(self, c1: int, num_heads: int = 4, depth: int = 2):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"ln1_{i}", nn.LayerNorm(c1, eps=1e-5))
            setattr(self, f"attn_{i}", DAttention(c1, num_heads))
            setattr(self, f"ln2_{i}", nn.LayerNorm(c1, eps=1e-5))
            setattr(self, f"mlp1_{i}", nn.Linear(c1, 4 * c1))
            setattr(self, f"mlp2_{i}", nn.Linear(4 * c1, c1))
        self.tail = Conv2d(c1, c1, 3, p=1)

    def forward(self, x):
        y = _nhwc(x)
        for i in range(self.depth):
            z = layer_norm(getattr(self, f"ln1_{i}"), y)
            y = y + _nhwc(getattr(self, f"attn_{i}")(_nchw(z)))
            z = layer_norm(getattr(self, f"ln2_{i}"), y)
            z = F.gelu(linear(getattr(self, f"mlp1_{i}"), z), approximate="tanh")
            y = y + linear(getattr(self, f"mlp2_{i}"), z)
        return x + self.tail(_nchw(y))


class DeBiAttentionBlock(nn.Module):
    """DAttention then BiFormerNCHW (bigarch.py:344); `c1` as BiFormerNCHW's."""

    def __init__(self, dim: int, num_heads: int = 8, n_win: int = 7, topk: int = 4, c1: int = 0):
        super().__init__()
        self.deform = DAttention(c1 or dim, num_heads)
        self.bra = BiFormerNCHW(dim, num_heads, n_win, topk, c1=c1)

    def forward(self, x):
        return self.bra(self.deform(x))


class SwinTransformer(nn.Module):
    """Windowed-attention stage (bigarch.py:360): a 1x1 projection where
    c1 != c2, then depth Swin blocks, every second one shifted by ws // 2."""

    def __init__(self, c1: int, c2: int = 0, num_heads: int = 8, window_size: int = 7,
                 depth: int = 2):
        super().__init__()
        c2 = c2 or c1
        self.proj = Conv2d(c1, c2, 1) if c1 != c2 else None
        self.depth = depth
        for i in range(depth):
            setattr(self, f"blk{i}", SwinTransformerBlock(
                c2, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2))

    def forward(self, x):
        if self.proj is not None:
            x = self.proj(x)
        for i in range(self.depth):
            x = getattr(self, f"blk{i}")(x)
        return x


class DeBiAttention_YOLO(nn.Module):
    """The YOLO wrapper (bigarch.py:387): a 1x1 projection where c1 != c2,
    then DeBiAttentionBlock."""

    def __init__(self, c1: int, c2: int = 0, num_heads: int = 8, n_win: int = 7):
        super().__init__()
        c2 = c2 or c1
        self.project = Conv2d(c1, c2, 1) if c1 != c2 else None
        self.attn = DeBiAttentionBlock(c2, num_heads, n_win)

    def forward(self, x):
        if self.project is not None:
            x = self.project(x)
        return self.attn(x)


class ShiftWindowAttention(nn.Module):
    """Shifted-window attention (bigarch.py:410): roll by -shift, W-MSA with
    the static mask and the relative position bias, roll back."""

    def __init__(self, dim: int, heads: int = 8, window_size: int = 7, shift_size: int = 3):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.attn = WindowAttention(dim, window_size, heads)

    def forward(self, x):
        return _nchw(shifted_window_attention(self.attn, _nhwc(x), self.window_size,
                                              self.shift_size))


class FusedKQnA(nn.Module):
    """Fused query-and-attend (bigarch.py:456): `n_q` learned queries score
    every pixel's key; the k x k neighbourhood sums of score-weighted values
    and of the scores, weighted by the activated relative-position table
    (times `attn_scale` for the values), are grouped depthwise convs, one
    filter a (query, head, channel); their ratio summed over the queries.
    `c1`: the input width (default `n_channels`)."""

    def __init__(self, n_q: int, n_channels: int, n_heads: int = 8, ksize: int = 3,
                 stride: int = 1, padding: int = 1, qna_activation: str = "exp", c1: int = 0):
        super().__init__()
        self.n_q, self.n_heads, self.ksize = n_q, n_heads, ksize
        self.stride, self.padding, self.act = stride, padding, qna_activation
        hs, cs = n_heads * stride, n_channels * stride
        self.hc = n_channels // n_heads
        self.proj_k = nn.Linear(c1 or n_channels, cs, bias=False)
        self.proj_v = nn.Linear(c1 or n_channels, cs, bias=False)
        self.q_param = nn.Parameter(torch.empty(n_q, cs))
        self.attn_scale = nn.Parameter(torch.empty(ksize * ksize, n_q * hs))
        self.rpb_table = nn.Parameter(torch.empty(ksize * ksize, n_q * hs))
        self.proj_out = Conv2d(cs, cs, 1, bias=False)

    def init_own(self, generator: torch.Generator):
        """flax's initialisers: truncated_normal(sqrt(1/hc)) queries,
        normal(0.02) scales, truncated_normal(0.02) bias table (flax's
        truncated normal is cut at two standard deviations, unscaled)."""
        std = (1.0 / self.hc) ** 0.5
        nn.init.trunc_normal_(self.q_param, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.attn_scale.normal_(0.0, 0.02, generator=generator)
        nn.init.trunc_normal_(self.rpb_table, 0.0, 0.02, -0.04, 0.04, generator=generator)

    def _activate(self, t):
        if self.act == "exp":
            return torch.exp(t - t.max().detach())
        if self.act == "sigmoid":
            return torch.sigmoid(t)
        return t

    def forward(self, x):
        b, _, h, w = x.shape
        nq, hs, hc, k = self.n_q, self.n_heads * self.stride, self.hc, self.ksize
        xn = _nhwc(x)
        kh = linear(self.proj_k, xn).reshape(b, h * w, hs, hc)
        v = linear(self.proj_v, xn)
        qh = self.q_param.to(x.dtype).reshape(nq, hs, hc) * hc ** -0.5
        cost = self._activate(torch.einsum("qgc,bngc->bnqg", qh, kh))  # (B, N, nq, hs)
        rpb = self._activate(self.rpb_table).to(x.dtype)  # (k², nq·hs)
        scale = self.attn_scale.to(x.dtype)
        vq = (cost[..., None] * v.reshape(b, h * w, 1, hs, hc)).reshape(b, h, w, nq * hs * hc)
        # HWIO (k, k, 1, C) kernels as torch's (C, 1, k, k); each (q, head)
        # filter repeated over its hc channels, as jnp.repeat
        num_kern = (rpb * scale).t().repeat_interleave(hc, 0).reshape(-1, 1, k, k)
        num = F.conv2d(_nchw(vq), num_kern, stride=self.stride, padding=self.padding,
                       groups=nq * hs * hc)
        den = F.conv2d(_nchw(cost.reshape(b, h, w, nq * hs)), rpb.t().reshape(-1, 1, k, k),
                       stride=self.stride, padding=self.padding, groups=nq * hs)
        ho, wo = num.shape[2:]
        num = _nhwc(num).reshape(b, ho, wo, nq, hs, hc)
        den = _nhwc(den).reshape(b, ho, wo, nq, hs, 1)
        out = (num / den).sum(3).reshape(b, ho, wo, hs * hc)
        return self.proj_out(_nchw(out))


class OutlookAttention(nn.Module):
    """Outlook attention, stride 1 (bigarch.py:103): each pixel's k⁴ x heads
    logits (a Dense) weight the k x k patch of its `v` projection, and the
    weighted patches fold back, overlapping sums in float32. The weighted
    patches (heads, k², hd) are read as (C, k²) in their memory order, as
    JAX's reshape does: channels and taps interleave."""

    def __init__(self, dim, num_heads, kernel_size=3):
        super().__init__()
        self.num_heads, self.k = num_heads, kernel_size
        self.v = nn.Linear(dim, dim, bias=False)
        self.attn = nn.Linear(dim, kernel_size ** 4 * num_heads)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, c, h, w = x.shape
        k, nh = self.k, self.num_heads
        hd, p = c // nh, k // 2
        t = _nhwc(x)
        v_p = _unfold_patches(linear(self.v, t), k, 1).reshape(b, h, w, nh, hd, k * k)
        attn = linear(self.attn, t).reshape(b, h, w, nh, k * k, k * k) * hd ** -0.5
        out_p = torch.matmul(torch.softmax(attn, -1), v_p.transpose(-1, -2))  # (.., nh, k², hd)
        out_p = out_p.reshape(b, h, w, c, k * k)
        out = torch.zeros((b, h + 2 * p, w + 2 * p, c), device=x.device,
                          dtype=torch.promote_types(x.dtype, torch.float32))
        for i in range(k):
            for j in range(k):
                out[:, i:i + h, j:j + w] += out_p[..., i * k + j]
        return _nchw(linear(self.proj, out[:, p:p + h, p:p + w].to(x.dtype)))


class Outlooker(nn.Module):
    """VOLO's Outlooker (bigarch.py:130; the Outlooker_YOLO row): LayerNorm,
    outlook attention, residual; LayerNorm, a tanh-GELU MLP of `mlp_ratio`
    x `dim`, residual. `c1` is the input width, which the residual needs
    `dim` to equal (JAX reads it from the input)."""

    def __init__(self, c1, dim, kernel_size=3, num_heads=8, mlp_ratio=3.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(c1, eps=1e-5)
        self.attn = OutlookAttention(c1, num_heads, kernel_size)
        self.norm2 = nn.LayerNorm(c1, eps=1e-5)
        self.mlp_fc1 = nn.Linear(c1, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        t = _nhwc(x) + _nhwc(self.attn(_nchw(layer_norm(self.norm1, _nhwc(x)))))
        z = F.gelu(linear(self.mlp_fc1, layer_norm(self.norm2, t)), approximate="tanh")
        return _nchw(t + linear(self.mlp_fc2, z))
