"""Upsample pool, batch 3 (port of yolo_dbl_tpu/nn/upsample/batch3.py):
YOLO-EMAC's DyT, WindowMHSA, MBlock, M2C2f and C3k2_EAMC, and the
upsamplers CARAFEplusplus and LDA_AQU.

LDA_AQU samples its keys and the raw values at k_u² deformed taps a hi-res
query through `sample_bilinear_pixel`, which is K2 (kernels/sampling.py) on
a CUDA tensor: two grouped launches a call, one on the key map and one on
the input, each with the `n_groups` contiguous channel groups at their own
coordinates (B, Hq, Wq, k_u², G). JAX samples (B·G, H, W, C/G) copies
(batch3.py:253-260); the numbers are the same.

Modules take and return NCHW; the window attention works on the NHWC view,
in the JAX module's order of reshapes, with `torch.matmul` and softmax, as
JAX's is `einsum` outside any Pallas kernel. Module and attribute names are
the flax scope names (utils/convert.py). `nn.gelu` in flax is the tanh form.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.resample import (avg_pool2, bilinear_upsample, nearest_upsample, pixel_shuffle,
                             sample_bilinear_pixel)
from ..blocks import Bottleneck, C3k
from ..common import Conv, Conv2d, layer_norm, linear
from .carafe import _unfold_patches


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class DyT(nn.Module):
    """Dynamic tanh 'norm' (batch3.py:29): gamma · tanh(alpha · x) + beta,
    per channel (channel axis 1)."""

    def __init__(self, channels):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def init_own(self, generator: torch.Generator):
        self.alpha.fill_(1.0)
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x):
        y = torch.tanh(self.alpha.to(x.dtype) * x)
        return self.gamma.to(x.dtype)[None, :, None, None] * y \
            + self.beta.to(x.dtype)[None, :, None, None]


class WindowMHSA(nn.Module):
    """Multi-head self-attention within ws x ws windows (batch3.py:45). The
    map is padded with zeros at the bottom and right to a multiple of the
    window before the bias-free `qkv` Dense, so padded positions enter every
    softmax as zero keys with zero values: they are not masked, as in JAX."""

    def __init__(self, dim, num_heads, window_size=7):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x):
        b, c, h, w = x.shape
        ws, nh = self.window_size, self.num_heads
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        hp, wp, hd = h + ph, w + pw, c // nh
        xp = F.pad(x, (0, pw, 0, ph)).permute(0, 2, 3, 1)  # (B, Hp, Wp, C)
        qkv = linear(self.qkv, xp)
        wins = qkv.reshape(b, hp // ws, ws, wp // ws, ws, 3 * c).transpose(2, 3)
        wins = wins.reshape(-1, ws * ws, 3, nh, hd).permute(2, 0, 3, 1, 4)  # (3, BW, h, n, hd)
        q, k, v = wins[0], wins[1], wins[2]
        attn = torch.softmax(torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)), -1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, hp // ws, wp // ws, ws, ws, c)
        out = out.transpose(2, 3).reshape(b, hp, wp, c)
        return linear(self.proj, out)[:, :h, :w].permute(0, 3, 1, 2)


class MBlock(nn.Module):
    """DyT → the windows' attentions fused by a 1x1 conv, residual → DyT →
    1x1 MLP with tanh GELU, residual (batch3.py:72)."""

    def __init__(self, dim, num_heads, mlp_ratio=2.0, window_sizes=(3, 5, 7)):
        super().__init__()
        self.window_sizes = tuple(window_sizes)
        self.dyt1 = DyT(dim)
        for ws in self.window_sizes:
            self.add_module(f"win{ws}", WindowMHSA(dim, num_heads, ws))
        self.fuse = Conv2d(dim * len(self.window_sizes), dim, 1, bias=False)
        self.dyt2 = DyT(dim)
        self.mlp1 = Conv2d(dim, int(dim * mlp_ratio), 1)
        self.mlp2 = Conv2d(int(dim * mlp_ratio), dim, 1)

    def forward(self, x):
        y = self.dyt1(x)
        x = x + self.fuse(torch.cat([getattr(self, f"win{ws}")(y) for ws in self.window_sizes], 1))
        z = F.gelu(self.mlp1(self.dyt2(x)), approximate="tanh")
        return x + self.mlp2(z)


class M2C2f(nn.Module):
    """R-ELAN over pairs of MBlocks (heads of 32 channels, at least one) or
    C3k blocks (batch3.py:96). The YAML's third argument lands on
    `residual`, positionally: with attention, the output is x + gamma · out,
    gamma starting at 0.01."""

    def __init__(self, c1, c2, n=1, use_attn=True, residual=False, mlp_ratio=2.0, e=0.5, g=1,
                 shortcut=True):
        super().__init__()
        c_ = int(c2 * e)
        self.n, self.use_attn = n, use_attn
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            if use_attn:
                for j in range(2):
                    self.add_module(f"m_{i}_{j}", MBlock(c_, max(1, c_ // 32), mlp_ratio))
            else:
                self.add_module(f"m_{i}", C3k(c_, c_, 2, shortcut, g))
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if use_attn and residual else None

    def init_own(self, generator: torch.Generator):
        if self.gamma is not None:
            self.gamma.fill_(0.01)

    def forward(self, x):
        ys = [self.cv1(x)]
        for i in range(self.n):
            if self.use_attn:
                ys.append(getattr(self, f"m_{i}_1")(getattr(self, f"m_{i}_0")(ys[-1])))
            else:
                ys.append(getattr(self, f"m_{i}")(ys[-1]))
        out = self.cv2(torch.cat(ys, 1))
        if self.gamma is not None:
            return x + self.gamma.to(out.dtype)[None, :, None, None] * out
        return out


class C3k2_EAMC(nn.Module):
    """C2f with a triple-feature ECA gate (batch3.py:132): the channel mean,
    max and a 1x1 projection's mean stacked as 3 features along the channel
    axis, a bias-free 1-D conv across channels (flax's `nn.Conv` over the
    (B, C, 3) stack: kernel (k, 3, 1); here Conv1d(3, 1, k) on (B, 3, C)),
    its sigmoid gating the output."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True, eca_k=3):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", C3k(c, c, 2, shortcut, g) if c3k
                            else Bottleneck(c, c, shortcut, g))
        self.cv2 = Conv((2 + n) * c, c2, 1)
        self.channel_proj = Conv2d(c2, c2, 1)
        self.reduce_conv = nn.Conv1d(3, 1, eca_k, padding=(eca_k - 1) // 2, bias=False)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1]))
        out = self.cv2(torch.cat(ys, 1))
        yv = torch.stack([out.mean((2, 3)), out.amax((2, 3)),
                          self.channel_proj(out).mean((2, 3))], 1)  # (B, 3, C)
        conv = self.reduce_conv
        gate = F.conv1d(yv, conv.weight.to(yv.dtype), None, padding=conv.padding)[:, 0]
        return out * torch.sigmoid(gate)[:, :, None, None]


class CARAFEplusplus(nn.Module):
    """CARAFE++ (batch3.py:170): content-aware reassembly, "up" (k_u x k_u
    kernels a hi-res pixel, softmaxed, over s-dilated patches of the
    nearest-upsampled map) or "down" (kernels predicted on the 2x2-averaged,
    or s-strided, compressed map over the strided patches)."""

    def __init__(self, in_channels, scale_factor=2, up_down_type="up", k_encoder=3,
                 k_reassembly=5):
        super().__init__()
        if up_down_type not in ("up", "down"):
            raise ValueError(f"up_down_type must be 'up' or 'down', got {up_down_type!r}")
        self.s, self.ku, self.up = scale_factor, k_reassembly, up_down_type == "up"
        cm = max(in_channels // 4, 16)
        self.comp = Conv2d(in_channels, cm, 1)
        n = (scale_factor ** 2 if self.up else 1) * k_reassembly ** 2
        self.enc = Conv2d(cm, n, k_encoder, p=k_encoder // 2)

    def forward(self, x):
        s, ku = self.s, self.ku
        comp = self.comp(x)
        if self.up:
            wgt = torch.softmax(pixel_shuffle(_nhwc(self.enc(comp)), s), -1)  # (B, sH, sW, ku²)
            patches = _unfold_patches(nearest_upsample(_nhwc(x), s), ku, dilation=s)
        else:
            comp_d = _nchw(avg_pool2(_nhwc(comp))) if s == 2 else comp[:, :, ::s, ::s]
            wgt = torch.softmax(_nhwc(self.enc(comp_d)), -1)
            patches = _unfold_patches(_nhwc(x), ku, dilation=1)[:, ::s, ::s]
        return _nchw(torch.einsum("bhwck,bhwk->bhwc", patches, wgt))


class LDA_AQU(nn.Module):
    """Local deformable attention query upsampler (batch3.py:201). The
    queries, a 1x1 projection bilinearly upsampled s x, predict per channel
    group (one offset network, its weights shared by the groups) tanh-bounded
    offsets of the k_u x k_u taps around each query's lo-res parent; the
    keys (a 1x1 projection) and the raw input are sampled there (border
    padding, pixel coordinates); each query's softmax over its taps (scale
    hd^-0.5, hd = hidden / nh, plus the (k_u²,) bias `rpb`) reassembles the
    sampled input."""

    def __init__(self, in_channels, reduction_factor=4, nh=1, scale_factor=2.0, k_u=3,
                 n_groups=2, range_factor=11.0):
        super().__init__()
        self.s, self.k_u, self.n_groups = int(scale_factor), k_u, n_groups
        self.range_factor = range_factor
        hidden = in_channels // reduction_factor
        self.hd = hidden // nh
        gc = hidden // n_groups
        self.proj_q = Conv2d(in_channels, hidden, 1, bias=False)
        self.proj_k = Conv2d(in_channels, hidden, 1, bias=False)
        self.off_dw = Conv2d(gc, gc, 3, p=1, g=gc, bias=False)
        self.off_ln = nn.LayerNorm(gc, eps=1e-5)
        self.off_pw = Conv2d(gc, 2 * k_u * k_u, 3, p=1)
        self.rpb = nn.Parameter(torch.zeros(k_u * k_u))

    def init_own(self, generator: torch.Generator):
        self.rpb.zero_()

    def coords(self, q_hi, h: int, w: int):
        """(gy, gx): (B, Hq, Wq, k_u², G) pixel coordinates on the h x w map
        of every query's taps, from the NCHW hi-res queries (batch3.py:236-251)."""
        b, hidden, hq, wq = q_hi.shape
        g, k = self.n_groups, self.k_u
        qg = q_hi.reshape(b * g, hidden // g, hq, wq)
        off = F.gelu(layer_norm(self.off_ln, _nhwc(self.off_dw(qg))), approximate="tanh")
        off = torch.tanh(_nhwc(self.off_pw(_nchw(off)))) * (self.range_factor / max(h, w))
        off = off.reshape(b, g, hq, wq, k * k, 2)
        dt, dev = off.dtype, off.device
        base_y = (torch.arange(hq, dtype=dt, device=dev) + 0.5) / self.s - 0.5
        base_x = (torch.arange(wq, dtype=dt, device=dev) + 0.5) / self.s - 0.5
        d = torch.arange(k, dtype=dt, device=dev) - k // 2
        gy = base_y[:, None, None] + d.repeat_interleave(k)[None, None, :]
        gx = base_x[None, :, None] + d.repeat(k)[None, None, :]
        sy = gy + off[..., 0] * h
        sx = gx + off[..., 1] * w
        return sy.permute(0, 2, 3, 4, 1), sx.permute(0, 2, 3, 4, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        g, ku2 = self.n_groups, self.k_u ** 2
        q_hi = _nchw(bilinear_upsample(_nhwc(self.proj_q(x)), self.s, align_corners=False))
        hq, wq = q_hi.shape[2:]
        sy, sx = self.coords(q_hi, h, w)
        # (B, Hq, Wq, ku², hidden) and (B, Hq, Wq, ku², C)
        k_s = sample_bilinear_pixel(_nhwc(self.proj_k(x)), sy, sx, groups=g)
        v_s = sample_bilinear_pixel(_nhwc(x), sy, sx, groups=g)
        n, hidden = b * hq * wq, q_hi.shape[1]
        q = _nhwc(q_hi).reshape(n, g, 1, hidden // g) * self.hd ** -0.5
        k_s = k_s.reshape(n, ku2, g, hidden // g)
        v_s = v_s.reshape(n, ku2, g, c // g)
        rpb = self.rpb.to(q.dtype)
        out = []
        for j in range(g):  # a group's taps are strided slices: no copy for the products
            attn = torch.softmax(torch.matmul(q[:, j], k_s[:, :, j].transpose(1, 2)) + rpb, -1)
            out.append(torch.matmul(attn, v_s[:, :, j]))  # (N, 1, C/G)
        return _nchw(torch.cat(out, -1).reshape(b, hq, wq, c))
