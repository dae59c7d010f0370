"""YOLO-EMAC's blocks (port of the config-reachable part of
yolo_dbl_tpu/nn/upsample/batch3.py): DyT, WindowMHSA, MBlock, M2C2f and
C3k2_EAMC.

Modules take and return NCHW; the window attention works on the NHWC view,
in the JAX module's order of reshapes, with `torch.matmul` and softmax, as
JAX's is `einsum` outside any Pallas kernel. Module and attribute names are
the flax scope names (utils/convert.py). `nn.gelu` in flax is the tanh form.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..blocks import Bottleneck, C3k
from ..common import Conv, Conv2d, linear


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
