"""PCPE-YOLO's C2f_PIG and the wavelet-conv family (port of
yolo_dbl_tpu/nn/upsample/pig.py): the Haar bank and its one-level
transform and inverse, WTConv2d, PConvPIG, InceptionDWConv2d, C2f_PIG and
C2f_WT.

The transforms take and return NHWC, as JAX's; the modules take and
return NCHW. The Haar analysis is stride-2 and non-overlapping, so both
directions are a product of each 2x2 cell with the (4, 2, 2) bank, as JAX
forms the inverse. Module and attribute names are the flax scope names
(utils/convert.py); `base_scale` and `wavelet_scale` are bare parameters.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..common import Conv, Conv2d, conv2d
from ..structures.blocks import GhostBottleneckV2

_H = 1.0 / math.sqrt(2.0)
# db1 (Haar) decomposition filters, pywt's dec_lo and dec_hi reversed (pig.py:27-28)
_DEC_LO = (_H, _H)
_DEC_HI = (-_H, _H)


def haar_filters(dtype=torch.float32, device=None):
    """(4, 2, 2) LL, LH, HL, HH analysis bank (pig.py:31), formed in float32."""
    lo = torch.tensor(_DEC_LO, dtype=torch.float32, device=device)
    hi = torch.tensor(_DEC_HI, dtype=torch.float32, device=device)
    bank = torch.stack([lo[None, :] * lo[:, None], lo[None, :] * hi[:, None],
                        hi[None, :] * lo[:, None], hi[None, :] * hi[:, None]])
    return bank.to(dtype)


def wavelet_transform(x):
    """NHWC (B, H, W, C), H and W even → (B, H/2, W/2, C, 4) Haar subbands (pig.py:43)."""
    b, h, w, c = x.shape
    cells = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return torch.einsum("bhiwjc,kij->bhwck", cells, haar_filters(x.dtype, x.device))


def inverse_wavelet_transform(sub):
    """(B, H/2, W/2, C, 4) → NHWC (B, H, W, C) Haar reconstruction (pig.py:58)."""
    b, h2, w2, c, _ = sub.shape
    cells = torch.einsum("bhwck,kij->bhwcij", sub, haar_filters(sub.dtype, sub.device))
    return cells.permute(0, 1, 4, 2, 5, 3).reshape(b, h2 * 2, w2 * 2, c)


class WTConv2d(nn.Module):
    """Wavelet-decomposed depthwise conv, one level (pig.py:72): a biased
    depthwise conv scaled by `base_scale`, plus the inverse Haar transform of
    a bias-free depthwise conv over the 4C subbands scaled by
    `wavelet_scale`; an odd map is padded to even with zeros at the bottom
    and right for the transform and cropped after."""

    def __init__(self, channels, kernel_size=5):
        super().__init__()
        c, k = channels, kernel_size
        self.base_conv = Conv2d(c, c, k, p=k // 2, g=c)
        self.base_scale = nn.Parameter(torch.ones(c))
        self.wavelet_conv = Conv2d(4 * c, 4 * c, k, p=k // 2, g=4 * c, bias=False)
        self.wavelet_scale = nn.Parameter(torch.full((4 * c,), 0.1))

    def init_own(self, generator: torch.Generator):
        self.base_scale.fill_(1.0)
        self.wavelet_scale.fill_(0.1)

    def forward(self, x):
        b, c, h, w = x.shape
        base = self.base_conv(x) * self.base_scale.to(x.dtype)[None, :, None, None]
        xp = F.pad(x, (0, w % 2, 0, h % 2)).permute(0, 2, 3, 1)
        sub = wavelet_transform(xp)  # (B, H/2, W/2, C, 4)
        hh, ww = sub.shape[1:3]
        flat = self.wavelet_conv(sub.reshape(b, hh, ww, 4 * c).permute(0, 3, 1, 2))
        flat = flat * self.wavelet_scale.to(x.dtype)[None, :, None, None]
        rec = inverse_wavelet_transform(flat.permute(0, 2, 3, 1).reshape(b, hh, ww, c, 4))
        return base + rec[:, :h, :w].permute(0, 3, 1, 2)


class PConvPIG(nn.Module):
    """Partial conv (pig.py:103): a bias-free 3x3 conv on the first C/n_div
    channels, the rest passed on, then a 1x1 Conv to `ouc`."""

    def __init__(self, c1, ouc, n_div=4):
        super().__init__()
        self.c3 = c1 // n_div
        self.partial_conv3 = nn.Conv2d(self.c3, self.c3, 3, padding=1, bias=False)
        self.conv = Conv(c1, ouc, 1)

    def forward(self, x):
        x1 = conv2d(self.partial_conv3, x[:, :self.c3])
        return self.conv(torch.cat([x1, x[:, self.c3:]], 1))


class InceptionDWConv2d(nn.Module):
    """Inception depthwise conv (pig.py:119): of C channels the first C -
    3·gc pass, then a k x k, a 1 x bk and a bk x 1 depthwise conv on gc each
    (gc = int(C · branch_ratio)), then a k x k Conv."""

    def __init__(self, c1, out_channels, square_kernel_size=3, band_kernel_size=11,
                 branch_ratio=0.125):
        super().__init__()
        gc = int(c1 * branch_ratio)
        k, bk = square_kernel_size, band_kernel_size
        self.split = (c1 - 3 * gc, gc, gc, gc)
        self.dwconv_hw = Conv2d(gc, gc, k, p=k // 2, g=gc)
        self.dwconv_w = Conv2d(gc, gc, (1, bk), p=(0, bk // 2), g=gc)
        self.dwconv_h = Conv2d(gc, gc, (bk, 1), p=(bk // 2, 0), g=gc)
        self.fuse = Conv(c1, out_channels, k)

    def forward(self, x):
        x_id, x_hw, x_w, x_h = x.split(self.split, 1)
        y = torch.cat([x_id, self.dwconv_hw(x_hw), self.dwconv_w(x_w), self.dwconv_h(x_h)], 1)
        return self.fuse(y)


class C2f_PIG(nn.Module):
    """Parameter-inverted C2f (pig.py:147): PConvPIG then InceptionDWConv2d
    bottlenecks (the input added with `shortcut`) for n ≤ 3, GhostBottleneckV2
    (DFC attention, `se_ratio`) beyond."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5, se_ratio=0.0):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n, self.shortcut = n, shortcut
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            if n <= 3:
                self.add_module(f"m_{i}_pconv", PConvPIG(c, c))
                self.add_module(f"m_{i}_idw", InceptionDWConv2d(c, c))
            else:
                self.add_module(f"m_{i}", GhostBottleneckV2(c, c, c, se_ratio=se_ratio))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            if self.n <= 3:
                z = getattr(self, f"m_{i}_idw")(getattr(self, f"m_{i}_pconv")(ys[-1]))
                z = ys[-1] + z if self.shortcut else z
            else:
                z = getattr(self, f"m_{i}")(ys[-1])
            ys.append(z)
        return self.cv2(torch.cat(ys, 1))


class C2f_WT(nn.Module):
    """C2f over wavelet-conv bottlenecks (pig.py:178): a 3x3 Conv then a
    3x3 WTConv2d, the input added with `shortcut`."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n, self.shortcut = n, shortcut
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}_cv1", Conv(c, c, 3))
            self.add_module(f"m_{i}_wt", WTConv2d(c, 3))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            z = getattr(self, f"m_{i}_wt")(getattr(self, f"m_{i}_cv1")(ys[-1]))
            ys.append(ys[-1] + z if self.shortcut else z)
        return self.cv2(torch.cat(ys, 1))
