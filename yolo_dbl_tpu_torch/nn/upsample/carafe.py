"""CARAFE-family content-aware upsamplers (port of yolo_dbl_tpu/nn/upsample/carafe.py).

Modules take and return NCHW, as the rest of the port; inside they work on
NHWC views in the JAX module's order, so each reshape and softmax axis is
JAX's. The patch extraction is `F.unfold` (row-major (ki, kj) patches,
dilated, zero-padded), the order JAX's `_unfold_patches` reproduces with
shifted slices. The weighted sums are `torch.einsum`: plain products, as
the JAX package leaves them to XLA. Module and attribute names are the
flax scope names (utils/convert.py); `comp_bn` and `enc_bn` are flax
BatchNorms called directly, with flax's defaults (nn/common.py
`flax_batch_norm`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.resample import nearest_upsample, pixel_shuffle
from ..common import Conv, Conv2d, flax_batch_norm


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _unfold_patches(x, k: int, dilation: int = 1):
    """k x k dilated patches per pixel: NHWC (B, H, W, C) → (B, H, W, C, k²),
    zero-padded by (k // 2) * dilation, patches in row-major (ki, kj) order,
    as nn.Unfold(k, dilation=d, padding=k // 2 * d) (carafe.py:26)."""
    b, h, w, c = x.shape
    cols = F.unfold(_nchw(x), k, dilation=dilation, padding=(k // 2) * dilation)
    return cols.reshape(b, c, k * k, h, w).permute(0, 3, 4, 1, 2)


class CARAFE(nn.Module):
    """The CARAFE variant parse_model registers (carafe.py:44): low-res k x k
    reassembly with a kernel per sub-pixel, then pixel-shuffle to s x."""

    def __init__(self, c1, c2=0, kernel_size=3, up_factor=2):
        super().__init__()
        k, s = kernel_size, up_factor
        self.k, self.s = k, s
        self.down = Conv2d(c1, c1 // 4, 1)
        self.encoder = Conv2d(c1 // 4, s * s * k * k, k, p=k // 2)
        self.out = Conv2d(c1, c2 or c1, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        k, s = self.k, self.s
        # channels laid out (k², s, s); softmax over the k² kernel axis
        wgt = torch.softmax(_nhwc(self.encoder(self.down(x))).reshape(b, h, w, k * k, s * s), 3)
        patches = _unfold_patches(_nhwc(x), k, 1)
        out = torch.einsum("bhwck,bhwks->bhwcs", patches, wgt).reshape(b, h, w, c * s * s)
        return self.out(_nchw(pixel_shuffle(out, s)))


class _OfficialStyleCARAFE(nn.Module):
    """Body of CARAFE_XiaLiPKU and DLU (carafe.py:71): a compressor (1x1
    conv, flax BatchNorm, relu or silu), a kernel encoder ((s k_up)² kernels
    at low resolution: a k_enc conv and BatchNorm, or with `dsconv_enc` a
    depthwise then a pointwise conv), pixel-shuffled and softmaxed over the
    k_up² taps, which reassemble a dilated (dilation s) unfold of the
    nearest-upsampled input."""

    def __init__(self, c, c_mid=64, scale=2, k_up=5, k_enc=3, comp_act="relu",
                 dsconv_enc=False):
        super().__init__()
        self.scale, self.k_up, self.comp_act, self.dsconv_enc = scale, k_up, comp_act, dsconv_enc
        n_up = (scale * k_up) ** 2
        self.comp_conv = Conv2d(c, c_mid, 1, bias=False)
        self.comp_bn = flax_batch_norm(c_mid)
        if dsconv_enc:
            self.enc_dw = Conv2d(c_mid, c_mid, k_enc, p=k_enc // 2, g=c_mid, bias=False)
            self.enc_pw = Conv2d(c_mid, n_up, 1, bias=False)
        else:
            self.enc_conv = Conv2d(c_mid, n_up, k_enc, p=k_enc // 2, bias=False)
            self.enc_bn = flax_batch_norm(n_up)

    def forward(self, x):
        s, ku = self.scale, self.k_up
        wgt = self.comp_bn(self.comp_conv(x))
        wgt = F.relu(wgt) if self.comp_act == "relu" else F.silu(wgt)
        if self.dsconv_enc:
            wgt = self.enc_pw(self.enc_dw(wgt))
        else:
            wgt = self.enc_bn(self.enc_conv(wgt))
        wgt = torch.softmax(pixel_shuffle(_nhwc(wgt), s), -1)  # (B, sH, sW, k_up²)
        patches = _unfold_patches(nearest_upsample(_nhwc(x), s), ku, s)
        return _nchw(torch.einsum("bhwck,bhwk->bhwc", patches, wgt))


class CARAFE_XiaLiPKU(_OfficialStyleCARAFE):
    """carafe.py:107: the official-style body with a relu compressor."""


class CARAFE_simplified(nn.Module):
    """carafe.py:111: the official-style reassembly with Conv (conv, BN,
    SiLU) as compressor and Conv without activation as encoder."""

    def __init__(self, c, k_enc=3, k_up=5, c_mid=64, scale=2):
        super().__init__()
        self.scale, self.k_up = scale, k_up
        self.comp = Conv(c, c_mid, 1)
        self.enc = Conv(c_mid, (scale * k_up) ** 2, k_enc, act=False)

    def forward(self, x):
        s = self.scale
        wgt = torch.softmax(pixel_shuffle(_nhwc(self.enc(self.comp(x))), s), -1)
        patches = _unfold_patches(nearest_upsample(_nhwc(x), s), self.k_up, s)
        return _nchw(torch.einsum("bhwck,bhwk->bhwc", patches, wgt))


class DLU(_OfficialStyleCARAFE):
    """carafe.py:134: CARAFE with a depthwise-separable kernel encoder."""

    def __init__(self, c, c_mid=64, scale=2, k_up=5, k_enc=3, comp_act="relu", dsconv_enc=True):
        super().__init__(c, c_mid, scale, k_up, k_enc, comp_act, dsconv_enc)


class CARAFEPack(nn.Module):
    """The official CARAFE package (carafe.py:141): 1x1 compressor, content
    encoder of s²·g·k² kernels at low resolution, pixel-shuffled, softmax
    over k² per group, reassembling k x k low-resolution neighbourhoods
    (a dilated unfold of the nearest-upsampled input)."""

    def __init__(self, channels, scale_factor=2, up_kernel=5, up_group=1, encoder_kernel=3,
                 encoder_dilation=1, compressed_channels=64):
        super().__init__()
        self.scale, self.k_up, self.groups = scale_factor, up_kernel, up_group
        pad = (encoder_kernel - 1) * encoder_dilation // 2
        self.channel_compressor = Conv2d(channels, compressed_channels, 1)
        self.content_encoder = Conv2d(compressed_channels,
                                      up_kernel ** 2 * up_group * scale_factor ** 2,
                                      encoder_kernel, p=pad, d=encoder_dilation)

    def forward(self, x):
        b, c, h, w = x.shape
        s, ku, g = self.scale, self.k_up, self.groups
        mask = pixel_shuffle(_nhwc(self.content_encoder(self.channel_compressor(x))), s)
        mask = torch.softmax(mask.reshape(b, s * h, s * w, g, ku * ku), -1)
        patches = _unfold_patches(nearest_upsample(_nhwc(x), s), ku, s)
        patches = patches.reshape(b, s * h, s * w, g, c // g, ku * ku)
        out = torch.einsum("bhwgck,bhwgk->bhwgc", patches, mask)
        return _nchw(out.reshape(b, s * h, s * w, c))
