"""Mobile structures (port of yolo_dbl_tpu/nn/structures/mobile.py): MobileNetV4's
multi-query attention `MQA` (:34), MobileNetV5's multi-scale fusion adapter
`MFA` (:74), RepGhost's `RepGhostModule` and `RepGhostBottleneck`
(:100-150), RepLKNet's `ReparamLargeKernelConv` and `RepLKBlock`
(:152-189) and G-Ghost RegNet's `GGhostBottleneck` and `GGhostStage`
(:191-240). Each takes its input width(s) first (flax reads them from the
input) and runs on NCHW; the re-parameterizable branches stay in their
training form, as in JAX. The BatchNorms are flax's called directly
(nn/common.py `flax_batch_norm`)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.resample import resize_nearest
from ..common import Conv2d, flax_batch_norm, linear
from .blocks import add_conv_bn, conv_bn, hard_sigmoid_se


def _resize_nearest_nchw(x, h, w):
    """JAX's nearest resize (`jax.image.resize(..., "nearest")`) of an NCHW map."""
    return resize_nearest(x.permute(0, 2, 3, 1), h, w).permute(0, 3, 1, 2)


class MQA(nn.Module):
    """Multi-query attention with spatial downsampling (mobile.py:34):
    `num_heads` query heads of `key_dim` share one key and one value head
    (both `key_dim` wide, as in JAX). Queries are taken every
    `query_h_strides` rows and `query_w_strides` columns by slicing, then
    BatchNorm; keys and values come through a strided depthwise conv and
    BatchNorm where `kv_strides` > 1; the output is resized back to the
    input's size by JAX's nearest rule and projected to the input width."""

    def __init__(self, inp, num_heads=4, key_dim=64, value_dim=64, query_h_strides=1,
                 query_w_strides=1, kv_strides=1, dw_kernel_size=3):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.q_strides = (query_h_strides, query_w_strides)
        self.strided = query_h_strides > 1 or query_w_strides > 1
        if self.strided:
            self.q_ds_norm = flax_batch_norm(inp)
        self.query_proj = Conv2d(inp, num_heads * key_dim, 1, bias=False)
        self.kv_strides = kv_strides
        if kv_strides > 1:
            add_conv_bn(self, "kv_dw", inp, inp, dw_kernel_size, kv_strides, inp)
        self.key_proj = Conv2d(inp, key_dim, 1, bias=False)
        self.value_proj = Conv2d(inp, key_dim, 1, bias=False)
        self.output_proj = Conv2d(num_heads * key_dim, inp, 1, bias=False)

    def forward(self, x):
        b, _, h, w = x.shape
        nh, kd = self.num_heads, self.key_dim
        q_in = x
        if self.strided:
            q_in = self.q_ds_norm(x[:, :, ::self.q_strides[0], ::self.q_strides[1]])
        q = self.query_proj(q_in)
        qh, qw = q.shape[2:]
        q = q.reshape(b, nh, kd, qh * qw).transpose(2, 3)  # (B, nh, N, kd)
        kv_in = conv_bn(self, "kv_dw", x) if self.kv_strides > 1 else x
        k = self.key_proj(kv_in).flatten(2)  # (B, kd, M)
        v = self.value_proj(kv_in).flatten(2).transpose(1, 2)  # (B, M, kd)
        attn = torch.softmax(torch.matmul(q * kd ** -0.5, k[:, None]), -1)
        out = torch.matmul(attn, v[:, None]).transpose(2, 3).reshape(b, nh * kd, qh, qw)
        if self.strided:
            out = _resize_nearest_nchw(out, h, w)
        return self.output_proj(out)


class MFA(nn.Module):
    """Multi-scale fusion adapter (mobile.py:74): every input resized to
    r x r by JAX's nearest rule, concatenated, a ReLU 1x1 expansion by
    `expansion_ratio`, a linear 1x1 to `out_chs`, and an RMS norm over the
    channels (eps 1e-6 inside the root) scaled by `rms_scale`. `c_in`: the
    inputs' widths; the input is a list of maps."""

    def __init__(self, c_in: Sequence[int], out_chs, output_resolution=16, expansion_ratio=2.0):
        super().__init__()
        self.r = output_resolution
        cin = sum(c_in)
        hidden = int(cin * expansion_ratio)
        add_conv_bn(self, "ffn_expand", cin, hidden, 1)
        add_conv_bn(self, "ffn_proj", hidden, out_chs, 1)
        self.rms_scale = nn.Parameter(torch.ones(out_chs))

    def init_own(self, generator: torch.Generator):
        """flax's ones for the RMS norm's scale."""
        self.rms_scale.fill_(1.0)

    def forward(self, xs):
        y = torch.cat([_resize_nearest_nchw(x, self.r, self.r) for x in xs], 1)
        z = conv_bn(self, "ffn_proj", conv_bn(self, "ffn_expand", y, F.relu))
        rms = torch.sqrt(z.square().mean(1, keepdim=True) + 1e-6)
        return z / rms * self.rms_scale.to(z.dtype)[:, None, None]


class RepGhostModule(nn.Module):
    """RepGhost's add-based ghost module in its training form (mobile.py:100):
    a primary conv (ReLU with `relu`), a depthwise cheap conv, and a
    BatchNorm of the primary output added to the cheap one (ReLU with `relu`)."""

    def __init__(self, inp, oup, kernel_size=1, dw_size=3, stride=1, relu=True):
        super().__init__()
        self.relu = relu
        add_conv_bn(self, "primary", inp, oup, kernel_size, stride)
        add_conv_bn(self, "cheap", oup, oup, dw_size, 1, oup)
        self.fusion_bn = flax_batch_norm(oup)

    def forward(self, x):
        x1 = conv_bn(self, "primary", x, F.relu if self.relu else None)
        out = conv_bn(self, "cheap", x1) + self.fusion_bn(x1)
        return F.relu(out) if self.relu else out


class RepGhostBottleneck(nn.Module):
    """RepGhost's bottleneck (mobile.py:121): ghost1 to `mid_chs`, a strided
    depthwise conv, a hard-sigmoid SE, ghost2 to `out_chs`; the input added,
    or a depthwise and a 1x1 projection of it where the width or size changes."""

    def __init__(self, in_chs, mid_chs, out_chs, dw_kernel_size=3, stride=1, se_ratio=0.0):
        super().__init__()
        self.stride, self.se = stride, se_ratio > 0
        self.ghost1 = RepGhostModule(in_chs, mid_chs, relu=True)
        if stride > 1:
            add_conv_bn(self, "conv_dw", mid_chs, mid_chs, dw_kernel_size, stride, mid_chs)
        if self.se:
            rd = max(1, int(mid_chs * se_ratio))
            self.se_fc1 = nn.Linear(mid_chs, rd)
            self.se_fc2 = nn.Linear(rd, mid_chs)
        self.ghost2 = RepGhostModule(mid_chs, out_chs, relu=False)
        self.identity = in_chs == out_chs and stride == 1
        if not self.identity:
            add_conv_bn(self, "sc_dw", in_chs, in_chs, dw_kernel_size, stride, in_chs)
            add_conv_bn(self, "sc_pw", in_chs, out_chs, 1)

    def forward(self, x):
        y = self.ghost1(x)
        if self.stride > 1:
            y = conv_bn(self, "conv_dw", y)
        if self.se:
            y = hard_sigmoid_se(self.se_fc1, self.se_fc2, y)
        y = self.ghost2(y)
        if self.identity:
            return x + y
        return conv_bn(self, "sc_pw", conv_bn(self, "sc_dw", x)) + y


class ReparamLargeKernelConv(nn.Module):
    """RepLKNet's large-kernel conv in its training form (mobile.py:152): a
    kernel_size conv and its BatchNorm, plus a small_kernel conv and its
    BatchNorm where the kernel is larger, both padded k // 2."""

    def __init__(self, c1, out_channels, kernel_size=31, stride=1, groups=1, small_kernel=5):
        super().__init__()
        self.small = kernel_size > small_kernel
        add_conv_bn(self, "lk", c1, out_channels, kernel_size, stride, groups)
        if self.small:
            add_conv_bn(self, "small", c1, out_channels, small_kernel, stride, groups)

    def forward(self, x):
        y = conv_bn(self, "lk", x)
        return y + conv_bn(self, "small", x) if self.small else y


class RepLKBlock(nn.Module):
    """RepLKNet's block (mobile.py:172): a ReLU 1x1, the depthwise large
    kernel and ReLU, a linear 1x1; residual where the width holds."""

    def __init__(self, c1, c2, k=31, small_kernel=5):
        super().__init__()
        self.add = c1 == c2
        add_conv_bn(self, "pre", c1, c2, 1)
        self.lkc = ReparamLargeKernelConv(c2, c2, k, 1, c2, small_kernel)
        add_conv_bn(self, "post", c2, c2, 1)

    def forward(self, x):
        y = F.relu(self.lkc(conv_bn(self, "pre", x, F.relu)))
        y = conv_bn(self, "post", y)
        return x + y if self.add else y


class GGhostBottleneck(nn.Module):
    """G-Ghost RegNet's grouped bottleneck (mobile.py:191): ReLU 1x1, ReLU
    grouped 3x3 with the stride (groups planes // group_width, at least 1),
    linear 1x1; the input, or its strided 1x1 projection, added; ReLU."""

    def __init__(self, c1, planes, stride=1, group_width=48):
        super().__init__()
        groups = max(planes // group_width, 1)
        add_conv_bn(self, "c1", c1, planes, 1)
        add_conv_bn(self, "c2", planes, planes, 3, stride, groups)
        add_conv_bn(self, "c3", planes, planes, 1)
        self.down = stride != 1 or c1 != planes
        if self.down:
            add_conv_bn(self, "down", c1, planes, 1, stride)

    def forward(self, x):
        y = conv_bn(self, "c3", conv_bn(self, "c2", conv_bn(self, "c1", x, F.relu), F.relu))
        if self.down:
            x = conv_bn(self, "down", x)
        return F.relu(x + y)


class GGhostStage(nn.Module):
    """G-Ghost stage (mobile.py:211): a full-width base block, raw-width
    intermediate blocks on the base output's first `raw` channels, and the
    cheap channels made from the base output's rest by a 1x1 conv plus a
    mix of every block's mean over (H, W) through two bias-free Dense layers
    (ReLU between and after); the raw and cheap channels concatenated into
    a full-width end block. raw = max(int(planes (1 - cheap_ratio) / gw), 1)
    gw with gw = int(0.75 group_width), as JAX truncates them."""

    def __init__(self, c1, planes, blocks=3, stride=1, group_width=48, cheap_ratio=0.5):
        super().__init__()
        gw = int(group_width * 0.75)
        self.raw = raw = max(int(planes * (1 - cheap_ratio) / gw), 1) * gw
        cheap = planes - raw
        self.n_mid = max(blocks - 2, 0)
        self.base = GGhostBottleneck(c1, planes, stride, group_width)
        for i in range(self.n_mid):
            setattr(self, f"mid{i}", GGhostBottleneck(raw, raw, 1, group_width))
        self.merge_fc1 = nn.Linear(planes + raw * self.n_mid, cheap, bias=False)
        self.merge_fc2 = nn.Linear(cheap, cheap, bias=False)
        add_conv_bn(self, "cheap", planes - raw, cheap, 1)
        self.end = GGhostBottleneck(planes, planes, 1, group_width)

    def forward(self, x):
        y0 = self.base(x)
        feats, y = [y0], y0[:, :self.raw]
        for i in range(self.n_mid):
            y = getattr(self, f"mid{i}")(y)
            feats.append(y)
        mix = torch.cat([f.mean((2, 3)) for f in feats], 1)
        m = linear(self.merge_fc2, F.relu(linear(self.merge_fc1, mix)))
        cheap = F.relu(conv_bn(self, "cheap", y0[:, self.raw:]) + m[:, :, None, None])
        return self.end(torch.cat([y, cheap], 1))
