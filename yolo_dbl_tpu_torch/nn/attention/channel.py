"""Channel and spatial gating attentions of the catalogue (port of
yolo_dbl_tpu/nn/attention/channel.py).

SELayer, ECALayer, ChannelAttention, SpatialAttention, CBAM, SimAM, EMA,
`h_swish`, CoordAttention, GAM, `_TripletGate`, TripletAttention, MLCA,
ELA, BAM, CoTNetLayer and ECALayer_ns. Modules take and return NCHW, as the
rest of the port, and compute in their input's type (nn/common.py).
Attribute names are the flax scope names, so JAX variables load key by key
(utils/convert.py). The JAX package composes these from pools, convs and
elementwise ops, with no Pallas kernel; so does the port.

Where flax and torch part:
- a flax `nn.BatchNorm` called directly is flax's (momentum 0.99, epsilon
  1e-5; `flax_batch_norm`), CoordAttention's has momentum 0.9;
- flax's `nn.GroupNorm` (EMA, ELA) has epsilon 1e-6;
- a flax 1-D `nn.Conv` across the channels (ECALayer, MLCA, ELA) is a
  Conv1d over the (B, 1, C) or (B, C, L) view, its kernel bridged by the
  1-D conv rule.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..common import BatchNorm, Conv2d, flax_batch_norm, lecun_normal_, linear
from .pooling import adaptive_avg_pool2d

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon


def conv1d(conv: nn.Conv1d, x):
    """`conv(x)` in `x`'s type (a flax 1-D conv with that dtype)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv1d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def group_norm(norm: nn.GroupNorm, x):
    """`norm(x)` in `x`'s type."""
    return F.group_norm(x, norm.num_groups, norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                        norm.eps)


def _eca_conv(k: int) -> nn.Conv1d:
    """The shared k-tap conv across the channels of ECA (flax nn.Conv(1, (k,)))."""
    return nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)


class SELayer(nn.Module):
    """Squeeze-and-excitation (channel.py:34)."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channel, channel // reduction, bias=False)
        self.fc2 = nn.Linear(channel // reduction, channel, bias=False)

    def forward(self, x):
        y = torch.sigmoid(linear(self.fc2, F.relu(linear(self.fc1, x.mean((2, 3))))))
        return x * y[:, :, None, None]


class ECALayer(nn.Module):
    """Efficient channel attention: a k-tap conv across the pooled channels
    (channel.py:52). `channel` is unused, as in JAX."""

    def __init__(self, channel: int = 0, k_size: int = 3):
        super().__init__()
        self.conv = _eca_conv(k_size)

    def forward(self, x):
        y = conv1d(self.conv, x.mean((2, 3))[:, None, :])[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None]


class ChannelAttention(nn.Module):
    """CBAM's channel branch (channel.py:67)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """CBAM's spatial branch (channel.py:80): a conv over the channel mean and max."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = Conv2d(2, 1, kernel_size, p=3 if kernel_size == 7 else 1, bias=False)

    def forward(self, x):
        pooled = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.cv1(pooled))


class CBAM(nn.Module):
    """Convolutional block attention (channel.py:96)."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(kernel_size)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class SimAM(nn.Module):
    """Parameter-free energy attention (channel.py:109)."""

    def __init__(self, channels: int = 0, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x):
        n = x.shape[2] * x.shape[3] - 1
        sq = (x - x.mean((2, 3), keepdim=True)) ** 2
        y = sq / (4 * (sq.sum((2, 3), keepdim=True) / n + self.e_lambda)) + 0.5
        return x * torch.sigmoid(y)


class EMA(nn.Module):
    """Efficient multi-scale attention (channel.py:126): the channels in
    `factor` groups, each gated by its H and W strip means, a GroupNorm of
    one channel a group, and a 3x3 conv, fused by softmax-weighted products."""

    def __init__(self, channels: int, factor: int = 32):
        super().__init__()
        self.groups = factor
        cg = channels // factor
        self.conv1x1 = Conv2d(cg, cg, 1)
        self.gn = nn.GroupNorm(cg, cg, eps=GN_EPS)
        self.conv3x3 = Conv2d(cg, cg, 3, p=1)

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.groups
        cg = c // g
        gx = x.reshape(b * g, cg, h, w)
        x_h = gx.mean(3, keepdim=True)  # (BG, cg, H, 1)
        x_w = gx.mean(2, keepdim=True).transpose(2, 3)  # (BG, cg, W, 1)
        hw = self.conv1x1(torch.cat([x_h, x_w], 2))
        xh, xw = hw[:, :, :h], hw[:, :, h:].transpose(2, 3)
        x1 = group_norm(self.gn, gx * torch.sigmoid(xh) * torch.sigmoid(xw))
        x2 = self.conv3x3(gx)
        x11 = torch.softmax(x1.mean((2, 3)), -1)[:, None, :]  # (BG, 1, cg)
        x21 = torch.softmax(x2.mean((2, 3)), -1)[:, None, :]
        weights = (torch.matmul(x11, x2.reshape(b * g, cg, h * w))
                   + torch.matmul(x21, x1.reshape(b * g, cg, h * w))).reshape(b * g, 1, h, w)
        return (gx * torch.sigmoid(weights)).reshape(b, c, h, w)


def h_swish(x):
    """x · relu6(x + 3) / 6 (channel.py:168)."""
    return x * F.relu6(x + 3) / 6


class CoordAttention(nn.Module):
    """Coordinate attention (channel.py:172)."""

    def __init__(self, in_channels: int, out_channels: int = 0, reduction: int = 32):
        super().__init__()
        oup = out_channels or in_channels
        temp_c = max(8, in_channels // reduction)
        self.conv1 = Conv2d(in_channels, temp_c, 1)
        self.bn1 = BatchNorm(temp_c, eps=1e-5, momentum=0.1)
        self.conv2 = Conv2d(temp_c, oup, 1)
        self.conv3 = Conv2d(temp_c, oup, 1)

    def forward(self, x):
        h = x.shape[2]
        y = torch.cat([x.mean(3, keepdim=True), x.mean(2, keepdim=True).transpose(2, 3)], 2)
        y = h_swish(self.bn1(self.conv1(y)))
        yh, yw = y[:, :, :h], y[:, :, h:].transpose(2, 3)
        return x * torch.sigmoid(self.conv3(yw)) * torch.sigmoid(self.conv2(yh))


class GAM(nn.Module):
    """Global attention mechanism (channel.py:199): a per-pixel channel MLP,
    then two grouped 7x7 conv and BatchNorm layers and the channel shuffle
    of 4 groups."""

    def __init__(self, c1: int, c2: int = 0, group: bool = True, rate: int = 4):
        super().__init__()
        c2 = c2 or c1
        g = rate if group else 1
        self.ca_fc1 = nn.Linear(c1, c1 // rate)
        self.ca_fc2 = nn.Linear(c1 // rate, c1)
        self.sa_conv1 = Conv2d(c1, c1 // rate, 7, p=3, g=g)
        self.sa_bn1 = flax_batch_norm(c1 // rate)
        self.sa_conv2 = Conv2d(c1 // rate, c2, 7, p=3, g=g)
        self.sa_bn2 = flax_batch_norm(c2)

    def forward(self, x):
        y = x.permute(0, 2, 3, 1)
        y = linear(self.ca_fc2, F.relu(linear(self.ca_fc1, y)))
        x = x * y.permute(0, 3, 1, 2)
        s = F.relu(self.sa_bn1(self.sa_conv1(x)))
        s = torch.sigmoid(self.sa_bn2(self.sa_conv2(s)))
        b, c2, h, w = s.shape
        s = s.reshape(b, 4, c2 // 4, h, w).transpose(1, 2).reshape(b, c2, h, w)
        return x * s


class _TripletGate(nn.Module):
    """One branch of TripletAttention (channel.py:229), on an NHWC tensor: a
    7x7 conv over the max and mean of its last axis, BatchNorm, sigmoid."""

    def __init__(self):
        super().__init__()
        self.spatial = Conv2d(2, 1, 7, p=3, bias=False)
        self.bn = flax_batch_norm(1)

    def forward(self, x):
        pooled = torch.stack([x.amax(-1), x.mean(-1)], 1)  # NCHW (B, 2, A, B')
        y = self.bn(self.spatial(pooled))
        return x * torch.sigmoid(y).permute(0, 2, 3, 1)


class TripletAttention(nn.Module):
    """Three rotate-and-gate branches (channel.py:243): the channel axis
    swapped with H, with W, and kept (`spatial`), each gated and averaged."""

    def __init__(self, in_channel: int = 0, spatial: bool = True):
        super().__init__()
        self.gate_h = _TripletGate()
        self.gate_w = _TripletGate()
        self.gate_s = _TripletGate() if spatial else None

    def forward(self, x):
        xn = x.permute(0, 2, 3, 1)  # NHWC, as the JAX module's axes
        o1 = self.gate_h(xn.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)
        o2 = self.gate_w(xn.permute(0, 1, 3, 2)).permute(0, 1, 3, 2)
        if self.gate_s is not None:
            out = (o1 + o2 + self.gate_s(xn)) / 3
        else:
            out = (o1 + o2) / 2
        return out.permute(0, 3, 1, 2)


class MLCA(nn.Module):
    """Mixed local-channel attention (channel.py:265): a k-tap conv across
    the globally pooled channels and one across the flattened (ls, ls, C)
    local pool, mixed and un-pooled to the input's size."""

    def __init__(self, in_size: int, local_size: int = 5, gamma: int = 2, b: int = 1,
                 local_weight: float = 0.5):
        super().__init__()
        t = int(abs(math.log(in_size, 2) + b) / gamma)
        k = t if t % 2 else t + 1
        self.local_size, self.local_weight = local_size, local_weight
        self.conv = _eca_conv(k)
        self.conv_local = _eca_conv(k)

    def forward(self, x):
        bsz, c, h, w = x.shape
        ls = self.local_size
        local = adaptive_avg_pool2d(x.permute(0, 2, 3, 1), (ls, ls))  # (B, ls, ls, C)
        yg = conv1d(self.conv, local.mean((1, 2))[:, None, :])[:, 0]
        # the NHWC flatten: position-major, channel-minor, as JAX's
        yl = conv1d(self.conv_local, local.reshape(bsz, 1, ls * ls * c))[:, 0]
        att_local = torch.sigmoid(yl.reshape(bsz, ls, ls, c))
        att_global = torch.sigmoid(yg)[:, None, None, :]
        att = att_global * (1 - self.local_weight) + att_local * self.local_weight
        return x * adaptive_avg_pool2d(att, (h, w)).permute(0, 3, 1, 2)


class ELA(nn.Module):
    """Efficient local attention (channel.py:296): the H and W strip means
    through one depthwise k-tap conv and one GroupNorm of 16 groups."""

    def __init__(self, channel: int, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv1d(channel, channel, kernel_size, padding=kernel_size // 2,
                              groups=channel, bias=False)
        self.gn = nn.GroupNorm(16, channel, eps=GN_EPS)

    def forward(self, x):
        x_h = torch.sigmoid(group_norm(self.gn, conv1d(self.conv, x.mean(3))))  # (B, C, H)
        x_w = torch.sigmoid(group_norm(self.gn, conv1d(self.conv, x.mean(2))))  # (B, C, W)
        return x * x_h[:, :, :, None] * x_w[:, :, None, :]


class BAM(nn.Module):
    """Bottleneck attention (channel.py:316): 1 + sigmoid(channel gate ·
    spatial gate), the gate always applied (JAX's BatchNorm takes batch 1)."""

    def __init__(self, c1: int, reduction: int = 16, dilation_val: int = 4):
        super().__init__()
        cr = c1 // reduction
        self.gate_c_fc0 = nn.Linear(c1, cr)
        self.gate_c_bn1 = flax_batch_norm(cr)
        self.gate_c_fc_final = nn.Linear(cr, c1)
        self.gate_s_reduce = Conv2d(c1, cr, 1)
        self.gate_s_bn_r = flax_batch_norm(cr)
        for i in range(2):
            setattr(self, f"gate_s_di{i}", Conv2d(cr, cr, 3, p=dilation_val, d=dilation_val))
            setattr(self, f"gate_s_bn{i}", flax_batch_norm(cr))
        self.gate_s_final = Conv2d(cr, 1, 1)

    def _gate_c_bn1(self, y):
        """The channel gate's BatchNorm over the batch's rows; in training on
        a batch of 1 flax's (mean the row, variance 0: the output is the
        bias), which torch's batch_norm refuses."""
        bn = self.gate_c_bn1
        if not (self.training and y.shape[0] == 1):
            return bn(y)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(y[0].float(), alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum)
        return bn.bias.to(y.dtype).expand_as(y)

    def forward(self, x):
        y = F.relu(self._gate_c_bn1(linear(self.gate_c_fc0, x.mean((2, 3)))))
        ch_att = linear(self.gate_c_fc_final, y)[:, :, None, None]
        s = F.relu(self.gate_s_bn_r(self.gate_s_reduce(x)))
        for i in range(2):
            s = F.relu(getattr(self, f"gate_s_bn{i}")(getattr(self, f"gate_s_di{i}")(s)))
        s = self.gate_s_final(s)
        return (1 + torch.sigmoid(ch_att * s)) * x


class CoTNetLayer(nn.Module):
    """Contextual transformer block (channel.py:351): static keys from a k x k
    conv, values from a 1x1, and an attention over positions from both."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.key_conv = Conv2d(dim, dim, kernel_size, p=1, bias=False)
        self.key_bn = flax_batch_norm(dim)
        self.value_conv = Conv2d(dim, dim, 1, bias=False)
        self.value_bn = flax_batch_norm(dim)
        self.att_conv1 = Conv2d(2 * dim, 2 * dim // 4, 1, bias=False)
        self.att_bn = flax_batch_norm(2 * dim // 4)
        self.att_conv2 = Conv2d(2 * dim // 4, kernel_size * kernel_size * dim, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        k1 = F.relu(self.key_bn(self.key_conv(x)))
        v = self.value_bn(self.value_conv(x))
        att = F.relu(self.att_bn(self.att_conv1(torch.cat([k1, x], 1))))
        # flax's channel c * k² + j: the k² taps of channel c, averaged
        att = self.att_conv2(att).reshape(b, c, self.kernel_size ** 2, h, w).mean(2)
        k2 = torch.softmax(att.reshape(b, c, h * w), -1) * v.reshape(b, c, h * w)
        return k1 + k2.reshape(b, c, h, w)


class ECALayer_ns(nn.Module):
    """ECA without the shared squeeze (channel.py:378): each channel's gate
    is its own k-tap combination of its pooled neighbourhood, a bare
    (C, k) parameter `conv`."""

    def __init__(self, channel: int, k_size: int = 3):
        super().__init__()
        self.k_size = k_size
        self.conv = nn.Parameter(torch.empty(channel, k_size))

    def init_own(self, generator: torch.Generator):
        """flax's lecun_normal of the (C, k) leaf: fan-in C."""
        lecun_normal_(self.conv, self.conv.shape[0], generator)

    def forward(self, x):
        c, k = x.shape[1], self.k_size
        p = (k - 1) // 2
        yp = F.pad(x.mean((2, 3)), (p, p))
        nb = torch.stack([yp[:, i:i + c] for i in range(k)], -1)  # (B, C, k)
        g = torch.sigmoid((nb * self.conv.to(x.dtype)[None]).sum(-1))
        return x * g[:, :, None, None]
