"""The YOLOv9/v10/11 module family (NCHW inside, PyTorch; port of
yolo_dbl_tpu/nn/v9v10.py).

RepConv (train form, unfused, as JAX keeps it), RepCSP, RepNCSPELAN4,
ELAN1, AConv, ADown, SPPELAN, RepVGGDWBlock, CIB, C2fCIB, V10Attention,
PSABlock, PSA, C2PSA and SCDown. The attention is two products and a
softmax over every token of the map, in plain PyTorch as in JAX (no Pallas
kernel there, so no hand kernel here). Attribute names are the flax scope
names, so JAX variables load key by key (utils/convert.py).

AConv and ADown keep JAX's 2x2 stride-1 mean (`avg_pool2_s1`), which pads
the right and bottom and so returns H x W, where the original's
F.avg_pool2d(x, 2, 1) returns (H-1) x (W-1): the port mirrors the reference
it is held to (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.resample import max_pool
from .common import Conv, conv2d, flax_batch_norm


def _pool(x, k, s, p):
    """max_pool of the NHWC view of NCHW `x`, returned NCHW."""
    return max_pool(x.permute(0, 2, 3, 1), k, s, p).permute(0, 3, 1, 2)


class RepConv(nn.Module):
    """RepVGG conv in train form (v9v10.py:26): a k x k conv and a 1 x 1 conv,
    each with a flax-default BatchNorm (eps 1e-5, momentum 0.99), plus an
    identity BatchNorm when `bn` and c1 == c2 and s == 1; then SiLU."""

    def __init__(self, c1, c2, k=3, s=1, g=1, bn=False, act=True):
        super().__init__()
        self.conv1_conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.conv1_bn = flax_batch_norm(c2)
        self.conv2_conv = nn.Conv2d(c1, c2, 1, s, 0, groups=g, bias=False)
        self.conv2_bn = flax_batch_norm(c2)
        self.bn = flax_batch_norm(c1) if bn and c1 == c2 and s == 1 else None
        self.act = act

    def forward(self, x):
        y = self.conv1_bn(conv2d(self.conv1_conv, x)) + self.conv2_bn(conv2d(self.conv2_conv, x))
        if self.bn is not None:
            y = y + self.bn(x)
        return F.silu(y) if self.act else y


class RepCSP(nn.Module):
    """C3 over RepBottlenecks (v9v10.py:56): `m_{i}_cv1` a RepConv, `m_{i}_cv2`
    a Conv, residual with `shortcut`."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.n, self.shortcut = n, shortcut
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}_cv1", RepConv(c_, c_, 3))
            self.add_module(f"m_{i}_cv2", Conv(c_, c_, 3, 1, g=g))
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x), self.cv2(x)
        for i in range(self.n):
            y = getattr(self, f"m_{i}_cv2")(getattr(self, f"m_{i}_cv1")(a))
            a = a + y if self.shortcut else y
        return self.cv3(torch.cat([a, b], 1))


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN (v9v10.py:79): cv1 split in two; (RepCSP, Conv) twice on
    the last part, named `cv2_0`/`cv2_1` and `cv3_0`/`cv3_1`; cv4 over all
    four parts."""

    def __init__(self, c1, c2, c3, c4, n=1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2_0 = RepCSP(c3 - self.c, c4, n)
        self.cv2_1 = Conv(c4, c4, 3, 1)
        self.cv3_0 = RepCSP(c4, c4, n)
        self.cv3_1 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        ys.append(self.cv2_1(self.cv2_0(ys[-1])))
        ys.append(self.cv3_1(self.cv3_0(ys[-1])))
        return self.cv4(torch.cat(ys, 1))


class ELAN1(nn.Module):
    """ELAN with plain convs (v9v10.py:103)."""

    def __init__(self, c1, c2, c3, c4):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = Conv(c3 - self.c, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, 1))


def avg_pool2_s1(x):
    """JAX's 2x2 stride-1 mean of NCHW `x` (v9v10.py:123 `_avg_pool2_s1`):
    the right and bottom padded by one, each window's sum divided by the
    count of the map's elements it covers. So the output is H x W, its last
    row and column the means of 2 elements (the corner `x` itself)."""
    h, w = x.shape[-2:]
    s = F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1, divisor_override=1)
    count = torch.full((h, w), 4.0, dtype=x.dtype, device=x.device)
    count[-1] /= 2
    count[:, -1] /= 2
    return s / count


class AConv(nn.Module):
    """`avg_pool2_s1`, then a 3 x 3 stride-2 Conv (v9v10.py:132)."""

    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2, 1)

    def forward(self, x):
        return self.cv1(avg_pool2_s1(x))


class ADown(nn.Module):
    """Split downsample (v9v10.py:143): `avg_pool2_s1`, then a 3 x 3 stride-2
    Conv on the first half of the channels and a 3 x 3 stride-2 max pool
    (pad 1) and a 1 x 1 Conv on the second."""

    def __init__(self, c1, c2):
        super().__init__()
        self.c1h = c1 // 2
        self.cv1 = Conv(self.c1h, c2 // 2, 3, 2, 1)
        self.cv2 = Conv(c1 - self.c1h, c2 // 2, 1, 1, 0)

    def forward(self, x):
        y = avg_pool2_s1(x)
        x1, x2 = y[:, :self.c1h], y[:, self.c1h:]
        return torch.cat([self.cv1(x1), self.cv2(_pool(x2, 3, 2, 1))], 1)


class SPPELAN(nn.Module):
    """SPP-ELAN (v9v10.py:161): cv1, three chained k x k stride-1 max pools,
    cv5 over the four maps."""

    def __init__(self, c1, c2, c3, k=5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(_pool(ys[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(ys, 1))


class RepVGGDWBlock(nn.Module):
    """Depthwise 7 x 7 and 3 x 3 Convs without activation, summed, then SiLU
    (v9v10.py:178; CIB's `lk` branch)."""

    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 7, 1, 3, g=c, act=False)
        self.conv1 = Conv(c, c, 3, 1, 1, g=c, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Conditional identity block (v9v10.py:191): `cv1_0` to `cv1_4`, the
    middle one a RepVGGDWBlock when `lk`; residual when shapes allow."""

    def __init__(self, c1, c2, shortcut=True, e=0.5, lk=False):
        super().__init__()
        c_ = int(c2 * e)
        self.add = shortcut and c1 == c2
        self.cv1_0 = Conv(c1, c1, 3, g=c1)
        self.cv1_1 = Conv(c1, 2 * c_, 1)
        self.cv1_2 = RepVGGDWBlock(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_)
        self.cv1_3 = Conv(2 * c_, c2, 1)
        self.cv1_4 = Conv(c2, c2, 3, g=c2)

    def forward(self, x):
        y = x
        for i in range(5):
            y = getattr(self, f"cv1_{i}")(y)
        return x + y if self.add else y


class C2fCIB(nn.Module):
    """C2f over CIBs (v9v10.py:214)."""

    def __init__(self, c1, c2, n=1, shortcut=False, lk=False, g=1, e=0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", CIB(c, c, shortcut, e=1.0, lk=lk))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


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


class PSA(nn.Module):
    """Position-sensitive attention (v9v10.py:278): cv1 split in two,
    V10Attention (heads of 64 channels) and a 2-conv FFN, each residual, on
    the second part, cv2 over both back to the input's width."""

    def __init__(self, c1, c2, e=0.5):
        super().__init__()
        self.c = c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.attn = V10Attention(c, max(c // 64, 1), 0.5)
        self.ffn_0 = Conv(c, 2 * c, 1)
        self.ffn_1 = Conv(2 * c, c, 1, act=False)
        self.cv2 = Conv(2 * c, c1, 1)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.c], y[:, self.c:]
        b = b + self.attn(b)
        b = b + self.ffn_1(self.ffn_0(b))
        return self.cv2(torch.cat([a, b], 1))


class SCDown(nn.Module):
    """Separable-conv downsample (v9v10.py:315): a 1 x 1 Conv, then a
    depthwise k x k stride-s Conv without activation."""

    def __init__(self, c1, c2, k=3, s=2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))
