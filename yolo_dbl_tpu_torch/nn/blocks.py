"""YOLO building blocks (NCHW inside, PyTorch).

Port of the YOLOv13/DBL-family and stock detect-family (v3, v5, v6, v8,
11, v12) subset of yolo_dbl_tpu/nn/blocks.py, the ResNet layers of the
`-cls-resnet` configs and RT-DETR's HGStem, HGBlock and RepC3, in
dependency order.
Attribute names are the flax scope names (`cv1`, `m_0`, `edge_generator`,
...), so JAX variables load key by key (utils/convert.py). Each class cites
the JAX class it mirrors.

Each block computes in its input's type (nn/common.py). Where a float32
parameter or buffer with dimensions meets the activation, PyTorch would
promote the result to float32; each such place casts it to the
activation's type, as the JAX block does (`prototype_base`, `gamma`,
DySample's `init_pos`; the 0-d FullPAD `gate` too, as JAX casts it).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.attention import area_attention
from ..ops.resample import (avg_pool2, grid_sample_bilinear, max_pool, nearest_upsample,
                            pixel_shuffle)
from .common import Conv, Conv2d, DSConv, DWConv, conv2d, linear
from .structures.blocks import FasterBlock
from .v9v10 import RepConv


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """cv1 k[0] → cv2 k[1], residual when shapes allow (blocks.py:33)."""

    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class DSBottleneck(nn.Module):
    """DSConv k1 → DSConv k2 (dilated), residual when shapes allow (blocks.py:491)."""

    def __init__(self, c1, c2, shortcut=True, e=0.5, k1=3, k2=5, d2=1):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = DSConv(c1, c_, k1, 1, d=1)
        self.cv2 = DSConv(c_, c2, k2, 1, d=d2)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


def _add_chain(module: nn.Module, blocks):
    """Register blocks as m_0, m_1, ... (the flax names); return their count."""
    for i, blk in enumerate(blocks):
        module.add_module(f"m_{i}", blk)
    return len(blocks)


class _CSPSplit(nn.Module):
    """cv1 split in two, `blocks` chained on the last part, cv2 over every
    part: the shape of C2f, C3k2 and DSC3k2 (JAX's `call_parts` is this concat)."""

    def __init__(self, c1, c2, c, blocks):
        super().__init__()
        self.c = c
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.n = _add_chain(self, blocks)
        self.cv2 = Conv((2 + self.n) * c, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C2f(_CSPSplit):
    """n 3x3 Bottlenecks (e=1.0) on the split (blocks.py:72)."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        c = int(c2 * e)
        super().__init__(c1, c2, c, [Bottleneck(c, c, shortcut, g, (3, 3), 1.0) for _ in range(n)])


class C1(nn.Module):
    """cv1, then n 3x3 Convs chained, plus cv1's output (blocks.py:223)."""

    def __init__(self, c1, c2, n=1):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.n = _add_chain(self, [Conv(c2, c2, 3) for _ in range(n)])

    def forward(self, x):
        y = z = self.cv1(x)
        for i in range(self.n):
            z = getattr(self, f"m_{i}")(z)
        return z + y


class C2(nn.Module):
    """cv1 split in two, n 3x3 Bottlenecks (e=1.0) on the first part, cv2
    over both (blocks.py:239)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.n = _add_chain(self, [Bottleneck(c, c, shortcut, g, (3, 3), 1.0) for _ in range(n)])
        self.cv2 = Conv(2 * c, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        a = y[:, :self.c]
        for i in range(self.n):
            a = getattr(self, f"m_{i}")(a)
        return self.cv2(torch.cat([a, y[:, self.c:]], 1))


class LightConv(nn.Module):
    """1x1 Conv without activation, then a k x k depthwise Conv with ReLU
    (blocks.py:259)."""

    def __init__(self, c1, c2, k=1):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


def _relu_conv(c1, c2, k=1, s=1, p=None):
    return Conv(c1, c2, k, s, p, act=nn.ReLU())


class HGStem(nn.Module):
    """PPHGNetV2 stem (blocks.py:273): five ReLU Convs and a 2x2 stride-1 max
    pool. One zero pad on the right and bottom of stem1's output feeds both
    the stem2a branch and the pool, which is then a plain valid pool."""

    def __init__(self, c1, cm, c2):
        super().__init__()
        self.stem1 = _relu_conv(c1, cm, 3, 2)
        self.stem2a = _relu_conv(cm, cm // 2, 2, 1, 0)
        self.stem2b = _relu_conv(cm // 2, cm, 2, 1, 0)
        self.stem3 = _relu_conv(cm * 2, cm, 3, 2)
        self.stem4 = _relu_conv(cm, c2, 1, 1)

    def forward(self, x):
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        x1 = _nchw(max_pool(_nhwc(x), 2, 1, 0))
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """PPHGNetV2 block (blocks.py:296): n chained LightConvs or ReLU Convs
    `m_{i}`, the squeeze conv `sc` over the input and all their outputs,
    the excite conv `ec`; the input added where `shortcut` and the widths
    match."""

    def __init__(self, c1, cm, c2, k=3, n=6, lightconv=False, shortcut=False):
        super().__init__()
        self.n = n
        for i in range(n):
            ci = c1 if i == 0 else cm
            self.add_module(f"m_{i}", LightConv(ci, cm, k) if lightconv
                            else _relu_conv(ci, cm, k))
        self.sc = _relu_conv(c1 + n * cm, c2 // 2, 1, 1)
        self.ec = _relu_conv(c2 // 2, c2, 1, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = [x]
        for i in range(self.n):
            y.append(getattr(self, f"m_{i}")(y[-1]))
        out = self.ec(self.sc(torch.cat(y, 1)))
        return out + x if self.add else out


class RepC3(nn.Module):
    """RT-DETR's CSP block (blocks.py:322): cv1, n RepConvs `m_{i}`, plus
    cv2 of the input; cv3 only where its width c_ differs from c2."""

    def __init__(self, c1, c2, n=3, e=1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", RepConv(c_, c_))
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else None

    def forward(self, x):
        y = self.cv1(x)
        for i in range(self.n):
            y = getattr(self, f"m_{i}")(y)
        y = y + self.cv2(x)
        return y if self.cv3 is None else self.cv3(y)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: cv1, three chained k x k max pools
    (stride 1, padding k // 2), cv2 over the four maps (blocks.py:142)."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c1 // 2, 1, 1)
        self.cv2 = Conv(c1 // 2 * 4, c2, 1, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(_nchw(max_pool(_nhwc(ys[-1]), self.k, 1, self.k // 2)))
        return self.cv2(torch.cat(ys, 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: cv1 halves the channels, parallel k x k max
    pools (stride 1, padding k // 2) for each k, cv2 over the maps
    (blocks.py:385)."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        self.k = tuple(k)
        self.cv1 = Conv(c1, c1 // 2, 1, 1)
        self.cv2 = Conv(c1 // 2 * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y] + [_nchw(max_pool(_nhwc(y), k, 1, k // 2)) for k in self.k]
        return self.cv2(torch.cat(ys, 1))


class ResNetBlock(nn.Module):
    """Bottleneck ResNet block (blocks.py:344): cv1 1x1 and cv2 3x3 (stride
    s) Convs with their SiLU, cv3 1x1 to e·c2 without activation, a
    `shortcut` Conv (1x1, stride s, no activation) where the shape changes,
    and ReLU on the sum."""

    def __init__(self, c1, c2, s=1, e=4):
        super().__init__()
        c3 = e * c2
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, 3, s, p=1)
        self.cv3 = Conv(c2, c3, 1, act=False)
        self.shortcut = Conv(c1, c3, 1, s, act=False) if s != 1 or c1 != c3 else None

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return torch.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNetLayer(nn.Module):
    """n ResNet blocks `b0`, `b1`, ... (the first of stride s), or with
    `is_first` the stem: a 7x7 stride-2 Conv and a 3x3 stride-2 max pool
    of padding 1 (blocks.py:365)."""

    def __init__(self, c1, c2, s=1, is_first=False, n=1, e=4):
        super().__init__()
        self.is_first, self.n = is_first, n
        if is_first:
            self.stem = Conv(c1, c2, 7, 2, p=3)
            return
        self.b0 = ResNetBlock(c1, c2, s, e)
        for i in range(1, n):
            self.add_module(f"b{i}", ResNetBlock(e * c2, c2, 1, e))

    def forward(self, x):
        if self.is_first:
            return _nchw(max_pool(_nhwc(self.stem(x)), 3, 2, 1))
        for i in range(self.n):
            x = getattr(self, f"b{i}")(x)
        return x


class SPPCSPC(nn.Module):
    """YOLOv7's CSP spatial pyramid pooling (blocks.py:465): cv1, cv3, cv4,
    then parallel k x k max pools (stride 1, padding k // 2) for each k,
    cv5 over the maps and cv6; the shortcut cv2; cv7 over both."""

    def __init__(self, c1, c2, e=0.5, k=(5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(c_, c_, 3, 1)
        self.cv4 = Conv(c_, c_, 1, 1)
        self.cv5 = Conv(c_ * (len(self.k) + 1), c_, 1, 1)
        self.cv6 = Conv(c_, c_, 3, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv7 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        ys = [x1] + [_nchw(max_pool(_nhwc(x1), k, 1, k // 2)) for k in self.k]
        y1 = self.cv6(self.cv5(torch.cat(ys, 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class CBLinear(nn.Module):
    """YOLOv9-E's cross-branch linear (blocks.py:425): one biased conv named
    `conv`, its output split into a tuple of `c2s` channel groups."""

    def __init__(self, c1, c2s, k=1, s=1, g=1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), k, s, k // 2, groups=g, bias=True)

    def forward(self, x):
        return conv2d(self.conv, x).split(self.c2s, 1)


def _nearest_index(n_in: int, n_out: int, device):
    """jax.image.resize's nearest source rows: floor((i + 0.5) * n_in / n_out)
    in float32."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long()


def cb_fuse(xs, idx):
    """YOLOv9-E's cross-branch fuse (blocks.py:446): branch idx[i] of each
    CBLinear tuple, resized nearest to the last input's size as
    jax.image.resize does, summed with the last input (NCHW)."""
    h, w = xs[-1].shape[-2:]
    out = xs[-1]
    parts = []
    for i, x in enumerate(xs[:-1]):
        t = x[idx[i]]
        if t.shape[-2:] != (h, w):
            t = t.index_select(2, _nearest_index(t.shape[2], h, t.device))
            t = t.index_select(3, _nearest_index(t.shape[3], w, t.device))
        parts.append(t)
    return sum(parts) + out


class _CSP3(nn.Module):
    """CSP with 3 convs: `blocks` chained after cv1, cv3 over their output
    and cv2's; the shape of C3, C3k, C3Ghost and DSC3k."""

    def __init__(self, c1, c2, c_, blocks):
        super().__init__()
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.n = _add_chain(self, blocks)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m_{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class C3(_CSP3):
    """CSP bottleneck with 3 convs (blocks.py:52): n Bottlenecks with
    kernels (1, 3) and e=1.0."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [Bottleneck(c_, c_, shortcut, g, (1, 3), 1.0)
                                      for _ in range(n)])


class C3k(_CSP3):
    """C3 over Bottlenecks with a k x k kernel (blocks.py:94)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [Bottleneck(c_, c_, shortcut, g, (k, k), 1.0)
                                      for _ in range(n)])


class C3k2(_CSPSplit):
    """C2f over C3k blocks (`c3k`) or 3x3 Bottlenecks with e=0.5 (blocks.py:117)."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True):
        c = int(c2 * e)
        if c3k:
            blocks = [C3k(c, c, 2, shortcut, g) for _ in range(n)]
        else:
            blocks = [Bottleneck(c, c, shortcut, g, (3, 3), 0.5) for _ in range(n)]
        super().__init__(c1, c2, c, blocks)


class C3_Faster(_CSP3):
    """C3 over FasterNet blocks (blocks.py:401). JAX calls FasterBlock(c_,
    c_): the second argument is `shortcut`, truthy, so each block is
    residual."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [FasterBlock(c_, c_, c_) for _ in range(n)])


class GhostConv(nn.Module):
    """Ghost convolution (blocks.py:160): a primary conv makes half the
    channels, a 5x5 depthwise Conv over them the other half."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """GhostConv, a stride-2 depthwise conv when s=2, a linear GhostConv;
    the shortcut is x, or at s=2 a depthwise and a 1x1 conv (blocks.py:179)."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.gc1 = GhostConv(c1, c_, 1, 1)
        self.gc2 = GhostConv(c_, c2, 1, 1, act=False)
        if s == 2:
            self.dw = DWConv(c_, c_, k, s, act=False)
            self.sc_dw = DWConv(c1, c1, k, s, act=False)
            self.sc_pw = Conv(c1, c2, 1, 1, act=False)

    def forward(self, x):
        y = self.gc1(x)
        if self.s == 2:
            y = self.dw(y)
        y = self.gc2(y)
        return y + (self.sc_pw(self.sc_dw(x)) if self.s == 2 else x)


class C3Ghost(_CSP3):
    """C3 over GhostBottlenecks (blocks.py:203). `shortcut` and `g` are
    taken and unused, as in JAX: every GhostBottleneck adds its input."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [GhostBottleneck(c_, c_) for _ in range(n)])


class DSC3k(_CSP3):
    """C3 over DSBottlenecks (blocks.py:511)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k1=3, k2=5, d2=1):
        c_ = int(c2 * e)
        super().__init__(c1, c2, c_, [DSBottleneck(c_, c_, shortcut, 1.0, k1, k2, d2)
                                      for _ in range(n)])


class DSC3k2(_CSPSplit):
    """C2f over DSC3k / DSBottleneck blocks (blocks.py:536)."""

    def __init__(self, c1, c2, n=1, dsc3k=False, e=0.5, g=1, shortcut=True, k1=3, k2=7, d2=1):
        c = int(c2 * e)
        if dsc3k:
            blocks = [DSC3k(c, c, 2, shortcut, g, 1.0, k1, k2, d2) for _ in range(n)]
        else:
            blocks = [DSBottleneck(c, c, shortcut, 1.0, k1, k2, d2) for _ in range(n)]
        super().__init__(c1, c2, c, blocks)


class LSKblock(nn.Module):
    """Large selective kernel spatial gating (blocks.py:570): 5x5 DW and 7x7
    DW (dilation 3, padding 9) branches, avg/max channel-squeeze gate."""

    def __init__(self, dim):
        super().__init__()
        d = dim
        self.conv0 = Conv2d(d, d, 5, p=2, g=d)
        self.conv_spatial = Conv2d(d, d, 7, p=9, g=d, d=3)
        self.conv1 = Conv2d(d, d // 2, 1)
        self.conv2 = Conv2d(d, d // 2, 1)
        self.conv_squeeze = Conv2d(2, 2, 7, p=3)
        self.conv = Conv2d(d // 2, d, 1)

    def forward(self, x):
        attn1 = self.conv0(x)
        attn2 = self.conv_spatial(attn1)
        attn1 = self.conv1(attn1)
        attn2 = self.conv2(attn2)
        attn = torch.cat([attn1, attn2], 1)
        agg = torch.cat([attn.mean(1, keepdim=True), attn.amax(1, keepdim=True)], 1)
        sig = torch.sigmoid(self.conv_squeeze(agg))
        attn = attn1 * sig[:, 0:1] + attn2 * sig[:, 1:2]
        return x * self.conv(attn)


class AdaHyperedgeGen(nn.Module):
    """Adaptive hyperedge participation matrix (blocks.py:598): context-
    conditioned prototypes, multi-head similarity averaged over heads,
    softmax over the node axis."""

    def __init__(self, node_dim, num_hyperedges, num_heads=4, dropout=0.1, context="both"):
        super().__init__()
        if context != "both":
            raise NotImplementedError(f"only context='both' (YOLO-DBL) is ported, got {context!r}")
        self.num_hyperedges, self.num_heads = num_hyperedges, num_heads
        self.prototype_base = nn.Parameter(torch.empty(num_hyperedges, node_dim))
        self.context_net = nn.Linear(2 * node_dim, num_hyperedges * node_dim)
        self.pre_head_proj = nn.Linear(node_dim, node_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        b, n, d = x.shape
        e, nh = self.num_hyperedges, self.num_heads
        hd = d // nh
        ctx = torch.cat([x.mean(1), x.amax(1)], -1)
        prototypes = (self.prototype_base.to(x.dtype)[None]
                      + linear(self.context_net, ctx).reshape(b, e, d))
        xh = linear(self.pre_head_proj, x).reshape(b, n, nh, hd)
        ph = prototypes.reshape(b, e, nh, hd)
        logits = torch.einsum("bnhd,behd->bhne", xh, ph) / math.sqrt(hd)
        logits = self.dropout(logits.mean(1))  # (B, N, E)
        return torch.softmax(logits, dim=1)  # over nodes


class AdaHGConv(nn.Module):
    """Vertex → hyperedge → vertex convolution with erf GELU (blocks.py:642)."""

    def __init__(self, embed_dim, num_hyperedges=16, num_heads=4, dropout=0.1, context="both"):
        super().__init__()
        self.edge_generator = AdaHyperedgeGen(embed_dim, num_hyperedges, num_heads, dropout, context)
        self.edge_proj = nn.Linear(embed_dim, embed_dim)
        self.node_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        a = self.edge_generator(x)
        he = F.gelu(linear(self.edge_proj, torch.einsum("bne,bnd->bed", a, x)))
        xn = F.gelu(linear(self.node_proj, torch.einsum("bne,bed->bnd", a, he)))
        return xn + x


class AdaHGComputation(nn.Module):
    """NCHW ↔ (B, H*W, C) token wrapper around AdaHGConv (blocks.py:667)."""

    def __init__(self, embed_dim, num_hyperedges=16, num_heads=8, dropout=0.1, context="both"):
        super().__init__()
        self.hgnn = AdaHGConv(embed_dim, num_hyperedges, num_heads, dropout, context)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.hgnn(x.flatten(2).transpose(1, 2))
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class C3AH(nn.Module):
    """CSP wrapper over adaptive hypergraph computation (blocks.py:688)."""

    def __init__(self, c1, c2, e=1.0, num_hyperedges=8, context="both"):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 16:
            raise ValueError(f"C3AH hidden dim must be a multiple of 16, got {c_}")
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.m = AdaHGComputation(c_, num_hyperedges, c_ // 16, 0.1, context)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class FuseModule(nn.Module):
    """3-scale align + fuse for HyperACE (blocks.py:710): avg-pool x[0],
    nearest-upsample x[2], concat with x[1], 1x1 Conv to c_in."""

    def __init__(self, c_in, channel_adjust=True):
        super().__init__()
        self.conv_out = Conv((4 if channel_adjust else 3) * c_in, c_in, 1)

    def forward(self, xs):
        x1 = _nchw(avg_pool2(_nhwc(xs[0])))
        x3 = _nchw(nearest_upsample(_nhwc(xs[2]), 2))
        return self.conv_out(torch.cat([x1, xs[1], x3], 1))


class HyperACE(nn.Module):
    """Hypergraph adaptive correlation enhancement (blocks.py:730). Both C3AH
    branches read y1, as the JAX package does."""

    def __init__(self, c1, c2, n=1, num_hyperedges=8, dsc3k=True, shortcut=False, e1=0.5,
                 e2=1.0, context="both", channel_adjust=True):
        super().__init__()
        self.c = c = int(c2 * e1)
        self.fuse = FuseModule(c1, channel_adjust)
        self.cv1 = Conv(c1, 3 * c, 1, 1)
        self.branch1 = C3AH(c, c, e2, num_hyperedges, context)
        self.branch2 = C3AH(c, c, e2, num_hyperedges, context)
        if dsc3k:
            blocks = [DSC3k(c, c, 2, shortcut, k1=3, k2=7) for _ in range(n)]
        else:
            blocks = [DSBottleneck(c, c, shortcut) for _ in range(n)]
        self.n = _add_chain(self, blocks)
        self.cv2 = Conv((4 + n) * c, c2, 1)

    def forward(self, xs):
        c = self.c
        y = self.cv1(self.fuse(xs))
        y0, y1, y2 = y[:, :c], y[:, c:2 * c], y[:, 2 * c:]
        ys = [y0, self.branch1(y1), y2]
        last = y2
        for i in range(self.n):
            last = getattr(self, f"m_{i}")(last)
            ys.append(last)
        ys.append(self.branch2(y1))
        return self.cv2(torch.cat(ys, 1))


class HyperACE2(HyperACE):
    """HyperACE over FuseModule2 (blocks.py:770-784), whose fuse conv takes
    the concat's own width: flax reads it from the inputs, so JAX's module
    fits any three widths. `c_cat` is that width (the model passes its
    rows'); 4 * c1 on the v13 pyramid (c1, c1, 2 c1), as HyperACE's."""

    def __init__(self, c1, c2, n=1, num_hyperedges=8, dsc3k=True, shortcut=False, e1=0.5,
                 e2=1.0, context="both", c_cat=None):
        super().__init__(c1, c2, n, num_hyperedges, dsc3k, shortcut, e1, e2, context)
        self.fuse.conv_out = Conv(c_cat or 4 * c1, c1, 1)


class DownsampleConv(nn.Module):
    """Avg-pool /2 + channel-doubling 1x1 Conv (blocks.py:819)."""

    def __init__(self, c1, channel_adjust=True):
        super().__init__()
        self.channel_adjust = Conv(c1, 2 * c1, 1) if channel_adjust else None

    def forward(self, x):
        y = _nchw(avg_pool2(_nhwc(x)))
        return self.channel_adjust(y) if self.channel_adjust is not None else y


class FullPAD_Tunnel(nn.Module):
    """Gated residual fusion x[0] + gate * x[1], scalar gate initialised to 0 (blocks.py:834)."""

    def __init__(self):
        super().__init__()
        self.gate = nn.Parameter(torch.zeros(()))

    def forward(self, xs):
        return xs[0] + self.gate.to(xs[0].dtype) * xs[1]


class AAttn(nn.Module):
    """Area attention (blocks.py:893): attention within `area` contiguous runs
    of the row-major (h, w) tokens, plus a depthwise 7x7 position encoding of
    v. The tokens come from the NHWC view of the qkv conv's output, where
    each head holds [q_h | k_h | v_h]; the three (BB, N, H, 32) views go to
    the K3 kernels without copies on the card (channels_last)."""

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.num_heads, self.area = num_heads, area
        self.head_dim = dim // num_heads
        self.qkv = Conv(dim, 3 * dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, p=3, g=dim, act=False)
        self.proj = Conv(dim, dim, 1, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        hd = self.head_dim
        qkv = _nhwc(self.qkv(x)).reshape(b * self.area, h * w // self.area, self.num_heads, 3 * hd)
        q, k, v = qkv.split(hd, -1)
        out = _nchw(area_attention(q, k, v).reshape(b, h, w, c))
        v = _nchw(v.reshape(b, h, w, c))
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    """Area-attention block: attention and a 2-conv MLP, both residual (blocks.py:926)."""

    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp_0 = Conv(dim, hidden, 1)
        self.mlp_1 = Conv(hidden, dim, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp_1(self.mlp_0(x))


class A2C2f(nn.Module):
    """Area-attention C2f (blocks.py:944): pairs of ABlocks (heads of 32
    channels) or C3k blocks, and with `residual` a gamma-scaled shortcut."""

    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False, mlp_ratio=2.0, e=0.5, g=1,
                 shortcut=True):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 32:
            raise ValueError(f"A2C2f hidden dim must be a multiple of 32, got {c_}")
        self.n, self.a2 = n, a2
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            if a2:
                for j in range(2):
                    self.add_module(f"m_{i}_{j}", ABlock(c_, c_ // 32, mlp_ratio, area))
            else:
                self.add_module(f"m_{i}", C3k(c_, c_, 2, shortcut, g))
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if a2 and residual else None

    def forward(self, x):
        ys = [self.cv1(x)]
        for i in range(self.n):
            if self.a2:
                ys.append(getattr(self, f"m_{i}_1")(getattr(self, f"m_{i}_0")(ys[-1])))
            else:
                ys.append(getattr(self, f"m_{i}")(ys[-1]))
        out = self.cv2(torch.cat(ys, 1))
        if self.gamma is not None:
            return x + self.gamma.to(out.dtype)[None, :, None, None] * out
        return out


class DySample(nn.Module):
    """Dynamic point-sampling upsampler, 'lp' style without dyscope (blocks.py:981).

    A 1x1 conv predicts per-group offsets (x0.25) added to the static
    sub-pixel grid; the offsets are pixel-shuffled to the output size and
    each contiguous channel group is bilinearly sampled at its own
    coordinates (border padding, align_corners=False): one K2 launch.
    """

    def __init__(self, in_channels, scale=2, style="lp", groups=4, dyscope=False):
        super().__init__()
        if style != "lp" or dyscope:
            raise NotImplementedError("only DySample style='lp' without dyscope is ported")
        self.scale, self.groups = scale, groups
        self.offset = Conv2d(in_channels, 2 * groups * scale * scale, 1)
        self.register_buffer("init_pos", self._init_pos(), persistent=False)

    def _init_pos(self):
        """(2*g*s*s,) ordered [x..., y...] (blocks.py:997-1005)."""
        s = self.scale
        h = (torch.arange(s, dtype=torch.float32) - (s - 1) / 2) / s
        gy, gx = torch.meshgrid(h, h, indexing="ij")
        grid = torch.stack([gx, gy])  # (2, s, s)
        return grid.reshape(2, -1).repeat(1, self.groups).reshape(-1)

    def forward(self, x):
        b, c, h, w = x.shape
        g, s = self.groups, self.scale
        off = self.offset(x) * 0.25
        off = off + self.init_pos.to(off.dtype)[None, :, None, None]
        off = off.reshape(b, 2, g * s * s, h, w)
        # the coordinates are formed in the offsets' type, in the JAX block's
        # order (blocks.py:1019-1024): in bfloat16, as JAX forms them there
        coords_w = torch.arange(w, dtype=off.dtype, device=off.device) + 0.5
        coords_h = torch.arange(h, dtype=off.dtype, device=off.device) + 0.5
        gy, gx = torch.meshgrid(coords_h, coords_w, indexing="ij")
        coords = torch.stack([2.0 * (gx + off[:, 0]) / w - 1.0,
                              2.0 * (gy + off[:, 1]) / h - 1.0], 1)  # (B, 2, g*s*s, H, W)
        # pixel-shuffle coords to (B, sH, sW, 2, g): the group is the minor axis
        coords = pixel_shuffle(_nhwc(coords.reshape(b, 2 * g * s * s, h, w)), s)
        coords = coords.reshape(b, s * h, s * w, 2, g)
        return _nchw(grid_sample_bilinear(_nhwc(x), coords))
