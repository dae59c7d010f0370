"""The fusion and enhancement modules the YAMLs and the upsample catalogue
reach (port of part of yolo_dbl_tpu/nn/upsample/misc.py).

SPDConv, EFE and C3k2_EFE, FGM, OmniKernel and Multibranch
(yolo11-C3k2_EFE-IRSTE.yaml); FEM, SCAM, FFM_Concat2 and FFM_Concat3
(FFCA-YOLO.yaml, FFCA-YOLO-L.yaml); EUCB, MEUM and ResBlock_CBAM (the
upsample catalogue, utils/benchmarks.py); CAA (its YAML row). Modules take and return NCHW, as
the rest of the port. Module and attribute names are the flax scope names, so
JAX variables load key by key (utils/convert.py); `_BasicConv`'s BatchNorm
is a flax BatchNorm called directly (nn/common.py `flax_batch_norm`).

Two departures of the JAX package from the torch original, mirrored here:
EFE's Sobel branch is a real 2-D depthwise Sobel (`sob` plus its
transpose), where the original's mis-shaped Conv3d gives zeros; FFM's
fusion weights weight actual channels, where the original's `.view`
scrambles the axis (misc.py:8-14). `nn.gelu` in flax is the tanh form.
The FFTs are torch.fft's on complex64, whatever the input's type, as JAX's
`.astype(complex64)`; the magnitude comes back in the input's type.
ResBlock_CBAM's strided 3x3 conv pads as flax's "SAME" does: (0, 1) at
stride 2 on an even size, not (1, 1).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.resample import bilinear_upsample, nearest_upsample
from ..attention.channel import CBAM
from ..common import Conv, Conv2d, conv2d, flax_batch_norm

# the vertical Sobel kernel; EFE adds its transpose (misc.py:101)
SOBEL = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _complex_magnitude(spatial, x_f):
    """|IFFT2(spatial · x_f)| over the last two dims (misc.py:153)."""
    return torch.fft.ifft2(spatial.to(torch.complex64) * x_f).abs()


class SPDConv(nn.Module):
    """Space-to-depth conv (misc.py:74): the 2x2 phases concatenated in JAX's
    order [::2, ::2], [1::2, ::2], [::2, 1::2], [1::2, 1::2], then a 3x3 Conv."""

    def __init__(self, inc, ouc):
        super().__init__()
        self.conv = Conv(4 * inc, ouc, 3)

    def forward(self, x):
        parts = [x[:, :, ::2, ::2], x[:, :, 1::2, ::2], x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]]
        return self.conv(torch.cat(parts, 1))


class EFE(nn.Module):
    """Edge-feature enhancement (misc.py:89): depthwise Sobel (vertical plus
    horizontal) and a 3x3 Conv branch fused by a 1x1 Conv, the input added,
    a 1x1 Conv to `ouc`. The Sobel kernels are a buffer, not a parameter."""

    def __init__(self, inc, ouc):
        super().__init__()
        self.conv_branch = Conv(inc, inc, 3)
        self.conv1 = Conv(2 * inc, inc, 1)
        self.conv2 = Conv(inc, ouc, 1)
        self.register_buffer("sobel", self.sobel_kernels(inc), persistent=False)

    @staticmethod
    def sobel_kernels(c):
        """(2C, 1, 3, 3): C depthwise kernels `sob`, then C of `sob.T` (4-D, so
        that the model's channels_last conversion takes it)."""
        sob = torch.tensor(SOBEL)
        return torch.stack([sob, sob.T])[:, None, None].expand(2, c, 1, 3, 3).reshape(2 * c, 1, 3, 3)

    def init_buffers(self):
        self.sobel = self.sobel_kernels(self.conv1.conv.out_channels)

    def forward(self, x):
        c = x.shape[1]
        k = self.sobel.to(x.dtype)
        x_sobel = F.conv2d(x, k[:c], padding=1, groups=c) + F.conv2d(x, k[c:], padding=1, groups=c)
        y = self.conv1(torch.cat([x_sobel, self.conv_branch(x)], 1))
        return self.conv2(y + x)


class C3k2_EFE(nn.Module):
    """C3k2 over EFE blocks (misc.py:115): cv1 split in two, n EFE blocks
    (or, with `c3k`, C3 wrappers of two EFEs with flat scope names
    m_{i}_cv1, m_{i}_cv2, m_{i}_efe{j}, m_{i}_cv3) on the last part, cv2
    over every part."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n, self.c3k = n, c3k
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            if c3k:
                self.add_module(f"m_{i}_cv1", Conv(c, c // 2, 1))
                self.add_module(f"m_{i}_cv2", Conv(c, c // 2, 1))
                for j in range(2):
                    self.add_module(f"m_{i}_efe{j}", EFE(c // 2, c // 2))
                self.add_module(f"m_{i}_cv3", Conv(2 * (c // 2), c, 1))
            else:
                self.add_module(f"m_{i}", EFE(c, c))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            if self.c3k:
                a = getattr(self, f"m_{i}_cv1")(ys[-1])
                b = getattr(self, f"m_{i}_cv2")(ys[-1])
                for j in range(2):
                    a = getattr(self, f"m_{i}_efe{j}")(a)
                ys.append(getattr(self, f"m_{i}_cv3")(torch.cat([a, b], 1)))
            else:
                ys.append(getattr(self, f"m_{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class FGM(nn.Module):
    """Fourier gating (misc.py:144): |IFFT2(x1 · FFT2(x2))| of two 1x1 convs,
    times `alpha`, plus the input times `beta`."""

    def __init__(self, dim):
        super().__init__()
        self.dwconv1 = Conv2d(dim, dim, 1)
        self.dwconv2 = Conv2d(dim, dim, 1)
        self.alpha = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.ones(dim))

    def init_own(self, generator: torch.Generator):
        self.alpha.zero_()
        self.beta.fill_(1.0)

    def forward(self, x):
        x2f = torch.fft.fft2(self.dwconv2(x).to(torch.complex64))
        out = _complex_magnitude(self.dwconv1(x), x2f).to(x.dtype)
        alpha, beta = (p.to(x.dtype)[None, :, None, None] for p in (self.alpha, self.beta))
        return out * alpha + x * beta


class OmniKernel(nn.Module):
    """Omni-kernel block (misc.py:162): a 1x1 conv and tanh GELU, then the sum
    of the input, 1x31, 31x1, 31x31 and 1x1 depthwise convs and the
    frequency-domain channel attention with FGM, ReLU, a 1x1 conv."""

    KER, PAD = 31, 15

    def __init__(self, dim):
        super().__init__()
        c, ker, pad = dim, self.KER, self.PAD
        self.in_conv = Conv2d(c, c, 1)
        self.fac_conv = Conv2d(c, c, 1)
        self.conv_sca = Conv2d(c, c, 1)
        self.fgm = FGM(c)
        self.dw_13 = Conv2d(c, c, (1, ker), p=(0, pad), g=c)
        self.dw_31 = Conv2d(c, c, (ker, 1), p=(pad, 0), g=c)
        self.dw_33 = Conv2d(c, c, ker, p=pad, g=c)
        self.dw_11 = Conv2d(c, c, 1, g=c)
        self.out_conv = Conv2d(c, c, 1)

    def forward(self, x):
        out = F.gelu(self.in_conv(x), approximate="tanh")
        x_att = self.fac_conv(out.mean((2, 3), keepdim=True))
        x_fca = _complex_magnitude(x_att, torch.fft.fft2(out.to(torch.complex64))).to(out.dtype)
        x_sca = self.fgm(self.conv_sca(x_fca.mean((2, 3), keepdim=True)) * x_fca)
        y = torch.relu(x + self.dw_13(out) + self.dw_31(out) + self.dw_33(out) + self.dw_11(out)
                       + x_sca)
        return self.out_conv(y)


class Multibranch(nn.Module):
    """CSP-style OmniKernel branch (misc.py:190): cv1, OmniKernel on the first
    `e` of the channels, cv2 over it and the rest."""

    def __init__(self, dim, e=0.25):
        super().__init__()
        self.ce = ce = int(dim * e)
        self.cv1 = Conv(dim, dim, 1)
        self.m = OmniKernel(ce)
        self.cv2 = Conv(dim, dim, 1)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([self.m(y[:, :self.ce]), y[:, self.ce:]], 1))


class _BasicConv(nn.Module):
    """Bias-free conv, flax's own BatchNorm (momentum 0.99, eps 1e-5), ReLU
    unless `relu=False` (misc.py:207)."""

    def __init__(self, c1, c2, k=1, s=1, p=0, d=1, relu=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, p, d=d, bias=False)
        self.bn = flax_batch_norm(c2)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return torch.relu(y) if self.relu else y


class FEM(nn.Module):
    """Feature-enhancement module (misc.py:227): three branches of
    asymmetric (1x3, 3x1, strided) and 3x3 convs at dilation 5, a 1x1
    `linear` fuse, plus `scale` times it over a 1x1 `shortcut`, ReLU."""

    def __init__(self, in_planes, out_planes, stride=1, scale=0.1, map_reduce=8):
        super().__init__()
        self.scale = scale
        ip, s = in_planes // map_reduce, stride
        c_in = in_planes
        self.b0_0 = _BasicConv(c_in, 2 * ip, 1, s=s)
        self.b0_1 = _BasicConv(2 * ip, 2 * ip, 3, p=1, relu=False)
        self.b1_0 = _BasicConv(c_in, ip, 1)
        self.b1_1 = _BasicConv(ip, (ip // 2) * 3, (1, 3), s=s, p=(0, 1))
        self.b1_2 = _BasicConv((ip // 2) * 3, 2 * ip, (3, 1), s=s, p=(1, 0))
        self.b1_3 = _BasicConv(2 * ip, 2 * ip, 3, p=5, d=5, relu=False)
        self.b2_0 = _BasicConv(c_in, ip, 1)
        self.b2_1 = _BasicConv(ip, (ip // 2) * 3, (3, 1), s=s, p=(1, 0))
        self.b2_2 = _BasicConv((ip // 2) * 3, 2 * ip, (1, 3), s=s, p=(0, 1))
        self.b2_3 = _BasicConv(2 * ip, 2 * ip, 3, p=5, d=5, relu=False)
        self.linear = _BasicConv(6 * ip, out_planes, 1, relu=False)
        self.shortcut = _BasicConv(c_in, out_planes, 1, s=s, relu=False)

    def forward(self, x):
        b0 = self.b0_1(self.b0_0(x))
        b1 = self.b1_3(self.b1_2(self.b1_1(self.b1_0(x))))
        b2 = self.b2_3(self.b2_2(self.b2_1(self.b2_0(x))))
        out = self.linear(torch.cat([b0, b1, b2], 1))
        return torch.relu(out * self.scale + self.shortcut(x))


class SCAM(nn.Module):
    """Spatial context-aware module (misc.py:258): a channel context (the
    values pooled by a softmax over positions) and a spatial gate from the
    values' products with the softmaxed channel means and maxima."""

    def __init__(self, in_channels):
        super().__init__()
        c = in_channels
        self.k = Conv(c, 1, 1)
        self.v = Conv(c, c, 1)
        self.m = Conv2d(c, c, 1, bias=False)
        self.m2 = Conv(2, 1, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        avg_ = torch.softmax(x.mean((2, 3)), -1)  # (B, C)
        max_ = torch.softmax(x.amax((2, 3)), -1)
        k = torch.softmax(self.k(x).reshape(b, h * w), -1)
        v = self.v(x).reshape(b, c, h * w)
        y_ch = torch.einsum("bcn,bn->bc", v, k)[:, :, None, None]
        y_avg = torch.einsum("bc,bcn->bn", avg_, v).reshape(b, 1, h, w)
        y_max = torch.einsum("bc,bcn->bn", max_, v).reshape(b, 1, h, w)
        gate = torch.sigmoid(self.m2(torch.cat([y_avg, y_max], 1)))
        return x + F.silu(self.m(y_ch)) * gate


class _FFMConcat(nn.Module):
    """Fast-normalized weighted concat (misc.py:282,301): `w` (ones) over the
    inputs' channels, normalized by its sum plus 1e-4, each input times its
    slice. The slices' widths come from the spec row, not the inputs."""

    def __init__(self, dimension, *channels):
        super().__init__()
        self.channels = channels
        self.w = nn.Parameter(torch.ones(sum(channels)))

    def init_own(self, generator: torch.Generator):
        self.w.fill_(1.0)

    def forward(self, xs):
        weight = self.w / (self.w.sum() + 1e-4)
        parts = weight.split(self.channels)
        return torch.cat([x * p.to(x.dtype)[None, :, None, None] for x, p in zip(xs, parts,
                                                                                 strict=True)], 1)


class FFM_Concat2(_FFMConcat):
    """Two inputs (misc.py:282): channels (c // 2, c // 2) of the row."""

    def __init__(self, dimension=1, channel1=1, channel2=1):
        super().__init__(dimension, channel1, channel2)


class FFM_Concat3(_FFMConcat):
    """Three inputs (misc.py:301): channels (c // 4, c // 2, c // 4) of the row."""

    def __init__(self, dimension=1, channel1=1, channel2=1, channel3=1):
        super().__init__(dimension, channel1, channel2, channel3)


class EUCB(nn.Module):
    """Efficient up-conv block (misc.py:31): nearest 2x, a depthwise conv,
    BatchNorm and ReLU, then a 1x1 conv (the channel shuffle with groups = C
    is the identity)."""

    def __init__(self, in_channels, out_channels=0, kernel_size=3, stride=1):
        super().__init__()
        self.up_dwc = Conv2d(in_channels, in_channels, kernel_size, s=stride, p=kernel_size // 2,
                             g=in_channels, bias=False)
        self.bn = flax_batch_norm(in_channels)
        self.pwc = Conv2d(in_channels, out_channels or in_channels, 1)

    def forward(self, x):
        y = nearest_upsample(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
        return self.pwc(F.relu(self.bn(self.up_dwc(y))))


class MEUM(nn.Module):
    """Multi-scale edge-aware upsampling (misc.py:54): bilinear 2x
    (align_corners=True), a sigmoid 1x1 transform, and the edge enhancer's
    residual: t minus its 3x3 mean (zero padding, / 9), 1x1, sigmoid."""

    def __init__(self, channels):
        super().__init__()
        self.meem_conv = Conv2d(channels, channels, 1, bias=False)
        self.ee_conv = Conv2d(channels, channels, 1, bias=False)

    def forward(self, x):
        xu = bilinear_upsample(x.permute(0, 2, 3, 1), 2, align_corners=True).permute(0, 3, 1, 2)
        t = torch.sigmoid(self.meem_conv(xu))
        pooled = F.avg_pool2d(t, 3, 1, 1, count_include_pad=True)
        return xu + torch.sigmoid(self.ee_conv(t - pooled))


def same_pad(x, k: int, s: int):
    """Zero padding of flax's "SAME" for a k x k conv at stride s: the total
    max((ceil(n / s) - 1) s + k - n, 0) split with the smaller half first."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ResBlock_CBAM(nn.Module):
    """Residual bottleneck with CBAM (misc.py:345): 1x1, 3x3 (stride s) and
    1x1 bare convs with flax BatchNorms and LeakyReLU(0.1), the CBAM gate,
    the input added (through a strided 1x1 projection where the width or
    the size changes, or with `downsampling`), ReLU."""

    def __init__(self, in_places, places=0, stride=1, downsampling=False, expansion=1):
        super().__init__()
        places = places or in_places
        out_c = places * expansion
        self.stride = stride
        for name, (ci, co, k, s) in {"b0": (in_places, places, 1, 1),
                                     "b1": (places, places, 3, stride),
                                     "b2": (places, out_c, 1, 1)}.items():
            setattr(self, f"{name}_conv", nn.Conv2d(ci, co, k, s, bias=False))
            setattr(self, f"{name}_bn", flax_batch_norm(co))
        self.cbam = CBAM(out_c)
        self.project = downsampling or in_places != out_c or stride != 1
        if self.project:
            self.downsample_conv = nn.Conv2d(in_places, out_c, 1, stride, bias=False)
            self.downsample_bn = flax_batch_norm(out_c)

    def _cbl(self, name, x):
        conv = getattr(self, f"{name}_conv")
        if conv.kernel_size[0] > 1:
            x = same_pad(x, conv.kernel_size[0], conv.stride[0])
        return getattr(self, f"{name}_bn")(conv2d(conv, x))

    def forward(self, x):
        y = F.leaky_relu(self._cbl("b0", x), 0.1)
        y = F.leaky_relu(self._cbl("b1", y), 0.1)
        y = self.cbam(self._cbl("b2", y))
        res = self._cbl("downsample", x) if self.project else x
        return F.relu(y + res)


class CAA(nn.Module):
    """Context-anchor attention (misc.py:321): a 7x7 mean (zero padding,
    always / 49), a 1x1 Conv, 1 x k and k x 1 depthwise strips, a 1x1 Conv,
    its sigmoid gating the input."""

    def __init__(self, ch, h_kernel_size=11, v_kernel_size=11):
        super().__init__()
        self.conv1 = Conv(ch, ch, 1)
        self.h_conv = Conv2d(ch, ch, (1, h_kernel_size), p=(0, h_kernel_size // 2), g=ch)
        self.v_conv = Conv2d(ch, ch, (v_kernel_size, 1), p=(v_kernel_size // 2, 0), g=ch)
        self.conv2 = Conv(ch, ch, 1)

    def forward(self, x):
        y = F.avg_pool2d(x, 7, 1, 3, count_include_pad=True)
        y = self.conv2(self.v_conv(self.h_conv(self.conv1(y))))
        return torch.sigmoid(y) * x
