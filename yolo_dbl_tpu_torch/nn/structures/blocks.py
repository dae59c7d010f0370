"""Structure blocks (port of yolo_dbl_tpu/nn/structures/blocks.py):
`ExtractLayer` (:31, which also serves the Index row), FasterNet's `PConv`
and `FasterBlock` (:42-73), which FFCA-YOLO-L's C3_Faster chains, ScConv
(:75), EfficientNetV2's `MBConv` and `EffBlock` (:125-186), GhostNetV2's
`GhostModuleV2` and `GhostBottleneckV2` (:191-272), which C2f_PIG stacks
beyond n = 3, RepViT's `RepViTBlock` (:274-351), MobileNetV4's `UIB`
(:353), GhostNetV3's `GhostModuleV3` and `GhostBottleneckV3` (:391-472),
the pinwheel `APConvPinwheel` (:474) and `TorchVision`, a backbone taken
from a model zoo (:502-560). Each takes its input width first (flax reads
it from the input) and runs on NCHW. The re-parameterizable branches
(RepVGGDW, GhostModuleV3) stay in their training form, as in JAX. Their
BatchNorms are flax's called directly (nn/common.py `flax_batch_norm`),
APConvPinwheel's the `Conv`'s."""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from ...models.backbones import ResNet18Features, ResNet50
from ...ops.resample import resize_nearest
from ..common import Conv, Conv2d, conv2d, flax_batch_norm, linear


def add_conv_bn(owner: nn.Module, name: str, c1, c2, k, s=1, g=1, conv="c"):
    """Register flax's `{name}_{conv}` (a bias-free conv, padding k // 2)
    and `{name}_bn` (flax's own BatchNorm) on `owner`, as JAX's `conv_bn`
    helpers scope them (MobileNetV3's convs are `{name}_conv`)."""
    setattr(owner, f"{name}_{conv}", nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False))
    setattr(owner, f"{name}_bn", flax_batch_norm(c2))


def conv_bn(owner: nn.Module, name: str, x, act=None, conv="c"):
    """`{name}_bn({name}_{conv}(x))`, then `act` where given."""
    y = getattr(owner, f"{name}_bn")(conv2d(getattr(owner, f"{name}_{conv}"), x))
    return act(y) if act is not None else y


def hard_sigmoid_se(fc1: nn.Linear, fc2: nn.Linear, y):
    """The ghost bottlenecks' SE: the mean over (H, W), a ReLU Dense, a Dense,
    relu6(+3)/6, scaling `y`."""
    s = F.relu(linear(fc1, y.mean((2, 3))))
    s = torch.clamp(linear(fc2, s) + 3, 0, 6) / 6
    return y * s[:, :, None, None]


class ExtractLayer(nn.Module):
    """One item of a tuple or list output (blocks.py:31): a GiraffeNeckV2
    level, or the Index row's pick."""

    def __init__(self, from_index: int = 0):
        super().__init__()
        self.from_index = from_index

    def forward(self, x):
        return x[self.from_index]


class PConv(nn.Module):
    """FasterNet partial conv (blocks.py:42): a bias-free 3x3 conv on the
    first C/4 channels, the rest passed on, then flax's own BatchNorm and
    SiLU over the whole."""

    def __init__(self, dim):
        super().__init__()
        self.c3 = dim // 4
        self.partial_conv3 = nn.Conv2d(self.c3, self.c3, 3, padding=1, bias=False)
        self.bn = flax_batch_norm(dim)

    def forward(self, x):
        conv = self.partial_conv3
        x1 = F.conv2d(x[:, :self.c3], conv.weight.to(x.dtype), None, padding=1)
        return F.silu(self.bn(torch.cat([x1, x[:, self.c3:]], 1)))


class FasterBlock(nn.Module):
    """PConv, then a 1x1 Conv, residual when shapes allow (blocks.py:60)."""

    def __init__(self, c1, c2, shortcut=True):
        super().__init__()
        self.pconv = PConv(c1)
        self.conv1 = Conv(c1, c2, 1, 1)
        self.add = bool(shortcut) and c1 == c2

    def forward(self, x):
        y = self.conv1(self.pconv(x))
        return x + y if self.add else y


class ScConv(nn.Module):
    """Spatial and channel reconstruction conv (blocks.py:75). The SRU's
    GroupNorm is written out, as JAX's is, so that its scale `gn_scale`
    also weights the gate: the mean and the biased variance over each
    group's channels and pixels, eps 1e-5 inside the root. The CRU splits
    the channels by `alpha`, squeezes both parts by `squeeze_radio`, and
    fuses a group-wise and a point-wise conv of the upper part with the
    lower part, by a softmax over the channels' means."""

    def __init__(self, op_channel, group_num=4, gate_threshold=0.5, alpha=0.5, squeeze_radio=2,
                 group_size=2, group_kernel_size=3):
        super().__init__()
        c = op_channel
        self.group_num, self.gate_threshold = group_num, gate_threshold
        self.gn_scale = nn.Parameter(torch.ones(c))
        self.gn_bias = nn.Parameter(torch.zeros(c))
        self.up_c = up_c = int(alpha * c)
        low_c = c - up_c
        up_s, low_s = up_c // squeeze_radio, low_c // squeeze_radio
        self.squeeze1 = Conv2d(up_c, up_s, 1, bias=False)
        self.squeeze2 = Conv2d(low_c, low_s, 1, bias=False)
        self.gwc = Conv2d(up_s, c, group_kernel_size, p=group_kernel_size // 2, g=group_size)
        self.pwc1 = Conv2d(up_s, c, 1, bias=False)
        self.pwc2 = Conv2d(low_s, c - low_s, 1, bias=False)

    def init_own(self, generator: torch.Generator):
        """flax's ones and zeros for the GroupNorm's scale and bias."""
        self.gn_scale.fill_(1.0)
        self.gn_bias.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        gamma, beta = self.gn_scale.to(x.dtype), self.gn_bias.to(x.dtype)
        xg = x.reshape(b, self.group_num, c // self.group_num, h * w)
        mu = xg.mean((2, 3), keepdim=True)
        var = (xg - mu).square().mean((2, 3), keepdim=True)
        gn = ((xg - mu) / torch.sqrt(var + 1e-5)).reshape(b, c, h, w)
        gn = gn * gamma[:, None, None] + beta[:, None, None]
        rew = torch.sigmoid(gn * (gamma / gamma.sum())[:, None, None])
        gate = rew > self.gate_threshold
        x1 = torch.where(gate, torch.ones_like(rew), rew) * x
        x2 = torch.where(gate, torch.zeros_like(rew), rew) * x
        half = c // 2
        y = torch.cat([x1[:, :half] + x2[:, half:], x1[:, half:] + x2[:, :half]], 1)
        up = self.squeeze1(y[:, :self.up_c])
        low = self.squeeze2(y[:, self.up_c:])
        out = torch.cat([self.gwc(up) + self.pwc1(up), self.pwc2(low), low], 1)
        out = torch.softmax(out.mean((2, 3), keepdim=True), 1) * out
        half = out.shape[1] // 2
        return out[:, :half] + out[:, half:]


class _EffSE(nn.Module):
    """EfficientNetV2's SE (blocks.py:125): a SiLU Dense to inp // 4, a
    sigmoid Dense back to the hidden width."""

    def __init__(self, inp, hidden):
        super().__init__()
        self.fc1 = nn.Linear(hidden, inp // 4)
        self.fc2 = nn.Linear(inp // 4, hidden)

    def forward(self, x):
        y = F.silu(linear(self.fc1, x.mean((2, 3))))
        return x * torch.sigmoid(linear(self.fc2, y))[:, :, None, None]


class MBConv(nn.Module):
    """EfficientNetV2's MBConv (blocks.py:140): with `use_se` a 1x1
    expansion, a depthwise 3x3 and the SE, else one fused 3x3; then a linear
    1x1 projection, residual where the shape holds. The hidden width is
    Python's round(inp · expand_ratio)."""

    def __init__(self, inp, oup, stride=1, expand_ratio=1.0, use_se=False):
        super().__init__()
        hidden = round(inp * expand_ratio)
        self.use_se = use_se
        self.identity = stride == 1 and inp == oup
        if use_se:
            add_conv_bn(self, "pw", inp, hidden, 1)
            add_conv_bn(self, "dw", hidden, hidden, 3, stride, hidden)
            self.se = _EffSE(inp, hidden)
        else:
            add_conv_bn(self, "fused", inp, hidden, 3, stride)
        add_conv_bn(self, "pw_lin", hidden, oup, 1)

    def forward(self, x):
        if self.use_se:
            y = self.se(conv_bn(self, "dw", conv_bn(self, "pw", x, F.silu), F.silu))
        else:
            y = conv_bn(self, "fused", x, F.silu)
        y = conv_bn(self, "pw_lin", y)
        return x + y if self.identity else y


class EffBlock(nn.Module):
    """n MBConvs, the first with the stride (blocks.py:173)."""

    def __init__(self, c1, c2, n=1, s=1, t=1.0, se=0):
        super().__init__()
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}", MBConv(c1 if i == 0 else c2, c2, s if i == 0 else 1, t,
                                          bool(se)))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"m{i}")(x)
        return x


class GhostModuleV2(nn.Module):
    """Ghost module (blocks.py:191): a primary conv and a cheap depthwise
    conv, concatenated and cut to `oup`; in mode "attn" gated by DFC
    attention, the sigmoid of a 1x1 conv and 1x5, 5x1 depthwise convs on
    the 2x2-averaged input (an odd last row or column dropped), resized to
    the output by JAX's nearest rule."""

    def __init__(self, inp, oup, kernel_size=1, ratio=2, dw_size=3, stride=1, relu=True,
                 mode="original"):
        super().__init__()
        if mode not in ("original", "attn"):
            raise ValueError(f"mode must be 'original' or 'attn', got {mode!r}")
        init_c = math.ceil(oup / ratio)
        self.oup, self.relu, self.attn = oup, relu, mode == "attn"
        layers = {"primary": (inp, init_c, kernel_size, stride, 1, kernel_size // 2),
                  "cheap": (init_c, init_c * (ratio - 1), dw_size, 1, init_c, dw_size // 2)}
        if self.attn:
            layers.update(short1=(inp, oup, kernel_size, stride, 1, kernel_size // 2),
                          short2=(oup, oup, (1, 5), 1, oup, (0, 2)),
                          short3=(oup, oup, (5, 1), 1, oup, (2, 0)))
        # flax scopes `{name}_c` and `{name}_bn` (blocks.py:199, `conv_bn`)
        for name, (ci, co, k, s, g, p) in layers.items():
            setattr(self, f"{name}_c", nn.Conv2d(ci, co, k, s, p, groups=g, bias=False))
            setattr(self, f"{name}_bn", flax_batch_norm(co))

    def _cbn(self, name, x):
        return getattr(self, f"{name}_bn")(conv2d(getattr(self, f"{name}_c"), x))

    def forward(self, x):
        x1 = self._cbn("primary", x)
        x1 = F.relu(x1) if self.relu else x1
        x2 = self._cbn("cheap", x1)
        x2 = F.relu(x2) if self.relu else x2
        out = torch.cat([x1, x2], 1)[:, :self.oup]
        if not self.attn:
            return out
        b, c, h, w = x.shape
        ds = x[:, :, :h // 2 * 2, :w // 2 * 2].reshape(b, c, h // 2, 2, w // 2, 2).mean((3, 5))
        gate = torch.sigmoid(self._cbn("short3", self._cbn("short2", self._cbn("short1", ds))))
        gate = resize_nearest(gate.permute(0, 2, 3, 1), *out.shape[2:]).permute(0, 3, 1, 2)
        return out * gate


class GhostBottleneckV2(nn.Module):
    """GhostNetV2 bottleneck (blocks.py:226): ghost1 (DFC attention past
    layer 1), a strided depthwise conv, a hard-sigmoid SE, ghost2; the input
    added, or a depthwise and a 1x1 projection of it where the width or the
    size changes."""

    def __init__(self, in_chs, mid_chs, out_chs, dw_kernel_size=3, stride=1, se_ratio=0.0,
                 layer_id=2):
        super().__init__()
        k, p = dw_kernel_size, (dw_kernel_size - 1) // 2
        self.stride, self.se = stride, se_ratio > 0
        self.ghost1 = GhostModuleV2(in_chs, mid_chs, relu=True,
                                    mode="original" if layer_id <= 1 else "attn")
        if stride > 1:
            self.conv_dw = nn.Conv2d(mid_chs, mid_chs, k, stride, p, groups=mid_chs, bias=False)
            self.bn_dw = flax_batch_norm(mid_chs)
        if self.se:
            rd = max(1, int(mid_chs * se_ratio))
            self.se_fc1 = nn.Linear(mid_chs, rd)
            self.se_fc2 = nn.Linear(rd, mid_chs)
        self.ghost2 = GhostModuleV2(mid_chs, out_chs, relu=False)
        self.identity = in_chs == out_chs and stride == 1
        if not self.identity:
            self.sc_dw = nn.Conv2d(in_chs, in_chs, k, stride, p, groups=in_chs, bias=False)
            self.sc_bn1 = flax_batch_norm(in_chs)
            self.sc_pw = nn.Conv2d(in_chs, out_chs, 1, bias=False)
            self.sc_bn2 = flax_batch_norm(out_chs)

    def forward(self, x):
        y = self.ghost1(x)
        if self.stride > 1:
            y = self.bn_dw(conv2d(self.conv_dw, y))
        if self.se:
            y = hard_sigmoid_se(self.se_fc1, self.se_fc2, y)
        y = self.ghost2(y)
        if self.identity:
            return x + y
        sc = self.sc_bn1(conv2d(self.sc_dw, x))
        return self.sc_bn2(conv2d(self.sc_pw, sc)) + y


class _Conv2dBN(nn.Module):
    """RepViT's conv and flax BatchNorm (blocks.py:274); `bn_weight_init` 0
    starts the BatchNorm's scale at zero, as flax's constant(0) does."""

    def __init__(self, c1, c2, k=1, s=1, p=0, g=1, bn_weight_init=1.0):
        super().__init__()
        if bn_weight_init not in (0.0, 1.0):
            raise ValueError(f"bn_weight_init must be 0 or 1, got {bn_weight_init}")
        self.c = nn.Conv2d(c1, c2, k, s, p, groups=g, bias=False)
        self.bn = flax_batch_norm(c2)
        self.bn.zero_scale = bn_weight_init == 0.0

    def forward(self, x):
        return self.bn(conv2d(self.c, x))


class _SqueezeExcite(nn.Module):
    """RepViT's SE (blocks.py:293): a ReLU Dense to max(1, int(C · rd_ratio)),
    a sigmoid Dense back."""

    def __init__(self, c, rd_ratio=0.25):
        super().__init__()
        rd = max(1, int(c * rd_ratio))
        self.fc1 = nn.Linear(c, rd)
        self.fc2 = nn.Linear(rd, c)

    def forward(self, x):
        y = F.relu(linear(self.fc1, x.mean((2, 3))))
        return x * torch.sigmoid(linear(self.fc2, y))[:, :, None, None]


class RepVGGDW(nn.Module):
    """Depthwise RepVGG branch in its training form (blocks.py:307): a
    depthwise 3x3 with its BatchNorm, a biased depthwise 1x1 and the input,
    summed under one BatchNorm."""

    def __init__(self, c):
        super().__init__()
        self.conv = _Conv2dBN(c, c, 3, 1, 1, g=c)
        self.conv1 = nn.Conv2d(c, c, 1, groups=c)
        self.bn = flax_batch_norm(c)

    def forward(self, x):
        return self.bn(self.conv(x) + conv2d(self.conv1, x) + x)


class RepViTBlock(nn.Module):
    """RepViT's token and channel mixers (blocks.py:320), tanh GELU as
    flax's `nn.gelu`. Stride 2: a depthwise conv, the SE, a 1x1 to `oup`, and
    a residual 2·oup channel mixer; stride 1: RepVGGDW, the SE, and a
    residual channel mixer through `hidden_dim` (the input must be `oup`
    wide). `use_hs` is accepted and unused, as in JAX."""

    def __init__(self, inp, hidden_dim, oup, kernel_size=3, stride=1, use_se=True, use_hs=True):
        super().__init__()
        self.stride, self.use_se = stride, use_se
        if stride == 2:
            self.tm_dw = _Conv2dBN(inp, inp, kernel_size, stride, (kernel_size - 1) // 2, g=inp)
            self.tm_pw = _Conv2dBN(inp, oup, 1, 1, 0)
            hidden = 2 * oup
        else:
            self.tm_rep = RepVGGDW(inp)
            hidden = hidden_dim
        if use_se:
            self.tm_se = _SqueezeExcite(inp)
        self.cm_pw1 = _Conv2dBN(oup if stride == 2 else inp, hidden, 1, 1, 0)
        self.cm_pw2 = _Conv2dBN(hidden, oup, 1, 1, 0, bn_weight_init=0.0)

    def forward(self, x):
        y = self.tm_dw(x) if self.stride == 2 else self.tm_rep(x)
        if self.use_se:
            y = self.tm_se(y)
        if self.stride == 2:
            y = self.tm_pw(y)
        return y + self.cm_pw2(F.gelu(self.cm_pw1(y), approximate="tanh"))


class UIB(nn.Module):
    """MobileNetV4's universal inverted bottleneck (blocks.py:353): an
    optional depthwise start conv, a ReLU 1x1 expansion by `expand_ratio`,
    an optional ReLU depthwise middle conv, a linear 1x1 projection; the
    stride on the start conv, or on the middle one with
    `middle_downsample`; residual where the shape holds."""

    def __init__(self, inp, oup, start_dw_kernel=0, middle_dw_kernel=3, middle_downsample=False,
                 stride=1, expand_ratio=4.0):
        super().__init__()
        self.start, self.middle = bool(start_dw_kernel), bool(middle_dw_kernel)
        if self.start:
            add_conv_bn(self, "start_dw", inp, inp, start_dw_kernel,
                        1 if middle_downsample else stride, inp)
        expand_c = int(inp * expand_ratio)
        add_conv_bn(self, "expand", inp, expand_c, 1)
        if self.middle:
            add_conv_bn(self, "middle_dw", expand_c, expand_c, middle_dw_kernel,
                        stride if middle_downsample else 1, expand_c)
        add_conv_bn(self, "proj", expand_c, oup, 1)
        self.identity = stride == 1 and inp == oup

    def forward(self, x):
        y = conv_bn(self, "start_dw", x) if self.start else x
        y = conv_bn(self, "expand", y, F.relu)
        if self.middle:
            y = conv_bn(self, "middle_dw", y, F.relu)
        y = conv_bn(self, "proj", y)
        return x + y if self.identity else y


class GhostModuleV3(nn.Module):
    """GhostNetV3's ghost module in its training form (blocks.py:391): the
    primary and the cheap conv are each the sum of `num_branches` conv and
    BatchNorm branches, a 1x1 scale branch where the kernel is larger than
    1, and a BatchNorm of the input where the width and size hold; ReLU
    after each with `relu`; concatenated and cut to `oup`."""

    def __init__(self, inp, oup, kernel_size=1, stride=1, ratio=2, dw_size=3, relu=True,
                 num_branches=3):
        super().__init__()
        init_c = math.ceil(oup / ratio)
        self.oup, self.relu, self.num_branches = oup, relu, num_branches
        self.parts = {}
        for name, (ci, co, k, s, g) in {"primary": (inp, init_c, kernel_size, stride, 1),
                                        "cheap": (init_c, init_c * (ratio - 1), dw_size, 1,
                                                  init_c)}.items():
            for i in range(num_branches):
                add_conv_bn(self, f"{name}_b{i}", ci, co, k, s, g)
            if k > 1:
                add_conv_bn(self, f"{name}_scale", ci, co, 1, s, g if g == 1 else co)
            if ci == co and s == 1:
                setattr(self, f"{name}_skip", flax_batch_norm(ci))
            self.parts[name] = (k > 1, ci == co and s == 1)

    def _rpr(self, name, y):
        scale, skip = self.parts[name]
        out = sum(conv_bn(self, f"{name}_b{i}", y) for i in range(self.num_branches))
        if scale:
            out = out + conv_bn(self, f"{name}_scale", y)
        if skip:
            out = out + getattr(self, f"{name}_skip")(y)
        return out

    def forward(self, x):
        x1 = self._rpr("primary", x)
        x1 = F.relu(x1) if self.relu else x1
        x2 = self._rpr("cheap", x1)
        x2 = F.relu(x2) if self.relu else x2
        return torch.cat([x1, x2], 1)[:, :self.oup]


class GhostBottleneckV3(nn.Module):
    """GhostNetV3's bottleneck (blocks.py:436; JAX's row takes (in, out,
    mid)): ghost1 to `mid_chs`, a strided depthwise conv, a hard-sigmoid SE,
    ghost2 to `out_chs`; the input added, or a depthwise and a 1x1
    projection of it where the width or the size changes."""

    def __init__(self, in_chs, out_chs, mid_chs, dw_kernel_size=3, stride=1, se_ratio=0.0):
        super().__init__()
        k, p = dw_kernel_size, (dw_kernel_size - 1) // 2
        self.stride, self.se = stride, se_ratio > 0
        self.ghost1 = GhostModuleV3(in_chs, mid_chs, relu=True)
        if stride > 1:
            self.conv_dw = nn.Conv2d(mid_chs, mid_chs, k, stride, p, groups=mid_chs, bias=False)
            self.bn_dw = flax_batch_norm(mid_chs)
        if self.se:
            rd = max(1, int(mid_chs * se_ratio))
            self.se_fc1 = nn.Linear(mid_chs, rd)
            self.se_fc2 = nn.Linear(rd, mid_chs)
        self.ghost2 = GhostModuleV3(mid_chs, out_chs, relu=False)
        self.identity = in_chs == out_chs and stride == 1
        if not self.identity:
            self.sc_dw = nn.Conv2d(in_chs, in_chs, k, stride, p, groups=in_chs, bias=False)
            self.sc_bn1 = flax_batch_norm(in_chs)
            self.sc_pw = nn.Conv2d(in_chs, out_chs, 1, bias=False)
            self.sc_bn2 = flax_batch_norm(out_chs)

    def forward(self, x):
        y = self.ghost1(x)
        if self.stride > 1:
            y = self.bn_dw(conv2d(self.conv_dw, y))
        if self.se:
            y = hard_sigmoid_se(self.se_fc1, self.se_fc2, y)
        y = self.ghost2(y)
        if self.identity:
            return x + y
        return self.sc_bn2(conv2d(self.sc_pw, self.sc_bn1(conv2d(self.sc_dw, x)))) + y


class APConvPinwheel(nn.Module):
    """Pinwheel-shaped conv (blocks.py:474): the input padded four ways
    (left, right, top, bottom: ZeroPad2d's order, which F.pad takes),
    through a shared 1xk Conv (the two horizontal pads) and a shared kx1
    Conv (the two vertical ones), each to c2 // 4 channels with the stride,
    concatenated and merged by a 2x2 Conv."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        self.pads = ((k, 0, 1, 0), (0, k, 0, 1), (0, 1, k, 0), (1, 0, 0, k))
        self.cw = Conv(c1, c2 // 4, (1, k), s, p=0)
        self.ch = Conv(c1, c2 // 4, (k, 1), s, p=0)
        self.cat = Conv(c2 // 4 * 4, c2, 2, 1, p=0)

    def forward(self, x):
        convs = (self.cw, self.cw, self.ch, self.ch)
        return self.cat(torch.cat([conv(F.pad(x, pad)) for conv, pad in zip(convs, self.pads)], 1))


TRUNKS = {"resnet18": ResNet18Features, "resnet50": ResNet50}


class TorchVision(nn.Module):
    """A native trunk `m` standing for a torchvision model (blocks.py:502):
    `weights` is accepted for the YAML and ignored (the weights are drawn
    from the seed); the output is the trunk's last map (`truncate` >= 2, or
    no `unwrap`), or its global mean kept as a 1x1 map (`unwrap` and
    `truncate` 1: torchvision's avgpool kept, its fc dropped)."""

    def __init__(self, c1: int, c2: int, model: str = "resnet18", weights: Any = "DEFAULT",
                 unwrap: bool = True, truncate: int = 2, split: bool = False):
        super().__init__()
        if model not in TRUNKS:
            raise NotImplementedError(f"TorchVision model '{model}' has no native trunk yet; "
                                      f"available: {sorted(TRUNKS)}")
        if split:
            raise NotImplementedError("TorchVision split=True is not supported")
        self.unwrap, self.truncate = unwrap, truncate
        self.m = TRUNKS[model](c1)

    def forward(self, x):
        y = self.m(x)["layer4"]
        if self.unwrap and self.truncate == 1:
            y = y.mean((2, 3), keepdim=True)
        return y
