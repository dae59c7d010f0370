"""GiraffeNeckV2, DAMO-YOLO's queen-fusion neck (port of yolo_dbl_tpu/nn/structures/giraffe.py).

`ConvBNAct` (:27), `RepConvG` (:44: the 3x3, 1x1 and identity-BatchNorm
branches in their training form, the identity only where the widths
agree), `BasicBlock3x3Reverse` (:66), `CSPStage` (:83: dense concat of
every block's output, an optional SPP after block (n - 1) // 2 whose max
pools pad with -inf) and `GiraffeNeckV2` (:114). Each takes its input
width(s) first, which flax reads from the input, and runs on NCHW; the
BatchNorms are flax's called directly (nn/common.py `flax_batch_norm`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.resample import max_pool
from ..common import conv2d, flax_batch_norm

ACTS = {"silu": F.silu, "swish": F.silu, "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, 0.1)}


def _upsample2(x):
    """Nearest 2x upsample of an NCHW map (resample.py `nearest_upsample`)."""
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


class ConvBNAct(nn.Module):
    """A bias-free k x k conv (padding (k - 1) // 2), flax's BatchNorm, the activation."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, (k - 1) // 2, groups=g, bias=False)
        self.bn = flax_batch_norm(c2)
        self.act = ACTS[act]

    def forward(self, x):
        return self.act(self.bn(conv2d(self.conv, x)))


class RepConvG(nn.Module):
    """RepVGG's 3x3 + 1x1 + identity-BatchNorm branches, summed, then the
    activation; `id_bn` exists only where c1 == c2."""

    def __init__(self, c1, c2, act="relu"):
        super().__init__()
        self.dense_conv = nn.Conv2d(c1, c2, 3, 1, 1, bias=False)
        self.dense_bn = flax_batch_norm(c2)
        self.pw_conv = nn.Conv2d(c1, c2, 1, bias=False)
        self.pw_bn = flax_batch_norm(c2)
        if c1 == c2:
            self.id_bn = flax_batch_norm(c1)
        self.identity = c1 == c2
        self.act = ACTS[act]

    def forward(self, x):
        y = self.dense_bn(conv2d(self.dense_conv, x)) + self.pw_bn(conv2d(self.pw_conv, x))
        if self.identity:
            y = y + self.id_bn(x)
        return self.act(y)


class BasicBlock3x3Reverse(nn.Module):
    """RepConvG to int(c1 · hidden_ratio), a 3x3 ConvBNAct to c2; residual
    with `shortcut`."""

    def __init__(self, c1, hidden_ratio, c2, act="silu", shortcut=True):
        super().__init__()
        hidden = int(c1 * hidden_ratio)
        self.conv2 = RepConvG(c1, hidden, act=act)
        self.conv1 = ConvBNAct(hidden, c2, 3, act=act)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv1(self.conv2(x))
        return x + y if self.shortcut else y


class CSPStage(nn.Module):
    """Two 1x1 ConvBNActs split c2 into c2 // 2 and the rest; n blocks run
    on the second, each block's output kept; an optional SPP (the map and
    its 5, 9, 13 max pools through a 1x1) after block (n - 1) // 2; every
    kept map concatenated through a 1x1 to c2."""

    def __init__(self, c1, hidden_ratio, c2, n, act="silu", spp=False):
        super().__init__()
        ch_first = c2 // 2
        ch_mid = c2 - ch_first
        self.n, self.spp_at = n, (n - 1) // 2 if spp else None
        self.conv1 = ConvBNAct(c1, ch_first, 1, act=act)
        self.conv2 = ConvBNAct(c1, ch_mid, 1, act=act)
        for i in range(n):
            setattr(self, f"blk{i}", BasicBlock3x3Reverse(ch_mid, hidden_ratio, ch_mid, act=act))
        if spp:
            self.spp = ConvBNAct(4 * ch_mid, ch_mid, 1, act=act)
        self.conv3 = ConvBNAct(ch_first + n * ch_mid, c2, 1, act=act)

    def forward(self, x):
        y2 = self.conv2(x)
        mids = [self.conv1(x)]
        for i in range(self.n):
            y2 = getattr(self, f"blk{i}")(y2)
            mids.append(y2)
            if i == self.spp_at:
                pools = [y2] + [max_pool(y2.permute(0, 2, 3, 1), k, 1, k // 2).permute(0, 3, 1, 2)
                                for k in (5, 9, 13)]
                y2 = self.spp(torch.cat(pools, 1))
        return self.conv3(torch.cat(mids, 1))


class GiraffeNeckV2(nn.Module):
    """DAMO-YOLO's queen-fusion neck: [P3, P4, P5] → (P3', P4', P5') of
    `out_channels`. `c_in`: the widths of the three inputs; `in_channels`
    (JAX's row gives its inputs' widths) set the widths of the inner convs.
    n = max(round(3 · depth), 1) blocks a CSPStage."""

    def __init__(self, c_in: Sequence[int], in_channels: Tuple[int, int, int],
                 out_channels: Tuple[int, int, int] = (256, 512, 1024), depth=1.0,
                 hidden_ratio=1.0, act="silu", spp=False):
        super().__init__()
        c2_, c1_, c0_ = c_in
        ic, oc = in_channels, out_channels
        n = max(round(3 * depth), 1)

        def csp(c1, c2):
            return CSPStage(c1, hidden_ratio, c2, n, act=act, spp=spp)

        self.bu_conv13 = ConvBNAct(c1_, ic[1], 3, 2, act=act)
        self.merge_3 = csp(c0_ + ic[1], ic[2])
        self.bu_conv24 = ConvBNAct(c2_, ic[0], 3, 2, act=act)
        self.merge_4 = csp(c1_ + ic[0] + ic[2], ic[1])
        self.merge_5 = csp(c2_ + ic[1], oc[0])
        self.bu_conv57 = ConvBNAct(oc[0], oc[0], 3, 2, act=act)
        self.merge_7 = csp(ic[1] + oc[0], oc[1])
        self.bu_conv46 = ConvBNAct(ic[1], ic[1], 3, 2, act=act)
        self.bu_conv76 = ConvBNAct(oc[1], oc[1], 3, 2, act=act)
        self.merge_6 = csp(ic[2] + ic[1] + oc[1], oc[2])

    def forward(self, xs):
        x2, x1, x0 = xs
        x3 = self.merge_3(torch.cat([x0, self.bu_conv13(x1)], 1))
        x4 = self.merge_4(torch.cat([x1, self.bu_conv24(x2), _upsample2(x3)], 1))
        x5 = self.merge_5(torch.cat([x2, _upsample2(x4)], 1))
        x7 = self.merge_7(torch.cat([x4, self.bu_conv57(x5)], 1))
        x6 = self.merge_6(torch.cat([x3, self.bu_conv46(x4), self.bu_conv76(x7)], 1))
        return (x5, x7, x6)
