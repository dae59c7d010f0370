"""YOLO-World's open-vocabulary modules (port of yolo_dbl_tpu/nn/world.py).

MaxSigmoidAttnBlock and C2fAttn (text-guided attention in the neck),
ImagePoolingAttn (the text updated from pooled image features),
ContrastiveHead and BNContrastiveHead (region-text similarity), and
WorldDetect (Detect with the contrastive class branch). Images are NCHW, as
in the rest of the port; a text is (B, K, ct) embeddings, K prompts.

Module and attribute names are the flax scope names (utils/convert.py):
ImagePoolingAttn's `query_0` / `query_1` (and `key_*`, `value_*`) are a
LayerNorm (eps 1e-5) then a Dense, its `projections_{i}` raw convs with a
bias. JAX's `scale` option of MaxSigmoidAttnBlock and ImagePoolingAttn
(its `scale_p` leaf) is not ported: no config or module sets it. The text
comes in the model's compute type (nn/tasks.py casts it
once, as it casts the images), so in bfloat16 the contrastive products run
in bfloat16 too; JAX, handed a float32 text, promotes them to float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .blocks import Bottleneck
from .common import Conv, Conv2d, flax_batch_norm, layer_norm, linear


def _l2_normalized(x, dim):
    """x / max(‖x‖, 1e-12) along `dim` (world.py:150)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


class MaxSigmoidAttnBlock(nn.Module):
    """Max-sigmoid text-guided attention (world.py:42): for each head, the
    sigmoid of the largest product of a pixel's embedding with the prompts'
    guide scales a 3x3 projection of the input."""

    def __init__(self, c1, c2, nh=1, ec=128, gc=512):
        super().__init__()
        self.nh, self.hc, self.ec = nh, c2 // nh, ec
        self.gl = nn.Linear(gc, ec)
        self.ec_conv = Conv(c1, ec, 1, act=False) if c1 != ec else None
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = Conv(c1, c2, 3, 1, act=False)

    def init_own(self, generator: torch.Generator):
        self.bias.zero_()

    def forward(self, x, guide):
        b, _, h, w = x.shape
        nh, hc = self.nh, self.hc
        g = linear(self.gl, guide).reshape(b, -1, nh, hc)
        embed = x if self.ec_conv is None else self.ec_conv(x)
        embed = embed.reshape(b, nh, hc, h, w)
        aw = torch.einsum("bmchw,bkmc->bmhwk", embed, g).amax(-1)  # (B, nh, H, W)
        aw = torch.sigmoid(aw / hc ** 0.5 + self.bias.to(x.dtype)[None, :, None, None])
        y = self.proj_conv(x).reshape(b, nh, hc, h, w) * aw[:, :, None]
        return y.reshape(b, -1, h, w)


class C2fAttn(nn.Module):
    """C2f with a text-guided attention branch at the tail (world.py:76)."""

    def __init__(self, c1, c2, n=1, ec=128, nh=1, gc=512, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(c, c, shortcut, g, (3, 3), 1.0))
        self.attn = MaxSigmoidAttnBlock(c, c, nh=nh, ec=ec, gc=gc)
        self.cv2 = Conv((3 + n) * c, c2, 1)

    def forward(self, x, guide):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, 1))


class ImagePoolingAttn(nn.Module):
    """The text updated by attention over max-pooled image features
    (world.py:101): each input map projected to `ec` and pooled to k x k
    (torch's adaptive max-pool bins), the text's queries attend over those
    tokens in `nh` heads, and the projected result is added to the text.
    Returns the updated text."""

    def __init__(self, ec=256, ch=(), ct=512, nh=8, k=3):
        super().__init__()
        self.ec, self.nh, self.k = ec, nh, k
        for i, c in enumerate(ch):
            self.add_module(f"projections_{i}", nn.Conv2d(c, ec, 1))
        self.nf = len(ch)
        self.query_0, self.query_1 = nn.LayerNorm(ct, eps=1e-5), nn.Linear(ct, ec)
        self.key_0, self.key_1 = nn.LayerNorm(ec, eps=1e-5), nn.Linear(ec, ec)
        self.value_0, self.value_1 = nn.LayerNorm(ec, eps=1e-5), nn.Linear(ec, ec)
        self.proj = nn.Linear(ec, ct)

    def forward(self, xs, text):
        b, ec, nh = xs[0].shape[0], self.ec, self.nh
        hc = ec // nh
        tokens = []
        for i, x in enumerate(xs):
            conv = getattr(self, f"projections_{i}")
            p = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
            tokens.append(F.adaptive_max_pool2d(p, self.k).flatten(2).transpose(1, 2))
        t = torch.cat(tokens, 1)  # (B, nf·k², ec)
        q = linear(self.query_1, layer_norm(self.query_0, text)).reshape(b, -1, nh, hc)
        kk = linear(self.key_1, layer_norm(self.key_0, t)).reshape(b, -1, nh, hc)
        v = linear(self.value_1, layer_norm(self.value_0, t)).reshape(b, -1, nh, hc)
        aw = torch.softmax(torch.einsum("bnmc,bkmc->bmnk", q, kk) / hc ** 0.5, -1)
        out = torch.einsum("bmnk,bkmc->bnmc", aw, v).reshape(b, -1, ec)
        return linear(self.proj, out) + text


class ContrastiveHead(nn.Module):
    """Region-text similarity of l2-normalized embeddings (world.py:138):
    sim · exp(`logit_scale`) + `bias`, with logit_scale = log(1/0.07) and
    bias -10 at init."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.full((1,), -10.0))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def init_own(self, generator: torch.Generator):
        self.bias.fill_(-10.0)
        self.logit_scale.fill_(math.log(1 / 0.07))

    def forward(self, x, w):
        sim = torch.einsum("bchw,bkc->bkhw", _l2_normalized(x, 1), _l2_normalized(w, -1))
        return sim * self.logit_scale.exp().to(x.dtype) + self.bias.to(x.dtype)


class BNContrastiveHead(nn.Module):
    """The BatchNorm variant (world.py:155): the embedding through flax's own
    BatchNorm instead of l2 normalization; logit_scale -1 at init."""

    def __init__(self, embed_dims):
        super().__init__()
        self.bias = nn.Parameter(torch.full((1,), -10.0))
        self.logit_scale = nn.Parameter(torch.tensor(-1.0))
        self.norm = flax_batch_norm(embed_dims)

    def init_own(self, generator: torch.Generator):
        self.bias.fill_(-10.0)
        self.logit_scale.fill_(-1.0)

    def forward(self, x, w):
        sim = torch.einsum("bchw,bkc->bkhw", self.norm(x), _l2_normalized(w, -1))
        return sim * self.logit_scale.exp().to(x.dtype) + self.bias.to(x.dtype)


class WorldDetect(nn.Module):
    """Detect with a text-contrastive class branch (world.py:172): the box
    branch of Detect, and a class branch of two 3x3 Convs and a 1x1 conv to
    `embed` channels scored against the K prompts by a (BN)ContrastiveHead.
    Returns raw per-level NCHW maps of 4·reg_max + K channels."""

    def __init__(self, nc=80, embed=512, with_bn=False, ch=(), reg_max=16):
        super().__init__()
        self.nc, self.nl, self.reg_max = nc, len(ch), reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c1 in enumerate(ch):
            self.add_module(f"cv2_{i}_0", Conv(c1, c2, 3))
            self.add_module(f"cv2_{i}_1", Conv(c2, c2, 3))
            self.add_module(f"cv2_{i}_2", Conv2d(c2, 4 * reg_max, 1))
            self.add_module(f"cv3_{i}_0", Conv(c1, c3, 3))
            self.add_module(f"cv3_{i}_1", Conv(c3, c3, 3))
            self.add_module(f"cv3_{i}_2", Conv2d(c3, embed, 1))
            self.add_module(f"cv4_{i}", BNContrastiveHead(embed) if with_bn else ContrastiveHead())

    def forward(self, xs, text):
        outs = []
        for i, x in enumerate(xs):
            box, emb = x, x
            for j in range(3):
                box = getattr(self, f"cv2_{i}_{j}")(box)
                emb = getattr(self, f"cv3_{i}_{j}")(emb)
            outs.append(torch.cat([box, getattr(self, f"cv4_{i}")(emb, text)], 1))
        return outs
