"""Token and spatial attentions of the catalogue (port of
yolo_dbl_tpu/nn/attention/spatial.py:25-332).

EfficientAttention, HiLo, FullyAttentionalBlock, NonLocalBlock2D, MHSA,
BoTAttention and EdgeAwareAttention. Modules take and return NCHW and
compute in their input's type (nn/common.py); the token math runs on the
NHWC view, as JAX writes it. JAX's attentions here are einsum and softmax
with the whole score tensor held at once, outside any Pallas call; the
port's are `torch.matmul` and softmax in the same form. At the catalogue's
reference shape (4x256x256x64) that tensor does not fit a card for MHSA,
BoTAttention and HiLo (chip_smoke.py `catalogue_score_bytes`).

Where flax and torch part:
- flax's `nn.gelu` is the tanh form (MHSA's MLP);
- MHSA's `nn.MultiHeadDotProductAttention` keeps (C, heads, hd) query, key
  and value kernels and a (heads, hd, C) `out` kernel; here they are
  nn.Linear layers of those names, bridged by the 3-D Dense rule
  (utils/convert.py), with the query scaled by 1/sqrt(hd);
- BoTAttention's `rel_height` and `rel_width` are sized to the map the
  module first sees, as flax's `init` sizes them (`size`; a YAML row's from
  DetectionModel's `imgsz`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..common import Conv2d, flax_batch_norm, layer_norm, linear


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class EfficientAttention(nn.Module):
    """Linear attention (spatial.py:25): keys softmaxed over positions,
    queries over the key width, a (heads, kc/h, vc/h) context read back."""

    def __init__(self, in_channels: int, key_channels: int = 8, head_count: int = 0,
                 value_channels: int = 0):
        super().__init__()
        self.kc, self.heads = key_channels, head_count or in_channels
        self.vc = value_channels or in_channels
        self.keys = Conv2d(in_channels, key_channels, 1)
        self.queries = Conv2d(in_channels, key_channels, 1)
        self.values = Conv2d(in_channels, self.vc, 1)
        self.reprojection = Conv2d(self.vc, in_channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        n, kc, vc, heads = h * w, self.kc, self.vc, self.heads
        keys = torch.softmax(self.keys(x).reshape(b, heads, kc // heads, n), -1)
        queries = torch.softmax(self.queries(x).reshape(b, heads, kc // heads, n), 2)
        values = self.values(x).reshape(b, heads, vc // heads, n)
        context = torch.matmul(keys, values.transpose(2, 3))  # (B, heads, hk, hv)
        out = torch.matmul(context.transpose(2, 3), queries).reshape(b, vc, h, w)
        return self.reprojection(out) + x


class HiLo(nn.Module):
    """High/low-frequency split attention (spatial.py:53): the high heads
    attend within ws x ws windows, the low heads to the ws-pooled map."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 2, alpha: float = 0.5,
                 qkv_bias: bool = False):
        super().__init__()
        self.num_heads, self.ws = num_heads, window_size
        self.head_dim = dim // num_heads
        l_heads = int(num_heads * alpha)
        h_heads = num_heads - l_heads
        if window_size == 1:
            l_heads, h_heads = num_heads, 0
        self.l_heads, self.h_heads = l_heads, h_heads
        self.l_dim, self.h_dim = l_heads * self.head_dim, h_heads * self.head_dim
        if window_size == 1:
            self.l_dim, self.h_dim = dim, 0
        if h_heads > 0:
            self.h_qkv = nn.Linear(dim, 3 * self.h_dim, bias=qkv_bias)
            self.h_proj = nn.Linear(self.h_dim, self.h_dim)
        if l_heads > 0:
            self.l_q = nn.Linear(dim, self.l_dim, bias=qkv_bias)
            self.l_kv = nn.Linear(dim, 2 * self.l_dim, bias=qkv_bias)
            self.l_proj = nn.Linear(self.l_dim, self.l_dim)

    def forward(self, x):
        b, c, h0, w0 = x.shape
        ws, hd = self.ws, self.head_dim
        scale = hd ** -0.5
        xp = F.pad(_nhwc(x), (0, 0, 0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws))
        h, w = xp.shape[1:3]
        outs = []
        if self.h_heads > 0:
            nh, hdim = self.h_heads, self.h_dim
            hg, wg = h // ws, w // ws
            xs = xp.reshape(b, hg, ws, wg, ws, c).transpose(2, 3).reshape(b, hg * wg, ws * ws, c)
            qkv = linear(self.h_qkv, xs).reshape(b, hg * wg, ws * ws, 3, nh, hd)
            q, k, v = (qkv[..., i, :, :].transpose(2, 3) for i in range(3))  # (B, G, nh, n, hd)
            attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
            o = torch.matmul(attn, v).transpose(2, 3).reshape(b, hg, wg, ws, ws, hdim)
            o = o.transpose(2, 3).reshape(b, h, w, hdim)
            outs.append(linear(self.h_proj, o))
        if self.l_heads > 0:
            nh, ldim = self.l_heads, self.l_dim
            q = linear(self.l_q, xp).reshape(b, h * w, nh, hd).transpose(1, 2)
            if ws > 1:
                xk = xp.reshape(b, h // ws, ws, w // ws, ws, c).mean((2, 4)).reshape(b, -1, c)
            else:
                xk = xp.reshape(b, -1, c)
            kv = linear(self.l_kv, xk).reshape(b, -1, 2, nh, hd)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
            attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
            o = torch.matmul(attn, v).transpose(1, 2).reshape(b, h, w, ldim)
            outs.append(linear(self.l_proj, o))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, -1)
        return _nchw(out[:, :h0, :w0])


class FullyAttentionalBlock(nn.Module):
    """Row and column channel-relation attention (spatial.py:124). The
    encodings are tiled over the batch as JAX's `jnp.tile` (and torch's
    `repeat` in the original) does: row r of the (B*W, ...) stack takes
    encoding r mod B."""

    def __init__(self, plane: int):
        super().__init__()
        self.conv1 = nn.Linear(plane, plane)
        self.conv2 = nn.Linear(plane, plane)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.conv_out = Conv2d(plane, plane, 3, p=1, bias=False)
        self.bn = flax_batch_norm(plane)

    def init_own(self, generator: torch.Generator):
        """flax's zeros for `gamma`."""
        self.gamma.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        feat_h = x.permute(0, 3, 1, 2).reshape(b * w, c, h)
        feat_w = x.permute(0, 2, 1, 3).reshape(b * h, c, w)
        enc_h = linear(self.conv1, x.mean(3).transpose(1, 2)).repeat(w, 1, 1)  # (B*W, H, C)
        enc_w = linear(self.conv2, x.mean(2).transpose(1, 2)).repeat(h, 1, 1)  # (B*H, W, C)
        rel_h = torch.softmax(torch.matmul(feat_h, enc_h), -1)  # (B*W, C, C)
        rel_w = torch.softmax(torch.matmul(feat_w, enc_w), -1)
        aug_h = torch.matmul(rel_h, feat_h).reshape(b, w, c, h).permute(0, 2, 3, 1)
        aug_w = torch.matmul(rel_w, feat_w).reshape(b, h, c, w).permute(0, 2, 1, 3)
        out = self.gamma.to(x.dtype) * (aug_h + aug_w) + x
        return F.relu(self.bn(self.conv_out(out)))


class NonLocalBlock2D(nn.Module):
    """Non-local block, embedded Gaussian, with 2x2 max-pooled keys and
    values (spatial.py:158); `w_z_bn`'s scale starts at zero."""

    def __init__(self, in_channels: int, inter_channels: int = 0, sub_sample: bool = True,
                 bn_layer: bool = True):
        super().__init__()
        ic = inter_channels or max(in_channels // 2, 1)
        self.sub_sample = sub_sample
        self.g = Conv2d(in_channels, ic, 1)
        self.theta = Conv2d(in_channels, ic, 1)
        self.phi = Conv2d(in_channels, ic, 1)
        self.w_z = Conv2d(ic, in_channels, 1)
        self.w_z_bn = flax_batch_norm(in_channels) if bn_layer else None
        if bn_layer:
            self.w_z_bn.zero_scale = True

    def forward(self, x):
        b, c, h, w = x.shape
        g, theta, phi = self.g(x), self.theta(x), self.phi(x)
        ic = g.shape[1]
        if self.sub_sample:
            g, phi = F.max_pool2d(g, 2), F.max_pool2d(phi, 2)
        f = torch.softmax(torch.matmul(theta.reshape(b, ic, h * w).transpose(1, 2),
                                       phi.reshape(b, ic, -1)), -1)  # (B, N, M)
        y = torch.matmul(f, g.reshape(b, ic, -1).transpose(1, 2))  # (B, N, ic)
        y = self.w_z(y.transpose(1, 2).reshape(b, ic, h, w))
        if self.w_z_bn is not None:
            y = self.w_z_bn(y)
        return y + x


class MultiHeadDotProductAttention(nn.Module):
    """flax's `nn.MultiHeadDotProductAttention` (no mask): `query`, `key`,
    `value` (C → heads x hd) and `out` (heads x hd → C) projections, each
    with a bias; the query scaled by 1/sqrt(hd). Self-attention on `x`, or
    `x`'s queries over the tokens `kv` (LoftUp's cross-attention)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.out = nn.Linear(c, c)

    def forward(self, x, kv=None):
        b, n, c = x.shape
        kv = x if kv is None else kv
        nh = self.num_heads
        hd = c // nh

        def heads(dense, t):
            return linear(dense, t).reshape(b, t.shape[1], nh, hd).transpose(1, 2)

        q = heads(self.query, x) / math.sqrt(hd)
        attn = torch.softmax(torch.matmul(q, heads(self.key, kv).transpose(-1, -2)), -1)
        out = torch.matmul(attn, heads(self.value, kv)).transpose(1, 2).reshape(b, n, c)
        return linear(self.out, out)


class MHSA(nn.Module):
    """ViT block on the flattened map (spatial.py:196): LN → MHA → residual,
    LN → MLP (2x, tanh GELU) → residual; a 1x1 conv first where c2 != c1.
    Dropout is 0 in every caller (JAX's default) and is not ported."""

    def __init__(self, c1: int, c2: int = 0, num_heads: int = 4, dropout: float = 0.0):
        super().__init__()
        if dropout:
            raise NotImplementedError("MHSA's dropout is not ported")
        c2 = c2 or c1
        self.proj = Conv2d(c1, c2, 1) if c2 != c1 else None
        self.ln_1 = nn.LayerNorm(c2, eps=1e-5)
        self.self_attention = MultiHeadDotProductAttention(c2, num_heads)
        self.ln_2 = nn.LayerNorm(c2, eps=1e-5)
        self.mlp_fc1 = nn.Linear(c2, 2 * c2)
        self.mlp_fc2 = nn.Linear(2 * c2, c2)

    def forward(self, x):
        if self.proj is not None:
            x = self.proj(x)
        b, c, h, w = x.shape
        tokens = _nhwc(x).reshape(b, h * w, c)
        tokens = tokens + self.self_attention(layer_norm(self.ln_1, tokens))
        z = F.gelu(linear(self.mlp_fc1, layer_norm(self.ln_2, tokens)), approximate="tanh")
        tokens = tokens + linear(self.mlp_fc2, z)
        return _nchw(tokens.reshape(b, h, w, c))


class BoTAttention(nn.Module):
    """Bottleneck-transformer attention with a learned absolute 2-D position
    term (spatial.py:235): `rel_height` (H, dh) and `rel_width` (W, dh) for
    the (H, W) map given as `size`. Without a size the parameters are
    placeholders until a forward on the meta device sizes them (the
    model's build probe); on any other device the map must be `size`."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 128, channel_adjust: bool = True,
                 size=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Conv2d(dim, 3 * inner, 1, bias=False)
        h, w = size if size is not None else (0, 0)
        self.rel_height = nn.Parameter(torch.empty(h, dim_head))
        self.rel_width = nn.Parameter(torch.empty(w, dim_head))
        self.adjust_conv = Conv2d(inner, dim, 1) if channel_adjust else None
        self.adjust_bn = flax_batch_norm(dim) if channel_adjust else None

    def init_own(self, generator: torch.Generator):
        """flax's normal(dh^-0.5) for the position tables."""
        for p in (self.rel_height, self.rel_width):
            p.normal_(0.0, self.dim_head ** -0.5, generator=generator)

    def _size_to(self, h, w):
        if (self.rel_height.shape[0], self.rel_width.shape[0]) == (h, w):
            return
        if self.rel_height.device.type != "meta":
            raise ValueError(f"BoTAttention's position tables are for a "
                             f"{self.rel_height.shape[0]}x{self.rel_width.shape[0]} map, got "
                             f"{h}x{w}")
        self.rel_height = nn.Parameter(torch.empty(h, self.dim_head, device="meta"))
        self.rel_width = nn.Parameter(torch.empty(w, self.dim_head, device="meta"))

    def forward(self, x):
        b, c, h, w = x.shape
        self._size_to(h, w)
        nh, dh = self.heads, self.dim_head
        qkv = _nhwc(self.to_qkv(x)).reshape(b, h * w, 3, nh, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, nh, N, dh)
        q = q * dh ** -0.5
        emb = (self.rel_height[:, None, :] + self.rel_width[None, :, :]).reshape(h * w, dh)
        sim = torch.matmul(q, k.transpose(-1, -2)) + torch.matmul(q, emb.to(q.dtype).t())
        out = torch.matmul(torch.softmax(sim, -1), v).transpose(1, 2).reshape(b, h, w, nh * dh)
        out = _nchw(out)
        if self.adjust_conv is not None:
            out = self.adjust_bn(self.adjust_conv(out))
        return out


class EdgeAwareAttention(nn.Module):
    """Edge-prior attention (spatial.py:296): a detached Sobel magnitude (in
    float32) drives a channel MLP, through a learned 1x1 gain, and a
    4-channel spatial gate, through another: x (1 + c) (1 + s)."""

    def __init__(self, in_channels: int, reduction: int = 16, ksize: int = 7):
        super().__init__()
        hidden = max(8, in_channels // reduction)
        self.mlp_fc1 = nn.Linear(in_channels, hidden, bias=False)
        self.mlp_fc2 = nn.Linear(hidden, in_channels, bias=False)
        self.c_gain = Conv2d(in_channels, in_channels, 1)
        self.spatial = Conv2d(4, 1, ksize, p=ksize // 2)
        self.s_gain = Conv2d(1, 1, 1)
        self.register_buffer("sobel", self.sobel_kernels(in_channels), persistent=False)

    @staticmethod
    def sobel_kernels(c, device=None):
        """(2C, 1, 3, 3) depthwise kernels: kx then ky for each channel group
        of C (spatial.py:303-304)."""
        kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=device) / 4
        ky = torch.tensor([[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]], device=device) / 4
        return torch.cat([kx.expand(c, 1, 3, 3), ky.expand(c, 1, 3, 3)])

    def init_buffers(self):
        self.sobel = self.sobel_kernels(self.c_gain.conv.in_channels, self.sobel.device)

    def forward(self, x):
        c = x.shape[1]
        xd = x.detach().float()
        gx = F.conv2d(xd, self.sobel[:c], padding=1, groups=c)
        gy = F.conv2d(xd, self.sobel[c:], padding=1, groups=c)
        g = torch.sqrt(gx * gx + gy * gy + 1e-12).to(x.dtype)
        cw = linear(self.mlp_fc2, F.relu(linear(self.mlp_fc1, g.mean((2, 3)))))
        cgate = self.c_gain(torch.sigmoid(cw)[:, :, None, None])
        s_in = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True),
                          g.mean(1, keepdim=True), g.amax(1, keepdim=True)], 1)
        s = self.s_gain(torch.sigmoid(self.spatial(s_in)))
        return x * (1 + cgate) * (1 + s)


# 3x3 edge operators: (kx, ky, divisor) (spatial.py:293)
_EDGE_KERNELS = {
    "sobel": (((1, 0, -1), (2, 0, -2), (1, 0, -1)), ((1, 2, 1), (0, 0, 0), (-1, -2, -1)), 4.0),
    "scharr": (((3, 0, -3), (10, 0, -10), (3, 0, -3)), ((3, 10, 3), (0, 0, 0), (-3, -10, -3)),
               16.0),
    "prewitt": (((1, 0, -1), (1, 0, -1), (1, 0, -1)), ((1, 1, 1), (0, 0, 0), (-1, -1, -1)), 3.0),
    "log": (((0, 1, 0), (1, -4, 1), (0, 1, 0)), ((0, 1, 0), (1, -4, 1), (0, 1, 0)), 1.0),
    "kirsch": (((-3, -3, 5), (-3, 0, 5), (-3, -3, 5)), ((-3, -3, -3), (-3, 0, -3), (5, 5, 5)),
               1.0),
    "prewitt_alt": (((1, 1, 1), (0, 0, 0), (-1, -1, -1)), ((1, 0, -1), (1, 0, -1), (1, 0, -1)),
                    1.0),
    "sobel_alt": (((1, 2, 1), (0, 0, 0), (-1, -2, -1)), ((1, 0, -1), (2, 0, -2), (1, 0, -1)),
                  1.0),
}


class EdgeAwareAttentionV2(nn.Module):
    """Multi-operator edge-prior attention (spatial.py:333): a bank of N
    learnable 3x3 edge kernels `kx`, `ky` (N, 3, 3), made zero-mean and
    unit-L1 at every call, run as one depthwise conv in float32 (output
    feature c·N + i); the Charbonnier magnitudes, mixed by a softmax gate
    over the bank's global responses, drive a channel gate and a 4-channel
    spatial gate with softplus gains alpha (per image, "scalar"; per pixel,
    "map") and beta (per channel): x (1 + alpha s) (1 + beta c)."""

    def __init__(self, in_channels, reduction=16, ksize=7,
                 kernel_bank=("sobel", "scharr", "prewitt"), charbonnier_eps=1e-3,
                 alpha_mode="scalar"):
        super().__init__()
        if alpha_mode not in ("scalar", "map"):
            raise ValueError(f"alpha_mode must be 'scalar' or 'map', got {alpha_mode!r}")
        c, n = in_channels, len(kernel_bank)
        self.kernel_bank, self.eps = tuple(kernel_bank), charbonnier_eps
        self.alpha_mode = alpha_mode
        self.kx = nn.Parameter(self._bank(0))
        self.ky = nn.Parameter(self._bank(1))
        hidden = max(8, c // reduction)
        self.gate_fc1 = nn.Linear(n, max(8, 2 * n))
        self.gate_fc2 = nn.Linear(max(8, 2 * n), n)
        self.mlp_fc1 = nn.Linear(c, hidden, bias=False)
        self.mlp_fc2 = nn.Linear(hidden, c, bias=False)
        self.spatial = Conv2d(4, 1, ksize, p=ksize // 2)
        if alpha_mode == "scalar":
            self.alpha_fc1 = nn.Linear(2, 16)
            self.alpha_fc2 = nn.Linear(16, 1)
        else:
            self.alpha_conv = Conv2d(4, 1, 1)
        self.beta_fc1 = nn.Linear(c, hidden, bias=False)
        self.beta_fc2 = nn.Linear(hidden, c, bias=False)

    def _bank(self, idx):
        """(N, 3, 3) float32: each named operator's kernel over its divisor."""
        return torch.stack([torch.tensor(_EDGE_KERNELS[name.lower()][idx], dtype=torch.float32)
                            / _EDGE_KERNELS[name.lower()][2] for name in self.kernel_bank])

    def init_own(self, generator: torch.Generator):
        self.kx.copy_(self._bank(0))
        self.ky.copy_(self._bank(1))

    def _edges(self, xf, kern):
        """(B, C, N, H, W) responses of the normalized bank to each channel."""
        b, c, h, w = xf.shape
        kern = kern - kern.mean((1, 2), keepdim=True)
        kern = kern / torch.clamp(kern.abs().sum((1, 2), keepdim=True), min=1e-6)
        n = kern.shape[0]
        weight = kern[None].expand(c, n, 3, 3).reshape(c * n, 1, 3, 3)
        return F.conv2d(xf, weight, padding=1, groups=c).reshape(b, c, n, h, w)

    def forward(self, x):
        xf = x.float()
        gx, gy = self._edges(xf, self.kx.float()), self._edges(xf, self.ky.float())
        g_bank = torch.sqrt(gx * gx + gy * gy + self.eps ** 2)  # (B, C, N, H, W)
        gw = linear(self.gate_fc1, g_bank.mean((1, 3, 4)).to(x.dtype))
        gate = torch.softmax(linear(self.gate_fc2, F.relu(gw)), -1)
        g = (g_bank * gate.to(g_bank.dtype)[:, None, :, None, None]).sum(2).to(x.dtype)
        c_vec = g.mean((2, 3))
        cgate = torch.sigmoid(linear(self.mlp_fc2, F.relu(linear(self.mlp_fc1, c_vec))))
        s_in = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True),
                          g.mean(1, keepdim=True), g.amax(1, keepdim=True)], 1)
        s = torch.sigmoid(self.spatial(s_in))
        if self.alpha_mode == "scalar":
            stats = torch.stack([g.mean((1, 2, 3)), g.amax((1, 2, 3))], 1)
            a = linear(self.alpha_fc2, F.relu(linear(self.alpha_fc1, stats)))
            alpha = F.softplus(a)[:, :, None, None]
        else:
            alpha = F.softplus(self.alpha_conv(s_in))
        beta = F.softplus(linear(self.beta_fc2, F.relu(linear(self.beta_fc1, c_vec))))
        return x * (1 + alpha * s) * (1 + beta[:, :, None, None] * cgate[:, :, None, None])
