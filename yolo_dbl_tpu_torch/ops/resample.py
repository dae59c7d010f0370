"""Spatial resampling primitives on NHWC tensors (port of yolo_dbl_tpu/ops/resample.py).

The layout at these functions is the JAX package's NHWC. The network runs
NCHW, channels_last on the card, so it reaches them through
`permute(0, 2, 3, 1)` views that cost no copy there.

The TPU one-hot/unroll/chunk sampling machinery (resample.py:137-241) is
not ported: it is a workaround for slow TPU gathers whose output equals the
gather form, and the gather form is what `sample_bilinear_pixel` computes,
through the hand kernel on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from ..kernels.sampling import sample_bilinear


def nearest_upsample(x, scale: int = 2):
    """Nearest-neighbour Nx upsample of NHWC tensors (resample.py:17)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, scale, w, scale, c)
    return x.reshape(b, h * scale, w * scale, c)


def avg_pool2(x):
    """2x2 average pool, stride 2, no padding, on NHWC (resample.py:24); an odd
    trailing row/column is dropped, as torch AvgPool2d(2) does."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2, :]
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return (x[:, :, 0, :, 0] + x[:, :, 0, :, 1] + x[:, :, 1, :, 0] + x[:, :, 1, :, 1]) * 0.25


def max_pool(x, k: int, stride: int = 1, padding: int = 0):
    """k x k max pool with symmetric padding on NHWC (resample.py:44). The
    padding is -inf, as in JAX, which F.max_pool2d also pads with; it pools
    the NCHW view of the same memory (channels_last on the card)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding).permute(0, 2, 3, 1)


def pixel_shuffle(x, r: int):
    """NHWC (B, H, W, C*r^2) → (B, H*r, W*r, C), channel-major (c, dy, dx) as
    torch.pixel_shuffle (resample.py:56)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def bilinear_upsample(x, scale: int = 2, align_corners: bool = True):
    """Bilinear NHWC upsample, torch's F.interpolate(mode='bilinear') in
    either align_corners mode (resample.py:75, which forms it as two 1-D
    interpolation matmuls)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale, mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def grid_sample_bilinear(x, coords, padding_mode: str = "border", align_corners: bool = False):
    """Bilinear grid sample of NHWC `x` (resample.py:105), either
    align_corners mode.

    coords: (B, Ho, Wo, 2) normalized xy grid in [-1, 1], or (B, Ho, Wo, 2, G)
    with one grid per contiguous channel group. Returns (B, Ho, Wo, C).
    """
    gy, gx = pixel_coords(coords, x.shape[1], x.shape[2], align_corners)
    return sample_bilinear_pixel(x, gy, gx, padding_mode,
                                 groups=coords.shape[-1] if coords.dim() == 5 else 1)


def pixel_coords(coords, h: int, w: int, align_corners: bool = False):
    """(gy, gx) pixel coordinates of a normalized xy grid on an h x w map:
    (B, Ho, Wo) each, or (B, Ho, Wo, G) for a grouped (B, Ho, Wo, 2, G)
    grid. With align_corners, -1 and 1 are the corner pixels' centres
    (resample.py:125-127)."""
    grouped = coords.dim() == 5
    cx, cy = (coords[..., 0, :], coords[..., 1, :]) if grouped else (coords[..., 0], coords[..., 1])
    if align_corners:
        return (cy + 1.0) * (h - 1) / 2.0, (cx + 1.0) * (w - 1) / 2.0
    return (cy + 1.0) * (h / 2.0) - 0.5, (cx + 1.0) * (w / 2.0) - 0.5


def linspace(start: float, stop: float, num: int, dtype=torch.float32, device=None):
    """`jnp.linspace(start, stop, num)` by JAX's formula (jax 0.9
    array_creation.py `_linspace`): step = iota / (num - 1), start · (1 -
    step) + stop · step, the last point `stop` itself. torch.linspace counts
    back from `stop` over the second half, so its points part from JAX's by
    an ulp."""
    if num == 1:
        return torch.full((1,), float(start), dtype=dtype, device=device)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), float(stop), dtype=dtype, device=device)])


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5, of |distance| (jax/_src/image/scale.py
    `_fill_keys_cubic_kernel`)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _cubic_weights(n_in: int, n_out: int, dtype=np.float32):
    """(n_in, n_out) weights of `jax.image.resize(..., "bicubic")` along one
    axis (scale.py `compute_weight_mat`, antialiased), formed in `dtype`
    (JAX's: float32, or float64 under x64): the kernel widened by in/out
    when shrinking, each column renormalized, columns whose sample falls
    outside the input zeroed."""
    inv_scale = dtype(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, dtype(1.0))
    sample = (np.arange(n_out, dtype=dtype) + dtype(0.5)) * inv_scale - dtype(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=dtype)[:, None]) / kernel_scale
    weights = _keys_cubic(dist.astype(dtype)).astype(dtype)
    total = weights.sum(0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(dtype)


def resize_bicubic(x, h: int, w: int):
    """`jax.image.resize(x, (B, h, w, C), "bicubic")` of NHWC `x`: Keys'
    cubic (a = -0.5) with JAX's edge renormalization and antialiasing, as
    two weight-matrix products. F.interpolate's bicubic is another kernel
    (a = -0.75, clamped at the edges)."""
    dtype = np.float64 if x.dtype == torch.float64 else np.float32
    mh = torch.from_numpy(_cubic_weights(x.shape[1], h, dtype)).to(x.device, x.dtype)
    mw = torch.from_numpy(_cubic_weights(x.shape[2], w, dtype)).to(x.device, x.dtype)
    return torch.einsum("bhwc,hH,wW->bHWc", x, mh, mw)


def resize_nearest(x, h: int, w: int):
    """`jax.image.resize(x, (B, h, w, C), "nearest")` of NHWC `x`: output
    pixel i reads floor((i + 0.5) · in / out), formed in float32 as JAX
    forms it (scale.py `_resize_nearest`)."""
    def index(n_in, n_out):
        pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in) \
            / np.float32(n_out)
        return torch.from_numpy(np.floor(pos).astype(np.int64)).to(x.device)

    return x.index_select(1, index(x.shape[1], h)).index_select(2, index(x.shape[2], w))


def sample_bilinear_pixel(x, gy, gx, padding_mode: str = "border", groups: int = 1):
    """Bilinear sample NHWC `x` at pixel coordinates (resample.py:244).

    gy, gx: (B, ...) or, with groups > 1, (B, ..., groups): channel group g
    (contiguous C/groups channels) is sampled at gy[..., g], gx[..., g].
    Returns (B, ..., C). Runs the K2 kernel on a CUDA tensor.
    """
    b = x.shape[0]
    out_shape = gy.shape[1:-1] if groups > 1 else gy.shape[1:]
    gy = gy.reshape(b, -1, groups).contiguous()
    gx = gx.reshape(b, -1, groups).contiguous()
    out = sample_bilinear(x.contiguous(), gy, gx, padding_mode)
    return out.reshape(b, *out_shape, x.shape[-1])
