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


def grid_sample_bilinear(x, coords, padding_mode: str = "border"):
    """Bilinear grid sample of NHWC `x`, align_corners=False (resample.py:105).

    coords: (B, Ho, Wo, 2) normalized xy grid in [-1, 1], or (B, Ho, Wo, 2, G)
    with one grid per contiguous channel group. Returns (B, Ho, Wo, C).
    """
    gy, gx = pixel_coords(coords, x.shape[1], x.shape[2])
    return sample_bilinear_pixel(x, gy, gx, padding_mode,
                                 groups=coords.shape[-1] if coords.dim() == 5 else 1)


def pixel_coords(coords, h: int, w: int):
    """(gy, gx) pixel coordinates of a normalized xy grid on an h x w map,
    align_corners=False: (B, Ho, Wo) each, or (B, Ho, Wo, G) for a grouped
    (B, Ho, Wo, 2, G) grid."""
    grouped = coords.dim() == 5
    cx, cy = (coords[..., 0, :], coords[..., 1, :]) if grouped else (coords[..., 0], coords[..., 1])
    return (cy + 1.0) * (h / 2.0) - 0.5, (cx + 1.0) * (w / 2.0) - 0.5


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
