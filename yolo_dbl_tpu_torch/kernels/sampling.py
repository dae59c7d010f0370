"""Group-aware bilinear point sampler (K2): wrapper, plain version, launch.

Replaces yolo_dbl_tpu/kernels/sampling.py (`sample_bilinear_separable`,
Pallas body `_kernel`, pallas_call at :102), forward only. The kernel is
csrc/sampling.cu; its note gives the bound and the design.

`sample_bilinear(x, gy, gx)` samples NHWC `x` (B, H, W, C) at pixel
coordinates `gy`, `gx` (B, N, G): channel group g (contiguous C/G channels)
is sampled at its own coordinates, so one launch serves all of a DySample's
groups. G = 1 is the plain per-point sampler of the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, launches

PADDING_MODES = ("border", "zeros")


def _check(x, gy, gx, padding_mode):
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"padding_mode must be one of {PADDING_MODES}, got {padding_mode!r}")
    if x.dim() != 4 or gy.dim() != 3 or gy.shape != gx.shape:
        raise ValueError(f"expected x (B,H,W,C) and gy, gx (B,N,G); got {tuple(x.shape)}, "
                         f"{tuple(gy.shape)}, {tuple(gx.shape)}")
    if gy.shape[0] != x.shape[0] or x.shape[-1] % gy.shape[-1]:
        raise ValueError(f"batch or group mismatch: x {tuple(x.shape)}, coords {tuple(gy.shape)}")
    if x.dtype != torch.float32 or gy.dtype != torch.float32 or gx.dtype != torch.float32:
        raise TypeError(f"float32 only; got x {x.dtype}, gy {gy.dtype}, gx {gx.dtype}")


def sample_bilinear_plain(x, gy, gx, padding_mode: str = "border"):
    """Plain PyTorch version: the gather path of yolo_dbl_tpu/ops/resample.py
    (:278-305), applied per channel group."""
    _check(x, gy, gx, padding_mode)
    b, h, w, c = x.shape
    n, g = gy.shape[1:]
    cg = c // g
    flat = x.reshape(b, h * w, g, cg)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]

    def gather(yi, xi):
        yic = yi.clamp(0, h - 1).long()
        xic = xi.clamp(0, w - 1).long()
        idx = (yic * w + xic)[..., None].expand(b, n, g, cg)
        vals = torch.gather(flat, 1, idx)
        if padding_mode == "zeros":
            inb = ((yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1))[..., None]
            vals = torch.where(inb, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        return vals

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).reshape(b, n, c)


def _lib():
    lib = build.library("sampling")
    fn = lib.sample_bilinear_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def sample_bilinear(x, gy, gx, padding_mode: str = "border"):
    """(B, N, C) bilinear samples; the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type != "cuda":
        return sample_bilinear_plain(x, gy, gx, padding_mode)
    _check(x, gy, gx, padding_mode)
    if gy.device != x.device or gx.device != x.device:
        raise ValueError(f"x on {x.device}, gy on {gy.device}, gx on {gx.device}")
    if not (x.is_contiguous() and gy.is_contiguous() and gx.is_contiguous()):
        raise ValueError("sample_bilinear kernel needs contiguous x (NHWC), gy and gx")
    b, h, w, c = x.shape
    n, g = gy.shape[1:]
    out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    fn = _lib().sample_bilinear_f32
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    err = fn(x.data_ptr(), gy.data_ptr(), gx.data_ptr(), out.data_ptr(), b, h, w, c, n, g,
             int(padding_mode == "zeros"), dev, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sample_bilinear")
    launches["sample_bilinear"] += 1
    return out
