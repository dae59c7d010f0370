"""Fused letterbox + normalize (K1): wrapper, plain version, geometry.

Replaces yolo_dbl_tpu/kernels/preprocess.py (`letterbox_normalize`, Pallas
body `_letterbox_kernel`, pallas_call at :144). The kernel is
csrc/preprocess.cu; its note gives the bound and the design.

Geometry is the JAX package's `letterbox_geometry` (gain, resized size and
the reference's round(d - 0.1) pad rounding), copied so the predictor's
gain/pad box rescale stays valid. The resize is cv2 INTER_LINEAR with the
half-pixel tap rule of `_bilinear_matrix` (preprocess.py:168).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build, launches

OUT_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's tile plan (csrc/preprocess.cu): a warp blends up to TILE output
# pixels of a row from two source rows staged in slots of at most SLOT_LIMIT
# bytes; a block holds WARPS warps
TILE, SLOT_LIMIT, WARPS = 128, 1024, 8


def letterbox_geometry(h_in: int, w_in: int, h_out: int, w_out: int, scaleup: bool = True):
    """Static letterbox geometry (preprocess.py:44): gain r (capped at 1 when
    scaleup=False), resized size, and the round(d - 0.1) top/left padding."""
    r = min(h_out / h_in, w_out / w_in)
    if not scaleup:
        r = min(r, 1.0)
    new_h, new_w = round(h_in * r), round(w_in * r)
    dh, dw = (h_out - new_h) / 2, (w_out - new_w) / 2
    top, left = round(dh - 0.1), round(dw - 0.1)
    return r, new_h, new_w, top, left


def _tap_rule(n_out: int, n_in: int):
    """(scale, shift) of the half-pixel rule: source coordinate s = r*scale + shift."""
    return n_in / n_out, 0.5 * n_in / n_out - 0.5


def _taps(n_out: int, n_in: int, device):
    """Two taps and the second tap's weight per output coordinate, rounded
    exactly as `_bilinear_matrix`: float64 coordinates, float32 weight."""
    scale, shift = _tap_rule(n_out, n_in)
    s = torch.arange(n_out, dtype=torch.float64, device=device) * scale + shift
    lo = torch.floor(s)
    w = (s - lo).float()
    return lo.clamp(0, n_in - 1).long(), (lo + 1).clamp(0, n_in - 1).long(), w


def _plan(w_in, new_w, h_out, w_out, batch, out_dtype, n_sm=132):
    """(tile, slot, rows_per_warp) of the kernel: the widest tile (at most
    TILE output pixels) whose source span fits a slot of SLOT_LIMIT bytes,
    kept a multiple of the pixels that fill 16 bytes of output; the slot, the
    span's bytes + 24 (alignment and the last pixel's 3-word read) rounded
    up to 16; and rows per warp, halved from 8 while the grid has fewer than
    8 blocks an SM (blocks run 4 at a time on an SM; more, shorter blocks
    even out the SMs' shares).

    A tile of t output columns reads at most floor((t - 1) * W / new_w) + 3
    source pixels of a row; one more covers float64 rounding of the taps."""
    scale = w_in / new_w
    span_px = (SLOT_LIMIT - 24) // 3 - 4  # the largest floor((t - 1) * scale) a slot holds
    tile = min(TILE, int(span_px / scale) + 1)
    quantum = 4 if out_dtype == torch.float32 else 8  # pixels of 48 bytes
    if tile >= quantum:
        tile -= tile % quantum
    slot = -(-((math.floor((tile - 1) * scale) + 4) * 3 + 24) // 16) * 16
    rows, n_tiles = 8, -(-w_out // tile)
    while rows > 1 and batch * n_tiles * -(-h_out // (WARPS * rows)) < 8 * n_sm:
        rows //= 2
    return tile, slot, rows


def _check(images_u8, out_hw, out_dtype):
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected uint8 (B, H, W, 3) frames, got {images_u8.dtype} "
                         f"{tuple(images_u8.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if len(out_hw) != 2 or min(out_hw) < 1:
        raise ValueError(f"bad out_hw {out_hw}")


def letterbox_normalize_plain(images_u8, out_hw=(640, 640), pad_value=114, scaleup=False,
                              out_dtype=torch.float32):
    """Plain PyTorch version: gather the taps, blend rows then columns, pad, /255."""
    _check(images_u8, out_hw, out_dtype)
    b, h_in, w_in, _ = images_u8.shape
    h_out, w_out = out_hw
    _, new_h, new_w, top, left = letterbox_geometry(h_in, w_in, h_out, w_out, scaleup)
    y0, y1, wy = _taps(new_h, h_in, images_u8.device)
    x0, x1, wx = _taps(new_w, w_in, images_u8.device)
    img = images_u8.float()
    wy = wy[:, None, None]
    rows = (1 - wy) * img[:, y0] + wy * img[:, y1]  # (B, new_h, W, 3)
    wx = wx[:, None]
    val = (1 - wx) * rows[:, :, x0] + wx * rows[:, :, x1]  # (B, new_h, new_w, 3)
    canvas = torch.full((b, h_out, w_out, 3), float(pad_value), device=images_u8.device)
    canvas[:, top:top + new_h, left:left + new_w] = val
    return (canvas / 255.0).to(out_dtype)


def _lib():
    lib = build.library("preprocess")
    fn = lib.letterbox_normalize_u8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_double] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.letterbox_shared_bytes.argtypes = [ctypes.c_int] * 3
        lib.letterbox_shared_bytes.restype = ctypes.c_int
    return lib


def shared_bytes(in_hw, out_hw=(640, 640), batch=1, scaleup=False, out_dtype=torch.float32):
    """Dynamic shared bytes of a kernel block for frames of in_hw."""
    _, _, new_w, _, _ = letterbox_geometry(*in_hw, *out_hw, scaleup)
    tile, slot, _ = _plan(in_hw[1], new_w, *out_hw, batch, out_dtype)
    return _lib().letterbox_shared_bytes(int(out_dtype == torch.bfloat16), tile, slot)


def letterbox_normalize(images_u8, out_hw=(640, 640), pad_value=114, scaleup=False,
                        out_dtype=torch.float32):
    """uint8 (B, H, W, 3) frames → (B, h_out, w_out, 3) in [0, 1], padded with
    pad_value/255; the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor. One source size per call."""
    if images_u8.device.type != "cuda":
        return letterbox_normalize_plain(images_u8, out_hw, pad_value, scaleup, out_dtype)
    _check(images_u8, out_hw, out_dtype)
    if not images_u8.is_contiguous():
        raise ValueError("letterbox_normalize kernel needs contiguous (B, H, W, 3) frames")
    b, h_in, w_in, _ = images_u8.shape
    h_out, w_out = out_hw
    _, new_h, new_w, top, left = letterbox_geometry(h_in, w_in, h_out, w_out, scaleup)
    sy, oy = _tap_rule(new_h, h_in)
    sx, ox = _tap_rule(new_w, w_in)
    out = torch.empty((b, h_out, w_out, 3), dtype=out_dtype, device=images_u8.device)
    dev = images_u8.device.index
    dev = dev if dev is not None else torch.cuda.current_device()
    plan = _plan(w_in, new_w, h_out, w_out, b, out_dtype,
                 torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):  # the launcher sets the device; torch's comes back after it
        err = _lib().letterbox_normalize_u8(
            images_u8.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16), b, h_in, w_in,
            h_out, w_out, new_h, new_w, top, left, sy, oy, sx, ox, float(pad_value), *plan, dev,
            torch.cuda.current_stream(dev).cuda_stream)
    count = "letterbox_normalize" if out_dtype == torch.float32 else "letterbox_normalize_bf16"
    build.check(err, count)
    launches[count] += 1
    return out


def device_normalize(img, dtype=torch.float32):
    """uint8 NHWC → [0, 1] float (preprocess.py:159); float input passes through.
    In bfloat16, x / 255 is the float32 quotient rounded once (PyTorch
    divides bfloat16 in float32): the bits of JAX's float32 /255 that flax's
    first bfloat16 layer rounds."""
    if img.dtype == torch.uint8:
        return img.to(dtype) / 255.0
    return img.to(dtype)
