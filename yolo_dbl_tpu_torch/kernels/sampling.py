"""Group-aware bilinear point sampler (K2): wrapper, plain version, launch.

Replaces yolo_dbl_tpu/kernels/sampling.py (`sample_bilinear_separable`:
Pallas body `_kernel`, pallas_call at :102, and its custom_vjp backward
`_bwd` :142). Both kernels are in csrc/sampling.cu; its notes give the
bounds and the designs.

`sample_bilinear(x, gy, gx)` samples NHWC `x` (B, H, W, C) at pixel
coordinates `gy`, `gx` (B, N, G): channel group g (contiguous C/G channels)
is sampled at its own coordinates, so one launch serves all of a DySample's
groups. G = 1 is the plain per-point sampler of the JAX package. On CUDA
tensors it is a `torch.autograd.Function` whose backward is the backward
kernel, so DySample trains on the card.

Types: float32, or bfloat16 for x, the coordinates and the output gradient
(then the output and every gradient are bfloat16 too). A bfloat16 kernel
forms the taps and weights in float32 from the bfloat16 coordinates, sums
in float32 and rounds each result once; its plain version is the float32
one on the upcast inputs, rounded once. Each type has its own kernels and
launch counts (`sample_bilinear_bf16`, `sample_bilinear_backward_bf16`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, launches

PADDING_MODES = ("border", "zeros")
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the launch count of each type's kernels: forward, backward
_COUNTS = {torch.float32: ("sample_bilinear", "sample_bilinear_backward"),
           torch.bfloat16: ("sample_bilinear_bf16", "sample_bilinear_backward_bf16")}


def _check(x, gy, gx, padding_mode, dtypes=KERNEL_DTYPES):
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"padding_mode must be one of {PADDING_MODES}, got {padding_mode!r}")
    if x.dim() != 4 or gy.dim() != 3 or gy.shape != gx.shape:
        raise ValueError(f"expected x (B,H,W,C) and gy, gx (B,N,G); got {tuple(x.shape)}, "
                         f"{tuple(gy.shape)}, {tuple(gx.shape)}")
    if gy.shape[0] != x.shape[0] or x.shape[-1] % gy.shape[-1]:
        raise ValueError(f"batch or group mismatch: x {tuple(x.shape)}, coords {tuple(gy.shape)}")
    if x.dtype not in dtypes or gy.dtype != x.dtype or gx.dtype != x.dtype:
        raise TypeError(f"{dtypes} only; got x {x.dtype}, gy {gy.dtype}, gx {gx.dtype}")


def sample_bilinear_plain(x, gy, gx, padding_mode: str = "border"):
    """Plain PyTorch version: the gather path of yolo_dbl_tpu/ops/resample.py
    (:278-305), applied per channel group. It also takes float64, so a model
    on the CPU can serve as a float64 reference for float32 runs. bfloat16
    inputs are upcast, sampled in float32 and the result rounded once."""
    _check(x, gy, gx, padding_mode, (*KERNEL_DTYPES, torch.float64))
    if x.dtype == torch.bfloat16:
        return sample_bilinear_plain(x.float(), gy.float(), gx.float(),
                                     padding_mode).to(torch.bfloat16)
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


def sample_bilinear_backward_plain(x, gy, gx, grad, padding_mode: str = "border"):
    """Plain version of the backward: (dx, dgy, dgx) by autograd through
    `sample_bilinear_plain`, for the tests and the on-card comparison (in
    bfloat16: float32 gradients of the upcast inputs, each rounded once)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, gy, gx)]
        out = sample_bilinear_plain(*inputs, padding_mode)
        return torch.autograd.grad(out, inputs, grad)


def _lib():
    lib = build.library("sampling")
    if lib.sample_bilinear_f32.argtypes is None:
        for fn in (lib.sample_bilinear_f32, lib.sample_bilinear_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        bwd = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.sample_bilinear_backward_f32.argtypes = bwd
        lib.sample_bilinear_backward_bf16.argtypes = [ctypes.c_void_p] + bwd
        lib.sample_bilinear_backward_taps_f32.argtypes = bwd + [ctypes.c_void_p]
        lib.sample_bilinear_backward_shared_bytes.argtypes = [ctypes.c_int] * 2
        for fn in (lib.sample_bilinear_f32, lib.sample_bilinear_bf16,
                   lib.sample_bilinear_backward_f32, lib.sample_bilinear_backward_bf16,
                   lib.sample_bilinear_backward_taps_f32,
                   lib.sample_bilinear_backward_shared_bytes):
            fn.restype = ctypes.c_int
    return lib


def _check_cuda(*tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}; the kernel needs one card")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the sample_bilinear kernels need contiguous x (NHWC), gy, gx and grad")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(idx).cuda_stream


def _forward_kernel(x, gy, gx, padding_mode):
    dev, stream = _check_cuda(x, gy, gx)
    b, h, w, c = x.shape
    n, g = gy.shape[1:]
    out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    lib = _lib()
    launch = lib.sample_bilinear_f32 if x.dtype == torch.float32 else lib.sample_bilinear_bf16
    with torch.cuda.device(dev):  # the launcher sets the device; torch's comes back after it
        err = launch(x.data_ptr(), gy.data_ptr(), gx.data_ptr(), out.data_ptr(), b, h, w, c, n, g,
                     int(padding_mode == "zeros"), dev, stream)
    count = _COUNTS[x.dtype][0]
    build.check(err, count)
    launches[count] += 1
    return out


def _check_grad(x, gy, gx, grad, padding_mode, dtypes=KERNEL_DTYPES):
    _check(x, gy, gx, padding_mode, dtypes)
    if grad.shape != (x.shape[0], gy.shape[1], x.shape[-1]) or grad.dtype != x.dtype:
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} does not match the output")


def _backward_kernel(x, gy, gx, grad, padding_mode, taps=None):
    dev, stream = _check_cuda(x, gy, gx, grad)
    b, h, w, c = x.shape
    n, g = gy.shape[1:]
    # the kernel adds its blocks' windows and stray taps into a zeroed float32
    # dx: dx itself, or for bfloat16 a scratch that it then rounds into dx
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dx = acc if x.dtype == torch.float32 else torch.empty_like(x)
    dgy, dgx = torch.empty_like(gy), torch.empty_like(gx)
    args = [x.data_ptr(), gy.data_ptr(), gx.data_ptr(), grad.data_ptr(), acc.data_ptr(),
            dgy.data_ptr(), dgx.data_ptr(), b, h, w, c, n, g, int(padding_mode == "zeros"), dev,
            stream]
    lib = _lib()
    with torch.cuda.device(dev):
        if taps is not None:
            err = lib.sample_bilinear_backward_taps_f32(*args, taps.data_ptr())
        elif x.dtype == torch.float32:
            err = lib.sample_bilinear_backward_f32(*args)
        else:
            err = lib.sample_bilinear_backward_bf16(*args[:5], dx.data_ptr(), *args[5:])
    count = _COUNTS[x.dtype][1]
    build.check(err, count)
    launches[count] += 1
    return dx, dgy, dgx


def sample_bilinear_backward(x, gy, gx, grad, padding_mode: str = "border"):
    """(dx, dgy, dgx) for the (B, N, C) output gradient `grad`: the backward
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_grad(x, gy, gx, grad, padding_mode)
    if x.device.type != "cuda":
        return sample_bilinear_backward_plain(x, gy, gx, grad, padding_mode)
    return _backward_kernel(x, gy, gx, grad, padding_mode)


def backward_window_misses(x, gy, gx, grad, padding_mode: str = "border"):
    """(taps, missed): how many taps one launch of the backward kernel
    scattered into dx, and how many of them fell outside their tile's window
    of dx and were added to dx one by one with global atomics. A build of
    the float32 kernel with a counter; float32 CUDA tensors only."""
    _check_grad(x, gy, gx, grad, padding_mode, (torch.float32,))
    if x.device.type != "cuda":
        raise ValueError(f"the backward kernel takes CUDA tensors, got {x.device}")
    taps = torch.zeros(2, dtype=torch.int64, device=x.device)
    _backward_kernel(x, gy, gx, grad, padding_mode, taps)
    return tuple(int(t) for t in taps.cpu())


def backward_shared_bytes(c: int, g: int) -> int:
    """Bytes of shared memory (its tile's g and the window's counting sort) a
    block of the backward kernel takes at c channels in g groups."""
    return _lib().sample_bilinear_backward_shared_bytes(c, g)


class SampleBilinear(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel. Saves the
    inputs, not the output."""

    @staticmethod
    def forward(ctx, x, gy, gx, padding_mode):
        ctx.save_for_backward(x, gy, gx)
        ctx.padding_mode = padding_mode
        return _forward_kernel(x, gy, gx, padding_mode)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, gy, gx = ctx.saved_tensors
        dx, dgy, dgx = sample_bilinear_backward(x, gy, gx, grad.contiguous(), ctx.padding_mode)
        return dx, dgy, dgx, None


def sample_bilinear(x, gy, gx, padding_mode: str = "border"):
    """(B, N, C) bilinear samples; the CUDA kernels (forward, and backward
    under autograd; float32 or bfloat16) on CUDA tensors, the plain version
    on CPU tensors."""
    if x.device.type != "cuda":
        return sample_bilinear_plain(x, gy, gx, padding_mode)
    _check(x, gy, gx, padding_mode)
    return SampleBilinear.apply(x, gy, gx, padding_mode)
