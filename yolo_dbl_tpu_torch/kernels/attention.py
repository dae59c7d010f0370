"""Area attention (K3): wrapper, plain version, launch.

Replaces the Pallas `flash_attention` that yolo_dbl_tpu/nn/blocks.py:868-884
(`_area_attention`) calls on the TPU: its forward kernel and the dkv and dq
kernels of its custom_vjp. The kernels are in csrc/attention.cu; its notes
give the bounds and the designs. The plain version is the einsum path of
blocks.py:888-890, which the JAX package runs everywhere but on a TPU.

`area_attention(q, k, v)` takes (BB, N, H, hd) tokens and returns
softmax(q kᵀ / √hd) v in the same layout. On CUDA tensors it is a
`torch.autograd.Function` whose forward kernel also keeps the row
log-sum-exp, and whose backward runs the dq kernel (which also forms
delta = rowsum(dO ∘ O)) and then the dkv kernel. All three run their
products on the tensor cores in 3xTF32 (float32-accurate TF32 `mma.sync`).
The kernels take hd = 32 (A2C2f's heads are c_ // 32 wide, blocks.py:961)
and any strides on BB, N and H, so AAttn hands them the three views of its
packed qkv tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, launches

HEAD_DIM = 32


def _check(q, k, v, dtypes=(torch.float32,)):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one (BB, N, H, hd) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{dtypes} only; got q {q.dtype}, k {k.dtype}, v {v.dtype}")


def area_attention_plain(q, k, v):
    """Plain PyTorch version: the einsum path of blocks.py:888-890. It also
    takes float64, so a model on the CPU can serve as a float64 reference."""
    _check(q, k, v, (torch.float32, torch.float64))
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (q.shape[-1] ** -0.5)
    return torch.einsum("bhnm,bmhd->bnhd", attn.softmax(-1), v)


def area_attention_lse_plain(q, k):
    """The row log-sum-exp (BB, H, N) of the scaled scores, as the forward
    kernel keeps it for the backward."""
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (q.shape[-1] ** -0.5)
    return attn.logsumexp(-1)


def area_attention_backward_plain(q, k, v, grad):
    """Plain version of the backward: (dq, dk, dv) by autograd through
    `area_attention_plain`."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(area_attention_plain(*inputs), inputs, grad)


def _lib():
    lib = build.library("attention")
    fns = (lib.area_attention_fwd_f32, lib.area_attention_bwd_dq_f32,
           lib.area_attention_bwd_dkv_f32)
    if fns[0].argtypes is None:
        strides = [ctypes.c_longlong] * 9
        tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        for fn, n_ptrs in zip(fns, (2, 5, 5)):
            fn.argtypes = [ctypes.c_void_p] * 3 + strides + [ctypes.c_void_p] * n_ptrs + tail
            fn.restype = ctypes.c_int
        lib.area_attention_shared_bytes.argtypes = [ctypes.c_int]
        lib.area_attention_shared_bytes.restype = ctypes.c_int
    return lib


def shared_bytes():
    """{kernel: bytes of dynamic shared memory a block takes}."""
    names = ("attention_fwd_kernel", "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")
    return {name: _lib().area_attention_shared_bytes(i) for i, name in enumerate(names)}


def _check_cuda(q, k, v, *contiguous):
    """The kernels' contract; returns (device index, stream, strides)."""
    if q.device.type != "cuda":
        raise ValueError(f"the area attention kernels take CUDA tensors, got {q.device}")
    _check(q, k, v)
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the area attention kernels take head dim {HEAD_DIM}, got {q.shape[-1]}")
    tensors = (q, k, v, *contiguous)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}; the kernels need one card")
    if any(t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:-1])
           for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous head dim and 16-byte aligned rows")
    if not all(t.is_contiguous() for t in contiguous):
        raise ValueError("o, lse and the output gradient must be contiguous")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    strides = [s for t in (q, k, v) for s in t.stride()[:-1]]
    return idx, torch.cuda.current_stream(idx).cuda_stream, strides


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def area_attention_forward(q, k, v):
    """(o, lse): the forward kernel, on CUDA tensors only. o is
    (BB, N, H, hd), lse (BB, H, N)."""
    dev, stream, strides = _check_cuda(q, k, v)
    bb, n, h, hd = q.shape
    o = torch.empty((bb, n, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((bb, h, n), dtype=q.dtype, device=q.device)
    err = _lib().area_attention_fwd_f32(*_ptrs(q, k, v), *strides, *_ptrs(o, lse), bb, n, h,
                                        hd ** -0.5, dev, stream)
    build.check(err, "area_attention")
    launches["area_attention"] += 1
    return o, lse


def area_attention_backward(q, k, v, o, lse, grad):
    """(dq, dk, dv) for the output gradient `grad`: the dq kernel and then
    the dkv kernel, from the forward's o and lse, on CUDA tensors only."""
    dev, stream, strides = _check_cuda(q, k, v, o, lse, grad)
    bb, n, h, hd = q.shape
    if o.shape != q.shape or grad.shape != q.shape or lse.shape != (bb, h, n):
        raise ValueError(f"o {tuple(o.shape)}, lse {tuple(lse.shape)} or grad "
                         f"{tuple(grad.shape)} does not match q {tuple(q.shape)}")
    lib = _lib()
    dq, dk, dv = (torch.empty((bb, n, h, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty_like(lse)
    err = lib.area_attention_bwd_dq_f32(*_ptrs(q, k, v), *strides, *_ptrs(o, lse, grad, dq, delta),
                                        bb, n, h, hd ** -0.5, dev, stream)
    build.check(err, "area_attention_backward_dq")
    launches["area_attention_backward_dq"] += 1
    err = lib.area_attention_bwd_dkv_f32(*_ptrs(q, k, v), *strides,
                                         *_ptrs(lse, grad, delta, dk, dv), bb, n, h, hd ** -0.5,
                                         dev, stream)
    build.check(err, "area_attention_backward_dkv")
    launches["area_attention_backward_dkv"] += 1
    return dq, dk, dv


class AreaAttention(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernels. Saves the
    inputs, the output and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = area_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return area_attention_backward(*ctx.saved_tensors, grad.contiguous())


def area_attention(q, k, v):
    """softmax(q kᵀ / √hd) v for (BB, N, H, hd) tokens: the CUDA kernels
    (forward, and backward under autograd; float32, hd = 32) on CUDA tensors,
    the plain version on CPU tensors."""
    if q.device.type != "cuda":
        return area_attention_plain(q, k, v)
    return AreaAttention.apply(q, k, v)
