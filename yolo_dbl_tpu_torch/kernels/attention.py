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
delta = rowsum(dO ∘ O)) and then the dkv kernel. All run their products
on the tensor cores: the float32 kernels in 3xTF32 (float32-accurate TF32
`mma.sync`), the bfloat16 kernels in bfloat16 `mma.sync` m16n8k16, P and
dS split into bfloat16 terms (dq and dkv: 3, which carry them exactly;
the forward: 2, P's leading 16 bits, within 2^-16 of each P).
The kernels take hd = 32 (A2C2f's heads are c_ // 32 wide, blocks.py:961)
and any strides on BB, N and H, so AAttn hands them the three views of its
packed qkv tensor.

Types: float32, or bfloat16 in and out (q, k, v, the output and its
gradient, dq, dk, dv), float32 inside, as the JAX flash path casts q, k and
v to float32 and its output back to their type (blocks.py:876,885); the
row log-sum-exp stays float32. A product of two bfloat16 inputs is exact
in float32; one of a float32 P or dS and an input takes one bfloat16 pass
a term of P or dS (forward 2 terms, dq and dkv 3).
The plain versions compute bfloat16 the same way: in float32 on the upcast
inputs, each result rounded once. The backward reads the forward's output
in float32, as JAX's flash backward gets it: a bfloat16 forward that
autograd will differentiate also writes a float32 copy of it. Each type
has its own kernels and launch counts (`area_attention_bf16`, ...).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, launches

HEAD_DIM = 32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# each type's kernels: (C entry point suffix, launch count suffix)
_SUFFIX = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", "_bf16")}


def _check(q, k, v, dtypes=KERNEL_DTYPES):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one (BB, N, H, hd) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{dtypes} only; got q {q.dtype}, k {k.dtype}, v {v.dtype}")


def area_attention_plain(q, k, v):
    """Plain PyTorch version: the einsum path of blocks.py:888-890. It also
    takes float64, so a model on the CPU can serve as a float64 reference.
    bfloat16 inputs are upcast, attended in float32 and the result rounded
    once, as the kernels and the JAX flash path compute them."""
    _check(q, k, v, (*KERNEL_DTYPES, torch.float64))
    if q.dtype == torch.bfloat16:
        return area_attention_plain(q.float(), k.float(), v.float()).to(torch.bfloat16)
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (q.shape[-1] ** -0.5)
    return torch.einsum("bhnm,bmhd->bnhd", attn.softmax(-1), v)


def area_attention_lse_plain(q, k):
    """The row log-sum-exp (BB, H, N) of the scaled scores, as the forward
    kernel keeps it for the backward (float32 for bfloat16 inputs)."""
    if q.dtype == torch.bfloat16:
        q, k = q.float(), k.float()
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (q.shape[-1] ** -0.5)
    return attn.logsumexp(-1)


def area_attention_backward_plain(q, k, v, grad):
    """Plain version of the backward: (dq, dk, dv) by autograd through
    `area_attention_plain` (in bfloat16: float32 gradients of the upcast
    inputs for the upcast output gradient, each rounded once)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(area_attention_plain(*inputs), inputs, grad)


def _lib():
    lib = build.library("attention")
    if lib.area_attention_fwd_f32.argtypes is None:
        strides = [ctypes.c_longlong] * 9
        tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        for suffix, _ in _SUFFIX.values():
            for kernel, n_ptrs in (("fwd", 2 + (suffix == "bf16")), ("bwd_dq", 5),
                                   ("bwd_dkv", 5)):
                fn = getattr(lib, f"area_attention_{kernel}_{suffix}")
                fn.argtypes = [ctypes.c_void_p] * 3 + strides + [ctypes.c_void_p] * n_ptrs + tail
                fn.restype = ctypes.c_int
        lib.area_attention_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.area_attention_shared_bytes.restype = ctypes.c_int
    return lib


def shared_bytes():
    """{kernel: {type: bytes of dynamic shared memory a block takes}}."""
    names = ("attention_fwd_kernel", "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")
    return {name: {"float32": _lib().area_attention_shared_bytes(i, 0),
                   "bfloat16": _lib().area_attention_shared_bytes(i, 1)}
            for i, name in enumerate(names)}


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
    if any(t.stride(-1) != 1 or t.data_ptr() % 16
           or any(s * t.element_size() % 16 for s in t.stride()[:-1]) for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous head dim and 16-byte aligned rows")
    if not all(t.is_contiguous() for t in contiguous):
        raise ValueError("o, lse and the output gradient must be contiguous")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    strides = [s for t in (q, k, v) for s in t.stride()[:-1]]
    return idx, torch.cuda.current_stream(idx).cuda_stream, strides


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def area_attention_forward(q, k, v, residual=False):
    """(o, lse): the forward kernel, on CUDA tensors only. o is
    (BB, N, H, hd) in q's type, lse (BB, H, N) float32. With `residual`,
    (o, lse, o32): o32 is o in float32 for the backward, o itself for
    float32 inputs and a second output of the kernel for bfloat16 ones: its
    O before the rounding to bfloat16 (o32.to(bfloat16) == o), within about
    2^-16 of v's largest of the float32-accurate O, since the bfloat16
    forward keeps 16 bits of P in P V (csrc/attention.cu)."""
    dev, stream, strides = _check_cuda(q, k, v)
    bb, n, h, hd = q.shape
    suffix, count = _SUFFIX[q.dtype]
    o = torch.empty((bb, n, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((bb, h, n), dtype=torch.float32, device=q.device)
    o32 = o
    outs = _ptrs(o, lse)
    if q.dtype == torch.bfloat16:
        o32 = torch.empty(o.shape, dtype=torch.float32, device=q.device) if residual else None
        outs = [o.data_ptr(), None if o32 is None else o32.data_ptr(), lse.data_ptr()]
    with torch.cuda.device(dev):  # the launcher sets the device; torch's comes back after it
        err = getattr(_lib(), f"area_attention_fwd_{suffix}")(*_ptrs(q, k, v), *strides, *outs,
                                                              bb, n, h, hd ** -0.5, dev, stream)
    build.check(err, "area_attention" + count)
    launches["area_attention" + count] += 1
    return (o, lse, o32) if residual else (o, lse)


def area_attention_backward(q, k, v, o, lse, grad):
    """(dq, dk, dv) for the output gradient `grad`: the dq kernel and then
    the dkv kernel, from the forward's float32 o (`o32` of
    `area_attention_forward(..., residual=True)`) and lse, on CUDA tensors
    only; grad and the gradients in q's type."""
    dev, stream, strides = _check_cuda(q, k, v, o, lse, grad)
    bb, n, h, hd = q.shape
    if o.shape != q.shape or grad.shape != q.shape or lse.shape != (bb, h, n):
        raise ValueError(f"o {tuple(o.shape)}, lse {tuple(lse.shape)} or grad "
                         f"{tuple(grad.shape)} does not match q {tuple(q.shape)}")
    if grad.dtype != q.dtype or o.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"grad {grad.dtype} must be q's {q.dtype}, o {o.dtype} and lse "
                        f"{lse.dtype} float32")
    lib = _lib()
    suffix, count = _SUFFIX[q.dtype]
    dq, dk, dv = (torch.empty((bb, n, h, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty_like(lse)
    with torch.cuda.device(dev):
        err = getattr(lib, f"area_attention_bwd_dq_{suffix}")(
            *_ptrs(q, k, v), *strides, *_ptrs(o, lse, grad, dq, delta), bb, n, h, hd ** -0.5, dev,
            stream)
    build.check(err, "area_attention_backward_dq" + count)
    launches["area_attention_backward_dq" + count] += 1
    with torch.cuda.device(dev):
        err = getattr(lib, f"area_attention_bwd_dkv_{suffix}")(
            *_ptrs(q, k, v), *strides, *_ptrs(lse, grad, delta, dk, dv), bb, n, h, hd ** -0.5, dev,
            stream)
    build.check(err, "area_attention_backward_dkv" + count)
    launches["area_attention_backward_dkv" + count] += 1
    return dq, dk, dv


class AreaAttention(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernels. Saves the
    inputs, the output in float32 and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        if not any(ctx.needs_input_grad):
            return area_attention_forward(q, k, v)[0]
        o, lse, o32 = area_attention_forward(q, k, v, residual=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return area_attention_backward(*ctx.saved_tensors, grad.contiguous())


def area_attention(q, k, v):
    """softmax(q kᵀ / √hd) v for (BB, N, H, hd) tokens: the CUDA kernels
    (forward, and backward under autograd; float32 or bfloat16, hd = 32) on
    CUDA tensors, the plain version on CPU tensors."""
    if q.device.type != "cuda":
        return area_attention_plain(q, k, v)
    return AreaAttention.apply(q, k, v)
