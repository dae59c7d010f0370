"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA card (the kernels have no CPU mode). This file
imports nothing of JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which sets up JAX for the rest of
the suite.)
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from yolo_dbl_tpu_torch import kernels
from yolo_dbl_tpu_torch.kernels import build
from yolo_dbl_tpu_torch.kernels import attention as TA
from yolo_dbl_tpu_torch.kernels import preprocess as TP
from yolo_dbl_tpu_torch.kernels import sampling as TS

TOL = 1e-5  # float32: same arithmetic, only FMA contraction differs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


def _letterbox_count(out_dtype):
    """The launch count of the letterbox kernel writing `out_dtype`."""
    return "letterbox_normalize" + ("_bf16" if out_dtype == torch.bfloat16 else "")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_hw,out_hw", [((250, 333), (256, 320)), ((100, 60), (128, 128))])
def test_letterbox_kernel_matches_plain(cuda, out_dtype, in_hw, out_hw):
    img = np.random.default_rng(7).integers(0, 256, (3, *in_hw, 3), dtype=np.uint8)
    img = torch.from_numpy(img).to(cuda)
    count = _letterbox_count(out_dtype)
    before = kernels.launches[count]
    out = TP.letterbox_normalize(img, out_hw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.launches[count] == before + 1
    ref = TP.letterbox_normalize_plain(img, out_hw, out_dtype=out_dtype)
    tol = TOL if out_dtype == torch.float32 else 4e-3  # one bf16 step at 1.0
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


# (batch, frame, canvas, scaleup, pad value): the smoke's (a third of the rows
# wholly pad); 1080p and a frame wider than 4096 px (tiles narrowed to fit a
# slot); 1x1 frames, kept and upscaled; a 1-pixel-wide frame; upscaling; odd
# top/left offsets, canvas widths not a multiple of 8 and frames whose bytes
# are not a multiple of 16 (the batch starts mid-chunk); a canvas with no pad
LETTERBOX_GEOMETRIES = [
    (8, (512, 768), (640, 640), False, 114), (2, (1080, 1920), (640, 640), False, 114),
    (1, (300, 5000), (640, 640), False, 114), (1, (1, 1), (640, 640), False, 114),
    (2, (1, 1), (64, 64), True, 114), (3, (480, 1), (640, 640), False, 114),
    (2, (100, 60), (128, 128), True, 114), (2, (320, 480), (640, 640), True, 114),
    (2, (251, 333), (257, 330), False, 114), (2, (101, 77), (131, 133), False, 0),
    (2, (37, 91), (63, 45), True, 255), (1, (640, 640), (640, 640), False, 114)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,in_hw,out_hw,scaleup,pad", LETTERBOX_GEOMETRIES)
def test_letterbox_kernel_geometries(cuda, out_dtype, b, in_hw, out_hw, scaleup, pad):
    """The kernel against the plain version, one launch a call; the frames
    are a slice of a larger batch, so they start where the previous frame
    ends, not at an allocation."""
    img = np.random.default_rng(9).integers(0, 256, (b + 1, *in_hw, 3), dtype=np.uint8)
    img = torch.from_numpy(img).to(cuda)[1:]
    count = _letterbox_count(out_dtype)
    before = kernels.launches[count]
    out = TP.letterbox_normalize(img, out_hw, pad, scaleup, out_dtype)
    torch.cuda.synchronize()
    assert kernels.launches[count] == before + 1
    assert out.shape == (b, *out_hw, 3) and out.dtype == out_dtype
    ref = TP.letterbox_normalize_plain(img, out_hw, pad, scaleup, out_dtype)
    tol = TOL if out_dtype == torch.float32 else 4e-3  # one bf16 step at 1.0
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


def _coords(rng, b, n, h, w, g):
    gy = rng.uniform(-1.5, h + 0.5, (b, n, g)).astype(np.float32)
    gx = rng.uniform(-1.5, w + 0.5, (b, n, g)).astype(np.float32)
    return gy, gx


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("c,g", [(64, 4), (6, 2)])
def test_sample_bilinear_kernel_matches_plain(cuda, padding_mode, c, g):
    """(64, 4) takes the float4 path, (6, 2) the scalar one."""
    rng = np.random.default_rng(8)
    b, h, w, n = 2, 20, 13, 777
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda)
    gy, gx = (torch.from_numpy(a).to(cuda) for a in _coords(rng, b, n, h, w, g))
    before = kernels.launches["sample_bilinear"]
    out = TS.sample_bilinear(x, gy, gx, padding_mode)
    torch.cuda.synchronize()
    assert kernels.launches["sample_bilinear"] == before + 1
    ref = TS.sample_bilinear_plain(x, gy, gx, padding_mode)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("c,g", [(64, 4), (6, 2), (512, 2)])
def test_sample_bilinear_backward_kernel_matches_plain(cuda, padding_mode, c, g):
    """(64, 4): float4, 16 lanes a point; (6, 2): scalar; (512, 2): 32 lanes
    looping over 256 channels. dx sums atomics in any order: 1e-4."""
    rng = np.random.default_rng(9)
    b, h, w, n = 2, 9, 11, 4 * 9 * 11
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda)
    gy, gx = (torch.from_numpy(a).to(cuda) for a in _coords(rng, b, n, h, w, g))
    grad = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(cuda)
    before = kernels.launches["sample_bilinear_backward"]
    got = TS.sample_bilinear_backward(x, gy, gx, grad, padding_mode)
    torch.cuda.synchronize()
    assert kernels.launches["sample_bilinear_backward"] == before + 1
    want = TS.sample_bilinear_backward_plain(x, gy, gx, grad, padding_mode)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)


def _assert_backward_matches_plain(got, x, gy, gx, grad, padding_mode):
    """dx within 1e-4 (atomics add in any order), dgy and dgx within 1e-4
    of their largest."""
    want = TS.sample_bilinear_backward_plain(x, gy, gx, grad, padding_mode)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    for a, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, r, atol=1e-4 * float(r.abs().max()), rtol=0)


def _site_coords(rng, b, h, w, g, uniform):
    """The coordinates chip_smoke.py gives a DySample site's (B, 4 h w, G)
    points: DySample's (each point of the 2x output near its source
    position, offsets of 0.75 pixel) or uniform over the image and a margin."""
    n = 4 * h * w
    if uniform:
        return (rng.uniform(0, 1, (b, n, g)) * (s + 2) - 1.5 for s in (h, w))
    oy, ox = ((np.arange(2 * s) + 0.5) / 2 - 0.5 for s in (h, w))
    gy, gx = np.meshgrid(oy, ox, indexing="ij")
    return (grid.reshape(1, -1, 1) + rng.standard_normal((b, n, g)) * 0.75 for grid in (gy, gx))


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("coords", ["dysample", "uniform"])
def test_sample_bilinear_backward_window_and_global_fallback(cuda, padding_mode, coords):
    """Row 13's site (40x40, 256 channels in 4 groups) at the smoke's two
    coordinate sets. A block sums its taps over a window of dx (at most 256
    of the 1,600 pixels); DySample's taps nearly all land there, uniform ones
    mostly miss it and take the global atomics. The kernel's own count of
    misses shows which path ran; both give autograd's gradients through the
    plain version."""
    rng = np.random.default_rng(16)
    b, h, w, c, g = 2, 40, 40, 256, 4
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda)
    gy, gx = (torch.from_numpy(a.astype(np.float32)).to(cuda)
              for a in _site_coords(rng, b, h, w, g, coords == "uniform"))
    grad = torch.from_numpy(rng.standard_normal((b, 4 * h * w, c)).astype(np.float32)).to(cuda)
    before = kernels.launches["sample_bilinear_backward"]
    got = TS.sample_bilinear_backward(x, gy, gx, grad, padding_mode)
    taps, missed = TS.backward_window_misses(x, gy, gx, grad, padding_mode)
    torch.cuda.synchronize()
    assert kernels.launches["sample_bilinear_backward"] == before + 2
    assert taps > 0
    assert missed < 0.05 * taps if coords == "dysample" else missed > 0.5 * taps, (taps, missed)
    _assert_backward_matches_plain(got, x, gy, gx, grad, padding_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_bilinear_backward_on_window_and_tile_edges(cuda, padding_mode):
    """Points on the edges of the kernel's blocks, which take tiles of
    4096 / (C/G) consecutive points (32 here) and a window of at most 256
    pixels. N = 4 x 23 x 29 = 2,668 is 83 tiles and a ragged 12. Offsets are
    whole and half pixels (taps of weight 0 and 1, coincident taps), some
    points sit on the image's edges and past them, and the first and last
    point of every tile are at the image's first and last pixel: each tile's
    taps then span all 667 pixels, so its window is cut and taps fall on
    both sides of its ends."""
    rng = np.random.default_rng(17)
    b, h, w, c, g = 3, 23, 29, 256, 2
    n, tile = 4 * h * w, 4096 // (c // g)
    oy, ox = ((np.arange(2 * s) + 0.5) / 2 - 0.5 for s in (h, w))
    gy, gx = (grid.reshape(1, -1, 1) + rng.integers(-2, 3, (b, n, g)) * 0.5
              for grid in np.meshgrid(oy, ox, indexing="ij"))
    gy[:, ::tile], gx[:, ::tile] = 0.0, 0.0
    gy[:, tile - 1::tile], gx[:, tile - 1::tile] = h - 1.0, w - 1.0
    gy[:, 10::tile], gx[:, 10::tile] = -1.0, float(w)
    gy[:, 20::tile], gx[:, 20::tile] = float(h), -0.5
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda)
    gy, gx = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (gy, gx))
    grad = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(cuda)
    got = TS.sample_bilinear_backward(x, gy, gx, grad, padding_mode)
    taps, missed = TS.backward_window_misses(x, gy, gx, grad, padding_mode)
    torch.cuda.synchronize()
    assert 0 < missed < taps, (taps, missed)
    _assert_backward_matches_plain(got, x, gy, gx, grad, padding_mode)


@pytest.mark.cuda
def test_sample_bilinear_output_has_grad_fn_and_backward_runs_the_kernel(cuda):
    """The CUDA output carries autograd; its backward is the hand kernel."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32)).to(cuda)
    gy, gx = (torch.from_numpy(a).to(cuda) for a in _coords(rng, 2, 256, 8, 8, 4))
    leaves = [t.clone().requires_grad_() for t in (x, gy, gx)]
    out = TS.sample_bilinear(*leaves)
    assert out.grad_fn is not None
    before = dict(kernels.launches)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.launches["sample_bilinear_backward"] == before["sample_bilinear_backward"] + 1
    assert kernels.launches["sample_bilinear"] == before["sample_bilinear"]
    want = TS.sample_bilinear_backward_plain(x, gy, gx, 2 * TS.sample_bilinear_plain(x, gy, gx))
    for t, r in zip(leaves, want):
        torch.testing.assert_close(t.grad, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 8, device=cuda)
    c = torch.zeros(1, 5, 2, device=cuda)
    with pytest.raises(ValueError):
        TS.sample_bilinear(x.permute(0, 2, 1, 3), c, c)  # not contiguous
    with pytest.raises(ValueError):
        TS.sample_bilinear(x, c, c.cpu())
    with pytest.raises(ValueError):
        TS.sample_bilinear_backward(x, c, c, torch.zeros(1, 5, 8, device=cuda).transpose(1, 2)
                                    .contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        TP.letterbox_normalize(torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device=cuda)
                               .transpose(1, 2), (16, 16))


def _packed_qkv(rng, bb, n, h, device):
    """q, k, v as AAttn makes them: the three views of one (BB, N, H, 96) tensor."""
    qkv = torch.from_numpy(rng.standard_normal((bb, n, h, 96)).astype(np.float32)).to(device)
    return qkv, qkv.split(32, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("bb,n,h", [(2, 1, 1), (2, 4, 1), (3, 17, 2), (2, 65, 3), (3, 100, 2),
                                    (4, 400, 4), (1, 129, 8), (64, 400, 4)])
def test_area_attention_kernel_matches_plain(cuda, bb, n, h):
    """Ragged tiles and steps (N = 1, 4, 17, 65, 100, 129; 400 = 6 x 64 + 16)
    and row 6's shape at training batch 16, whose 1,792 blocks take several
    waves, on the packed views; lse against logsumexp of the scaled scores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, (q, k, v) = _packed_qkv(np.random.default_rng(11), bb, n, h, cuda)
    before = kernels.launches["area_attention"]
    o, lse = TA.area_attention_forward(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["area_attention"] == before + 1
    torch.testing.assert_close(o, TA.area_attention_plain(q, k, v), atol=TOL, rtol=0)
    torch.testing.assert_close(lse, TA.area_attention_lse_plain(q, k), atol=TOL, rtol=0)


def _backward_inputs(rng, bb, n, h, device):
    """Packed q, k, v views, the forward kernel's o and lse, and an output gradient."""
    _, (q, k, v) = _packed_qkv(rng, bb, n, h, device)
    grad = torch.from_numpy(rng.standard_normal((bb, n, h, 32)).astype(np.float32)).to(device)
    return (q, k, v, *TA.area_attention_forward(q, k, v), grad)


@pytest.mark.cuda
@pytest.mark.parametrize("bb,n,h", [(2, 1, 1), (2, 4, 1), (3, 17, 2), (2, 64, 2), (2, 65, 3),
                                    (3, 100, 2), (2, 400, 8), (64, 400, 4)])
def test_area_attention_backward_kernels_match_plain(cuda, bb, n, h):
    """dq, dk, dv within 1e-4 of each tensor's largest (3xTF32 products, sums
    in another order), on the packed views: ragged N around the 64-row tiles
    (1, 17, 64, 65; 400 = 6 x 64 + 16) and row 6's training shape, whose
    1,792 blocks take several waves. At N = 1, dq and dk are exactly 0, so
    their bar has a floor of 1e-6 of dv's largest."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, o, lse, grad = _backward_inputs(np.random.default_rng(12), bb, n, h, cuda)
    before = dict(kernels.launches)
    got = TA.area_attention_backward(q, k, v, o, lse, grad)
    torch.cuda.synchronize()
    for name in ("area_attention_backward_dq", "area_attention_backward_dkv"):
        assert kernels.launches[name] == before[name] + 1
    want = TA.area_attention_backward_plain(q, k, v, grad)
    floor = 1e-2 * float(want[2].abs().max())
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=1e-4 * max(float(r.abs().max()), floor), rtol=0)


@pytest.mark.cuda
def test_area_attention_backward_is_bitwise_repeatable(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    inputs = _backward_inputs(np.random.default_rng(14), 8, 400, 4, cuda)
    first = TA.area_attention_backward(*inputs)
    second = TA.area_attention_backward(*inputs)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _sass_functions(lib):
    """{kernel name: its SASS} of a built library, from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                     "bin", "cuobjdump")
    if not os.path.isfile(tool):
        pytest.skip("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


@pytest.mark.cuda
def test_area_attention_kernels_run_on_the_tensor_cores(cuda):
    """The forward and both backward kernels, each built for float32 and for
    bfloat16 input, run their products on the tensor cores. The float32
    kernels (the 3xTF32 template, built for float32 only: no bfloat16
    instance of it ships) issue TF32 HMMAs and no other kind; the bfloat16
    forward, dq and dkv kernels (attention_*_kernel_bf16) issue bfloat16
    m16n8k16 HMMAs (HMMA.16816.F32.BF16) and no TF32 one."""
    build.library("attention")
    functions = _sass_functions(build.library_path("attention"))
    for kernel in ("attention_fwd_kernel", "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel"):
        bodies = {name: body for name, body in functions.items() if kernel in name}
        assert len(bodies) == 2 and sum("bfloat16" in name for name in bodies) == 1, list(bodies)
        for name, sass in bodies.items():
            hmma = [ln for ln in sass.splitlines() if "HMMA" in ln]
            assert hmma, name
            if kernel + "_bf16" in name:
                assert all("HMMA.16816.F32.BF16" in ln for ln in hmma), hmma[:3]
            else:
                assert all("TF32" in ln for ln in hmma), hmma[:3]
        assert sum(kernel + "_bf16" in name for name in bodies) == 1, list(bodies)


@pytest.mark.cuda
def test_area_attention_output_has_grad_fn_and_reaches_qkv(cuda):
    """The CUDA output carries autograd, its backward runs the two backward
    kernels, and the gradient reaches the packed qkv tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, _ = _packed_qkv(np.random.default_rng(13), 2, 50, 2, cuda)
    leaf = qkv.clone().requires_grad_()
    out = TA.area_attention(*leaf.split(32, -1))
    assert out.grad_fn is not None
    before = dict(kernels.launches)
    out.square().sum().backward()
    torch.cuda.synchronize()
    for name in ("area_attention_backward_dq", "area_attention_backward_dkv"):
        assert kernels.launches[name] == before[name] + 1
    assert kernels.launches["area_attention"] == before["area_attention"]
    ref = qkv.clone().requires_grad_()
    TA.area_attention_plain(*ref.split(32, -1)).square().sum().backward()
    torch.testing.assert_close(leaf.grad, ref.grad, atol=1e-4 * float(ref.grad.abs().max()), rtol=0)


@pytest.mark.cuda
def test_area_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        TA.area_attention(q, q, q)  # head dim 16
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        TA.area_attention(q[..., ::2], q[..., ::2], q[..., ::2])  # strided head dim
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(TypeError):
        TA.area_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        TA.area_attention(q, q, q.cpu())


# ---------------------------------------------------------------- bfloat16


def _bf16_ulp(t):
    """The spacing of bfloat16 at each element of `t` (8 significant bits):
    2^(e - 8) for |t| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _assert_within_bf16_ulp(got, want, scale):
    """got and want are float32 sums of the same terms in other orders, each
    rounded once to bfloat16: they may differ by one bfloat16 step of the
    result, and near 0, where the rounding of the float32 sums' own last
    bits shows, by 1e-6 of the inputs' scale."""
    assert got.dtype == want.dtype == torch.bfloat16
    bar = _bf16_ulp(want) + 1e-6 * scale
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bar).all()), float((diff - bar).max())


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("c,g", [(64, 4), (6, 2), (256, 4), (12, 3)])
def test_sample_bilinear_bf16_kernel_matches_plain(cuda, padding_mode, c, g):
    """bfloat16 x and coordinates: taps, weights and blend in float32, each
    output rounded once; within one bfloat16 step of the plain version
    (float32 on the upcast inputs, rounded once). (64, 4) and (256, 4) take
    the 16-byte path (8 channels a thread), (6, 2) and (12, 3) the scalar
    one; one launch of the bfloat16 kernel, none of the float32 one."""
    rng = np.random.default_rng(18)
    b, h, w, n = 2, 20, 13, 777
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda).bfloat16()
    gy, gx = (torch.from_numpy(a).to(cuda).bfloat16() for a in _coords(rng, b, n, h, w, g))
    before = dict(kernels.launches)
    out = TS.sample_bilinear(x, gy, gx, padding_mode)
    torch.cuda.synchronize()
    assert kernels.launches["sample_bilinear_bf16"] == before["sample_bilinear_bf16"] + 1
    assert kernels.launches["sample_bilinear"] == before["sample_bilinear"]
    _assert_within_bf16_ulp(out, TS.sample_bilinear_plain(x, gy, gx, padding_mode),
                            float(x.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("c,g", [(64, 4), (6, 2), (512, 2)])
@pytest.mark.parametrize("coords", ["dysample", "uniform"])
def test_sample_bilinear_bf16_backward_kernel_matches_plain(cuda, padding_mode, c, g, coords):
    """bfloat16 in, bfloat16 dx, dgy and dgx out, float32 sums: dx through
    the float32 scratch and its rounding pass. Each within one bfloat16 step
    of the plain version, plus 1e-6 of the largest term's scale (g x x for
    dgy and dgx summed over a group's channels, g for dx); DySample's
    coordinates take the window path, uniform ones mostly the global
    atomics."""
    rng = np.random.default_rng(19)
    b, h, w = 2, 9, 11
    n = 4 * h * w
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda).bfloat16()
    gy, gx = (torch.from_numpy(a.astype(np.float32)).to(cuda).bfloat16()
              for a in _site_coords(rng, b, h, w, g, coords == "uniform"))
    grad = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(cuda).bfloat16()
    before = dict(kernels.launches)
    got = TS.sample_bilinear_backward(x, gy, gx, grad, padding_mode)
    torch.cuda.synchronize()
    name = "sample_bilinear_backward"
    assert kernels.launches[name + "_bf16"] == before[name + "_bf16"] + 1
    assert kernels.launches[name] == before[name]
    want = TS.sample_bilinear_backward_plain(x, gy, gx, grad, padding_mode)
    g_max, x_max = float(grad.abs().max()), float(x.abs().max())
    for a, r, scale in zip(got, want, (4 * g_max, c // g * g_max * x_max, c // g * g_max * x_max)):
        _assert_within_bf16_ulp(a, r, scale)


# (C, G, N, coordinates) of the forward kernel's cases. A block takes runs
# of FWD_THREADS / (lanes a point and group x groups) consecutive points (8
# at C/G = 64) of one image: N = 575 is not a multiple of any block's
# points, N = 5 is less than one run; "shifted" moves every point 6 rows
# down from its DySample position (most taps clip at the image's edge),
# "uniform" spreads the taps over the image and a margin. C/G = 2048 makes
# a lane loop over its group's vectors, G = 128 a thread over groups.
FORWARD_CASES = [(256, 4, 575, "dysample"), (512, 4, 575, "shifted"), (256, 4, 5, "uniform"),
                 (128, 1, 575, "uniform"), (64, 1, 5, "dysample"), (12, 3, 575, "shifted"),
                 (6, 2, 575, "uniform"), (2048, 1, 37, "uniform"), (256, 128, 37, "dysample")]


def _forward_coords(rng, b, n, h, w, g, kind):
    """(B, n, G) coordinates: the first n points of DySample's 2x grid with
    offsets of 0.75 pixel (shifted 6 rows down), or uniform."""
    if kind == "uniform":
        return _coords(rng, b, n, h, w, g)
    oy, ox = ((np.arange(2 * s) + 0.5) / 2 - 0.5 for s in (h, w))
    base = [grid.reshape(-1)[np.arange(n) % (4 * h * w)][None, :, None]
            for grid in np.meshgrid(oy, ox, indexing="ij")]
    base[0] = base[0] + (6.0 if kind == "shifted" else 0.0)
    return tuple((t + rng.standard_normal((b, n, g)) * 0.75).astype(np.float32) for t in base)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("c,g,n,kind", FORWARD_CASES)
def test_sample_bilinear_forward_kernel_cases(cuda, dtype, padding_mode, c, g, n, kind):
    """The forward kernel at the model's C/G (64, 128), at 2048, at 4 (16
    bytes in float32, one channel a lane in bfloat16) and at 3 and 2 (one
    channel a lane), G = 1 to 4 and 128, runs of points cut by N, DySample's,
    shifted and uniform coordinates: float32 within 1e-5 of the plain
    version, bfloat16 within one bfloat16 step of it; one launch of the
    type's kernel, and a second launch gives the same bits."""
    rng = np.random.default_rng(28)
    b, h, w = 2, 13, 11
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda).to(dtype)
    gy, gx = (torch.from_numpy(a).to(cuda).to(dtype)
              for a in _forward_coords(rng, b, n, h, w, g, kind))
    name = "sample_bilinear" + ("_bf16" if dtype == torch.bfloat16 else "")
    before = dict(kernels.launches)
    out = TS.sample_bilinear(x, gy, gx, padding_mode)
    again = TS.sample_bilinear(x, gy, gx, padding_mode)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before[name] + 2
    assert torch.equal(out, again)
    want = TS.sample_bilinear_plain(x, gy, gx, padding_mode)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=TOL, rtol=0)
    else:
        _assert_within_bf16_ulp(out, want, float(x.float().abs().max()))


@pytest.mark.cuda
def test_sample_bilinear_bf16_trains_through_the_kernels(cuda):
    """A bfloat16 output carries autograd; its backward is the bfloat16
    backward kernel and the gradients are bfloat16."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32)).to(cuda).bfloat16()
    gy, gx = (torch.from_numpy(a).to(cuda).bfloat16() for a in _coords(rng, 2, 256, 8, 8, 4))
    leaves = [t.clone().requires_grad_() for t in (x, gy, gx)]
    before = dict(kernels.launches)
    TS.sample_bilinear(*leaves).float().square().sum().backward()
    torch.cuda.synchronize()
    for name in ("sample_bilinear_bf16", "sample_bilinear_backward_bf16"):
        assert kernels.launches[name] == before[name] + 1
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


def _packed_qkv_bf16(rng, bb, n, h, device):
    qkv, _ = _packed_qkv(rng, bb, n, h, device)
    qkv = qkv.bfloat16()
    return qkv, qkv.split(32, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("bb,n,h", [(2, 1, 1), (3, 17, 2), (2, 65, 3), (4, 400, 4),
                                    (1, 129, 8), (64, 400, 4), (2, 800, 4)])
def test_area_attention_bf16_kernel_matches_plain(cuda, bb, n, h):
    """bfloat16 q, k, v (the packed views) and o, float32 lse: within one
    bfloat16 step of the plain version (float32 on the upcast inputs, o
    rounded once) plus 1e-6 of v's largest; lse within 1e-5. One launch of
    the bfloat16 kernel, none of the float32 one. N = 800 runs the ring of
    key tiles past the 400 of the model's sites."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, (q, k, v) = _packed_qkv_bf16(np.random.default_rng(21), bb, n, h, cuda)
    before = dict(kernels.launches)
    o, lse = TA.area_attention_forward(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["area_attention_bf16"] == before["area_attention_bf16"] + 1
    assert kernels.launches["area_attention"] == before["area_attention"]
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_within_bf16_ulp(o, TA.area_attention_plain(q, k, v), float(v.abs().max()))
    torch.testing.assert_close(lse, TA.area_attention_lse_plain(q, k), atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bb,n,h", [(2, 1, 1), (3, 17, 2), (2, 65, 3), (2, 400, 8),
                                    (64, 400, 4), (2, 800, 4)])
def test_area_attention_bf16_backward_kernels_match_plain(cuda, bb, n, h):
    """bfloat16 dO in, bfloat16 dq, dk, dv out, float32 inside (delta from
    the forward's float32 O, which its bfloat16 run writes beside o when
    asked): each within one bfloat16 step of the plain version plus 1e-6 of
    the tensor's largest (the float32 sums differ at 1e-6 of it, as in
    float32). N = 800 runs the ring of query tiles past the model's 400."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(22)
    _, (q, k, v) = _packed_qkv_bf16(rng, bb, n, h, cuda)
    grad = torch.from_numpy(rng.standard_normal((bb, n, h, 32)).astype(np.float32)).to(cuda)
    grad = grad.bfloat16()
    o, lse, o32 = TA.area_attention_forward(q, k, v, residual=True)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(torch.bfloat16), o)
    before = dict(kernels.launches)
    got = TA.area_attention_backward(q, k, v, o32, lse, grad)
    torch.cuda.synchronize()
    for name in ("area_attention_backward_dq", "area_attention_backward_dkv"):
        assert kernels.launches[name + "_bf16"] == before[name + "_bf16"] + 1
        assert kernels.launches[name] == before[name]
    want = TA.area_attention_backward_plain(q, k, v, grad)
    floor = 1e-2 * float(want[2].float().abs().max())
    for a, r in zip(got, want):
        _assert_within_bf16_ulp(a, r, max(float(r.float().abs().max()), floor))


@pytest.mark.cuda
def test_area_attention_bf16_kernels_are_bitwise_repeatable(cuda):
    """No atomics in bfloat16 either: two forward and two backward launches
    on the same inputs (row 6's shape at training batch 16) give the same
    bits."""
    rng = np.random.default_rng(27)
    _, (q, k, v) = _packed_qkv_bf16(rng, 64, 400, 4, cuda)
    grad = torch.from_numpy(rng.standard_normal((64, 400, 4, 32)).astype(np.float32)).to(cuda)
    first = TA.area_attention_forward(q, k, v, residual=True)
    second = TA.area_attention_forward(q, k, v, residual=True)
    got = TA.area_attention_backward(q, k, v, first[2], first[1], grad.bfloat16())
    again = TA.area_attention_backward(q, k, v, first[2], first[1], grad.bfloat16())
    torch.cuda.synchronize()
    for a, b in zip((*first, *got), (*second, *again)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_area_attention_bf16_trains_through_the_kernels(cuda):
    """A bfloat16 output carries autograd; its backward runs the two
    bfloat16 backward kernels and the gradient reaches the packed bfloat16
    qkv tensor."""
    qkv, _ = _packed_qkv_bf16(np.random.default_rng(23), 2, 50, 2, cuda)
    leaf = qkv.clone().requires_grad_()
    before = dict(kernels.launches)
    TA.area_attention(*leaf.split(32, -1)).float().square().sum().backward()
    torch.cuda.synchronize()
    for name in ("area_attention_bf16", "area_attention_backward_dq_bf16",
                 "area_attention_backward_dkv_bf16"):
        assert kernels.launches[name] == before[name] + 1
    assert leaf.grad.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_area_attention_without_grad_runs_the_forward_kernel_alone(cuda, dtype):
    """Serving: under no_grad (and inference_mode) the output is the forward
    kernel's o, one launch, and no float32 copy of it is made."""
    _, (q, k, v) = _packed_qkv(np.random.default_rng(26), 2, 50, 2, cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    name = "area_attention" + ("_bf16" if dtype == torch.bfloat16 else "")
    for mode in (torch.no_grad, torch.inference_mode):
        before = dict(kernels.launches)
        with mode():
            out = TA.area_attention(q, k, v)
        torch.cuda.synchronize()
        assert out.dtype == dtype and kernels.launches[name] == before[name] + 1
        assert torch.equal(out, TA.area_attention_forward(q, k, v)[0])


@pytest.mark.cuda
def test_bf16_never_reaches_a_float32_only_launch(cuda):
    """The counted backward build is float32 only, types may not be mixed,
    and float16 has no kernel: each raises, none falls back."""
    x = torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.bfloat16)
    c = torch.zeros(1, 5, 2, device=cuda, dtype=torch.bfloat16)
    g = torch.zeros(1, 5, 8, device=cuda, dtype=torch.bfloat16)
    before = dict(kernels.launches)
    with pytest.raises(TypeError):
        TS.backward_window_misses(x, c, c, g)
    with pytest.raises(TypeError):
        TS.sample_bilinear(x, c.float(), c.float())
    with pytest.raises(ValueError):
        TS.sample_bilinear_backward(x, c, c, g.float())
    with pytest.raises(TypeError):
        TS.sample_bilinear(x.half(), c.half(), c.half())
    _, (q, k, v) = _packed_qkv_bf16(np.random.default_rng(24), 1, 8, 2, cuda)
    o, lse, o32 = TA.area_attention_forward(q, k, v, residual=True)
    with pytest.raises(TypeError):
        TA.area_attention_backward(q, k, v, o, lse, o)  # o must be the float32 copy
    with pytest.raises(TypeError):
        TA.area_attention_backward(q, k, v, o32, lse, o32)
    with pytest.raises(TypeError):
        TA.area_attention(q.half(), k.half(), v.half())
    after = dict(kernels.launches)
    after["area_attention_bf16"] -= 1
    assert after == before


@pytest.mark.cuda
def test_letterbox_bf16_output_is_the_float32_output_rounded_once(cuda):
    """K1 writing bfloat16 gives its own float32 values rounded once, bit for
    bit: the bits flax's first bfloat16 layer makes of JAX's float32 canvas."""
    img = np.random.default_rng(25).integers(0, 256, (2, 251, 333, 3), dtype=np.uint8)
    img = torch.from_numpy(img).to(cuda)
    f32 = TP.letterbox_normalize(img, (256, 320))
    bf16 = TP.letterbox_normalize(img, (256, 320), out_dtype=torch.bfloat16)
    assert torch.equal(bf16, f32.to(torch.bfloat16))


@pytest.mark.cuda
def test_yolov8n_card_decode_matches_cpu(cuda):
    """yolov8n (C2f, SPPF, the legacy Detect) at 64 px: the card's decode
    against the CPU's at the same weights, TF32 off: boxes < 0.05 px, scores
    <= 1e-3 (the repo's fidelity bar). No hand kernel runs on this model."""
    from yolo_dbl_tpu_torch import DetectionModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = DetectionModel("yolov8n.yaml", nc=3, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    gpu = DetectionModel("yolov8n.yaml", nc=3, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    kernels.reset_launches()
    pred_g = gpu.predict(x.to(cuda)).cpu()
    pred_c = cpu.predict(x)
    assert pred_g.shape == pred_c.shape == (2, 7, 84) and bool(torch.isfinite(pred_g).all())
    assert float((pred_g[:, :4] - pred_c[:, :4]).abs().max()) < 0.05
    assert float((pred_g[:, 4:] - pred_c[:, 4:]).abs().max()) <= 1e-3
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


@pytest.mark.cuda
def test_yolo_predict_on_card_matches_cpu(cuda, tmp_path):
    """`YOLO.predict` on a directory of JPEG frames of two sizes (two
    buckets, K1 once each, the K2 forward 3 times each) on the card against
    the CPU at the same weights, TF32 off: equal kept counts, boxes within
    0.05 px, scores within 1e-3."""
    from yolo_dbl_tpu_torch.engine.model import YOLO

    from tests.torch_fixtures import write_jpeg_frames

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    write_jpeg_frames(tmp_path, ((96, 160), (120, 100)), 4, seed=3)
    cpu = YOLO("yolov13n_DBL.yaml", nc=3, device="cpu")
    gpu = YOLO("yolov13n_DBL.yaml", nc=3, device=cuda)
    gpu.model.load_state_dict(cpu.model.state_dict())
    kernels.reset_launches()
    got = gpu.predict(tmp_path, imgsz=128, conf=0.001)
    launches = dict(kernels.launches)
    want = cpu.predict(tmp_path, imgsz=128, conf=0.001)
    assert launches["letterbox_normalize"] == 2 and launches["sample_bilinear"] == 6
    assert [len(r) for r in got] == [len(r) for r in want] and sum(map(len, want)) > 0
    for g, w in zip(got, want):
        assert g.path == w.path and g.orig_shape == w.orig_shape
        assert np.abs(g.boxes.xyxy - w.boxes.xyxy).max(initial=0) < 0.05
        assert np.abs(g.boxes.conf - w.boxes.conf).max(initial=0) <= 1e-3
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)


@pytest.mark.cuda
@pytest.mark.compileheavy
def test_shapes_convergence_map50_on_card(cuda, tmp_path):
    """tests/test_convergence.py's run through the port's facade on the card:
    yolov8n from random init on the shapes set (32 train, 16 val images at
    160 px) reaches val mAP50 >= 0.8 within 60 epochs. The JAX package's run
    of record crossed 0.8 at epoch 19 (runs/convergence_r5/results.csv)."""
    from yolo_dbl_tpu_torch.engine.model import YOLO

    from tests.fixtures import make_shapes_dataset

    data = make_shapes_dataset(tmp_path / "ds", n_train=32, n_val=16, imgsz=160, seed=0,
                               max_objects=3)
    epochs = 60
    out = YOLO("yolov8n.yaml", nc=3, device=cuda).train(
        data, epochs=epochs, batch=8, imgsz=160, lr0=0.01, patience=epochs + 1, mosaic=1.0,
        close_mosaic=epochs // 4, warmup_epochs=3.0, project=str(tmp_path / "runs"), name="conv",
        workers=0, plots=False, verbose=False)
    best50 = max(h["val_mAP50"] for h in out["history"])
    assert best50 >= 0.8, f"val mAP50 never reached 0.8 in {epochs} epochs (best {best50:.3f})"
    assert out["best_fitness"] > 0.2


# YOLO-DBL2-l's DySample sites at 640 (rows 18 and 13): (H, W, C), 4 groups,
# 256 and 128 channels a group; at 256 the backward's tile holds 16 points
DBL2_K2_SITES = [(20, 20, 1024), (40, 40, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("h,w,c", DBL2_K2_SITES)
def test_sample_bilinear_kernels_at_dbl2_sites(cuda, dtype, padding_mode, h, w, c):
    """The forward and backward kernels of `dtype` at YOLO-DBL2-l's sites
    (batch 2, DySample coordinates) against the plain versions: float32
    within 1e-5 (forward), 1e-4 (dx) and 1e-4 of the largest (dgy, dgx);
    bfloat16 within one bfloat16 step plus 1e-6 of the terms' scale."""
    rng = np.random.default_rng(27)
    b, g = 2, 4
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda).to(dtype)
    gy, gx = (torch.from_numpy(a.astype(np.float32)).to(cuda).to(dtype)
              for a in _site_coords(rng, b, h, w, g, False))
    grad = torch.from_numpy(rng.standard_normal((b, 4 * h * w, c)).astype(np.float32))
    grad = grad.to(cuda).to(dtype)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    before = dict(kernels.launches)
    out = TS.sample_bilinear(x, gy, gx, padding_mode)
    got = TS.sample_bilinear_backward(x, gy, gx, grad, padding_mode)
    torch.cuda.synchronize()
    for name in ("sample_bilinear", "sample_bilinear_backward"):
        assert kernels.launches[name + suffix] == before[name + suffix] + 1
    want_out = TS.sample_bilinear_plain(x, gy, gx, padding_mode)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, atol=TOL, rtol=0)
        _assert_backward_matches_plain(got, x, gy, gx, grad, padding_mode)
        return
    g_max, x_max, cg = float(grad.abs().max()), float(x.abs().max()), c // g
    _assert_within_bf16_ulp(out, want_out, x_max)
    want = TS.sample_bilinear_backward_plain(x, gy, gx, grad, padding_mode)
    for a, r, scale in zip(got, want, (4 * g_max, cg * g_max * x_max, cg * g_max * x_max)):
        _assert_within_bf16_ulp(a, r, scale)


# RT-DETR-l's MSDeformAttn sites at 640: the P3-P5 maps (H, W) of 256
# channels in 8 heads of 32, 300 queries x 4 points a head
MSDEFORM_SITES = [(80, 80), (40, 40), (20, 20)]


def _deform_coords(rng, b, h, w, queries=300, points=4, heads=8):
    """(gy, gx) (B, queries x points, heads) in pixels as MSDeformAttn forms
    them: reference boxes anywhere on the map with sides up to its size, and
    each point up to half a side from the centre, so that many points fall
    off the map."""
    ctr = rng.uniform(0, 1, (b, queries, 1, 1, 2))
    side = rng.uniform(0.05, 1.0, (b, queries, 1, 1, 2))
    loc = ctr + rng.uniform(-1, 1, (b, queries, heads, points, 2)) * side * 0.5
    loc = loc.transpose(0, 1, 3, 2, 4).reshape(b, queries * points, heads, 2)
    return loc[..., 1] * h - 0.5, loc[..., 0] * w - 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", MSDEFORM_SITES)
def test_sample_bilinear_kernels_at_msdeformattn_sites(cuda, dtype, h, w):
    """The forward and backward kernels of `dtype` at RT-DETR-l's
    deformable-attention sites (batch 2, zeros padding, 32 channels a
    group, points off the map) against the plain versions: float32 within
    1e-5 (forward), 1e-4 (dx) and 1e-4 of the largest (dgy, dgx); bfloat16
    within one bfloat16 step plus 1e-6 of the terms' scale."""
    rng = np.random.default_rng(29)
    b, c, g = 2, 256, 8
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda).to(dtype)
    gy, gx = (torch.from_numpy(a.astype(np.float32)).to(cuda).to(dtype)
              for a in _deform_coords(rng, b, h, w))
    off = ((gy <= -1) | (gy >= h) | (gx <= -1) | (gx >= w)).float().mean()
    assert 0.05 < float(off) < 0.5
    grad = torch.from_numpy(rng.standard_normal((b, gy.shape[1], c)).astype(np.float32))
    grad = grad.to(cuda).to(dtype)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    before = dict(kernels.launches)
    out = TS.sample_bilinear(x, gy, gx, "zeros")
    got = TS.sample_bilinear_backward(x, gy, gx, grad, "zeros")
    torch.cuda.synchronize()
    for name in ("sample_bilinear", "sample_bilinear_backward"):
        assert kernels.launches[name + suffix] == before[name + suffix] + 1
    want_out = TS.sample_bilinear_plain(x, gy, gx, "zeros")
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, atol=TOL, rtol=0)
        _assert_backward_matches_plain(got, x, gy, gx, grad, "zeros")
        return
    g_max, x_max, cg = float(grad.abs().max()), float(x.abs().max()), c // g
    _assert_within_bf16_ulp(out, want_out, x_max)
    want = TS.sample_bilinear_backward_plain(x, gy, gx, grad, "zeros")
    for a, r, scale in zip(got, want, (4 * g_max, cg * g_max * x_max, cg * g_max * x_max)):
        _assert_within_bf16_ulp(a, r, scale)


@pytest.mark.cuda
def test_dbl2_l_card_forward_matches_cpu_at_640(cuda):
    """YOLO-DBL2-l (C3Ghost, DySample at 128, 256 and 128 channels a group)
    on one 640 frame: the card's decode (K2 forward, 3 launches) against the
    CPU port's at the same weights, TF32 off: boxes < 0.05 px, scores
    <= 1e-3."""
    from yolo_dbl_tpu_torch import DetectionModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = DetectionModel("yolov13l_DBL2.yaml", nc=3, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    gpu = DetectionModel("yolov13l_DBL2.yaml", nc=3, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand((1, 640, 640, 3), generator=torch.Generator().manual_seed(2))
    kernels.reset_launches()
    pred_g = gpu.predict(x.to(cuda)).cpu()
    assert kernels.launches["sample_bilinear"] == 3
    pred_c = cpu.predict(x)
    assert pred_g.shape == pred_c.shape == (1, 7, 8400) and bool(torch.isfinite(pred_g).all())
    assert float((pred_g[:, :4] - pred_c[:, :4]).abs().max()) < 0.05
    assert float((pred_g[:, 4:] - pred_c[:, 4:]).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_dp_gloo_two_ranks_on_one_card_match_one_process(cuda, tmp_path):
    """chip_smoke.py's dp phase, part (b), at 128 px: YOLO-DBL-s (nc=3),
    global batch 4, 3 steps of Trainer(mesh=...) over a Gloo group of two
    processes on this card (2 rows each) against the one-process Trainer on
    the same weights and batches, TF32 off: loss items 1e-4 relative, the
    first step's gradient 1e-3 of each leaf's largest (float64 CPU where a
    leaf misses it by float32 order), BatchNorm statistics 1e-4, the
    parameters bit for bit equal on the ranks, and K2's forward and backward
    3 launches a step on each rank."""
    from chip_smoke import _float64_grads, train_batches
    from tests.torch_ranks import card_steps, check_dp_float32, dp_card_rank, launch
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.cfg import get_cfg

    name, steps = "yolov13s_DBL.yaml", 3
    cpu = DetectionModel(name, nc=3, device="cpu", generator=torch.Generator().manual_seed(0))
    for mod in cpu.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    batches = train_batches(np.random.default_rng(5), steps, b=4, imgsz=128)
    gpu = DetectionModel(name, nc=3, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    state_path = str(tmp_path / "state.pt")
    torch.save(cpu.state_dict(), state_path)
    try:
        one = card_steps(gpu, batches)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    del gpu
    ranks = launch(dp_card_rank, 2, name, 3, ["float32"], state_path, batches, devices="cuda:0",
                   backend="gloo", timeout=600, workdir=tmp_path)
    ranks = [r["float32"] for r in ranks]
    readings, failures = check_dp_float32(one, ranks,
                                          lambda: _float64_grads(cpu, get_cfg(), batches[0])[1])
    assert not failures, (failures, readings)
    want = {"sample_bilinear": 3 * steps, "sample_bilinear_backward": 3 * steps}
    assert one["launches"] == want and all(r["launches"] == want for r in ranks)
    assert all(len(r["allreduce_ms"]) == steps for r in ranks)


@pytest.mark.cuda
def test_tp_and_sp_gloo_two_ranks_on_one_card_match_one_process(cuda, tmp_path):
    """chip_smoke.py's tp and sp phases at 128 px: YOLO-DBL-s (nc=3) over a
    Gloo 1x2 mesh of two processes on this card. TP: 2 steps of
    Trainer(mesh=...) at global batch 4 against the one-process Trainer on
    the same weights and batches (TF32 off), at the dp phase's bars; each
    rank holds the specs' share of the parameter bytes; K2's forward and
    backward 3 launches a step on each rank. SP: 2 requests of 4 u8 frames
    through `spatial(model, mesh)`: the decode within 0.05 px and 1e-3 of
    the one-process decode, K1 once and K2 3 times a request on each rank."""
    from chip_smoke import _float64_grads, _model_bytes_share, train_batches
    from tests.torch_ranks import card_steps, check_dp_float32, dp_card_rank, launch, sp_card_rank
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.cfg import get_cfg

    name, steps, imgsz = "yolov13s_DBL.yaml", 2, 128
    cpu = DetectionModel(name, nc=3, device="cpu", generator=torch.Generator().manual_seed(0))
    for mod in cpu.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    batches = train_batches(np.random.default_rng(5), steps, b=4, imgsz=imgsz)
    state_path = str(tmp_path / "state.pt")
    torch.save(cpu.state_dict(), state_path)
    gpu = DetectionModel(name, nc=3, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    frames = np.random.default_rng(6).integers(0, 256, (4, 96, 160, 3), dtype=np.uint8)
    try:
        one = card_steps(gpu, batches)
        gpu.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            ref = gpu.eval().predict(TP.letterbox_normalize(torch.from_numpy(frames).to(cuda),
                                                            (imgsz, imgsz))).float().cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    del gpu
    ranks = launch(dp_card_rank, 2, name, 3, ["float32"], state_path, batches, devices="cuda:0",
                   backend="gloo", timeout=600, workdir=tmp_path, n_model=2)
    ranks = [r["float32"] for r in ranks]
    readings, failures = check_dp_float32(
        one, ranks, lambda: _float64_grads(cpu, get_cfg(), batches[0])[1], n_model=2)
    assert not failures, (failures, readings)
    want = {"sample_bilinear": 3 * steps, "sample_bilinear_backward": 3 * steps}
    assert one["launches"] == want and all(r["launches"] == want for r in ranks)
    share = _model_bytes_share(cpu, 2)
    assert all(abs(r["local_bytes"] / r["whole_bytes"] - share) < 1e-9 for r in ranks)
    sp = launch(sp_card_rank, 2, name, 3, state_path, frames, imgsz, 2, devices="cuda:0",
                backend="gloo", timeout=600, workdir=tmp_path, n_model=2)
    assert float((sp[0]["decode"][:, :4] - ref[:, :4]).abs().max()) < 0.05
    assert float((sp[0]["decode"][:, 4:] - ref[:, 4:]).abs().max()) <= 1e-3
    assert all(r["launches"] == {"letterbox_normalize": 2, "sample_bilinear": 6} for r in sp)


@pytest.mark.cuda
def test_kernel_launches_leave_the_current_device(cuda):
    """Each launcher sets the CUDA device of its tensors; the wrappers run it
    inside torch.cuda.device, so a launch on another card's tensors leaves
    torch's current device as it was. Needs two cards: skips with one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a launch on the current card cannot show the device kept")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)).to(other)
    TP.letterbox_normalize(frames, (64, 64))
    assert torch.cuda.current_device() == 0
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 32)).astype(np.float32)).to(other)
    gy, gx = (torch.from_numpy(a).to(other) for a in _coords(rng, 1, 64, 8, 8, 4))
    x.requires_grad_()
    TS.sample_bilinear(x, gy, gx).sum().backward()
    assert torch.cuda.current_device() == 0
    qkv, _ = _packed_qkv(rng, 2, 64, 2, other)
    qkv.requires_grad_()
    TA.area_attention(*qkv.split(32, -1)).sum().backward()
    assert torch.cuda.current_device() == 0


def _perturbed(module, seed):
    """`module` in eval mode with seeded non-trivial BatchNorm statistics and
    affine parameters (its convs keep PyTorch's seeded init)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    return module.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["ConvTranspose2d", "C2PSA"])
def test_conv_transpose_and_c2psa_on_card_match_cpu(cuda, dtype, kind):
    """yolov6's transposed conv (k 2, s 2, 256 -> 256 at n's width 64) and
    yolo11-s's C2PSA (256 channels, 2 heads of 64, 20x20 tokens) on the card
    in `dtype` against the CPU's float32 at the same weights, TF32 off:
    float32 within 1e-4 of the output's largest; bfloat16 computes in
    bfloat16 (the weights cast at the call) within 3e-2 of it (a few
    bfloat16 steps through 4-6 layers and a softmax)."""
    import copy

    from yolo_dbl_tpu_torch.nn.common import ConvTranspose2d
    from yolo_dbl_tpu_torch.nn.v9v10 import C2PSA

    torch.manual_seed(0)
    if kind == "ConvTranspose2d":
        cpu, shape = ConvTranspose2d(64, 64, 2, 2, 0), (2, 64, 20, 20)
    else:
        cpu, shape = _perturbed(C2PSA(256, 256, 1), 1), (2, 256, 20, 20)
    gpu = copy.deepcopy(cpu).to(cuda).to(memory_format=torch.channels_last)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launches()
    with torch.no_grad():
        want = cpu(x)
        got = gpu(x.to(cuda, dtype).contiguous(memory_format=torch.channels_last))
    assert got.dtype == dtype and got.shape == want.shape
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)
    err = float((got.float().cpu() - want).abs().max() / want.abs().max())
    assert err <= (1e-4 if dtype == torch.float32 else 3e-2), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_yolov12n_runs_k3_eight_times_a_forward_and_a_step(cuda, dtype):
    """YOLOv12-n at 128 px on the card: A2C2f rows 6 and 8 hold 4 ABlocks
    each (heads of 32), so a forward launches the K3 forward 8 times and a
    train step each of K3's three kernels 8 times, in `dtype`'s kernels."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.engine.trainer import Trainer

    model = DetectionModel("yolov12n.yaml", nc=80, device=cuda, dtype=dtype)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    rng = np.random.default_rng(3)
    kernels.reset_launches()
    with torch.no_grad():
        pred = model.predict(torch.rand((2, 128, 128, 3), device=cuda))
    assert pred.shape == (2, 84, 16 * 16 + 8 * 8 + 4 * 4) and bool(torch.isfinite(pred).all())
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0), "area_attention" + suffix: 8}
    trainer = Trainer(model, {"batch": 2, "imgsz": 128}).setup(10)
    batch = dict(img=rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
                 gt_boxes=np.tile(np.array([[0.5, 0.5, 0.3, 0.2]], np.float32), (2, 4, 1)),
                 gt_cls=rng.integers(0, 80, (2, 4)).astype(np.int32),
                 gt_mask=np.ones((2, 4), np.float32))
    kernels.reset_launches()
    metrics = trainer.step(batch)
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0),
                                **{k + suffix: 8 for k in ("area_attention",
                                                           "area_attention_backward_dq",
                                                           "area_attention_backward_dkv")}}


# the module catalogue (utils/benchmarks.py): DAttention's K2 sites and every entry card
# against CPU
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 64, 64, 64), (2, 32, 48, 64)])
def test_sample_bilinear_kernels_at_dattention_sites(cuda, shape):
    """K2 forward and backward at the catalogue's DeBiAttention_YOLO's
    DAttention sites (seed 0's weights; two groups of 32 channels, the
    stride-2 grid's points from its offset network, clipped, border
    padding) against the plain versions: forward within TOL, dx within
    1e-4, the coordinate gradients within 1e-4 of their largest."""
    from chip_smoke import dattention_sites

    (x, gy, gx), = dattention_sites(cuda, {"site": shape}).values()
    b, h, w, c = shape
    assert gy.shape == (b, (h // 2) * (w // 2), 2)
    assert float(gy.min()) >= -0.5 and float(gy.max()) <= h - 0.5
    kernels.reset_launches()
    got = TS.sample_bilinear(x, gy, gx, "border")
    assert kernels.launches["sample_bilinear"] == 1
    assert float((got - TS.sample_bilinear_plain(x, gy, gx, "border")).abs().max()) <= TOL
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    dx, dgy, dgx = TS.sample_bilinear_backward(x, gy, gx, grad, "border")
    want = TS.sample_bilinear_backward_plain(x, gy, gx, grad, "border")
    assert float((dx - want[0]).abs().max()) <= 1e-4
    for a, r in zip((dgy, dgx), want[1:]):
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.cuda
def test_dattention_trains_through_the_kernels(cuda):
    """DAT (two DAttention layers) forward and backward on the card: K2's
    forward and backward twice each, and the input's and every parameter's
    gradient within 1e-4 of its largest of the CPU's (TF32 off), plus 1e-7
    of the largest of all: the keys' bias has an exact gradient of 0
    (softmax ignores a shift common to a query's scores), which float32
    leaves at ~4e-9 of the largest on the CPU."""
    import copy

    from yolo_dbl_tpu_torch.nn.attention.bigarch import DAT
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    cpu = bm.prepare(DAT(32, num_heads=4), "cpu").train()
    gpu = copy.deepcopy(cpu).to(cuda).to(memory_format=torch.channels_last)
    x = bm.reference_input((2, 24, 24, 32), "cpu")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    xc, xg = x.clone().requires_grad_(), x.to(cuda).requires_grad_()
    cpu(xc).square().sum().backward()
    kernels.reset_launches()
    gpu(xg).square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0), "sample_bilinear": 2,
                                "sample_bilinear_backward": 2}
    pairs = [("x", xg.grad, xc.grad)] + [(n, p.grad, dict(cpu.named_parameters())[n].grad)
                                        for n, p in gpu.named_parameters()]
    floor = 1e-7 * max(float(want.abs().max()) for _, _, want in pairs)
    for name, got, want in pairs:
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max()) + floor, name


def _catalogue_entries():
    from chip_smoke import CATALOGUE_CHECK

    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    return [("upsample", n) for n, _ in bm.upsample_catalogue()] + \
        [("attention", n) for n, _ in bm.attention_catalogue(hw=CATALOGUE_CHECK["attention"][1:3])]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name", _catalogue_entries())
def test_catalogue_entry_on_the_card_matches_the_cpu(cuda, kind, name):
    """Each of the 35 catalogue entries at chip_smoke.py's check shape, card
    against CPU at seed 0's weights (TF32 off): within 1e-4 of the CPU
    output's largest; K2's forward once a call for DySample and
    DeBiAttention_YOLO, no kernel for the others."""
    import copy

    from chip_smoke import CATALOGUE_CHECK, CATALOGUE_K2, _catalogue_module

    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    shape = CATALOGUE_CHECK[kind]
    cpu = _catalogue_module(kind, name, shape, "cpu")
    gpu = copy.deepcopy(cpu).to(cuda).to(memory_format=torch.channels_last)
    x = bm.reference_input(shape, "cpu")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launches()
    with torch.no_grad():
        want = cpu(x)
        got = gpu(x.to(cuda)).cpu()
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0),
                                **({"sample_bilinear": 1} if name in CATALOGUE_K2 else {})}
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
