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


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_hw,out_hw", [((250, 333), (256, 320)), ((100, 60), (128, 128))])
def test_letterbox_kernel_matches_plain(cuda, out_dtype, in_hw, out_hw):
    img = np.random.default_rng(7).integers(0, 256, (3, *in_hw, 3), dtype=np.uint8)
    img = torch.from_numpy(img).to(cuda)
    before = kernels.launches["letterbox_normalize"]
    out = TP.letterbox_normalize(img, out_hw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.launches["letterbox_normalize"] == before + 1
    ref = TP.letterbox_normalize_plain(img, out_hw, out_dtype=out_dtype)
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
@pytest.mark.parametrize("bb,n,h", [(2, 4, 1), (3, 100, 2), (4, 400, 4), (1, 129, 8)])
def test_area_attention_kernel_matches_plain(cuda, bb, n, h):
    """Ragged tiles (N = 4, 100, 129) and the serving shape's N = 400, on
    the packed views; lse against logsumexp of the scaled scores."""
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
def test_area_attention_backward_kernels_run_on_the_tensor_cores(cuda):
    """Both backward kernels issue TF32 tensor-core products (HMMA ... TF32)
    and no other kind; the forward kernel none."""
    build.library("attention")
    functions = _sass_functions(build.library_path("attention"))
    for kernel, want in (("attention_bwd_dq_kernel", True), ("attention_bwd_dkv_kernel", True),
                         ("attention_fwd_kernel", False)):
        (sass,) = [body for name, body in functions.items() if kernel in name]
        hmma = [ln for ln in sass.splitlines() if "HMMA" in ln]
        assert bool(hmma) == want, (kernel, len(hmma))
        assert all("TF32" in ln for ln in hmma), hmma[:3]


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
