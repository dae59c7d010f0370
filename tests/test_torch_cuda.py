"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA card (the kernels have no CPU mode). This file
imports nothing of JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which sets up JAX for the rest of
the suite.)
"""

import numpy as np
import pytest
import torch

from yolo_dbl_tpu_torch import kernels
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
