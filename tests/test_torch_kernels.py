"""The port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those plain versions to the JAX functions: the Pallas kernels in interpret
mode and their XLA twins, within 1e-5 in float32. tests/test_torch_cuda.py
holds the CUDA kernels to the plain versions on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from yolo_dbl_tpu.kernels import preprocess as JP
import jax

from yolo_dbl_tpu.kernels.sampling import _TILE_N, sample_bilinear_separable
from yolo_dbl_tpu.ops import resample as JR

from yolo_dbl_tpu_torch.kernels import preprocess as TP
from yolo_dbl_tpu_torch.kernels import sampling as TS
from yolo_dbl_tpu_torch.ops import resample as TR
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5

LETTERBOX_SHAPES = [((100, 160), (128, 128)), ((64, 64), (96, 96)), ((200, 100), (160, 160)),
                    ((480, 640), (320, 320)), ((48, 80), (64, 64))]


@pytest.mark.parametrize("scaleup", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", LETTERBOX_SHAPES)
def test_letterbox_plain_matches_jax(in_hw, out_hw, scaleup):
    img = np.random.default_rng(0).integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    pallas = np.asarray(JP.letterbox_normalize(jnp.asarray(img), out_hw, scaleup=scaleup,
                                               interpret=True))
    xla = np.asarray(JP.letterbox_normalize_xla(jnp.asarray(img), out_hw, scaleup=scaleup))
    out = TP.letterbox_normalize(torch.from_numpy(img), out_hw, scaleup=scaleup)
    assert out.dtype == torch.float32 and out.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(out.numpy(), pallas, atol=TOL)
    np.testing.assert_allclose(out.numpy(), xla, atol=TOL)


@pytest.mark.parametrize("in_hw,out_hw", [((100, 160), (128, 128)), ((480, 640), (320, 320))])
def test_letterbox_plain_matches_host_cv2_letterbox(in_hw, out_hw):
    """Same geometry as the JAX package's host cv2 letterbox (data/augment.py)
    and the same bilinear resize within cv2's uint8 rounding."""
    from yolo_dbl_tpu.data.augment import letterbox

    img = np.random.default_rng(1).integers(0, 256, (*in_hw, 3), dtype=np.uint8)
    host, gain, pad = letterbox(img, out_hw, scaleup=False)
    out = TP.letterbox_normalize(torch.from_numpy(img[None]), out_hw)[0].numpy()
    diff = np.abs(host.astype(np.float32) / 255.0 - out)
    assert np.quantile(diff, 0.999) <= 1.5 / 255, float(diff.max())
    r, _, _, top, left = TP.letterbox_geometry(*in_hw, *out_hw, scaleup=False)
    assert abs(r - gain) < 1e-9 and (left, top) == tuple(int(p) for p in pad)


def test_letterbox_geometry_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(300):
        h_in, w_in, h_out, w_out = (int(v) for v in rng.integers(1, 2000, 4))
        for scaleup in (False, True):
            assert (TP.letterbox_geometry(h_in, w_in, h_out, w_out, scaleup)
                    == JP.letterbox_geometry(h_in, w_in, h_out, w_out, scaleup))


def test_letterbox_pad_and_scaleup():
    wide = torch.full((1, 50, 100, 3), 255, dtype=torch.uint8)
    out = TP.letterbox_normalize(wide, (100, 100))
    assert torch.allclose(out[0, 0], torch.tensor(114 / 255))  # top pad
    assert torch.allclose(out[0, 50], torch.tensor(1.0))  # content row
    small = torch.full((1, 32, 32, 3), 200, dtype=torch.uint8)
    up = TP.letterbox_normalize(small, (64, 64), scaleup=True)
    noup = TP.letterbox_normalize(small, (64, 64), scaleup=False)
    assert torch.allclose(up, torch.tensor(200 / 255))
    assert torch.allclose(noup[0, 0, 0], torch.tensor(114 / 255))
    assert torch.allclose(noup[0, 32, 32], torch.tensor(200 / 255))


def test_letterbox_bf16_and_validation():
    img = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 40, 56, 3), dtype=np.uint8))
    f32 = TP.letterbox_normalize(img, (64, 64))
    bf16 = TP.letterbox_normalize(img, (64, 64), out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    with pytest.raises(ValueError):
        TP.letterbox_normalize(img.float(), (64, 64))
    with pytest.raises(TypeError):
        TP.letterbox_normalize(img, (64, 64), out_dtype=torch.float16)
    np.testing.assert_allclose(TP.device_normalize(img).numpy(),
                               np.asarray(JP.device_normalize(jnp.asarray(img.numpy()))), atol=0)


# the smoke's 512x768 -> 640x640 (resized to 427x640) and 1080p -> 640x640
# (360x640) beside the geometries of LETTERBOX_SHAPES: (n_out, n_in) per axis
TAP_AXES = sorted({(n_out, n_in)
                   for in_hw, out_hw in LETTERBOX_SHAPES + [((512, 768), (640, 640)),
                                                            ((1080, 1920), (640, 640))]
                   for scaleup in (False, True)
                   for n_out, n_in in zip(TP.letterbox_geometry(*in_hw, *out_hw, scaleup)[1:3],
                                          in_hw)})


@pytest.mark.parametrize("n_out,n_in", TAP_AXES)
def test_letterbox_taps_match_jax_bilinear_matrix(n_out, n_in):
    """The tap rule the kernel mirrors (two taps and the second's weight,
    float64 coordinates, float32 weight) is `_bilinear_matrix`'s: the same
    nonzero columns in every row and bit-equal weights."""
    x0, x1, w = (t.numpy() for t in TP._taps(n_out, n_in, "cpu"))
    m = JP._bilinear_matrix(n_out, n_in)
    rows = np.arange(n_out)
    for r in rows:
        want = {int(x0[r]), int(x1[r])} - ({int(x1[r])} if w[r] == 0 and x1[r] != x0[r] else set())
        assert set(np.flatnonzero(m[r]).tolist()) == want, r
    ours = np.zeros_like(m)
    np.add.at(ours, (rows, x0), np.float32(1.0) - w)
    np.add.at(ours, (rows, x1), w)
    assert ours.dtype == m.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), m.view(np.uint32))
    two = x1 != x0
    np.testing.assert_array_equal(m[rows[two], x1[two]].view(np.uint32), w[two].view(np.uint32))


def test_letterbox_plan_spans_fit_their_slots():
    """The kernel stages the source span of each column tile (csrc/preprocess.cu)
    in a slot of the planned bytes and reads up to 24 bytes past the span's
    start phase and end; the plan must hold every tile's span, with tiles a
    multiple of 16 bytes of output wherever they can be."""
    rng = np.random.default_rng(3)
    geos = [((512, 768), (640, 640)), ((1080, 1920), (640, 640)), ((300, 5000), (640, 640)),
            ((1, 1), (640, 640)), ((480, 1), (640, 640)), ((1, 20000), (640, 640)),
            ((2000, 3), (8, 700))]
    geos += [(tuple(int(v) for v in rng.integers(1, 9000, 2)),
              tuple(int(v) for v in rng.integers(1, 1300, 2))) for _ in range(60)]
    checked = 0
    for in_hw, out_hw in geos:
        for scaleup in (False, True):
            _, new_h, new_w, _, left = TP.letterbox_geometry(*in_hw, *out_hw, scaleup)
            if new_h == 0 or new_w == 0:
                continue
            x0, x1, _ = TP._taps(new_w, in_hw[1], "cpu")
            for dtype, quantum in ((torch.float32, 4), (torch.bfloat16, 8)):
                tile, slot, rows = TP._plan(in_hw[1], new_w, *out_hw, 4, dtype)
                assert 1 <= tile <= TP.TILE and tile % quantum == 0 or tile < quantum
                assert slot % 16 == 0 and slot <= TP.SLOT_LIMIT and rows in (1, 2, 4, 8)
                for c0 in range(0, out_hw[1], tile):
                    cl, cr = max(c0, left), min(c0 + tile, out_hw[1], left + new_w)
                    if cl < cr:
                        span = int(x1[cr - 1 - left] - x0[cl - left]) + 1
                        assert span * 3 + 24 <= slot, (in_hw, out_hw, c0, span, slot)
                        checked += 1
    assert checked > 1000


def _coords(rng, b, n, h, w, g=None):
    """Coordinates over in-bounds, border and out-of-bounds regions."""
    shape = (b, n) if g is None else (b, n, g)
    gy = rng.uniform(-1.5, h + 0.5, shape).astype(np.float32)
    gx = rng.uniform(-1.5, w + 0.5, shape).astype(np.float32)
    return gy, gx


@pytest.mark.parametrize("n", [50, _TILE_N + 7])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_bilinear_plain_matches_jax(padding_mode, n):
    """G = 1: the plain sampler == the Pallas kernel (interpret) == the gather path."""
    rng = np.random.default_rng(3)
    b, h, w, c = 3, 12, 9, 5
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gy, gx = _coords(rng, b, n, h, w)
    pallas = np.asarray(sample_bilinear_separable(jnp.asarray(x), jnp.asarray(gy), jnp.asarray(gx),
                                                  padding_mode, True))
    gather = np.asarray(JR.sample_bilinear_pixel(jnp.asarray(x), jnp.asarray(gy), jnp.asarray(gx),
                                                 padding_mode, prefer_onehot=False))
    out = TS.sample_bilinear(torch.from_numpy(x), torch.from_numpy(gy[..., None]),
                             torch.from_numpy(gx[..., None]), padding_mode).numpy()
    np.testing.assert_allclose(out, pallas, atol=TOL)
    np.testing.assert_allclose(out, gather, atol=TOL)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_bilinear_groups_match_per_group_jax(padding_mode):
    """G = 4 contiguous channel groups in one call == one JAX call per group."""
    rng = np.random.default_rng(4)
    b, h, w, c, g, n = 2, 7, 10, 16, 4, 60
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gy, gx = _coords(rng, b, n, h, w, g)
    cg = c // g
    ref = np.concatenate([
        np.asarray(JR.sample_bilinear_pixel(jnp.asarray(x[..., i * cg:(i + 1) * cg]),
                                            jnp.asarray(gy[..., i]), jnp.asarray(gx[..., i]),
                                            padding_mode, prefer_onehot=False))
        for i in range(g)], -1)
    out = TS.sample_bilinear(torch.from_numpy(x), torch.from_numpy(gy), torch.from_numpy(gx),
                             padding_mode).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("groups", [1, 4])
def test_sample_bilinear_backward_plain_matches_jax(padding_mode, groups):
    """The plain backward (autograd through the plain sampler) == JAX's
    gradient of the gather path, per group, and for G = 1 also the Pallas
    kernel's custom_vjp (interpret mode), within 1e-4 as tests/test_kernels.py."""
    rng = np.random.default_rng(9)
    b, h, w, c, n = 2, 6, 7, 8, 40
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gy, gx = _coords(rng, b, n, h, w, groups)
    gout = rng.standard_normal((b, n, c)).astype(np.float32)
    cg = c // groups

    def gather_loss(xs, ys, xs_):
        outs = [JR.sample_bilinear_pixel(xs[..., i * cg:(i + 1) * cg], ys[..., i], xs_[..., i],
                                         padding_mode, prefer_onehot=False) for i in range(groups)]
        return (jnp.concatenate(outs, -1) * gout).sum()

    refs = [jax.grad(gather_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gy), jnp.asarray(gx))]
    if groups == 1:
        def pallas_loss(xs, ys, xs_):
            return (sample_bilinear_separable(xs, ys[..., 0], xs_[..., 0], padding_mode, True)
                    * gout).sum()

        refs.append(jax.grad(pallas_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gy),
                                                                jnp.asarray(gx)))
    grads = TS.sample_bilinear_backward(torch.from_numpy(x), torch.from_numpy(gy),
                                        torch.from_numpy(gx), torch.from_numpy(gout), padding_mode)
    assert float(grads[1].abs().max()) > 0 and float(grads[2].abs().max()) > 0
    for ref in refs:
        for got, want in zip(grads, ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_sample_bilinear_validation():
    x = torch.zeros(1, 4, 4, 6)
    c = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError):
        TS.sample_bilinear(x, c, c)  # 6 channels do not split into 4 groups
    with pytest.raises(ValueError):
        TS.sample_bilinear(x, c[..., :2], c[..., :2], "reflection")
    with pytest.raises(TypeError):
        TS.sample_bilinear(x.half(), c[..., :2].half(), c[..., :2].half())
    with pytest.raises(TypeError):
        TS.sample_bilinear(x.double(), c[..., :2], c[..., :2])
    with pytest.raises(ValueError):
        TS.sample_bilinear_backward(x, c[..., :2], c[..., :2], torch.zeros(1, 3, 5))


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_bilinear_plain_float64_matches_float32(padding_mode):
    """The plain version in float64 (a reference for float32 runs on the CPU)
    agrees with float32 on values and on the gradients of all three inputs."""
    rng = np.random.default_rng(11)
    b, h, w, c, n, g = 2, 6, 7, 8, 40, 4
    x = rng.standard_normal((b, h, w, c))
    gy, gx = (v.astype(np.float64) for v in _coords(rng, b, n, h, w, g))
    gout = rng.standard_normal((b, n, c))
    outs = {}
    for dt in (torch.float32, torch.float64):
        ins = [torch.tensor(v, dtype=dt, requires_grad=True) for v in (x, gy, gx)]
        out = TS.sample_bilinear(*ins, padding_mode)
        assert out.dtype == dt
        outs[dt] = [out] + list(torch.autograd.grad(out, ins, torch.tensor(gout, dtype=dt)))
    for a, b64 in zip(outs[torch.float32], outs[torch.float64]):
        np.testing.assert_allclose(a.detach().double().numpy(), b64.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("grouped", [False, True])
def test_grid_sample_bilinear_matches_jax(grouped):
    rng = np.random.default_rng(5)
    b, h, w, c = 2, 6, 8, 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    shape = (b, 12, 16, 2, 4) if grouped else (b, 12, 16, 2)
    coords = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
    if grouped:
        ref = np.concatenate([
            np.asarray(JR.grid_sample_bilinear(jnp.asarray(x[..., i * 2:(i + 1) * 2]),
                                               jnp.asarray(coords[..., i]), prefer_onehot=False))
            for i in range(4)], -1)
    else:
        ref = np.asarray(JR.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(coords),
                                                 prefer_onehot=False))
    out = TR.grid_sample_bilinear(torch.from_numpy(x), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


@pytest.mark.parametrize("hw", [(8, 6), (9, 7)])
def test_resample_primitives_match_jax(hw):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(TR.avg_pool2(t).numpy(), np.asarray(JR.avg_pool2(j)), atol=1e-6)
    np.testing.assert_allclose(TR.nearest_upsample(t, 2).numpy(),
                               np.asarray(JR.nearest_upsample(j, 2)), atol=0)
    np.testing.assert_allclose(TR.pixel_shuffle(t, 2).numpy(), np.asarray(JR.pixel_shuffle(j, 2)),
                               atol=0)
