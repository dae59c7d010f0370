"""Shared-weight parity of the PyTorch port's modules with the JAX package.

Each case builds the JAX module and its port at narrow widths, draws one set
of variables with numpy (BatchNorm statistics, biases and gates perturbed
away from their init so nothing hides behind an identity), loads them into
the port through the weight bridge, and compares outputs on the same NHWC
input. Tolerance: 1e-4 absolute and relative, float32 sums of up to a few
hundred terms taken in another order by each framework.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn import common as JC
from yolo_dbl_tpu.nn import heads as JH
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import common as TC
from yolo_dbl_tpu_torch.nn import heads as TH
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-4


def random_variables(shapes, rng, gate=0.5):
    """numpy values for a JAX variables shape tree: lecun-scaled kernels and
    non-trivial BatchNorm statistics, biases, FullPAD gates, A2C2f gammas
    and IDetect's implicit leaves."""

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        if name in ("scale",):
            return rng.uniform(0.5, 1.5, shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.2, shape)
        if name == "gate":
            return np.full(shape, gate)
        if name == "prototype_base":
            return rng.normal(0.0, 0.3, shape)
        if name == "gamma":
            return rng.uniform(0.5, 1.5, shape)
        if name[:2] in ("ia", "im") and name[2:].isdigit():  # IDetect's implicit leaves
            return rng.normal(1.0 if name[1] == "m" else 0.0, 0.2, shape)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(lambda p, l: draw(p, l).astype(np.float32), shapes)


def jax_tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def run_pair(jax_module, torch_module, inputs, seed=0):
    """Apply both modules to the same NHWC input(s) with shared random variables."""
    rng = np.random.default_rng(seed)
    jin = [jnp.asarray(x) for x in inputs] if isinstance(inputs, list) else jnp.asarray(inputs)
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jin)
    variables = random_variables(shapes, rng)
    out_j = jax_module.apply(jax_tree(variables), jin)
    load_jax_variables(torch_module, variables)
    torch_module.eval()
    tin = [to_nchw(x) for x in inputs] if isinstance(inputs, list) else to_nchw(inputs)
    with torch.no_grad():
        out_t = torch_module(tin)
    return out_j, out_t


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


SINGLE_INPUT_CASES = {
    "Conv_k3_s2": (lambda: JC.Conv(16, 3, 2), lambda: TC.Conv(8, 16, 3, 2), (2, 12, 10, 8)),
    "DWConv_gcd": (lambda: JC.DWConv(16, 3), lambda: TC.DWConv(8, 16, 3), (2, 9, 9, 8)),
    "DSConv_s2": (lambda: JC.DSConv(16, 3, 2), lambda: TC.DSConv(8, 16, 3, 2), (2, 12, 12, 8)),
    "DSConv_dilated": (lambda: JC.DSConv(16, 7, d=2), lambda: TC.DSConv(8, 16, 7, d=2), (1, 16, 16, 8)),
    "Conv2d_grouped": (lambda: JC.Conv2d(16, 3, g=4), lambda: TC.Conv2d(8, 16, 3, g=4), (2, 8, 8, 8)),
    "Bottleneck": (lambda: JB.Bottleneck(16), lambda: TB.Bottleneck(16, 16), (2, 8, 8, 16)),
    "DSC3k2_dsc3k": (lambda: JB.DSC3k2(32, 2, True), lambda: TB.DSC3k2(16, 32, 2, True),
                     (2, 10, 10, 16)),
    "LSKblock": (lambda: JB.LSKblock(16), lambda: TB.LSKblock(16), (2, 16, 16, 16)),
    "C3AH": (lambda: JB.C3AH(32, 1.0, 4), lambda: TB.C3AH(24, 32, 1.0, 4), (2, 6, 6, 24)),
    "DownsampleConv_odd": (lambda: JB.DownsampleConv(), lambda: TB.DownsampleConv(16),
                           (2, 9, 11, 16)),
    "DySample": (lambda: JB.DySample(32), lambda: TB.DySample(32), (2, 8, 6, 32)),
}


@pytest.mark.parametrize("case", sorted(SINGLE_INPUT_CASES))
def test_single_input_module_parity(case):
    make_j, make_t, shape = SINGLE_INPUT_CASES[case]
    out_j, out_t = run_pair(make_j(), make_t(), _input(shape))
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


def test_dysample_border_taps():
    """Large offsets push sample points past the border: border clipping
    (coincident taps add) must match too."""
    x = _input((1, 6, 6, 16), seed=3)
    jm, tm = JB.DySample(16), TB.DySample(16)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, rng)
    variables["params"]["offset"]["conv"]["bias"] = rng.normal(0.0, 16.0, (32,)).astype(np.float32)
    out_j = jm.apply(jax_tree(variables), jnp.asarray(x))
    load_jax_variables(tm, variables)
    with torch.no_grad():
        out_t = tm(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


def test_hyperace_parity():
    """HyperACE over a 3-level pyramid: fuse, C3AH branches (both on y1), DSC3k chain."""
    xs = [_input((2, 8, 8, 32), 5), _input((2, 4, 4, 32), 6), _input((2, 2, 2, 64), 7)]
    jm = JB.HyperACE(32, 64, 1, 4, True, True, 0.5, 1, "both", True)
    tm = TB.HyperACE(32, 64, 1, 4, True, True, 0.5, 1, "both", True)
    out_j, out_t = run_pair(jm, tm, xs)
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


def test_fullpad_tunnel_gate():
    xs = [_input((2, 4, 4, 8), 8), _input((2, 4, 4, 8), 9)]
    out_j, out_t = run_pair(JB.FullPAD_Tunnel(), TB.FullPAD_Tunnel(), xs)
    assert float(out_t.detach().abs().sum()) > 0
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=1e-6)
    np.testing.assert_allclose(to_nhwc(out_t), xs[0] + 0.5 * xs[1], atol=1e-6)


def test_detect_and_decode_parity():
    ch, nc, strides = (16, 32, 64), 3, (8, 16, 32)
    xs = [_input((2, 8, 8, 16), 10), _input((2, 4, 4, 32), 11), _input((2, 2, 2, 64), 12)]
    out_j, out_t = run_pair(JH.Detect(nc=nc, ch=ch, legacy=False), TH.Detect(nc=nc, ch=ch), xs)
    feats_t = [o.permute(0, 2, 3, 1) for o in out_t]
    for a, b in zip(feats_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    dec_j = np.asarray(JH.decode_detections(out_j, strides, nc))
    dec_t = TH.decode_detections(feats_t, strides, nc).numpy()
    assert dec_t.shape == dec_j.shape == (2, 4 + nc, 84)
    np.testing.assert_allclose(dec_t[:, :4], dec_j[:, :4], atol=1e-3)
    np.testing.assert_allclose(dec_t[:, 4:], dec_j[:, 4:], atol=1e-5)


def _clustered_predictions(seed, b=2, a=600, nc=3):
    """Decoded (B, 4+nc, A) predictions with overlapping box clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(40, 600, (b, 12, 2))
    pick = rng.integers(0, 12, (b, a))
    xy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 6, (b, a, 2))
    wh = rng.uniform(20, 90, (b, a, 2))
    scores = rng.uniform(0, 1, (b, a, nc)) ** 2
    return np.concatenate([xy, wh, scores], -1).transpose(0, 2, 1).astype(np.float32)


@pytest.mark.parametrize("multi_label,topk", [(True, 1024), (False, 1024), (True, 200)])
def test_nms_parity(multi_label, topk):
    """Identical decoded predictions on both sides: equal counts, equal rows."""
    pred = _clustered_predictions(13)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, pre_nms_topk=topk,
              multi_label=multi_label)
    dj, nj = jax_nms(jnp.asarray(pred), **kw)
    dt, nt = torch_nms(torch.from_numpy(pred), **kw)
    assert dt.shape == (2, 300, 6) and nt.dtype == torch.int32
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert 0 < int(nt.min()) and int(nt.max()) < 300  # suppression really happened
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


def test_nms_ties_follow_index_order():
    """Equal scores keep index order, as lax.top_k does, so greedy keeps the
    same box of a tied overlapping pair."""
    pred = np.zeros((1, 5, 4), np.float32)
    pred[0, :4] = [[50, 52, 200, 201], [50, 50, 200, 200], [40, 40, 120, 121], [40, 40, 120, 120]]
    pred[0, 4] = [0.9, 0.9, 0.7, 0.7]
    dj, nj = jax_nms(jnp.asarray(pred))
    dt, nt = torch_nms(torch.from_numpy(pred))
    assert int(nt[0]) == int(nj[0]) == 2
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
