"""The v9, v10 and v7 families' modules in the port against the JAX package, on the CPU.

Modules, with variables drawn by numpy and carried by utils/convert.py (as
tests/test_torch_modules.py `run_pair` does): RepConv (with and without its
identity BatchNorm, stride 2), RepCSP, RepNCSPELAN4, ELAN1, AConv, ADown,
SPPELAN, RepVGGDWBlock, CIB (both middle convs), C2fCIB, PSA, SCDown,
SPPCSPC, CBLinear, V10Detect (both branches) and IDetect (the implicit
leaves), at 8-32 channels (PSA 128-256, for its heads of 64) and 7-16 px,
in eval mode and in train mode (batch statistics, and the running
statistics moved as flax moves them). Bar: 1e-5 absolute and relative;
running statistics 1e-6 absolute, 1e-5 relative.

Also: `cb_fuse` across sizes (nearest upsampling by 2 and 4, and sizes that
do not divide, against jax.image.resize's rows), `v10_postprocess` on
random scores (equal rows) and on tied scores (lower index first, as
lax.top_k), `decode_v7` on random 5-D maps, and two pins of where the
JAX package departs from the original and the port follows it: AConv and
ADown's 2x2 stride-1 mean pads the right and bottom (JAX's H x W, not
F.avg_pool2d's (H-1) x (W-1)), and a fresh v10Detect model keeps zero head
biases (JAX's bias prior matches no v10Detect leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn import heads as JH
from yolo_dbl_tpu.nn import v9v10 as JV
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import heads as TH
from yolo_dbl_tpu_torch.nn import v9v10 as TV
from yolo_dbl_tpu_torch.utils.convert import jax_param_paths, load_jax_variables, state_dict_from_jax

from tests.test_torch_modules import _input, jax_tree, random_variables, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-5
CH = (16, 32, 64)
ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))


def _pyramid(seed, b=2, hw=16):
    return [_input((b, hw >> i, hw >> i, c), seed=seed + i) for i, c in enumerate(CH)]


# name: (JAX module, port module, NHWC input shape or a list of them)
CASES = {
    "RepConv": (lambda: JV.RepConv(16, 3), lambda: TV.RepConv(16, 16, 3), (2, 8, 8, 16)),
    "RepConv_identity_bn": (lambda: JV.RepConv(16, 3, bn=True),
                            lambda: TV.RepConv(16, 16, 3, bn=True), (2, 8, 8, 16)),
    "RepConv_s2_no_act": (lambda: JV.RepConv(24, 3, 2, act=False),
                          lambda: TV.RepConv(16, 24, 3, 2, act=False), (2, 9, 9, 16)),
    "RepCSP": (lambda: JV.RepCSP(32, 2), lambda: TV.RepCSP(16, 32, 2), (2, 8, 8, 16)),
    "RepNCSPELAN4": (lambda: JV.RepNCSPELAN4(32, 32, 16, 1),
                     lambda: TV.RepNCSPELAN4(16, 32, 32, 16, 1), (2, 8, 8, 16)),
    "ELAN1": (lambda: JV.ELAN1(32, 32, 16), lambda: TV.ELAN1(16, 32, 32, 16), (2, 8, 8, 16)),
    "AConv": (lambda: JV.AConv(24), lambda: TV.AConv(16, 24), (2, 9, 10, 16)),
    "ADown": (lambda: JV.ADown(32), lambda: TV.ADown(16, 32), (2, 8, 9, 16)),
    "SPPELAN": (lambda: JV.SPPELAN(32, 16), lambda: TV.SPPELAN(16, 32, 16), (2, 8, 8, 16)),
    "RepVGGDWBlock": (lambda: JV.RepVGGDWBlock(), lambda: TV.RepVGGDWBlock(16), (2, 9, 8, 16)),
    "CIB": (lambda: JV.CIB(16, True, 0.5, False), lambda: TV.CIB(16, 16, True, 0.5, False),
            (2, 8, 8, 16)),
    "CIB_lk": (lambda: JV.CIB(16, True, 0.5, True), lambda: TV.CIB(16, 16, True, 0.5, True),
               (2, 8, 8, 16)),
    "C2fCIB_lk": (lambda: JV.C2fCIB(32, 2, True, True), lambda: TV.C2fCIB(16, 32, 2, True, True),
                  (2, 8, 8, 16)),
    "C2fCIB": (lambda: JV.C2fCIB(32, 1), lambda: TV.C2fCIB(16, 32, 1), (2, 7, 8, 16)),
    "PSA": (lambda: JV.PSA(128), lambda: TV.PSA(128, 128), (2, 4, 5, 128)),
    "PSA_2heads": (lambda: JV.PSA(256), lambda: TV.PSA(256, 256), (2, 4, 4, 256)),
    "SCDown": (lambda: JV.SCDown(32, 3, 2), lambda: TV.SCDown(16, 32, 3, 2), (2, 9, 8, 16)),
    "SPPCSPC": (lambda: JB.SPPCSPC(16), lambda: TB.SPPCSPC(16, 16), (2, 9, 9, 16)),
    "CBLinear": (lambda: JB.CBLinear((8, 16, 24)), lambda: TB.CBLinear(16, (8, 16, 24)),
                 (2, 8, 8, 16)),
    "V10Detect": (lambda: JH.V10Detect(nc=3, ch=CH), lambda: TH.V10Detect(nc=3, ch=CH),
                  [(2, 16, 16, 16), (2, 8, 8, 32), (2, 4, 4, 64)]),
    "IDetect": (lambda: JH.IDetect(nc=3, anchors=ANCHORS, ch=CH),
                lambda: TH.IDetect(3, ANCHORS, CH), [(2, 16, 16, 16), (2, 8, 8, 32), (2, 4, 4, 64)]),
}


def _inputs(shape, seed):
    if isinstance(shape, list):
        return [_input(s, seed=seed + i) for i, s in enumerate(shape)]
    return _input(shape, seed=seed)


def _flat(out, torch_side):
    """The arrays of a module's output, NHWC, in order: a map, a tuple or
    list of maps, or V10Detect's dict. IDetect's port maps are NCHW of
    na * (5 + nc) channels, JAX's (B, H, W, na, 5 + nc)."""
    if isinstance(out, dict):
        return [a for k in ("one2many", "one2one") for a in _flat(out[k], torch_side)]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o, torch_side)]
    if torch_side:
        return [to_nhwc(out)]
    a = np.asarray(out)
    return [a.reshape(*a.shape[:3], -1)] if a.ndim == 5 else [a]


def _close(out_t, out_j):
    a, b = _flat(out_t, True), _flat(out_j, False)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL)


def _run(case, seed, train, x=None):
    make_j, make_t, shape = CASES[case]
    jm, tm = make_j(), make_t()
    x = _inputs(shape, seed) if x is None else x
    jin = [jnp.asarray(v) for v in x] if isinstance(x, list) else jnp.asarray(x)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jin)
    variables = random_variables(shapes, np.random.default_rng(seed + 10))
    out_j, mut = jm.apply(jax_tree(variables), jin, train=train, mutable=["batch_stats"])
    load_jax_variables(tm, variables)
    tm.train(train)
    with torch.no_grad():
        out_t = tm([to_nchw(v) for v in x] if isinstance(x, list) else to_nchw(x))
    return tm, out_t, out_j, mut


@pytest.mark.parametrize("case", sorted(CASES))
def test_v9v10_module_parity(case):
    _, out_t, out_j, _ = _run(case, 2, train=False)
    _close(out_t, out_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_v9v10_module_train_mode_and_batch_stats(case):
    """Train mode: batch statistics in every BatchNorm (Conv's eps 1e-3,
    RepConv's flax defaults eps 1e-5, momentum 0.99), and the running
    statistics moved as flax moves them."""
    tm, out_t, out_j, mut = _run(case, 3, train=True)
    _close(out_t, out_j)
    stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mut.get("batch_stats", {}))})
    own = tm.state_dict()
    assert len(stats) >= (0 if case in ("CBLinear", "IDetect") else 2)
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


def test_implicit_leaves_bridge_and_paths():
    """IDetect's `ia{i}`/`im{i}` (1, 1, 1, C) leaves load as (1, C, 1, 1)
    parameters, its bare `m{i}` convs as convs, and `jax_param_paths`
    names every parameter by its JAX path."""
    tm, _, _, _ = _run("IDetect", 4, train=False)
    assert tuple(tm.ia1.shape) == (1, 32, 1, 1) and tuple(tm.im2.shape) == (1, 24, 1, 1)
    paths = jax_param_paths(tm)
    assert paths["ia0"] == "ia0" and paths["m1.weight"] == "m1/kernel"
    assert paths["m1.bias"] == "m1/bias"
    assert len(paths) == 12


def test_v10detect_one2one_reads_detached_features():
    """one2one's loss reaches its own leaves and not the features: JAX's
    stop_gradient."""
    tm = TH.V10Detect(nc=3, ch=CH)
    xs = [to_nchw(x).requires_grad_() for x in _pyramid(5)]
    out = tm(xs)
    g = torch.autograd.grad(sum(o.sum() for o in out["one2one"]), xs, allow_unused=True)
    assert all(v is None for v in g)
    g = torch.autograd.grad(sum(o.sum() for o in out["one2many"]), xs)
    assert all(float(v.abs().max()) > 0 for v in g)


@pytest.mark.parametrize("sizes,target", [
    (((4, 4), (8, 8)), (16, 16)),  # nearest upsampling by 4 and 2
    (((5, 7), (16, 16)), (12, 9)),  # ratios that do not divide, up and down
])
def test_cb_fuse_matches_jax(sizes, target):
    rng = np.random.default_rng(6)
    c = 8
    xs = [tuple(rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for _ in range(3))
          for h, w in sizes]
    last = rng.normal(0, 1, (2, *target, c)).astype(np.float32)
    idx = [2, 0]
    want = np.asarray(JB.cb_fuse([tuple(jnp.asarray(t) for t in x) for x in xs]
                                 + [jnp.asarray(last)], idx))
    got = TB.cb_fuse([tuple(to_nchw(t) for t in x) for x in xs] + [to_nchw(last)], idx)
    assert to_nhwc(got).shape == want.shape == (2, *target, c)
    np.testing.assert_allclose(to_nhwc(got), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("max_det", [20, 300])
def test_v10_postprocess_matches_jax(max_det):
    """Random scores (no ties): the same (B, k, 6) rows; k = min(max_det, A)."""
    rng = np.random.default_rng(7)
    pred = np.concatenate([rng.uniform(0, 64, (2, 4, 120)), rng.uniform(0, 1, (2, 5, 120))],
                          1).astype(np.float32)
    want = np.asarray(JH.v10_postprocess(jnp.asarray(pred), max_det=max_det, nc=5))
    got = TH.v10_postprocess(torch.from_numpy(pred), max_det=max_det, nc=5).numpy()
    assert got.shape == want.shape == (2, min(max_det, 120), 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_v10_postprocess_ties_take_the_lower_index_first():
    """Scores on a grid of 4 values: many ties, in both top-k passes. JAX's
    lax.top_k puts the lower index first; so does the port."""
    rng = np.random.default_rng(8)
    pred = np.concatenate([rng.uniform(0, 64, (2, 4, 60)),
                           rng.integers(0, 4, (2, 3, 60)) / 4.0], 1).astype(np.float32)
    want = np.asarray(JH.v10_postprocess(jnp.asarray(pred), max_det=25, nc=3))
    got = TH.v10_postprocess(torch.from_numpy(pred), max_det=25, nc=3).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_v7_matches_jax():
    rng = np.random.default_rng(9)
    strides = (8, 16, 32)
    feats = [rng.normal(0, 2, (2, 64 // s, 64 // s, 3, 5 + 3)).astype(np.float32)
             for s in strides]
    want = np.asarray(JH.decode_v7([jnp.asarray(f) for f in feats], strides, ANCHORS, 3))
    got = TH.decode_v7([torch.from_numpy(f) for f in feats], strides, ANCHORS, 3).numpy()
    assert got.shape == want.shape == (2, 4 + 3, 3 * (64 + 16 + 4))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert 0.0 <= got[:, 4:].min() and got[:, 4:].max() <= 1.0


# ---------------------------------------------------------------- mirrored departures


@pytest.mark.parametrize("case", ["AConv", "ADown"])
def test_avg_pool2_s1_pads_right_and_bottom_as_jax(case):
    """JAX's `_avg_pool2_s1` (v9v10.py:123) pads the right and bottom and
    divides by the count covered: H x W. The original's
    F.avg_pool2d(x, 2, 1) is (H-1) x (W-1). The port equals JAX at every
    position (test_v9v10_module_parity); here the module run on the
    original form equals it except on the last output row and column,
    which read the extra row and column."""
    x = _input((2, 8, 8, 16), seed=11)
    tm, _, out_j, _ = _run(case, 11, train=False, x=x)
    xt = to_nchw(x)
    pooled = TV.avg_pool2_s1(xt)
    original = F.avg_pool2d(xt, 2, 1)
    assert tuple(pooled.shape[-2:]) == (8, 8) and tuple(original.shape[-2:]) == (7, 7)
    np.testing.assert_allclose(pooled[..., :7, :7].numpy(), original.numpy(), atol=1e-6)
    np.testing.assert_array_equal(pooled[..., -1, -1].numpy(), xt[..., -1, -1].numpy())
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        ours = tm(xt)
        mp.setattr(TV, "avg_pool2_s1", lambda t: F.avg_pool2d(t, 2, 1))
        theirs = tm(xt)
    np.testing.assert_allclose(to_nhwc(ours), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours[..., :-1, :-1].numpy(), theirs[..., :-1, :-1].numpy(),
                               atol=1e-5)
    d = (ours - theirs).abs()
    assert float(d[..., -1, :].max()) > 1e-3 and float(d[..., :, -1].max()) > 1e-3


def test_fresh_v10_model_has_zero_head_biases_as_jax():
    """JAX's `_bias_init` (tasks.py:814) writes the prior where a leaf path
    holds `m{head}/cv2_{lvl}_2/conv/bias`; v10Detect's leaves are
    `m23/one2many/cv2_0_2/...`, so JAX leaves them at flax's zero init.
    The port mirrors it: a fresh yolov10n has zero box and class biases in
    both branches (a yolov9t, plain Detect, takes the prior)."""
    jm = JaxDetectionModel("yolov10n.yaml", nc=3)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    head = jm._bias_init(zeros)["params"]["m23"]
    for branch in ("one2many", "one2one"):
        for lvl in range(3):
            for cv in ("cv2", "cv3"):
                assert not np.asarray(head[branch][f"{cv}_{lvl}_2"]["conv"]["bias"]).any()
    tm = DetectionModel("yolov10n.yaml", nc=3, device="cpu")
    assert [type(d).__name__ for d in tm.detect_branches] == ["Detect", "Detect"]
    for det in tm.detect_branches:
        for lvl in range(3):
            assert not getattr(det, f"cv2_{lvl}_2").conv.bias.any()
            assert not getattr(det, f"cv3_{lvl}_2").conv.bias.any()
    v9 = DetectionModel("yolov9t.yaml", nc=3, device="cpu")
    assert bool((v9.detect.cv2_0_2.conv.bias == 1.0).all())
