"""Shared-weight parity of the pools' last attention and upsample modules in the port with the JAX package.

`yolo_dbl_tpu/nn/upsample/{batch3,misc,pig,loftup_dlu}.py` (LDA_AQU,
CARAFEplusplus, CAA, the wavelet family and C2f_PIG, LoftUp and DLUPack),
`nn/attention/{extra,bigarch,spatial}.py` (ASFF, ASFFmobile, PSAModule,
CPCA, OutlookAttention and Outlooker, EdgeAwareAttentionV2),
`nn/structures/blocks.py` (GhostModuleV2, GhostBottleneckV2) and the
resampling helpers they bring (`grid_sample_bilinear` with align_corners,
JAX's bicubic and nearest resize, `jnp.linspace`'s formula). Each case
builds the JAX module and its port at 16-64 channels on 8-24 px maps,
draws one set of variables with numpy (the bare leaves too: `rpb`, `kx`,
`ky`, `base_scale`, `wavelet_scale`, `biases`, `lr_pe`, the channel
LayerNorm's `weight`), loads them through the weight bridge, and compares
the eval-mode outputs on the same input in float32: max |Δ| ≤ 1e-4 of the
JAX output's largest |value|.

LoftUp is held in float64 on both sides: its Fourier features reach
frequencies of exp(10), where an ulp of a grid point moves a sine by
~2e-3, and XLA on the CPU rounds some of `jnp.linspace`'s points an ulp or
two off its own formula (the float32 gap is in ROADMAP Queue 3). LDA_AQU's
gradient (input and parameters) is held against `jax.grad` in float64 on
both sides, through K2's plain backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.nn import attention as JA
from yolo_dbl_tpu.nn import structures as JS
from yolo_dbl_tpu.nn.upsample import batch3 as J3
from yolo_dbl_tpu.nn.upsample import loftup_dlu as JL
from yolo_dbl_tpu.nn.upsample import misc as JM
from yolo_dbl_tpu.nn.upsample import pig as JP
from yolo_dbl_tpu.ops import resample as JR

from yolo_dbl_tpu_torch.nn.attention import bigarch as TB
from yolo_dbl_tpu_torch.nn.attention import extra as TE
from yolo_dbl_tpu_torch.nn.attention import spatial as TSP
from yolo_dbl_tpu_torch.nn.structures import blocks as TS
from yolo_dbl_tpu_torch.nn.upsample import batch3 as T3
from yolo_dbl_tpu_torch.nn.upsample import loftup_dlu as TL
from yolo_dbl_tpu_torch.nn.upsample import misc as TM
from yolo_dbl_tpu_torch.nn.upsample import pig as TP
from yolo_dbl_tpu_torch.ops import resample as TR
from yolo_dbl_tpu_torch.utils.convert import jax_param_paths, load_jax_variables, params_from_jax

from tests.test_torch_modules import jax_tree, random_variables, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

BAR = 1e-4  # of the JAX output's largest |value|
# the bare leaves of these modules, drawn with numpy
POOL_LEAVES = {
    "rpb": lambda rng, shape: rng.normal(0.0, 0.5, shape),
    "kx": lambda rng, shape: rng.normal(0.0, 1.0, shape),
    "ky": lambda rng, shape: rng.normal(0.0, 1.0, shape),
    "base_scale": lambda rng, shape: rng.uniform(0.5, 1.5, shape),
    "wavelet_scale": lambda rng, shape: rng.uniform(0.05, 0.5, shape),
    "biases": lambda rng, shape: rng.normal(0.0, 1.0, shape),
    "lr_pe": lambda rng, shape: rng.normal(0.0, 1.0, shape),
    "weight": lambda rng, shape: rng.uniform(0.5, 1.5, shape),
}


def pool_variables(shapes, rng, scale=None, leaves=POOL_LEAVES):
    """`random_variables` with the bare leaves of `leaves` drawn too;
    `scale`: {leaf path suffix: factor} for kernels drawn larger."""

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in leaves:
            return leaves[name](rng, leaf.shape).astype(np.float32)
        value = random_variables({name: leaf}, rng)[name]
        keys = "/".join(str(p.key) for p in path)
        for suffix, factor in (scale or {}).items():
            if keys.endswith(suffix):
                value = value * factor
        return value

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def run(jax_module, torch_module, xs, seed=0, scale=None):
    """Both modules applied to the NHWC input(s) `xs` (an array, a tuple of
    arguments, or a list taken as one argument) with shared variables: (JAX
    output (jitted), port output in NHWC, the variables)."""
    args = xs if isinstance(xs, tuple) else (xs,)
    jin = [[jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x) for x in args]
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *jin)
    variables = pool_variables(shapes, np.random.default_rng(seed), scale)
    out_j = np.asarray(jax.jit(jax_module.apply)(jax_tree(variables), *jin))
    load_jax_variables(torch_module, variables)
    torch_module.eval()
    tin = [[to_nchw(a) for a in x] if isinstance(x, list) else to_nchw(x) for x in args]
    with torch.no_grad():
        out_t = to_nhwc(torch_module(*tin))
    return out_j, out_t, variables


def assert_close(got, want, bar=BAR):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bar * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _asff_inputs(level, dims):
    """[x0 (P5), x1 (P4), x2 (P3)] at 4, 8 and 16 px; the level's own input
    has `dims[level]` channels (it enters the fusion as it is), the others
    narrower widths of their own."""
    widths = [dims[i] if i == level else (24, 40, 16)[i] for i in range(3)]
    return [_input((2, 4 * 2 ** i, 4 * 2 ** i, widths[i]), seed=i + 1) for i in range(3)]


# {case: (JAX module, port module, NHWC input shape or inputs)}
CASES = {
    "LDA_AQU": (lambda: J3.LDA_AQU(32), lambda: T3.LDA_AQU(32), (2, 8, 12, 32)),
    "LDA_AQU_4groups_2heads": (lambda: J3.LDA_AQU(64, n_groups=4, nh=2),
                               lambda: T3.LDA_AQU(64, n_groups=4, nh=2), (2, 9, 7, 64)),
    "CARAFEplusplus_up": (lambda: J3.CARAFEplusplus(32), lambda: T3.CARAFEplusplus(32),
                          (2, 8, 10, 32)),
    "CARAFEplusplus_down": (lambda: J3.CARAFEplusplus(32, up_down_type="down"),
                            lambda: T3.CARAFEplusplus(32, up_down_type="down"), (2, 8, 10, 32)),
    "CARAFEplusplus_down_s3": (lambda: J3.CARAFEplusplus(32, 3, "down"),
                               lambda: T3.CARAFEplusplus(32, 3, "down"), (2, 9, 12, 32)),
    "CAA": (lambda: JM.CAA(16), lambda: TM.CAA(16), (2, 10, 12, 16)),
    "WTConv2d_odd": (lambda: JP.WTConv2d(16, 3), lambda: TP.WTConv2d(16, 3), (2, 9, 11, 16)),
    "WTConv2d_k5": (lambda: JP.WTConv2d(16), lambda: TP.WTConv2d(16), (2, 8, 10, 16)),
    "C2f_PIG_n1_shortcut": (lambda: JP.C2f_PIG(32, 1, True), lambda: TP.C2f_PIG(16, 32, 1, True),
                            (2, 12, 10, 16)),
    "C2f_PIG_n4": (lambda: JP.C2f_PIG(32, 4), lambda: TP.C2f_PIG(16, 32, 4), (2, 12, 10, 16)),
    "C2f_PIG_n4_se": (lambda: JP.C2f_PIG(32, 4, se_ratio=0.25),
                      lambda: TP.C2f_PIG(16, 32, 4, se_ratio=0.25), (2, 9, 11, 16)),
    "C2f_WT_shortcut": (lambda: JP.C2f_WT(32, 2, True), lambda: TP.C2f_WT(16, 32, 2, True),
                        (2, 9, 11, 16)),
    "GhostModuleV2_attn_s2": (lambda: JS.GhostModuleV2(24, 3, stride=2, mode="attn"),
                              lambda: TS.GhostModuleV2(16, 24, 3, stride=2, mode="attn"),
                              (2, 11, 9, 16)),
    "GhostBottleneckV2_s2_se": (lambda: JS.GhostBottleneckV2(24, 32, stride=2, se_ratio=0.25),
                                lambda: TS.GhostBottleneckV2(16, 24, 32, stride=2, se_ratio=0.25),
                                (2, 12, 10, 16)),
    "GhostBottleneckV2_identity": (lambda: JS.GhostBottleneckV2(24, 16),
                                   lambda: TS.GhostBottleneckV2(16, 24, 16), (2, 8, 10, 16)),
    "PSAModule_s2": (lambda: JA.PSAModule(64, stride=2), lambda: TE.PSAModule(32, 64, stride=2),
                     (2, 12, 10, 32)),
    "CPCA_trans": (lambda: JA.CPCA(16, 32), lambda: TE.CPCA(16, 32), (2, 12, 10, 16)),
    "CPCA": (lambda: JA.CPCA(32), lambda: TE.CPCA(32), (2, 12, 10, 32)),
    "Outlooker_k3_4heads": (lambda: JA.Outlooker(32, 3, 4), lambda: TB.Outlooker(32, 32, 3, 4),
                            (2, 9, 11, 32)),
    "EdgeAwareAttentionV2_scalar": (lambda: JA.EdgeAwareAttentionV2(32),
                                    lambda: TSP.EdgeAwareAttentionV2(32), (2, 10, 12, 32)),
    "EdgeAwareAttentionV2_map": (lambda: JA.EdgeAwareAttentionV2(32, alpha_mode="map"),
                                 lambda: TSP.EdgeAwareAttentionV2(32, alpha_mode="map"),
                                 (2, 10, 12, 32)),
    "DLUPack": (lambda: JL.DLUPack(16), lambda: TL.DLUPack(16), (2, 10, 12, 16)),
}
CASES.update({
    f"ASFF_level{lvl}": (lambda lvl=lvl: JA.ASFF(lvl),
                         lambda lvl=lvl: TE.ASFF(lvl, ch=[x.shape[-1] for x in
                                                         _asff_inputs(lvl, TE.ASFF.DIMS)]),
                         _asff_inputs(lvl, TE.ASFF.DIMS)) for lvl in (0, 1, 2)})
CASES["ASFFmobile_level2"] = (
    lambda: JA.ASFFmobile(2),
    lambda: TE.ASFFmobile(2, ch=[x.shape[-1] for x in _asff_inputs(2, TE.ASFFmobile.DIMS)]),
    _asff_inputs(2, TE.ASFFmobile.DIMS))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_module_parity(case):
    make_j, make_t, shape = CASES[case]
    x = shape if isinstance(shape, list) else _input(shape)
    out_j, out_t, _ = run(make_j(), make_t(), x)
    assert_close(out_t, out_j)


def _lda_coords(tm, x):
    """LDA_AQU's tap coordinates (B, Hq, Wq, k_u², G) from the port's layers."""
    with torch.no_grad():
        q_hi = TR.bilinear_upsample(tm.proj_q(x).permute(0, 2, 3, 1), 2, align_corners=False)
        return tm.coords(q_hi.permute(0, 3, 1, 2), *x.shape[2:])


def test_lda_aqu_taps_leave_the_map_on_a_non_square_map():
    """The offsets reach tanh · 11 / max(h, w) of each side (7.3 rows and
    11 columns of an 8x12 map): most taps leave the map, and border padding
    clamps them; the width scales the offsets further than the height. The
    port's offset network is one set of weights shared by the 4 groups."""
    x = _input((2, 8, 12, 64))
    tm = T3.LDA_AQU(64, n_groups=4)
    out_j, out_t, _ = run(J3.LDA_AQU(64, n_groups=4), tm, x)
    assert_close(out_t, out_j)
    assert tm.off_dw.conv.weight.shape == (4, 1, 3, 3)  # gc = 64 / 4 / 4 channels, one bank
    sy, sx = _lda_coords(tm, to_nchw(x))
    assert sy.shape == sx.shape == (2, 16, 24, 9, 4)
    outside = ((sy < 0) | (sy > 7) | (sx < 0) | (sx > 11)).float().mean()
    assert 0.3 < float(outside) < 0.9
    assert float(sx.max() - sx.min()) > float(sy.max() - sy.min())


def test_lda_aqu_gradient_matches_jax_in_float64():
    """d(sum(out · r))/d(x, every parameter) of LDA_AQU in float64 on both
    sides: JAX's jax.grad, the port's autograd through K2's plain backward
    (kernels/sampling.py `sample_bilinear_plain` on the CPU); max |Δ| ≤
    1e-9 of each gradient's largest, plus 1e-12 of the largest of all."""
    x = _input((2, 8, 10, 32)).astype(np.float64)
    r = _input((2, 16, 20, 32), seed=7).astype(np.float64)
    jm = J3.LDA_AQU(32, dtype=jnp.float64)
    tm = T3.LDA_AQU(32).double()
    with jax.enable_x64(True):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
        variables = pool_variables(shapes, np.random.default_rng(0), {"off_pw/conv/kernel": 3.0})
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss(params, xx):
            return jnp.sum(jm.apply({"params": params}, xx) * jnp.asarray(r))

        g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(jax_tree(variables["params"]),
                                                               jnp.asarray(x))
        g_params = jax.tree_util.tree_map(np.asarray, g_params)
        g_x = np.asarray(g_x)
    load_jax_variables(tm, variables)
    xt = to_nchw(x).clone().requires_grad_()
    (tm(xt) * to_nchw(r)).sum().backward()
    np.testing.assert_allclose(to_nhwc(xt.grad), g_x, atol=1e-9 * np.abs(g_x).max(), rtol=0)
    want = {k: v.numpy() for k, v in params_from_jax(tm, g_params).items()}
    floor = 1e-12 * max(np.abs(w).max() for w in want.values())
    assert float(np.abs(want["rpb"]).max()) > 0
    for name, p in tm.named_parameters():
        w = want[name]
        assert np.abs(p.grad.numpy() - w).max() <= 1e-9 * np.abs(w).max() + floor, name


def _linspace_formula(start, stop, num):
    """jnp.linspace's formula (jax 0.9 `_linspace`) evaluated by numpy in float32."""
    step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    out = np.float32(start) * (np.float32(1) - step) + np.float32(stop) * step
    return np.append(out, np.float32(stop))


@pytest.mark.parametrize("num", [5, 12, 20, 24])
def test_grid_and_freqs_follow_jax_linspace(num):
    """The grid points and the frequencies' exponents are JAX's formula bit
    for bit (float32 iota / (num - 1), start (1 - step) + stop step, the
    last point `stop`), where torch.linspace's second half counts back from
    `stop`. XLA's own values on the CPU part from the formula by up to 2
    float32 eps at the grid's scale (its division), and its frequencies
    from the port's by a few parts in 1e6 (its exponents' rounding and its
    exp): at exp(10) that moves a sine's argument by ~0.05, hence the
    float64 LoftUp tests."""
    grid = TL.fourier_grid(num, num + 1)
    np.testing.assert_array_equal(grid[:, 0, 0].numpy(), _linspace_formula(-1, 1, num))
    np.testing.assert_array_equal(grid[0, :, 1].numpy(), _linspace_formula(-1, 1, num + 1))
    np.testing.assert_array_equal(TR.linspace(-2, 10, num).numpy(), _linspace_formula(-2, 10, num))
    xla_grid = np.asarray(jax.jit(lambda: jnp.linspace(-1, 1, num))())
    assert np.abs(TR.linspace(-1, 1, num).numpy() - xla_grid).max() <= 2 * 2.0 ** -23
    xla_freqs = np.asarray(jax.jit(lambda: jnp.exp(jnp.linspace(-2, 10, num)))())
    np.testing.assert_allclose(TL.fourier_freqs(num).numpy(), xla_freqs, rtol=4e-6, atol=0)


@pytest.mark.parametrize("pe,lr_hw", [("sine", (6, 5)), ("learnable", (6, 6)),
                                      ("learnable", (12, 12)), ("learnable", (8, 8))])
def test_loftup_matches_jax_in_float64(pe, lr_hw):
    """LoftUp (lr_size 8) at 16 channels on a 24x20 image, sine PE or the
    learnable table resized down, up or kept, float64 on both sides."""
    lr = _input((2, *lr_hw, 16)).astype(np.float64)
    img = _input((2, 24, 20, 3), seed=2).astype(np.float64)
    with jax.enable_x64(True):
        jm = JL.LoftUp(16, lr_pe_type=pe, lr_size=8, dtype=jnp.float64)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(lr), jnp.asarray(img))
        variables = pool_variables(shapes, np.random.default_rng(0))
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        want = np.asarray(jax.jit(jm.apply)(jax_tree(variables), jnp.asarray(lr), jnp.asarray(img)))
    tm = TL.LoftUp(16, lr_pe_type=pe, lr_size=8)
    load_jax_variables(tm, variables)
    tm = tm.double().eval()
    with torch.no_grad():
        got = to_nhwc(tm(to_nchw(lr), to_nchw(img)))
    assert_close(got, want)


@pytest.mark.parametrize("size", [(5, 7), (16, 16), (12, 20)])
def test_resize_bicubic_and_nearest_match_jax_image_resize(size):
    """A 8x12 map resized down, across and up: Keys' cubic with JAX's edge
    renormalization and antialiasing, and JAX's nearest rule."""
    x = _input((2, 8, 12, 5))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 5), "bicubic"))
    np.testing.assert_allclose(TR.resize_bicubic(torch.from_numpy(x), *size).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 5), "nearest"))
    np.testing.assert_array_equal(TR.resize_nearest(torch.from_numpy(x), *size).numpy(), want)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jax_in_both_corner_modes(align_corners):
    x = _input((2, 7, 9, 8))
    grid = np.random.default_rng(3).uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(np.float32)
    want = np.asarray(JR.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid), "border",
                                              align_corners=align_corners))
    got = TR.grid_sample_bilinear(torch.from_numpy(x), torch.from_numpy(grid), "border",
                                  align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wavelet_transforms_match_jax():
    x = _input((2, 8, 10, 6))
    np.testing.assert_array_equal(TP.haar_filters().numpy(), np.asarray(JP.haar_filters()))
    sub = np.asarray(JP.wavelet_transform(jnp.asarray(x)))
    np.testing.assert_allclose(TP.wavelet_transform(torch.from_numpy(x)).numpy(), sub, atol=1e-6)
    np.testing.assert_allclose(TP.inverse_wavelet_transform(torch.from_numpy(sub.copy())).numpy(),
                               np.asarray(JP.inverse_wavelet_transform(jnp.asarray(sub))),
                               atol=1e-6)


def test_bridge_names_the_bare_leaves():
    """The new bare leaves map both ways: JAX path → parameter
    (`params_from_jax`) and parameter → JAX path (`jax_param_paths`)."""
    modules = {"lda": (J3.LDA_AQU(32), T3.LDA_AQU(32), (2, 8, 8, 32)),
               "edge": (JA.EdgeAwareAttentionV2(32), TSP.EdgeAwareAttentionV2(32), (2, 8, 8, 32)),
               "wt": (JP.WTConv2d(16), TP.WTConv2d(16), (2, 8, 8, 16))}
    seen = set()
    for jm, tm, shape in modules.values():
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape))
        params = pool_variables(shapes, np.random.default_rng(0))["params"]
        mapped = params_from_jax(tm, params)
        paths = jax_param_paths(tm)
        assert set(paths) == set(mapped)
        for name, path in paths.items():
            if path.split("/")[-1] in POOL_LEAVES:  # copied as they are
                leaf = params
                for key in path.split("/"):
                    leaf = leaf[key]
                np.testing.assert_array_equal(np.asarray(leaf), mapped[name].numpy())
        seen |= {p.split("/")[-1] for p in paths.values()}
    assert {"rpb", "kx", "ky", "base_scale", "wavelet_scale"} <= seen
    lm = TL.LoftUp(16, lr_pe_type="learnable", lr_size=4)
    paths = jax_param_paths(lm)
    assert paths["lr_pe"] == "lr_pe" and paths["cn.weight"] == "cn/weight"
    assert paths["fourier.biases"] == "fourier/biases"


def loftup_float32_gap():
    """{case: max |Δ| over JAX's largest |value|} of LoftUp in float32 on both
    sides at the float64 test's shapes and variables (ROADMAP Queue 3)."""
    out = {}
    for pe, lr_hw in (("sine", (6, 5)), ("learnable", (6, 6)), ("learnable", (12, 12))):
        lr, img = _input((2, *lr_hw, 16)), _input((2, 24, 20, 3), seed=2)
        out_j, out_t, _ = run(JL.LoftUp(16, lr_pe_type=pe, lr_size=8),
                              TL.LoftUp(16, lr_pe_type=pe, lr_size=8), (lr, img))
        out[f"{pe}_{lr_hw[0]}x{lr_hw[1]}"] = float(np.abs(out_t - out_j).max()
                                                   / np.abs(out_j).max())
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_pools_rest (JAX_PLATFORMS=cpu): the float32 gap
    import json

    print(json.dumps({"loftup_float32_rel": loftup_float32_gap()}))
