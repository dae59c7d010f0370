"""Shared-weight parity of the module catalogue's modules in the port with the JAX package.

The attention modules of `yolo_dbl_tpu/nn/attention/{pooling,channel,
spatial,bigarch}.py`, Swin's window attention (`nn/structures/swin.py`),
EUCB, MEUM and ResBlock_CBAM (`nn/upsample/misc.py`) and
`ops/resample.py` `bilinear_upsample`. Each case builds the JAX module and
its port at 16-64 channels on 8-20 px maps, draws one set of variables
with numpy (the catalogue's own leaves too: BoTAttention's position
tables, AxialAttention's `relative`, FusedKQnA's queries, scales and bias
table, the Swin bias table, ECALayer_ns's taps), loads them through the
weight bridge, and compares the eval-mode outputs on the same input in
float32: max |Δ| ≤ 1e-4 of the JAX output's largest |value|.

The cases hold what parts the frameworks: AxialAttention's embedding
resized up and down (jax.image.resize antialiases a shrink), BiFormer's
top-k on tied region scores (index order), ResBlock_CBAM's "SAME" padding
at stride 2 on an even size, DAttention's offsets leaving the map before
the clip, and DAttention's gradient (input and parameters) against
`jax.grad` in float64 on both sides, through K2's plain backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.nn import attention as JA
from yolo_dbl_tpu.nn.attention import pooling as JP
from yolo_dbl_tpu.nn.structures import swin as JSW
from yolo_dbl_tpu.nn.upsample import misc as JM
from yolo_dbl_tpu.ops import resample as JR

from yolo_dbl_tpu_torch.nn.attention import bigarch as TBA
from yolo_dbl_tpu_torch.nn.attention import channel as TC
from yolo_dbl_tpu_torch.nn.attention import pooling as TP
from yolo_dbl_tpu_torch.nn.attention import spatial as TSP
from yolo_dbl_tpu_torch.nn.structures import swin as TSW
from yolo_dbl_tpu_torch.nn.upsample import misc as TM
from yolo_dbl_tpu_torch.ops import resample as TR
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables, params_from_jax

from tests.test_torch_modules import jax_tree, random_variables, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

BAR = 1e-4  # of the JAX output's largest |value|
# the catalogue's own leaves, drawn with numpy
CATALOGUE_LEAVES = {
    "rel_height": lambda rng, shape: rng.normal(0.0, 0.25, shape),
    "rel_width": lambda rng, shape: rng.normal(0.0, 0.25, shape),
    "relative": lambda rng, shape: rng.normal(0.0, 1.0, shape),
    "q_param": lambda rng, shape: rng.normal(0.0, 0.3, shape),
    "attn_scale": lambda rng, shape: rng.normal(0.0, 0.5, shape),
    "rpb_table": lambda rng, shape: rng.normal(0.0, 0.5, shape),
    "relative_position_bias_table": lambda rng, shape: rng.normal(0.0, 0.5, shape),
    "conv": lambda rng, shape: rng.normal(0.0, 0.5, shape),
}


def catalogue_variables(shapes, rng, scale=None):
    """`random_variables` with the catalogue's own leaves drawn too;
    `scale`: {leaf path suffix: factor} for kernels drawn larger."""

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in CATALOGUE_LEAVES:
            return CATALOGUE_LEAVES[name](rng, leaf.shape).astype(np.float32)
        value = random_variables({name: leaf}, rng)[name]
        keys = "/".join(str(p.key) for p in path)
        for suffix, factor in (scale or {}).items():
            if keys.endswith(suffix):
                value = value * factor
        return value

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def run(jax_module, torch_module, x, seed=0, scale=None):
    """Both modules applied to the NHWC input `x` with shared variables:
    (JAX output (jitted), port output in NHWC, the variables)."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = catalogue_variables(shapes, np.random.default_rng(seed), scale)
    out_j = np.asarray(jax.jit(jax_module.apply)(jax_tree(variables), jnp.asarray(x)))
    load_jax_variables(torch_module, variables)
    torch_module.eval()
    with torch.no_grad():
        out_t = to_nhwc(torch_module(to_nchw(x)))
    return out_j, out_t, variables


def assert_close(got, want, bar=BAR):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bar * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# {case: (JAX module, port module, NHWC input shape)}
CASES = {
    "SELayer": (lambda: JA.SELayer(32), lambda: TC.SELayer(32), (2, 8, 8, 32)),
    "ECALayer": (lambda: JA.ECALayer(32), lambda: TC.ECALayer(32), (2, 8, 8, 32)),
    "ECALayer_k5": (lambda: JA.ECALayer(32, 5), lambda: TC.ECALayer(32, 5), (2, 8, 9, 32)),
    "CBAM": (lambda: JA.CBAM(32), lambda: TC.CBAM(32), (2, 9, 10, 32)),
    "SimAM": (lambda: JA.SimAM(16), lambda: TC.SimAM(16), (2, 8, 8, 16)),
    "EMA": (lambda: JA.EMA(32, factor=8), lambda: TC.EMA(32, factor=8), (2, 8, 10, 32)),
    "CoordAttention": (lambda: JA.CoordAttention(32, 32), lambda: TC.CoordAttention(32, 32),
                       (2, 8, 10, 32)),
    "GAM": (lambda: JA.GAM(32, 32), lambda: TC.GAM(32, 32), (2, 8, 8, 32)),
    "TripletAttention": (lambda: JA.TripletAttention(16), lambda: TC.TripletAttention(16),
                         (2, 8, 10, 16)),
    "TripletAttention_no_spatial": (lambda: JA.TripletAttention(16, spatial=False),
                                    lambda: TC.TripletAttention(16, spatial=False),
                                    (2, 8, 10, 16)),
    "MLCA": (lambda: JA.MLCA(32), lambda: TC.MLCA(32), (2, 10, 12, 32)),
    "ELA": (lambda: JA.ELA(32), lambda: TC.ELA(32), (2, 8, 10, 32)),
    "BAM": (lambda: JA.BAM(32), lambda: TC.BAM(32), (2, 10, 10, 32)),
    "CoTNetLayer": (lambda: JA.CoTNetLayer(16), lambda: TC.CoTNetLayer(16), (2, 8, 8, 16)),
    "ECALayer_ns": (lambda: JA.ECALayer_ns(32), lambda: TC.ECALayer_ns(32), (2, 8, 8, 32)),
    "EfficientAttention": (lambda: JA.EfficientAttention(32, key_channels=32, head_count=8),
                           lambda: TSP.EfficientAttention(32, key_channels=32, head_count=8),
                           (2, 8, 8, 32)),
    "HiLo_padded": (lambda: JA.HiLo(32, num_heads=4), lambda: TSP.HiLo(32, num_heads=4),
                    (2, 9, 10, 32)),
    "HiLo_ws1": (lambda: JA.HiLo(32, num_heads=4, window_size=1),
                 lambda: TSP.HiLo(32, num_heads=4, window_size=1), (2, 8, 8, 32)),
    "FullyAttentionalBlock": (lambda: JA.FullyAttentionalBlock(16),
                              lambda: TSP.FullyAttentionalBlock(16), (2, 8, 10, 16)),
    "NonLocalBlock2D_odd": (lambda: JA.NonLocalBlock2D(32), lambda: TSP.NonLocalBlock2D(32),
                            (2, 9, 11, 32)),
    "MHSA": (lambda: JA.MHSA(32, num_heads=4), lambda: TSP.MHSA(32, num_heads=4), (2, 8, 8, 32)),
    "MHSA_proj": (lambda: JA.MHSA(16, 32, num_heads=4), lambda: TSP.MHSA(16, 32, num_heads=4),
                  (2, 8, 6, 16)),
    "BoTAttention": (lambda: JA.BoTAttention(32, heads=4, dim_head=16),
                     lambda: TSP.BoTAttention(32, heads=4, dim_head=16, size=(8, 10)),
                     (2, 8, 10, 32)),
    "EdgeAwareAttention": (lambda: JA.EdgeAwareAttention(32), lambda: TSP.EdgeAwareAttention(32),
                           (2, 8, 8, 32)),
    # L 16 and 12 against kernel 8 and 16: resized up, and down (antialiased)
    "AxialBlock_L_above_kernel": (lambda: JA.AxialBlock(16, kernel_size=8),
                                  lambda: TBA.AxialBlock(32, 16, kernel_size=8), (2, 16, 16, 32)),
    "AxialBlock_L_below_kernel": (lambda: JA.AxialBlock(16, kernel_size=16),
                                  lambda: TBA.AxialBlock(32, 16, kernel_size=16), (2, 12, 10, 32)),
    "AxialBlock_dynamic_both": (lambda: JA.AxialBlock_dynamic(16, groups=2, kernel_size=12),
                                lambda: TBA.AxialBlock_dynamic(24, 16, groups=2, kernel_size=12),
                                (2, 8, 16, 24)),
    "AxialBlock_wopos": (lambda: JA.AxialBlock_wopos(16, groups=2, kernel_size=8),
                         lambda: TBA.AxialBlock_wopos(32, 16, groups=2, kernel_size=8),
                         (2, 8, 10, 32)),
    "ShiftWindowAttention": (lambda: JA.ShiftWindowAttention(32, heads=4, window_size=4,
                                                             shift_size=2),
                             lambda: TBA.ShiftWindowAttention(32, heads=4, window_size=4,
                                                              shift_size=2), (2, 10, 12, 32)),
    "FusedKQnA": (lambda: JA.FusedKQnA(n_q=2, n_channels=32, n_heads=4),
                  lambda: TBA.FusedKQnA(n_q=2, n_channels=32, n_heads=4), (2, 8, 8, 32)),
    "BiFormerNCHW_padded": (lambda: JA.BiFormerNCHW(32, num_heads=4, n_win=4, topk=3),
                            lambda: TBA.BiFormerNCHW(32, num_heads=4, n_win=4, topk=3),
                            (2, 10, 14, 32)),
    "DAttention": (lambda: JA.DAttention(32, n_heads=4), lambda: TBA.DAttention(32, n_heads=4),
                   (2, 16, 12, 32)),
    "DAT": (lambda: JA.DAT(32, num_heads=4), lambda: TBA.DAT(32, num_heads=4), (2, 12, 12, 32)),
    "DeBiAttentionBlock": (lambda: JA.DeBiAttentionBlock(32, num_heads=4, n_win=4),
                           lambda: TBA.DeBiAttentionBlock(32, num_heads=4, n_win=4),
                           (2, 12, 12, 32)),
    "DeBiAttention_YOLO_proj": (lambda: JA.DeBiAttention_YOLO(16, 32, num_heads=4, n_win=4),
                                lambda: TBA.DeBiAttention_YOLO(16, 32, num_heads=4, n_win=4),
                                (2, 12, 12, 16)),
    "SwinTransformer": (lambda: JA.SwinTransformer(16, 32, num_heads=4, window_size=4),
                        lambda: TBA.SwinTransformer(16, 32, num_heads=4, window_size=4),
                        (2, 10, 12, 16)),
    "SwinTransformerBlock_shifted": (lambda: JSW.SwinTransformerBlock(32, 4, 4, 2),
                                     lambda: TSW.SwinTransformerBlock(32, 4, 4, 2),
                                     (2, 8, 12, 32)),
    "EUCB": (lambda: JM.EUCB(16), lambda: TM.EUCB(16), (2, 8, 8, 16)),
    "EUCB_out": (lambda: JM.EUCB(16, 32), lambda: TM.EUCB(16, 32), (2, 6, 8, 16)),
    "MEUM": (lambda: JM.MEUM(16), lambda: TM.MEUM(16), (2, 8, 10, 16)),
    # flax "SAME" at stride 2 on an even size pads (0, 1)
    "ResBlock_CBAM_stride2_even": (lambda: JM.ResBlock_CBAM(16, 32, stride=2),
                                   lambda: TM.ResBlock_CBAM(16, 32, stride=2), (2, 8, 10, 16)),
    "ResBlock_CBAM_stride2_odd": (lambda: JM.ResBlock_CBAM(16, 16, stride=2),
                                  lambda: TM.ResBlock_CBAM(16, 16, stride=2), (2, 9, 9, 16)),
    "ResBlock_CBAM": (lambda: JM.ResBlock_CBAM(16, 16), lambda: TM.ResBlock_CBAM(16, 16),
                      (2, 8, 8, 16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_catalogue_module_parity(case):
    make_j, make_t, shape = CASES[case]
    out_j, out_t, _ = run(make_j(), make_t(), _input(shape))
    assert_close(out_t, out_j)


def test_resblock_cbam_same_padding_is_not_symmetric():
    """At stride 2 on an 8x10 map the 3x3 conv pads (0, 1), as flax's
    "SAME": torch's symmetric padding 1 gives the same 4x5 shape and other
    values, so the parity case above tells the two apart."""
    x = to_nchw(_input((2, 8, 10, 32)))
    tm = TM.ResBlock_CBAM(16, 32, stride=2)
    torch.nn.init.normal_(tm.b1_conv.weight)
    with torch.no_grad():
        same = torch.nn.functional.conv2d(TM.same_pad(x, 3, 2), tm.b1_conv.weight, None, 2)
        symmetric = torch.nn.functional.conv2d(x, tm.b1_conv.weight, None, 2, 1)
    assert same.shape == symmetric.shape == (2, 32, 4, 5)
    assert float((same - symmetric).abs().max()) > 1e-1
    assert TM.same_pad(x, 3, 1).shape[2:] == (10, 12)


@pytest.mark.parametrize("shape,out_hw", [((2, 10, 12, 8), (5, 5)), ((2, 5, 5, 8), (10, 12)),
                                          ((2, 7, 9, 8), (3, 4))])
def test_adaptive_avg_pool_matches_jax(shape, out_hw):
    """torch's bin edges, down and up (MLCA un-pools 5x5 to the map)."""
    x = _input(shape)
    want = np.asarray(JP.adaptive_avg_pool2d(jnp.asarray(x), out_hw))
    got = TP.adaptive_avg_pool2d(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(TP.adaptive_avg_pool_h(torch.from_numpy(x)).numpy(),
                               np.asarray(JP.adaptive_avg_pool_h(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(TP.adaptive_avg_pool_w(torch.from_numpy(x)).numpy(),
                               np.asarray(JP.adaptive_avg_pool_w(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
def test_bilinear_upsample_matches_jax(align_corners):
    x = _input((2, 5, 7, 8))
    want = np.asarray(JR.bilinear_upsample(jnp.asarray(x), 2, align_corners=align_corners))
    got = TR.bilinear_upsample(torch.from_numpy(x), 2, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("length", [5, 12, 24])
def test_axial_embedding_resize_matches_jax_image_resize(length):
    """The (2gp, K, K) embedding at K = 12 resized to L: jax.image.resize
    'linear' against F.interpolate (antialiased below K)."""
    rel = _input((8, 23))
    ta = TBA.AxialAttention(8, 8, groups=2, kernel_size=12)
    ta.relative.data = torch.from_numpy(rel)
    emb = rel[:, ta.index.numpy()]
    want = np.asarray(jax.image.resize(jnp.asarray(emb), (8, length, length), "linear"))
    got = ta.embedding(length).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_biformer_tied_region_scores_route_in_index_order():
    """Every region holds the same pattern, so all region scores tie: top-k
    takes the lowest region indices (lax.top_k's order), and the outputs
    agree."""
    block = _input((1, 3, 3, 32), seed=4)
    x = np.tile(block, (2, 4, 4, 1))  # 12x12, n_win 4: 16 identical 3x3 regions
    jm = JA.BiFormerNCHW(32, num_heads=4, n_win=4, topk=3)
    tm = TBA.BiFormerNCHW(32, num_heads=4, n_win=4, topk=3)
    out_j, out_t, _ = run(jm, tm, x)
    assert_close(out_t, out_j)
    with torch.no_grad():
        qkv = tm.qkv_linear(to_nchw(x)).permute(0, 2, 3, 1)
        mask = tm.region_mask(*qkv.split(32, -1)[:2])
    assert mask[:, :, :3].all() and not mask[:, :, 3:].any()


def _dattention_grid_unclipped(tm, x):
    """The sample points before the clip, from the port's layers."""
    with torch.no_grad():
        q = tm.proj_q(x)
        b, c, h, w = q.shape
        off = tm.off_dw(q.reshape(b * 2, c // 2, h, w))
        off = torch.nn.functional.gelu(
            torch.nn.functional.layer_norm(off.permute(0, 2, 3, 1), (c // 2,), tm.off_ln.weight,
                                           tm.off_ln.bias, 1e-5), approximate="tanh")
        off = tm.off_pw(off.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        hk, wk = off.shape[1:3]
        off = torch.tanh(off) * torch.tensor([1.0 / hk, 1.0 / wk]) * 2.0
        ref_y = (torch.arange(hk) + 0.5) / hk * 2 - 1
        ref_x = (torch.arange(wk) + 0.5) / wk * 2 - 1
        gy, gx = torch.meshgrid(ref_y, ref_x, indexing="ij")
        return torch.stack([gx, gy], -1)[None] + off.flip(-1)


def test_dattention_offsets_leave_the_map_before_the_clip():
    """Offset kernels drawn 20x larger saturate the tanh: points of the
    edge rows and columns leave [-1, 1] and are clipped there (border
    sampling of the clipped point), as in JAX."""
    x = _input((2, 12, 16, 32))
    tm = TBA.DAttention(32, n_heads=4)
    out_j, out_t, _ = run(JA.DAttention(32, n_heads=4), tm, x, scale={"off_pw/conv/kernel": 20.0})
    assert_close(out_t, out_j)
    grid = _dattention_grid_unclipped(tm, to_nchw(x))
    outside = (grid.abs() > 1).any(-1).float().mean()
    assert 0.05 < float(outside) < 0.6


def test_dattention_gradient_matches_jax_in_float64():
    """d(sum(out · r))/d(x, every parameter) of DAttention in float64 on both
    sides: JAX's jax.grad, the port's autograd through K2's plain backward
    (kernels/sampling.py `sample_bilinear_plain` on the CPU); max |Δ| ≤
    1e-9 of each gradient's largest, plus 1e-12 of the largest of all (the
    keys' bias has an exact gradient of 0: softmax ignores a shift common
    to a query's scores)."""
    x = _input((2, 12, 16, 32)).astype(np.float64)
    r = _input((2, 12, 16, 32), seed=7).astype(np.float64)
    jm = JA.DAttention(32, n_heads=4, dtype=jnp.float64)
    tm = TBA.DAttention(32, n_heads=4).double()
    with jax.enable_x64(True):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
        variables = catalogue_variables(shapes, np.random.default_rng(0),
                                        {"off_pw/conv/kernel": 5.0})
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
    for name, p in tm.named_parameters():
        w = want[name]
        assert np.abs(p.grad.numpy() - w).max() <= 1e-9 * np.abs(w).max() + floor, name
