"""Shared-weight parity of the module pools' blocks in the port with the JAX package.

The blocks that FFCA-YOLO{,-L}, YOLO-EMAC, yolo11-C3k2_EFE-IRSTE and
YOLO-World build: SPDConv, EFE and C3k2_EFE, FGM, OmniKernel and
Multibranch, FEM, SCAM, FFM_Concat2/3 (nn/upsample/misc.py); PConv,
FasterBlock and C3_Faster; DyT, WindowMHSA, MBlock, M2C2f and C3k2_EAMC
(nn/upsample/batch3.py); the World blocks (nn/world.py). Each case builds
the JAX module and its port at narrow widths on 8-16 px maps, draws one set
of variables with numpy (every leaf perturbed from its init: the FGM and
DyT scalars, FFM's weights and the contrastive heads' scale and bias too),
loads them through the weight bridge, and compares outputs on the same
input in float32. Tolerance: 1e-4 absolute and relative, float32 sums of up
to a few hundred terms (and FFTs of 12x16 maps) taken in another order by
each framework.

WindowMHSA runs at maps that are not multiples of the window (zero keys
and values in the padding, unmasked, as in JAX); flax's `nn.gelu` is held
to torch's tanh GELU; C3k2_EAMC's 1-D conv across channels is flax's
(k, 3, 1) kernel as Conv1d's (1, 3, k).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn import structures as JS
from yolo_dbl_tpu.nn import world as JW
from yolo_dbl_tpu.nn.upsample import batch3 as J3
from yolo_dbl_tpu.nn.upsample import misc as JM

from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import world as TW
from yolo_dbl_tpu_torch.nn.structures import blocks as TS
from yolo_dbl_tpu_torch.nn.upsample import batch3 as T3
from yolo_dbl_tpu_torch.nn.upsample import misc as TM
from yolo_dbl_tpu_torch.utils.convert import jax_param_paths, load_jax_variables, state_dict_from_jax

from tests.test_torch_modules import jax_tree, random_variables, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-4
# the pools' own leaves, drawn away from their init values (0, 1, -10, ...)
POOL_LEAVES = {
    "alpha": lambda rng, shape: rng.uniform(0.5, 1.5, shape),
    "beta": lambda rng, shape: rng.uniform(-0.5, 0.5, shape),
    "w": lambda rng, shape: rng.uniform(0.5, 1.5, shape),
    "logit_scale": lambda rng, shape: rng.uniform(0.5, 1.5, shape),
}


def pool_variables(shapes, rng):
    """`random_variables` for a JAX variables shape tree, the pools' own
    leaves (POOL_LEAVES) drawn too."""

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in POOL_LEAVES:
            return POOL_LEAVES[name](rng, leaf.shape).astype(np.float32)
        return random_variables({name: leaf}, rng)[name]

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def _text(b, k, c=512, seed=2):
    return np.random.default_rng(seed).normal(0.0, 1.0, (b, k, c)).astype(np.float32)


def run(jax_module, torch_module, jax_args, torch_args, seed=0):
    """Apply both modules with shared random variables; returns (JAX out, port out)."""
    jargs = jax.tree_util.tree_map(jnp.asarray, jax_args)
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *jargs)
    variables = pool_variables(shapes, np.random.default_rng(seed))
    out_j = jax_module.apply(jax_tree(variables), *jargs)
    load_jax_variables(torch_module, variables)
    torch_module.eval()
    with torch.no_grad():
        out_t = torch_module(*torch_args)
    return out_j, out_t


# {case: (JAX module, port module, NHWC input shape)}, one image in, one out
IMAGE_CASES = {
    "SPDConv": (lambda: JM.SPDConv(8, 16), lambda: TM.SPDConv(8, 16), (2, 12, 10, 8)),
    "EFE": (lambda: JM.EFE(8, 16), lambda: TM.EFE(8, 16), (2, 10, 12, 8)),
    "C3k2_EFE": (lambda: JM.C3k2_EFE(32, 2, False, 0.5), lambda: TM.C3k2_EFE(16, 32, 2, False, 0.5),
                 (2, 8, 8, 16)),
    "C3k2_EFE_c3k": (lambda: JM.C3k2_EFE(32, 1, True), lambda: TM.C3k2_EFE(16, 32, 1, True),
                     (2, 8, 10, 16)),
    "FGM_fft": (lambda: JM.FGM(8), lambda: TM.FGM(8), (2, 12, 16, 8)),
    "OmniKernel": (lambda: JM.OmniKernel(8), lambda: TM.OmniKernel(8), (2, 12, 16, 8)),
    "Multibranch": (lambda: JM.Multibranch(32), lambda: TM.Multibranch(32), (2, 10, 12, 32)),
    "FEM": (lambda: JM.FEM(32, 32), lambda: TM.FEM(32, 32), (2, 12, 12, 32)),
    "FEM_c2_24": (lambda: JM.FEM(32, 24), lambda: TM.FEM(32, 24), (2, 16, 16, 32)),
    "SCAM": (lambda: JM.SCAM(16), lambda: TM.SCAM(16), (2, 9, 11, 16)),
    "PConv": (lambda: JS.PConv(16), lambda: TS.PConv(16), (2, 8, 8, 16)),
    "FasterBlock": (lambda: JS.FasterBlock(16, 16), lambda: TS.FasterBlock(16, 16, 16),
                    (2, 8, 8, 16)),
    "C3_Faster": (lambda: JB.C3_Faster(32, 2), lambda: TB.C3_Faster(16, 32, 2), (2, 8, 8, 16)),
    "DyT": (lambda: J3.DyT(16), lambda: T3.DyT(16), (2, 6, 7, 16)),
    "WindowMHSA_ws7_10x10": (lambda: J3.WindowMHSA(32, 1, 7), lambda: T3.WindowMHSA(32, 1, 7),
                             (2, 10, 10, 32)),
    "WindowMHSA_ws3_10x11_heads2": (lambda: J3.WindowMHSA(32, 2, 3),
                                    lambda: T3.WindowMHSA(32, 2, 3), (2, 10, 11, 32)),
    "MBlock": (lambda: J3.MBlock(32, 1), lambda: T3.MBlock(32, 1), (2, 9, 10, 32)),
    "M2C2f_residual": (lambda: J3.M2C2f(64, 1, True, 4), lambda: T3.M2C2f(64, 64, 1, True, 4),
                       (2, 8, 9, 64)),
    "M2C2f_c3k": (lambda: J3.M2C2f(32, 1, False), lambda: T3.M2C2f(16, 32, 1, False),
                  (2, 8, 8, 16)),
    "C3k2_EAMC_conv1d": (lambda: J3.C3k2_EAMC(32, 1, False, 0.25),
                         lambda: T3.C3k2_EAMC(16, 32, 1, False, 0.25), (2, 8, 8, 16)),
    "C3k2_EAMC_c3k_k5": (lambda: J3.C3k2_EAMC(32, 1, True, eca_k=5),
                         lambda: T3.C3k2_EAMC(16, 32, 1, True, eca_k=5), (2, 8, 8, 16)),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_pool_module_parity(case):
    make_j, make_t, shape = IMAGE_CASES[case]
    x = _input(shape)
    out_j, out_t = run(make_j(), make_t(), [x], [to_nchw(x)])
    assert to_nhwc(out_t).shape == np.asarray(out_j).shape
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_in", [2, 3])
def test_ffm_concat_parity(n_in):
    """FFM_Concat2 (c // 2, c // 2) and FFM_Concat3 (c // 4, c // 2, c // 4):
    each input weighted by its slice of the normalized `w`."""
    widths = (8, 8) if n_in == 2 else (4, 8, 4)
    xs = [_input((2, 6, 6, c), seed=i) for i, c in enumerate(widths)]
    jm = JM.FFM_Concat2(1, *widths) if n_in == 2 else JM.FFM_Concat3(1, *widths)
    tm = TM.FFM_Concat2(1, *widths) if n_in == 2 else TM.FFM_Concat3(1, *widths)
    out_j, out_t = run(jm, tm, [xs], [[to_nchw(x) for x in xs]])
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


def test_flax_gelu_is_the_tanh_form():
    """flax's nn.gelu (MBlock's MLP, OmniKernel's input) is torch's tanh
    GELU within float32 rounding; the exact GELU parts from it by more
    than the bars here."""
    x = np.linspace(-6.0, 6.0, 2001, dtype=np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x), approximate="tanh").numpy(), want,
                               atol=1e-6, rtol=0)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_window_padding_is_not_masked():
    """At 10x10 and window 7 the padded positions hold zero keys: the output
    differs from attention with those keys masked out, as JAX's does."""
    tm = T3.WindowMHSA(16, 1, 7).eval()
    x = torch.from_numpy(_input((1, 16, 10, 10)))
    with torch.no_grad():
        full = tm(x)
        tm.window_size = 10  # one window, no padding: the masked result
        masked = tm(x)
    assert float((full - masked).abs().max()) > 1e-3


def test_eamc_reduce_conv_is_flax_1d_conv_across_channels():
    """flax's nn.Conv(1, (k,)) over the (B, C, 3) stack against Conv1d(3, 1, k)
    over (B, 3, C) with the bridged kernel."""
    yv = _input((2, 20, 3))
    conv = fnn.Conv(1, (5,), padding=[(2, 2)], use_bias=False)
    variables = pool_variables(jax.eval_shape(conv.init, jax.random.PRNGKey(0), jnp.asarray(yv)),
                               np.random.default_rng(3))
    want = np.asarray(conv.apply(jax_tree(variables), jnp.asarray(yv)))[..., 0]
    sd = state_dict_from_jax({"params": {"reduce_conv": variables["params"]}})
    t = torch.nn.Conv1d(3, 1, 5, padding=2, bias=False)
    t.weight.data.copy_(sd["reduce_conv.weight"])
    with torch.no_grad():
        got = t(torch.from_numpy(yv).transpose(1, 2))[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- World blocks

# {case: (JAX module, port module, input width)}, an image and a text of 5 prompts in
TEXT_CASES = {
    "MaxSigmoidAttnBlock": (lambda: JW.MaxSigmoidAttnBlock(32, nh=2, ec=32),
                            lambda: TW.MaxSigmoidAttnBlock(32, 32, nh=2, ec=32), 32),
    "MaxSigmoidAttnBlock_ec_conv": (lambda: JW.MaxSigmoidAttnBlock(32, nh=2, ec=32),
                                    lambda: TW.MaxSigmoidAttnBlock(16, 32, nh=2, ec=32), 16),
    "C2fAttn": (lambda: JW.C2fAttn(32, 2, ec=16, nh=2), lambda: TW.C2fAttn(24, 32, 2, ec=16, nh=2),
                24),
}


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_text_guided_block_parity(case):
    make_j, make_t, c = TEXT_CASES[case]
    x, text = _input((2, 8, 9, c)), _text(2, 5)
    out_j, out_t = run(make_j(), make_t(), [x, text], [to_nchw(x), torch.from_numpy(text)])
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


def test_image_pooling_attn_parity():
    """The text updated from three maps pooled 3x3 (adaptive bins of 9, 5
    and 3 rows): LayerNorm then Dense, 8 heads."""
    xs = [_input((2, 9, 10, 16), 1), _input((2, 5, 5, 32), 2), _input((2, 3, 4, 24), 3)]
    text = _text(2, 6)
    out_j, out_t = run(JW.ImagePoolingAttn(ec=32, ch=(16, 32, 24)),
                       TW.ImagePoolingAttn(ec=32, ch=(16, 32, 24)),
                       [xs, text], [[to_nchw(x) for x in xs], torch.from_numpy(text)])
    assert out_t.shape == (2, 6, 512)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_bn", [False, True])
def test_world_detect_parity(with_bn):
    """WorldDetect's maps (box bins, then the K prompts' logits) with the
    ContrastiveHead (l2-normalized) or the BNContrastiveHead."""
    xs = [_input((2, 8, 8, 16), 1), _input((2, 4, 4, 32), 2)]
    text = _text(2, 7, c=64)
    out_j, out_t = run(JW.WorldDetect(nc=7, embed=64, with_bn=with_bn, ch=(16, 32)),
                       TW.WorldDetect(nc=7, embed=64, with_bn=with_bn, ch=(16, 32)),
                       [xs, text], [[to_nchw(x) for x in xs], torch.from_numpy(text)])
    for a, b in zip(out_t, out_j, strict=True):
        assert to_nhwc(a).shape == b.shape and b.shape[-1] == 64 + 7
        np.testing.assert_allclose(to_nhwc(a), np.asarray(b), atol=ATOL, rtol=RTOL)


def test_pool_parameter_paths_round_trip():
    """Every parameter of the new blocks names its JAX path (the optimizer's
    masks read them): a 1-D conv kernel, LayerNorm scales, the copied leaves."""
    tm = torch.nn.ModuleDict({"eamc": T3.C3k2_EAMC(16, 32, 1), "ipa": TW.ImagePoolingAttn(32, (16,)),
                              "dyt": T3.DyT(8), "fgm": TM.FGM(8), "ffm": TM.FFM_Concat2(1, 4, 4),
                              "head": TW.ContrastiveHead(), "bn": TW.BNContrastiveHead(8)})
    paths = jax_param_paths(tm)
    assert paths["eamc.reduce_conv.weight"] == "eamc/reduce_conv/kernel"
    assert paths["ipa.query_0.weight"] == "ipa/query_0/scale"
    assert paths["ipa.query_1.weight"] == "ipa/query_1/kernel"
    for name in ("dyt.alpha", "dyt.beta", "dyt.gamma", "fgm.alpha", "fgm.beta", "ffm.w",
                 "head.logit_scale", "head.bias", "bn.logit_scale"):
        assert paths[name] == name.replace(".", "/")
    with pytest.raises(KeyError, match="no rule"):
        state_dict_from_jax({"params": {"m0": {"unknown_leaf": np.zeros(3, np.float32)}}})


# {rule: (JAX leaf path, its array, port key, the port's array)}: the bridge's rules for the
# pools' leaves, one case each
_K3 = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
BRIDGE_RULES = {
    "kernel_1d": (("m4", "reduce_conv", "kernel"), _K3, "m4.reduce_conv.weight",
                  _K3.transpose(2, 1, 0)),
    "alpha": (("m6", "dyt1", "alpha"), np.full((1,), 0.7, np.float32), "m6.dyt1.alpha", None),
    "beta": (("m6", "fgm", "beta"), np.arange(5, dtype=np.float32), "m6.fgm.beta", None),
    "w": (("m12", "w"), np.arange(6, dtype=np.float32), "m12.w", None),
    "logit_scale": (("m22", "cv4_0", "logit_scale"), np.array(-1.0, np.float32),
                    "m22.cv4_0.logit_scale", None),
    "layer_norm_scale": (("m16", "query_0", "scale"), np.arange(3, dtype=np.float32),
                         "m16.query_0.weight", None),
}


@pytest.mark.parametrize("rule", sorted(BRIDGE_RULES))
def test_weight_bridge_rule(rule):
    """A 1-D conv's (k, in, out) kernel → Conv1d's (out, in, k); a LayerNorm's
    scale → weight; DyT's and FGM's alpha and beta, FFM's w and the scalar
    logit_scale copied as they are."""
    path, arr, key, want = BRIDGE_RULES[rule]
    tree = {}
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = arr
    sd = state_dict_from_jax({"params": tree})
    assert list(sd) == [key]
    np.testing.assert_array_equal(sd[key].numpy(), arr if want is None else want)
    assert sd[key].shape == (arr if want is None else want).shape
