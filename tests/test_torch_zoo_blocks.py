"""The stock detect families' modules in the port against the JAX package, on the CPU.

Modules, with variables drawn by numpy and carried by utils/convert.py
(tests/test_torch_modules.py `run_pair`): C3, C3k2 (both branches), C1,
C2, LightConv, SPP, V10Attention, PSABlock, C2PSA and ConvTranspose2d, in
eval mode and in train mode (batch statistics, and the running statistics
moved as flax moves them). Bar: 1e-4 absolute and relative (float32 sums
of up to a few hundred terms in another order; the softmax of
V10Attention over 20-30 tokens); running statistics 1e-6 absolute, 1e-5
relative.

Also: the weight bridge's transposed-conv rule (a flax ConvTranspose
kernel is flipped in space and laid out (in, out, kh, kw)), which a
c1 == c2 layer would take silently and wrongly under the conv rule;
`jax_param_paths` as the inverse of the bridge over these modules; the
nn.MaxPool2d, nn.ZeroPad2d and nn.Identity rows of the compiler; tensor
and spatial parallelism refusing what they cannot shard yet; and the YAML
`activation:` override against JAX's `default_act_ctx` for each of its
nine names, scoped to the model it was built for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn import common as JC
from yolo_dbl_tpu.nn import v9v10 as JV
from yolo_dbl_tpu.nn.heads import decode_detections as jax_decode
from yolo_dbl_tpu.nn.tasks import YOLOModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import common as TC
from yolo_dbl_tpu_torch.nn import v9v10 as TV
from yolo_dbl_tpu_torch.utils.convert import (jax_param_paths, load_jax_variables,
                                              params_from_jax, state_dict_from_jax)

from tests.test_torch_modules import _input, jax_tree, random_variables, run_pair, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-4


def _close(out_t, out_j):
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


# name: (JAX module, port module, NHWC input shape)
CASES = {
    "C3": (lambda: JB.C3(32, 2), lambda: TB.C3(16, 32, 2), (2, 8, 8, 16)),
    "C3_no_shortcut_e025": (lambda: JB.C3(32, 1, False, 1, 0.25),
                            lambda: TB.C3(16, 32, 1, False, 1, 0.25), (2, 7, 9, 16)),
    "C3k2_c3k": (lambda: JB.C3k2(32, 2, True), lambda: TB.C3k2(16, 32, 2, True), (2, 8, 8, 16)),
    "C3k2_bottleneck_e025": (lambda: JB.C3k2(32, 2, False, 0.25),
                             lambda: TB.C3k2(16, 32, 2, False, 0.25), (2, 8, 8, 16)),
    "C1": (lambda: JB.C1(16, 2), lambda: TB.C1(8, 16, 2), (2, 8, 8, 8)),
    "C2": (lambda: JB.C2(32, 2), lambda: TB.C2(16, 32, 2), (2, 8, 8, 16)),
    "LightConv_k3": (lambda: JB.LightConv(16, 3), lambda: TB.LightConv(8, 16, 3), (2, 8, 8, 8)),
    "SPP": (lambda: JB.SPP(16), lambda: TB.SPP(16, 16), (2, 9, 9, 16)),
    "SPP_k3_k7": (lambda: JB.SPP(24, (3, 7)), lambda: TB.SPP(16, 24, (3, 7)), (2, 8, 10, 16)),
    "V10Attention": (lambda: JV.V10Attention(64, 2), lambda: TV.V10Attention(64, 2),
                     (2, 4, 5, 64)),
    "PSABlock": (lambda: JV.PSABlock(64, 0.5, 1), lambda: TV.PSABlock(64, 0.5, 1), (2, 5, 6, 64)),
    "C2PSA": (lambda: JV.C2PSA(128, 1), lambda: TV.C2PSA(64, 128, 1), (2, 5, 4, 64)),
    "C2PSA_n2_2heads": (lambda: JV.C2PSA(256, 2), lambda: TV.C2PSA(128, 256, 2), (2, 4, 4, 128)),
    "ConvTranspose2d_k2_s2_p0": (lambda: JC.ConvTranspose2d(12, 2, 2, 0),
                                 lambda: TC.ConvTranspose2d(8, 12, 2, 2, 0), (2, 5, 6, 8)),
    "ConvTranspose2d_k2_s2_p1": (lambda: JC.ConvTranspose2d(12, 2, 2, 1),
                                 lambda: TC.ConvTranspose2d(8, 12, 2, 2, 1), (2, 5, 6, 8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_zoo_module_parity(case):
    make_j, make_t, shape = CASES[case]
    out_j, out_t = run_pair(make_j(), make_t(), _input(shape, seed=2))
    assert to_nhwc(out_t).shape == np.asarray(out_j).shape
    _close(out_t, out_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zoo_module_train_mode_and_batch_stats(case):
    """Train mode: batch statistics in every Conv's BatchNorm, and the
    running statistics moved as flax moves them (momentum 0.97, eps 1e-3).
    ConvTranspose2d has no BatchNorm: its train mode is its eval mode."""
    make_j, make_t, shape = CASES[case]
    jm, tm, x = make_j(), make_t(), _input(shape, seed=3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(4))
    out_j, mut = jm.apply(jax_tree(variables), jnp.asarray(x), train=True, mutable=["batch_stats"])
    load_jax_variables(tm, variables)
    tm.train()
    with torch.no_grad():
        _close(tm(to_nchw(x)), out_j)
    stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mut.get("batch_stats", {}))})
    own = tm.state_dict()
    assert len(stats) >= (0 if case.startswith("ConvTranspose") else 2)
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------- weight bridge


def test_bridge_loads_a_square_transposed_conv_flipped():
    """yolov6's ConvTranspose2d rows have c1 == c2 ([256, 2, 2, 0] after a
    Conv of 256): a flax kernel (kh, kw, 8, 8) fits the conv rule's
    transpose(3, 2, 0, 1) too, so that rule would load it without an error
    and compute another function. The bridge flips it and lays it out (in,
    out, kh, kw); the old rule's output is far from JAX's at the same
    weights (so this test tells the two apart)."""
    x = _input((2, 5, 6, 8), seed=5)
    jm, tm = JC.ConvTranspose2d(8, 2, 2, 0), TC.ConvTranspose2d(8, 8, 2, 2, 0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(6))
    kernel = variables["params"]["conv"]["kernel"]
    assert kernel.shape == (2, 2, 8, 8)
    assert tuple(tm.conv.weight.shape) == kernel.transpose(3, 2, 0, 1).shape == (8, 8, 2, 2)
    want = np.asarray(jm.apply(jax_tree(variables), jnp.asarray(x)))
    load_jax_variables(tm, variables)
    np.testing.assert_array_equal(tm.conv.weight.detach().numpy(),
                                  kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    with torch.no_grad():
        got = to_nhwc(tm(to_nchw(x)))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        tm.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        old = to_nhwc(tm(to_nchw(x)))
    assert np.abs(old - want).max() > 0.5
    # params_from_jax (the trees of gradients and EMA) takes the same rule
    mapped = params_from_jax(tm, variables["params"])
    np.testing.assert_array_equal(mapped["conv.weight"].numpy(),
                                  kernel[::-1, ::-1].transpose(2, 3, 0, 1))


class _Stack(torch.nn.Module):
    """A ConvTranspose2d and a C2PSA under flax-style names."""

    def __init__(self):
        super().__init__()
        self.m0 = TC.ConvTranspose2d(64, 64, 2, 2, 0)
        self.m1 = TV.C2PSA(64, 64, 1)


def test_jax_param_paths_inverts_the_bridge():
    """Every parameter's JAX path names the JAX leaf the bridge maps onto
    it, over a ConvTranspose2d and a C2PSA (conv kernels, BatchNorm scales
    and biases, the transposed kernel and its bias): each JAX leaf is
    filled with its own constant, which the bridge's transposes and flips
    keep."""
    import flax.linen as fnn

    class Pair(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            x = JC.ConvTranspose2d(64, 2, 2, 0, name="m0")(x)
            return JV.C2PSA(64, 1, name="m1")(x, train)

    shapes = jax.eval_shape(Pair().init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 64)))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes["params"])
    fill = {"/".join(str(k.key) for k in p): float(i + 1) for i, (p, _) in enumerate(leaves)}
    params = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    tm = _Stack()
    paths = jax_param_paths(tm)
    assert sorted(paths.values()) == sorted(fill)
    assert paths["m0.conv.weight"] == "m0/conv/kernel" and paths["m0.conv.bias"] == "m0/conv/bias"
    for name, value in params_from_jax(tm, params).items():
        assert bool((value == fill[paths[name]]).all()), name


# ---------------------------------------------------------------- compiler rows

ROWS_YAML = {
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "nn.ZeroPad2d", [[0, 1, 0, 1]]],
                 [-1, 1, "nn.MaxPool2d", [2, 1, 0]],
                 [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "nn.MaxPool2d", [3, 2, 1]],
                 [-1, 1, "nn.Identity", []],
                 [-1, 1, "nn.ZeroPad2d", [[1, 0, 0, 1]]],
                 [-1, 1, "nn.MaxPool2d", [2]]],
    "head": [[-1, 1, "Conv", [32, 1, 1]],
             [[4, 8], 1, "Detect", ["nc"]]],
}


def test_maxpool_zeropad_identity_rows_match_jax():
    """The parameter-free torch rows (tasks.py:277-278, :743-753): MaxPool2d's
    defaults (stride k, padding 0), its -inf padding, ZeroPad2d's (left,
    right, top, bottom) order, Identity; the two levels' raw maps at 64 px."""
    spec = jax_parse_model_spec(dict(ROWS_YAML))
    tm = DetectionModel(dict(ROWS_YAML), device="cpu")
    assert [(l.name, l.c2) for l in tm.spec.layers] == [(l.name, l.c2) for l in spec.layers]
    x = np.random.default_rng(9).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    module = YOLOModel(spec)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(10))
    feats_j = module.apply(jax_tree(variables), jnp.asarray(x))
    load_jax_variables(tm, variables)
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
    # 64 → 32 (conv) → 33 → 32 (pad, pool k2 s1) → 16 (conv) → 8 (pool k3 s2 p1)
    # → 9x9 (pad left 1, bottom 1) → 4 (pool k2, stride 2)
    assert [tuple(f.shape[1:3]) for f in feats_t] == [(8, 8), (4, 4)]
    assert tm.strides == (8, 16)
    for a, b in zip(feats_t, feats_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_decode(feats_j, tm.strides, 3)), atol=ATOL, rtol=0)


def test_tp_and_sp_refuse_the_layers_they_cannot_shard_yet():
    """Tensor parallelism raises on a transposed conv, whose (in, out, kh,
    kw) weight the conv rule would shard on the wrong axis (one model rank
    replicates it), and spatial parallelism on the torch pooling and
    padding rows, which have no halo exchange yet."""
    from types import SimpleNamespace

    from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
    from yolo_dbl_tpu_torch.parallel.spatial import spatial

    two = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)
    with pytest.raises(NotImplementedError, match="m0.conv.*item 7"):
        model_parallel_shardings(_Stack(), two)
    one = model_parallel_shardings(_Stack(), SimpleNamespace(shape={"data": 2, "model": 1}))
    assert one and set(one.values()) == {()}
    with pytest.raises(NotImplementedError, match="nn.MaxPool2d, nn.ZeroPad2d"):
        with spatial(DetectionModel(dict(ROWS_YAML), device="cpu"), two):
            pass


# ---------------------------------------------------------------- activation override

ACT_NAMES = ("nn.SiLU()", "nn.ReLU()", "nn.ReLU6()", "nn.LeakyReLU()", "nn.LeakyReLU(0.1)",
             "nn.GELU()", "nn.Hardswish()", "nn.Mish()", "nn.Identity()")


def test_activation_names_are_jax_names():
    assert set(TC._ACT_NAMES) == set(JC._ACT_NAMES) == set(ACT_NAMES)
    with pytest.raises(ValueError, match="unsupported activation"):
        TC.resolve_act("nn.Tanh()")
    with pytest.raises(ValueError, match="unsupported activation"):
        JC.resolve_act("nn.Tanh()")


@pytest.mark.parametrize("name", ACT_NAMES)
def test_activation_override_matches_jax(name):
    """A Conv and a DWConv built with act=True inside `default_act(name)`
    against JAX's under `default_act_ctx(resolve_act(name))`; a DSConv keeps
    its SiLU on both sides. Inputs of scale 3, so every activation's
    negative and saturating ranges are reached (ReLU6 above 6, Hardswish
    below -3)."""
    x = _input((2, 6, 6, 8), seed=11) * 3.0
    pairs = {"Conv": (lambda: JC.Conv(16, 3), lambda: TC.Conv(8, 16, 3)),
             "DWConv": (lambda: JC.DWConv(8, 3), lambda: TC.DWConv(8, 8, 3)),
             "DSConv": (lambda: JC.DSConv(16, 3), lambda: TC.DSConv(8, 16, 3))}
    for kind, (make_j, make_t) in pairs.items():
        with TC.default_act(name):
            tm = make_t()
        jm = make_j()
        with JC.default_act_ctx(JC.resolve_act(name)):
            out_j, out_t = run_pair(jm, tm, x, seed=12)
        _close(out_t, out_j)
        if kind == "DSConv":
            with JC.default_act_ctx(None):
                out_silu, _ = run_pair(jm, TC.DSConv(8, 16, 3), x, seed=12)
            np.testing.assert_array_equal(np.asarray(out_j), np.asarray(out_silu))
    # the override ends with its block
    assert isinstance(TC.Conv(8, 8).act, torch.nn.SiLU)


def test_activation_override_is_scoped_to_its_model():
    """yolov6 sets `activation: nn.ReLU()`: every Conv of yolov6n and of its
    Detect head takes ReLU; yolov8n built after it in the same process keeps
    SiLU, as JAX scopes the override to its own model's trace."""
    v6 = DetectionModel("yolov6n.yaml", nc=3, device="cpu")
    v8 = DetectionModel("yolov8n.yaml", nc=3, device="cpu")

    def acts(m):
        return {type(c.act).__name__ for c in m.modules() if isinstance(c, (TC.Conv, TC.DWConv))}

    assert v6.yaml["activation"] == "nn.ReLU()"
    assert acts(v6) == {"ReLU"} and {type(c.act).__name__ for c in v6.detect.modules()
                                     if isinstance(c, TC.Conv)} == {"ReLU"}
    assert acts(v8) == {"SiLU"}
