"""Shared-weight parity of the `nn/structures` modules in the port with the JAX package.

`yolo_dbl_tpu/nn/structures/{swin,giraffe,blocks,mobile,mobilenetv3}.py`:
SwinStage, PatchEmbed and PatchMerging; ConvBNAct, RepConvG,
BasicBlock3x3Reverse, CSPStage and GiraffeNeckV2; ExtractLayer; ScConv,
_EffSE, MBConv, EffBlock, _Conv2dBN, _SqueezeExcite, RepVGGDW, RepViTBlock,
UIB, GhostModuleV3, GhostBottleneckV3 and APConvPinwheel; MQA, MFA,
RepGhostModule, RepGhostBottleneck, ReparamLargeKernelConv, RepLKBlock,
GGhostBottleneck and GGhostStage; MNV3SELayer, InvertedResidual and
MobileNetV3. Each case builds the JAX module and its port at 16-64
channels on 5-24 px maps, draws one set of variables with numpy (the bare
leaves too: ScConv's `gn_scale` and `gn_bias`, MFA's `rms_scale`, Swin's
bias table), loads them through the weight bridge, and runs both on the
same input in eval mode and in train mode (one jitted JAX call for both):
the outputs within 1e-4 of the JAX output's largest |value|, and the
BatchNorm statistics a train-mode call leaves within 1e-4 of their largest.
The two MobileNetV3 classifiers have torchvision's parameter counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.nn.structures import blocks as JB
from yolo_dbl_tpu.nn.structures import giraffe as JG
from yolo_dbl_tpu.nn.structures import mobile as JM
from yolo_dbl_tpu.nn.structures import mobilenetv3 as JV3
from yolo_dbl_tpu.nn.structures import swin as JSW

from yolo_dbl_tpu_torch.nn.structures import blocks as TB
from yolo_dbl_tpu_torch.nn.structures import giraffe as TG
from yolo_dbl_tpu_torch.nn.structures import mobile as TM
from yolo_dbl_tpu_torch.nn.structures import mobilenetv3 as TV3
from yolo_dbl_tpu_torch.nn.structures import swin as TSW
from yolo_dbl_tpu_torch.utils.convert import (jax_param_paths, load_jax_variables,
                                              state_dict_from_jax)

from tests.test_torch_modules import jax_tree, to_nchw, to_nhwc
from tests.test_torch_pools_rest import POOL_LEAVES, pool_variables
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

BAR = 1e-4  # of the JAX output's largest |value|
# the structures' bare leaves, drawn with numpy
STRUCTURE_LEAVES = {
    "gn_scale": lambda rng, shape: rng.uniform(0.5, 1.5, shape),
    "gn_bias": lambda rng, shape: rng.normal(0.0, 0.2, shape),
    "rms_scale": lambda rng, shape: rng.uniform(0.5, 1.5, shape),
    "relative_position_bias_table": lambda rng, shape: rng.normal(0.0, 0.5, shape),
}


def structure_variables(shapes, rng):
    """`pool_variables` with the structures' bare leaves drawn too."""
    return pool_variables(shapes, rng, leaves={**POOL_LEAVES, **STRUCTURE_LEAVES})


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def _takes_train(module):
    import inspect

    return "train" in inspect.signature(type(module).__call__).parameters


def run_both_modes(jax_module, torch_module, xs, seed=0):
    """The JAX module (one jitted call: eval, then train with its updated
    batch_stats) and the port on the NHWC input (or list of inputs) `xs`
    with shared variables: {"eval": (JAX, port), "train": (JAX, port),
    "stats": [(name, JAX, port)]}, outputs in NHWC."""
    as_list = isinstance(xs, list)
    jin = [jnp.asarray(x) for x in xs] if as_list else jnp.asarray(xs)
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jin)
    variables = structure_variables(shapes, np.random.default_rng(seed))
    train_kw = _takes_train(jax_module)

    def both(v, x):
        out_eval = jax_module.apply(v, x)
        if "batch_stats" not in v:
            return out_eval, jax_module.apply(v, x, **({"train": True} if train_kw else {})), {}
        out_train, mut = jax_module.apply(v, x, train=True, mutable=["batch_stats"])
        return out_eval, out_train, mut["batch_stats"]

    out_j, train_j, stats_j = jax.tree_util.tree_map(
        np.asarray, jax.jit(both)(jax_tree(variables), jin))
    load_jax_variables(torch_module, variables)
    tin = [to_nchw(x) for x in xs] if as_list else to_nchw(xs)

    def nhwc(out):
        return [to_nhwc(o) for o in out] if isinstance(out, (list, tuple)) else (
            out.detach().numpy() if out.dim() == 2 else to_nhwc(out))

    with torch.no_grad():
        out_t = nhwc(torch_module.eval()(tin))
        train_t = nhwc(torch_module.train()(tin))
    own = torch_module.state_dict()
    stats = [(k, v.numpy(), own[k].numpy())
             for k, v in state_dict_from_jax({"batch_stats": stats_j}).items()] if stats_j else []
    return {"eval": (out_j, out_t), "train": (train_j, train_t), "stats": stats}


def assert_close(got, want, bar=BAR):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, bar)
        return
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bar * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# {case: (JAX module, port module, NHWC input shape or list of shapes)}
CASES = {
    # Swin: 12x12 pads to 15 and shifts (window 5); 9x11 pads both sides, 5x5 shifts
    # not (min(h, w) > ws fails)
    "SwinStage_pad_shift": (lambda: JSW.SwinStage(32, 32, 2, 2, 5),
                            lambda: TSW.SwinStage(32, 32, 2, 2, 5), (2, 12, 12, 32)),
    "SwinStage_odd": (lambda: JSW.SwinStage(16, 16, 3, 2, 4),
                      lambda: TSW.SwinStage(16, 16, 3, 2, 4), (2, 9, 11, 16)),
    "SwinStage_no_shift": (lambda: JSW.SwinStage(16, 16, 2, 1, 5),
                           lambda: TSW.SwinStage(16, 16, 2, 1, 5), (2, 5, 5, 16)),
    "PatchEmbed_pad": (lambda: JSW.PatchEmbed(32, 4), lambda: TSW.PatchEmbed(3, 32, 4),
                       (2, 22, 19, 3)),
    "PatchMerging_odd": (lambda: JSW.PatchMerging(16, 32), lambda: TSW.PatchMerging(16, 32),
                         (2, 9, 7, 16)),
    # Giraffe
    "ConvBNAct_s2": (lambda: JG.ConvBNAct(32, 3, 2), lambda: TG.ConvBNAct(16, 32, 3, 2),
                     (2, 11, 10, 16)),
    "RepConvG_identity": (lambda: JG.RepConvG(16), lambda: TG.RepConvG(16, 16), (2, 8, 10, 16)),
    "RepConvG_widen": (lambda: JG.RepConvG(32, act="lrelu"),
                       lambda: TG.RepConvG(16, 32, act="lrelu"), (2, 8, 10, 16)),
    "BasicBlock3x3Reverse": (lambda: JG.BasicBlock3x3Reverse(0.75, 32),
                             lambda: TG.BasicBlock3x3Reverse(32, 0.75, 32), (2, 8, 10, 32)),
    "CSPStage_spp": (lambda: JG.CSPStage(0.75, 32, 3, spp=True),
                     lambda: TG.CSPStage(24, 0.75, 32, 3, spp=True), (2, 10, 9, 24)),
    "GiraffeNeckV2": (lambda: JG.GiraffeNeckV2((16, 24, 32), (32, 48, 64), 0.34, 0.75),
                      lambda: TG.GiraffeNeckV2((16, 24, 32), (16, 24, 32), (32, 48, 64), 0.34,
                                               0.75),
                      [(2, 16, 16, 16), (2, 8, 8, 24), (2, 4, 4, 32)]),
    "ExtractLayer": (lambda: JB.ExtractLayer(1), lambda: TB.ExtractLayer(1),
                     [(2, 8, 8, 16), (2, 4, 4, 24)]),
    # blocks
    "ScConv": (lambda: JB.ScConv(32), lambda: TB.ScConv(32), (2, 10, 12, 32)),
    "ScConv_alpha": (lambda: JB.ScConv(48, group_num=8, alpha=0.25, group_size=3),
                     lambda: TB.ScConv(48, group_num=8, alpha=0.25, group_size=3),
                     (2, 9, 11, 48)),
    "EffSE": (lambda: JB._EffSE(16, 64), lambda: TB._EffSE(16, 64), (2, 8, 10, 64)),
    "MBConv_se_s2": (lambda: JB.MBConv(32, 2, 2.5, True), lambda: TB.MBConv(16, 32, 2, 2.5, True),
                     (2, 11, 10, 16)),
    "MBConv_fused_identity": (lambda: JB.MBConv(16, 1, 3.0), lambda: TB.MBConv(16, 16, 1, 3.0),
                              (2, 8, 10, 16)),
    "EffBlock_n2_se": (lambda: JB.EffBlock(32, 2, 2, 4, 1), lambda: TB.EffBlock(16, 32, 2, 2, 4, 1),
                       (2, 12, 10, 16)),
    "Conv2dBN_zero_scale": (lambda: JB._Conv2dBN(32, 3, 2, 1, bn_weight_init=0.0),
                            lambda: TB._Conv2dBN(16, 32, 3, 2, 1, bn_weight_init=0.0),
                            (2, 9, 10, 16)),
    "SqueezeExcite": (lambda: JB._SqueezeExcite(), lambda: TB._SqueezeExcite(32), (2, 8, 8, 32)),
    "RepVGGDW": (lambda: JB.RepVGGDW(), lambda: TB.RepVGGDW(32), (2, 8, 10, 32)),
    "RepViTBlock_s1": (lambda: JB.RepViTBlock(64, 32), lambda: TB.RepViTBlock(32, 64, 32),
                       (2, 8, 10, 32)),
    "RepViTBlock_s2_no_se": (lambda: JB.RepViTBlock(64, 48, 3, 2, False),
                             lambda: TB.RepViTBlock(32, 64, 48, 3, 2, False), (2, 9, 10, 32)),
    "UIB_start_middle_s2": (lambda: JB.UIB(32, 3, 5, True, 2, 2.0),
                            lambda: TB.UIB(16, 32, 3, 5, True, 2, 2.0), (2, 11, 10, 16)),
    "UIB_start_only_s2": (lambda: JB.UIB(32, 5, 0, False, 2),
                          lambda: TB.UIB(16, 32, 5, 0, False, 2), (2, 10, 11, 16)),
    "UIB_identity": (lambda: JB.UIB(16), lambda: TB.UIB(16, 16), (2, 8, 10, 16)),
    "GhostModuleV3_k3": (lambda: JB.GhostModuleV3(32, 3, 1),
                         lambda: TB.GhostModuleV3(16, 32, 3, 1), (2, 8, 10, 16)),
    "GhostModuleV3_skip": (lambda: JB.GhostModuleV3(32, relu=False),
                           lambda: TB.GhostModuleV3(16, 32, relu=False), (2, 8, 10, 16)),
    "GhostBottleneckV3_s2_se": (lambda: JB.GhostBottleneckV3(32, 48, stride=2, se_ratio=0.25),
                                lambda: TB.GhostBottleneckV3(16, 32, 48, stride=2, se_ratio=0.25),
                                (2, 12, 10, 16)),
    "GhostBottleneckV3_identity": (lambda: JB.GhostBottleneckV3(16, 32),
                                   lambda: TB.GhostBottleneckV3(16, 16, 32), (2, 8, 10, 16)),
    "APConv": (lambda: JB.APConvPinwheel(32), lambda: TB.APConvPinwheel(16, 32), (2, 8, 10, 16)),
    "APConv_s2_k5": (lambda: JB.APConvPinwheel(32, 5, 2),
                     lambda: TB.APConvPinwheel(16, 32, 5, 2), (2, 11, 10, 16)),
    # mobile
    "MQA": (lambda: JM.MQA(32, 2, 16), lambda: TM.MQA(32, 2, 16), (2, 8, 10, 32)),
    "MQA_strided": (lambda: JM.MQA(32, 4, 16, 16, 2, 2, 2),
                    lambda: TM.MQA(32, 4, 16, 16, 2, 2, 2), (2, 11, 9, 32)),
    "MFA": (lambda: JM.MFA(32, 6), lambda: TM.MFA((16, 24), 32, 6),
            [(2, 12, 12, 16), (2, 5, 5, 24)]),
    "RepGhostModule_s2": (lambda: JM.RepGhostModule(32, 3, stride=2),
                          lambda: TM.RepGhostModule(16, 32, 3, stride=2), (2, 11, 10, 16)),
    "RepGhostBottleneck_s2_se": (lambda: JM.RepGhostBottleneck(48, 32, stride=2, se_ratio=0.25),
                                 lambda: TM.RepGhostBottleneck(16, 48, 32, stride=2,
                                                               se_ratio=0.25), (2, 12, 10, 16)),
    "RepGhostBottleneck_identity": (lambda: JM.RepGhostBottleneck(32, 16),
                                    lambda: TM.RepGhostBottleneck(16, 32, 16), (2, 8, 10, 16)),
    "ReparamLargeKernelConv": (lambda: JM.ReparamLargeKernelConv(32, 7, 2, 32, 3),
                               lambda: TM.ReparamLargeKernelConv(32, 32, 7, 2, 32, 3),
                               (2, 11, 10, 32)),
    "RepLKBlock_k31": (lambda: JM.RepLKBlock(32), lambda: TM.RepLKBlock(32, 32), (2, 12, 10, 32)),
    "RepLKBlock_widen": (lambda: JM.RepLKBlock(32, 9, 3), lambda: TM.RepLKBlock(16, 32, 9, 3),
                         (2, 8, 10, 16)),
    "GGhostBottleneck_s2": (lambda: JM.GGhostBottleneck(32, 2, 16),
                            lambda: TM.GGhostBottleneck(16, 32, 2, 16), (2, 10, 11, 16)),
    "GGhostStage": (lambda: JM.GGhostStage(64, 4, 2, 16),
                    lambda: TM.GGhostStage(32, 64, 4, 2, 16), (2, 12, 10, 32)),
    # mobilenetv3
    "MNV3SELayer": (lambda: JV3.MNV3SELayer(40), lambda: TV3.MNV3SELayer(40), (2, 8, 8, 40)),
    "InvertedResidual_expand_se_hs": (lambda: JV3.InvertedResidual(64, 24, 5, 2, True, True),
                                      lambda: TV3.InvertedResidual(16, 64, 24, 5, 2, True, True),
                                      (2, 11, 10, 16)),
    "InvertedResidual_no_expand": (lambda: JV3.InvertedResidual(16, 16, 3, 1, True, False),
                                   lambda: TV3.InvertedResidual(16, 16, 16, 3, 1, True, False),
                                   (2, 8, 10, 16)),
    "MobileNetV3_small_64px": (lambda: JV3.mobilenetv3_small(), lambda: TV3.mobilenetv3_small(),
                               (2, 64, 64, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_structure_module_parity(case):
    make_j, make_t, shape = CASES[case]
    xs = [_input(s, seed=i + 1) for i, s in enumerate(shape)] if isinstance(shape, list) \
        else _input(shape)
    res = run_both_modes(make_j(), make_t(), xs)
    for mode in ("eval", "train"):
        want, got = res[mode]
        assert_close(got, want)
    for name, want, got in res["stats"]:
        assert float(np.abs(got - want).max()) <= BAR * max(float(np.abs(want).max()), 1.0), name


def test_mobilenetv3_parameter_counts():
    """torchvision's counts (tests/test_structures.py holds JAX's to them)."""
    assert sum(p.numel() for p in TV3.mobilenetv3_large().parameters()) == 5_483_032
    assert sum(p.numel() for p in TV3.mobilenetv3_small().parameters()) == 2_542_856


def test_bridge_names_the_structures_bare_leaves():
    """ScConv's `gn_scale`, `gn_bias` and MFA's `rms_scale` map both ways:
    JAX path → parameter and parameter → JAX path, copied as they are."""
    paths = {**jax_param_paths(TB.ScConv(32)), **jax_param_paths(TM.MFA((16,), 32))}
    assert paths["gn_scale"] == "gn_scale" and paths["gn_bias"] == "gn_bias"
    assert paths["rms_scale"] == "rms_scale"
    tm = TB.ScConv(32)
    shapes = jax.eval_shape(JB.ScConv(32).init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 32)))
    variables = structure_variables(shapes, np.random.default_rng(0))
    load_jax_variables(tm, variables)
    np.testing.assert_array_equal(tm.gn_scale.detach().numpy(), variables["params"]["gn_scale"])
