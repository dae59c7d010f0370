"""The rest of the YOLOv13/DBL family in the port against the JAX package, on the CPU.

Modules, with variables drawn by numpy and carried by utils/convert.py
(tests/test_torch_modules.py `run_pair`): GhostConv, GhostBottleneck at
s=1 and s=2, C3Ghost (eval, and train with its BatchNorm statistics
updated), HyperACE2, `_unfold_patches`, DLU and each CARAFE variant (the
official-style ones also in train mode, for their flax BatchNorms), SLA's
core and SLA with non-zero `proj_l` and `out_proj` under each feature map.
Bar: 1e-4 absolute and relative (float32 sums of up to a few hundred terms
in another order).

SLA's block top-k is discrete: a near-tie between the k-th and (k+1)-th
block scores moves a whole key block between the branches. Each SLA case
asserts that every row's gap there is at least 1e-3 of the scores' scale,
far above float32 rounding: on the shared inputs of the core, and on the
port's own q and k in the module (which agree with JAX's to ~1e-6).

Configs: every scale's rows of all seven YAMLs are JAX's; at nc=80 and a
small scale (each YAML's first, n) the parameter counts equal JAX's, and
the forward, decode and NMS at 64 px match JAX at the repo's bar (raw maps
1e-4, boxes < 0.05 px, scores <= 1e-3, equal kept counts). DBL2 has only
the l and x scales, so a scale dict {"n": [0.5, 0.25, 1024]} is injected
into both sides. One train-mode loss and gradient of DBL2 at that scale,
dropout off on both sides, in float64 on both (the test says why and
gives its bars); and the train step over the rows of two YAMLs that the
loss does not reach.
"""

import functools
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.losses import detection as JD
from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn.attention import sla as JS
from yolo_dbl_tpu.nn.heads import decode_detections as jax_decode
from yolo_dbl_tpu.nn.tasks import YOLOModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from yolo_dbl_tpu.nn.upsample import carafe as JU
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.engine.trainer import Trainer, train_loss
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.nn.attention import sla as TS
from yolo_dbl_tpu_torch.nn.upsample import carafe as TU
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.convert import (load_jax_variables, params_from_jax,
                                              state_dict_from_jax)

from tests.test_torch_modules import (_input, jax_tree, random_variables, run_pair, to_nchw,
                                      to_nhwc)
from tests.test_torch_train import _NoDropout, _train_batches
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
ATOL = RTOL = 1e-4
NC, IMGSZ = 3, 64
SMALL = {"n": [0.5, 0.25, 1024]}  # injected into DBL2, which has only l and x
FAMILY = ("yolov13_DBL2", "yolov13_edit9", "yolov13_edit10", "yolov13_v3edit5_attn",
          "yolov13_v3edit5_attn2", "yolov13_v3edit6", "yolov13_edit_template")


def _close(out_t, out_j):
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- modules


MODULE_CASES = {
    "GhostConv_k3": (lambda: JB.GhostConv(16, 3), lambda: TB.GhostConv(8, 16, 3), (2, 9, 9, 8)),
    "GhostConv_s2_g2": (lambda: JB.GhostConv(16, 3, 2, 2), lambda: TB.GhostConv(8, 16, 3, 2, 2),
                        (2, 10, 10, 8)),
    "GhostBottleneck_s1": (lambda: JB.GhostBottleneck(16), lambda: TB.GhostBottleneck(16, 16),
                           (2, 8, 8, 16)),
    "GhostBottleneck_s2": (lambda: JB.GhostBottleneck(32, 3, 2),
                           lambda: TB.GhostBottleneck(16, 32, 3, 2), (2, 9, 8, 16)),
    "C3Ghost": (lambda: JB.C3Ghost(32, 2), lambda: TB.C3Ghost(16, 32, 2), (2, 8, 8, 16)),
    "DLU": (lambda: JU.DLU(16), lambda: TU.DLU(16), (2, 6, 5, 16)),
    "CARAFE": (lambda: JU.CARAFE(16), lambda: TU.CARAFE(16), (2, 6, 5, 16)),
    "CARAFE_c2_k5": (lambda: JU.CARAFE(16, 24, 5), lambda: TU.CARAFE(16, 24, 5), (1, 7, 6, 16)),
    "CARAFE_XiaLiPKU": (lambda: JU.CARAFE_XiaLiPKU(16, 8), lambda: TU.CARAFE_XiaLiPKU(16, 8),
                        (2, 5, 6, 16)),
    "CARAFE_simplified": (lambda: JU.CARAFE_simplified(16, c_mid=8),
                          lambda: TU.CARAFE_simplified(16, c_mid=8), (2, 5, 6, 16)),
    "CARAFEPack_groups": (lambda: JU.CARAFEPack(16, up_group=2, compressed_channels=8),
                          lambda: TU.CARAFEPack(16, up_group=2, compressed_channels=8),
                          (2, 5, 6, 16)),
}


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_family_module_parity(case):
    make_j, make_t, shape = MODULE_CASES[case]
    out_j, out_t = run_pair(make_j(), make_t(), _input(shape, seed=2))
    _close(out_t, out_j)


TRAIN_CASES = {
    "C3Ghost": (lambda: JB.C3Ghost(32, 2), lambda: TB.C3Ghost(16, 32, 2), (2, 8, 8, 16)),
    "DLU": (lambda: JU.DLU(16, 8), lambda: TU.DLU(16, 8), (2, 6, 5, 16)),
    "CARAFE_XiaLiPKU": (lambda: JU.CARAFE_XiaLiPKU(16, 8), lambda: TU.CARAFE_XiaLiPKU(16, 8),
                        (2, 5, 6, 16)),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_family_module_train_mode_and_batch_stats(case):
    """Train mode: batch statistics, and the running statistics moved as
    flax moves them (Conv's BatchNorm: momentum 0.97, eps 1e-3; the direct
    flax BatchNorms of the CARAFE body: 0.99, 1e-5)."""
    make_j, make_t, shape = TRAIN_CASES[case]
    jm, tm, x = make_j(), make_t(), _input(shape, seed=3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(4))
    out_j, mut = jm.apply(jax_tree(variables), jnp.asarray(x), train=True, mutable=["batch_stats"])
    load_jax_variables(tm, variables)
    tm.train()
    _close(tm(to_nchw(x)), out_j)
    stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                       mut["batch_stats"])})
    own = tm.state_dict()
    assert len(stats) >= 2
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


def test_hyperace2_parity():
    """HyperACE2 over a 3-level pyramid: FuseModule2's conv takes the
    concat's width (flax reads it; the port gets it from the model)."""
    xs = [_input((2, 8, 8, 32), 5), _input((2, 4, 4, 32), 6), _input((2, 2, 2, 48), 7)]
    jm = JB.HyperACE2(32, 64, 1, 4, True, True, 0.5, 1, "both")
    tm = TB.HyperACE2(32, 64, 1, 4, True, True, 0.5, 1, "both", c_cat=32 + 32 + 48)
    out_j, out_t = run_pair(jm, tm, xs)
    _close(out_t, out_j)


@pytest.mark.parametrize("k,d", [(3, 1), (5, 2)])
def test_unfold_patches_matches_jax(k, d):
    x = _input((2, 7, 6, 5), seed=8)
    want = np.asarray(JU._unfold_patches(jnp.asarray(x), k, d))
    got = TU._unfold_patches(torch.from_numpy(x), k, d).numpy()
    assert got.shape == want.shape == (2, 7, 6, 5, k * k)
    np.testing.assert_array_equal(got, want)


def _topk_gap(score, topk):
    """The smallest gap, over rows, between the k-th and (k+1)-th block
    scores, over the scores' scale."""
    top = torch.as_tensor(np.asarray(score)).topk(topk + 1, -1).values
    return float((top[..., topk - 1] - top[..., topk]).min() / top.abs().max())


def _sla_qk(seed, l=60, d=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, 2, l, d)).astype(np.float32) for _ in range(3)]


# (seed, topk ratio, block): L = 60 tokens in blocks of 8 (a ragged last
# block); each seed's top-k gap is at least 1e-3 of the scores' scale
SLA_CORE_CASES = {"top2_of_8": (11, 0.25, 8), "top3_of_8": (12, 0.4, 8), "top1_of_4": (13, 0.3, 16)}


@pytest.mark.parametrize("case", sorted(SLA_CORE_CASES))
def test_sparse_linear_attention_matches_jax(case):
    seed, ratio, blk = SLA_CORE_CASES[case]
    q, k, v = _sla_qk(seed)
    cq, ck = (jax.nn.softmax(jnp.asarray(t), -1) for t in (q, k))
    want = JS.sparse_linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cq, ck,
                                      ratio, blk, blk)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    mask, score = TS.block_mask(tq, tk, ratio, blk, blk)
    n_blocks = score.shape[-1]
    topk = max(1, min(n_blocks, int(ratio * n_blocks)))
    assert _topk_gap(score, topk) > 1e-3
    assert int(mask.sum(-1).min()) == int(mask.sum(-1).max()) == topk < n_blocks
    got = TS.sparse_linear_attention(tq, tk, tv, tq.softmax(-1), tk.softmax(-1), ratio, blk, blk)
    for g, w in zip(got, want):
        assert float(np.abs(np.asarray(w)).max()) > 0.1  # both branches carry weight
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("feature_map", ["softmax", "elu", "relu"])
def test_sla_module_with_nonzero_projections(feature_map):
    """SLA at 8x10 tokens (80, blocks of 16: 5 blocks, top 2) with random,
    non-zero proj_l and out_proj on both sides (zero at init, where the
    block is inert and parity would prove nothing)."""
    x = _input((2, 8, 10, 32), seed=21)
    jm = JS.SLA(32, num_heads=4, topk=0.4, feature_map=feature_map, blkq=16, blkk=16)
    tm = TS.SLA(32, num_heads=4, topk=0.4, feature_map=feature_map, blkq=16, blkk=16)
    out_j, out_t = run_pair(jm, tm, x, seed=22)
    assert tm.out_proj.weight.detach().abs().min() > 0 and tm.proj_l.weight.detach().abs().min() > 0
    # the top-k margin on the port's own q, k (the JAX side's are equal to 1e-5)
    with torch.no_grad():
        qkv = tm.qkv_proj(to_nchw(x)).flatten(2).transpose(1, 2)
        q, k, _ = (t.reshape(2, 80, 4, 8).transpose(1, 2) for t in qkv.split(32, -1))
        mask, score = TS.block_mask(q, k, 0.4, 16, 16)
    assert _topk_gap(score, 2) > 1e-3 and int(mask.sum(-1).max()) == 2
    assert float(np.abs(np.asarray(out_j)).max()) > 0.1
    _close(out_t, out_j)


def test_sla_starts_inert_in_the_model():
    """DetectionModel's init zeroes proj_l and out_proj, as flax's zeros
    initialisers do: the block outputs 0 until trained."""
    tm = DetectionModel("yolov13_v3edit5_attn.yaml", nc=NC, device="cpu")
    slas = [m for m in tm.modules() if isinstance(m, TS.SLA)]
    assert [m.head_dim for m in slas] == [16, 32, 64]
    for m in slas:
        assert not m.out_proj.weight.any() and not m.proj_l.weight.any()
        assert m.qkv_proj.conv.weight.abs().max() > 0
        with torch.no_grad():
            assert not m(torch.randn(1, m.out_proj.in_channels, 4, 4)).any()


# ---------------------------------------------------------------- configs


def _jax_dict(name, scales=None):
    d = jax_yaml_model_load(f"{name}.yaml")
    return d | ({"scales": scales} if scales else {})


def _port_dict(name, scales=None):
    d = T.yaml_model_load(f"{name}.yaml")
    return d | ({"scales": scales} if scales else {})


@pytest.mark.parametrize("name", FAMILY)
def test_family_yaml_copies_and_rows(name):
    """The port's YAML copy is byte for byte JAX's, reads as PyYAML reads it,
    and every scale's rows are JAX's; a name without a scale letter takes
    the first scale, as with JAX's guess_model_scale."""
    port = REPO / f"yolo_dbl_tpu_torch/cfg/models/v13/{name}.yaml"
    ref = REPO / f"yolo_dbl_tpu/cfg/models/v13/{name}.yaml"
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(ref.read_text())
    scales = yaml.safe_load(ref.read_text())["scales"]
    for scale in (*scales, ""):
        scaled = name.replace("yolov13", f"yolov13{scale}")
        spec_j = jax_parse_model_spec(jax_yaml_model_load(f"{scaled}.yaml") | {"nc": 80})
        spec_t = T.parse_model_spec(T.yaml_model_load(f"{scaled}.yaml") | {"nc": 80})
        assert spec_t.scale == spec_j.scale == (scale or next(iter(scales)))
        assert [(l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
            [(l.name, l.args, l.c2, l.n) for l in spec_j.layers]


def test_dbl2_l_params_and_rows():
    """DBL2 at l and nc=80: 26,846,723 parameters on both sides
    (tests/test_model.py's golden 26,846,739 less the 16 of the folded DFL
    conv); row 25, [13, 1, DSC3k2, [256, 1, 1]], an integer dsc3k and e=1."""
    spec = jax_parse_model_spec(jax_yaml_model_load("yolov13l_DBL2.yaml") | {"nc": 80})
    shapes = jax.eval_shape(YOLOModel(spec).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"])) == \
        26_846_723
    tm = DetectionModel("yolov13l_DBL2.yaml", nc=80, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 26_846_723
    assert tm.spec.layers[25].args == [512, 256, 1, 1, 1] == spec.layers[25].args
    assert tm.strides == (8, 16, 32)
    dys = [m for m in tm.modules() if isinstance(m, TB.DySample)]
    assert [m.offset.conv.in_channels // m.groups for m in dys] == [128, 256, 128]


@functools.cache
def _models(name):
    """The JAX spec and the port model of `name` at nc=80 and a small scale
    (the YAML's first, n; DBL2 the injected one), built once for the file."""
    scales = SMALL if name == "yolov13_DBL2" else None
    return (jax_parse_model_spec(_jax_dict(name, scales) | {"nc": 80}),
            DetectionModel(_port_dict(name, scales), nc=80, device="cpu"))


def _family_pair(name):
    """JAX and the port on 64 px inputs from the same perturbed variables
    (Detect class biases 0, so NMS has candidates at conf 0.25): the
    parameter counts, the JAX raw maps and decode, and the port model. JAX
    decodes at the port's strides: the raw maps' shapes, compared in the
    test, are what fixes them."""
    spec, tm = _models(name)
    module = YOLOModel(spec)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(1))
    head = variables["params"][f"m{len(spec.layers) - 1}"]
    for sub in head:
        if sub.startswith("cv3_") and sub.endswith("_2"):
            head[sub]["conv"]["bias"][:] = 0.0
    run = jax.jit(lambda v, img: (lambda f: (f, jax_decode(f, tm.strides, 80)))(
        module.apply(v, img)))
    feats, pred = run(jax_tree(variables), jnp.asarray(x))
    assert [l.args for l in tm.spec.layers] == [l.args for l in spec.layers]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    load_jax_variables(tm, variables)
    return tm, x, [np.asarray(f) for f in feats], np.asarray(pred)


@pytest.mark.parametrize("name", FAMILY)
def test_family_params_forward_decode_nms_parity(name):
    tm, x, feats_j, pred_j = _family_pair(name)
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
    for a, b in zip(feats_t, feats_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0)
    pred_t = tm.predict(torch.from_numpy(x)).numpy()
    anchors = sum((IMGSZ // s) ** 2 for s in tm.strides)
    assert pred_t.shape == pred_j.shape == (2, 4 + 80, anchors)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    _, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    _, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


# leaves whose exact gradient is 0: the hyperedge generators' pre_head_proj
# bias shifts every node's logit alike before a softmax over nodes; the
# BatchNorm bias of a GhostBottleneck's gc2.cv2 adds a per-channel constant
# that reaches only 1x1 convs and then train-mode BatchNorms, which remove it
ZERO_GRADIENT_LEAVES = ("edge_generator.pre_head_proj.bias", "gc2.cv2.bn.bias")


def test_dbl2_train_step_loss_gradients_and_batch_stats_match_jax():
    """One train-mode loss and gradient of DBL2 at the injected n scale
    (nc=80), 64 px, batch 2, and the BatchNorm statistics it leaves, dropout
    off on both sides (the hyperedge generators' rate 0.1 draws different
    bits in each). Both sides run in float64 (JAX's model with dtype float64
    under `jax.enable_x64`; a `.double()` copy of the port's), so the check
    reads the function and not float32's conditioning: at 64 px the P5 maps
    are 2x2 and the largest |g| is ~1e3, and float32 reads a cancelling sum
    such as a FullPAD gate's gradient poorly on either side (a P5 gate's
    two float32 readings part by 1.7e-3 of its largest). JAX's loss casts
    the maps to float32 (yolo_dbl_tpu/losses/detection.py:87), so the bars
    are those of tests/test_torch_v13.py's float64 test: gradients within
    1e-5 of each leaf's largest plus 1e-12 of the model's, loss items 1e-6
    relative, statistics 1e-6; an exact-zero leaf under 1e-12 of the
    model's largest on both sides."""
    _, tm = _models("yolov13_DBL2")
    batch = _train_batches(1, seed=31)[0]
    cfg = get_cfg()
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        module = YOLOModel(jax_parse_model_spec(_jax_dict("yolov13_DBL2", SMALL) | {"nc": 80}),
                           dtype=jnp.float64)
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, IMGSZ, IMGSZ, 3), jnp.float64))
        variables = random_variables(shapes, np.random.default_rng(32))
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(params, batch_stats, b):
            outs, mut = module.apply({"params": params, "batch_stats": batch_stats},
                                     jax_device_normalize(b["img"], jnp.float64), train=True,
                                     mutable=["batch_stats"])
            total, items = JD.detection_loss(outs, b, tm.strides, 80, box_gain=cfg.box,
                                             cls_gain=cfg.cls, dfl_gain=cfg.dfl)
            return total, (items, mut["batch_stats"])

        (loss_j, (items_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jv["params"], jv["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()})
        grads_j, stats_j = jax.tree_util.tree_map(np.asarray, (grads_j, stats_j))

    load_jax_variables(tm, variables)
    m64 = tm.double()
    dropouts = [m for m in m64.modules() if isinstance(m, torch.nn.Dropout)]
    assert len(dropouts) == 2  # HyperACE branch1, branch2
    for m in dropouts:
        m.p = 0.0
    b64 = {k: torch.as_tensor(v) for k, v in batch.items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in b64.items()}
    names, params = zip(*m64.named_parameters())
    try:
        loss_t, items_t = train_loss(m64, cfg, b64)
        grads_t = dict(zip(names, torch.autograd.grad(loss_t, params)))
        own = {k: v.clone() for k, v in m64.state_dict().items()}
    finally:
        tm.float()  # the shared model goes back to float32

    assert float(items_j.box) > 0
    for a, b in zip((loss_t, *items_t), (loss_j, *items_j)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-6)
    gj = params_from_jax(tm, grads_j)
    assert set(gj) == set(grads_t)
    g_max = max(float(g.abs().max()) for g in gj.values())
    zero = [n for n in grads_t if n.endswith(ZERO_GRADIENT_LEAVES)]
    assert len(zero) == 2 + 4 + 1  # the two hyperedge generators; m9's and m33's GhostBottlenecks
    for n, g in grads_t.items():
        if n in zero:
            assert max(float(g.abs().max()), float(gj[n].abs().max())) < 1e-12 * g_max, n
            continue
        ref = gj[n].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, err_msg=n,
                                   atol=1e-5 * np.abs(ref).max() + 1e-12 * g_max)
    ghost = [n for n in grads_t if ".m_0.gc1." in n]
    assert ghost and all(float(grads_t[n].abs().max()) > 0 for n in ghost)
    stats = state_dict_from_jax({"batch_stats": stats_j})
    assert len(stats) > 100
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,unreached", [
    ("yolov13_v3edit5_attn", ("m16.gate", "m24.cv1.", "m24.cv2.")),
    ("yolov13_v3edit6", ("m12.gate", "m17.conv.", "m17.bn."))])
def test_trainer_steps_over_rows_the_loss_does_not_reach(name, unreached):
    """Two of the authors' YAMLs hold rows whose output no later row reads
    (v3edit5_attn's m24 Bottleneck and the m16 tunnel over it, v3edit6's m17
    Conv and the m12 tunnel over it). jax.grad gives their parameters zero
    gradients; the port's train step hands the optimizer zeros for them too
    (it once raised on them), of each parameter's shape."""
    tm = _models(name)[1]
    trainer = Trainer(tm, {"batch": 2, "imgsz": IMGSZ}).setup(5)
    seen = []
    step = trainer.optimizer.step
    trainer.optimizer.step = lambda grads: seen.append(grads) or step(grads)
    metrics = trainer.step(_train_batches(1, seed=34)[0])
    assert all(np.isfinite(float(v)) for v in metrics.values())
    grads = dict(zip((n for n, _ in tm.named_parameters()), seen[0]))
    dead = sorted(n for n in grads if n.startswith(unreached))
    assert len(dead) >= 3
    for n in dead:
        assert grads[n].shape == tm.get_parameter(n).shape and not grads[n].any(), n
