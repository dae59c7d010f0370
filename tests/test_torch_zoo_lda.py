"""The pools' last YAML rows and LDA-DBL in the port against the JAX package, on the CPU.

The 13 rows (tasks.py:345-410,432-434: ASFF, CPCA, CPCA_YOLO,
EdgeAwareAttentionV2, Outlooker_YOLO, PSAModule, CAA, C2f_PIG, C2f_WT,
CARAFEplusplus, LDA_AQU, GhostModuleV2, GhostBottleneckV2) each in a small
model (Conv, the row, Conv, a one-level Detect; ASFF over three Convs) at
32 px: the port's row table is JAX's, its parameter count is the JAX
model's, and its raw Detect map from the same variables is JAX's within
1e-4 of its largest. ASFF's and a GhostBottleneckV2's output widths are
not their rows' (JAX's table holds its input's width, flax reads the true
one): the next row is built from the true width.

LDA-DBL: yolov13_DBL.yaml with its three DySample rows written as LDA_AQU
(tests/torch_fixtures.py `lda_dbl`), at scale n and 64 px: rows, parameter count,
raw maps, decode (boxes < 0.05 px, scores ≤ 1e-3) and NMS against JAX;
one train-mode loss, gradient and BatchNorm statistics in float64 on both
sides (dropout off), as tests/test_torch_v13_family.py holds DBL2. Then
what is left unported, and the parallel paths' refusals.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.losses import detection as JD
from yolo_dbl_tpu.nn import tasks as JT
from yolo_dbl_tpu.nn.heads import decode_detections as jax_decode
from yolo_dbl_tpu.nn.tasks import YOLOModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.engine.trainer import train_loss
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.nn.upsample.batch3 import LDA_AQU
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.convert import (load_jax_variables, params_from_jax,
                                              state_dict_from_jax)

from tests.test_torch_modules import jax_tree
from tests.test_torch_pools_rest import pool_variables
from tests.test_torch_train import _NoDropout, _train_batches
from tests.torch_fixtures import lda_dbl, one_torch_thread  # noqa: F401 (autouse fixture)

IMGSZ = 32
BAR = 1e-4
# {row name: its YAML args}, after a Conv to 32 channels at 16x16; GhostBottleneckV2's
# second arg is its output width (48), not its row's (32)
ROWS = {
    "EdgeAwareAttentionV2": [32], "Outlooker_YOLO": [32, 3, 4], "PSAModule": [64, [3, 5, 7, 9], 2],
    "CPCA": [32], "CPCA_YOLO": [48], "CAA": [32], "C2f_PIG": [32, 1, True],
    "C2f_WT": [32, 1, True], "CARAFEplusplus": [32], "LDA_AQU": [],
    "GhostModuleV2": [24, 3, 2, 3, 1, True, "attn"], "GhostBottleneckV2": [32, 48],
}


def _yaml(name):
    if name == "ASFF":  # level 1 over P5 (64 wide), P4 (256: its own level), P3 (32)
        return {"nc": 3,
                "backbone": [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [256, 3, 2]],
                             [-1, 1, "Conv", [64, 3, 2]], [[2, 1, 0], 1, "ASFF", [1]],
                             [-1, 1, "Conv", [32, 3, 2]]],
                "head": [[[4], 1, "Detect", ["nc"]]]}
    return {"nc": 3,
            "backbone": [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, name, list(ROWS[name])],
                         [-1, 1, "Conv", [32, 3, 2]]],
            "head": [[[2], 1, "Detect", ["nc"]]]}


def _rows(spec):
    return [(l.f, l.name, l.args, l.c2, l.n) for l in spec.layers]


def _undrawn(cfg, **kw):
    """DetectionModel(cfg, ...) on the CPU without its own draw of the
    weights: every test that reads them loads JAX's first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        return DetectionModel(cfg, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted([*ROWS, "ASFF"]))
def test_pool_row_matches_jax(name):
    """Rows, parameter count and the raw Detect map of the small model at
    32 px, from one set of variables."""
    d = _yaml(name)
    spec_j, spec_t = jax_parse_model_spec(dict(d)), T.parse_model_spec(dict(d))
    assert _rows(spec_t) == _rows(spec_j)
    x = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    module = YOLOModel(spec_j)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = pool_variables(shapes, np.random.default_rng(4))
    tm = _undrawn(dict(d), imgsz=IMGSZ)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes["params"]))
    load_jax_variables(tm, variables)
    want = np.asarray(jax.jit(module.apply)(jax_tree(variables), jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= BAR * float(np.abs(want).max())


def test_rows_after_a_width_changing_row_take_the_true_width():
    """JAX's table gives the Conv after ASFF (expand_c 512) its input P3's
    32 and the Conv after GhostBottleneckV2 [32, 48] its 32; the port keeps
    the table and builds both Convs from the true widths."""
    tm = _undrawn(_yaml("ASFF"), imgsz=IMGSZ)
    assert tm.spec.layers[3].c2 == 32 and tm.spec.layers[4].args[0] == 32
    assert tm.m4.conv.in_channels == 512
    tm = _undrawn(_yaml("GhostBottleneckV2"), imgsz=IMGSZ)
    assert tm.spec.layers[1].c2 == 32 and tm.m2.conv.in_channels == 48


def test_only_structure_rows_and_pconv_stay_unported():
    """Of the 100 names JAX's `_*_BUILDERS` tables take, only PConv
    (deliberately not ported) still raises: the 20 `nn/structures` rows
    (ROADMAP 6.3c-ii) are ported (tests/test_torch_zoo_structures.py)."""
    names = set().union(*(getattr(JT, k) for k in dir(JT)
                          if k.endswith("_BUILDERS") and isinstance(getattr(JT, k), dict)))
    assert len(names) == 100
    raising = set()
    for m in names:
        d = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, m, [32]]], "head": []}
        try:
            T.parse_model_spec(d)
        except NotImplementedError:
            raising.add(m)
        except (TypeError, IndexError):  # a ported row that wants other args than [32]
            pass
    assert raising == {"PConv"}
    assert set(T.POOL_ROWS) == set(ROWS) | {"ASFF"}


@pytest.mark.parametrize("name", ["LDA_AQU", "C2f_PIG", "ASFF"])
def test_pool_rows_refuse_the_parallel_paths(name):
    """The new rows' modules have no tensor- or spatial-parallel form
    (ROADMAP Queue 1 item 7): Dense and LayerNorm layers, global poolings,
    per-pixel softmaxes over taps, wavelet cells, K2's sampling."""
    from types import SimpleNamespace

    from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
    from yolo_dbl_tpu_torch.parallel.spatial import spatial

    two = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)
    tm = _undrawn(_yaml(name), imgsz=IMGSZ)
    with pytest.raises(NotImplementedError, match="item 7"):
        model_parallel_shardings(tm, two)
    with pytest.raises(NotImplementedError, match="item 7"):
        with spatial(tm, two):
            pass


LDA_IMGSZ = 64


def _jax_lda_dict():
    d = jax_yaml_model_load("yolov13n_DBL.yaml")
    for part in ("backbone", "head"):
        d[part] = [[f, n, "LDA_AQU" if m == "DySample" else m, args] for f, n, m, args in d[part]]
    return d


def test_lda_dbl_n_rows_params_forward_decode_nms_match_jax():
    """LDA-DBL-n at nc=3 and 64 px from the same variables (Detect class
    biases 0, so NMS has candidates): the rows (three LDA_AQU where DBL has
    DySample), the parameter count, the raw maps within 1e-4, the decode
    (boxes < 0.05 px, scores ≤ 1e-3) and the kept counts."""
    spec = jax_parse_model_spec(_jax_lda_dict() | {"nc": 3})
    tm = _undrawn(lda_dbl("n"), nc=3, imgsz=LDA_IMGSZ)
    assert _rows(tm.spec) == _rows(spec)
    assert [l.i for l in tm.spec.layers if l.name == "LDA_AQU"] == [13, 18, 22]
    assert sum(isinstance(m, LDA_AQU) for m in tm.modules()) == 3
    module = YOLOModel(spec)
    x = np.random.default_rng(0).uniform(0, 1, (2, LDA_IMGSZ, LDA_IMGSZ, 3)).astype(np.float32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = pool_variables(shapes, np.random.default_rng(1))
    head = variables["params"][f"m{len(spec.layers) - 1}"]
    for sub in head:
        if sub.startswith("cv3_") and sub.endswith("_2"):
            head[sub]["conv"]["bias"][:] = 0.0
    run = jax.jit(lambda v, img: (lambda f: (f, jax_decode(f, tm.strides, 3)))(
        module.apply(v, img)))
    feats_j, pred_j = run(jax_tree(variables), jnp.asarray(x))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    load_jax_variables(tm, variables)
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
    for a, b in zip(feats_t, feats_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BAR * float(np.abs(b).max()),
                                   rtol=0)
    pred_t = tm.predict(torch.from_numpy(x)).numpy()
    pred_j = np.asarray(pred_j)
    anchors = sum((LDA_IMGSZ // s) ** 2 for s in tm.strides)
    assert pred_t.shape == pred_j.shape == (2, 4 + 3, anchors)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    _, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    _, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


# the hyperedge generators' pre_head_proj bias shifts every node's logit alike
# before a softmax over nodes: its exact gradient is 0
ZERO_GRADIENT_LEAVES = ("edge_generator.pre_head_proj.bias",)


def test_lda_dbl_n_train_step_matches_jax_in_float64():
    """One train-mode loss and gradient of LDA-DBL-n (nc=3, 64 px, batch 2)
    and the BatchNorm statistics it leaves, dropout off on both sides, in
    float64 on both (JAX's model with dtype float64 under `jax.enable_x64`,
    a `.double()` copy of the port's through K2's plain backward), at
    tests/test_torch_v13_family.py's bars: gradients within 1e-5 of each
    leaf's largest plus 1e-12 of the model's, loss items 1e-6 relative,
    statistics 1e-6; an exact-zero leaf under 1e-12 of the model's largest
    on both sides. The LDA_AQU leaves (offsets through K2's coordinate
    gradient, keys through its input gradient) get gradients."""
    tm = _undrawn(lda_dbl("n"), nc=3, imgsz=LDA_IMGSZ)
    batch = _train_batches(1, seed=41)[0]
    cfg = get_cfg()
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        module = YOLOModel(jax_parse_model_spec(_jax_lda_dict() | {"nc": 3}), dtype=jnp.float64)
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, LDA_IMGSZ, LDA_IMGSZ, 3), jnp.float64))
        variables = pool_variables(shapes, np.random.default_rng(42))
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(params, batch_stats, b):
            outs, mut = module.apply({"params": params, "batch_stats": batch_stats},
                                     jax_device_normalize(b["img"], jnp.float64), train=True,
                                     mutable=["batch_stats"])
            total, items = JD.detection_loss(outs, b, tm.strides, 3, box_gain=cfg.box,
                                             cls_gain=cfg.cls, dfl_gain=cfg.dfl)
            return total, (items, mut["batch_stats"])

        (loss_j, (items_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jv["params"], jv["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()})
        grads_j, stats_j = jax.tree_util.tree_map(np.asarray, (grads_j, stats_j))

    load_jax_variables(tm, variables)
    m64 = tm.double()
    for m in m64.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    b64 = {k: torch.as_tensor(v) for k, v in batch.items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in b64.items()}
    names, params = zip(*m64.named_parameters())
    loss_t, items_t = train_loss(m64, cfg, b64)
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, params)))
    own = {k: v.clone() for k, v in m64.state_dict().items()}

    assert float(items_j.box) > 0
    for a, b in zip((loss_t, *items_t), (loss_j, *items_j)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-6)
    gj = params_from_jax(tm, grads_j)
    assert set(gj) == set(grads_t)
    g_max = max(float(g.abs().max()) for g in gj.values())
    zero = [n for n in grads_t if n.endswith(ZERO_GRADIENT_LEAVES)]
    assert len(zero) == 2  # the two hyperedge generators
    for n, g in grads_t.items():
        if n in zero:
            assert max(float(g.abs().max()), float(gj[n].abs().max())) < 1e-12 * g_max, n
            continue
        ref = gj[n].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, err_msg=n,
                                   atol=1e-5 * np.abs(ref).max() + 1e-12 * g_max)
    lda = [n for n in grads_t if any(f"m{i}." in n[:5] for i in (13, 18, 22))
           and (".off_pw." in n or ".proj_k." in n or n.endswith(".rpb"))]
    assert len(lda) == 3 * 4 and all(float(grads_t[n].abs().max()) > 0 for n in lda)
    stats = state_dict_from_jax({"batch_stats": stats_j})
    assert len(stats) > 100
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)
