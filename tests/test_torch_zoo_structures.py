"""The `nn/structures` YAML rows and Swin-T-Giraffe in the port against the JAX package, on the CPU.

The 20 rows (tasks.py:419-455: GiraffeNeckV2, PatchEmbed, SwinStage,
PatchMerging, ExtractLayer, Index, UIB, MQA, MFA, RepViTBlock,
GhostModuleV3, GhostBottleneckV3, RepGhostBottleneck, RepLKBlock,
GGhostBottleneck, GGhostStage, EffBlock, MBConv, ScConv, APConv) each in a
small model at 64 px: the port's row table is JAX's, its parameter count
is the JAX model's, and its Detect maps have the shapes JAX's
`eval_shape` gives. A RepViTBlock's, a RepGhostBottleneck's and an MFA's
output widths are not their rows' (JAX's table holds another, flax reads
the true one): the next row is built from the true width.

Swin-T-Giraffe (tests/torch_fixtures.py `swin_giraffe`) at its published
widths has JAX's 49,430,595 parameters at nc = 3. Narrowed (C = 16,
depths 2-2-2-2, heads 1-2-2-4, window 5, neck 32-48-64 at depth 1/3) at
96 px, where stages 1-3 pad to the window and shift and stage 4 pads
alone: the rows, the parameter count, the raw maps (1e-4 of the largest),
the decode (boxes < 0.05 px, scores ≤ 1e-3) and NMS against JAX, and one
train-mode loss, gradient and BatchNorm statistics in float64 on both
sides at tests/test_torch_zoo_lda.py's bars. JAX's float64 model is the
reference for the port's float32 serving too: one JAX compile serves both
(`jax_swin`). Then what is left unported, and the parallel paths' refusals.
"""

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
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.engine.trainer import train_loss
from yolo_dbl_tpu_torch.nn import structures as S
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.convert import (load_jax_variables, params_from_jax,
                                              state_dict_from_jax)

from tests.test_torch_structures import structure_variables
from tests.torch_fixtures import one_torch_thread, swin_giraffe  # noqa: F401 (autouse fixture)

ROW_IMGSZ = 64
# {row name: its YAML args}, after a Conv to 16 channels at 32x32; the first
# width of RepViTBlock [64, 16] and RepGhostBottleneck [48, 32] is not their
# output's
ROWS = {
    "PatchEmbed": [32, 4], "SwinStage": [16, 2, 2, 4], "PatchMerging": [32], "UIB": [32],
    "MQA": [0, 2, 16], "RepViTBlock": [64, 16], "GhostModuleV3": [32],
    "GhostBottleneckV3": [32, 48], "RepGhostBottleneck": [48, 32], "RepLKBlock": [32, 7, 3],
    "GGhostBottleneck": [32, 2, 16], "GGhostStage": [64, 3, 2, 16], "EffBlock": [32, 2, 4, 1],
    "MBConv": [32, 2, 4.0, 1], "ScConv": [], "APConv": [32, 3, 2],
}
# rows that read a list: the neck, its levels (ExtractLayer, Index) and MFA
LIST_ROWS = ("GiraffeNeckV2", "ExtractLayer", "Index", "MFA")


def _yaml(name):
    if name in LIST_ROWS:  # P3-P5 at 16, 8, 4 px from Convs of 24, 32, 48
        convs = [[-1, 1, "Conv", [c, 3, 2]] for c in (16, 24, 32, 48)]
        if name == "MFA":  # MFA's 40 channels, where JAX's table holds its last input's 48
            return {"nc": 3, "backbone": convs + [[[1, 2, 3], 1, "MFA", [0, 40, 8]],
                                                  [-1, 1, "Conv", [32, 3, 2]]],
                    "head": [[[5], 1, "Detect", ["nc"]]]}
        return {"nc": 3, "backbone": convs + [
            [[1, 2, 3], 1, "GiraffeNeckV2", [[16, 32, 64], 0.34, 0.75]],
            [4, 1, "ExtractLayer", [0]], [4, 1, "Index", [32, 1]], [4, 1, "ExtractLayer", [2]]],
            "head": [[[5, 6, 7], 1, "Detect", ["nc"]]]}
    n = 2 if name == "EffBlock" else 1
    return {"nc": 3,
            "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, n, name, list(ROWS[name])],
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


def _head_widths(model):
    return tuple(getattr(model.detect, f"cv2_{i}_0").conv.in_channels
                 for i in range(model.detect.nl))


def _jax_count(shapes):
    return sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", sorted([*ROWS, "GiraffeNeckV2", "MFA"]))
def test_structure_row_matches_jax(name):
    """Rows, parameter count and the Detect maps' shapes of the small model
    at 64 px (JAX's by `eval_shape`; the port's from a forward of seeded
    weights, finite)."""
    d = _yaml(name)
    spec_j, spec_t = jax_parse_model_spec(dict(d)), T.parse_model_spec(dict(d))
    assert _rows(spec_t) == _rows(spec_j)
    x = jnp.zeros((2, ROW_IMGSZ, ROW_IMGSZ, 3))
    module = YOLOModel(spec_j)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    want = jax.eval_shape(module.apply, shapes, x)
    tm = DetectionModel(dict(d), device="cpu", imgsz=ROW_IMGSZ)
    assert sum(p.numel() for p in tm.parameters()) == _jax_count(shapes)
    with torch.no_grad():
        got = tm(torch.rand((2, ROW_IMGSZ, ROW_IMGSZ, 3),
                            generator=torch.Generator().manual_seed(0)))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_rows_after_a_width_changing_row_take_the_true_width():
    """JAX's table gives RepViTBlock [64, 16] the width 64, RepGhostBottleneck
    [48, 32] 48 and MFA its last input's 48; the port keeps the table and
    builds the next Conv from the true 16, 32 and 40. GiraffeNeckV2's width
    is its levels' list, which ExtractLayer and Index pick from."""
    for name, table, true in (("RepViTBlock", 64, 16), ("RepGhostBottleneck", 48, 32)):
        tm = _undrawn(_yaml(name), imgsz=ROW_IMGSZ)
        assert tm.spec.layers[1].c2 == table and tm.m2.conv.in_channels == true
    tm = _undrawn(_yaml("MFA"), imgsz=ROW_IMGSZ)
    assert tm.spec.layers[4].c2 == 48 and tm.m5.conv.in_channels == 40
    tm = _undrawn(_yaml("GiraffeNeckV2"), imgsz=ROW_IMGSZ)
    assert tm.spec.layers[4].c2 == [16, 32, 64]
    assert [tm.spec.layers[i].c2 for i in (5, 6, 7)] == [16, 32, 64]
    assert _head_widths(tm) == (16, 32, 64) and tm.strides == (4, 8, 16)


def test_structure_rows_are_jax_structure_builders():
    """The port's structure rows are the 20 of JAX's `_STRUCTURE_BUILDERS`
    that no earlier table holds (PConv, deliberately not ported, aside;
    tests/test_torch_zoo_lda.py holds it as the one name that raises)."""
    assert set(T.STRUCTURE_ROWS) == set(JT._STRUCTURE_BUILDERS) - {
        "PConv", "FasterBlock", "TorchVision", "GhostModuleV2", "GhostBottleneckV2"}
    assert len(T.STRUCTURE_ROWS) == 20


def test_swin_t_giraffe_has_jax_parameter_count():
    """The published widths at nc = 3: 49,430,595 parameters in 412 leaves
    and 28,544 BatchNorm statistics, JAX's count, by building the model
    (strides probed on the meta device, no weights drawn)."""
    tm = _undrawn(swin_giraffe(), nc=3)
    assert sum(p.numel() for p in tm.parameters()) == 49_430_595
    assert len(list(tm.parameters())) == 412
    assert sum(b.numel() for n, b in tm.named_buffers() if n.endswith(("_mean", "_var"))) == 28_544
    assert tm.strides == (8, 16, 32) and _head_widths(tm) == (128, 256, 512)
    assert sum(isinstance(m, S.SwinTransformerBlock) for m in tm.modules()) == 12


SWIN_IMGSZ = 96
NARROW = dict(embed=16, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), window=5, neck=(32, 48, 64),
              depth=0.34)


def _swin_batch(seed=41, b=2, m=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.25, 0.75, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    return dict(img=rng.integers(0, 256, (b, SWIN_IMGSZ, SWIN_IMGSZ, 3), dtype=np.uint8),
                gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                gt_cls=rng.integers(0, 3, (b, m)).astype(np.int32),
                gt_mask=(np.arange(m)[None] < np.array([[2], [4]])).astype(np.float32))


@pytest.fixture(scope="module")
def jax_swin():
    """The narrow Swin-T-Giraffe in JAX, float64, from one set of numpy
    variables (Detect class biases 0, so NMS has candidates): its row spec,
    the variables, the eval-mode maps and decode of `x` and the train-mode
    loss, items, gradient and BatchNorm statistics of `_swin_batch()`, from
    one compile."""
    spec = jax_parse_model_spec(swin_giraffe(**NARROW))
    x = np.random.default_rng(0).uniform(0, 1, (2, SWIN_IMGSZ, SWIN_IMGSZ, 3))
    batch = _swin_batch()
    cfg = get_cfg()
    with jax.enable_x64(True):
        module = YOLOModel(spec, dtype=jnp.float64)
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, SWIN_IMGSZ, SWIN_IMGSZ, 3), jnp.float64))
        variables = structure_variables(shapes, np.random.default_rng(1))
        head = variables["params"][f"m{len(spec.layers) - 1}"]
        for sub in head:
            if sub.startswith("cv3_") and sub.endswith("_2"):
                head[sub]["conv"]["bias"][:] = 0.0
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def run(v, img, b):
            feats = module.apply(v, img)

            def loss_fn(params):
                outs, mut = module.apply({"params": params, "batch_stats": v["batch_stats"]},
                                         jax_device_normalize(b["img"], jnp.float64), train=True,
                                         mutable=["batch_stats"])
                total, items = JD.detection_loss(outs, b, (8, 16, 32), 3, box_gain=cfg.box,
                                                 cls_gain=cfg.cls, dfl_gain=cfg.dfl)
                return total, (items, mut["batch_stats"])

            (loss, (items, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
            return feats, jax_decode(feats, (8, 16, 32), 3), loss, items, grads, stats

        out = jax.jit(run)(jv, jnp.asarray(x), {k: jnp.asarray(v) for k, v in batch.items()})
        out = jax.tree_util.tree_map(np.asarray, out)
    return dict(spec=spec, shapes=shapes, variables=variables, x=x, batch=batch, cfg=cfg,
                feats=out[0], pred=out[1], loss=out[2], items=out[3], grads=out[4],
                stats=out[5])


def test_narrow_swin_t_giraffe_rows_params_forward_decode_nms_match_jax(jax_swin):
    """The narrow model's rows and parameter count are JAX's; from the same
    variables its float32 maps are JAX's float64 ones within 1e-4 of their
    largest, its decode within 0.05 px and 1e-3, and NMS keeps as many rows."""
    tm = _undrawn(swin_giraffe(**NARROW), imgsz=SWIN_IMGSZ)
    assert _rows(tm.spec) == _rows(jax_swin["spec"])
    assert sum(p.numel() for p in tm.parameters()) == _jax_count(jax_swin["shapes"])
    load_jax_variables(tm, jax_swin["variables"])
    x = torch.from_numpy(jax_swin["x"].astype(np.float32))
    with torch.no_grad():
        feats = tm(x)
    for a, b in zip(feats, jax_swin["feats"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * float(np.abs(b).max()), rtol=0)
    pred_t, pred_j = tm.predict(x).numpy(), jax_swin["pred"]
    assert pred_t.shape == pred_j.shape == (2, 4 + 3, 12 ** 2 + 6 ** 2 + 3 ** 2)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    _, nj = jax_nms(jnp.asarray(pred_j.astype(np.float32)), conf_thres=0.25, iou_thres=0.45)
    _, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


def test_narrow_swin_t_giraffe_train_step_matches_jax_in_float64(jax_swin):
    """One train-mode loss and gradient of the narrow model (nc = 3, 96 px,
    batch 2) and the BatchNorm statistics it leaves, in float64 on both
    sides, at tests/test_torch_zoo_lda.py's bars: gradients within 1e-5 of
    each leaf's largest plus 1e-12 of the model's, loss items 1e-6
    relative, statistics 1e-6. The window attentions' bias tables and qkv
    Dense layers, the PatchMerging reductions and the neck's RepConvG 3x3
    branches get gradients."""
    tm = _undrawn(swin_giraffe(**NARROW), imgsz=SWIN_IMGSZ)
    load_jax_variables(tm, jax_swin["variables"])
    m64 = tm.double()
    b64 = {k: torch.as_tensor(v) for k, v in jax_swin["batch"].items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in b64.items()}
    names, params = zip(*m64.named_parameters())
    loss_t, items_t = train_loss(m64, jax_swin["cfg"], b64)
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, params)))
    own = {k: v.clone() for k, v in m64.state_dict().items()}

    assert float(jax_swin["items"].box) > 0
    for a, b in zip((loss_t, *items_t), (jax_swin["loss"], *jax_swin["items"])):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-6)
    gj = params_from_jax(tm, jax_swin["grads"])
    assert set(gj) == set(grads_t)
    g_max = max(float(g.abs().max()) for g in gj.values())
    for n, g in grads_t.items():
        ref = gj[n].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, err_msg=n,
                                   atol=1e-5 * np.abs(ref).max() + 1e-12 * g_max)
    named = [n for n in grads_t if n.endswith(("relative_position_bias_table", "attn.qkv.weight",
                                               "reduction.weight", "dense_conv.weight"))]
    assert len(named) == 8 + 8 + 3 + 5
    assert all(float(grads_t[n].abs().max()) > 0 for n in named)
    stats = state_dict_from_jax({"batch_stats": jax_swin["stats"]})
    assert len(stats) > 50
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["swin_giraffe", "MQA", "GGhostStage"])
def test_structure_rows_refuse_the_parallel_paths(name):
    """The structures' modules have no tensor- or spatial-parallel form
    (ROADMAP Queue 1 item 7): window attention with its padding and rolls,
    Dense and LayerNorm layers, tuple outputs, global poolings, strided
    queries."""
    from types import SimpleNamespace

    from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
    from yolo_dbl_tpu_torch.parallel.spatial import spatial

    two = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)
    cfg = swin_giraffe(**NARROW) if name == "swin_giraffe" else _yaml(name)
    tm = _undrawn(cfg, imgsz=SWIN_IMGSZ if name == "swin_giraffe" else ROW_IMGSZ)
    with pytest.raises(NotImplementedError, match="item 7"):
        model_parallel_shardings(tm, two)
    with pytest.raises(NotImplementedError, match="item 7"):
        with spatial(tm, two):
            pass
