"""The stock detect families' configs in the port against the JAX package, on the CPU.

Seventeen YAMLs of v3, v5, v6, v8, 11 and v12, copied byte for byte into
the port. For each: the copy reads as PyYAML reads it, every scale's rows
are JAX's, and at nc=80 and its smallest scale (its first; none where the
YAML has no scales) the parameter count equals JAX's (jax.eval_shape of
the JAX model) and the golden count less 16 of tests/test_model.py where
one is listed (the frozen DFL conv the JAX package folds).

Decode and NMS parity at 64 px, from the same perturbed variables (Detect
class biases 0, so NMS has candidates at conf 0.25), for every config
under ~20 M parameters at that scale: raw maps 1e-4, boxes < 0.05 px,
scores <= 1e-3, equal kept counts. That covers 2 levels (yolov3-tiny), 4
levels with strides 4-32 (P2) and 8-64 (P6), C3k2, C2PSA, A2C2f, C3, C2,
SPP, the ReLU override and the transposed convs. The YOLOv3 family's
whole models (48-114 M parameters) run in a `compileheavy` case; the
default lane holds their rows and counts, and their decode with
descending strides (32, 16, 8) on random raw maps.

One train-mode loss and gradient of yolo11n and of yolov6n against JAX's,
in float64 on both sides (the bars of tests/test_torch_v13_family.py's
float64 test: at 64 px the P5 maps are 2x2, where float32 reads a
cancelling gradient poorly on either side); yolov6n's checkpoint round
trip keeps its ReLU; and the facade over four of the configs.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.losses import detection as JD
from yolo_dbl_tpu.nn.heads import decode_detections as jax_decode
from yolo_dbl_tpu.nn.tasks import YOLOModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.engine.trainer import train_loss
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.nn.common import Conv
from yolo_dbl_tpu_torch.nn.heads import decode_detections as torch_decode
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.checkpoint import save_deploy
from yolo_dbl_tpu_torch.utils.convert import (load_jax_variables, params_from_jax,
                                              state_dict_from_jax)

from tests.fixtures import make_shapes_dataset
from tests.test_torch_modules import jax_tree, random_variables
from tests.test_torch_train import _train_batches
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
IMGSZ = 64
# {YAML: (its folder, the golden counts of tests/test_model.py:47-62,178-197 by model name)}
ZOO = {
    "yolov3": ("v3", {"yolov3.yaml": 103754144}),
    "yolov3_edit1": ("v3", {"yolov3_edit1.yaml": 114223008}),
    "yolov3_edit2": ("v3", {}),
    "yolov3_edit3": ("v3", {}),
    "yolov3_edit5": ("v3", {"yolov3_edit5.yaml": 1601960}),
    "yolov3-tiny": ("v3", {"yolov3-tiny.yaml": 12173248}),
    "yolov3-spp": ("v3", {"yolov3-spp.yaml": 104803744}),
    "yolov5": ("v5", {"yolov5s.yaml": 9153152}),
    "yolov5-p6": ("v5", {"yolov5-p6.yaml": 4334896}),
    "yolov6": ("v6", {"yolov6n.yaml": 4500080}),
    "yolov8-p2": ("v8", {"yolov8n-p2.yaml": 3354144}),
    "yolov8-p6": ("v8", {"yolov8n-p6.yaml": 4984352}),
    "yolov8-ghost": ("v8", {"yolov8n-ghost.yaml": 1865316}),
    "yolov8-ghost-p2": ("v8", {"yolov8n-ghost-p2.yaml": 2033944}),
    "yolov8-ghost-p6": ("v8", {"yolov8n-ghost-p6.yaml": 2901100}),
    "yolo11": ("11", {}),
    "yolov12": ("v12", {"yolov12n.yaml": 2572336, "yolov12s.yaml": 9164288}),
}
# the YOLOv3 family's whole models: 48-114 M parameters, no scales
BIG = ("yolov3", "yolov3_edit1", "yolov3_edit2", "yolov3_edit3", "yolov3-spp")
SMALL = tuple(n for n in ZOO if n not in BIG)
STRIDES = {"yolov3-tiny": (16, 32), "yolov3_edit1": (32, 16, 8), "yolov3_edit2": (32, 16, 8),
           "yolov3_edit3": (32, 16, 8), "yolov5-p6": (8, 16, 32, 64), "yolov8-p6": (8, 16, 32, 64),
           "yolov8-ghost-p6": (8, 16, 32, 64), "yolov8-p2": (4, 8, 16, 32),
           "yolov8-ghost-p2": (4, 8, 16, 32)}


def _paths(name):
    folder = ZOO[name][0]
    return (REPO / f"yolo_dbl_tpu_torch/cfg/models/{folder}/{name}.yaml",
            REPO / f"yolo_dbl_tpu/cfg/models/{folder}/{name}.yaml")


def _scaled(name, scale):
    """The model name of a scale: yolov8-p2 at n is yolov8n-p2."""
    return re.sub(r"^(yolo(?:v)?\d+)", rf"\g<1>{scale}", name)


def _smallest(name):
    """The model name at the YAML's first scale (the name itself without scales)."""
    scales = yaml.safe_load(_paths(name)[1].read_text()).get("scales")
    return _scaled(name, next(iter(scales))) if scales else name


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_yaml_copies_and_rows(name):
    """The port's copy is byte for byte JAX's and reads as PyYAML reads it;
    every scale's rows (and a name without a scale letter, which takes the
    first) are JAX's."""
    port, ref = _paths(name)
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(ref.read_text())
    scales = yaml.safe_load(ref.read_text()).get("scales") or {}
    for scale in (*scales, ""):
        model = _scaled(name, scale) + ".yaml"
        spec_j = jax_parse_model_spec(jax_yaml_model_load(model) | {"nc": 80})
        spec_t = T.parse_model_spec(T.yaml_model_load(model) | {"nc": 80})
        assert spec_t.scale == spec_j.scale
        assert [(l.f, l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
            [(l.f, l.name, l.args, l.c2, l.n) for l in spec_j.layers]
        assert spec_t.save == spec_j.save


def _undrawn(model, **kw):
    """DetectionModel(model, ...) on the CPU without its own draw of the
    weights (seconds for the YOLOv3 family's 48-114 M parameters): every
    test that reads these weights loads JAX's first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        return DetectionModel(model, device="cpu", **kw)


@functools.cache
def _models(name):
    """The JAX spec, the JAX variables' shapes at 64 px and the port model of
    `name` at nc=80 and its smallest scale, built once for the file."""
    model = _smallest(name) + ".yaml"
    spec = jax_parse_model_spec(jax_yaml_model_load(model) | {"nc": 80})
    shapes = jax.eval_shape(YOLOModel(spec).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, IMGSZ, IMGSZ, 3)))
    return spec, shapes, _undrawn(model, nc=80)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_params_match_jax(name):
    _, shapes, tm = _models(name)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    for model, golden in ZOO[name][1].items():
        m = tm if model == _smallest(name) + ".yaml" else _undrawn(model, nc=80)
        assert sum(p.numel() for p in m.parameters()) == golden - 16, model
    assert tm.strides == STRIDES.get(name, (8, 16, 32))


def _pair(name, seed=1):
    """JAX and the port on 64 px inputs from the same perturbed variables
    (Detect class biases 0): JAX's raw maps and decode at the port's
    strides, and the port model."""
    spec, shapes, tm = _models(name)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    variables = random_variables(shapes, np.random.default_rng(seed))
    head = variables["params"][f"m{len(spec.layers) - 1}"]
    for sub in head:
        if sub.startswith("cv3_") and sub.endswith("_2"):
            head[sub]["conv"]["bias"][:] = 0.0
    module = YOLOModel(spec)
    run = jax.jit(lambda v, img: (lambda f: (f, jax_decode(f, tm.strides, 80)))(
        module.apply(v, img)))
    feats, pred = run(jax_tree(variables), jnp.asarray(x))
    load_jax_variables(tm, variables)
    return tm, x, [np.asarray(f) for f in feats], np.asarray(pred)


def _check_decode(name):
    tm, x, feats_j, pred_j = _pair(name)
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
    assert len(feats_t) == len(feats_j) == len(tm.strides)
    for a, b in zip(feats_t, feats_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
    pred_t = tm.predict(torch.from_numpy(x)).numpy()
    anchors = sum((IMGSZ // s) ** 2 for s in tm.strides)
    assert pred_t.shape == pred_j.shape == (2, 4 + 80, anchors)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    _, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    _, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_zoo_forward_decode_nms_parity(name):
    _check_decode(name)


@pytest.mark.compileheavy
@pytest.mark.parametrize("name", sorted(BIG))
def test_zoo_big_forward_decode_nms_parity(name):
    """The YOLOv3 family's whole models (48-114 M parameters) at 64 px."""
    _check_decode(name)


def test_decode_with_descending_strides_matches_jax():
    """yolov3_edit1-3 list their Detect inputs P5, P4, P3: strides (32, 16,
    8). The decode and NMS of random raw maps of those shapes at 64 px (2x2,
    4x4, 8x8, 4 * 16 + 80 channels) against JAX's; the anchors run level by
    level in that order on both sides."""
    rng = np.random.default_rng(3)
    strides = _models("yolov3_edit3")[2].strides
    assert strides == (32, 16, 8)
    feats = [rng.normal(0, 2, (2, IMGSZ // s, IMGSZ // s, 64 + 80)).astype(np.float32)
             for s in strides]
    pred_j = np.asarray(jax_decode([jnp.asarray(f) for f in feats], strides, 80))
    pred_t = torch_decode([torch.from_numpy(f) for f in feats], strides, 80).numpy()
    assert pred_t.shape == (2, 84, 4 + 16 + 64)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 1e-4
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-6
    # the first anchors are P5's, at its stride
    assert pred_t[0, 0, :4].max() > 16 and pred_t[0, 0, 4:].min() < 64
    _, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    _, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


@pytest.mark.parametrize("name", ["yolo11", "yolov6"])
def test_train_step_loss_gradients_and_batch_stats_match_jax(name):
    """One train-mode loss and gradient of yolo11n (C3k2, C2PSA) and yolov6n
    (ReLU, the transposed convs) at nc=80, 64 px, batch 2, and the
    BatchNorm statistics it leaves, in float64 on both sides (JAX's model
    with dtype float64 under `jax.enable_x64`; a `.double()` copy of the
    port's). Bars: loss items 1e-6 relative, gradients within 1e-5 of each
    leaf's largest plus 1e-12 of the model's largest, statistics 1e-6."""
    spec, _, tm = _models(name)
    batch = _train_batches(1, seed=41)[0]
    cfg = get_cfg()
    with jax.enable_x64(True):
        module = YOLOModel(spec, dtype=jnp.float64)
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, IMGSZ, IMGSZ, 3), jnp.float64))
        variables = random_variables(shapes, np.random.default_rng(42))
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
    b64 = {k: torch.as_tensor(v) for k, v in batch.items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in b64.items()}
    names, params = zip(*m64.named_parameters())
    try:
        loss_t, items_t = train_loss(m64, cfg, b64)
        grads_t = dict(zip(names, torch.autograd.grad(loss_t, params)))
        own = {k: v.clone() for k, v in m64.state_dict().items()}
    finally:
        tm.float().eval()  # the shared model goes back to float32

    assert float(items_j.box) > 0
    for a, b in zip((loss_t, *items_t), (loss_j, *items_j)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-6)
    gj = params_from_jax(tm, grads_j)
    assert set(gj) == set(grads_t)
    g_max = max(float(g.abs().max()) for g in gj.values())
    for n, g in grads_t.items():
        ref = gj[n].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, err_msg=n,
                                   atol=1e-5 * np.abs(ref).max() + 1e-12 * g_max)
    stats = state_dict_from_jax({"batch_stats": stats_j})
    assert len(stats) > 100
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def shapes64(tmp_path_factory):
    return make_shapes_dataset(tmp_path_factory.mktemp("shapes64"), n_train=4, n_val=2, imgsz=64)


def _acts(model):
    """The activations of the model's Convs built with act=True (an act=False
    Conv's is Identity)."""
    return {type(m.act).__name__ for m in model.modules()
            if isinstance(m, Conv) and not isinstance(m.act, torch.nn.Identity)}


def test_yolov6_checkpoint_round_trip_keeps_relu(tmp_path):
    """A deploy checkpoint of yolov6n holds the YAML with its `activation:`;
    YOLO('x.ckpt') rebuilds every Conv with ReLU and gives the same boxes."""
    y = YOLO("yolov6n.yaml", nc=3, device="cpu")
    with torch.no_grad():
        for p in y.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.01)
    path = tmp_path / "best.ckpt"
    save_deploy(path, {"params": dict(y.model.named_parameters()),
                       "batch_stats": {k: v for k, v in y.model.named_buffers()}},
                model_yaml=y.model.yaml, nc=y.model.nc)
    back = YOLO(str(path), device="cpu")
    assert _acts(back.model) == _acts(y.model) == {"ReLU"}
    assert back.model.yaml["activation"] == "nn.ReLU()"
    x = torch.rand((1, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(back.model.predict(x), y.model.predict(x), rtol=0, atol=0)


@pytest.mark.parametrize("model,yaml_name,scale,acts", [
    ("yolo11n.yaml", "11/yolo11.yaml", "n", {"SiLU"}),
    ("yolov12s.yaml", "v12/yolov12.yaml", "s", {"SiLU"}),
    ("yolov6n.yaml", "v6/yolov6.yaml", "n", {"ReLU"}),
    ("yolov3-tiny.yaml", "v3/yolov3-tiny.yaml", "", {"SiLU"})])
def test_facade_trains_validates_and_predicts(model, yaml_name, scale, acts, shapes64, tmp_path):
    """`YOLO(name)` resolves the YAML through the scale rule, trains an
    epoch (one step of 4 at 64 px), validates and predicts on the CPU."""
    y = YOLO(model, nc=3, device="cpu")
    assert y.model.yaml["yaml_file"].endswith(yaml_name) and y.model.spec.scale == scale
    assert _acts(y.model) == acts
    out = y.train(shapes64, epochs=1, batch=4, imgsz=IMGSZ, workers=0, project=str(tmp_path),
                  name="run", plots=False)
    hist = out["history"][0]
    assert all(np.isfinite(v) for v in hist.values() if isinstance(v, float))
    metrics = y.val(shapes64, batch=2, imgsz=IMGSZ)
    assert 0.0 <= metrics["mAP50"] <= 1.0
    res = y.predict(np.random.default_rng(0).integers(0, 256, (IMGSZ, 80, 3), dtype=np.uint8),
                    imgsz=IMGSZ, conf=0.001)
    assert len(res) == 1 and res[0].boxes.data.shape[1] == 6
