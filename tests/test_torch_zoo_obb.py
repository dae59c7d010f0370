"""The OBB and `-cls-resnet` configs in the port against the JAX package, on the CPU.

Five YAMLs (v8/yolov8-obb, 11/yolo11-obb, v8/yolov8-cls-resnet{50,101},
11/yolo11-cls-resnet18), copied byte for byte into the port: each reads as
PyYAML reads it, every scale's rows are JAX's, and the parameter counts are
jax.eval_shape's of the JAX model (and tests/test_model.py's goldens less
the 16 of the DFL fold for yolo11n-obb; the resnet18 classifier's exact).

Whole-model parity at 64 px from the same perturbed variables (class biases
0 on the nested Detect, so the rotated NMS has candidates at conf 0.25)
through each side's predictor: yolov8n-obb and yolo11n-obb (raw maps 1e-4;
the decode's xywh 0.05 px, angle 1e-4, scores 1e-3; the same kept rows),
yolo11n-cls-resnet18 and yolov8-cls-resnet50 (probabilities 1e-4). One
train-mode loss and gradient of yolov8n-obb against JAX's in float64 on
both sides (JAX's extra.py float32 casts widened, as tests/test_torch_tasks.py
does). Then the facade and the CLI: yolov8n-obb trains, validates (box
and rbox mAP) and predicts (`Results.obb`) at 64 px, its checkpoint loads
back, and `obb train`, `obb val` and `obb predict` run.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_dbl_tpu.engine import predictor as JP
from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.losses import extra as JX
from yolo_dbl_tpu.nn.tasks import ClassificationModel as JaxClassificationModel
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.nn.tasks import YOLOModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load

from yolo_dbl_tpu_torch import ClassificationModel, DetectionModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.cli import entrypoint
from yolo_dbl_tpu_torch.engine import predictor as TP
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.engine.trainer import train_loss
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables, params_from_jax, state_dict_from_jax

from tests.fixtures import make_task_dataset
from tests.test_torch_modules import jax_tree, random_variables
from tests.test_torch_tasks import _WideNumpy
from tests.torch_fixtures import one_torch_thread, write_jpeg_frames  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
IMGSZ = 64
# {YAML: (its folder, {model: (nc, its count: tests/test_model.py's golden less the 16 of the
# DFL fold where it lists one, else the JAX model's own)})}
ZOO = {
    "yolov8-obb": ("v8", {"yolov8n-obb.yaml": (80, 3228851)}),
    "yolo11-obb": ("11", {"yolo11n-obb.yaml": (80, 2695747 - 16),
                          "yolo11s-obb.yaml": (15, 9719760)}),
    "yolov8-cls-resnet50": ("v8", {"yolov8-cls-resnet50.yaml": (1000, 27413032)}),
    "yolov8-cls-resnet101": ("v8", {"yolov8-cls-resnet101.yaml": (1000, 46405160)}),
    "yolo11-cls-resnet18": ("11", {"yolo11n-cls-resnet18.yaml": (
        10, 11176512 + (512 * 1280 + 1280 * 2) + (1280 * 10 + 10))}),
}


def _paths(name):
    folder = ZOO[name][0]
    return (REPO / f"yolo_dbl_tpu_torch/cfg/models/{folder}/{name}.yaml",
            REPO / f"yolo_dbl_tpu/cfg/models/{folder}/{name}.yaml")


def _is_cls(model):
    return "-cls" in model


def _scaled(name, scale):
    """'yolo11-obb' at scale 'n' → 'yolo11n-obb'; the resnet50/101 names keep none."""
    if name.startswith("yolov8-cls-resnet"):
        return name
    return name.replace("-", f"{scale}-", 1)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_obb_and_resnet_yaml_copies_and_rows(name):
    """The port's copy is byte for byte JAX's and reads as PyYAML reads it;
    every scale's rows (OBB's ne, ResNetLayer's and TorchVision's unscaled
    widths) are JAX's."""
    port, ref = _paths(name)
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(ref.read_text())
    scales = yaml.safe_load(ref.read_text()).get("scales") or {"": None}
    for scale in scales:
        model = _scaled(name, scale) + ".yaml"
        spec_j = jax_parse_model_spec(jax_yaml_model_load(model))
        spec_t = T.parse_model_spec(T.yaml_model_load(model))
        assert spec_t.scale == spec_j.scale
        assert [(l.f, l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
            [(l.f, l.name, l.args, l.c2, l.n) for l in spec_j.layers], model
        assert spec_t.save == spec_j.save


def _undrawn(cls, model, **kw):
    """`cls(model, ...)` on the CPU without its own draw of the weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        return cls(model, device="cpu", **kw)


@pytest.mark.parametrize("model,nc,golden", [(m, nc, g) for _, (_, models) in sorted(ZOO.items())
                                              for m, (nc, g) in models.items()])
def test_obb_and_resnet_params_match_jax(model, nc, golden):
    jcls, tcls = ((JaxClassificationModel, ClassificationModel) if _is_cls(model)
                  else (JaxDetectionModel, DetectionModel))
    jm = jcls(model, nc=nc)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)))
    tm = _undrawn(tcls, model, nc=nc)
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n == golden
    assert tm.strides == (() if _is_cls(model) else (8, 16, 32)) == tuple(jm.strides)
    assert tm.head_name == jm.head_name


@functools.cache
def _pair(model, nc):
    """The JAX model, shared variables (class biases 0) and the port model."""
    cls = _is_cls(model)
    jm = (JaxClassificationModel if cls else JaxDetectionModel)(model, nc=nc)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((2, IMGSZ, IMGSZ, 3)))
    variables = random_variables(shapes, np.random.default_rng(31))
    if not cls:
        head = variables["params"][f"m{len(jm.spec.layers) - 1}"]["detect"]
        for sub, leaf in head.items():
            if sub.startswith("cv3_") and sub.endswith("_2"):
                leaf["conv"]["bias"][:] = 0.0
    tm = _undrawn(ClassificationModel if cls else DetectionModel, model, nc=nc)
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _frames(seed=32):
    return np.random.default_rng(seed).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)


@pytest.mark.parametrize("model", ["yolov8n-obb.yaml", "yolo11n-obb.yaml"])
def test_obb_model_predictor_parity(model):
    """Raw maps and angles 1e-4; the decode's xywh within 0.05 px, angle
    1e-4 and scores 1e-3; the rotated NMS keeps the same rows (counts,
    classes; boxes 0.05 px, angles 1e-4, scores 1e-3)."""
    jm, variables, tm = _pair(model, 15)
    x = _frames()
    feats_j = jax.jit(jm.module.apply)(jax_tree(variables), jnp.asarray(x))
    pred_j = np.asarray(jax.jit(jm.predict)(jax_tree(variables), jnp.asarray(x)))
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
    for a, b in zip([*feats_t[0], *feats_t[1]], [*feats_j[0], *feats_j[1]], strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    pred_t = tm.predict(torch.from_numpy(x)).numpy()
    assert pred_t.shape == pred_j.shape == (2, 4 + 15 + 1, 84)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, -1] - pred_j[:, -1]).max() <= 1e-4
    assert np.abs(pred_t[:, 4:-1] - pred_j[:, 4:-1]).max() <= 1e-3
    jp = JP.OBBPredictor(jm, conf=0.25, iou=0.45, imgsz=IMGSZ)
    dj, nj = (np.asarray(a) for a in jp._infer(jax_tree(variables), jnp.asarray(x)))
    dt, nt = (t.numpy() for t in TP.OBBPredictor(tm, conf=0.25, iou=0.45, imgsz=IMGSZ)
              .infer_images(torch.from_numpy(x)))
    np.testing.assert_array_equal(nt, nj)
    assert int(nt.min()) > 0
    for i, k in enumerate(nt):
        np.testing.assert_allclose(dt[i, :k, :4], dj[i, :k, :4], atol=0.05, rtol=0)
        np.testing.assert_allclose(dt[i, :k, 4], dj[i, :k, 4], atol=1e-4, rtol=0)
        np.testing.assert_allclose(dt[i, :k, 5], dj[i, :k, 5], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(dt[i, :k, 6], dj[i, :k, 6])


@pytest.mark.parametrize("model,nc", [("yolo11n-cls-resnet18.yaml", 10),
                                      ("yolov8-cls-resnet50.yaml", 1000)])
def test_resnet_classifier_parity(model, nc):
    """The TorchVision (ResNet-18) and ResNetLayer (ResNet-50) classifiers:
    probabilities within 1e-4, top-1 equal where the top two are apart."""
    jm, variables, tm = _pair(model, nc)
    x = _frames()
    want = np.asarray(JP.ClassificationPredictor(jm, imgsz=IMGSZ)._infer(jax_tree(variables),
                                                                        jnp.asarray(x)))
    (got,) = TP.ClassificationPredictor(tm, imgsz=IMGSZ).infer_images(torch.from_numpy(x))
    got = got.numpy()
    assert got.shape == want.shape == (2, nc)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    top2 = np.sort(want, -1)[:, -2:]
    same = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(got.argmax(-1)[same], want.argmax(-1)[same])


def _obb_batch(seed, b=2, m=6, nc=15):
    """A train batch of the loss contract with rotated boxes: uint8 images,
    2 and 4 real rows of xywh in [0, 1] and angles in [-π/4, 3π/4)."""
    rng = np.random.default_rng(seed)
    gt = np.concatenate([rng.uniform(0.3, 0.7, (b, m, 2)), rng.uniform(0.15, 0.5, (b, m, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, m, 1))], -1)
    mask = (np.arange(m)[None] < np.array([[2], [4]])).astype(np.float32)
    return {"img": rng.integers(0, 256, (b, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "gt_boxes": (gt * mask[..., None]).astype(np.float32),
            "gt_cls": rng.integers(0, nc, (b, m)).astype(np.int32), "gt_mask": mask}


def test_obb_train_step_loss_gradients_and_batch_stats_match_jax():
    """One train-mode loss and gradient of yolov8n-obb (nc=15) at 64 px,
    batch 2, and the BatchNorm statistics it leaves, in float64 on both
    sides (JAX's model with dtype float64 under `jax.enable_x64` and its
    extra.py's float32 casts widened; a `.double()` copy of the port's,
    whose OBB loss keeps float64). Bars: loss items 1e-6 relative,
    gradients within 1e-5 of each leaf's largest plus 1e-12 of the model's
    largest, statistics 1e-6."""
    tm = _undrawn(DetectionModel, "yolov8n-obb.yaml", nc=15)
    spec = jax_parse_model_spec(jax_yaml_model_load("yolov8n-obb.yaml") | {"nc": 15})
    batch = _obb_batch(41)
    cfg = get_cfg()
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JX, "jnp", _WideNumpy())
        module = YOLOModel(spec, dtype=jnp.float64)
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, IMGSZ, IMGSZ, 3), jnp.float64))
        variables = random_variables(shapes, np.random.default_rng(42))
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(params, batch_stats, b):
            (det, ang), mut = module.apply({"params": params, "batch_stats": batch_stats},
                                           jax_device_normalize(b["img"], jnp.float64),
                                           train=True, mutable=["batch_stats"])
            total, items = JX.obb_loss(det, ang, b, tm.strides, 15, box_gain=cfg.box,
                                       cls_gain=cfg.cls, dfl_gain=cfg.dfl)
            return total, (items, mut["batch_stats"])

        (loss_j, (items_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jv["params"], jv["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()})
        grads_j, stats_j = jax.tree_util.tree_map(np.asarray, (grads_j, stats_j))
        assert items_j.box.dtype == jnp.float64

    load_jax_variables(tm, variables)
    m64 = tm.double()
    b64 = {k: torch.as_tensor(v) for k, v in batch.items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in b64.items()}
    names, params = zip(*m64.named_parameters())
    loss_t, items_t = train_loss(m64, cfg, b64)
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, params)))
    own = {k: v.clone() for k, v in m64.state_dict().items()}

    assert float(items_j.box) > 0 and float(items_j.dfl) > 0
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


# ---------------------------------------------------------------- facade and CLI

@pytest.fixture(scope="module")
def obb_set(tmp_path_factory):
    return make_task_dataset(tmp_path_factory.mktemp("obb"), task="obb", n_train=4, n_val=2,
                             imgsz=IMGSZ)


def test_facade_trains_validates_and_predicts_obb(obb_set, tmp_path):
    """One epoch of yolov8n-obb, val (box and rbox mAP), predict from memory
    (Results.obb rows, no boxes), the best checkpoint loaded back with the
    same forward."""
    y = YOLO("yolov8n-obb.yaml", nc=2, device="cpu")
    assert y.task == "obb"
    out = y.train(obb_set, epochs=1, batch=2, imgsz=IMGSZ, workers=0, project=str(tmp_path),
                  name="run", plots=False)
    hist = out["history"][0]
    assert y.trainer.steps == 2
    assert all(k in hist and np.isfinite(hist[k]) for k in ("loss", "box_loss", "cls_loss",
                                                             "dfl_loss", "val_rbox_mAP50"))
    metrics = y.val(obb_set, batch=2, imgsz=IMGSZ)
    assert metrics["images"] == 2 and 0.0 <= metrics["rbox_mAP50-95"] <= 1.0
    frames = list(np.random.default_rng(33).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8))
    res = y.predict(frames, imgsz=IMGSZ, conf=0.001)
    assert len(res) == 2 and res[0].boxes is None and len(res[0]) == len(res[0].obb) > 0
    assert res[0].obb.data.shape[1] == 7 and np.isfinite(res[0].obb.data).all()
    assert res[0].to_json_dicts()[0]["box"].keys() == {"x", "y", "w", "h", "angle"}
    back = YOLO(str(Path(out["run_dir"]) / "best.ckpt"), device="cpu")
    assert back.task == "obb"
    x = torch.rand((1, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = back.model(x), y.model(x)
    for u, v in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b),
                    strict=True):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_cli_runs_obb_train_val_and_predict(obb_set, tmp_path, capsys):
    """`obb train`, `obb val` and `obb predict` through the CLI on the CPU."""
    entrypoint(["obb", "train", "model=yolov8n-obb.yaml", f"data={obb_set}", "nc=2", "epochs=1",
                "batch=2", f"imgsz={IMGSZ}", "workers=0", "device=cpu", f"project={tmp_path}",
                "name=cli", "plots=False"])
    best = tmp_path / "cli" / "best.ckpt"
    assert "best fitness" in capsys.readouterr().out and best.is_file()
    entrypoint(["obb", "val", f"model={best}", f"data={obb_set}", "batch=2", f"imgsz={IMGSZ}",
                "device=cpu"])
    assert "mAP50" in capsys.readouterr().out
    src = tmp_path / "frames"
    write_jpeg_frames(src, ((48, 80),), 2)
    entrypoint(["obb", "predict", f"model={best}", f"source={src}", "device=cpu",
                f"imgsz={IMGSZ}", "conf=0.001"])
    out = capsys.readouterr().out
    assert "frame00.jpg" in out and "'angle'" in out
