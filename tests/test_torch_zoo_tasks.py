"""The segment, pose and classify configs in the port against the JAX package, on the CPU.

Eight YAMLs (v8/yolov8-{seg,pose,cls}, 11/yolo11-{seg,pose,cls},
v9/yolov9{c,e}-seg), copied byte for byte into the port: each reads as
PyYAML reads it, every scale's rows are JAX's, and the parameter counts are
jax.eval_shape's of the JAX model and tests/test_model.py's goldens (less
the 16 of the DFL fold for a Detect head; a Classify model's are exact).

Whole-model parity at 64 px from the same perturbed variables (class biases
0 on the nested Detect, so NMS has candidates at conf 0.25) through each
side's task predictor (`infer` / `infer_images`: forward, decode, NMS with
anchor indices, the gathers): yolo11n-seg (raw maps 1e-4, boxes 0.05 px,
scores 1e-3, equal counts, kept coefficients and prototypes 1e-4, binary
masks of the kept rows), yolo11n-pose (kept keypoints 0.05 px and
visibility 1e-3) and yolov8n-cls (probabilities 1e-4, equal top-1);
yolov9e-seg whole is `compileheavy`. Then the facade: `YOLO('yolo11n-seg')`
and `YOLO('yolo11n-pose')` train, validate and predict at 64 px, their
checkpoints (and a classify one) load back, the CLI takes the task words,
and the guards: classify does not train or validate, and a task model does
not train under a mesh or run tensor- or spatial-parallel.
"""

import functools
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_dbl_tpu.engine import predictor as JP
from yolo_dbl_tpu.nn.tasks import ClassificationModel as JaxClassificationModel
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load

from yolo_dbl_tpu_torch import ClassificationModel, DetectionModel
from yolo_dbl_tpu_torch.cli import entrypoint
from yolo_dbl_tpu_torch.engine import predictor as TP
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.engine.trainer import Trainer
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.nn.heads import decode_masks
from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
from yolo_dbl_tpu_torch.parallel.spatial import spatial
from yolo_dbl_tpu_torch.utils.checkpoint import save_deploy
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables

from tests.fixtures import make_task_dataset
from tests.test_torch_modules import jax_tree, random_variables
from tests.torch_fixtures import one_torch_thread, write_jpeg_frames  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
IMGSZ = 64
# {YAML: (its folder, {model: (nc, its golden count: tests/test_model.py's less the 16 of the DFL
# fold where it lists one, else the JAX model's own count)})}
ZOO = {
    "yolov8-seg": ("v8", {"yolov8n-seg.yaml": (80, 3409952)}),
    "yolov8-pose": ("v8", {"yolov8n-pose.yaml": (1, 3295454)}),
    "yolov8-cls": ("v8", {"yolov8n-cls.yaml": (1000, 2719288)}),
    "yolo11-seg": ("11", {"yolo11n-seg.yaml": (80, 2876848 - 16),
                          "yolo11s-seg.yaml": (80, 10113232)}),
    "yolo11-pose": ("11", {"yolo11n-pose.yaml": (80, 2908507 - 16),
                           "yolo11s-pose.yaml": (1, 9918222)}),
    "yolo11-cls": ("11", {"yolo11n-cls.yaml": (10, 1543914), "yolo11s-cls.yaml": (1000, 6724008)}),
    "yolov9c-seg": ("v9", {"yolov9c-seg.yaml": (80, 27897120 - 16)}),
    "yolov9e-seg": ("v9", {"yolov9e-seg.yaml": (80, 60512800 - 16)}),
}
TWO = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)


def _paths(name):
    folder = ZOO[name][0]
    return (REPO / f"yolo_dbl_tpu_torch/cfg/models/{folder}/{name}.yaml",
            REPO / f"yolo_dbl_tpu/cfg/models/{folder}/{name}.yaml")


def _scaled(name, scale):
    """'yolo11-seg' at scale 'n' → 'yolo11n-seg'; the v9 names carry none."""
    return re.sub(r"^(yolo(?:v)?\d+)-", rf"\g<1>{scale}-", name)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_task_yaml_copies_and_rows(name):
    """The port's copy is byte for byte JAX's and reads as PyYAML reads it;
    every scale's rows (Segment's width-scaled prototypes, Pose's kpt_shape,
    Classify's unscaled nc) are JAX's."""
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


def _is_cls(model):
    return "-cls" in model


@pytest.mark.parametrize("model,nc,golden", [(m, nc, g) for _, (_, models) in sorted(ZOO.items())
                                              for m, (nc, g) in models.items()])
def test_task_params_match_jax(model, nc, golden):
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


def _zero_class_biases(params, head):
    for sub, leaf in params[head]["detect"].items():
        if sub.startswith("cv3_") and sub.endswith("_2"):
            leaf["conv"]["bias"][:] = 0.0


@functools.cache
def _pair(model, nc):
    """The JAX model, shared variables (class biases 0) and the port model."""
    cls = _is_cls(model)
    jm = (JaxClassificationModel if cls else JaxDetectionModel)(model, nc=nc)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((2, IMGSZ, IMGSZ, 3)))
    variables = random_variables(shapes, np.random.default_rng(31))
    if not cls:
        _zero_class_biases(variables["params"], f"m{len(jm.spec.layers) - 1}")
    tm = _undrawn(ClassificationModel if cls else DetectionModel, model, nc=nc)
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _frames(seed=32):
    return np.random.default_rng(seed).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)


def _check_boxes(dj, nj, dt, nt):
    np.testing.assert_array_equal(nt, nj)
    assert int(nt.min()) > 0
    for i, k in enumerate(nt):
        np.testing.assert_allclose(dt[i, :k, :4], dj[i, :k, :4], atol=0.05, rtol=0)
        np.testing.assert_allclose(dt[i, :k, 4], dj[i, :k, 4], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(dt[i, :k, 5], dj[i, :k, 5])


def _check_seg(model):
    jm, variables, tm = _pair(model, 80)
    x = _frames()
    jp = JP.SegmentationPredictor(jm, conf=0.25, iou=0.45, imgsz=IMGSZ)
    dj, nj, kj, pj = (np.asarray(a) for a in jp._infer(jax_tree(variables), jnp.asarray(x)))
    feats_j = jax.jit(jm.module.apply)(jax_tree(variables), jnp.asarray(x))
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
    for a, b in zip([*feats_t[0], *feats_t[1], feats_t[2]],
                    [*feats_j[0], *feats_j[1], feats_j[2]], strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    tp = TP.SegmentationPredictor(tm, conf=0.25, iou=0.45, imgsz=IMGSZ)
    dt, nt, kt, pt = (t.numpy() for t in tp.infer_images(torch.from_numpy(x)))
    _check_boxes(dj, nj, dt, nt)
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    changed = 0
    for i, k in enumerate(nt):
        np.testing.assert_allclose(kt[i, :k], kj[i, :k], atol=1e-4, rtol=0)
        mj, mt = (decode_masks(*(torch.from_numpy(a) for a in (kk[i, :k], pp[i], dj[i, :k, :4])),
                               (IMGSZ, IMGSZ)) > 0.5 for kk, pp in ((kj, pj), (kt, pt)))
        changed += int((mj != mt).sum())
    assert changed <= 1e-3 * sum(nt) * pt.shape[1] * pt.shape[2]


def _check_pose(model):
    jm, variables, tm = _pair(model, 80)
    x = _frames()
    jp = JP.PosePredictor(jm, kpt_shape=(17, 3), conf=0.25, iou=0.45, imgsz=IMGSZ)
    dj, nj, kj = (np.asarray(a) for a in jp._infer(jax_tree(variables), jnp.asarray(x)))
    tp = TP.PosePredictor(tm, conf=0.25, iou=0.45, imgsz=IMGSZ)
    assert tp.kpt_shape == (17, 3)
    dt, nt, kt = (t.numpy() for t in tp.infer_images(torch.from_numpy(x)))
    _check_boxes(dj, nj, dt, nt)
    for i, k in enumerate(nt):
        np.testing.assert_allclose(kt[i, :k, :, :2], kj[i, :k, :, :2], atol=0.05, rtol=0)
        np.testing.assert_allclose(kt[i, :k, :, 2], kj[i, :k, :, 2], atol=1e-3, rtol=0)


def _check_cls(model, nc):
    jm, variables, tm = _pair(model, nc)
    x = _frames()
    want = np.asarray(JP.ClassificationPredictor(jm, imgsz=IMGSZ)._infer(jax_tree(variables),
                                                                        jnp.asarray(x)))
    (got,) = TP.ClassificationPredictor(tm, imgsz=IMGSZ).infer_images(torch.from_numpy(x))
    got = got.numpy()
    assert got.shape == want.shape == (2, nc)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    top2 = np.sort(want, -1)[:, -2:]
    same = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(got.argmax(-1)[same], want.argmax(-1)[same])


@pytest.mark.parametrize("model", ["yolo11n-seg.yaml", "yolo11n-pose.yaml", "yolov8n-cls.yaml"])
def test_task_model_predictor_parity(model):
    if "seg" in model:
        _check_seg(model)
    elif "pose" in model:
        _check_pose(model)
    else:
        _check_cls(model, 1000)


@pytest.mark.compileheavy
def test_yolov9e_seg_predictor_parity():
    """yolov9e-seg whole (60 M parameters: CBLinear, CBFuse, Silence, Segment) at 64 px."""
    _check_seg("yolov9e-seg.yaml")


# ---------------------------------------------------------------- facade and guards

@pytest.fixture(scope="module")
def task_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("tasks")
    return {task: make_task_dataset(root / task, task=task, n_train=4, n_val=2, imgsz=IMGSZ)
            for task in ("segment", "pose")}


@pytest.mark.parametrize("task,name", [("segment", "yolo11n-seg.yaml"),
                                       ("pose", "yolo11n-pose.yaml")])
def test_facade_trains_validates_and_predicts_task_models(task_sets, task, name, tmp_path):
    """One epoch, then val (box and mask or pose mAP), predict from memory
    (Results with masks or keypoints of the boxes' rows), the best
    checkpoint loaded back with the same forward, and the CLI's task word."""
    y = YOLO(name, nc=2, device="cpu")
    assert y.task == task
    out = y.train(task_sets[task], epochs=1, batch=2, imgsz=IMGSZ, workers=0,
                  project=str(tmp_path), name="run", plots=False)
    hist = out["history"][0]
    items = ("mask_loss",) if task == "segment" else ("kpt_loss", "kobj_loss")
    assert all(k in hist and np.isfinite(hist[k]) for k in ("loss", "box_loss", *items))
    key = "mask" if task == "segment" else "pose"
    metrics = y.val(task_sets[task], batch=2, imgsz=IMGSZ)
    assert metrics["images"] == 2 and 0.0 <= metrics[f"{key}_mAP50-95"] <= 1.0
    assert f"val_{key}_mAP50" in hist
    frames = list(np.random.default_rng(33).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8))
    res = y.predict(frames, imgsz=IMGSZ, conf=0.001)
    assert len(res) == 2 and len(res[0]) > 0
    extra = res[0].masks if task == "segment" else res[0].keypoints
    assert len(extra) == len(res[0].boxes)
    assert extra.data.shape[1:] == ((48, 80) if task == "segment" else (17, 3))
    back = YOLO(str(Path(out["run_dir"]) / "best.ckpt"), device="cpu")
    assert back.task == task
    x = torch.rand((1, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = back.model(x), y.model(x)
    for u, v in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b),
                    strict=True):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    src = tmp_path / "frames"
    write_jpeg_frames(src, ((48, 80),), 2)
    entrypoint([task, "predict", f"model={Path(out['run_dir']) / 'best.ckpt'}", f"source={src}",
                "device=cpu", f"imgsz={IMGSZ}", "conf=0.001"])


def test_classify_serves_but_does_not_train_or_validate(task_sets, tmp_path, capsys):
    """A classify model predicts Probs through the letterbox lane, its
    checkpoint loads back, and train and val raise (the JAX package has no
    classify loss, loader or validator)."""
    y = YOLO("yolo11n-cls.yaml", nc=10, device="cpu")
    assert y.task == "classify" and isinstance(y.model, ClassificationModel)
    frames = list(np.random.default_rng(34).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8))
    res = y.predict(frames, imgsz=IMGSZ)
    assert len(res) == 2 and res[0].probs.data.shape == (10,) and res[0].boxes is None
    np.testing.assert_allclose(res[0].probs.data.sum(), 1.0, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="classify"):
        y.train(task_sets["segment"], epochs=1, imgsz=IMGSZ)
    with pytest.raises(NotImplementedError, match="classify"):
        y.val(task_sets["segment"], imgsz=IMGSZ)
    with pytest.raises(NotImplementedError, match="Classify"):
        Trainer(y.model)
    path = tmp_path / "cls.ckpt"
    save_deploy(path, {"params": dict(y.model.named_parameters()),
                       "batch_stats": dict(y.model.named_buffers())},
                model_yaml=y.model.yaml, nc=y.model.nc)
    back = YOLO(str(path), device="cpu")
    assert isinstance(back.model, ClassificationModel)
    np.testing.assert_array_equal(back.predict(frames, imgsz=IMGSZ)[1].probs.data,
                                  res[1].probs.data)
    src = tmp_path / "frames"
    write_jpeg_frames(src, ((48, 80),), 1)
    entrypoint(["classify", "predict", f"model={path}", f"source={src}", "device=cpu",
                f"imgsz={IMGSZ}"])
    assert "frame00.jpg" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["yolov8n-seg.yaml", "yolov8n-pose.yaml", "yolov8n-cls.yaml",
                                  "yolov8n-obb.yaml"])
def test_task_models_refuse_the_parallel_paths(name):
    """A task model does not train under a mesh (its mask and keypoint
    normalizers, or the OBB loss's, would be a rank's) and has no tensor- or spatial-parallel
    form (ROADMAP Queue 1 item 7). The v8 trunks: yolo11's C2PSA is refused
    by spatial parallelism before the head."""
    model = _undrawn(ClassificationModel if _is_cls(name) else DetectionModel, name, nc=2)
    if not _is_cls(name):
        with pytest.raises(NotImplementedError, match="mesh.*item 7"):
            Trainer(model, mesh=SimpleNamespace(device=model.device))
    with pytest.raises(NotImplementedError, match=f"{model.head_name}.*item 7"):
        model_parallel_shardings(model, TWO)
    with pytest.raises(NotImplementedError, match=f"{model.head_name}.*item 7"):
        with spatial(model, TWO):
            pass
