"""The port's yolov8n, detection metrics and DetectionValidator against the JAX package.

- `max_pool`, C2f (n = 1 and 2, with and without the shortcut), SPPF and
  the legacy (v8) Detect head with shared random variables against their
  JAX modules, float32: max |d| <= 1e-5 of the output's largest |value|
  (max pool: equal).
- yolov8n: parameter counts equal JAX's (`eval_shape`), the weight bridge
  covers every leaf, and the 64 px forward, decode and NMS match JAX with
  converted weights: boxes < 0.05 px, scores <= 1e-3 (the repo's fidelity
  bar), equal NMS counts.
- The metrics (a numpy copy): `DetMetrics.results()`,
  `COCOEvaluator.summarize()` and `ConfusionMatrix` on fixed seeded
  detections, equal to JAX's within 1e-12.
- `DetectionValidator` against JAX's on the same val batches of a shapes
  set at 64 px, for yolov8n and for yolov13n_DBL (whose DySample runs the
  plain K2 here): the same kept count per image, rows within the bar, each
  metric and COCO stat within 1e-4.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from yolo_dbl_tpu import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.data.build import DataLoader as JaxDataLoader
from yolo_dbl_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_dbl_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn import heads as JH
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_dbl_tpu.ops.resample import max_pool as jax_max_pool
from yolo_dbl_tpu.utils import metrics as JM

from yolo_dbl_tpu_torch import DetectionModel, kernels
from yolo_dbl_tpu_torch.engine.validator import DetectionValidator
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import heads as TH
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.ops.resample import max_pool
from yolo_dbl_tpu_torch.utils import metrics as TM
from yolo_dbl_tpu_torch.utils.convert import (TORCH_ONLY_SUFFIX, load_jax_variables,
                                              state_dict_from_jax)

from tests.fixtures import make_shapes_dataset
from tests.test_torch_modules import _input, jax_tree, random_variables, run_pair, to_nhwc

REPO = Path(__file__).resolve().parent.parent
IMGSZ, NC = 64, 3
MODULE_REL = 1e-5  # of the output's largest |value|
BOX_PX, SCORE = 0.05, 1e-3  # the repo's fidelity bar
METRIC_TOL = 1e-4


def _within_scale(got, want, rel=MODULE_REL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("k,s,p", [(5, 1, 2), (3, 1, 1), (3, 2, 1), (2, 2, 0)])
def test_max_pool_matches_jax(k, s, p):
    x = _input((2, 9, 11, 8), seed=k + s) - 3.0  # negative maps: the -inf padding shows
    got = max_pool(torch.from_numpy(x), k, s, p).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_max_pool(jnp.asarray(x), k, s, p)))


BLOCK_CASES = {
    "C2f_n1_shortcut": (lambda: JB.C2f(32, 1, True), lambda: TB.C2f(16, 32, 1, True)),
    "C2f_n2_shortcut": (lambda: JB.C2f(32, 2, True), lambda: TB.C2f(16, 32, 2, True)),
    "C2f_n1": (lambda: JB.C2f(32, 1, False), lambda: TB.C2f(16, 32, 1, False)),
    "C2f_n2": (lambda: JB.C2f(32, 2), lambda: TB.C2f(16, 32, 2)),
    "SPPF_k5": (lambda: JB.SPPF(24, 5), lambda: TB.SPPF(16, 24, 5)),
    "SPPF_k3": (lambda: JB.SPPF(24, 3), lambda: TB.SPPF(16, 24, 3)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_v8_block_parity(case):
    make_j, make_t = BLOCK_CASES[case]
    out_j, out_t = run_pair(make_j(), make_t(), _input((2, 10, 9, 16), seed=5))
    assert to_nhwc(out_t).shape == np.asarray(out_j).shape
    _within_scale(to_nhwc(out_t), out_j)


@pytest.mark.parametrize("nc", [3, 80])
def test_legacy_detect_parity(nc):
    ch, strides = (16, 32, 64), (8, 16, 32)
    xs = [_input((2, 8, 8, 16), 10), _input((2, 4, 4, 32), 11), _input((2, 2, 2, 64), 12)]
    out_j, out_t = run_pair(JH.Detect(nc=nc, ch=ch, legacy=True),
                            TH.Detect(nc=nc, ch=ch, legacy=True), xs)
    feats_t = [o.permute(0, 2, 3, 1) for o in out_t]
    for a, b in zip(feats_t, out_j):
        _within_scale(a.numpy(), b)
    dec_j = np.asarray(JH.decode_detections(out_j, strides, nc))
    dec_t = TH.decode_detections(feats_t, strides, nc).numpy()
    assert dec_t.shape == dec_j.shape == (2, 4 + nc, 84)
    assert np.abs(dec_t[:, :4] - dec_j[:, :4]).max() < BOX_PX
    assert np.abs(dec_t[:, 4:] - dec_j[:, 4:]).max() <= SCORE


# ---------------------------------------------------------------- yolov8n


@pytest.mark.parametrize("nc,n_params", [(80, 3157184), (3, 3011417)])
def test_v8_param_counts_match_jax(nc, n_params):
    jm = JaxDetectionModel("yolov8n.yaml", nc=nc)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    tm = DetectionModel("yolov8n.yaml", nc=nc, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == n_jax == n_params
    assert [l.args for l in tm.spec.layers] == [l.args for l in jm.spec.layers]
    assert tm.strides == jm.strides == (8, 16, 32)
    assert tm.names == jm.names and len(tm.names) == nc


def test_v8_yaml_copy_and_rows():
    port = REPO / "yolo_dbl_tpu_torch/cfg/models/v8/yolov8.yaml"
    ref = REPO / "yolo_dbl_tpu/cfg/models/v8/yolov8.yaml"
    assert port.read_bytes() == ref.read_bytes()
    spec_j = jax_parse_model_spec(yaml.safe_load(ref.read_text()) | {"scale": "n", "nc": NC})
    spec_t = T.parse_model_spec(T.yaml_model_load("yolov8n.yaml") | {"nc": NC})
    assert [(l.name, l.args, l.n) for l in spec_t.layers] == [(l.name, l.args, l.n)
                                                              for l in spec_j.layers]
    assert spec_t.layers[-1].args[-1] is True  # v8 keeps the legacy Detect
    assert T.parse_model_spec(T.yaml_model_load("yolov13n_DBL.yaml")).layers[-1].args[-1] is False


@pytest.fixture(scope="module")
def v8_pair():
    """JAX yolov8n with perturbed variables, its port loaded from them, and
    JAX's raw maps and decode on a fixed 64 px input."""
    jm = JaxDetectionModel("yolov8n.yaml", nc=NC)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(1))
    jv = jax_tree(variables)
    feats_j = jm.module.apply(jv, jnp.asarray(x))
    pred_j = jm.decode_outputs(feats_j)
    tm = DetectionModel("yolov8n.yaml", nc=NC, device="cpu")
    load_jax_variables(tm, variables)
    return dict(jm=jm, jv=jv, variables=variables, x=x, tm=tm,
                feats_j=[np.asarray(f) for f in feats_j], pred_j=np.asarray(pred_j))


def test_v8_bridge_covers_every_leaf(v8_pair):
    leaves = jax.tree_util.tree_leaves(v8_pair["variables"])
    mapped = state_dict_from_jax(v8_pair["variables"])
    own = {k for k in v8_pair["tm"].state_dict() if not k.endswith(TORCH_ONLY_SUFFIX)}
    assert len(leaves) == len(mapped) == len(own)
    assert set(mapped) == own
    names = set(mapped)
    for key in ("m2.m_0.cv1.conv.weight", "m9.cv1.bn.running_var", "m9.cv2.conv.weight",
                "m22.cv3_2_0.bn.running_mean", "m22.cv3_0_1.conv.weight", "m22.cv3_1_2.conv.bias"):
        assert key in names, key


def test_v8_bridge_rejects_unmapped_keys(v8_pair):
    bad = dict(v8_pair["variables"])
    bad["params"] = dict(bad["params"], m99={"conv": {"kernel": np.zeros((1, 1, 3, 8), np.float32)}})
    with pytest.raises(KeyError):
        load_jax_variables(DetectionModel("yolov8n.yaml", nc=NC, device="cpu"), bad)


def test_v8_forward_decode_nms_parity(v8_pair):
    x = torch.from_numpy(v8_pair["x"])
    tm = v8_pair["tm"]
    with torch.no_grad():
        feats_t = tm(x)
    for a, b in zip(feats_t, v8_pair["feats_j"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
    pred_t = tm.predict(x).numpy()
    pred_j = v8_pair["pred_j"]
    assert pred_t.shape == pred_j.shape == (2, 4 + NC, 84)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < BOX_PX
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= SCORE
    dj, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    dt, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


# ---------------------------------------------------------------- metrics


def _fixed_detections(seed, n_images=6, nc=3):
    """Per image: ground truth (boxes xyxy, classes) and detections (n, 6),
    some near the ground truth, some not, with classes that are sometimes wrong."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_images):
        g = int(rng.integers(0, 5))
        xy = rng.uniform(0, 500, (g, 2))
        wh = rng.uniform(8, 160, (g, 2))
        gt = np.concatenate([xy, xy + wh], 1)
        gt_cls = rng.integers(0, nc, g)
        idx = rng.integers(0, g, int(rng.integers(0, 8))) if g else np.zeros(0, int)
        near = gt[idx] + rng.normal(0, 6, (len(idx), 4))
        near_cls = np.where(rng.random(len(idx)) < 0.8, gt_cls[idx], rng.integers(0, nc, len(idx)))
        far = rng.uniform(0, 560, (int(rng.integers(0, 6)), 2))
        far = np.concatenate([far, far + rng.uniform(4, 120, far.shape)], 1)
        boxes = np.concatenate([near, far], 0)
        cls = np.concatenate([near_cls, rng.integers(0, nc, len(far))])
        dets = np.concatenate([boxes, rng.uniform(0.001, 1, (len(boxes), 1)), cls[:, None]], 1)
        out.append((dets.astype(np.float32), gt.astype(np.float32), gt_cls.astype(np.int32)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    images = _fixed_detections(seed)
    res = {}
    for name, M in (("jax", JM), ("port", TM)):
        det, coco, cm = M.DetMetrics(3), M.COCOEvaluator(3), M.ConfusionMatrix(3)
        for dets, gt, gt_cls in images:
            det.update(dets, gt, gt_cls)
            coco.update(dets, gt, gt_cls)
            cm.process_batch(dets, gt, gt_cls)
        res[name] = (det.results(), coco.summarize(), cm.matrix)
    (dj, cj, mj), (dt, ct, mt) = res["jax"], res["port"]
    assert dj.keys() == dt.keys() and cj.keys() == ct.keys()
    for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"):
        assert abs(dt[k] - dj[k]) <= 1e-12, k
    assert dt["per_class_ap50_95"].keys() == dj["per_class_ap50_95"].keys()
    for c, v in dj["per_class_ap50_95"].items():
        assert abs(dt["per_class_ap50_95"][c] - v) <= 1e-12
    for k, v in cj.items():
        assert abs(ct[k] - v) <= 1e-12, k
    np.testing.assert_array_equal(mt, mj)
    assert dj["mAP50"] > 0 and cj["AP50"] > 0 and mj.trace() > 0  # the data exercises them


# ---------------------------------------------------------------- validator


@pytest.fixture(scope="module")
def val_batches(tmp_path_factory):
    """The JAX loader's val batches of a shapes set (4 images at 160 px),
    letterboxed to 64 px, in batches of 2 (Python lane)."""
    root = make_shapes_dataset(tmp_path_factory.mktemp("shapes"), n_train=0, n_val=4, imgsz=160)
    mp = pytest.MonkeyPatch()
    mp.setenv("YOLO_DBL_NATIVE_LOADER", "0")
    try:
        dl = JaxDataLoader(JaxDataset(root, split="val", imgsz=IMGSZ), batch_size=2, imgsz=IMGSZ,
                           augment=False, prefetch=0)
        batches = list(dl)
    finally:
        mp.undo()
    assert len(batches) == 2 and all("labels" in b for b in batches)
    return batches


def _validate_both(jm, jv, tm, batches, tmp_path):
    """Per-batch NMS output and the metrics of both validators on `batches`."""
    jval = JaxValidator(jm, conf=0.001, iou=0.7, max_det=300, use_coco_stats=True,
                        save_json=True, save_dir=tmp_path / "jax")
    tval = DetectionValidator(tm, conf=0.001, iou=0.7, max_det=300, use_coco_stats=True,
                              save_json=True, save_dir=tmp_path / "port")
    for batch in batches:
        dj, nj = (np.asarray(a) for a in jval._infer(jv, jnp.asarray(batch["img"])))
        dt, nt = (a.numpy() for a in tval.infer(torch.from_numpy(batch["img"])))
        np.testing.assert_array_equal(nt, nj)
        for i in range(len(nt)):
            a, b = dt[i, :nt[i]], dj[i, :nj[i]]
            assert np.abs(a[:, :4] - b[:, :4]).max(initial=0) < BOX_PX
            assert np.abs(a[:, 4] - b[:, 4]).max(initial=0) <= SCORE
            np.testing.assert_array_equal(a[:, 5], b[:, 5])
    return jval(jv, batches), tval(batches)


def _gt_near_detections(jm, jv, batches, seed=0):
    """The batches with ground truth moved next to JAX's own detections (its
    top 6 an image, jittered by 2 px, a class changed now and then), so the
    metrics compared are not all 0, as they are for random weights on the
    shapes set."""
    jval = JaxValidator(jm, conf=0.001, iou=0.7, max_det=300)
    rng = np.random.default_rng(seed)
    out = []
    for batch in batches:
        dets, num = (np.asarray(a) for a in jval._infer(jv, jnp.asarray(batch["img"])))
        labels = []
        for d, k in zip(dets, num):
            d = d[:min(int(k), 6)].astype(np.float64)
            cls = np.where(rng.random(len(d)) < 0.8, d[:, 5], rng.integers(0, NC, len(d)))
            labels.append({"boxes": (d[:, :4] + rng.normal(0, 2, (len(d), 4))).astype(np.float32),
                           "cls": cls.astype(np.int32)})
        out.append({"img": batch["img"], "labels": labels})
    return out


def _check_results(rj, rt):
    for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"):
        assert abs(rt[k] - rj[k]) <= METRIC_TOL, (k, rt[k], rj[k])
    assert rt["coco_stats"].keys() == rj["coco_stats"].keys()
    for k, v in rj["coco_stats"].items():
        assert abs(rt["coco_stats"][k] - v) <= METRIC_TOL, (k, rt["coco_stats"][k], v)
    assert rt["images"] == rj["images"] == 4
    assert set(rt["speed_ms_per_image"]) == {"inference", "postprocess"}
    rows_j = json.loads(Path(rj["predictions_json"]).read_text())
    rows_t = json.loads(Path(rt["predictions_json"]).read_text())
    assert len(rows_t) == len(rows_j) > 0
    assert [r["image_id"] for r in rows_t] == [r["image_id"] for r in rows_j]
    assert [r["category_id"] for r in rows_t] == [r["category_id"] for r in rows_j]
    assert max(abs(a - b) for rt_, rj_ in zip(rows_t, rows_j)
               for a, b in zip(rt_["bbox"], rj_["bbox"])) < BOX_PX + 2e-3
    assert max(abs(rt_["score"] - rj_["score"]) for rt_, rj_ in zip(rows_t, rows_j)) <= SCORE


@pytest.mark.parametrize("form", ["labels", "gt_arrays", "gt_near_detections"])
def test_validator_matches_jax_v8(v8_pair, val_batches, form, tmp_path):
    batches = val_batches
    if form == "gt_arrays":  # the loss's normalized xywh arrays in place of `labels`
        batches = [{k: v for k, v in b.items() if k != "labels"} for b in val_batches]
    elif form == "gt_near_detections":
        batches = _gt_near_detections(v8_pair["jm"], v8_pair["jv"], val_batches)
    rj, rt = _validate_both(v8_pair["jm"], v8_pair["jv"], v8_pair["tm"], batches, tmp_path)
    _check_results(rj, rt)
    if form == "gt_near_detections":
        assert rj["mAP50"] > 0.1 and rj["coco_stats"]["AP50"] > 0.1


def test_validator_matches_jax_dbl(val_batches, tmp_path):
    """yolov13n_DBL, whose three DySample sites run K2's plain version here
    (JAX: its XLA sampler on the CPU, as its own tests run it)."""
    jm = JaxDetectionModel("yolov13n_DBL.yaml", nc=NC)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMGSZ, IMGSZ, 3)))
    variables = random_variables(shapes, np.random.default_rng(3))
    tm = load_jax_variables(DetectionModel("yolov13n_DBL.yaml", nc=NC, device="cpu"), variables)
    jv = jax_tree(variables)
    kernels.reset_launches()
    rj, rt = _validate_both(jm, jv, tm, _gt_near_detections(jm, jv, val_batches), tmp_path)
    _check_results(rj, rt)
    assert rj["mAP50"] > 0.1 and rj["coco_stats"]["AP50"] > 0.1
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)  # CPU: plain versions only


def test_validator_takes_the_models_device(monkeypatch, val_batches):
    """No CPU fallback: without CUDA no model is built unless the caller asks
    for the CPU, and a CPU model validates on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionModel("yolov8n.yaml", nc=NC)
    tm = DetectionModel("yolov8n.yaml", nc=NC, device="cpu")
    out = DetectionValidator(tm)(val_batches, max_batches=1)
    assert out["images"] == 2 and "coco_stats" not in out


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_validator_and_smoke_import_no_cv2_and_no_data():
    for f in (REPO / "yolo_dbl_tpu_torch/engine/validator.py", REPO / "chip_smoke.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] != "cv2", f"{f.name} imports {mod}"
            assert "data" not in mod.split("."), f"{f.name} imports {mod}"
    code = ("import sys; sys.modules['cv2'] = None; "
            "import yolo_dbl_tpu_torch.engine.validator, yolo_dbl_tpu_torch.engine.trainer; "
            "assert 'yolo_dbl_tpu_torch.data' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
