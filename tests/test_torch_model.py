"""The PyTorch port's YOLO-DBL model and serving path against the JAX package.

yolov13n_DBL at 64 px, nc=3, with one set of perturbed variables bridged
from the JAX tree into the port. Bars: raw Detect maps within 1e-4,
decoded boxes within 0.05 px and scores within 1e-3 (the repo's fidelity
bar, README "Forward-output fidelity"), equal NMS counts. Also: the weight
bridge covers every leaf both ways, n/s parameter counts and layer widths
equal the JAX ones, the port imports nothing of JAX, and entry points do
not fall back to the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from yolo_dbl_tpu import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.engine.predictor import BasePredictor
from yolo_dbl_tpu.kernels.preprocess import letterbox_geometry as jax_letterbox_geometry
from yolo_dbl_tpu.kernels.preprocess import letterbox_normalize as jax_letterbox
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel, kernels
from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.convert import (TORCH_ONLY_SUFFIX, load_jax_variables,
                                              state_dict_from_jax)
from yolo_dbl_tpu_torch.utils.device import resolve_device

from tests.test_torch_modules import random_variables

REPO = Path(__file__).resolve().parent.parent
IMGSZ, NC = 64, 3


@pytest.fixture(scope="module")
def pair():
    """JAX n-scale model with perturbed variables, its port loaded from them,
    and the JAX raw maps + decoded predictions on a fixed input."""
    jm = JaxDetectionModel("yolov13n_DBL.yaml", nc=NC)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(1))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    run = jax.jit(lambda v, img: (lambda f: (f, jm.decode_outputs(f)))(jm.module.apply(v, img)))
    feats_j, pred_j = run(jv, jnp.asarray(x))
    tm = DetectionModel("yolov13n_DBL.yaml", nc=NC, device="cpu")
    load_jax_variables(tm, variables)
    return dict(jm=jm, jv=jv, variables=variables, run=run, x=x, tm=tm,
                feats_j=[np.asarray(f) for f in feats_j], pred_j=np.asarray(pred_j))


def test_forward_decode_nms_parity(pair):
    x = torch.from_numpy(pair["x"])
    tm = pair["tm"]
    with torch.no_grad():
        feats_t = tm(x)
    for a, b in zip(feats_t, pair["feats_j"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
    pred_t = tm.predict(x).numpy()
    pred_j = pair["pred_j"]
    assert pred_t.shape == pred_j.shape == (2, 4 + NC, 84)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    dj, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    dt, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


def test_u8_frames_to_boxes_parity(pair):
    """The slice end to end: u8 frames → letterbox (K1) → forward (K2 inside
    DySample) → decode → NMS → boxes in source pixels, against the JAX
    package's u8 lane (Pallas letterbox in interpret mode)."""
    frames = np.random.default_rng(2).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    img_j = jax_letterbox(jnp.asarray(frames), (IMGSZ, IMGSZ), scaleup=False, interpret=True)
    _, pred_j = pair["run"](pair["jv"], img_j)
    dj, nj = jax_nms(pred_j, conf_thres=0.25, iou_thres=0.45)
    gain, _, _, top, left = jax_letterbox_geometry(48, 80, IMGSZ, IMGSZ, scaleup=False)
    ref = [BasePredictor._rescale_boxes(np.asarray(dj[i][: int(nj[i])]), gain,
                                        (float(left), float(top)), (48, 80)) for i in range(2)]
    out = DetectionPredictor(pair["tm"], imgsz=IMGSZ)(frames)
    assert [len(o) for o in out] == [len(r) for r in ref] and len(out[0]) > 0
    for o, r in zip(out, ref):
        assert np.abs(o[:, :4] - r[:, :4]).max() < 0.05
        assert np.abs(o[:, 4] - r[:, 4]).max() <= 1e-3
        np.testing.assert_array_equal(o[:, 5], r[:, 5])


def test_bridge_covers_every_leaf(pair):
    leaves = jax.tree_util.tree_leaves(pair["variables"])
    mapped = state_dict_from_jax(pair["variables"])
    own = {k for k in pair["tm"].state_dict() if not k.endswith(TORCH_ONLY_SUFFIX)}
    assert len(leaves) == len(mapped) == 603
    assert set(mapped) == own


def test_bridge_rejects_unmapped_keys():
    bad = {"params": {"m0": {"conv": {"kernel": np.zeros((3, 3, 3, 8), np.float32)}}}}
    with pytest.raises(KeyError):
        load_jax_variables(DetectionModel("yolov13n_DBL.yaml", nc=NC, device="cpu"), bad)
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": {"m0": {"weird": np.zeros(3, np.float32)}}})


@pytest.mark.parametrize("scale", ["n", "s"])
def test_param_counts_and_widths_match_jax(scale):
    name = f"yolov13{scale}_DBL.yaml"
    jm = JaxDetectionModel(name, nc=NC)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    tm = DetectionModel(name, nc=NC, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert [l.c2 for l in tm.spec.layers] == [l.c2 for l in jm.spec.layers]
    assert [l.args for l in tm.spec.layers] == [l.args for l in jm.spec.layers]
    assert tm.strides == jm.strides == (8, 16, 32)
    if scale == "s":
        assert [l.c2 for l in tm.spec.layers][:12] == [16, 32, 32, 64, 64, 128, 128, 256, 256,
                                                       256, 512, 512]
        sites = {}
        for i in (13, 18, 22):
            getattr(tm, f"m{i}").register_forward_hook(
                lambda mod, inp, out, i=i: sites.__setitem__(i, tuple(inp[0].shape[1:])))
        tm.to("meta")(torch.zeros((1, 640, 640, 3), device="meta"))
        assert sites == {13: (256, 40, 40), 18: (512, 20, 20), 22: (256, 40, 40)}


def test_yaml_copy_and_reader():
    port = REPO / "yolo_dbl_tpu_torch/cfg/models/v13/yolov13_DBL.yaml"
    ref = REPO / "yolo_dbl_tpu/cfg/models/v13/yolov13_DBL.yaml"
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(port.read_text())
    spec_j = jax_parse_model_spec(yaml.safe_load(ref.read_text()) | {"scale": "s", "nc": NC})
    spec_t = T.parse_model_spec(T.yaml_model_load("yolov13s_DBL.yaml") | {"nc": NC})
    assert [l.args for l in spec_t.layers] == [l.args for l in spec_j.layers]


def test_unported_module_raises():
    d = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "C2f", [32]]], "head": []}
    with pytest.raises(NotImplementedError, match="C2f"):
        T.parse_model_spec(d)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "yolo_dbl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    banned = {"jax", "flax", "yolo_dbl_tpu", "jaxlib", "optax"}
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, f"{f.relative_to(REPO)} imports {mod}"


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionModel("yolov13n_DBL.yaml", nc=NC)
    assert resolve_device("cpu").type == "cpu"


def test_cpu_path_launches_no_kernel(pair):
    kernels.reset_launches()
    frames = np.zeros((1, 40, 40, 3), np.uint8)
    DetectionPredictor(pair["tm"], imgsz=IMGSZ)(frames)
    assert kernels.launches == {"letterbox_normalize": 0, "sample_bilinear": 0,
                                "sample_bilinear_backward": 0, "area_attention": 0,
                                "area_attention_backward_dq": 0,
                                "area_attention_backward_dkv": 0}
