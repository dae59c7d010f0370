"""RT-DETR's configs in the port against the JAX package, on the CPU.

The four `rt-detr/` YAMLs (rtdetr-l, rtdetr-x, rtdetr-resnet50,
rtdetr-resnet101), copied byte for byte into the port: each reads as PyYAML
reads it, its rows are JAX's (AIFI's channels prepended, the HG rows
unscaled with HGBlock's repeat as an argument, RepC3 scaled with its
repeat inserted, the decoder's channel list) and its parameter count is
tests/test_model.py's golden.

rtdetr-l whole, from one set of perturbed variables (`detr_variables`),
drawn once from `jax.eval_shape` of the JAX model's init: its decode at
128 px (336 tokens, so the top-300 selects) within 0.05 px and 1e-3,
row for row; one train step at 64 px (batch 2; 84 tokens, all selected)
against JAX's jitted `jax.value_and_grad` of `rtdetr_loss` over the
module's train-mode apply, in float64 on both sides (the 2x2 P5 map's
train-mode BatchNorm): the matchings equal, the loss items within 1e-4
relative and the gradient within 1e-3 of each leaf's largest.

Then the refusals: the predictor, the validator and `YOLO.train` (JAX's
predictor hands the decode's (B, Q, 6) rows to NMS, shown here on the same
model), training under a mesh or in bfloat16, and tensor and spatial
parallelism.
"""

import copy
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_dbl_tpu.engine.predictor import DetectionPredictor as JaxDetectionPredictor
from yolo_dbl_tpu.losses import detr as JD
from yolo_dbl_tpu.models.rtdetr import rtdetr_postprocess as jax_postprocess
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
from yolo_dbl_tpu_torch.engine.trainer import Trainer, check_trainable, train_loss
from yolo_dbl_tpu_torch.engine.validator import DetectionValidator
from yolo_dbl_tpu_torch.losses import detr as TD
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
from yolo_dbl_tpu_torch.parallel.spatial import spatial
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables, params_from_jax

from tests.fixtures import make_shapes_dataset
from tests.test_torch_modules import jax_tree
from tests.test_torch_rtdetr import detr_variables
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
TWO = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)
# tests/test_model.py's goldens (no DFL fold in a DETR head)
PARAMS = {"rtdetr-l": 32970476, "rtdetr-x": 67467852, "rtdetr-resnet50": 42925132,
          "rtdetr-resnet101": 61917260}
DECODE_PX, TRAIN_PX = 128, 64


def _undrawn(cfg, **kw):
    """The port's model on the CPU without its own draw of the weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        return DetectionModel(cfg, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_rtdetr_yaml_copies_rows_and_params(name):
    port = REPO / f"yolo_dbl_tpu_torch/cfg/models/rt-detr/{name}.yaml"
    ref = REPO / f"yolo_dbl_tpu/cfg/models/rt-detr/{name}.yaml"
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(ref.read_text())
    spec_j = jax_parse_model_spec(jax_yaml_model_load(f"{name}.yaml"))
    spec_t = T.parse_model_spec(T.yaml_model_load(f"{name}.yaml"))
    assert spec_t.scale == spec_j.scale
    assert [(l.f, l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
        [(l.f, l.name, l.args, l.c2, l.n) for l in spec_j.layers]
    assert spec_t.save == spec_j.save
    tm = _undrawn(f"{name}.yaml", nc=80)
    assert sum(p.numel() for p in tm.parameters()) == PARAMS[name]
    assert tm.head_name == "RTDETRDecoder" and tm.strides == (8, 16, 32)


@functools.cache
def _pair():
    """The JAX rtdetr-l (nc=80), shared perturbed variables and the port's
    model holding them."""
    jm = JaxDetectionModel("rtdetr-l.yaml", nc=80)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, TRAIN_PX, TRAIN_PX, 3)))
    variables = detr_variables(shapes, np.random.default_rng(61))
    tm = _undrawn("rtdetr-l.yaml", nc=80)
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _frames(px, seed):
    return np.random.default_rng(seed).uniform(0, 1, (2, px, px, 3)).astype(np.float32)


@functools.cache
def _decodes():
    """(JAX raw outputs, JAX decode, port raw outputs, port decode) at 128 px."""
    jm, variables, tm = _pair()
    x = _frames(DECODE_PX, 62)
    out_j = jax.jit(lambda v, a: jm.apply(v, a))(jax_tree(variables), jnp.asarray(x))
    dets_j = np.asarray(jm.decode_outputs(out_j, img_size=DECODE_PX))
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x))
    return out_j, dets_j, out_t, tm.predict(torch.from_numpy(x)).numpy()


def test_rtdetr_l_decode_matches_jax_at_128():
    """336 tokens for 300 queries: the top-k selects. The decoder's outputs
    within 1e-4 of their largest, and `predict`'s rows (rtdetr_postprocess:
    xyxy pixels, score, class, sorted) within 0.05 px and 1e-3 with equal
    classes, row for row."""
    out_j, dets_j, out_t, dets_t = _decodes()
    assert out_t[0].shape == (2, 6, 300, 4) and out_t[1].shape == (2, 6, 300, 80)
    for a, b in zip(out_t, out_j, strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(1.0, np.abs(b).max()), rtol=0)
    assert dets_t.shape == dets_j.shape == (2, 300, 6)
    assert np.abs(dets_t[..., :4] - dets_j[..., :4]).max() < 0.05
    assert np.abs(dets_t[..., 4] - dets_j[..., 4]).max() <= 1e-3
    np.testing.assert_array_equal(dets_t[..., 5], dets_j[..., 5])
    assert (np.diff(dets_t[..., 4], axis=1) <= 0).all() and dets_t[..., 4].max() > 0.5


def _train_batch(seed, b=2, m=6, nc=80):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.25, 0.75, (b, m, 2))
    wh = rng.uniform(0.1, 0.4, (b, m, 2))
    mask = (np.arange(m)[None] < np.array([[3], [6]])).astype(np.float32)
    return {"img": rng.integers(0, 256, (b, TRAIN_PX, TRAIN_PX, 3), dtype=np.uint8),
            "gt_boxes": (np.concatenate([xy, wh], -1) * mask[..., None]).astype(np.float32),
            "gt_cls": rng.integers(0, nc, (b, m)).astype(np.int32), "gt_mask": mask}


def test_rtdetr_l_train_step_matches_jax():
    """One train-mode loss and gradient at 64 px, batch 2 (84 tokens: every
    one a query), against JAX's jitted `jax.value_and_grad` of
    `rtdetr_loss` over the module's train-mode apply (`make_train_step`'s
    loss function without the optimizer), both in float64 (JAX under
    jax.enable_x64): at 64 px the P5 map is 2x2, so train-mode BatchNorm
    normalizes 8 values a channel, and the port's float32 run parts from
    JAX's float64 one by 0.34% of the decoder scores' largest (its float64
    run by 1.5e-7). Every matching equal; the items (GIoU, class, L1) and
    the total within 1e-4 relative; each leaf's gradient within 1e-3 of its
    largest (plus 1e-10 of the model's largest, for leaves whose exact
    gradient is 0: the class embedding's on both sides). Then the float32
    model's `Trainer.step` runs on the same batch with finite metrics."""
    _, variables, tm = _pair()
    batch = _train_batch(63)
    solved, solve = {"jax": [], "port": []}, (JD._lsa_host, TD._lsa_host)

    def record(side, fn):
        return lambda cost, counts: solved[side].append(fn(cost, counts)) or solved[side][-1]

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "_lsa_host", record("jax", solve[0]))
        jm = JaxDetectionModel("rtdetr-l.yaml", nc=80, dtype=jnp.float64)
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        img = jnp.asarray(batch["img"], jnp.float64) / 255.0

        def loss_fn(params):
            out, _ = jm.module.apply({"params": params, "batch_stats": wide["batch_stats"]},
                                     img, train=True, mutable=["batch_stats"])
            return JD.rtdetr_loss(out, batch, 80)

        (loss_j, items_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            wide["params"])
        grads_j = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, grads_j))

    trainer = Trainer(tm, {"batch": 2, "imgsz": TRAIN_PX}).setup(5)
    model = copy.deepcopy(tm).double()
    names, params = zip(*model.named_parameters())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "_lsa_host", record("port", solve[1]))
        loss_t, items_t = train_loss(model, trainer.cfg, trainer.to_device(batch))
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, params, materialize_grads=True)))
    assert len(solved["port"]) == len(solved["jax"]) == 1
    np.testing.assert_array_equal(solved["port"][0], solved["jax"][0])
    for k, v in items_t._asdict().items():
        assert abs(float(v.detach()) - float(items_j[k])) <= 1e-4 * abs(float(items_j[k])), k
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    g_max = max(float(g.abs().max()) for g in grads_j.values())
    for n in names:
        ref = grads_j[n]
        tol = 1e-3 * float(ref.abs().max()) + 1e-10 * g_max
        assert float((grads_t[n] - ref).abs().max()) <= tol, n
    assert not grads_t["m28.denoising_class_embed.weight"].any()
    metrics = trainer.step(batch)
    assert list(metrics) == ["loss", "giou_loss", "cls_loss", "l1_loss"]
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_rtdetr_refuses_predictor_validator_and_facade_training(tmp_path):
    """The port's predictor, validator and `YOLO.train` raise on RT-DETR
    (ROADMAP Queue 3), where JAX's predictor hands `rtdetr_postprocess`'s
    sorted (B, Q, 6) rows to NMS as a (B, 4+nc, A) decode: on the same
    model and frames at conf 0, its kept rows are not the decode's rows."""
    jm, variables, tm = _pair()
    out_j, dets_j, _, _ = _decodes()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        DetectionPredictor(tm)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        DetectionValidator(tm)
    data = make_shapes_dataset(tmp_path / "shapes", n_train=2, n_val=2, imgsz=64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        yolo = YOLO("rtdetr-l.yaml", nc=80, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        yolo.train(data, epochs=1, batch=2, imgsz=64, workers=0)
    assert yolo.trainer is None
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        yolo.predict(np.zeros((64, 64, 3), np.uint8))
    # JAX's predictor (its `infer`: the model's decode, then NMS) on the same decode at
    # conf 0: NMS reads the (B, 300, 6) rows as a (B, 4+nc, A) decode, 296 "classes" at 6
    # "anchors", and keeps rows of classes the 80-class model does not have
    jp = JaxDetectionPredictor(jm, conf=0.0, imgsz=DECODE_PX)
    jp.model = SimpleNamespace(predict=lambda v, x: jnp.asarray(dets_j), nc=80)
    dets, counts = jp.infer(jax_tree(variables), None)
    rows = np.asarray(dets)[0, : int(counts[0])]
    assert rows.shape[1] == 6 and rows[:, 5].max() >= 80
    assert not (len(rows) == len(dets_j[0]) and np.allclose(rows, dets_j[0], atol=0.05))
    np.testing.assert_allclose(np.asarray(jax_postprocess(out_j[0], out_j[1], DECODE_PX)), dets_j)


def test_rtdetr_refuses_mesh_bf16_training_tp_and_sp():
    tm = _pair()[2]
    mesh = SimpleNamespace(device=tm.device)
    with pytest.raises(NotImplementedError, match="under a mesh"):
        check_trainable(tm, mesh)
    with pytest.raises(NotImplementedError, match="float32 only"):
        check_trainable(_undrawn("rtdetr-resnet50.yaml", nc=80, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="no tensor-parallel form"):
        model_parallel_shardings(tm, TWO)
    with pytest.raises(NotImplementedError, match="no spatial-parallel form"):
        with spatial(tm, TWO):
            pass
