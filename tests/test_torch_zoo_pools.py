"""The module pools' configs and YOLO-World in the port against the JAX package, on the CPU.

Six YAMLs (11/yolo11-C3k2_EFE-IRSTE, v12/YOLO-EMAC, v5/FFCA-YOLO,
v5/FFCA-YOLO-L, v8/yolov8-world, v8/yolov8-worldv2), copied byte for byte
into the port: each reads as PyYAML reads it, every scale's rows are JAX's
(FFCA-YOLO-L's stray "anchors" dropped, its top-level multiples; the
`default` scale as the first key), and the parameter counts are
jax.eval_shape's of the JAX model and tests/test_model.py's goldens.

Whole-model parity at 64 px from the same perturbed variables (class
biases 0, the world heads' contrastive bias 0), each config at scale n
where the YAML has one (YOLO-EMAC through a dict with scale "n"): raw maps
within 1e-4 of their largest magnitude, the decode's boxes within 0.05 px and
scores within 1e-3. WorldModel: JAX's seeded `txt_feats`, an explicit
text, and `set_classes` with 5 prompts. One yolov8n-worldv2 train step
against JAX's `make_train_step` (loss items 1e-4 relative) and its
gradient against JAX's (1e-3 of each leaf's largest), on the zero text.
Then the facade and the CLI on yolov8n-worldv2, and the refusals of
tensor and spatial parallelism.
"""

import copy
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from yolo_dbl_tpu.cfg import get_cfg as jax_get_cfg
from yolo_dbl_tpu.engine import train_state as JS
from yolo_dbl_tpu.engine.trainer import make_train_step as jax_make_train_step
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.nn.tasks import WorldModel as JaxWorldModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load

from yolo_dbl_tpu_torch import DetectionModel, WorldModel
from yolo_dbl_tpu_torch.cli import entrypoint
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.engine.trainer import Trainer, train_loss
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
from yolo_dbl_tpu_torch.parallel.spatial import spatial
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables, params_from_jax

from tests.fixtures import make_shapes_dataset
from tests.test_torch_pools import pool_variables
from tests.test_torch_modules import jax_tree
from tests.torch_fixtures import one_torch_thread, write_jpeg_frames  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
IMGSZ = 64
TWO = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)
# {YAML: its folder}
FOLDERS = {"yolo11-C3k2_EFE-IRSTE": "11", "YOLO-EMAC": "v12", "FFCA-YOLO": "v5",
           "FFCA-YOLO-L": "v5", "yolov8-world": "v8", "yolov8-worldv2": "v8"}
# {model: (YAML, scale or None for the name's own, parameters at nc=80)}: tests/test_model.py's
# goldens less the 16 of the DFL fold (IRSTE at n less the reference's dead Sobel and FGM
# weights too), else the JAX model's own count
PARAMS = {
    "FFCA-YOLO.yaml": ("FFCA-YOLO", None, 8485818),
    "FFCA-YOLO-L.yaml": ("FFCA-YOLO-L", None, 5258778),
    "YOLO-EMAC.yaml": ("YOLO-EMAC", None, 13008930 - 16),
    "yolo11n-C3k2_EFE-IRSTE.yaml": ("yolo11-C3k2_EFE-IRSTE", None,
                                    3051968 - 16 - 18 * (16 + 32 + 64 + 128) - 20 * 80),
    "yolov8n-world.yaml": ("yolov8-world", None, 4204095),
    "yolov8n-worldv2.yaml": ("yolov8-worldv2", None, 3695167),
    "yolov8s-worldv2.yaml": ("yolov8-worldv2", None, 12759864),
    "YOLO-EMAC-n": ("YOLO-EMAC", "n", None),
}
# the configs held whole at 64 px: n where the YAML has scales (YOLO-EMAC by dict)
DECODE = ("FFCA-YOLO.yaml", "FFCA-YOLO-L.yaml", "YOLO-EMAC-n", "yolo11n-C3k2_EFE-IRSTE.yaml",
          "yolov8n-world.yaml", "yolov8n-worldv2.yaml")


def _paths(name):
    folder = FOLDERS[name]
    return (REPO / f"yolo_dbl_tpu_torch/cfg/models/{folder}/{name}.yaml",
            REPO / f"yolo_dbl_tpu/cfg/models/{folder}/{name}.yaml")


def _cfg(load, model):
    """The config dict of `model` by `load` (either side's yaml_model_load),
    its scale set where PARAMS names one."""
    yaml_name, scale, _ = PARAMS.get(model, (None, None, None))
    d = load(f"{yaml_name}.yaml" if scale else model)
    if scale:
        d["scale"] = scale
    return d


def _is_world(model):
    return "world" in model


@pytest.mark.parametrize("name", sorted(FOLDERS))
def test_pool_yaml_copies_and_rows(name):
    """The port's copy is byte for byte JAX's and reads as PyYAML reads it;
    every scale's rows (C2fAttn's embed and heads, the FFM splits,
    ImagePoolingAttn's and WorldDetect's widths, M2C2f's positional
    `residual`) are JAX's."""
    port, ref = _paths(name)
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(ref.read_text())
    scales = yaml.safe_load(ref.read_text()).get("scales") or {"": None}
    for scale in scales:
        dj, dt = jax_yaml_model_load(f"{name}.yaml"), T.yaml_model_load(f"{name}.yaml")
        dj["scale"] = dt["scale"] = scale
        spec_j, spec_t = jax_parse_model_spec(dj), T.parse_model_spec(dt)
        assert spec_t.scale == spec_j.scale
        assert [(l.f, l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
            [(l.f, l.name, l.args, l.c2, l.n) for l in spec_j.layers], (name, scale)
        assert spec_t.save == spec_j.save
    if name == "FFCA-YOLO-L":
        assert spec_t.layers[-1].args[0] == 8 and "anchors" not in spec_t.layers[-1].args
    if name in ("FFCA-YOLO", "YOLO-EMAC", "yolo11-C3k2_EFE-IRSTE"):  # the `default` key first
        assert T.parse_model_spec(T.yaml_model_load(f"{name}.yaml")).scale == "default"


def _undrawn(cls, cfg, **kw):
    """`cls(cfg, ...)` on the CPU without its own draw of the weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        return cls(cfg, device="cpu", **kw)


def _jax_init(jm, b=2, imgsz=IMGSZ):
    """The JAX model's variables' shapes (a world model's init takes a text)."""
    x = jnp.zeros((b, imgsz, imgsz, 3))
    if isinstance(jm, JaxWorldModel):
        txt = jnp.zeros((b, jm.spec.nc, 512))
        return jax.eval_shape(lambda k: jm.module.init(k, x, text=txt), jax.random.PRNGKey(0))
    return jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), x)


@functools.cache
def _jax_model(model):
    """The JAX model at nc=80 and its variables' shapes."""
    jm = (JaxWorldModel if _is_world(model) else JaxDetectionModel)(
        _cfg(jax_yaml_model_load, model), nc=80)
    return jm, _jax_init(jm)


@functools.cache
def _port_model(model):
    """The port's model at nc=80, its weights undrawn."""
    return _undrawn(WorldModel if _is_world(model) else DetectionModel,
                    _cfg(T.yaml_model_load, model), nc=80)


@functools.cache
def _jax_forward(model):
    """The JAX model's jitted apply, taking the text explicitly for a world model."""
    jm, _ = _jax_model(model)
    if _is_world(model):
        return jax.jit(lambda v, x, t: jm.apply(v, x, text=t))
    return jax.jit(lambda v, x, t: jm.apply(v, x))


@pytest.mark.parametrize("model", [m for m, v in PARAMS.items() if v[2] is not None])
def test_pool_params_match_jax(model):
    jm, shapes = _jax_model(model)
    tm = _port_model(model)
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n == PARAMS[model][2]
    assert tm.strides == tuple(jm.strides) == ((4, 8, 16) if "FFCA" in model else (8, 16, 32))
    assert tm.head_name == jm.head_name


@functools.cache
def _pair(model):
    """The JAX model, shared variables (class biases 0; a world head's
    contrastive bias 0) and the port model."""
    world = _is_world(model)
    jm, shapes = _jax_model(model)
    variables = pool_variables(shapes, np.random.default_rng(51))
    head = variables["params"][f"m{len(jm.spec.layers) - 1}"]
    for sub, leaf in head.items():
        if sub.startswith("cv3_") and sub.endswith("_2") and not world:
            leaf["conv"]["bias"][:] = 0.0
        if sub.startswith("cv4_"):
            leaf["bias"][:] = 0.0
    tm = _port_model(model)
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _frames(seed=52):
    return np.random.default_rng(seed).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)


def _check_decode(feats_t, feats_j, pred_t, pred_j, nc):
    for a, b in zip(feats_t, feats_j, strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(1.0, np.abs(b).max()), rtol=0)
    assert pred_t.shape == pred_j.shape and pred_t.shape[1] == 4 + nc
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    assert pred_j[:, 4:].max() > 0.05  # the scores are not all near 0


@pytest.mark.parametrize("model", DECODE)
def test_pool_model_decode_parity(model):
    """Raw maps within 1e-4 of their largest magnitude (at least 1e-4); the
    decode's boxes within 0.05 px and scores within 1e-3. A world model
    scores against its seeded `txt_feats` on both sides."""
    jm, variables, tm = _pair(model)
    x = _frames()
    text = jm._text(2) if _is_world(model) else None
    feats_j = _jax_forward(model)(jax_tree(variables), jnp.asarray(x), text)
    pred_j = np.asarray(jm.decode_outputs(feats_j))
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
    _check_decode(feats_t, feats_j, tm.predict(torch.from_numpy(x)).numpy(), pred_j, 80)


def test_world_model_text_feats_text_and_set_classes():
    """WorldModel's `txt_feats` is JAX's seeded (1, nc, 512) buffer, not
    normalized; an explicit text reaches the same maps on both sides; and
    after `set_classes` with 5 prompts both decode (B, 4+5, A)."""
    jm, variables, tm = _pair("yolov8n-world.yaml")
    np.testing.assert_array_equal(tm.txt_feats.numpy(), np.asarray(jm.txt_feats))
    assert tm.txt_feats.shape == (1, 80, 512) and abs(float(tm.txt_feats.norm(dim=-1)[0, 0]) - 1) > 1
    x = _frames(53)
    text = np.random.default_rng(54).normal(0, 1, (2, 80, 512)).astype(np.float32)
    feats_j = _jax_forward("yolov8n-world.yaml")(jax_tree(variables), jnp.asarray(x),
                                                 jnp.asarray(text))
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x), torch.from_numpy(text))
    for a, b in zip(feats_t, feats_j, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-4 * max(1.0, float(np.abs(b).max())), rtol=0)
    emb = np.random.default_rng(55).normal(0, 1, (5, 512)).astype(np.float32)
    jw = copy.copy(jm)
    jw.set_classes(emb, names=list("abcde"))
    tw = copy.deepcopy(tm)
    tw.set_classes(emb, names=list("abcde"))
    assert tw.nc == jw.nc == 5 and tw.names == jw.names == dict(enumerate("abcde"))
    np.testing.assert_allclose(tw.txt_feats.numpy(), np.asarray(jw.txt_feats), atol=1e-6)
    feats_j = _jax_forward("yolov8n-world.yaml")(jax_tree(variables), jnp.asarray(x), jw._text(2))
    pred_j = np.asarray(jw.decode_outputs(feats_j))
    with torch.no_grad():
        feats_t = tw(torch.from_numpy(x))
    pred_t = tw.predict(torch.from_numpy(x)).numpy()
    assert pred_t.shape == (2, 4 + 5, 84)
    _check_decode(feats_t, feats_j, pred_t, pred_j, 5)


# an optax transform that keeps the step's gradient as its state and updates nothing: one
# compiled `make_train_step` gives the loss items and the gradient
GRADIENT_TX = optax.GradientTransformation(
    lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def _world_batch(seed, b=2, m=6, nc=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.25, 0.75, (b, m, 2))
    wh = rng.uniform(0.1, 0.4, (b, m, 2))
    mask = (np.arange(m)[None] < np.array([[2], [5]])).astype(np.float32)
    return {"img": rng.integers(0, 256, (b, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "gt_boxes": (np.concatenate([xy, wh], -1) * mask[..., None]).astype(np.float32),
            "gt_cls": rng.integers(0, nc, (b, m)).astype(np.int32), "gt_mask": mask}


def test_world_train_step_matches_jax_on_the_zero_text():
    """One yolov8n-worldv2 (nc=4) train step at 64 px, batch 2: the loss
    items of JAX's `make_train_step` within 1e-4 relative, and the loss's
    gradient (the step's, kept by GRADIENT_TX) within 1e-3 of each leaf's
    largest. Both sides train on the
    zero text (JAX's step applies the module without one): the port's
    loss does not move when `txt_feats` does."""
    nc, spe = 4, 5
    overrides = dict(batch=2, epochs=10, imgsz=IMGSZ, optimizer="SGD", lr0=0.01)
    jm = JaxWorldModel("yolov8n-worldv2.yaml", nc=nc)
    variables = pool_variables(_jax_init(jm, 2), np.random.default_rng(56))
    batch = _world_batch(57)
    state = JS.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), GRADIENT_TX)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax_make_train_step(jm, jax_get_cfg(overrides=overrides), GRADIENT_TX))
    state, metrics = step(state, jb, jax.random.PRNGKey(0))
    grads_j = jax.tree_util.tree_map(np.asarray, state.opt_state)
    losses_j = {k: float(v) for k, v in metrics.items()}

    tm = _undrawn(WorldModel, "yolov8n-worldv2.yaml", nc=nc)
    load_jax_variables(tm, variables)
    trainer = Trainer(tm, overrides).setup(spe)
    probe = copy.deepcopy(tm)
    params = [p for _, p in probe.named_parameters()]
    loss, _ = train_loss(probe, trainer.cfg, trainer.to_device(batch))
    grads_t = dict(zip([n for n, _ in probe.named_parameters()], torch.autograd.grad(loss, params)))
    probe.txt_feats = torch.randn(1, nc, 512)
    with torch.no_grad():
        assert float(train_loss(probe, trainer.cfg, trainer.to_device(batch))[0]) == float(loss)
    losses_t = {k: float(v) for k, v in trainer.step(batch).items()}

    assert set(losses_t) == set(losses_j) and losses_j["box_loss"] > 0
    for k in losses_t:
        np.testing.assert_allclose(losses_t[k], losses_j[k], rtol=1e-4, err_msg=k)
    gj = params_from_jax(tm, grads_j)
    assert set(gj) == set(grads_t)
    for n, g in grads_t.items():
        scale = float(gj[n].abs().max())
        np.testing.assert_allclose(g.numpy(), gj[n].numpy(), atol=1e-3 * scale + 1e-8, rtol=0,
                                   err_msg=n)
    # on the zero text the class logits are the contrastive bias alone: the
    # embedding branch and the logit scale get no gradient, on both sides
    assert all(float(gj[n].abs().max()) == 0 for n in gj if ".cv4_0." in n and "logit" in n)


# ---------------------------------------------------------------- facade and CLI

@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    return make_shapes_dataset(tmp_path_factory.mktemp("shapes"), n_train=4, n_val=2, imgsz=IMGSZ)


def test_facade_trains_validates_and_predicts_a_world_model(shapes, tmp_path):
    """yolov8n-worldv2 through YOLO: a WorldModel (by the name's stem) trains
    one epoch, validates and predicts with its `txt_feats`; its checkpoint
    reloads as a plain DetectionModel, which scores against the zero text
    (as JAX's facade reloads it)."""
    y = YOLO("yolov8n-worldv2.yaml", nc=2, device="cpu")
    assert isinstance(y.model, WorldModel) and y.task == "detect"
    out = y.train(shapes, epochs=1, batch=2, imgsz=IMGSZ, workers=0, project=str(tmp_path),
                  name="run", plots=False)
    hist = out["history"][0]
    assert y.trainer.steps == 2
    assert all(np.isfinite(hist[k]) for k in ("loss", "box_loss", "cls_loss", "dfl_loss",
                                              "val_mAP50"))
    metrics = y.val(shapes, batch=2, imgsz=IMGSZ)
    assert metrics["images"] == 2 and 0.0 <= metrics["mAP50-95"] <= 1.0
    frames = list(np.random.default_rng(58).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8))
    res = y.predict(frames, imgsz=IMGSZ, conf=0.001)
    assert len(res) == 2 and np.isfinite(res[0].boxes.data).all()
    back = YOLO(str(Path(out["run_dir"]) / "best.ckpt"), device="cpu")
    assert type(back.model) is DetectionModel and back.model.takes_text
    x = torch.rand((1, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = back.model(x), y.model.forward_text(x)
    for u, v in zip(a, b, strict=True):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_cli_trains_and_predicts_a_world_model(shapes, tmp_path, capsys):
    entrypoint(["detect", "train", "model=yolov8n-worldv2.yaml", f"data={shapes}", "nc=2",
                "epochs=1", "batch=2", f"imgsz={IMGSZ}", "workers=0", "device=cpu",
                f"project={tmp_path}", "name=cli", "plots=False"])
    best = tmp_path / "cli" / "best.ckpt"
    assert "best fitness" in capsys.readouterr().out and best.is_file()
    src = tmp_path / "frames"
    write_jpeg_frames(src, ((48, 80),), 2)
    entrypoint(["detect", "predict", f"model={best}", f"source={src}", "device=cpu",
                f"imgsz={IMGSZ}", "conf=0.001"])
    assert "frame00.jpg" in capsys.readouterr().out


@pytest.mark.parametrize("model", DECODE)
def test_pool_models_refuse_the_parallel_paths(model):
    """The pools' blocks have no tensor- or spatial-parallel form (ROADMAP
    Queue 1 item 7): their Dense, LayerNorm and Conv1d layers, FFTs, window
    padding, global poolings and text inputs."""
    tm = _port_model(model)
    with pytest.raises(NotImplementedError, match="item 7"):
        model_parallel_shardings(tm, TWO)
    with pytest.raises(NotImplementedError, match="item 7"):
        with spatial(tm, TWO):
            pass
