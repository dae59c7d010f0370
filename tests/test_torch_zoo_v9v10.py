"""The v9, v10 and v7 families' configs in the port against the JAX package, on the CPU.

Thirteen YAMLs (v9/yolov9{t,s,m,c,e}, v10/yolov10{,n,s,m,b,l,x}, v7/yolov7),
copied byte for byte into the port. For each: the copy reads as PyYAML
reads it, every scale's rows are JAX's, and at nc=80 the parameter count
equals JAX's (jax.eval_shape of the JAX model) and the golden count of
tests/test_model.py less 16 where one is listed (the frozen DFL conv the
JAX package folds; yolov7 has no DFL: exactly 37,620,125 + 2,557).

Decode and NMS parity at 64 px for yolov9t, yolov9s, yolov10n and
yolov10s, from the same perturbed variables (class biases 0 in every
Detect branch, so NMS has candidates at conf 0.25): raw maps 1e-4 (both
v10 branches), boxes < 0.05 px, scores <= 1e-3, equal kept counts. The
whole-model yolov7 and yolov9e (38 and 58 M parameters) are
`compileheavy`.

One train-mode e2e loss and gradient of yolov10n against JAX's
`e2e_detect_loss`, in float64 on both sides (tests/test_torch_zoo.py's
bars), with one2one's gradient kept off the trunk; `YOLO('yolov10n.yaml')`
through the facade; the v10 checkpoint round trip; the YOLOv7 training
guard; and the parallel paths: yolov10n trained on a 2x2 mesh (data and
tensor parallel, both e2e terms under the global normalizer) and yolov9t
served tensor-parallel on 1x2, each against the one-process run, and the
rows spatial and tensor parallelism refuse.
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

from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.losses.extra import e2e_detect_loss as jax_e2e_detect_loss
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.nn.tasks import YOLOModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.engine.trainer import Trainer, train_loss
from yolo_dbl_tpu_torch.losses.extra import e2e_detect_loss
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
from yolo_dbl_tpu_torch.parallel.spatial import spatial
from yolo_dbl_tpu_torch.utils.checkpoint import save_deploy
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables, params_from_jax, state_dict_from_jax

from tests import torch_ranks as R
from tests.fixtures import make_shapes_dataset
from tests.test_torch_modules import jax_tree, random_variables
from tests.test_torch_train import TRAIN_OVERRIDES, _train_batches
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
IMGSZ = 64
# {YAML: (its folder, the golden counts of tests/test_model.py:111-197 by model name)}
ZOO = {
    "yolov9t": ("v9", {}),
    "yolov9s": ("v9", {"yolov9s.yaml": 7318368}),
    "yolov9m": ("v9", {"yolov9m.yaml": 20216160}),
    "yolov9c": ("v9", {"yolov9c.yaml": 25590912}),
    "yolov9e": ("v9", {"yolov9e.yaml": 58206592}),
    "yolov10": ("v10", {}),
    "yolov10n": ("v10", {"yolov10n.yaml": 2775520}),
    "yolov10s": ("v10", {}),
    "yolov10m": ("v10", {}),
    "yolov10b": ("v10", {}),
    "yolov10l": ("v10", {}),
    "yolov10x": ("v10", {"yolov10x.yaml": 31808960}),
    "yolov7": ("v7", {}),
}
YOLOV7_PARAMS = 37620125 + 2557  # tests/test_model.py:111: no DFL conv to fold
DECODED = ("yolov9t", "yolov9s", "yolov10n", "yolov10s")
BIG = ("yolov7", "yolov9e")
NC = 3


def _paths(name):
    folder = ZOO[name][0]
    return (REPO / f"yolo_dbl_tpu_torch/cfg/models/{folder}/{name}.yaml",
            REPO / f"yolo_dbl_tpu/cfg/models/{folder}/{name}.yaml")


def _scaled(name, scale):
    return re.sub(r"^(yolo(?:v)?\d+)", rf"\g<1>{scale}", name)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_v9v10_yaml_copies_and_rows(name):
    """The port's copy is byte for byte JAX's and reads as PyYAML reads it;
    every scale's rows (and the name itself) are JAX's."""
    port, ref = _paths(name)
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(ref.read_text())
    scales = yaml.safe_load(ref.read_text()).get("scales") or {}
    models = {f"{name}.yaml"} | {_scaled(name, s) + ".yaml" for s in scales if name == "yolov10"}
    for model in sorted(models):
        spec_j = jax_parse_model_spec(jax_yaml_model_load(model) | {"nc": 80})
        spec_t = T.parse_model_spec(T.yaml_model_load(model) | {"nc": 80})
        assert spec_t.scale == spec_j.scale
        assert [(l.f, l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
            [(l.f, l.name, l.args, l.c2, l.n) for l in spec_j.layers]
        assert spec_t.save == spec_j.save


def _undrawn(model, **kw):
    """DetectionModel(model, ...) on the CPU without its own draw of the
    weights (seconds for 20-58 M parameters): every test that reads these
    weights loads JAX's first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        return DetectionModel(model, device="cpu", **kw)


@functools.cache
def _models(name):
    """The JAX module, the JAX variables' shapes at 64 px and the port model
    of `name` at nc=80, built once for the file."""
    spec = jax_parse_model_spec(jax_yaml_model_load(f"{name}.yaml") | {"nc": 80})
    module = YOLOModel(spec)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((2, IMGSZ, IMGSZ, 3)))
    return module, shapes, _undrawn(f"{name}.yaml", nc=80)


@functools.cache
def _jax_model(name):
    return JaxDetectionModel(f"{name}.yaml", nc=80)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_v9v10_params_match_jax(name):
    _, shapes, tm = _models(name)
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    for model, golden in ZOO[name][1].items():
        assert n == golden - 16, model
    if name == "yolov7":
        assert n == YOLOV7_PARAMS
    assert tm.strides == (8, 16, 32)
    assert tm.head_name == {"v7": "IDetect", "v9": "Detect", "v10": "v10Detect"}[ZOO[name][0]]


def _zero_class_biases(head):
    """Zero the class biases of a JAX head's params (a Detect's, or each of
    v10Detect's branches)."""
    for branch in (head[k] for k in ("one2many", "one2one")) if "one2one" in head else [head]:
        for sub in branch:
            if sub.startswith("cv3_") and sub.endswith("_2"):
                branch[sub]["conv"]["bias"][:] = 0.0


def _maps(out):
    """The raw maps of a forward, in order (both v10 branches)."""
    if isinstance(out, dict):
        return [np.asarray(f) for k in ("one2many", "one2one") for f in out[k]]
    return [np.asarray(f) for f in out]


def _check_decode(name):
    _, shapes, tm = _models(name)
    jm = _jax_model(name)
    assert jm.strides == tm.strides and jm.head_name == tm.head_name
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    variables = random_variables(shapes, np.random.default_rng(1))
    if jm.head_name != "IDetect":
        _zero_class_biases(variables["params"][f"m{len(jm.spec.layers) - 1}"])
    run = jax.jit(lambda v, img: (lambda f: (f, jm.decode_outputs(f)))(jm.module.apply(v, img)))
    feats_j, pred_j = run(jax_tree(variables), jnp.asarray(x))
    load_jax_variables(tm, variables)
    with torch.no_grad():
        feats_t = tm(torch.from_numpy(x))
        pred_t = tm.predict(torch.from_numpy(x)).numpy()
    for a, b in zip(_maps(feats_t), _maps(feats_j), strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    pred_j = np.asarray(pred_j)
    na = 3 if jm.head_name == "IDetect" else 1
    assert pred_t.shape == pred_j.shape == (2, 4 + 80, na * (64 + 16 + 4))
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    assert 0.0 <= pred_t[:, 4:].min() and pred_t[:, 4:].max() <= 1.0
    _, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    _, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


@pytest.mark.parametrize("name", DECODED)
def test_v9v10_forward_decode_nms_parity(name):
    _check_decode(name)


@pytest.mark.compileheavy
@pytest.mark.parametrize("name", BIG)
def test_v9v10_big_forward_decode_nms_parity(name):
    """yolov7 (IDetect through decode_v7) and yolov9e (CBLinear, CBFuse,
    Silence) whole at 64 px."""
    _check_decode(name)


def _v10n_float64(batch, cfg):
    """JAX's float64 e2e loss, items and gradient of yolov10n (nc=80) at 64
    px in train mode, and the variables it started from."""
    with jax.enable_x64(True):
        jm = JaxDetectionModel("yolov10n.yaml", nc=80, dtype=jnp.float64)
        shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, IMGSZ, IMGSZ, 3), jnp.float64))
        variables = random_variables(shapes, np.random.default_rng(43))
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(params, batch_stats, b):
            outs, mut = jm.module.apply({"params": params, "batch_stats": batch_stats},
                                        jax_device_normalize(b["img"], jnp.float64), train=True,
                                        mutable=["batch_stats"])
            total, items = jax_e2e_detect_loss(outs, b, jm.strides, 80, box_gain=cfg.box,
                                               cls_gain=cfg.cls, dfl_gain=cfg.dfl)
            return total, (items, mut["batch_stats"])

        (loss, (items, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jv["params"], jv["batch_stats"], {k: jnp.asarray(v) for k, v in batch.items()})
        return variables, float(loss), jax.tree_util.tree_map(np.asarray, (items, grads, stats))


def test_v10_e2e_loss_gradients_and_batch_stats_match_jax():
    """One train-mode e2e loss (one2many at TAL top-10 plus one2one at
    top-1) and gradient of yolov10n at nc=80, 64 px, batch 2, and the
    BatchNorm statistics it leaves, in float64 on both sides. Bars: loss
    and items 1e-6 relative, gradients within 1e-5 of each leaf's largest
    plus 1e-12 of the model's largest, statistics 1e-6; the float32 loss
    items 1e-5 relative. `train_loss`
    returns the sum and one2many's items, as JAX's `_task_loss`; the
    one2one term's gradient reaches only the one2one branch."""
    batch = _train_batches(1, seed=44)[0]
    cfg = get_cfg()
    variables, loss_j, (items_j, grads_j, stats_j) = _v10n_float64(batch, cfg)
    _, _, tm = _models("yolov10n")
    load_jax_variables(tm, variables)
    m64 = tm.double()
    b64 = {k: torch.as_tensor(v) for k, v in batch.items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in b64.items()}
    names, params = zip(*m64.named_parameters())
    try:
        loss_t, items_t = train_loss(m64, cfg, b64)
        grads_t = dict(zip(names, torch.autograd.grad(loss_t, params)))
        own = {k: v.clone() for k, v in m64.state_dict().items()}
        m64.train()
        total, both = e2e_detect_loss(m64(b64["img"].double() / 255.0), b64, m64.strides, 80,
                                      box_gain=cfg.box, cls_gain=cfg.cls, dfl_gain=cfg.dfl)
        l_one = (sum(both["one2one"]) * 2)
        g_one = torch.autograd.grad(l_one, params, allow_unused=True)
    finally:
        tm.float().eval()  # the shared model goes back to float32
    np.testing.assert_allclose(float(loss_t.detach()), loss_j, rtol=1e-6)
    # the loss runs in float32 on both sides (both cast the maps, JAX's
    # detection.py:87): one2many's box and DFL items, sums over its top-10
    # foreground, part by 1.5e-6 and 1.7e-6 relative (~13 float32 spacings)
    for a, b in zip(items_t, items_j["one2many"]):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    assert float(items_j["one2one"].box) > 0
    np.testing.assert_allclose(float(total.detach()), loss_j, rtol=1e-6)
    gj = params_from_jax(tm, grads_j)
    g_max = max(float(np.abs(g.numpy()).max()) for g in gj.values())
    for n, g in grads_t.items():
        ref = gj[n].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, err_msg=n,
                                   atol=1e-5 * np.abs(ref).max() + 1e-12 * g_max)
    reached = {n for n, g in zip(names, g_one) if g is not None and bool(g.abs().max() > 0)}
    assert reached and all(n.startswith("m23.one2one.") for n in reached)
    stats = state_dict_from_jax({"batch_stats": stats_j})
    assert len(stats) > 100
    for k, v in stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def shapes64(tmp_path_factory):
    return make_shapes_dataset(tmp_path_factory.mktemp("shapes64"), n_train=4, n_val=2, imgsz=64)


def test_facade_trains_validates_and_predicts_yolov10n(shapes64, tmp_path):
    y = YOLO("yolov10n.yaml", nc=3, device="cpu")
    assert y.model.yaml["yaml_file"].endswith("v10/yolov10n.yaml") and y.model.spec.scale == "n"
    out = y.train(shapes64, epochs=1, batch=4, imgsz=IMGSZ, workers=0, project=str(tmp_path),
                  name="run", plots=False)
    hist = out["history"][0]
    assert all(np.isfinite(v) for v in hist.values() if isinstance(v, float))
    metrics = y.val(shapes64, batch=2, imgsz=IMGSZ)
    assert 0.0 <= metrics["mAP50"] <= 1.0
    res = y.predict(np.random.default_rng(0).integers(0, 256, (IMGSZ, 80, 3), dtype=np.uint8),
                    imgsz=IMGSZ, conf=0.001)
    assert len(res) == 1 and res[0].boxes.data.shape[1] == 6


def test_v10_checkpoint_round_trip_keeps_both_branches(tmp_path):
    """A deploy checkpoint of yolov10n holds both branches; YOLO('x.ckpt')
    loads them and gives the same forward, one2many included."""
    y = YOLO("yolov10n.yaml", nc=3, device="cpu")
    with torch.no_grad():
        for p in y.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.01)
    path = tmp_path / "best.ckpt"
    save_deploy(path, {"params": dict(y.model.named_parameters()),
                       "batch_stats": {k: v for k, v in y.model.named_buffers()}},
                model_yaml=y.model.yaml, nc=y.model.nc)
    back = YOLO(str(path), device="cpu")
    assert back.model.head_name == "v10Detect"
    x = torch.rand((1, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = back.model(x), y.model(x)
    assert set(a) == {"one2many", "one2one"}
    for k in a:
        for u, v in zip(a[k], b[k], strict=True):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert not torch.equal(a["one2many"][0], a["one2one"][0])


def test_yolov7_does_not_train():
    """JAX's `_task_loss` hands IDetect's 5-D maps to `detection_loss`, which
    cannot read them: the JAX package has no IDetect loss, and the port
    invents none. It serves and validates only."""
    _, _, tm = _models("yolov7")
    with pytest.raises(NotImplementedError, match="no IDetect loss"):
        Trainer(tm)
    with pytest.raises(NotImplementedError, match="no IDetect loss"):
        train_loss(tm, get_cfg(), {"img": torch.zeros((1, IMGSZ, IMGSZ, 3), dtype=torch.uint8)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DetectionModel, "init_weights", lambda self, generator: None)
        y = YOLO("yolov7.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match="no IDetect loss"):
        y.train("no dataset is read", epochs=1)


# ---------------------------------------------------------------- parallel paths

TWO = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)


@pytest.mark.parametrize("name,match", [
    ("yolov9t", "AConv has no spatial"), ("yolov9c", "ADown has no spatial"),
    ("yolov9e", "CBFuse rows"), ("yolov7", "MP rows"), ("yolov10n", "V10Attention")])
def test_spatial_parallelism_refuses_the_rows_it_cannot_shard(name, match):
    with pytest.raises(NotImplementedError, match=f"{match}.*item 7"):
        with spatial(_models(name)[2], TWO):
            pass


def test_tensor_parallelism_refuses_idetect():
    with pytest.raises(NotImplementedError, match="IDetect.*item 7"):
        model_parallel_shardings(_models("yolov7")[2], TWO)


def _one_process_steps(cfg, weights, batches, float64=False):
    model = DetectionModel(cfg, nc=NC, device="cpu")
    model.load_state_dict(weights)
    if float64:
        model.double()
    trainer = Trainer(model, TRAIN_OVERRIDES).setup(5)
    params = [{n: p.detach().clone() for n, p in model.named_parameters()}]
    losses = []
    for b in batches:
        losses.append({k: float(v) for k, v in trainer.step(b).items()})
        params.append({n: p.detach().clone() for n, p in model.named_parameters()})
    return losses, params


def test_v10_trains_data_and_tensor_parallel_as_one_process():
    """yolov10n (nc=3, 64 px, global batch 2, SGD) on a 2x2 mesh (Gloo, four
    processes): each data rank holds one image, each e2e term takes the
    global normalizer, and TP shards the large kernels. Two steps against
    the one-process Trainer: loss items 1e-4 relative; the second step's
    update within 1e-3 of each leaf's largest plus two float32 spacings of
    the leaf (tests/test_torch_train.py's update bar) or, where float32
    itself does not reach that, within 4x the one-process float32 update's
    own distance from the float64 one (chip_smoke.py's train_parity rule):
    at 64 px and one image a data rank the first BatchNorm biases' float32
    updates are ~1e-4 from float64's, and the leaves whose exact gradient
    is 0 (a bias before a conv and BatchNorm) move by float32 noise alone."""
    cfg = "yolov10n.yaml"
    weights = DetectionModel(cfg, nc=NC, device="cpu",
                             generator=torch.Generator().manual_seed(5)).state_dict()
    batches = _train_batches(2, seed=45)
    losses, params = _one_process_steps(cfg, weights, batches)
    _, params64 = _one_process_steps(cfg, weights, batches, float64=True)
    ranks = R.launch(R.tp_trainer_rank, 4, cfg, NC, {k: v.numpy() for k, v in weights.items()},
                     TRAIN_OVERRIDES, 5, batches, n_model=2)
    head = ranks[0]
    assert head["sharded"] > 10
    assert all(r["losses"] == head["losses"] for r in ranks)
    for lt, lo in zip(head["losses"], losses, strict=True):
        assert set(lt) == {"loss", "box_loss", "cls_loss", "dfl_loss"}
        for k in lt:
            assert abs(lt[k] - lo[k]) <= 1e-4 * abs(lo[k]), (k, lt[k], lo[k])
    for n, p2 in params[2].items():
        want = (p2 - params[1][n]).numpy()
        exact = (params64[2][n] - params64[1][n]).numpy()
        got = head["params"][2][n] - head["params"][1][n]
        ulp = np.spacing(np.abs(p2.numpy()).max())
        bar = max(1e-3 * np.abs(want).max() + 2 * ulp, 4 * np.abs(want - exact).max())
        np.testing.assert_allclose(got, want, atol=bar, rtol=0, err_msg=n)


def test_v9_serves_tensor_parallel_as_one_process():
    """yolov9t (nc=3, 64 px; RepConv, RepNCSPELAN4, ELAN1, AConv, SPPELAN)
    tensor-parallel on 1x2 (Gloo, two processes) against the one-process
    predict: boxes < 0.05 px, scores <= 1e-3."""
    cfg = "yolov9t.yaml"
    model = DetectionModel(cfg, nc=NC, device="cpu", generator=torch.Generator().manual_seed(6))
    model.zero_class_biases()
    x = np.random.default_rng(7).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = model.predict(torch.from_numpy(x)).numpy()
    ranks = R.launch(R.tp_predict_rank, 2, cfg, NC,
                     {k: v.numpy() for k, v in model.state_dict().items()}, x, n_model=2)
    assert all(r[True]["param_bytes"] < sum(p.numel() * 4 for p in model.parameters())
               for r in ranks)
    for r in ranks:
        got = r[True]["pred"]
        assert got.shape == want.shape
        assert np.abs(got[:, :4] - want[:, :4]).max() < 0.05
        assert np.abs(got[:, 4:] - want[:, 4:]).max() <= 1e-3
