"""The port's `YOLO` facade, checkpoints, predictor and CLI against the JAX package.

- `YOLO.train`: yolov8n (nc=3) on a shapes set (8 train, 4 val images at
  96 px; at 64 px the box loss is ~0), batch 4, 2 epochs, mosaic 1.0,
  close_mosaic 1, seed 0, against JAX's `YOLO.train` from the same
  variables (JAX's `model.init(PRNGKey(0), imgsz=96)`, carried across by
  utils/convert.py through the port model's `init_weights`): per epoch the
  same history keys, losses within 1e-3 relative, val metrics and
  best_fitness within 1e-3; the same `results.csv` columns; `best.ckpt` and
  `last.ckpt` written.
- Resume (port only; tests/test_resume.py's three cases, which are `slow` on
  the JAX side): 2 epochs then `resume=True` to 3 equal 3 epochs straight
  through (history, parameters, EMA, BatchNorm statistics and step count
  within 1e-6); the train args come back from the checkpoint and an explicit
  argument wins; a missing checkpoint raises FileNotFoundError.
- Checkpoints: both files load with `torch.load(weights_only=True)`;
  `YOLO(best.ckpt)` predicts bit for bit what the EMA model it was saved
  from predicted; the optimizer's state_dict round trip is bitwise.
- `YOLO.predict` against JAX's on yolov13n_DBL (nc=3, 128 px; K1 and K2 run
  their plain versions) with shared variables: a directory of JPEGs of two
  sizes (two buckets), a list of uint8 frames, a float image with
  `device_preprocess=False` (the host letterbox), `classes=[1]` and
  `agnostic_nms=True`: equal kept counts, boxes within 0.05 px, scores
  within 1e-3, and `to_json_dicts`, `verbose` and `save_txt` rows within
  those bars.
- `YOLO.val` against JAX's on a shapes set whose labels sit next to the
  model's detections (random weights score 0 on the drawn shapes), with the
  native val lane on both sides: metrics within 1e-4.
- The CLI: `predict` and `val` through `entrypoint`, `checks`, `settings`,
  the unported modes exit non-zero, and the facade and CLI import no JAX.
"""

import csv
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.engine.model import YOLO as JaxYOLO
from yolo_dbl_tpu.engine.predictor import DetectionPredictor as JaxDetectionPredictor

from yolo_dbl_tpu_torch.cli import entrypoint
from yolo_dbl_tpu_torch.engine import train_state as TS
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.native import loader as native
from yolo_dbl_tpu_torch.utils.checkpoint import peek_checkpoint_meta
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables
from yolo_dbl_tpu_torch.utils.settings import SettingsManager

from tests.fixtures import make_shapes_dataset
from tests.test_torch_modules import random_variables
from tests.torch_fixtures import one_torch_thread, write_jpeg_frames  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
NC = 3
TRAIN = dict(epochs=2, batch=4, imgsz=96, mosaic=1.0, close_mosaic=1, workers=0, seed=0,
             plots=False, verbose=False)
LOSS_REL, METRIC_ABS = 1e-3, 1e-3
BOX_PX, SCORE = 0.05, 1e-3
# tests/test_resume.py's settings: a constant learning rate after warmup, no
# augmentation draws, so that a run cut after 2 epochs can be compared
RESUME = dict(batch=4, imgsz=64, lr0=0.005, lrf=1.0, warmup_epochs=1.0, mosaic=0.0, mixup=0.0,
              copy_paste=0.0, translate=0.0, scale=0.0, fliplr=0.0, hsv_h=0.0, hsv_s=0.0,
              hsv_v=0.0, erasing=0.0, close_mosaic=0, multi_scale=False, patience=100, workers=0,
              plots=False, verbose=False)
PRED_IMGSZ = 128


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _from_jax(y: YOLO, variables):
    """Make `y.train` start from JAX variables: its seeded re-initialization
    loads them instead."""
    y.model.init_weights = lambda generator: load_jax_variables(y.model, variables)
    return y


@pytest.fixture(scope="module")
def shapes96(tmp_path_factory):
    return make_shapes_dataset(tmp_path_factory.mktemp("shapes96"), n_train=8, n_val=4, imgsz=96)


@pytest.fixture(scope="module")
def trained(shapes96, tmp_path_factory):
    """The same 2-epoch run through both facades; the port's saves are
    snapshotted (the EMA model's prediction on a fixed input) as they happen."""
    runs = tmp_path_factory.mktemp("runs")
    jy = JaxYOLO("yolov8n.yaml", nc=NC)
    jout = jy.train(shapes96, project=str(runs), name="jax", **TRAIN)
    variables = _numpy(jy.model.init(jax.random.PRNGKey(0), imgsz=TRAIN["imgsz"]))
    ty = _from_jax(YOLO("yolov8n.yaml", nc=NC, device="cpu"), variables)
    probe = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32))
    saved = {}

    def snapshot(model, path):
        saved[Path(path).name] = model.trainer.ema_model().predict(probe)

    ty.add_callback("on_model_save", snapshot)
    tout = ty.train(shapes96, project=str(runs), name="port", **TRAIN)
    return dict(jout=jout, tout=tout, ty=ty, probe=probe, saved=saved)


def _close(got, want, rel=0.0, abs_=0.0):
    return abs(got - want) <= abs_ + rel * abs(want)


def test_facade_train_matches_jax(trained):
    jh, th = trained["jout"]["history"], trained["tout"]["history"]
    assert len(jh) == len(th) == TRAIN["epochs"]
    for j, t in zip(jh, th):
        assert list(j) == list(t)
        for k in j:
            if k == "seconds":
                continue
            bar = (dict(rel=LOSS_REL) if k.endswith("loss") else dict(abs_=METRIC_ABS))
            assert _close(t[k], j[k], **bar), (k, t[k], j[k])
    assert th[-1]["box_loss"] > 0.01  # the box loss takes part at 96 px
    assert _close(trained["tout"]["best_fitness"], trained["jout"]["best_fitness"], abs_=METRIC_ABS)
    heads = []
    for out in (trained["jout"], trained["tout"]):
        run = Path(out["run_dir"])
        assert (run / "best.ckpt").is_file() and (run / "last.ckpt").is_file()
        with open(run / "results.csv") as f:
            rows = list(csv.reader(f))
        assert len(rows) == TRAIN["epochs"] + 1
        heads.append(rows[0])
    assert heads[0] == heads[1]


def test_checkpoints_load_weights_only_and_predict_bitwise(trained):
    run = Path(trained["tout"]["run_dir"])
    last = torch.load(run / "last.ckpt", weights_only=True)
    best = torch.load(run / "best.ckpt", weights_only=True)
    assert set(last) == {"step", "ema_updates", "best_fitness", "epoch", "best_epoch", "params",
                         "ema_params", "batch_stats", "opt_state", "train_args", "metrics",
                         "version"}
    assert set(best) == {"variables", "model_yaml", "nc", "version"}
    assert last["step"] == 4 and last["ema_updates"] == 4.0 and last["epoch"] == 1
    assert last["train_args"]["imgsz"] == 96 and "resume" not in last["train_args"]
    y = YOLO(run / "best.ckpt", device="cpu")
    assert y.nc == NC and y.info()["parameters"] == 3011417
    torch.testing.assert_close(y.model.predict(trained["probe"]), trained["saved"]["best.ckpt"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("name,accumulate", [("SGD", False), ("AdamW", False), ("RMSProp", True)])
def test_optimizer_state_dict_round_trip_is_bitwise(name, accumulate, tmp_path):
    def make():
        model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
        torch.manual_seed(0)
        for p in model.parameters():
            p.data.normal_()
        names, params = zip(*model.named_parameters())
        opt = TS.Optimizer(names, params, name, lambda step: 0.01 * (step + 1), 0.9, 1e-3,
                           dict.fromkeys(names, True), accumulate=2 if accumulate else 1)
        return model, opt

    gen = torch.Generator().manual_seed(1)
    grads = [[torch.randn(p.shape, generator=gen) for p in make()[0].parameters()] for _ in range(5)]
    ma, a = make()
    for g in grads[:3]:
        a.step(g)
    torch.save(a.state_dict(), tmp_path / "opt.pt")
    mb, b = make()
    mb.load_state_dict(ma.state_dict())
    b.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    for g in grads[3:]:
        a.step(g)
        b.step(g)
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        assert torch.equal(pa, pb)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(
        torch.equal(x, y) for k in sa if isinstance(sa[k], list) for x, y in zip(sa[k], sb[k]))


# ------------------------------------------------------------------ resume


def _state(y: YOLO):
    sd = y.trainer.state_dict()
    return sd["step"], {**sd["params"], **{f"ema.{k}": v for k, v in sd["ema_params"].items()},
                        **sd["batch_stats"]}


def test_resume_matches_uninterrupted(shapes96, tmp_path):
    full = YOLO("yolov8n.yaml", nc=NC, device="cpu")
    out_full = full.train(shapes96, epochs=3, project=str(tmp_path), name="full", **RESUME)
    YOLO("yolov8n.yaml", nc=NC, device="cpu").train(shapes96, epochs=2, project=str(tmp_path),
                                                     name="split", **RESUME)
    split = YOLO("yolov8n.yaml", nc=NC, device="cpu")
    out = split.train(shapes96, epochs=3, resume=True, project=str(tmp_path), name="split",
                      **RESUME)
    assert [h["epoch"] for h in out["history"]] == [2]
    for k, v in out["history"][0].items():
        if k != "seconds":
            assert _close(v, out_full["history"][2][k], abs_=1e-6), k
    (step_a, a), (step_b, b) = _state(full), _state(split)
    assert step_a == step_b == 6 and a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=1e-6, msg=k)


def test_resume_restores_train_args(shapes96, tmp_path):
    YOLO("yolov8n.yaml", nc=NC, device="cpu").train(shapes96, epochs=1, project=str(tmp_path),
                                                     name="args", **RESUME)
    out = YOLO("yolov8n.yaml", nc=NC, device="cpu").train(shapes96, resume=True,
                                                           project=str(tmp_path), name="args")
    assert out["history"] == []  # epochs=1 came back from the checkpoint: nothing left to run
    y = YOLO("yolov8n.yaml", nc=NC, device="cpu")
    out = y.train(shapes96, resume=True, epochs=2, project=str(tmp_path), name="args")
    assert [h["epoch"] for h in out["history"]] == [1]
    cfg = y.trainer.cfg
    assert (cfg.imgsz, cfg.batch, cfg.lr0) == (RESUME["imgsz"], RESUME["batch"], RESUME["lr0"])
    ta = peek_checkpoint_meta(tmp_path / "args" / "last.ckpt")["train_args"]
    assert ta["imgsz"] == RESUME["imgsz"] and ta["epochs"] == 2 and "resume" not in ta
    assert y.trainer.steps == 4


def test_train_from_a_checkpoint_starts_from_the_seed(trained, shapes96, tmp_path):
    """As JAX's `setup` (yolo_dbl_tpu/engine/trainer.py:163-164), training a
    model loaded from a checkpoint draws the weights anew from `seed`: the
    run equals one from the YAML, bit for bit (ROADMAP Queue 3)."""
    outs = []
    for model in (Path(trained["tout"]["run_dir"]) / "best.ckpt", "yolov8n.yaml"):
        y = YOLO(model, nc=None if str(model).endswith(".ckpt") else NC, device="cpu")
        out = y.train(shapes96, epochs=1, project=str(tmp_path), name="seed", **RESUME)
        outs.append({k: v for k, v in out["history"][0].items() if k != "seconds"})
    assert outs[0] == outs[1]


def test_resume_missing_ckpt_raises(shapes96, tmp_path):
    with pytest.raises(FileNotFoundError):
        YOLO("yolov8n.yaml", nc=NC, device="cpu").train(
            shapes96, epochs=1, resume=True, project=str(tmp_path), name="nonexistent", **RESUME)


def test_patience_save_period_multi_scale_and_callbacks(shapes96, tmp_path):
    """patience stops the run once the best epoch is `patience` epochs old
    (random weights: fitness 0 from epoch 0 on), save_period writes
    epoch{N}.ckpt, multi_scale trains on the size ladder, and the jsonl sink
    logs each epoch and the end."""
    y = YOLO("yolov8n.yaml", nc=NC, device="cpu")
    y.callbacks.integrate("jsonl", path=tmp_path / "metrics.jsonl")
    seen = []
    y.add_callback("on_fit_epoch_end", lambda model, epoch, metrics: seen.append(epoch))
    out = y.train(shapes96, **{**RESUME, "epochs": 4, "patience": 1, "save_period": 1,
                               "multi_scale": True}, project=str(tmp_path), name="p")
    run = Path(out["run_dir"])
    assert [h["epoch"] for h in out["history"]] == seen == [0, 1]
    assert out["best_fitness"] == 0.0
    assert sorted(f.name for f in run.glob("*.ckpt")) == ["best.ckpt", "epoch0.ckpt",
                                                           "epoch1.ckpt", "last.ckpt"]
    assert all(np.isfinite(v) for h in out["history"] for v in h.values())
    events = [ln.split('"event": ')[1].split(",")[0] for ln in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert events == ['"epoch"', '"epoch"', '"train_end"']


def test_callbacks_match_jax(monkeypatch, tmp_path):
    from yolo_dbl_tpu.utils import callbacks as JC

    from yolo_dbl_tpu_torch.utils import callbacks as TC

    assert TC.HOOKS == JC.HOOKS and sorted(TC._INTEGRATIONS) == sorted(JC._INTEGRATIONS)
    cb = TC.Callbacks()
    with pytest.raises(KeyError):
        cb.add("on_nothing", print)
    with pytest.raises(KeyError):
        cb.integrate("nothing")
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # tensorflow missing: the sink does nothing
    cb.integrate("tensorboard", log_dir=tmp_path / "tb")
    cb.integrate("wandb")
    assert all(not fns for fns in cb._hooks.values()) and not (tmp_path / "tb").exists()


def test_tune_evolves_and_logs(shapes96, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the tuner writes runs/tune/ under the working directory
    y = YOLO("yolov8n.yaml", nc=NC, device="cpu")
    out = y.tune(shapes96, iterations=2, epochs=1, space={"lr0": (1e-4, 1e-2, 1.0)},
                 **{k: v for k, v in RESUME.items() if k != "lr0"})
    assert set(out["best_hyp"]) == {"lr0"} and out["best_fitness"] == 0.0
    with open(tmp_path / "runs" / "tune" / "tune_results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["iteration", "fitness", "lr0"] and len(rows) == 3


# ------------------------------------------------------------ predict, val


@pytest.fixture(scope="module")
def dbl_pair():
    """yolov13n_DBL with one set of perturbed variables on both sides."""
    jy = JaxYOLO("yolov13n_DBL.yaml", nc=NC)
    shapes = jax.eval_shape(jy.model.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, PRED_IMGSZ, PRED_IMGSZ, 3)))
    variables = random_variables(shapes, np.random.default_rng(1))
    jy.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    ty = YOLO("yolov13n_DBL.yaml", nc=NC, device="cpu")
    load_jax_variables(ty.model, variables)
    return jy, ty


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """7 JPEG frames of two sizes (96x128 and 120x200): two buckets."""
    d = tmp_path_factory.mktemp("frames")
    write_jpeg_frames(d, ((96, 128), (120, 200)), 7, seed=7)
    return d


def _check_results(got, want, tmp_path):
    assert [len(r) for r in got] == [len(r) for r in want] and sum(map(len, want)) > 0
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape and g.path == w.path
        if len(w):
            assert np.abs(g.boxes.xyxy - w.boxes.xyxy).max() < BOX_PX
            assert np.abs(g.boxes.conf - w.boxes.conf).max() <= SCORE
            np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        assert g.verbose() == w.verbose()
        for a, b in zip(g.to_json_dicts(), w.to_json_dicts()):
            assert (a["name"], a["class"]) == (b["name"], b["class"])
            assert abs(a["confidence"] - b["confidence"]) <= SCORE
            assert all(abs(a["box"][k] - b["box"][k]) < BOX_PX for k in b["box"])
        tg, tw = (np.loadtxt(r.save_txt(tmp_path / f"{n}.txt"), ndmin=2) for n, r in
                  (("g", g), ("w", w)))
        assert tg.shape == tw.shape
        if len(tw):
            h, wd = w.orig_shape
            np.testing.assert_array_equal(tg[:, 0], tw[:, 0])
            scale = np.array([wd, h, wd, h])
            assert np.abs((tg[:, 1:5] - tw[:, 1:5]) * scale).max() < BOX_PX + 1e-5 * max(h, wd)
            assert np.abs(tg[:, 5] - tw[:, 5]).max() <= SCORE + 1e-6


@pytest.fixture(scope="module")
def jax_plain(dbl_pair):
    """The predictor JAX's `YOLO.predict(source, imgsz=128, conf=0.25)`
    makes (engine/model.py `_make_predictor`), kept across cases so that
    its programs compile once for the directory and the decoded frames."""
    jy, _ = dbl_pair
    return JaxDetectionPredictor(jy.model, conf=0.25, iou=0.45, imgsz=PRED_IMGSZ)


@pytest.mark.parametrize("case", ["directory", "frames", "host_letterbox", "classes", "agnostic"])
def test_predict_matches_jax(dbl_pair, jax_plain, frames_dir, case, tmp_path):
    jy, ty = dbl_pair
    kw = dict(imgsz=PRED_IMGSZ, conf=0.25)
    paths = sorted(frames_dir.glob("*.jpg"))
    frames = [cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB) for p in paths]
    one_size = frames[0:4:2]  # one bucket: one compilation on the JAX side
    source = {"directory": str(frames_dir), "frames": frames,
              "host_letterbox": frames[1].astype(np.float32),
              "classes": one_size, "agnostic": one_size}[case]
    extra = {"host_letterbox": dict(device_preprocess=False), "classes": dict(classes=[1]),
             "agnostic": dict(agnostic_nms=True)}.get(case)
    got = ty.predict(source, **kw, **(extra or {}))
    want = jy.predict(source, **kw, **extra) if extra else jax_plain(jy.variables, source)
    _check_results(got, want, tmp_path)
    if case == "classes":
        assert all((r.boxes.cls == 1).all() for r in got)
    if case == "agnostic":
        plain = ty.predict(source, **kw)
        assert sum(map(len, got)) < sum(map(len, plain))


@pytest.fixture(scope="module")
def near_labels(dbl_pair, tmp_path_factory):
    """A shapes set relabelled with ground truth next to the model's own
    detections at 128 px (moved by up to 2 px, a class changed now and then)."""
    _, ty = dbl_pair
    root = make_shapes_dataset(tmp_path_factory.mktemp("near"), n_train=0, n_val=6, imgsz=PRED_IMGSZ)
    rng = np.random.default_rng(5)
    for r in ty.predict(str(root / "images" / "val"), imgsz=PRED_IMGSZ, conf=0.25):
        d = r.boxes.data[:6]
        xyxy = np.clip(d[:, :4] + rng.uniform(-2, 2, (len(d), 4)), 0, PRED_IMGSZ)
        cls = np.where(rng.random(len(d)) < 0.8, d[:, 5], rng.integers(0, NC, len(d)))
        xywh = np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2, (xyxy[:, 1] + xyxy[:, 3]) / 2,
                         xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]], 1) / PRED_IMGSZ
        (root / "labels" / "val" / (Path(r.path).stem + ".txt")).write_text("".join(
            f"{int(c)} {' '.join(f'{v:.6f}' for v in b)}\n" for c, b in zip(cls, xywh)))
    return root


def test_val_matches_jax_on_the_native_lane(dbl_pair, near_labels, monkeypatch):
    monkeypatch.delenv("YOLO_DBL_NATIVE_LOADER", raising=False)
    assert native.is_available(), native.build_error()
    jy, ty = dbl_pair
    kw = dict(imgsz=PRED_IMGSZ, batch=4)
    got, want = ty.val(near_labels, **kw), jy.val(near_labels, **kw)
    assert got["images"] == want["images"] == 6 and want["mAP50"] > 0.02
    for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    for k, v in want["coco_stats"].items():
        assert abs(got["coco_stats"][k] - v) <= 1e-4, k


# ---------------------------------------------------------------- the CLI


def test_cli_predict_and_val(trained, shapes96, capsys):
    best = str(Path(trained["tout"]["run_dir"]) / "best.ckpt")
    source = str(Path(shapes96) / "images" / "val")
    entrypoint(["detect", "predict", f"model={best}", f"source={source}", "imgsz=96",
                "conf=0.001", "device=cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.endswith("detections")]
    want = YOLO(best, device="cpu").predict(source, imgsz=96, conf=0.001)
    assert lines == [f"{r.path} {len(r)} detections" for r in want]
    entrypoint(["val", f"model={best}", f"data={shapes96}", "imgsz=96", "batch=4", "device=cpu"])
    out = capsys.readouterr().out
    assert "mAP50" in out and "AP50" in out


def test_cli_checks_and_settings(capsys, tmp_path, monkeypatch):
    entrypoint(["checks"])
    out = capsys.readouterr().out
    assert f"torch: {torch.__version__}" in out and "yolo_dbl_tpu_torch:" in out
    s = SettingsManager(tmp_path / "settings.json")
    assert s["runs_dir"] == "runs" and (tmp_path / "settings.json").is_file()
    s["runs_dir"] = "elsewhere"
    s.save()
    assert SettingsManager(tmp_path / "settings.json")["runs_dir"] == "elsewhere"


@pytest.mark.parametrize("argv", [["track", "source=x.mp4"], ["detect", "export"], ["benchmark"],
                                  ["solutions"], ["obb", "track"]])
def test_cli_unported_modes_exit_nonzero(argv):
    with pytest.raises(SystemExit) as e:
        entrypoint(argv)
    assert e.value.code not in (0, None) and "not ported" in str(e.value.code)


def test_facade_and_cli_import_no_jax():
    code = ("import sys; import yolo_dbl_tpu_torch.engine.model, yolo_dbl_tpu_torch.cli; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'jaxlib', 'optax', 'yolo_dbl_tpu')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
