"""The port's data parallelism (parallel/, the mesh paths of Trainer, YOLO and
DataLoader, utils/elastic.py) against the JAX package, on the CPU.

The ranks are processes joined by a Gloo group (tests/torch_ranks.py: two
spawned processes, a `file://` store, one torch thread each); JAX runs its
2-device CPU mesh. Bars:
- `host_shard_indices` and the ranks' rows of `DataLoader` batches, joined:
  JAX's, bit for bit (augmentation on, 0 and 2 workers);
- cross-rank BatchNorm, half a batch a rank, against flax's BatchNorm on
  the whole batch: output, running statistics and the gradients of the
  input, weight and bias within 1e-5; in bfloat16 the output within one
  bfloat16 step of flax's, the input gradient within one of flax's float32
  one on the same bfloat16 input (flax rounds that gradient's terms to
  bfloat16 one by one, the port rounds their sum once);
- the detection loss: the ranks' shares summed, and the gradient with
  respect to the predictions, within 1e-5 of JAX's on the global batch;
- the slice as a whole: three steps of the port's `Trainer(mesh=...)`
  (yolov13n_DBL, 64 px, global batch 2) against JAX's
  `Trainer(mesh=make_mesh(n_data=2, ...))` from the same variables, at
  tests/test_torch_train.py's `check_train_*` bars (losses 1e-4; updates,
  EMA lag 1e-3 of their largest; BatchNorm statistics 1e-4), every
  parameter, statistic and EMA tensor bit for bit equal on the two ranks;
- the facade (yolov8n, 64 px, global batch 4, 2 epochs): rank 0 alone
  writes the run directory and runs the callbacks, both ranks return one
  history, within the facade tests' bars (losses 1e-3 relative, metrics
  1e-3) of the one-process `YOLO.train`, and 1 epoch and a resume give the
  2-epoch history (within 1e-6);
- the elastic supervisor: a child killed after an epoch is relaunched and
  the run trains every epoch.
"""

import csv
import json
from pathlib import Path
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.data.build import DataLoader as JaxDataLoader
from yolo_dbl_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_dbl_tpu.engine.trainer import Trainer as JaxTrainer
from yolo_dbl_tpu.losses import detection as JD
from yolo_dbl_tpu.parallel import input as JI
from yolo_dbl_tpu.parallel.mesh import make_mesh as jax_make_mesh

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.data.build import DataLoader
from yolo_dbl_tpu_torch.data.dataset import YOLODataset
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.parallel import (Mesh, MultiHostLoader, host_shard_indices, make_mesh,
                                         shard_batch)
from yolo_dbl_tpu_torch.utils.checkpoint import peek_checkpoint_meta
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables
from yolo_dbl_tpu_torch.utils.elastic import elastic_train

from tests import torch_ranks as R
from tests.conftest import cpu_devices
from tests.fixtures import make_shapes_dataset
from tests.test_torch_modules import random_variables
from tests.test_torch_train import (BATCH, IMGSZ, TRAIN_OVERRIDES, _NoDropout, _det_inputs,
                                    _train_batches, check_train_losses,
                                    check_train_updates_and_batch_stats)
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

NC, WORLD, TOL = 3, 2, 1e-5
CPU = torch.device("cpu")


def _rank(r, world=WORLD):
    """Rank r's view of a mesh with no process group (its rows, no collectives)."""
    return Mesh(rank=r, world=world, device=CPU)


# ---------------------------------------------------------------- input


@pytest.mark.parametrize("n,seed,epoch,count", [(103, 1, 2, 4), (16, 0, 0, 2), (17, 3, 5, 2),
                                                (5, 7, 1, 8), (64, 2, 3, 1)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_host_shard_indices_match_jax(n, seed, epoch, count, shuffle):
    for i in range(count):
        got = host_shard_indices(n, seed, epoch, shuffle, process_index=i, process_count=count)
        want = JI.host_shard_indices(n, seed, epoch, shuffle, process_index=i,
                                     process_count=count)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_multihost_loader_rows_are_jax_host_shards():
    ds = [{"img": np.full((4, 4, 3), i, np.float32), "y": np.int32(i)} for i in range(20)]
    for r in range(WORLD):
        loader = MultiHostLoader(ds, global_batch=8, mesh=_rank(r), seed=0)
        loader.set_epoch(1)
        idx = JI.host_shard_indices(20, 0, 1, process_index=r, process_count=WORLD)
        batches = list(loader)
        assert len(batches) == len(loader) == 2
        for i, b in enumerate(batches):
            np.testing.assert_array_equal(b["y"].numpy(), idx[i * 4:(i + 1) * 4])
    with pytest.raises(ValueError, match="does not split"):
        MultiHostLoader(ds, global_batch=7, mesh=_rank(0), seed=0)


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    return make_shapes_dataset(tmp_path_factory.mktemp("shapes"), n_train=8, n_val=4, imgsz=96)


@pytest.mark.parametrize("workers", [0, 2])
def test_rank_batches_joined_are_jax_global_batches(shapes, workers, monkeypatch):
    monkeypatch.setenv("YOLO_DBL_NATIVE_LOADER", "0")
    kw = dict(batch_size=4, imgsz=64, augment=True, max_gt=16, seed=3, workers=workers,
              hyp={"mosaic": 1.0, "degrees": 10.0, "fliplr": 0.5, "erasing": 0.4})
    want = JaxDataLoader(JaxDataset(shapes, split="train", imgsz=64), **kw)
    want = [list(want) for _ in range(2)]
    ranks = []
    for r in range(WORLD):
        loader = DataLoader(YOLODataset(shapes, split="train", imgsz=64), mesh=_rank(r), **kw)
        ranks.append([list(loader) for _ in range(2)])
        loader.close()
    for e in range(2):
        assert len(want[e]) == 2
        for i, w in enumerate(want[e]):
            parts = [ranks[r][e][i] for r in range(WORLD)]
            assert all(len(p["img"]) == 2 for p in parts)
            for k in ("img", "gt_boxes", "gt_cls", "gt_mask", "indices"):
                got = np.concatenate([p[k] for p in parts])
                assert got.dtype == w[k].dtype, k
                np.testing.assert_array_equal(got, w[k], err_msg=k)
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(YOLODataset(shapes, split="train", imgsz=64), batch_size=5, mesh=_rank(0))


# ---------------------------------------------------------------- mesh


def test_mesh_of_one_process_and_its_errors():
    mesh = make_mesh(devices="cpu")
    assert (mesh.rank, mesh.world, mesh.device, mesh.group) == (0, 1, CPU, None)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.is_main
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        make_mesh(n_data=1, n_model=2, devices="cpu")
    with pytest.raises(ValueError, match="n_data=2"):
        make_mesh(n_data=2, devices="cpu")
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA card"):
        make_mesh(devices="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()  # the default device is the card: no CPU fallback
    batch = {"img": np.arange(24).reshape(6, 4), "n": np.int32(3), "labels": ["a"]}
    rows = [shard_batch(_rank(r, 3), batch) for r in range(3)]
    np.testing.assert_array_equal(torch.cat([b["img"] for b in rows]).numpy(), batch["img"])
    assert int(rows[2]["n"]) == 3 and rows[1]["labels"] == ["a"]
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        shard_batch(_rank(0, 4), batch)


# ---------------------------------------------------------------- BatchNorm and loss


def _bf16_step(a):
    """One bfloat16 step (2^-7 of the binade) at each element of `a`."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_rank_batch_norm_matches_flax_on_the_whole_batch(dtype):
    rng = np.random.default_rng(30)
    x = rng.normal(1.0, 2.0, (4, 6, 5, 8)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    b = rng.normal(0.0, 0.2, 8).astype(np.float32)
    dy = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jbn = flax.linen.BatchNorm(momentum=0.97, epsilon=1e-3, dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)
    v = jbn.init(jax.random.PRNGKey(0), xj, use_running_average=False)
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}

    def f(xx, p):
        y, mut = jbn.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                           use_running_average=False, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * dy).sum(), (y, mut["batch_stats"])

    (_, (yj, stats)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(xj, params)
    if dtype == "bfloat16":
        # flax's bfloat16 input gradient is the sum of its terms (the
        # cotangents of x's two casts to float32) each rounded to bfloat16;
        # the port rounds their float32 sum once. Its yardstick is flax's
        # float32 BatchNorm on the same bfloat16 input and output gradient.
        jbn32 = flax.linen.BatchNorm(momentum=0.97, epsilon=1e-3)
        dy16 = np.asarray(jnp.asarray(dy).astype(jnp.bfloat16).astype(jnp.float32))

        def f32(xx):
            y, _ = jbn32.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                               use_running_average=False, mutable=["batch_stats"])
            return (y * dy16).sum()

        gx = jax.grad(f32)(xj.astype(jnp.float32))
    ranks = R.launch(R.batch_norm_rank, WORLD, x, w, b, dy, dtype, 0.03, 1e-3)
    got = {k: np.concatenate([r[k] for r in ranks]) for k in ("y", "dx")}
    assert all(r["y_dtype"] == f"torch.{dtype}" for r in ranks)
    for k, want in (("y", yj), ("dx", gx)):
        want = np.asarray(want.astype(jnp.float32))
        bar = TOL if dtype == "float32" else _bf16_step(want) + 1e-6
        np.testing.assert_array_less(np.abs(got[k] - want), bar + TOL * np.abs(want).max(),
                                     err_msg=k)
    for k, name in (("mean", "mean"), ("var", "var")):
        for r in ranks:  # every rank holds the global statistics
            np.testing.assert_allclose(r[k], np.asarray(stats[name]), atol=TOL, rtol=TOL)
    for k, name in (("dw", "scale"), ("db", "bias")):
        want = np.asarray(gp[name])
        np.testing.assert_allclose(sum(r[k] for r in ranks), want, atol=TOL * np.abs(want).max(),
                                   rtol=0, err_msg=k)


def test_detection_loss_shares_sum_to_jax_global_loss():
    feats, batch = _det_inputs(31, b=4)
    batch["gt_mask"] = (np.arange(6)[None] < np.array([[4], [2], [0], [6]])).astype(np.float32)
    strides = (8, 16, 32)

    def jloss(fs):
        return JD.detection_loss(fs, {k: jnp.asarray(v) for k, v in batch.items()}, strides, NC)

    (total_j, items_j), grads_j = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(f) for f in feats])
    ranks = R.launch(R.detection_loss_rank, WORLD, feats, batch, strides, NC)
    assert abs(ranks[0]["total"] - ranks[1]["total"]) > 1e-3  # shares, not copies
    np.testing.assert_allclose(sum(r["total"] for r in ranks), float(total_j), rtol=TOL)
    for i, want in enumerate(items_j):
        np.testing.assert_allclose(sum(r["items"][i] for r in ranks), float(want), rtol=TOL)
    for lvl, g in enumerate(grads_j):
        g = np.asarray(g)
        got = np.concatenate([r["grads"][lvl] for r in ranks])
        np.testing.assert_allclose(got, g, atol=TOL * np.abs(g).max(), rtol=0)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def dp_run():
    """Three steps of the port's Trainer over a Gloo mesh of two ranks and of
    JAX's Trainer over a 2-device CPU mesh, from the same variables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        return _dp_run()


def _dp_run(cfg="yolov13n_DBL.yaml", spe=5):
    jm = JaxDetectionModel(cfg, nc=NC)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((BATCH, IMGSZ, IMGSZ, 3), jnp.float32))
    variables = random_variables(shapes, np.random.default_rng(18))
    batches = _train_batches(3)
    jm.init = lambda rng, imgsz=None: jax.tree_util.tree_map(jnp.asarray, variables)
    mesh = jax_make_mesh(n_data=WORLD, devices=cpu_devices(WORLD))
    trainer = JaxTrainer(jm, TRAIN_OVERRIDES, mesh=mesh).setup(spe)
    assert trainer.state.params["m0"]["conv"]["kernel"].sharding.is_fully_replicated
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731 (donated buffers)
    states, losses_j = [numpy(trainer.state)], []
    for b in batches:
        metrics = trainer.step(b, jax.random.PRNGKey(0))
        losses_j.append({k: float(v) for k, v in metrics.items()})
        states.append(numpy(trainer.state))
    ranks = R.launch(R.trainer_rank, WORLD, cfg, NC, variables, TRAIN_OVERRIDES, spe, batches, 40)
    head = ranks[0]
    tm = DetectionModel(cfg, nc=NC, device="cpu")
    tm.load_state_dict({**{n: torch.from_numpy(v) for n, v in head["params"][-1].items()},
                        **{k: torch.from_numpy(v) for k, v in head["batch_stats"].items()}})
    return dict(tm=tm.eval(), states=states, losses_j=losses_j, losses_t=head["losses"],
                params_t=[{n: torch.from_numpy(v) for n, v in p.items()} for p in head["params"]],
                trainer=SimpleNamespace(ema=[torch.from_numpy(e) for e in head["ema"]]),
                variables=variables, ranks=ranks)


def test_dp_train_steps_match_jax_mesh_losses(dp_run):
    check_train_losses(dp_run)
    assert [r["losses"] for r in dp_run["ranks"]] == [dp_run["losses_t"]] * WORLD


def test_dp_train_steps_match_jax_mesh_updates_stats_and_ema(dp_run):
    check_train_updates_and_batch_stats(dp_run)


def test_dp_ranks_start_from_rank_0_and_stay_bit_identical(dp_run):
    ranks = dp_run["ranks"]
    assert len({r["checksum"] for r in ranks}) == 1  # parameters, statistics, EMA
    assert all(r["steps"] == 3 and not r["training"] for r in ranks)
    # rank 1 perturbed its weights before setup: the broadcast gave it rank 0's
    start = DetectionModel("yolov13n_DBL.yaml", nc=NC, device="cpu")
    load_jax_variables(start, dp_run["variables"])
    for n, p in start.named_parameters():
        np.testing.assert_array_equal(ranks[0]["params"][0][n], p.detach().numpy())


# ---------------------------------------------------------------- the facade


# a constant learning rate after warmup and no close_mosaic (tests/test_torch_facade.py's
# resume settings, mosaic on), so that a run cut after 1 epoch can be compared
FACADE = dict(epochs=2, batch=4, imgsz=64, lr0=0.005, lrf=1.0, warmup_epochs=1.0, mosaic=1.0,
              close_mosaic=0, workers=0, seed=0, plots=False, verbose=False)


@pytest.fixture(scope="module")
def facade_runs(shapes, tmp_path_factory):
    runs = tmp_path_factory.mktemp("facade_runs")
    whole = R.launch(R.facade_rank, WORLD, shapes, runs / "whole", FACADE)
    resumed = R.launch(R.facade_rank, WORLD, shapes, runs / "resumed", FACADE, 1)
    one = YOLO("yolov8n.yaml", nc=NC, device="cpu").train(shapes, project=str(runs / "one"),
                                                           name="dp", **FACADE)
    return dict(whole=whole, resumed=resumed, one=one)


def test_dp_facade_rank_0_alone_writes_and_every_rank_returns_one_history(facade_runs):
    r0, r1 = facade_runs["whole"]
    assert r0["history"] == r1["history"] and r0["run_dir"] == r1["run_dir"]
    assert r0["best_fitness"] == r1["best_fitness"]
    assert r0["events"] == [0, 1] and r1["events"] == []
    assert r1["written"] == [] and r0["written"].count("last.ckpt") == 2
    run = Path(r0["run_dir"])
    with open(run / "results.csv") as f:
        assert len(list(csv.reader(f))) == FACADE["epochs"] + 1  # one writer
    meta = peek_checkpoint_meta(run / "last.ckpt")
    assert meta["epoch"] == 1 and meta["train_args"]["batch"] == 4


def test_dp_facade_history_matches_one_process(facade_runs):
    got, want = facade_runs["whole"][0]["history"], facade_runs["one"]["history"]
    assert len(got) == len(want) == FACADE["epochs"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k == "seconds":
                continue
            bar = 1e-3 * abs(w[k]) if k.endswith("loss") else 1e-3
            assert abs(g[k] - w[k]) <= bar, (k, g[k], w[k])
    assert got[-1]["box_loss"] > 0


def test_dp_facade_resume_matches_uninterrupted(facade_runs):
    whole, resumed = facade_runs["whole"][0], facade_runs["resumed"]
    assert resumed[0]["history"] == resumed[1]["history"]
    assert len(resumed[0]["history"]) == len(whole["history"])
    for g, w in zip(resumed[0]["history"], whole["history"]):
        assert list(g) == list(w)
        for k in w:
            if k != "seconds":
                assert abs(g[k] - w[k]) <= 1e-6 * max(abs(w[k]), 1.0), (k, g[k], w[k])


# ---------------------------------------------------------------- elastic


ELASTIC = dict(batch=4, imgsz=64, lr0=0.005, lrf=1.0, warmup_epochs=1.0, mosaic=0.0, mixup=0.0,
               copy_paste=0.0, translate=0.0, scale=0.0, fliplr=0.0, hsv_h=0.0, hsv_s=0.0,
               hsv_v=0.0, erasing=0.0, close_mosaic=0, multi_scale=False, patience=100,
               workers=0, plots=False, verbose=False)


def test_elastic_survives_preemption(shapes, tmp_path):
    """tests/test_elastic.py's preemption case on the port: the first child
    dies (os._exit) at the end of epoch 1; the relaunch resumes from epoch
    0's last.ckpt and trains to the end."""
    out = elastic_train("yolov8n.yaml", shapes, nc=NC, device="cpu", epochs=3, max_restarts=2,
                        backoff_s=0.1, env={"OMP_NUM_THREADS": "1"},
                        project=str(tmp_path / "runs"), name="elastic", _crash_after_epoch=1,
                        **ELASTIC)
    assert out["restarts"] == 1 and out["attempts"] == 2
    run_dir = Path(out["run_dir"])
    assert (run_dir / "elastic_crash_done").exists()
    spec = json.loads((run_dir / "elastic_spec.json").read_text())
    assert spec["train"].get("resume") is True and spec["device"] == "cpu"
    meta = peek_checkpoint_meta(run_dir / "last.ckpt")
    assert meta["epoch"] == 2 and meta["train_args"]["epochs"] == 3
    with open(run_dir / "results.csv") as f:
        epochs = [int(float(row["epoch"])) for row in csv.DictReader(f)]
    assert epochs == [0, 1, 1, 2]  # epoch 1 died before its checkpoint and was trained again


def test_elastic_gives_up_after_max_restarts(tmp_path):
    with pytest.raises(RuntimeError, match="giving up"):
        elastic_train("nonexistent_model_config.yaml", tmp_path / "nope", nc=NC, device="cpu",
                      epochs=1, max_restarts=1, backoff_s=0.05, project=str(tmp_path / "runs"),
                      name="doomed")


def test_parallel_and_elastic_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, yolo_dbl_tpu_torch.parallel, yolo_dbl_tpu_torch.utils.elastic, "
            "tests.torch_ranks; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'yolo_dbl_tpu.')) or m == 'yolo_dbl_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(Path(__file__).resolve().parent.parent))
