"""The port's 'model' axis (parallel/shardings.py, parallel/tensor.py,
parallel/spatial.py, the tensor-parallel branches of Trainer and YOLO)
against the JAX package, on the CPU.

The ranks are processes joined by a Gloo group (tests/torch_ranks.py, one
torch thread each); JAX runs its CPU mesh (tests/conftest.py forces 8
devices). JAX's own TP tests show that its sharded and replicated programs
agree, so JAX's replicated predict is the predict oracle. Bars:
- the rule: every parameter's spec equals JAX's `PartitionSpec` on
  JAX's test trees, YOLO-DBL-s (n_model 2 and 4, alternate on and off) and
  yolov8n; the counts pinned (DBL-s 48 O, 47 I, 8 dense; yolov8n 21 O, 20 I);
- TP predict at 1x2: yolov8n within 1e-4 (rtol and atol) of JAX's,
  yolov13n_DBL within 1e-3 (JAX's flagship bar), with and without the
  column -> row pairing; each rank's parameter bytes are the specs' count;
- TP training: three steps at 1x2 (yolov13n_DBL, 64 px, global batch 2)
  and two at 2x2 against JAX's `Trainer` on the same mesh shapes, at
  tests/test_torch_train.py's `check_train_*` bars; replicated leaves and
  statistics bit for bit equal on the model ranks; each rank's parameter,
  EMA and moment bytes the specs' count;
- checkpoints: a TP run's checkpoint holds the one-process layout, loads
  into a one-process Trainer, and a resume on 1x2 gives the uninterrupted
  history within 1e-6;
- the facade (yolov8n, 64 px, global batch 4, 2 epochs, 1x2): rank 0 alone
  writes, the history within the facade bars of the one-process run, and
  its best.ckpt loads in a one-process YOLO;
- SP predict at 1x2: yolov8n within 1e-4 of JAX's; a height the model ranks
  do not divide at stride 32 raises.
"""

import collections
from pathlib import Path
from types import SimpleNamespace

import flax.linen
import flax.struct
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.cfg import get_cfg as jax_get_cfg
from yolo_dbl_tpu.engine import train_state as JS
from yolo_dbl_tpu.engine.trainer import Trainer as JaxTrainer
from yolo_dbl_tpu.engine.trainer import make_train_step as jax_make_train_step
from yolo_dbl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolo_dbl_tpu.parallel.shardings import model_parallel_shardings as jax_mps

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.engine.model import YOLO
from yolo_dbl_tpu_torch.engine.trainer import Trainer
from yolo_dbl_tpu_torch.parallel import Mesh, model_parallel_shardings
from yolo_dbl_tpu_torch.parallel.shardings import COL, DENSE_OUT, ROW
from yolo_dbl_tpu_torch.utils.checkpoint import load_checkpoint, peek_checkpoint_meta
from yolo_dbl_tpu_torch.utils.convert import jax_param_paths, load_jax_variables

from tests import torch_ranks as R
from tests.conftest import cpu_devices
from tests.fixtures import make_shapes_dataset
from tests.test_torch_modules import random_variables
from tests.test_torch_parallel import FACADE
from tests.test_torch_train import (BATCH, IMGSZ, TRAIN_OVERRIDES, _NoDropout, _train_batches,
                                    check_train_updates_and_batch_stats)
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

NC = 3
CPU = torch.device("cpu")


def _port_mesh(n_model, world=8):
    """A mesh of `world` ranks with no group: the rule reads only its shape."""
    return Mesh(0, world, CPU, n_model=n_model)


# ---------------------------------------------------------------- the mesh


def test_two_axis_mesh_coords_groups_and_rows():
    ranks = R.launch(R.mesh_rank, 4, n_model=2)
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        assert got["coords"] == {"data": d, "model": m} and got["shape"] == {"data": 2, "model": 2}
        assert got["sum_data"] == 2 and got["sum_model"] == 2 and got["sum_world"] == 4
        assert got["gather_model"] == [2 * d, 2 * d + 1]  # this data row's ranks, in order
        assert got["rows"] == list(range(4 * d, 4 * d + 4))  # by the data coordinate
        assert got["loader"] == ranks[2 * d]["loader"]  # one data row, one shard of rows
    assert ranks[0]["loader"] != ranks[2]["loader"]
    with pytest.raises(RuntimeError, match="n_model=3, but the process group has 2 ranks"):
        R.launch(R.mesh_rank, 2, n_model=3)


# ---------------------------------------------------------------- the rule


def test_sharding_rules_shapes_match_jax():
    jmesh = jax_make_mesh(n_data=4, n_model=2, devices=cpu_devices(8))
    shapes = {"big_conv": {"kernel": (3, 3, 256, 256), "bias": (256,)},
              "small_conv": {"kernel": (1, 1, 8, 16)}, "dense": {"kernel": (512, 512)},
              "odd": {"kernel": (3, 3, 64, 129)}}
    variables = {"params": {k: {n: np.zeros(s, np.float32) for n, s in v.items()}
                            for k, v in shapes.items()}}
    want = jax_mps(jax.tree_util.tree_map(jnp.asarray, variables), jmesh)
    got = model_parallel_shardings(variables, _port_mesh(2))
    for k, v in shapes.items():
        for n in v:
            assert got["params"][k][n] == tuple(want["params"][k][n].spec), (k, n)
    assert got["params"]["big_conv"]["kernel"] == COL
    assert got["params"]["dense"]["kernel"] == DENSE_OUT
    assert got["params"]["odd"]["kernel"] == () == got["params"]["big_conv"]["bias"]


def test_trainstate_copies_get_identical_specs():
    """JAX's TrainState case: three eligible kernels (odd) in params, EMA
    and Adam's mu and nu: every copy of a kernel gets one spec, and the
    chain alternates O, I, O."""

    @flax.struct.dataclass
    class FakeState:
        params: dict
        ema_params: dict
        opt_state: tuple

    tree = {f"c{i}": {"kernel": np.zeros((3, 3, 256, 256), np.float32)} for i in range(3)}
    Adam = collections.namedtuple("Adam", ["mu", "nu"])
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    state = FakeState(params=jtree, ema_params=jtree, opt_state=(Adam(mu=jtree, nu=jtree),))
    want = jax_mps(state, jax_make_mesh(n_data=4, n_model=2, devices=cpu_devices(8)))
    got = model_parallel_shardings({"params": tree, "ema_params": tree,
                                    "opt_state": {"mu": tree, "nu": tree}}, _port_mesh(2))
    for name in tree:
        copies = {got["params"][name]["kernel"], got["ema_params"][name]["kernel"],
                  got["opt_state"]["mu"][name]["kernel"], got["opt_state"]["nu"][name]["kernel"]}
        assert copies == {tuple(want.params[name]["kernel"].spec)}, name
    assert [got["params"][f"c{i}"]["kernel"] for i in range(3)] == [COL, ROW, COL]


@pytest.fixture(scope="module")
def jax_shapes():
    cache = {}

    def get(cfg):
        if cfg not in cache:
            jm = JaxDetectionModel(cfg, nc=NC)
            cache[cfg] = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), imgsz=64))
        return cache[cfg]

    return get


# (config, n_model, alternate): (O, I, dense) kernels
RULE_CASES = {("yolov13s_DBL.yaml", 2, True): (48, 47, 8),
              ("yolov13s_DBL.yaml", 2, False): (95, 0, 8),
              ("yolov13s_DBL.yaml", 4, True): (48, 47, 8),
              ("yolov13s_DBL.yaml", 4, False): (95, 0, 8),
              ("yolov8n.yaml", 2, True): (21, 20, 0)}


@pytest.mark.parametrize("case", sorted(RULE_CASES), ids=lambda c: f"{c[0][:-5]}-{c[1]}-{c[2]}")
def test_rule_matches_jax_on_every_parameter(jax_shapes, case):
    cfg, n_model, alternate = case
    jmesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model, devices=cpu_devices(8))
    want = jax_mps(jax_shapes(cfg), jmesh, alternate=alternate)["params"]
    model = DetectionModel(cfg, nc=NC, device="cpu")
    got = model_parallel_shardings(model, _port_mesh(n_model), alternate=alternate)
    paths = jax_param_paths(model)
    assert list(got) == [n for n, _ in model.named_parameters()]
    for name, spec in got.items():
        leaf = want
        for k in paths[name].split("/"):
            leaf = leaf[k]
        assert spec == tuple(leaf.spec), name
    counts = collections.Counter(got.values())
    assert (counts[COL], counts[ROW], counts[DENSE_OUT]) == RULE_CASES[case]


# ---------------------------------------------------------------- TP predict


def _variables(cfg, seed, imgsz=IMGSZ):
    jm = JaxDetectionModel(cfg, nc=NC)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, imgsz, imgsz, 3), jnp.float32))
    return jm, random_variables(shapes, np.random.default_rng(seed))


@pytest.mark.parametrize("cfg,bar,pairs", [("yolov8n.yaml", 1e-4, (True,)),
                                           ("yolov13n_DBL.yaml", 1e-3, (True, False))])
def test_tp_predict_matches_jax_replicated(cfg, bar, pairs):
    jm, variables = _variables(cfg, 21)
    x = np.random.default_rng(0).random((4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.predict(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    ranks = R.launch(R.tp_predict_rank, 2, cfg, NC, variables, x, pairs, n_model=2)
    model = DetectionModel(cfg, nc=NC, device="cpu")
    specs = model_parallel_shardings(model, _port_mesh(2))
    want_bytes = sum(p.numel() * p.element_size() // (2 if specs[n] else 1)
                     for n, p in model.named_parameters())
    for pair in pairs:
        for r in ranks:
            got = r[pair]
            assert got["pred"].shape == want.shape
            np.testing.assert_allclose(got["pred"], want, rtol=bar, atol=bar)
            assert bool(got["pairs"]) == pair and got["collectives"]["all_reduce:model"][0] > 0
            assert got["param_bytes"] == want_bytes
        assert ranks[0][pair]["pairs"] == ranks[1][pair]["pairs"]
    if len(pairs) == 2:  # in a forward the pairing saves each pair's all-gather
        on, off = (ranks[0][p]["collectives"]["all_gather:model"][0] for p in (True, False))
        assert off - on == len(ranks[0][True]["pairs"])


@pytest.mark.slow
def test_tp_predict_matches_jax_replicated_flagship_128():
    """JAX's slow flagship case on the port: YOLO-DBL-s at 128 px over a
    1x4 mesh (world 4) against JAX's replicated predict, within 1e-3."""
    jm, variables = _variables("yolov13s_DBL.yaml", 2, imgsz=128)
    x = np.random.default_rng(2).random((2, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jm.predict(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    ranks = R.launch(R.tp_predict_rank, 4, "yolov13s_DBL.yaml", NC, variables, x, n_model=4)
    for r in ranks:
        np.testing.assert_allclose(r[True]["pred"], want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------- TP training


def _jax_run(cfg, variables, batches, n_data, n_model, spe=5):
    jm = JaxDetectionModel(cfg, nc=NC)
    jm.init = lambda rng, imgsz=None: jax.tree_util.tree_map(jnp.asarray, variables)
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model, devices=cpu_devices(n_data * n_model))
    trainer = JaxTrainer(jm, TRAIN_OVERRIDES, mesh=mesh).setup(spe)
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    states, losses = [numpy(trainer.state)], []
    for b in batches:
        metrics = trainer.step(b, jax.random.PRNGKey(0))
        losses.append({k: float(v) for k, v in metrics.items()})
        states.append(numpy(trainer.state))
    return states, losses


def _jax_float64_losses(cfg, variables, batches, spe=5):
    """The loss items of JAX's own float64 reading of the steps (the model
    built with dtype float64 under `jax.enable_x64`; its loss casts the maps
    to float32, yolo_dbl_tpu/losses/detection.py:87)."""
    with jax.enable_x64(True):
        jm = JaxDetectionModel(cfg, nc=NC, dtype=jnp.float64)
        params, stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                               (variables["params"], variables["batch_stats"]))
        cfg_j = jax_get_cfg(overrides=TRAIN_OVERRIDES)
        tx, _ = JS.build_optimizer(params, NC, cfg_j, spe)
        state = JS.create_train_state({"params": params, "batch_stats": stats}, tx)
        step = jax.jit(jax_make_train_step(jm, cfg_j, tx))
        losses = []
        for b in batches:
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                                  jax.random.PRNGKey(0))
            losses.append({k: float(v) for k, v in metrics.items()})
    return losses


def _as_run(cfg, ranks, states, losses_j):
    """A `check_train_*` run dict from the port's rank 0 (whole leaves)."""
    head = ranks[0]
    tm = DetectionModel(cfg, nc=NC, device="cpu")
    tm.load_state_dict({**{n: torch.from_numpy(v) for n, v in head["params"][-1].items()},
                        **{k: torch.from_numpy(v) for k, v in head["batch_stats"].items()}})
    names = [n for n, _ in tm.named_parameters()]
    return dict(tm=tm.eval(), states=states, losses_j=losses_j, losses_t=head["losses"],
                params_t=[{n: torch.from_numpy(v) for n, v in p.items()} for p in head["params"]],
                trainer=SimpleNamespace(ema=[torch.from_numpy(head["ema"][n]) for n in names]),
                ranks=ranks)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """yolov13n_DBL, 64 px, global batch 2: three steps on 1x2 (the port
    writing its state after step 1), a resume of that state for steps 2-3,
    and two steps on 2x2; JAX's Trainer on a 1x2 mesh, and JAX's float64
    reading of the steps. The 2x2 run is held to JAX's 1x2 run too: JAX's
    own 2x2 program puts the step-2 update of m0.bn.bias 1.4e-5 (8x the
    update bar) from its one-device and 1x2 programs (ROADMAP Queue 3)."""
    cfg = "yolov13n_DBL.yaml"
    ckpt = tmp_path_factory.mktemp("tp_ckpt") / "last.ckpt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jm = JaxDetectionModel(cfg, nc=NC)
        shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                                jnp.zeros((BATCH, IMGSZ, IMGSZ, 3), jnp.float32))
        variables = random_variables(shapes, np.random.default_rng(18))
        batches = _train_batches(3)
        states, losses = _jax_run(cfg, variables, batches, 1, 2)
        float64 = _jax_float64_losses(cfg, variables, batches)
    r12 = R.launch(R.tp_trainer_rank, 2, cfg, NC, variables, TRAIN_OVERRIDES, 5, batches, str(ckpt),
                   n_model=2)
    resumed = R.launch(R.tp_trainer_rank, 2, cfg, NC, variables, TRAIN_OVERRIDES, 5, batches[1:],
                       None, 1, str(ckpt), n_model=2)
    r22 = R.launch(R.tp_trainer_rank, 4, cfg, NC, variables, TRAIN_OVERRIDES, 5, batches[:2],
                   n_model=2)
    return dict(one_by_two=_as_run(cfg, r12, states, losses),
                two_by_two=_as_run(cfg, r22, states[:3], losses[:2]), float64=float64,
                resumed=resumed, ckpt=ckpt, variables=variables, batches=batches)


def check_tp_losses(run, float64):
    """tests/test_torch_train.py's loss bar (1e-4 relative of JAX's float32
    run) for every item of every step, with its float64 rule for an
    ill-conditioned item: one that misses is held within 1e-4 of JAX's
    float64 reading, which JAX's float32 run must then be further from."""
    assert run["losses_j"][0]["box_loss"] > 0 and not run["tm"].training
    for step, (lt, lj) in enumerate(zip(run["losses_t"], run["losses_j"])):
        assert set(lt) == set(lj) == {"loss", "box_loss", "cls_loss", "dfl_loss"}
        for k in lt:
            if abs(lt[k] - lj[k]) <= 1e-4 * abs(lj[k]):
                continue
            ref = float64[step][k]
            assert abs(lj[k] - ref) > abs(lt[k] - ref), (step, k, lt[k], lj[k], ref)
            assert abs(lt[k] - ref) <= 1e-4 * abs(ref), (step, k, lt[k], lj[k], ref)


@pytest.mark.parametrize("mesh", ["one_by_two", "two_by_two"])
def test_tp_train_steps_match_jax_mesh(tp_runs, mesh):
    run = tp_runs[mesh]
    check_tp_losses(run, tp_runs["float64"])
    check_train_updates_and_batch_stats(run)
    assert all(r["losses"] == run["losses_t"] for r in run["ranks"])


@pytest.mark.parametrize("mesh", ["one_by_two", "two_by_two"])
def test_tp_ranks_hold_their_shards_and_equal_replicated_leaves(tp_runs, mesh):
    ranks = tp_runs[mesh]["ranks"]
    assert len({r["checksum"] for r in ranks}) == 1  # replicated leaves, EMA, moments, statistics
    for r in ranks:
        assert r["local_bytes"] == r["spec_bytes"] < 0.6 * r["whole_bytes"]
        assert r["sharded"] > 20 and r["steps"] == len(r["losses"]) and not r["training"]
    assert {tuple(r["pairs"]) for r in ranks} == {tuple(ranks[0]["pairs"])}


def test_tp_checkpoint_is_the_one_process_layout_and_resumes(tp_runs):
    state, meta = load_checkpoint(tp_runs["ckpt"])
    assert meta["epoch"] == 0 and state["step"] == 1
    head = tp_runs["one_by_two"]["ranks"][0]
    for n, v in state["params"].items():
        np.testing.assert_array_equal(v.numpy(), head["params"][1][n], err_msg=n)
    # one process reads it whole
    model = DetectionModel("yolov13n_DBL.yaml", nc=NC, device="cpu")
    load_jax_variables(model, tp_runs["variables"])
    one = Trainer(model, TRAIN_OVERRIDES).setup(5)
    own = one.state_dict()
    for k in ("params", "ema_params", "batch_stats"):
        assert {n: tuple(v.shape) for n, v in state[k].items()} == \
            {n: tuple(v.shape) for n, v in own[k].items()}, k
    one.restore(tp_runs["ckpt"])
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), head["params"][1][n], err_msg=n)
    # the resume on 1x2 re-shards it and gives the uninterrupted steps 2-3
    resumed = tp_runs["resumed"][0]
    for got, want in zip(resumed["losses"], head["losses"][1:]):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6 * max(abs(want[k]), 1.0), (k, got[k], want[k])
    for n, v in resumed["params"][-1].items():
        np.testing.assert_allclose(v, head["params"][-1][n], rtol=0,
                                   atol=1e-6 * max(np.abs(head["params"][-1][n]).max(), 1.0),
                                   err_msg=n)


# ---------------------------------------------------------------- the facade


@pytest.fixture(scope="module")
def tp_facade(tmp_path_factory):
    shapes = make_shapes_dataset(tmp_path_factory.mktemp("shapes"), n_train=8, n_val=4, imgsz=96)
    runs = tmp_path_factory.mktemp("tp_facade")
    ranks = R.launch(R.facade_rank, 2, shapes, runs / "tp", FACADE, n_model=2)
    one = YOLO("yolov8n.yaml", nc=NC, device="cpu").train(shapes, project=str(runs / "one"),
                                                           name="dp", **FACADE)
    return dict(ranks=ranks, one=one)


def test_tp_facade_trains_validates_and_rank_0_alone_writes(tp_facade):
    r0, r1 = tp_facade["ranks"]
    assert r0["history"] == r1["history"] and r0["run_dir"] == r1["run_dir"]
    assert r0["events"] == [0, 1] and r1["events"] == []
    assert r1["written"] == [] and r0["written"].count("last.ckpt") == 2
    run = Path(r0["run_dir"])
    assert peek_checkpoint_meta(run / "last.ckpt")["epoch"] == 1
    got, want = r0["history"], tp_facade["one"]["history"]
    assert len(got) == len(want) == FACADE["epochs"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k != "seconds":
                bar = 1e-3 * abs(w[k]) if k.endswith("loss") else 1e-3
                assert abs(g[k] - w[k]) <= bar, (k, g[k], w[k])
    # the TP run's best.ckpt serves in one process
    frames = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    results = YOLO(str(run / "best.ckpt"), device="cpu").predict(list(frames), imgsz=64)
    assert len(results) == 2


# ---------------------------------------------------------------- SP predict


def test_sp_predict_matches_jax_replicated():
    jm, variables = _variables("yolov8n.yaml", 22)
    x = np.random.default_rng(1).random((4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.predict(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    ranks = R.launch(R.sp_predict_rank, 2, "yolov8n.yaml", NC, variables, x, n_model=2)
    for r in ranks:
        assert r["pred"].shape == want.shape
        np.testing.assert_allclose(r["pred"], want, rtol=1e-4, atol=1e-4)
        assert r["halo_bytes"] > 0 and r["gather_bytes"] > 0
    with pytest.raises(RuntimeError, match="96 image rows do not split over 2 model ranks"):
        R.launch(R.sp_predict_rank, 2, "yolov8n.yaml", NC, variables,
                 np.zeros((2, 96, 96, 3), np.float32), n_model=2)


def test_tp_and_sp_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, yolo_dbl_tpu_torch.parallel.shardings, yolo_dbl_tpu_torch.parallel.tensor, "
            "yolo_dbl_tpu_torch.parallel.spatial, tests.torch_ranks; bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'yolo_dbl_tpu.')) or m == 'yolo_dbl_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(Path(__file__).resolve().parent.parent))
