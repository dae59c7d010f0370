"""The port's training path against the JAX package, on the CPU.

Box ops, the TAL assigner (exact top-k), the detection loss, the optimizer
chain with EMA, and three train steps of yolov13n_DBL at 64 px with the
same bridged variables and batches. Inputs come from numpy seeds. Bars:
float32 ops in the same order, 1e-5 (box ops, loss, optimizer); the whole
network, whose sums are taken in another order by each framework, 1e-4 on
losses and BatchNorm statistics and 1e-3 of a leaf's largest magnitude on
gradients and parameter updates.
"""

import copy

import flax.linen
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from yolo_dbl_tpu import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.cfg import get_cfg as jax_get_cfg
from yolo_dbl_tpu.engine import train_state as JS
from yolo_dbl_tpu.engine.trainer import make_train_step as jax_make_train_step
from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.losses import detection as JD
from yolo_dbl_tpu.losses.tal import task_aligned_assign as jax_tal
from yolo_dbl_tpu.ops import anchors as JA
from yolo_dbl_tpu.ops import boxes as JB

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.engine import train_state as TS
from yolo_dbl_tpu_torch.engine.trainer import Trainer, train_loss
from yolo_dbl_tpu_torch.losses import detection as TD
from yolo_dbl_tpu_torch.losses.tal import select_candidates_in_gts
from yolo_dbl_tpu_torch.losses.tal import task_aligned_assign as torch_tal
from yolo_dbl_tpu_torch.nn import blocks as TBL
from yolo_dbl_tpu_torch.nn import common as TC
from yolo_dbl_tpu_torch.ops import anchors as TA
from yolo_dbl_tpu_torch.ops import boxes as TB
from yolo_dbl_tpu_torch.utils.convert import (jax_param_paths, load_jax_variables,
                                              params_from_jax, state_dict_from_jax)

from tests.test_torch_modules import random_variables
from tests.torch_fixtures import torch_threads

TOL = 1e-5
NC = 3


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))  # np.ascontiguousarray makes 0-d arrays 1-d


def _boxes_xyxy(rng, shape, lo=0.0, hi=60.0):
    xy = rng.uniform(lo, hi, (*shape, 2))
    wh = rng.uniform(2.0, 30.0, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------- box ops


@pytest.mark.parametrize("xywh", [True, False])
@pytest.mark.parametrize("mode", ["IoU", "GIoU", "DIoU", "CIoU"])
def test_bbox_iou_values_and_grads(mode, xywh):
    rng = np.random.default_rng(10)
    b1, b2 = _boxes_xyxy(rng, (64,)), _boxes_xyxy(rng, (64,))
    b2[:8] = b1[:8] + rng.normal(0, 2.0, (8, 4)).astype(np.float32)  # overlapping pairs
    b2[8:12] = b1[8:12]  # identical pairs
    b2[12, :2], b2[12, 2:] = b1[12, 2:], b1[12, 2:] + 5.0  # touching corner: min/max ties
    w = rng.uniform(0.5, 1.5, (64,)).astype(np.float32)
    flags = {k: mode == k for k in ("GIoU", "DIoU", "CIoU")}

    def jloss(a, b):
        return (JB.bbox_iou(a, b, xywh=xywh, **flags) * w).sum()

    ref = np.asarray(JB.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh, **flags))
    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1, t2 = _t(b1).requires_grad_(), _t(b2).requires_grad_()
    out = TB.bbox_iou(t1, t2, xywh=xywh, **flags)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(gj[0]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(gj[1]), atol=TOL, rtol=TOL)


def test_dist_bbox_codecs_values_and_grads():
    rng = np.random.default_rng(11)
    anchors = rng.uniform(0, 20, (50, 2)).astype(np.float32)
    dist = rng.uniform(0, 8, (3, 50, 4)).astype(np.float32)
    box = _boxes_xyxy(rng, (3, 50), 0, 20) - np.float32(5.0)
    for xywh in (True, False):
        ref = np.asarray(JA.dist2bbox(jnp.asarray(dist), jnp.asarray(anchors), xywh=xywh))
        out = TA.dist2bbox(_t(dist), _t(anchors), xywh=xywh)
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL)
    # bbox2dist clips to [0, reg_max - 0.01]: both ends are hit here
    w = rng.normal(size=(3, 50, 4)).astype(np.float32)
    ref = np.asarray(JA.bbox2dist(jnp.asarray(anchors), jnp.asarray(box), 16))
    gj = jax.grad(lambda bx: (JA.bbox2dist(jnp.asarray(anchors), bx, 16) * w).sum())(jnp.asarray(box))
    tb = _t(box).requires_grad_()
    out = TA.bbox2dist(_t(anchors), tb, 16)
    (out * _t(w)).sum().backward()
    assert (ref == 0).any() and (ref == np.float32(15.99)).any()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gj), atol=TOL)


# ---------------------------------------------------------------- TAL


def _tal_inputs(seed, tied=False):
    """Predictions over a 16x16 anchor grid (stride 4) and 4 GT slots, one
    padded. `tied`: zero class scores, so every in-GT metric is exactly 0."""
    rng = np.random.default_rng(seed)
    b, m, g = 2, 4, 16
    c = (np.arange(g, dtype=np.float32) + 0.5) * 4
    gy, gx = np.meshgrid(c, c, indexing="ij")
    anc = np.stack([gx, gy], -1).reshape(-1, 2)
    a = len(anc)
    scores = rng.uniform(0, 1, (b, a, NC)).astype(np.float32)
    half = rng.uniform(2, 10, (b, a, 4)).astype(np.float32)
    pd = np.concatenate([anc - half[..., :2], anc + half[..., 2:]], -1).astype(np.float32)
    gt = _boxes_xyxy(rng, (b, m), 4, 40)
    labels = rng.integers(0, NC, (b, m)).astype(np.int32)
    mask = np.ones((b, m), np.float32)
    mask[:, -1] = 0.0
    gt[:, -1] = 0.0
    if tied:
        scores[:] = 0.0
        gt[:, 0] = [1.0, 1.0, 30.0, 20.0]  # holds anchors of the first grid rows
    return scores, pd, anc, labels, gt, mask


@pytest.mark.parametrize("tied", [False, True])
def test_task_aligned_assign_matches_exact_jax(tied):
    inputs = _tal_inputs(12, tied)
    ref = jax_tal(*map(jnp.asarray, inputs), topk=10, num_classes=NC, exact_topk=True)
    out = torch_tal(*map(_t, inputs), topk=10, num_classes=NC)
    labels, boxes, scores, fg, idx = (np.asarray(r) for r in ref)
    assert fg.sum() > 0
    np.testing.assert_array_equal(out[3].numpy(), fg)
    np.testing.assert_array_equal(out[4].numpy(), idx)
    np.testing.assert_array_equal(out[0].numpy(), labels)
    np.testing.assert_allclose(out[1].numpy(), boxes, atol=1e-6)
    np.testing.assert_allclose(out[2].numpy(), scores, atol=1e-6)
    if tied:
        assert scores.max() == 0.0  # every candidate metric was a tie at 0


def test_tal_ties_go_to_the_lower_anchor_index():
    """All metrics 0: each GT's k candidates are anchors 0..k-1, as lax.top_k
    orders ties, so the foreground is those of them inside a real GT."""
    scores, pd, anc, labels, gt, mask = (_t(a) for a in _tal_inputs(13, tied=True))
    fg = torch_tal(scores, pd, anc, labels, gt, mask, topk=10, num_classes=NC)[3]
    inside = (select_candidates_in_gts(anc, gt) * mask[..., None]).amax(1) > 0  # (B, A)
    first_k = torch.arange(anc.shape[0]) < 10
    assert (inside & first_k).any()
    assert torch.equal(fg, inside & first_k)


# ---------------------------------------------------------------- loss


def _det_inputs(seed, b=2, hw=(16, 8, 4), m=6):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1.5, (b, s, s, 64 + NC)).astype(np.float32) for s in hw]
    xy = rng.uniform(0.2, 0.8, (b, m, 2))
    wh = rng.uniform(0.05, 0.5, (b, m, 2))
    batch = dict(gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                 gt_cls=rng.integers(0, NC, (b, m)).astype(np.int32),
                 gt_mask=(np.arange(m)[None] < np.array([[4], [2]])).astype(np.float32))
    return feats, batch


def test_detection_loss_matches_jax():
    feats, batch = _det_inputs(14)
    strides = (8, 16, 32)

    def jloss(fs):
        return JD.detection_loss(fs, {k: jnp.asarray(v) for k, v in batch.items()}, strides, NC)

    (total_j, items_j), grads_j = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(f) for f in feats])
    tf = [_t(f).requires_grad_() for f in feats]
    total_t, items_t = TD.detection_loss(tf, {k: _t(v) for k, v in batch.items()}, strides, NC)
    total_t.backward()
    assert float(items_j.box) > 0 and float(items_j.dfl) > 0
    for a, b in zip((total_t, *items_t), (total_j, *items_j)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=TOL)
    for t, g in zip(tf, grads_j):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, atol=TOL * np.abs(g).max(), rtol=0)


# ---------------------------------------------------------------- optimizer


class _Tiny(torch.nn.Module):
    """Conv (kernel + BN), bare conv with bias, a FullPAD gate: every kind of
    leaf that the decay and freeze masks tell apart."""

    def __init__(self):
        super().__init__()
        self.m0 = TC.Conv(4, 8, 3)
        self.m1 = TC.Conv2d(8, 6, 1)
        self.m2 = TBL.FullPAD_Tunnel()


def _jax_tree(flat):
    """{'m0/conv/kernel': array} → nested dict."""
    tree = {}
    for path, v in flat.items():
        *scopes, leaf = path.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


def _to_jax_layout(t: np.ndarray):
    return t.transpose(2, 3, 1, 0) if t.ndim == 4 else t


# case: (overrides, index of the step whose gradient holds a NaN, inner steps taken)
OPT_CASES = {
    "SGD": (dict(optimizer="SGD", freeze=[1]), 37, 119),
    "AdamW": (dict(optimizer="AdamW", freeze=["m0/bn"]), 37, 119),
    "RMSProp": (dict(optimizer="RMSProp"), 37, 119),
    "AdamW_accumulate": (dict(optimizer="AdamW", batch=16, grad_accumulate=True), None, 30),
    # a NaN micro-batch poisons optax.MultiSteps' accumulator for good
    # ((1 - emit) * acc keeps it), and the port mirrors it (ROADMAP Queue 3)
    "AdamW_accumulate_nan": (dict(optimizer="AdamW", batch=16, grad_accumulate=True), 37, 9),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_and_ema_match_optax(case):
    """120 steps (warmup is 100), one of them non-finite, against the optax chain."""
    case_overrides, bad, inner_steps = OPT_CASES[case]
    overrides = dict(epochs=20, warmup_epochs=3.0, lr0=0.05, weight_decay=0.05, **case_overrides)
    spe, steps = 10, 120
    rng = np.random.default_rng(15)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(_t(np.asarray(rng.normal(0, 0.5, p.shape), np.float32)))
    paths = jax_param_paths(model)
    names = [n for n, _ in model.named_parameters()]
    params_j = _jax_tree({paths[n]: jnp.asarray(_to_jax_layout(p.detach().numpy()))
                          for n, p in model.named_parameters()})

    tx, _ = JS.build_optimizer(params_j, NC, jax_get_cfg(overrides=overrides), spe)
    state_j = tx.init(params_j)
    ema_j = jax.tree_util.tree_map(jnp.copy, params_j)
    opt, _ = TS.build_optimizer(model, NC, get_cfg(overrides=overrides), spe)
    ema_t = [p.detach().clone() for p in model.parameters()]
    flat = jax.tree_util.tree_flatten_with_path(JS.decay_mask(params_j))[0]
    want_decay = {"/".join(str(k.key) for k in path): bool(v) for path, v in flat}
    assert TS.decay_mask(model) == {n: want_decay[paths[n]] for n in names}
    assert sorted(n for n in names if want_decay[paths[n]]) == ["m0.conv.weight", "m1.conv.weight"]

    update = jax.jit(tx.update)
    for i in range(steps):
        grads = {n: np.asarray(rng.normal(0, 2.0, p.shape), np.float32)
                 for n, p in model.named_parameters()}
        if i == bad:
            grads[names[0]][0, 0, 0, 0] = np.nan
        g_j = _jax_tree({paths[n]: jnp.asarray(_to_jax_layout(g)) for n, g in grads.items()})
        upd, state_j = update(g_j, state_j, params_j)
        params_j = jax.tree_util.tree_map(lambda p, u: p + u, params_j, upd)
        ema_j = JS.ema_update(ema_j, params_j, jnp.float32(i + 1))
        opt.step([_t(grads[n]) for n in names])
        TS.ema_update(ema_t, list(model.parameters()), float(i + 1))

    want = params_from_jax(model, params_j)
    want_ema = params_from_jax(model, ema_j)
    for n, p, e in zip(names, model.parameters(), ema_t):
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=TOL, atol=1e-7)
        np.testing.assert_allclose(e.numpy(), want_ema[n].numpy(), rtol=TOL, atol=1e-7)
    assert opt.count == inner_steps
    frozen = TS.freeze_mask(model, overrides.get("freeze")) or {}
    assert sum(frozen.values()) == {"SGD": 2, "AdamW": 2}.get(case, 0)


def test_lr_schedule_and_auto_match_jax():
    for cos in (False, True):
        ref = JS.make_lr_schedule(0.01, 0.01, 30, 7, 3.0, cos)
        out = TS.make_lr_schedule(0.01, 0.01, 30, 7, 3.0, cos)
        steps = np.array([0, 1, 50, 99, 100, 101, 150, 209, 500])
        # JAX evaluates the schedule in float32: 1 - epoch/epochs loses digits near the end
        np.testing.assert_allclose([out(int(s)) for s in steps], np.asarray(ref(steps)), rtol=1e-5)
        assert out(0) == 0.0
    for it in (100, 20000):
        assert TS.auto_optimizer(NC, 0.01, 0.937, it) == JS.auto_optimizer(NC, 0.01, 0.937, it)


def test_cfg_matches_jax_defaults_and_rejects_unknown_keys():
    port, ref = vars(get_cfg()), vars(jax_get_cfg())
    assert len(port) == len(ref) == 95 and all(port[k] == ref[k] for k in ref)
    assert get_cfg(overrides={"lr0": 1, "freeze": [0, "m1"]}).lr0 == 1.0
    with pytest.raises(KeyError):
        get_cfg(overrides={"lr_zero": 0.1})
    with pytest.raises(TypeError):
        get_cfg(overrides={"cos_lr": 1})


def test_batchnorm_updates_running_stats_like_flax():
    fnn = flax.linen
    x = np.random.default_rng(16).normal(1.0, 2.0, (2, 4, 4, 6)).astype(np.float32)
    bn = TC.batch_norm(6).train()
    out_t = bn(_t(x).permute(0, 3, 1, 2))
    jbn = fnn.BatchNorm(momentum=0.97, epsilon=1e-3)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    out_j, mut = jbn.apply(v, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    np.testing.assert_allclose(out_t.permute(0, 2, 3, 1).detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), atol=1e-6)


# ---------------------------------------------------------------- train step


IMGSZ, BATCH, M = 64, 2, 5
# SGD: its update is linear in the gradient, so comparing updates compares
# gradients. Adam's update g / sqrt(g^2) turns an absolute float32 error in a
# small gradient element into a relative error of the update; the Adam chain
# is held to optax on identical gradients in test_optimizer_and_ema_match_optax.
# lr0 = 1: step 2 runs at 1/100 of it (warmup), so its update stands well
# above the float32 spacing of the parameters it is read from.
TRAIN_OVERRIDES = dict(batch=BATCH, epochs=10, imgsz=IMGSZ, optimizer="SGD", lr0=1.0)


def _train_batches(n, seed=17):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = rng.uniform(0.25, 0.75, (BATCH, M, 2))
        wh = rng.uniform(0.1, 0.5, (BATCH, M, 2))
        out.append(dict(img=rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8),
                        gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                        gt_cls=rng.integers(0, NC, (BATCH, M)).astype(np.int32),
                        gt_mask=(np.arange(M)[None] < np.array([[3], [5]])).astype(np.float32)))
    return out


class _NoDropout(flax.linen.Module):
    """Stands in for flax's Dropout: the two frameworks draw different
    random bits, so the train-step comparison runs with dropout off on both
    sides (the two hyperedge generators of HyperACE use rate 0.1)."""

    rate: float
    deterministic: bool = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def train_run():
    """Three train steps of yolov13n_DBL on both sides from the same variables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        return _train_run()


def _train_run(cfg="yolov13n_DBL.yaml", nc=NC):
    """Three train steps of `cfg` on both sides (JAX `make_train_step`, the
    port's `Trainer.step`) from the same variables; dropout must be off in
    flax (see `train_run`)."""
    spe = 5
    jm = JaxDetectionModel(cfg, nc=nc)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((BATCH, IMGSZ, IMGSZ, 3), jnp.float32))
    variables = random_variables(shapes, np.random.default_rng(18))
    batches = _train_batches(3)
    cfg_j = jax_get_cfg(overrides=TRAIN_OVERRIDES)
    tx, _ = JS.build_optimizer(variables["params"], nc, cfg_j, spe)
    state = JS.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)

    def loss_fn(params, batch_stats, batch):
        outs, _ = jm.module.apply({"params": params, "batch_stats": batch_stats},
                                  jax_device_normalize(batch["img"]), train=True,
                                  mutable=["batch_stats"])
        return JD.detection_loss(outs, batch, jm.strides, jm.nc)[0]

    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    grads_j = jax.jit(jax.grad(loss_fn))(state.params, state.batch_stats, jbatches[0])
    step = jax.jit(jax_make_train_step(jm, cfg_j, tx))
    states, losses_j = [state], []
    for b in jbatches:
        state, metrics = step(state, b, jax.random.PRNGKey(0))
        states.append(state)
        losses_j.append({k: float(v) for k, v in metrics.items()})

    tm = DetectionModel(cfg, nc=nc, device="cpu")
    load_jax_variables(tm, variables)
    dropouts = [m for m in tm.modules() if isinstance(m, torch.nn.Dropout)]
    assert len(dropouts) == 2  # HyperACE branch1, branch2
    for m in dropouts:
        m.p = 0.0
    trainer = Trainer(tm, TRAIN_OVERRIDES).setup(spe)
    probe = copy.deepcopy(tm)
    pp = [p for _, p in probe.named_parameters()]
    loss, _ = train_loss(probe, trainer.cfg, trainer.to_device(batches[0]))
    grads_t = dict(zip([n for n, _ in probe.named_parameters()], torch.autograd.grad(loss, pp)))
    params_t, losses_t = [{n: p.detach().clone() for n, p in tm.named_parameters()}], []
    for b in batches:
        losses_t.append({k: float(v) for k, v in trainer.step(b).items()})
        params_t.append({n: p.detach().clone() for n, p in tm.named_parameters()})
    return dict(tm=tm, trainer=trainer, states=states, losses_j=losses_j, losses_t=losses_t,
                grads_j=params_from_jax(tm, grads_j), grads_t=grads_t, params_t=params_t,
                model0=probe, batch0=batches[0])


def check_train_losses(train_run):
    for lt, lj in zip(train_run["losses_t"], train_run["losses_j"]):
        assert set(lt) == set(lj) == {"loss", "box_loss", "cls_loss", "dfl_loss"}
        for k in lt:
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-4)
    assert train_run["losses_j"][0]["box_loss"] > 0
    assert not train_run["tm"].training


def test_train_step_losses_match_jax(train_run):
    check_train_losses(train_run)


def check_train_gradients(train_run):
    gj, gt = train_run["grads_j"], train_run["grads_t"]
    assert set(gj) == set(gt)
    for n in gt:
        # + 1e-8: the hyperedge generators' pre_head_proj bias shifts every
        # node's logit alike before a softmax over nodes, so its gradient is
        # 0 in exact arithmetic and float32 noise (~1e-9) on both sides
        scale = float(gj[n].abs().max())
        np.testing.assert_allclose(gt[n].numpy(), gj[n].numpy(), atol=1e-3 * scale + 1e-8,
                                   rtol=0, err_msg=n)


def test_train_step_gradients_match_jax(train_run):
    check_train_gradients(train_run)
    gt = train_run["grads_t"]
    offsets = [n for n in gt if ".offset.conv." in n]
    assert len(offsets) == 6 and all(float(gt[n].abs().max()) > 0 for n in offsets)


def check_train_updates_and_batch_stats(train_run, min_moved=0.95, float64_stats=None,
                                        float32_spread=()):
    """Updates of step 2, BatchNorm statistics and EMA lag after step 3.
    A statistic named in `float32_spread` is held to `float64_stats`, a
    float64 JAX run's, instead of to JAX's float32 one, which must then be
    the further of the two from it."""
    tm, states, params_t = train_run["tm"], train_run["states"], train_run["params_t"]
    p1, p2 = (params_from_jax(tm, states[i].params) for i in (1, 2))
    moved = 0
    for n in p2:
        want = (p2[n] - p1[n]).numpy()
        got = (params_t[2][n] - params_t[1][n]).numpy()
        moved += bool(np.abs(want).max() > 0)
        # an update is read as the difference of two float32 parameters, so
        # each side carries the rounding of the new parameter: one spacing
        ulp = np.spacing(np.abs(p2[n].numpy()).max())
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 2 * ulp, rtol=0,
                                   err_msg=n)
    assert moved > min_moved * len(p2)  # leaves with a (near-)zero gradient and no decay stay
    stats = state_dict_from_jax({"batch_stats": states[-1].batch_stats})
    own = tm.state_dict()
    assert len(stats) > 100
    for k, v in stats.items():
        if k in float32_spread:
            ref = float64_stats[k]
            assert (v.double() - ref).abs().max() > (own[k].double() - ref).abs().max(), k
            v = ref
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
    # the EMA's distance from the parameters after step 3 (d (ema - p) per
    # step), against the JAX side's: a lag that the parameters' own drift
    # between the two sides does not enter
    p3 = params_from_jax(tm, states[-1].params)
    ema = params_from_jax(tm, states[-1].ema_params)
    for (n, p), e in zip(tm.named_parameters(), train_run["trainer"].ema):
        ulp = np.spacing(np.abs(p3[n].numpy()).max())
        lag_j = (ema[n] - p3[n]).numpy()
        np.testing.assert_allclose((e - p.detach()).numpy(), lag_j,
                                   atol=1e-3 * np.abs(lag_j).max() + 6 * ulp, rtol=0, err_msg=n)


def test_train_step_updates_and_batch_stats_match_jax(train_run):
    check_train_updates_and_batch_stats(train_run)


def test_trainer_fit_epoch_averages_on_cpu():
    """fit: epoch-average metrics over steps_per_epoch steps, the early stop
    of on_epoch_end, and no kernel launch on the CPU (on one thread: no bar
    here reads a float32 sum order)."""
    from yolo_dbl_tpu_torch import kernels

    tm = DetectionModel("yolov13n_DBL.yaml", nc=NC, device="cpu")
    trainer = Trainer(tm, {"batch": BATCH, "imgsz": IMGSZ}).setup(steps_per_epoch=2)
    assert trainer.optimizer.name == "AdamW"  # 'auto' at 2 x 100 iterations
    batches = _train_batches(3, seed=19)
    kernels.reset_launches()
    seen = []
    with torch_threads(1):
        history = trainer.fit(batches, epochs=3, steps_per_epoch=2,
                              on_epoch_end=lambda t, e, avg: seen.append(avg) or e < 1)
    assert [h["epoch"] for h in history] == [0, 1] and seen == history
    assert set(history[0]) == {"loss", "box_loss", "cls_loss", "dfl_loss", "epoch", "seconds"}
    assert trainer.optimizer.count == 4 and all(np.isfinite(h["loss"]) for h in history)
    assert sum(kernels.launches.values()) == 0 and not tm.training
    with pytest.raises(KeyError):
        Trainer(tm, {"lr_zero": 0.1})
