"""The OBB head, its engine and the ResNet trunks in the port against the JAX package, on the CPU.

Box ops and modules at narrow widths (16-32 channels, 64 px) from shared
numpy variables: `xywhr2xyxyxyxy`, `dist2rbox`, `probiou` (forward within
1e-6; the gradient in float64 within 1e-10 of its largest, and at a box of
zero width finite where JAX's is), the OBB head in eval and train mode, `decode_obb`
(xywh 0.05 px, angle 1e-4, scores 1e-3; here far inside), the rotated fast
NMS (the same kept rows), the rotated containment test and TAL, and
`obb_loss` (items within 1e-5 relative, each map's gradient within 1e-4 of
its largest), all in float32 on both sides. Then the obb batches bit for
bit through both loaders, `OBBValidator`'s metrics on the same kept rows,
the `OBB` container and `Results` with `OBBPredictor.build_result`,
`ResNetLayer` (stem and blocks) and both `TorchVision` trunks. Last, the
three reference behaviours the port mirrors (ROADMAP Queue 3): the labels'
rectangle fit on normalized corners, no class offset in the rotated NMS,
and no bias prior on the OBB head.
"""

import contextlib
import json
from types import SimpleNamespace

import cv2
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.data.build import DataLoader as JaxDataLoader
from yolo_dbl_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_dbl_tpu.engine import predictor as JP
from yolo_dbl_tpu.engine import validator as JV
from yolo_dbl_tpu.losses import extra as JX
from yolo_dbl_tpu.losses import tal as JT
from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn import heads as JH
from yolo_dbl_tpu.nn.structures import blocks as JS
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.ops import anchors as JA
from yolo_dbl_tpu.ops import boxes as JO
from yolo_dbl_tpu.ops.nms import non_max_suppression_rotated as jax_nms_rotated

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.data.build import DataLoader
from yolo_dbl_tpu_torch.data.dataset import YOLODataset
from yolo_dbl_tpu_torch.engine import predictor as TP
from yolo_dbl_tpu_torch.engine.validator import OBBValidator
from yolo_dbl_tpu_torch.losses import extra as TX
from yolo_dbl_tpu_torch.losses import tal as TT
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import heads as TH
from yolo_dbl_tpu_torch.nn.structures import blocks as TS
from yolo_dbl_tpu_torch.ops import anchors as TA
from yolo_dbl_tpu_torch.ops import boxes as TO
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression_rotated as torch_nms_rotated

from tests.fixtures import make_task_dataset
from tests.test_torch_modules import jax_tree, random_variables, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
CH = (16, 24, 32)
HW = ((8, 8), (4, 4), (2, 2))  # 64 px at strides 8, 16, 32
STRIDES, NC, M, IMGSZ = (8, 16, 32), 3, 6, 64


def _rboxes(rng, n, lo=8.0, hi=56.0, wh=(4.0, 30.0)):
    """n rotated boxes (n, 5): centres in [lo, hi), sides in `wh`, angles in
    [-π/4, 3π/4), the OBB head's range."""
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(*wh, (n, 2)),
                           rng.uniform(-np.pi / 4, 3 * np.pi / 4, (n, 1))], 1).astype(np.float32)


def _close(t, j, tol=TOL):
    t = to_nhwc(t) if t.dim() == 4 else t.detach().numpy()
    np.testing.assert_allclose(t, np.asarray(j), atol=tol, rtol=tol)


def _run(jax_module, torch_module, inputs, train, seed=0):
    """Both modules on the same NHWC input(s) with shared random variables;
    train mode runs BatchNorm on batch statistics on both sides."""
    jin = [jnp.asarray(x) for x in inputs] if isinstance(inputs, list) else jnp.asarray(inputs)
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jin)
    variables = random_variables(shapes, np.random.default_rng(seed))
    if train:
        out_j, _ = jax_module.apply(jax_tree(variables), jin, train=True, mutable=["batch_stats"])
    else:
        out_j = jax_module.apply(jax_tree(variables), jin)
    from yolo_dbl_tpu_torch.utils.convert import load_jax_variables

    load_jax_variables(torch_module, variables)
    torch_module.train(train)
    tin = [to_nchw(x) for x in inputs] if isinstance(inputs, list) else to_nchw(inputs)
    with torch.no_grad():
        out_t = torch_module(tin)
    return out_j, out_t


# ---------------------------------------------------------------- box ops

def test_xywhr2xyxyxyxy_and_dist2rbox_match_jax():
    rng = np.random.default_rng(1)
    rb = _rboxes(rng, 40)
    np.testing.assert_allclose(TO.xywhr2xyxyxyxy(torch.from_numpy(rb)).numpy(),
                               np.asarray(JO.xywhr2xyxyxyxy(jnp.asarray(rb))), atol=1e-5, rtol=0)
    dist = rng.uniform(0, 15, (2, 30, 4)).astype(np.float32)
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 30, 1)).astype(np.float32)
    anchors = rng.uniform(0, 8, (1, 30, 2)).astype(np.float32)
    got = TA.dist2rbox(*(torch.from_numpy(a) for a in (dist, ang, anchors))).numpy()
    want = np.asarray(JA.dist2rbox(*(jnp.asarray(a) for a in (dist, ang, anchors))))
    assert got.shape == (2, 30, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _probiou_pair(a, b, weights):
    """(value, grads w.r.t. both) of sum(probiou(a[:, None], b[None]) * w) on each side."""
    def f(x, y):
        return (JX.probiou(x[:, None], y[None]) * weights).sum()

    vj = np.asarray(JX.probiou(jnp.asarray(a)[:, None], jnp.asarray(b)[None]))
    gj = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))]
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    vt = TX.probiou(ta[:, None], tb[None])
    gt = [g.numpy() for g in torch.autograd.grad((vt * torch.from_numpy(weights)).sum(), (ta, tb))]
    return (vj, gj), (vt.detach().numpy(), gt)


def test_probiou_and_its_gradient_match_jax():
    """probiou of 12 x 16 rotated-box pairs (some overlapping, some far
    apart) within 1e-6 in float32; its gradient, where float32 rounding on
    either side reaches 1e-6 of the largest, in float64 on both sides
    (`jax.enable_x64`) within 1e-10 of the largest."""
    rng = np.random.default_rng(2)
    a, b = _rboxes(rng, 12, 20, 44), _rboxes(rng, 16, 20, 44)
    w = rng.uniform(0.5, 1.5, (12, 16)).astype(np.float32)
    (vj, _), (vt, _) = _probiou_pair(a, b, w)
    assert vt.shape == (12, 16) and 0.05 < vt.max() <= 1.0 and vt.min() >= 0.0
    np.testing.assert_allclose(vt, vj, atol=1e-6, rtol=0)
    with jax.enable_x64(True):
        (vj, gj), (vt, gt) = _probiou_pair(*(x.astype(np.float64) for x in (a, b, w)))
    np.testing.assert_allclose(vt, vj, atol=1e-12, rtol=0)
    for g, want in zip(gt, gj):
        assert g.dtype == want.dtype == np.float64
        np.testing.assert_allclose(g, want, atol=1e-10 * np.abs(want).max(), rtol=0)


def test_probiou_gradient_at_a_zero_width_box_is_finite_where_jax_is():
    """A box of w 0 (or h 0) makes the square root's argument in t3 0, whose
    gradient is infinite: the backward there is finite exactly where JAX's
    is, and the values agree."""
    rng = np.random.default_rng(3)
    a, b = _rboxes(rng, 4, 20, 44), _rboxes(rng, 5, 20, 44)
    a[1, 2] = 0.0
    b[2, 3] = 0.0
    (vj, gj), (vt, gt) = _probiou_pair(a, b, np.ones((4, 5), np.float32))
    np.testing.assert_allclose(vt, vj, atol=1e-6, rtol=0)
    for g, want in zip(gt, gj):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(want))
        ok = np.isfinite(want)
        np.testing.assert_allclose(g[ok], want[ok], atol=1e-6 * np.abs(want[ok]).max(), rtol=0)
    print("finite gradient rows:", [np.isfinite(g).all(-1).tolist() for g in gt])


# ---------------------------------------------------------------- the head

def _levels(seed, b=2, ch=CH):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 1.0, (b, h, w, c)).astype(np.float32) for (h, w), c in zip(HW, ch)]


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "dwconv"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_obb_head_matches_jax(train, legacy):
    out_j, out_t = _run(JH.OBB(nc=NC, ne=1, ch=CH, legacy=legacy),
                        TH.OBB(nc=NC, ne=1, ch=CH, legacy=legacy), _levels(4), train)
    assert [a.shape[1] for a in out_t[1]] == [1, 1, 1]
    for a, b in zip(out_t[0] + out_t[1], list(out_j[0]) + list(out_j[1]), strict=True):
        _close(a, b)
    ang = torch.cat([a.flatten() for a in out_t[1]])
    assert float(ang.min()) >= -np.pi / 4 and float(ang.max()) < 3 * np.pi / 4


def _obb_maps(seed, b=2):
    """Raw Detect maps (B, h, w, 64 + nc) and angle maps (B, h, w, 1) in range."""
    rng = np.random.default_rng(seed)
    det = [rng.normal(0, 1.5, (b, h, w, 64 + NC)).astype(np.float32) for h, w in HW]
    ang = [rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, h, w, 1)).astype(np.float32) for h, w in HW]
    return det, ang


def test_decode_obb_matches_jax():
    det, ang = _obb_maps(5)
    want = np.asarray(JH.decode_obb([jnp.asarray(a) for a in det], [jnp.asarray(a) for a in ang],
                                    STRIDES, NC))
    got = TH.decode_obb([torch.from_numpy(a) for a in det], [torch.from_numpy(a) for a in ang],
                        STRIDES, NC).numpy()
    assert got.shape == want.shape == (2, 4 + NC + 1, 84)
    assert np.abs(got[:, :4] - want[:, :4]).max() < 1e-4  # bar 0.05 px
    assert np.abs(got[:, -1] - want[:, -1]).max() <= 1e-6  # bar 1e-4 rad
    assert np.abs(got[:, 4:-1] - want[:, 4:-1]).max() <= 1e-6  # bar 1e-3


# ---------------------------------------------------------------- rotated NMS

def _decode(seed, a=96, b=2):
    """A random OBB decode (B, 4+nc+1, A): boxes crowded enough to overlap."""
    rng = np.random.default_rng(seed)
    rb = np.stack([_rboxes(rng, a, 8, 56, (6, 24)) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, a, NC)).astype(np.float32)
    return np.concatenate([rb[..., :4], scores, rb[..., 4:]], -1).transpose(0, 2, 1).copy()


@pytest.mark.parametrize("conf,iou,max_det", [(0.25, 0.45, 300), (0.5, 0.3, 20)])
def test_rotated_nms_keeps_the_rows_of_jax(conf, iou, max_det):
    """The same kept rows and counts (bit for bit: the rows are gathered
    inputs), on decodes without ties; max_det 20 cuts the kept rows."""
    pred = _decode(6)
    dj, nj = jax_nms_rotated(jnp.asarray(pred), conf_thres=conf, iou_thres=iou, max_det=max_det,
                             nc=NC)
    dt, nt = torch_nms_rotated(torch.from_numpy(pred), conf_thres=conf, iou_thres=iou,
                               max_det=max_det, nc=NC)
    assert dt.shape == (2, max_det, 7) and nt.dtype == torch.int32
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert 0 < int(nt.min())
    print("kept", nt.tolist(), "of", int((pred[:, 4:4 + NC].max(1) >= conf).sum()), "candidates")


# ---------------------------------------------------------------- rotated TAL and the loss

def _anchors():
    pts, st = TA.make_anchors(HW, STRIDES)
    return (pts * st).numpy(), pts.numpy(), st.numpy()


def _gt_rboxes(seed, b=2, tiny=False):
    """GT rotated boxes in pixels (B, M, 5), 3 and 5 real, and their classes."""
    rng = np.random.default_rng(seed)
    gt = np.stack([_rboxes(rng, M, 16, 48, (10, 36)) for _ in range(b)])
    if tiny:
        gt[0, 1, 2] = 1.5  # under 2 px: dropped by obb_loss
    mask = (np.arange(M)[None] < np.array([[3], [5]])).astype(np.float32)
    return gt * mask[..., None], rng.integers(0, NC, (b, M)).astype(np.int32), mask


def test_select_candidates_in_rotated_gts_matches_jax():
    anc = _anchors()[0]
    gt, _, _ = _gt_rboxes(7)
    got = TT.select_candidates_in_rotated_gts(torch.from_numpy(anc), torch.from_numpy(gt)).numpy()
    want = np.asarray(JT.select_candidates_in_rotated_gts(jnp.asarray(anc), jnp.asarray(gt)))
    np.testing.assert_array_equal(got, want)
    assert got[:, :3].sum() > 20


@pytest.mark.parametrize("topk", [10, 3])
def test_rotated_tal_matches_jax(topk):
    """Every output of the rotated assigner on predicted boxes near the GTs
    and random scores (metrics without ties): JAX's threshold form and the
    port's stable sort keep the same anchors."""
    anc = _anchors()[0]
    gt, cls, mask = _gt_rboxes(8)
    rng = np.random.default_rng(9)
    near = gt[:, rng.integers(0, 3, 84)] + rng.normal(0, 3, (2, 84, 5)).astype(np.float32)
    near[..., 2:4] = np.abs(near[..., 2:4]) + 2
    scores = rng.uniform(0.05, 0.95, (2, 84, NC)).astype(np.float32)
    args = (scores, near, anc, cls, gt, mask)
    want = JT.rotated_task_aligned_assign(*(jnp.asarray(a) for a in args), topk=topk,
                                          num_classes=NC)
    got = TT.rotated_task_aligned_assign(*(torch.from_numpy(a) for a in args), topk=topk,
                                         num_classes=NC)
    for name, g, w in zip(("labels", "rboxes", "scores", "fg", "gt_idx"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert 5 < int(got[3].sum()) and float(got[2].max()) > 0


def _loss_batch(seed, tiny):
    gt, cls, mask = _gt_rboxes(seed, tiny=tiny)
    gt = gt.copy()
    gt[..., :4] /= IMGSZ
    return {"gt_boxes": gt, "gt_cls": cls, "gt_mask": mask}


@pytest.mark.parametrize("tiny", [False, True], ids=["boxes", "tiny_box"])
def test_obb_loss_matches_jax(tiny):
    """Items within 1e-5 relative and each map's gradient within 1e-4 of
    its largest, float32 on both sides; a GT under 2 px drops out of both."""
    det, ang = _obb_maps(10)
    batch = _loss_batch(11, tiny)

    def f(d, a):
        return JX.obb_loss(d, a, {k: jnp.asarray(v) for k, v in batch.items()}, STRIDES, NC)

    (lj, ij), gj = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(x) for x in det], [jnp.asarray(x) for x in ang])
    td = [torch.tensor(x, requires_grad=True) for x in det]
    ta = [torch.tensor(x, requires_grad=True) for x in ang]
    lt, it = TX.obb_loss(td, ta, {k: torch.as_tensor(v) for k, v in batch.items()}, STRIDES, NC)
    gt = torch.autograd.grad(lt, td + ta)
    assert float(ij.box) > 0 and float(ij.dfl) > 0
    for a, b in zip((lt, *it), (lj, *ij)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    for i, (g, w) in enumerate(zip(gt, list(gj[0]) + list(gj[1]), strict=True)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1e-30), rtol=0,
                                   err_msg=f"map {i}")


# ---------------------------------------------------------------- batches, validator, Results

@pytest.fixture(scope="module")
def obb_set(tmp_path_factory):
    return make_task_dataset(tmp_path_factory.mktemp("obb"), task="obb", n_train=5, n_val=3,
                             imgsz=96)


@pytest.mark.parametrize("augment", [False, True], ids=["val", "train"])
def test_obb_batches_match_jax(obb_set, augment):
    """format_batch_task through both loaders, bit for bit: images, the
    (B, max_gt, 5) rotated boxes, classes and masks. Both loaders turn
    augmentation off for obb, so the train split comes in file order too."""
    kw = dict(batch_size=2, imgsz=IMGSZ, augment=augment, max_gt=8, seed=2, prefetch=0,
              drop_last=False)
    ds = dict(split="train" if augment else "val", imgsz=IMGSZ, task="obb")
    got = list(DataLoader(YOLODataset(obb_set, **ds), **kw))
    want = list(JaxDataLoader(JaxDataset(obb_set, **ds), task="obb", **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("img", "gt_boxes", "gt_cls", "gt_mask", "indices"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["gt_boxes"].shape == (2, 8, 5) and got[0]["gt_mask"].sum() > 0


def _val_batches(seed, n=3, b=2):
    """Batches with rotated GT and the NMS output a model would give them
    (GT moved a little, a false row, a missed GT)."""
    rng = np.random.default_rng(seed)
    batches, outs = [], []
    for _ in range(n):
        gt, cls, mask = _gt_rboxes(int(rng.integers(1 << 30)), b=b)
        dets = np.zeros((b, 10, 7), np.float32)
        num = np.zeros(b, np.int32)
        for i in range(b):
            real = np.flatnonzero(mask[i])[:-1]
            rows = gt[i, real] + rng.normal(0, 1.5, (len(real), 5)).astype(np.float32) * [1, 1, 1, 1, 0.05]
            rows = np.concatenate([rows, _rboxes(rng, 1)], 0)
            k = len(rows)
            dets[i, :k, :5] = rows
            dets[i, :k, 5] = rng.uniform(0.3, 1.0, k)
            dets[i, :k, 6] = np.concatenate([cls[i, real], rng.integers(0, NC, 1)])
            num[i] = k
        g = gt.copy()
        g[..., :4] /= IMGSZ
        batches.append({"img": np.zeros((b, IMGSZ, IMGSZ, 3), np.uint8), "gt_boxes": g,
                        "gt_cls": cls, "gt_mask": mask})
        outs.append((dets, num))
    return batches, outs


def test_obb_validator_metrics_match_jax():
    """The same kept rows into both validators (their device halves
    replaced): box mAP of the axis-aligned extents and the rbox (probiou)
    mAP equal."""
    batches, outs = _val_batches(12)
    names = {i: str(i) for i in range(NC)}
    jv = object.__new__(JV.OBBValidator)
    jv.model, jv.conf, jv.iou, jv.max_det = SimpleNamespace(nc=NC, names=names), 0.001, 0.7, 10
    it = iter(outs)
    jv._infer = lambda variables, img: next(it)
    want = jv(None, batches)
    tv = OBBValidator(SimpleNamespace(nc=NC, names=names, device=torch.device("cpu")))
    it2 = iter(outs)
    tv.infer = lambda img: tuple(torch.from_numpy(a) for a in next(it2))
    got = tv(batches)
    assert want["rbox_mAP50"] > 0.2 and got["images"] == want["images"] == 6
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            v, got[k] = list(v.values()), list(got[k].values())
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-9, err_msg=k)


def test_obb_results_and_build_result_match_jax(tmp_path):
    """OBBPredictor.build_result maps letterboxed rows to the frame as JAX's
    does; the OBB container's corners and envelopes, and the Results' JSON,
    summary, save_txt and drawing equal JAX's."""
    rng = np.random.default_rng(13)
    dets = np.zeros((1, 8, 7), np.float32)
    dets[0, :4, :5] = _rboxes(rng, 4)
    dets[0, :4, 5] = rng.uniform(0.3, 1, 4)
    dets[0, :4, 6] = [0, 1, 1, 0]
    num = np.array([4], np.int32)
    im = np.zeros((40, 80, 3), np.uint8)
    model = SimpleNamespace(names={0: "plane", 1: "ship"})
    jp = object.__new__(JP.OBBPredictor)
    jp.model = model
    want = jp.build_result((dets, num), 0, im, 0.8, (0.0, 12.0), "a.jpg")
    tp = object.__new__(TP.OBBPredictor)
    tp.model = model
    got = tp.build_result((dets, num), 0, im, 0.8, (0.0, 12.0), "a.jpg")
    assert got.boxes is None and len(got) == len(want) == 4
    np.testing.assert_array_equal(got.obb.data, want.obb.data)
    for attr in ("xywhr", "conf", "cls", "xyxyxyxy", "xyxy"):
        np.testing.assert_array_equal(getattr(got.obb, attr), getattr(want.obb, attr), err_msg=attr)
    assert json.dumps(got.to_json_dicts()) == json.dumps(want.to_json_dicts())
    assert got.verbose() == want.verbose() == "2 planes, 2 ships"
    a, b = tmp_path / "t.txt", tmp_path / "j.txt"
    got.save_txt(a)
    want.save_txt(b)
    assert a.read_text() == b.read_text() and len(a.read_text().splitlines()) == 4
    np.testing.assert_array_equal(got.plot(im), want.plot(im))


# ---------------------------------------------------------------- ResNet layers and trunks

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", ["stem", "blocks_s2", "blocks_s1"])
def test_resnet_layer_matches_jax(case, train):
    """The stem (7x7 s2 Conv, 3x3 s2 max pool) and stacks of ResNet blocks
    (the first of stride 2 with its projection, or of stride 1 onto e·c2
    channels: no projection past the first)."""
    rng = np.random.default_rng(14)
    c1, c2, s, first, n = {"stem": (3, 8, 1, True, 1), "blocks_s2": (8, 4, 2, False, 2),
                           "blocks_s1": (16, 4, 1, False, 3)}[case]
    x = rng.normal(0, 1, (2, 16, 12, c1)).astype(np.float32)
    out_j, out_t = _run(JB.ResNetLayer(c2, s, first, n), TB.ResNetLayer(c1, c2, s, first, n), x,
                        train)
    assert out_t.shape[1] == (c2 if first else 4 * c2)
    _close(out_t, out_j)


@pytest.mark.parametrize("model,truncate,train", [("resnet18", 2, False), ("resnet18", 1, True),
                                                  ("resnet50", 2, False), ("resnet50", 2, True)])
def test_torchvision_trunks_match_jax(model, truncate, train):
    """TorchVision over the native ResNet-18 and ResNet-50 trunks (raw
    convs, BatchNorm eps 1e-5), the last map or its global mean, at 64 px.
    Eval mode in float32 within 1e-4. Train mode in float64 on both sides
    within 1e-9: in float32 ResNet-50's 53 BatchNorms on batch statistics
    part by 7.5e-3 of a largest 9.3 (at 128 px too), where flax's
    E[x²] - E[x]² variance loses digits that PyTorch's does not."""
    wide = jax.enable_x64(True) if train else contextlib.nullcontext()
    dt = np.float64 if train else np.float32
    x = np.random.default_rng(15).uniform(0, 1, (2, 64, 64, 3)).astype(dt)
    c2 = 512 if model == "resnet18" else 2048
    with wide:
        jm = JS.TorchVision(c2, model, truncate=truncate, dtype=jnp.dtype(dt))
        tm = TS.TorchVision(3, c2, model, truncate=truncate).to(torch.float64 if train else
                                                                torch.float32)
        out_j, out_t = _run(jm, tm, x, train)
    assert out_t.shape == ((2, c2, 1, 1) if truncate == 1 else (2, c2, 2, 2))
    _close(out_t, out_j, tol=1e-9 if train else 1e-4)


def test_trunk_batchnorm_moves_as_flax_momentum_09():
    """The trunks' BatchNorms take flax's momentum 0.9 (torch 0.1) and
    epsilon 1e-5, unlike every Conv's (0.97, 1e-3)."""
    trunk = TS.TorchVision(3, 512, "resnet18")
    bns = [m for m in trunk.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 20 and all(m.momentum == 0.1 and m.eps == 1e-5 for m in bns)
    layer = TB.ResNetLayer(3, 8, 1, True)
    assert layer.stem.bn.momentum == 0.03 and layer.stem.bn.eps == 1e-3


# ---------------------------------------------------------------- mirrored reference behaviours

def test_obb_labels_fit_normalized_corners_as_jax(tmp_path):
    """ROADMAP Queue 3 (a): both packages fit cv2.minAreaRect to the
    corners divided by the image's width and height, then scale the fit's w
    by the width and its h by the height. On a non-square image that is
    exact only where the fit's w lies along x; a rectangle's corners from
    the label's rotated box then miss the true letterboxed corners. On a
    160 x 96 image letterboxed to 64, a 70 x 30 rectangle at 4 angles: the
    port's rboxes equal JAX's, and the corners' largest miss is measured
    (printed)."""
    w0, h0 = 160, 96
    root = tmp_path / "set"
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
    angles = (0.0, 20.0, 45.0, 60.0)  # degrees
    for split in ("train", "val"):
        for i, a in enumerate(angles):
            cv2.imwrite(str(root / "images" / split / f"im{i}.jpg"), np.zeros((h0, w0, 3), np.uint8))
            pts = cv2.boxPoints(((80.0, 48.0), (70.0, 30.0), a))
            row = " ".join(f"{v:.6f}" for v in (pts / [w0, h0]).reshape(-1))
            (root / "labels" / split / f"im{i}.txt").write_text(f"0 {row}\n")
    kw = dict(batch_size=4, imgsz=IMGSZ, augment=False, max_gt=2, prefetch=0, shuffle=False)
    got = next(iter(DataLoader(YOLODataset(root, split="val", imgsz=IMGSZ, task="obb"), **kw)))
    want = next(iter(JaxDataLoader(JaxDataset(root, split="val", imgsz=IMGSZ, task="obb"),
                                   task="obb", **kw)))
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
    gain = IMGSZ / w0
    pad = (IMGSZ - h0 * gain) / 2
    misses = []
    for i, a in enumerate(angles):
        true = cv2.boxPoints(((80.0, 48.0), (70.0, 30.0), a)) * gain + [0, pad]
        rb = got["gt_boxes"][i, 0].astype(np.float64) * np.array([IMGSZ] * 4 + [1])
        label = TO.xywhr2xyxyxyxy(torch.from_numpy(rb)).numpy()
        miss = float(np.linalg.norm(true[:, None] - label[None], axis=-1).min(1).max())
        misses.append(miss)
        print(f"{a:.0f} deg: label xywhr {np.round(rb, 3).tolist()}; true corners' largest miss "
              f"{miss:.4f} px")
    assert max(misses) > 0.5  # the departure shows
    print("largest corner miss over the angles (px):", max(misses))


def test_rotated_nms_suppresses_across_classes_as_jax():
    """ROADMAP Queue 3 (b): JAX's rotated NMS applies no class offset
    (nms.py:203-214), so two boxes of different classes that overlap
    suppress each other; the port mirrors it."""
    pred = np.zeros((1, 4 + NC + 1, 3), np.float32)
    pred[0, :4] = [[20, 21, 44], [20, 20, 44], [10, 10, 8], [10, 10, 8]]
    pred[0, 4:4 + NC] = [[0.9, 0.0, 0.0], [0.0, 0.8, 0.0], [0.0, 0.0, 0.6]]
    pred[0, -1] = [0.1, 0.12, 0.5]
    dj, nj = jax_nms_rotated(jnp.asarray(pred), conf_thres=0.25, iou_thres=0.45, nc=NC)
    dt, nt = torch_nms_rotated(torch.from_numpy(pred), conf_thres=0.25, iou_thres=0.45, nc=NC)
    assert int(nt[0]) == int(nj[0]) == 2  # the class-1 box at (21, 20) is gone
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert sorted(dt[0, :2, 6].tolist()) == [0.0, 2.0]


def test_fresh_obb_model_has_zero_head_biases_as_jax():
    """ROADMAP Queue 3 (c): JAX's `_bias_init` matches `m{head}/cv2_{lvl}_2`,
    which the OBB head's `m{head}/detect/cv2_...` leaves never hold, so its
    box and class output biases stay at flax's zero init; the port's fresh
    model mirrors it."""
    jm = JaxDetectionModel("yolov8n-obb.yaml", nc=15)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMGSZ, IMGSZ, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    flat = flax.traverse_util.flatten_dict(jm._bias_init(zeros), sep="/")
    head = f"params/m{len(jm.spec.layers) - 1}/detect"
    biases = {k: v for k, v in flat.items() if k.startswith(head) and k.endswith("_2/conv/bias")
              and k.split("/")[-3][:3] in ("cv2", "cv3")}
    assert len(biases) == 6 and all(not np.any(v) for v in biases.values())
    tm = DetectionModel("yolov8n-obb.yaml", nc=15, device="cpu")
    assert tm.head_name == "OBB" and tm.detect_branches == [tm.detect.detect]
    for lvl in range(3):
        assert not getattr(tm.detect.detect, f"cv2_{lvl}_2").conv.bias.any()
        assert not getattr(tm.detect.detect, f"cv3_{lvl}_2").conv.bias.any()
