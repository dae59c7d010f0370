"""The segment, pose and classify heads and their engine in the port against the JAX package, on the CPU.

Modules at narrow widths (8-32 channels, 32-64 px) from shared numpy
variables, in eval and train mode: Proto alone and inside Segment, Pose,
Classify, `decode_masks`, `kpts_decode`, within 1e-5. The task losses:
`segmentation_loss` (overlap on and off) and `pose_loss` (nd 2 and 3), the
port's foreground-gathered mask term against JAX's dense (B, A, Hm, Wm) one.
JAX's losses cast to float32 (losses/extra.py, losses/detection.py:87), so
the float64 comparison widens the float32 casts of JAX's extra.py to
float64 (`_wide_extra`), as the port keeps float64 maps in float64 there:
the mask, keypoint and visibility items within 1e-10 relative and the
gradients of the coefficient, prototype and keypoint maps within 1e-9 of
each map's largest; the detection items and the Detect maps' gradients come
from `detection_loss`, float32 on both sides, within 1e-5. Then
`classification_loss`, `keypoint_loss`, NMS's anchor indices,
`format_batch_task` bit for bit through both loaders, the task metrics, the
task `Results`, and the two reference behaviours the port mirrors (no bias
prior on the task heads; no gain on the mask term).
"""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.data.build import DataLoader as JaxDataLoader
from yolo_dbl_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_dbl_tpu.engine import predictor as JP
from yolo_dbl_tpu.losses import extra as JX
from yolo_dbl_tpu.nn import heads as JH
from yolo_dbl_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.ops.anchors import make_anchors as jax_make_anchors
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_dbl_tpu.utils import instance as JI
from yolo_dbl_tpu.utils import metrics as JM

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.data.build import DataLoader
from yolo_dbl_tpu_torch.data.dataset import YOLODataset
from yolo_dbl_tpu_torch.engine import predictor as TP
from yolo_dbl_tpu_torch.losses import extra as TX
from yolo_dbl_tpu_torch.nn import heads as TH
from yolo_dbl_tpu_torch.ops.anchors import make_anchors
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils import instance as TI
from yolo_dbl_tpu_torch.utils import metrics as TM
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables

from tests.fixtures import make_task_dataset
from tests.test_torch_modules import jax_tree, random_variables, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
CH = (16, 24, 32)  # the three levels' widths
HW = ((8, 8), (4, 4), (2, 2))  # their maps at 64 px, strides 8, 16, 32


def _levels(seed, b=2, ch=CH):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 1.0, (b, h, w, c)).astype(np.float32) for (h, w), c in zip(HW, ch)]


def _run(jax_module, torch_module, inputs, train, seed=0):
    """Both modules on the same NHWC input(s) (a list: per-level maps) with
    shared random variables; train mode runs BatchNorm on batch statistics
    on both sides. Returns (JAX output, port output)."""
    jin = [jnp.asarray(x) for x in inputs] if isinstance(inputs, list) else jnp.asarray(inputs)
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jin)
    variables = random_variables(shapes, np.random.default_rng(seed))
    if train:
        out_j, _ = jax_module.apply(jax_tree(variables), jin, train=True, mutable=["batch_stats"])
    else:
        out_j = jax_module.apply(jax_tree(variables), jin)
    load_jax_variables(torch_module, variables)
    torch_module.train(train)
    tin = [to_nchw(x) for x in inputs] if isinstance(inputs, list) else to_nchw(inputs)
    with torch.no_grad():
        out_t = torch_module(tin)
    return out_j, out_t


def _close(t, j, tol=TOL):
    t = to_nhwc(t) if t.dim() == 4 else t.numpy()
    np.testing.assert_allclose(t, np.asarray(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_proto_matches_jax(train):
    """Proto's raw flax ConvTranspose (SAME padding, kernel not transposed)
    through the bridge's flipped-kernel rule for nn.ConvTranspose2d."""
    x = np.random.default_rng(1).normal(0, 1, (2, 6, 5, 12)).astype(np.float32)
    out_j, out_t = _run(JH.Proto(16, 8), TH.Proto(12, 16, 8), x, train)
    assert out_t.shape == (2, 8, 12, 10)
    _close(out_t, out_j)


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "dwconv"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_segment_matches_jax(train, legacy):
    out_j, out_t = _run(JH.Segment(nc=3, nm=8, npr=16, ch=CH, legacy=legacy),
                        TH.Segment(nc=3, nm=8, npr=16, ch=CH, legacy=legacy), _levels(2), train)
    (det_j, coef_j, proto_j), (det_t, coef_t, proto_t) = out_j, out_t
    for a, b in zip(det_t + coef_t, list(det_j) + list(coef_j), strict=True):
        _close(a, b)
    assert proto_t.shape == (2, 8, 16, 16)
    _close(proto_t, proto_j)


@pytest.mark.parametrize("kpt_shape", [(17, 3), (4, 2)], ids=["17x3", "4x2"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pose_matches_jax(train, kpt_shape):
    out_j, out_t = _run(JH.Pose(nc=2, kpt_shape=kpt_shape, ch=CH, legacy=True),
                        TH.Pose(nc=2, kpt_shape=kpt_shape, ch=CH, legacy=True), _levels(3), train)
    assert out_t[1][0].shape[1] == kpt_shape[0] * kpt_shape[1]
    for a, b in zip(out_t[0] + out_t[1], list(out_j[0]) + list(out_j[1]), strict=True):
        _close(a, b)


@pytest.mark.parametrize("as_list", [False, True], ids=["tensor", "list"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_classify_matches_jax(train, as_list):
    """Conv 1x1 to 1280, the global mean, Dense; a list input is
    concatenated on channels."""
    rng = np.random.default_rng(4)
    x = [rng.normal(0, 1, (2, 4, 4, c)).astype(np.float32) for c in (8, 8)]
    out_j, out_t = _run(JH.Classify(5), TH.Classify(16, 5), x if as_list else np.concatenate(x, -1),
                        train)
    assert out_t.shape == (2, 5)
    _close(out_t, out_j)


def test_decode_masks_matches_jax():
    """sigmoid(coeff · protos) cut to each box with the half-open test, on
    boxes whose edges fall on and between prototype pixels."""
    rng = np.random.default_rng(5)
    coeffs = rng.normal(0, 1, (6, 8)).astype(np.float32)
    protos = rng.normal(0, 1, (16, 16, 8)).astype(np.float32)
    xy = rng.uniform(0, 40, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 24, (6, 2))], 1).astype(np.float32)
    boxes[0] = [8, 12, 32, 40]  # edges on prototype pixels at 64 -> 16
    want = np.asarray(JH.decode_masks(jnp.asarray(coeffs), jnp.asarray(protos), jnp.asarray(boxes),
                                      (64, 64)))
    got = TH.decode_masks(torch.from_numpy(coeffs), torch.from_numpy(protos),
                          torch.from_numpy(boxes), (64, 64)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_kpts_decode_matches_jax():
    rng = np.random.default_rng(6)
    anchors, _ = jax_make_anchors(HW, (8, 16, 32))
    pk = rng.normal(0, 1, (2, len(anchors), 5, 3)).astype(np.float32)
    want = np.asarray(JX.kpts_decode(anchors, jnp.asarray(pk)))
    a_t, _ = make_anchors(HW, (8, 16, 32))
    got = TX.kpts_decode(a_t, torch.from_numpy(pk)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- task losses

NC, M, STRIDES, NM = 3, 6, (8, 16, 32), 8


class _WideNumpy:
    """jax.numpy with float32 read as float64: the float32 casts of JAX's
    losses/extra.py (and nothing else) made float64 (`_wide_extra`)."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture
def _wide_extra():
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JX, "jnp", _WideNumpy())
        yield


def _task_batch(seed, b=2, kpt_shape=None, mask_hw=16):
    """GT boxes (2 and 4 real of M), classes, overlapping rectangle masks at
    mask_hw with a few pixels flipped, keypoints inside the boxes (some
    invisible)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.3, 0.7, (b, M, 2))
    wh = rng.uniform(0.2, 0.55, (b, M, 2))
    batch = dict(gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                 gt_cls=rng.integers(0, NC, (b, M)).astype(np.int32),
                 gt_mask=(np.arange(M)[None] < np.array([[2], [4]])).astype(np.float32))
    real = batch["gt_mask"].astype(bool)
    masks = np.zeros((b, M, mask_hw, mask_hw), np.float32)
    for i in range(b):
        for j in np.flatnonzero(real[i]):
            (cx, cy), (w, h) = xy[i, j] * mask_hw, wh[i, j] * mask_hw
            masks[i, j, int(cy - h / 2):int(cy + h / 2) + 1, int(cx - w / 2):int(cx + w / 2) + 1] = 1
            flip = rng.random((mask_hw, mask_hw)) < 0.05
            masks[i, j][flip] = 1 - masks[i, j][flip]
    batch["gt_masks"] = masks
    if kpt_shape is not None:
        k, nd = kpt_shape
        kx = xy[..., None, 0] + (rng.random((b, M, k)) - 0.5) * wh[..., None, 0]
        ky = xy[..., None, 1] + (rng.random((b, M, k)) - 0.5) * wh[..., None, 1]
        kp = [kx, ky] + ([np.where(rng.random((b, M, k)) < 0.2, 0.0, 2.0)] if nd == 3 else [])
        batch["gt_kpts"] = (np.stack(kp, -1) * real[..., None, None]).astype(np.float32)
    return batch


def _maps(seed, channels, b=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (b, h, w, channels)) for h, w in HW]


def _grads_close(got, want, tol, what):
    """Each map's gradient within tol of its largest |JAX| (exactly 0 where
    JAX's is: a level with no foreground anchor); some map's not 0."""
    want = [np.asarray(w) for w in want]
    assert max(np.abs(w).max() for w in want) > 0, f"{what}: zero gradients"
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(g, w, atol=tol * np.abs(w).max(), rtol=0,
                                   err_msg=f"{what}[{i}]")


def _loss_pair(jax_fn, torch_fn, maps, batch):
    """JAX's and the port's (loss, items, gradients w.r.t. each list of
    maps) in float64, the maps drawn once."""
    def f(*ms):
        return jax_fn(*ms, {k: jnp.asarray(v) for k, v in batch.items()})

    jm = [[jnp.asarray(a, jnp.float64) for a in group] if isinstance(group, list)
          else jnp.asarray(group, jnp.float64) for group in maps]
    (loss_j, items_j), grads_j = jax.value_and_grad(f, argnums=tuple(range(len(maps))),
                                                    has_aux=True)(*jm)
    tm = [[torch.tensor(a, requires_grad=True) for a in group] if isinstance(group, list)
          else torch.tensor(group, requires_grad=True) for group in maps]
    leaves = [t for group in tm for t in (group if isinstance(group, list) else [group])]
    loss_t, items_t = torch_fn(*tm, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads_t = torch.autograd.grad(loss_t, leaves)
    flat_j = [g for group in grads_j for g in (group if isinstance(group, list) else [group])]
    return (float(loss_j), dict(items_j), flat_j), (float(loss_t.detach()), items_t._asdict(),
                                                    [g.numpy() for g in grads_t])


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "no_overlap"])
def test_segmentation_loss_matches_jax_dense_form(overlap, _wide_extra):
    """The port's mask term over the foreground anchors only equals JAX's
    dense (B, A, Hm, Wm) form: the mask item within 1e-10 relative, the
    coefficient and prototype gradients within 1e-9 of each map's largest
    (float64); the detection items and the Detect maps' gradients within
    1e-5 (float32 on both sides)."""
    batch = _task_batch(7)
    det = _maps(8, 64 + NC)
    coeffs = _maps(9, NM)
    protos = np.random.default_rng(10).normal(0, 1, (2, 16, 16, NM))
    (lj, ij, gj), (lt, it, gt) = _loss_pair(
        lambda d, c, p, b: JX.segmentation_loss(d, c, p, b, STRIDES, NC, overlap_masks=overlap),
        lambda d, c, p, b: TX.segmentation_loss(d, c, p, b, STRIDES, NC, overlap_masks=overlap),
        [det, coeffs, protos], batch)
    assert list(it) == ["box", "cls", "dfl", "mask"] and set(ij) == set(it)
    assert float(ij["mask"]) > 0.1
    np.testing.assert_allclose(float(it["mask"]), float(ij["mask"]), rtol=1e-10)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=TOL, err_msg=k)
    np.testing.assert_allclose(lt, lj, rtol=TOL)
    _grads_close(gt[3:], gj[3:], 1e-9, "coefficients and prototypes")
    _grads_close(gt[:3], gj[:3], TOL, "Detect maps")


def test_exclusive_instance_masks_match_jax():
    """The smallest instance keeps a pixel; equal areas by index; padded rows none."""
    gm = _task_batch(11)["gt_masks"]
    gm[0, 1] = gm[0, 0]  # two instances of equal area over the same pixels
    want = np.asarray(JX.exclusive_instance_masks(jnp.asarray(gm)))
    got = TX.exclusive_instance_masks(torch.from_numpy(gm)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) <= 1).all() and got[0, :2].sum() == gm[0, 0].sum()


@pytest.mark.parametrize("kpt_shape", [(17, 3), (4, 2)], ids=["nd3", "nd2"])
def test_pose_loss_matches_jax(kpt_shape, _wide_extra):
    """The keypoint location term (its (2σ)² divisor) and, with nd 3, the
    visibility BCE on the raw logit: kpt and kobj within 1e-10 relative, the
    keypoint maps' gradients within 1e-9 of each map's largest (float64);
    the detection items within 1e-5 (float32)."""
    batch = _task_batch(12, kpt_shape=kpt_shape)
    det = _maps(13, 64 + NC)
    kpts = _maps(14, kpt_shape[0] * kpt_shape[1])
    (lj, ij, gj), (lt, it, gt) = _loss_pair(
        lambda d, k, b: JX.pose_loss(d, k, b, STRIDES, NC, kpt_shape=kpt_shape),
        lambda d, k, b: TX.pose_loss(d, k, b, STRIDES, NC, kpt_shape=kpt_shape),
        [det, kpts], batch)
    assert list(it) == ["box", "cls", "dfl", "kpt", "kobj"] and set(ij) == set(it)
    assert float(ij["kpt"]) > 0
    for k in ("kpt", "kobj"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-10, atol=0, err_msg=k)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=TOL, err_msg=k)
    np.testing.assert_allclose(lt, lj, rtol=TOL)
    _grads_close(gt[3:], gj[3:], 1e-9, "keypoint maps")
    _grads_close(gt[:3], gj[:3], TOL, "Detect maps")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classification_loss_matches_jax(smoothing):
    rng = np.random.default_rng(15)
    logits = rng.normal(0, 2, (4, 7))
    labels = rng.integers(0, 7, 4)
    with jax.enable_x64(True):
        want = float(JX.classification_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(TX.classification_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                       smoothing))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("k", [17, 5])
def test_keypoint_loss_matches_jax(k):
    """Its 2σ² divisor, the per-row factor and the count of rows with a
    visible keypoint."""
    rng = np.random.default_rng(16)
    pred, gt = rng.normal(0, 3, (6, k, 2)), rng.normal(0, 3, (6, k, 2))
    mask = (rng.random((6, k)) < 0.7).astype(np.float64)
    mask[2] = 0
    area = rng.uniform(1, 30, 6)
    with jax.enable_x64(True):
        want = float(JX.keypoint_loss(*(jnp.asarray(a) for a in (pred, gt, mask, area))))
    got = float(TX.keypoint_loss(*(torch.from_numpy(a) for a in (pred, gt, mask, area))))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_nms_return_idx_matches_jax():
    """On random decodes (no ties): equal rows, counts and anchor indices, 0
    on padded rows."""
    rng = np.random.default_rng(17)
    a = 84
    pred = np.concatenate([rng.uniform(8, 56, (2, 2, a)), rng.uniform(4, 30, (2, 2, a)),
                           rng.uniform(0, 1, (2, NC, a))], 1).astype(np.float32)
    dj, nj, ij = jax_nms(jnp.asarray(pred), conf_thres=0.3, iou_thres=0.45, max_det=200, nc=NC,
                         return_idx=True)
    dt, nt, it = torch_nms(torch.from_numpy(pred), conf_thres=0.3, iou_thres=0.45, max_det=200,
                           nc=NC, return_idx=True)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert it.dtype == torch.int32 and 0 < int(nt.min()) and int(nt.max()) < 200
    assert (it[0, int(nt[0]):] == 0).all()


# ---------------------------------------------------------------- batches

@pytest.fixture(scope="module")
def task_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("tasks")
    return {task: make_task_dataset(root / task, task=task, n_train=6, n_val=3, imgsz=96)
            for task in ("segment", "pose")}


@pytest.mark.parametrize("augment", [False, True], ids=["val", "train"])
@pytest.mark.parametrize("task", ["segment", "pose"])
def test_task_batches_match_jax(task_sets, task, augment):
    """format_batch_task through both loaders, bit for bit: images, boxes,
    classes, and the masks (cv2.fillPoly at a quarter of 64) or keypoints;
    mosaic and the rest of the train transforms when augmented (pose without
    a left-right flip)."""
    kw = dict(batch_size=3, imgsz=64, augment=augment, max_gt=8, seed=2, prefetch=0,
              drop_last=False)
    ds = dict(split="train" if augment else "val", imgsz=64, task=task)
    got = list(DataLoader(YOLODataset(task_sets[task], **ds), **kw))
    want = list(JaxDataLoader(JaxDataset(task_sets[task], **ds), task=task, **kw))
    extra = "gt_masks" if task == "segment" else "gt_kpts"
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) and extra in g
        for k in ("img", "gt_boxes", "gt_cls", "gt_mask", extra, "indices"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert sum(float(b[extra].sum()) for b in got) > 0
    if task == "segment":
        assert got[0][extra].shape[2:] == (16, 16)


# ---------------------------------------------------------------- metrics and Results

def test_task_metrics_match_jax():
    rng = np.random.default_rng(18)
    gm, pm = rng.random((3, 12, 12)) < 0.4, rng.random((5, 12, 12)) < 0.4
    np.testing.assert_allclose(TM.mask_iou_np(gm, pm), JM.mask_iou_np(gm, pm), rtol=1e-12)
    gk = np.concatenate([rng.uniform(0, 64, (3, 17, 2)), rng.integers(0, 3, (3, 17, 1))], -1)
    pk = rng.uniform(0, 64, (5, 17, 3))
    area = rng.uniform(10, 500, 3)
    np.testing.assert_allclose(TM.kpt_oks_np(gk, pk, area), JM.kpt_oks_np(gk, pk, area),
                               rtol=1e-12)
    np.testing.assert_array_equal(TM.OKS_SIGMA_NP, JM.OKS_SIGMA_NP)
    results = []
    for M_ in (TM, JM):
        tm = M_.TaskMetrics(3, {i: str(i) for i in range(3)}, task_key="mask")
        r = np.random.default_rng(19)
        for _ in range(4):
            gt_boxes = np.sort(r.uniform(0, 64, (3, 4)).reshape(3, 2, 2), 1).reshape(3, 4)
            gt_cls = r.integers(0, 3, 3)
            dets = np.concatenate([gt_boxes + r.normal(0, 3, (3, 4)), r.uniform(0, 1, (3, 1)),
                                   gt_cls[:, None]], 1)
            tm.update(dets, gt_boxes, gt_cls)
            tm.update_task(dets, r.uniform(0.3, 1.0, (3, 3)), gt_cls)
        results.append(tm.results())
    got, want = results
    assert set(got) == set(want) and "mask_mAP50-95" in got
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=1e-12, err_msg=k)


def _instance_ops(I, rng):
    """One chain of Bboxes and Instances operations on seeded data: its
    boxes, segments and keypoints after each step."""
    xy = rng.uniform(0, 40, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 20, (5, 2))], 1).astype(np.float32)
    boxes[4, 2:] = boxes[4, :2]  # a zero-area box
    segs = rng.uniform(0, 60, (5, 8, 2)).astype(np.float32)
    kpts = np.concatenate([rng.uniform(0, 60, (5, 17, 2)), rng.integers(0, 3, (5, 17, 1))],
                          -1).astype(np.float32)
    b = I.Bboxes(boxes.copy(), "xyxy").convert("xywh")
    out = [b.bboxes.copy(), b.areas(), b.convert("ltwh").mul((2, 0.5, 2, 0.5)).bboxes.copy(),
           I.Bboxes.concatenate([b, b[1:3]]).bboxes]
    inst = I.Instances(boxes.copy(), segs.copy(), kpts.copy())
    for step in (lambda: inst.scale(1.5, 0.75), lambda: inst.add_padding(3, 5),
                 lambda: inst.fliplr(70), lambda: inst.flipud(50), lambda: inst.clip(64, 48),
                 lambda: inst.normalize(64, 48), lambda: inst.denormalize(64, 48),
                 lambda: inst.convert_bbox("xywh"), lambda: inst.remove_zero_area_boxes()):
        step()
        out += [inst.bboxes.copy(), inst.segments.copy(), inst.keypoints.copy()]
    sub = inst[np.array([0, 2])]
    return out + [sub.bboxes, sub.segments, sub.keypoints, inst.bbox_areas, np.array(len(inst))]


def test_instance_containers_match_jax():
    """utils/instance.py, numpy only in both packages: the same arrays after
    every step of one chain of conversions, scalings, paddings, flips,
    clips and selections."""
    got = _instance_ops(TI, np.random.default_rng(26))
    want = _instance_ops(JI, np.random.default_rng(26))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _results_pair(**data):
    names = {0: "cat", 1: "dog"}
    make = lambda mod: mod.Results(  # noqa: E731
        mod.Boxes(data["boxes"]) if "boxes" in data else None, orig_shape=(40, 50), names=names,
        masks=mod.Masks(data["masks"]) if "masks" in data else None,
        keypoints=mod.Keypoints(data["kpts"]) if "kpts" in data else None,
        probs=mod.Probs(data["probs"]) if "probs" in data else None)
    return make(TP), make(JP)


@pytest.mark.parametrize("kind", ["masks", "keypoints", "probs"])
def test_task_results_match_jax(kind, tmp_path):
    """JSON rows (segments from the masks' contours, keypoints), save_txt and
    verbose of the port's Results equal JAX's on the same data."""
    rng = np.random.default_rng(20)
    boxes = np.array([[2, 3, 20, 30, 0.9, 1], [10, 5, 45, 35, 0.6, 0], [1, 1, 9, 9, 0.3, 1]],
                     np.float64)
    masks = np.zeros((3, 40, 50), bool)
    for j, (x1, y1, x2, y2) in enumerate(boxes[:, :4].astype(int)):
        masks[j, y1:y2, x1:x2] = True
    data = {"masks": dict(boxes=boxes, masks=masks),
            "keypoints": dict(boxes=boxes, kpts=rng.uniform(0, 40, (3, 5, 3))),
            "probs": dict(probs=np.array([0.1, 0.7, 0.05, 0.15]))}[kind]
    got, want = _results_pair(**data)
    assert len(got) == len(want)
    assert json.dumps(got.to_json_dicts()) == json.dumps(want.to_json_dicts())
    assert got.verbose() == want.verbose()
    a, b = tmp_path / "t.txt", tmp_path / "j.txt"
    got.save_txt(a)
    want.save_txt(b)
    assert a.read_text() == b.read_text() and a.read_text()
    canvas = np.zeros((40, 50, 3), np.uint8)
    np.testing.assert_array_equal(got.plot(canvas), want.plot(canvas))


# ---------------------------------------------------------------- mirrored reference behaviours

def _zero_variables(jm, imgsz=64):
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, imgsz, imgsz, 3), jnp.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("name,nc", [("yolov8n-seg.yaml", 80), ("yolo11n-pose.yaml", 1)])
def test_fresh_task_model_has_zero_head_biases_as_jax(name, nc):
    """JAX's `_bias_init` (nn/tasks.py:814) matches `m{head}/cv2_{lvl}_2`,
    which the task heads' `m{head}/detect/cv2_...` leaves never hold, so all
    six box and class output biases stay at flax's zero init; the port's
    fresh model mirrors it. The prior they miss: box 1.0, class
    log(5 / nc / (640 / s)²)."""
    jm = JaxDetectionModel(name, nc=nc)
    flat = flax.traverse_util.flatten_dict(jm._bias_init(_zero_variables(jm)), sep="/")
    head = f"params/m{len(jm.spec.layers) - 1}/detect"
    biases = {k: v for k, v in flat.items() if k.startswith(head) and k.endswith("_2/conv/bias")
              and k.split("/")[-3][:3] in ("cv2", "cv3")}
    assert len(biases) == 6 and all(not np.any(v) for v in biases.values())
    tm = DetectionModel(name, nc=nc, device="cpu")
    det = tm.detect.detect
    for lvl, s in enumerate(tm.strides):
        assert not getattr(det, f"cv2_{lvl}_2").conv.bias.any()
        assert not getattr(det, f"cv3_{lvl}_2").conv.bias.any()
    missed = [abs(np.log(5 / nc / (640 / s) ** 2)) for s in tm.strides]
    print(f"{name}: the prior's box biases 1.0, class biases {missed}")


def test_mask_term_carries_no_gain_as_jax():
    """JAX's segmentation loss adds the mask term times the batch, with no
    gain (losses/extra.py:197); the port mirrors it: the mask item does not
    move with box_gain, and the total is the detection total plus mask x B."""
    batch = {k: torch.as_tensor(v) for k, v in _task_batch(21).items()}
    det = [torch.tensor(a, dtype=torch.float32) for a in _maps(22, 64 + NC)]
    coeffs = [torch.tensor(a, dtype=torch.float32) for a in _maps(23, NM)]
    protos = torch.randn((2, 16, 16, NM), generator=torch.Generator().manual_seed(24))
    runs = {g: TX.segmentation_loss(det, coeffs, protos, batch, STRIDES, NC, box_gain=g)
            for g in (7.5, 1.0)}
    (l75, i75), (l1, i1) = runs[7.5], runs[1.0]
    assert float(i75.mask) == float(i1.mask) > 0
    det_total = (i75.box + i75.cls + i75.dfl) * 2
    torch.testing.assert_close(l75, det_total + i75.mask * 2, rtol=1e-6, atol=0)
    print(f"mask item {float(i75.mask)}; a gain of box 7.5 would add {float(i75.mask) * 6.5 * 2}")


def test_port_results_of_a_seg_predictor_match_jax_build_result():
    """The port makes a frame's masks on the device with bilinear resizes;
    JAX's `build_result` with cv2's INTER_LINEAR on the host. On the same
    kept rows and prototypes, at two letterbox geometries: boxes equal,
    masks within 1e-3 of their pixels."""
    rng = np.random.default_rng(25)
    imgsz, k = 64, 5
    for hw, pad, gain in (((48, 80), (0.0, 12.0), 0.8), ((64, 40), (12.0, 0.0), 1.0)):
        xy = rng.uniform(0, 40, (k, 2))
        dets = np.zeros((1, 8, 6), np.float32)
        dets[0, :k] = np.concatenate([xy, xy + rng.uniform(8, 24, (k, 2)), rng.uniform(0, 1, (k, 1)),
                                      rng.integers(0, 2, (k, 1))], 1)
        num = np.array([k], np.int32)
        kept = rng.normal(0, 1, (1, 8, NM)).astype(np.float32)
        protos = rng.normal(0, 1, (1, 16, 16, NM)).astype(np.float32)
        im = np.zeros((*hw, 3), np.uint8)
        jp = object.__new__(JP.SegmentationPredictor)
        jp.imgsz, jp.model = imgsz, type("M", (), {"names": {0: "0", 1: "1"}})()
        want = jp.build_result((dets, num, kept, protos), 0, im, gain, pad, None)
        tp = TP.SegmentationPredictor.__new__(TP.SegmentationPredictor)
        tp.imgsz, tp.model = imgsz, jp.model
        out = tp._to_host(tuple(torch.from_numpy(a) for a in (dets, num, kept, protos)),
                          [(gain, pad, hw)])
        got = tp.build_result(out, 0, im, gain, pad, None)
        np.testing.assert_array_equal(got.boxes.data, want.boxes.data)
        assert got.masks.data.shape == want.masks.data.shape == (k, *hw)
        assert want.masks.data.sum() > 0
        assert (got.masks.data != want.masks.data).mean() <= 1e-3
