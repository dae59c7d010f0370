"""chip_smoke.py's facade gate on the CPU: `_nms_partings` names the NMS
decisions that part two decodes of an image (a score on either side of
conf, two candidates' order, an IoU on either side of iou), and names none
where NMS decides alike on both decodes, which then keep the same rows;
`_frames_alike` holds each frame's kept rows alike or parted at named
decisions; `_nms_partings_rotated` does the same for the rotated fast-NMS
of two OBB decodes (a best score at conf, a best class, a probiou at iou);
`k1_source_bytes` counts the source rows K1's taps touch; `plain_kernels`
binds the models' kernel call sites to the plain versions and back.
For the module pools' paths: `_kept_rows_alike` (parity_world,
parity_emac) holds two decodes' kept rows through `_frames_alike`;
`grads_rel` reads a zero gradient on both devices as 0; `model_class`
picks WorldModel; the contrastive bias zeroed gives a seeded world model
candidates; `_float64_grads` runs the trainer's forward (the zero text);
`_world_yolo` scores a world checkpoint with its seeded text;
`zero_grad_leaves` names the leaves a world model's zero-text step leaves
without a gradient (train_world's moved-parameters check leaves them out).
For RT-DETR: the query-selection and matching partings, the rows compared
query by query, the K2 site inputs, `RTDETRRequests`, the pinned
selection and matching, `rtdetr_anchor_boxes` and `_rtdetr_partings`;
`source_of` skips a site where a time was not taken."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import (_float64_grads, _frames_alike, _kept_rows_alike, _nms_decisions,
                        _nms_partings, _nms_partings_rotated, _world_yolo, grads_rel,
                        k1_source_bytes, model_class, plain_kernels, zero_grad_leaves)
from yolo_dbl_tpu_torch import ClassificationModel, DetectionModel, WorldModel
from yolo_dbl_tpu_torch.cfg import get_cfg
from yolo_dbl_tpu_torch.utils.checkpoint import save_deploy

from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_geometry
from yolo_dbl_tpu_torch.losses.extra import probiou
from yolo_dbl_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_rotated

CONF, IOU = 0.001, 0.45


def _decode(seed, nc=3, a=400):
    """A seeded (4+nc, A) decode on a 320 px canvas: boxes of 8-80 px,
    scores spread over [0, 0.05) with many above CONF."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 320, (2, a))
    wh = rng.uniform(8, 80, (2, a))
    scores = rng.uniform(0, 0.05, (nc, a))
    return torch.from_numpy(np.concatenate([xy, wh, scores]).astype(np.float32))


def _next(x, toward):
    return torch.nextafter(torch.tensor(x, dtype=torch.float32),
                           torch.tensor(toward, dtype=torch.float32))


def _kept(pred):
    dets, n = non_max_suppression(pred[None], conf_thres=CONF, iou_thres=IOU)
    return dets[0, : int(n[0])]


def _pair_at_iou():
    """Two boxes of one class (scores 0.9, 0.8) whose float32 IoU in
    ops/boxes.py lies on either side of IOU for two adjacent float32 shifts:
    (decode above, decode at or below)."""
    def decode(dx):
        pred = torch.zeros((5, 2), dtype=torch.float32)
        pred[:, 0] = torch.tensor([100.0, 100.0, 20.0, 20.0, 0.9])
        pred[:, 1] = torch.stack([100.0 + dx, torch.tensor(100.0), torch.tensor(20.0),
                                  torch.tensor(20.0), torch.tensor(0.8)])
        return pred

    def iou(dx):
        b = xywh2xyxy(decode(dx)[:4].T)
        return float(box_iou(b, b)[1, 0])

    lo, hi = torch.tensor(0.0), torch.tensor(20.0)  # iou(lo) > IOU >= iou(hi)
    while _next(float(lo), float(hi)) < hi:
        mid = (lo + hi) / 2
        if mid in (lo, hi):
            mid = _next(float(lo), float(hi))
        lo, hi = (mid, hi) if iou(mid) > IOU else (lo, mid)
    return decode(lo), decode(hi)


def test_equal_decodes_part_nowhere():
    pred = _decode(0)
    assert _nms_partings(pred, pred.clone(), CONF, IOU) == {}


@pytest.mark.parametrize("seed", range(4))
def test_same_decisions_keep_the_same_rows(seed):
    """Boxes a float32 rounding apart and the same scores: where no IoU
    crosses IOU, NMS keeps the same (anchor, class) rows, with boxes as
    close as the decodes'."""
    card = _decode(seed)
    noise = np.random.default_rng(100 + seed).normal(0, 1e-6, (4, card.shape[1]))
    cpu = card.clone()
    cpu[:4] *= 1 + torch.from_numpy(noise.astype(np.float32))
    assert _nms_partings(card, cpu, CONF, IOU) == {}
    a, b = _kept(card), _kept(cpu)
    assert len(a) == len(b) > 0
    assert torch.equal(a[:, 4:], b[:, 4:])
    assert float((a[:, :4] - b[:, :4]).abs().max()) < 1e-3


def test_a_score_at_conf_is_named():
    card = _decode(1)
    cpu = card.clone()
    card[4, 7] = torch.tensor(CONF, dtype=torch.float32)
    cpu[4, 7] = _next(CONF, 1.0)
    parting = _nms_partings(card, cpu, CONF, IOU)["score > conf"]
    assert parting["count"] == 1
    assert parting["card"] == float(card[4, 7]) < parting["cpu"] == float(cpu[4, 7])


def test_two_candidates_order_is_named():
    card = _decode(2)
    s = 0.04
    card[4, 3], card[4, 9] = s, _next(s, 1.0)
    cpu = card.clone()
    cpu[4, 3], cpu[4, 9] = card[4, 9], card[4, 3]
    parting = _nms_partings(card, cpu, CONF, IOU)
    assert list(parting) == ["candidate order"]
    assert parting["candidate order"]["card"] == parting["candidate order"]["cpu"][::-1]


def test_an_iou_at_iou_thres_is_named_and_parts_the_kept_rows():
    above, below = _pair_at_iou()
    assert len(_kept(above)) == 1 and len(_kept(below)) == 2
    parting = _nms_partings(above, below, CONF, IOU)
    assert list(parting) == ["iou > iou_thres"]
    assert parting["iou > iou_thres"]["cpu"] <= IOU < parting["iou > iou_thres"]["card"]
    flat, idx, boxes = _nms_decisions(above, CONF)
    assert idx.tolist() == [0, 1] and boxes.shape == (2, 4)


def test_frames_alike_holds_rows_and_names_partings():
    """One frame whose rows differ by a float32 rounding is alike; one whose
    decodes part at an IoU on iou_thres is parted, with that decision named;
    a frame that parts where the decodes do not is parted and unnamed."""
    same = _decode(3)
    rows = _kept(same)
    near = rows.clone()
    near[:, :4] = near[:, :4] * (1 + 1e-7)
    above, below = _pair_at_iou()
    gate, named = _frames_alike([rows, _kept(above)], [near, _kept(below)],
                                [same, above], [same, below], CONF, IOU)
    assert gate["frames_parted"] == [1] and named
    assert gate["partings"][0] == {} and list(gate["partings"][1]) == ["iou > iou_thres"]
    assert 0 < gate["box_max_abs_px"] < 1e-3 and gate["score_max_abs"] == 0
    assert gate["classes_equal"]
    gate, named = _frames_alike([rows[1:]], [rows], [same], [same], CONF, IOU)
    assert gate["frames_parted"] == [0] and not named


@pytest.mark.parametrize("canvas, new_h, rows", [(640, 427, 512), (224, 149, 298)])
def test_k1_source_bytes_counts_the_tapped_rows(canvas, new_h, rows):
    """512x768 frames: at 640 every source row is tapped; at 224 each of the
    149 output rows taps two rows of its own (298 of 512)."""
    assert letterbox_geometry(512, 768, canvas, canvas, scaleup=False)[1] == new_h
    assert k1_source_bytes(8, (512, 768), new_h) == 8 * rows * 768 * 3


def test_plain_kernels_binds_the_plain_versions_and_restores():
    """Inside, a float64 sample through ops/resample.py is the plain
    version's; after, the call sites are the kernel wrappers again."""
    from yolo_dbl_tpu_torch.kernels import attention, sampling
    from yolo_dbl_tpu_torch.nn import blocks
    from yolo_dbl_tpu_torch.ops import resample

    wrappers = resample.sample_bilinear, blocks.area_attention
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, 4, 5, 8)))
    gy, gx = (torch.from_numpy(rng.uniform(-1, 5, (1, 6, 2))) for _ in range(2))
    with plain_kernels():
        assert resample.sample_bilinear is sampling.sample_bilinear_plain
        assert blocks.area_attention is attention.area_attention_plain
        got = resample.sample_bilinear_pixel(x, gy, gx, groups=2)
    assert (resample.sample_bilinear, blocks.area_attention) == wrappers
    assert torch.equal(got, resample.sample_bilinear_pixel(x, gy, gx, groups=2))


# ---------------------------------------------------------------- the rotated NMS's partings

def _obb_decode(seed, nc=3, a=300):
    """A seeded OBB decode (4+nc+1, A) on a 320 px canvas: rotated boxes of
    8-60 px, scores in [0, 0.6), angles in [-π/4, 3π/4)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.concatenate([
        rng.uniform(0, 320, (2, a)), rng.uniform(8, 60, (2, a)), rng.uniform(0, 0.6, (nc, a)),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (1, a))]).astype(np.float32))


def _kept_rotated(pred, conf=0.25):
    dets, n = non_max_suppression_rotated(pred[None], conf_thres=conf, iou_thres=IOU)
    return dets[0, : int(n[0])]


def _pair_at_probiou():
    """Two rotated boxes of one class (scores 0.9, 0.8) whose float32 probiou
    lies on either side of IOU for two adjacent float32 shifts: (decode at
    or above, decode below)."""
    def decode(dx):
        pred = torch.zeros((4 + 3 + 1, 2), dtype=torch.float32)
        pred[:, 0] = torch.tensor([100.0, 100.0, 30.0, 12.0, 0.9, 0.0, 0.0, 0.3])
        pred[:, 1] = torch.stack([100.0 + dx, *torch.tensor([100.0, 30.0, 12.0, 0.8, 0.0, 0.0,
                                                             0.3])])
        return pred

    def piou(dx):
        rb = torch.cat([decode(dx)[:4], decode(dx)[-1:]]).T
        return float(probiou(rb[0], rb[1]))

    lo, hi = torch.tensor(0.0), torch.tensor(30.0)  # piou(lo) >= IOU > piou(hi)
    while _next(float(lo), float(hi)) < hi:
        mid = (lo + hi) / 2
        if mid in (lo, hi):
            mid = _next(float(lo), float(hi))
        lo, hi = (mid, hi) if piou(mid) >= IOU else (lo, mid)
    return decode(lo), decode(hi)


def test_rotated_decodes_alike_part_nowhere():
    pred = _obb_decode(4)
    assert _nms_partings_rotated(pred, pred.clone(), 0.25, IOU) == {}
    rows = _kept_rotated(pred)
    gate, named = _frames_alike([rows], [rows.clone()], [pred], [pred], 0.25, IOU)
    assert len(rows) > 5 and gate["frames_parted"] == [] and named
    assert gate["angle_max_abs"] == 0 and gate["classes_equal"]


def test_a_probiou_at_iou_thres_is_named_and_parts_the_rotated_rows():
    """The rotated fast-NMS keeps one row of the pair at probiou >= iou and
    two below; `_nms_partings_rotated` names that probiou with both values,
    and `_frames_alike` parts the frame at it. A flipped best class and a
    best score across conf are named too; an angle 1e-3 apart parts a frame
    unnamed where the decodes decide alike."""
    above, below = _pair_at_probiou()
    assert len(_kept_rotated(above)) == 1 and len(_kept_rotated(below)) == 2
    parting = _nms_partings_rotated(above, below, 0.25, IOU)
    assert list(parting) == ["probiou >= iou_thres"]
    assert parting["probiou >= iou_thres"]["cpu"] < IOU <= parting["probiou >= iou_thres"]["card"]
    gate, named = _frames_alike([_kept_rotated(above)], [_kept_rotated(below)], [above], [below],
                                0.25, IOU)
    assert gate["frames_parted"] == [0] and named
    flipped = below.clone()
    flipped[5, 1] = 0.85  # class 1 now beats class 0 at the second anchor
    flipped[4, 0] = _next(0.25, 0.0)  # the first anchor's best score just under conf
    named_kinds = _nms_partings_rotated(below, flipped, 0.25, IOU)
    assert {"best class", "score >= conf"} <= set(named_kinds)
    rows = _kept_rotated(below)
    turned = rows.clone()
    turned[:, 4] += 1e-3
    gate, named = _frames_alike([turned], [rows], [below], [below], 0.25, IOU)
    assert gate["frames_parted"] == [0] and not named


# ---------------------------------------------------------------- the module pools' paths

def _world(nc=3):
    return WorldModel("yolov8n-worldv2.yaml", nc=nc, device="cpu",
                      generator=torch.Generator().manual_seed(0))


def test_kept_rows_alike_holds_decodes_and_names_a_parting():
    """parity_world's and parity_emac's rows: two equal decodes keep alike
    rows; a score moved across conf 0.25 parts the frame, and is named."""
    pred = torch.stack([_decode(5, a=300), _decode(6, a=300)])
    pred[:, 4:] *= 20  # scores over [0, 1)
    rows, named = _kept_rows_alike(pred, pred.clone(), 3)
    assert named and rows["frames_parted"] == [] and sum(rows["kept_cpu"]) > 0
    assert rows["box_max_abs_px"] == rows["score_max_abs"] == 0 and rows["classes_equal"]
    moved = pred.clone()
    j = int(moved[1, 4:].amax(0).argmax())
    moved[1, 4:, j] = 0.2499  # the frame's best candidate falls under conf
    rows, named = _kept_rows_alike(moved, pred, 3)
    assert rows["frames_parted"] == [1] and named and "score > conf" in rows["partings"][1]


def test_grads_rel_reads_zero_gradients_on_both_devices_as_zero():
    zero, g = torch.zeros(3), torch.tensor([1.0, -2.0, 0.5])
    rel = grads_rel({"a": zero, "b": g * (1 + 1e-5), "c": g * 0},
                    {"a": zero, "b": g, "c": zero + 1e-3}, ["a", "b", "c"])
    assert rel["a"] == 0 and rel["b"] == pytest.approx(1e-5, rel=1e-2) and rel["c"] == 1.0
    assert grads_rel({"a": g}, {"a": zero}, ["a"])["a"] > 1e29


def test_model_class_picks_the_world_and_classify_models():
    assert model_class("yolov8s-worldv2.yaml") is WorldModel
    assert model_class("yolo11s-cls.yaml") is ClassificationModel
    assert model_class("YOLO-EMAC.yaml") is model_class("yolov8n.yaml") is DetectionModel


def test_zeroed_contrastive_bias_gives_a_seeded_world_model_candidates():
    """At its init every world logit is the contrastive bias -10 plus a
    similarity: NMS at conf 0.25 keeps nothing; with the bias 0 it keeps rows."""
    model = _world()
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    _, num = non_max_suppression(model.predict(x), conf_thres=0.25, iou_thres=0.45, nc=3)
    assert int(num.max()) == 0
    model.zero_class_biases()
    assert all(float(getattr(model.detect, f"cv4_{i}").bias) == 0 for i in range(3))
    _, num = non_max_suppression(model.predict(x), conf_thres=0.25, iou_thres=0.45, nc=3)
    assert int(num.min()) > 0


def _batch(seed=2, b=2):
    rng = np.random.default_rng(seed)
    return {"img": rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8),
            "gt_boxes": np.tile(np.array([[[0.5, 0.5, 0.3, 0.3]]], np.float32), (b, 2, 1)),
            "gt_cls": np.zeros((b, 2), np.int32), "gt_mask": np.ones((b, 2), np.float32)}


def test_zero_grad_leaves_of_a_world_step_are_its_class_embedding_branch():
    """On the zero text every cv3_* leaf, the contrastive heads' scale and
    norm and the guide Dense kernels get no gradient; the contrastive bias
    and the box branch do. A plain Detect model's class branch has a
    gradient everywhere."""
    model = _world()
    dead = zero_grad_leaves(model, get_cfg(), _batch())
    head = f"m{model.spec.layers[-1].i}."
    names = [n for n, _ in model.named_parameters()]
    assert {n for n in names if n.startswith(head + "cv3_") or n.endswith("attn.gl.weight")
            or (n.startswith(head + "cv4_") and not n.endswith(("_0.bias", "_1.bias", "_2.bias")))
            } <= dead
    assert not dead & {f"{head}cv4_0.bias", f"{head}cv2_0_2.conv.weight", "m0.conv.weight"}
    plain = DetectionModel("yolov8n.yaml", nc=3, device="cpu")
    head = f"m{plain.spec.layers[-1].i}."
    # at 64 px no target is assigned to the P5 level: its box branch alone has no gradient
    assert {n[len(head):].split(".")[0] for n in zero_grad_leaves(plain, get_cfg(), _batch())} \
        <= {"cv2_2_0", "cv2_2_1", "cv2_2_2"}


def test_float64_grads_run_the_trainer_forward_on_the_zero_text():
    """train_parity's float64 reference of a world model does not read its
    `txt_feats`, as the trainer's step does not."""
    model = _world()
    batch = _batch()
    first, _ = _float64_grads(model, get_cfg(), batch, grads=False)
    model.txt_feats = torch.randn(1, 3, 512)
    again, _ = _float64_grads(model, get_cfg(), batch, grads=False)
    assert first == again and first["box"] > 0


def test_world_yolo_scores_a_world_checkpoint_with_its_text(tmp_path):
    """A world checkpoint reloads as a plain DetectionModel, one score at
    every anchor (the zero text); `_world_yolo` puts its weights in a
    WorldModel with the seeded text and the contrastive bias 0."""
    from yolo_dbl_tpu_torch.engine.model import YOLO

    model = _world(nc=2)
    path = tmp_path / "best.ckpt"
    params = dict(model.named_parameters())
    save_deploy(path, {"params": params, "batch_stats": {
        k: v for k, v in model.state_dict().items() if k not in params}},
                model_yaml=model.yaml, nc=2)
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    plain = YOLO(str(path), device="cpu").model
    assert type(plain) is DetectionModel
    scores = plain.predict(x)[:, 4:]
    assert float(scores.max() - scores.min()) == 0
    world = _world_yolo(str(path), device="cpu").model
    assert isinstance(world, WorldModel) and torch.equal(world.txt_feats, model.txt_feats)
    scores = world.predict(x)[:, 4:]
    assert float(scores.max() - scores.min()) > 0


# ---------------------------------------------------------------- RT-DETR's checks

def _selection(best, nq):
    """(selected (B, nq), best (B, S)) as the decoder's `select_queries`
    records them."""
    from yolo_dbl_tpu_torch.models.rtdetr import sort_descending

    return sort_descending(best, 1)[1][:, :nq], best


def test_selection_partings_name_near_ties_in_order_and_at_the_kth_query():
    """Two devices' top-3 of 6 tokens part where scores sit within float32
    rounding of each other: a swap of the 1st and 2nd, and the 3rd kept on
    one side only; each rank is named with both tokens' scores on both
    devices, and is a near-tie. Equal scores part nowhere; where any
    token's scores part by more than 1e-3, no parting is a near-tie."""
    from chip_smoke import _selection_partings

    best = torch.tensor([[0.9, 0.2, 0.5000001, 0.9000001, 0.5, 0.1]])
    other = best.clone()
    other[0, 2], other[0, 4], other[0, 3] = 0.4999999, 0.5000002, 0.8999999
    assert _selection_partings(_selection(best, 3), _selection(best.clone(), 3)) == ([], True)
    parts, near = _selection_partings(_selection(best, 3), _selection(other, 3))
    assert near and [(p["rank"], p["token_card"], p["token_cpu"]) for p in parts] == \
        [(0, 3, 0), (1, 0, 3), (2, 2, 4)]
    assert parts[2]["scores_card"] == pytest.approx([0.5000001, 0.5])
    far = other.clone()
    far[0, 5] = 0.1011  # an unselected token moved past the score bar
    assert not _selection_partings(_selection(best, 3), _selection(far, 3))[1]


def test_rtdetr_rows_alike_compare_the_final_layer_query_by_query():
    """Boxes in pixels of the canvas (xyxy), sigmoid scores and each query's
    best class, from the last decoder layer only."""
    from chip_smoke import _rtdetr_rows_alike

    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(rng.uniform(0.2, 0.6, (2, 3, 7, 4)).astype(np.float32))
    scores = torch.from_numpy(rng.normal(0, 1, (2, 3, 7, 5)).astype(np.float32))
    moved_b, moved_s = boxes.clone(), scores.clone()
    moved_b[1, -1, 4, 0] += 1e-4  # the centre x: both x corners move
    moved_s[0, 0] += 3.0  # an earlier layer: not compared
    out = _rtdetr_rows_alike((moved_b, moved_s), (boxes, scores), 640)
    assert out["box_max_abs_px"] == pytest.approx(0.064, rel=1e-2)
    assert out["score_max_abs"] == 0 and out["classes_equal"]
    moved_s[1, -1, 2, :] = scores[1, -1, 2].flip(0)
    assert not _rtdetr_rows_alike((boxes, moved_s), (boxes, scores), 640)["classes_equal"]


def test_matching_partings_count_differing_matchings_and_hold_them_to_near_ties():
    """A matching whose assignments part where the two devices' costs moved
    by d is a named near-tie when the CPU's assignment costs at most 2 k d
    more on the card's costs; one that costs more than that is not."""
    from chip_smoke import _matching_partings

    cost = torch.tensor([[[1.0, 5.0], [5.0, 1.0], [1.001, 5.0]],
                         [[1.0, 5.0], [5.0, 1.0], [3.0, 3.0]]])
    counts = torch.tensor([2, 2])
    own = torch.tensor([[0, 1], [0, 1]])
    card = (own, cost, counts)
    assert _matching_partings(card, (own.clone(), cost, counts)) == ([], True)
    moved = cost.clone()
    moved[0, 0, 0] = 1.002  # the CPU's costs: row 2 is now its optimum for GT 0
    parts, near = _matching_partings(card, (torch.tensor([[2, 1], [0, 1]]), moved, counts))
    assert near and [p["matching"] for p in parts] == [0]
    assert parts[0]["cpu_cost"] - parts[0]["own_cost"] == pytest.approx(0.001, abs=1e-6)
    parts, near = _matching_partings(card, (torch.tensor([[2, 1], [2, 1]]), moved, counts))
    assert not near and len(parts) == 2 and parts[1]["cpu_cost"] - parts[1]["own_cost"] == 2.0


def test_k2_point_site_inputs_count_taps_and_match_grid_sample():
    """MSDeformAttn's K2 site inputs: `_point_taps` counts the points with no
    tap on the map and the bytes the in-map taps need (each pixel's group
    once); F.grid_sample with zeros padding on `_grid_layout`'s planes and
    grid equals the plain sampler in zeros mode, points off the map too."""
    import torch.nn.functional as F

    from chip_smoke import _grid_layout, _point_taps
    from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear_plain

    x = torch.randn((2, 5, 6, 8), generator=torch.Generator().manual_seed(6))
    gy = torch.tensor([[[0.0, 0.5], [-3.0, 1.5], [4.0, 10.0]]] * 2)  # (B, N=3, G=2)
    gx = torch.tensor([[[0.0, 0.5], [2.0, -1.5], [5.0, 2.0]]] * 2)
    off, n_bytes = _point_taps(x, gy, gx)
    # no tap on the map: (y, x) = (-3, 2) and (10, 2), and (1.5, -1.5), whose x taps are
    # -2 and -1: 3 of an image's 6 points
    assert off == pytest.approx(3 / 6)
    # pixels the in-map taps touch an image: group 0 the 2x2 at (0, 0) and (4, 5) alone,
    # group 1 the 2x2 at (0, 0); 4 values a group, 4 bytes a value
    assert n_bytes == 2 * (5 + 4) * 4 * 4
    gy = torch.from_numpy(np.random.default_rng(7).uniform(-2, 6, (2, 9, 2)).astype(np.float32))
    gx = torch.from_numpy(np.random.default_rng(8).uniform(-2, 7, (2, 9, 2)).astype(np.float32))
    planes, grid = _grid_layout([x], gy, gx)
    lib = F.grid_sample(planes[0], grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    lib = lib.reshape(2, 2, 4, 9).permute(0, 3, 1, 2).reshape(2, 9, 8)
    assert torch.allclose(lib, sample_bilinear_plain(x, gy, gx, "zeros"), atol=1e-6)


@pytest.fixture(scope="module")
def rtdetr():
    """RT-DETR-l (nc=80) on the CPU, seeded."""
    return DetectionModel("rtdetr-l.yaml", nc=80, device="cpu",
                          generator=torch.Generator().manual_seed(0))


def test_rtdetr_requests_serve_rows_above_conf_in_frame_pixels(rtdetr):
    """`RTDETRRequests`: K1's letterbox, `predict`'s sorted rows, those above
    conf, rescaled to each frame and clipped: the rows `rtdetr_postprocess`
    gives on the letterboxed canvas, mapped back."""
    from chip_smoke import RTDETRRequests
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    frames = np.random.default_rng(9).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    rows = RTDETRRequests(rtdetr, conf=0.25, imgsz=64)(frames)
    dets = rtdetr.predict(letterbox_normalize(torch.from_numpy(frames), (64, 64), scaleup=False))
    gain, _, _, top, left = letterbox_geometry(48, 80, 64, 64, scaleup=False)
    for r, d in zip(rows, dets.numpy()):
        keep = d[d[:, 4] > 0.25]
        assert r.shape == keep.shape and len(r) > 0
        want = (keep[:, [0, 2]] - left) / gain
        assert np.allclose(r[:, [0, 2]], want.clip(0, 80), atol=1e-4)
        assert np.allclose(r[:, [1, 3]], ((keep[:, [1, 3]] - top) / gain).clip(0, 48), atol=1e-4)
        assert np.array_equal(r[:, 4:], keep[:, 4:])


def test_pinned_queries_and_matching_record_and_force(rtdetr):
    """Inside `pinned_queries(forced)` the decoder takes the forced tokens
    and records its own; inside `pinned_matching(forced)` the loss takes
    the forced matching and records its own with the costs; after, both
    are the port's own again."""
    from chip_smoke import pinned_matching, pinned_queries
    from yolo_dbl_tpu_torch.engine.trainer import train_loss
    from yolo_dbl_tpu_torch.losses import detr
    from yolo_dbl_tpu_torch.models.rtdetr import RTDETRDecoder

    own = RTDETRDecoder.select_queries, detr.assign
    rng = np.random.default_rng(10)
    batch = {"img": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)),
             "gt_boxes": torch.from_numpy(rng.uniform(0.3, 0.6, (2, 3, 4)).astype(np.float32)),
             "gt_cls": torch.from_numpy(rng.integers(0, 80, (2, 3))),
             "gt_mask": torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]])}
    with pinned_queries() as sq, pinned_matching() as sm:
        loss, _ = train_loss(rtdetr, get_cfg(), batch)
    (sel, best), (idx, cost, counts) = sq[0], sm[0]
    assert sel.shape == (2, 84) and best.shape == (2, 84) and cost.shape == (14, 84, 3)
    assert counts.tolist() == [2] * 7 + [3] * 7
    flipped = sel.flip(1)
    forced = torch.zeros_like(idx)
    with pinned_queries(flipped) as sq2, pinned_matching(forced) as sm2:
        loss2, _ = train_loss(rtdetr, get_cfg(), batch)
    assert torch.equal(sq2[0][0], sel) and float(loss2.detach()) != float(loss.detach())
    assert (RTDETRDecoder.select_queries, detr.assign) == own
    # the flipped order with its own matching: the loss is the unpinned one
    with pinned_queries(flipped), pinned_matching(sm2[0][0]):
        again, _ = train_loss(rtdetr, get_cfg(), batch)
    assert float(again.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)


def test_rtdetr_anchor_boxes_start_each_layer_at_its_anchor(rtdetr):
    """`rtdetr_anchor_boxes` zeroes the final Dense of the encoder's and each
    decoder layer's box head: every decoder layer's box is then the
    selected query's anchor box, the encoder's."""
    import copy

    from chip_smoke import rtdetr_anchor_boxes
    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize

    model = copy.deepcopy(rtdetr)
    rtdetr_anchor_boxes(model)
    dec = model.detect
    for head in (dec.enc_bbox_head, *(getattr(dec, f"dec_bbox_head_{i}") for i in range(6))):
        assert not head.layers_2.weight.any() and not head.layers_2.bias.any()
    assert dec.dec_bbox_head_0.layers_1.weight.any()  # the inner layers keep their weights
    img = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (1, 64, 64, 3),
                                                               dtype=np.uint8))
    with torch.no_grad():
        dec_bboxes, _, enc_bboxes, _ = model.eval()(device_normalize(img, torch.float32))
    assert torch.allclose(dec_bboxes, enc_bboxes[:, None].expand_as(dec_bboxes), atol=1e-6)


def test_rtdetr_partings_pack_the_card_records():
    """`_rtdetr_partings` reads the card's own selection and matchings
    against the CPU's: the count of matchings, those that differ, and
    whether each parting is a near-tie."""
    from chip_smoke import _rtdetr_partings

    best = torch.tensor([[0.9, 0.8, 0.7, 0.1]])
    cpu_sel = (torch.tensor([[0, 1, 2]]), best)
    cost = torch.tensor([[[0.0, 5.0], [5.0, 0.0], [3.0, 3.0]]] * 2)
    counts = torch.tensor([2, 2])
    cpu_match = (torch.tensor([[0, 1], [0, 1]]), cost, counts)
    extra, near = _rtdetr_partings(cpu_sel, cpu_match, (cpu_sel, cpu_match))
    assert near and extra["matchings"] == 2 and extra["matchings_differing"] == 0
    assert extra["selection_partings"] == [] and extra["matching_partings"] == []
    # matching 1's costs 0.1 apart between the devices: the card's (1, 0) costs 0
    # on its costs, the CPU's (0, 1) 10.1, past 2 k d = 0.4: no near-tie
    cost[1, :2] = torch.tensor([[5.0, 0.0], [0.0, 5.0]])
    card_cost = cost.clone()
    card_cost[1, 0, 0] = 5.1
    card_match = (torch.tensor([[0, 1], [1, 0]]), card_cost, counts)
    extra, near = _rtdetr_partings(cpu_sel, card_match, (cpu_sel, cpu_match))
    assert extra["matchings_differing"] == 1 and not near


def test_source_of_reads_untimed_sites_as_absent():
    """A time summed over sites where one was not taken (None) keeps the
    source of the sites that took it."""
    from chip_smoke import source_of

    assert source_of("profiler", None) == "profiler"
    assert source_of("profiler", "cuda_event", None) == "cuda_event"
    assert source_of("profiler", "profiler") == "profiler"


# ---------------------------------------------------------------- the module catalogue

SCORE_ENTRIES = ("MHSA", "BoTAttention", "HiLo", "NonLocalBlock2D", "DeBiAttention_YOLO")


@pytest.mark.parametrize("name", SCORE_ENTRIES)
def test_catalogue_score_bytes_reckon_the_softmax_inputs(name, monkeypatch):
    """`catalogue_score_bytes` at a 14x14 input against the softmax inputs
    the port's module really forms: 2 copies of the largest (its scores and
    their softmax), 3 for BoTAttention (q·k, q·pos, their sum) and for
    BiFormer's dense masked scores (the scores, the masked copy, the
    softmax)."""
    from chip_smoke import _catalogue_module, catalogue_score_bytes

    shape = (1, 14, 14, 64)
    module = _catalogue_module("attention", name, shape, "cpu")
    seen, softmax = [], torch.softmax
    monkeypatch.setattr(torch, "softmax", lambda t, dim: seen.append(t.numel()) or softmax(t, dim))
    with torch.no_grad():
        module(torch.zeros(1, 64, 14, 14))
    if name == "DeBiAttention_YOLO":  # DAttention's softmax, then BiFormer's
        want = max(2 * 4 * seen[0], 3 * 4 * seen[1])
    else:
        want = (3 if name == "BoTAttention" else 2) * 4 * max(seen)
    assert catalogue_score_bytes(name, shape) == want


def test_catalogue_plan_times_the_four_global_attentions_at_the_quick_shape():
    """On an 80 GB card (85,520,809,984 bytes, the H100's) the reckoning
    sends MHSA, BoTAttention, HiLo and DeBiAttention_YOLO to 1x64x64x64
    (137-1,649 GB at the reference shape) and keeps NonLocalBlock2D's 34 GB
    and every other entry at the reference shapes; 9 + 26 entries."""
    from chip_smoke import catalogue_plan

    plan = catalogue_plan(85_520_809_984)
    assert [kind for kind, *_ in plan] == ["upsample"] * 9 + ["attention"] * 26
    quick = {name for _, name, shape, _ in plan if shape == (1, 64, 64, 64)}
    assert quick == {"MHSA", "BoTAttention", "HiLo", "DeBiAttention_YOLO"}
    need = {name: n for _, name, _, n in plan}
    assert need["MHSA"] == 2 * 4 * 4 * 65536 ** 2 * 4
    assert need["NonLocalBlock2D"] == 2 * 4 * 65536 * 16384 * 4 < 40e9
    assert {shape for _, name, shape, _ in plan if name not in quick} == \
        {(2, 64, 64, 64), (4, 256, 256, 64)}


def test_dattention_sites_are_the_modules_sampler_inputs():
    """`dattention_sites` hands K2 what DeBiAttention_YOLO's DAttention
    samples: the plain sampler at its coordinates (border) is the module's
    own grid sample, F.grid_sample (border) on `_grid_layout` agrees, the
    points lie on the map's clipped range, and the offsets move them off
    the regular grid."""
    from chip_smoke import _grid_layout, dattention_sites

    from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear_plain
    from yolo_dbl_tpu_torch.nn.attention.bigarch import DeBiAttention_YOLO
    from yolo_dbl_tpu_torch.ops.resample import grid_sample_bilinear
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    (x, gy, gx), = dattention_sites("cpu", {"s": (2, 16, 20, 64)}).values()
    assert x.shape == (2, 16, 20, 64) and gy.shape == gx.shape == (2, 80, 2)
    deform = bm.prepare(DeBiAttention_YOLO(64, 64, num_heads=4), "cpu").attn.deform
    with torch.no_grad():
        grid = deform.grid(deform.proj_q(x.permute(0, 3, 1, 2)))
        want = grid_sample_bilinear(x, grid).reshape(2, 80, 64)
    got = sample_bilinear_plain(x, gy, gx, "border")
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    planes, g = _grid_layout([x], gy, gx)
    lib = torch.nn.functional.grid_sample(planes[0], g, padding_mode="border",
                                          align_corners=False)
    torch.testing.assert_close(lib.reshape(2, 2, 32, 80).permute(0, 3, 1, 2).reshape(2, 80, 64),
                               got, atol=1e-5, rtol=0)
    assert float(gy.min()) >= -0.5 and float(gy.max()) <= 15.5 and float(gx.max()) <= 19.5
    regular = (torch.arange(8.0) * 2 + 0.5).view(1, 8, 1, 1)
    assert float((gy.reshape(2, 8, 10, 2) - regular).abs().max()) > 0.05


def test_recording_sampler_and_pinned_cells_record_pin_and_restore():
    """`recording_sampler` yields detached copies of K2's calls (all, or the
    first n) and leaves the output alone; `pinned_cells` records each
    call's cells, and with a forced record moves a tap into its forced
    cell by less than a pixel, its gradient kept, counting the moves; a
    record of the same run moves nothing. After, the sampler is the
    port's own again."""
    from chip_smoke import pinned_cells, recording_sampler
    from yolo_dbl_tpu_torch.nn.tasks import init_flax_defaults
    from yolo_dbl_tpu_torch.nn.upsample.batch3 import LDA_AQU
    from yolo_dbl_tpu_torch.ops import resample

    own = resample.sample_bilinear
    module = LDA_AQU(16)
    init_flax_defaults(module, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 6, 8),
                                                                  dtype=np.float32))
    y = module(x)
    with recording_sampler() as calls:
        assert torch.equal(module(x), y)
    assert [c[0].shape[-1] for c in calls] == [4, 16] and {c[3] for c in calls} == {"border"}
    assert calls[0][1].shape == (2, 12 * 16 * 9, 2) and not calls[0][1].requires_grad
    assert torch.equal(calls[0][1], calls[1][1])  # keys and input at the same taps
    with recording_sampler(first=1) as first:
        module(x)
    assert len(first) == 1 and torch.equal(first[0][2], calls[0][2])
    with pinned_cells() as seen:
        module(x)
    with pinned_cells(seen) as same:
        assert torch.equal(module(x), y)
    assert [m for _, m, _ in same] == [0, 0]
    (fy, fx), _, _ = seen[0]
    shifted = [((fy + 1, fx), 0, 0.0), seen[1]]
    with pinned_cells(shifted) as moved:
        out = module(x)
    assert moved[0][1] == fy.numel() and 0 < moved[0][2] <= 1 and moved[1][1] == 0
    assert not torch.equal(out, y)
    grad = torch.autograd.grad(out.square().sum(), module.off_pw.conv.weight)[0]
    assert grad.abs().max() > 0
    assert resample.sample_bilinear is own
