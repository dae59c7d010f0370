"""chip_smoke.py's facade gate on the CPU: `_nms_partings` names the NMS
decisions that part two decodes of an image (a score on either side of
conf, two candidates' order, an IoU on either side of iou), and names none
where NMS decides alike on both decodes, which then keep the same rows;
`_frames_alike` holds each frame's kept rows alike or parted at named
decisions; `_nms_partings_rotated` does the same for the rotated fast-NMS
of two OBB decodes (a best score at conf, a best class, a probiou at iou);
`k1_source_bytes` counts the source rows K1's taps touch; `plain_kernels`
binds the models' kernel call sites to the plain versions and back."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import (_frames_alike, _nms_decisions, _nms_partings, _nms_partings_rotated,
                        k1_source_bytes, plain_kernels)
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
