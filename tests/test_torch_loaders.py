"""The port's host-side loaders, native loader and `Results` against the JAX package.

Every comparison is bit for bit:
- data/rect.py: `multi_scale_sizes`, `rect_group_indices`, `resize_batch`;
- data/loaders.py: a directory of JPEG and PNG images, a video written by
  cv2.VideoWriter (skipped only where no codec writes one), `LoadPilAndNumpy`,
  `LoadTensor` (a torch tensor on the port's side, an array on JAX's) and
  `load_inference_source`'s choice of loader;
- the native loader (a copy of the JAX package's C++ source, built apart):
  `decode_file`, `letterbox_u8` and the pool's `decode_letterbox_batch`; it
  must have built here, so these tests take the native lane;
- `DataLoader`'s native val lane against JAX's native lane; against the
  port's own Python lane it holds JAX's own bars for that comparison
  (tests/test_native_loader.py: boxes within 1.5 px, mean pixel difference
  below 4);
- `Boxes` and `Results`: `to_json_dicts`, `verbose`, `save_txt`,
  `save_crop` and the pixels of `plot`.
"""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from yolo_dbl_tpu.data import loaders as JL
from yolo_dbl_tpu.data import rect as JR
from yolo_dbl_tpu.data.build import DataLoader as JaxDataLoader
from yolo_dbl_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_dbl_tpu.engine import predictor as JP
from yolo_dbl_tpu.native import loader as jax_native

from yolo_dbl_tpu_torch.data import loaders as TL
from yolo_dbl_tpu_torch.data import rect as TR
from yolo_dbl_tpu_torch.data.build import DataLoader
from yolo_dbl_tpu_torch.data.dataset import YOLODataset
from yolo_dbl_tpu_torch.engine import predictor as TP
from yolo_dbl_tpu_torch.native import loader as native

from tests.fixtures import make_shapes_dataset


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# ------------------------------------------------------------------- rect


@pytest.mark.parametrize("imgsz,stride,n", [(640, 32, 5), (160, 32, 5), (320, 64, 3), (96, 16, 7)])
def test_multi_scale_sizes_match_jax(imgsz, stride, n):
    assert TR.multi_scale_sizes(imgsz, stride, n_buckets=n) == JR.multi_scale_sizes(
        imgsz, stride, n_buckets=n)
    rng_t, rng_j = np.random.default_rng(1), np.random.default_rng(1)
    sizes = TR.multi_scale_sizes(imgsz, stride)
    assert [TR.sample_scale(sizes, rng_t) for _ in range(20)] == [
        JR.sample_scale(sizes, rng_j) for _ in range(20)]


@pytest.mark.parametrize("seed", [0, 1])
def test_rect_group_indices_match_jax(seed):
    ars = np.random.default_rng(seed).uniform(0.4, 2.5, 37)
    assert TR.rect_group_indices(ars, 640, 8) == JR.rect_group_indices(ars, 640, 8)
    assert TR.rect_shapes(ars, 320, 32, 3) == JR.rect_shapes(ars, 320, 32, 3)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_batch_matches_jax(dtype):
    img = np.random.default_rng(2).uniform(0, 255, (3, 64, 64, 3)).astype(dtype)
    for size in (32, 64, 96):
        np.testing.assert_array_equal(TR.resize_batch(img, size), JR.resize_batch(img, size))


# ---------------------------------------------------------------- loaders


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    cv2.imwrite(str(d / "a.jpg"), _image(50, 70, 1))
    cv2.imwrite(str(d / "b.png"), _image(33, 41, 2))
    cv2.imwrite(str(d / "c.bmp"), _image(20, 30, 3))
    (d / "notes.txt").write_text("not an image")
    return d


def test_native_loader_builds_here():
    assert native.is_available(), native.build_error()
    assert native._SRC.read_bytes() == jax_native._SRC.read_bytes()


def _items(loader):
    return [(p, im) for p, im in loader]


def _assert_items_equal(got, want):
    assert [p for p, _ in got] == [p for p, _ in want] and got
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_images_loader_matches_jax(media):
    _assert_items_equal(_items(TL.LoadImagesAndVideos(media)), _items(JL.LoadImagesAndVideos(media)))
    one = media / "a.jpg"
    _assert_items_equal(_items(TL.load_inference_source(one)), _items(JL.load_inference_source(one)))
    with pytest.raises(FileNotFoundError):
        TL.LoadImagesAndVideos(media / "missing")


def test_video_loader_matches_jax(tmp_path):
    path = tmp_path / "v.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 32))
    if not writer.isOpened():
        pytest.skip("no cv2 codec writes MJPG here")
    for i in range(5):
        writer.write(_image(32, 48, i))
    writer.release()
    for stride in (1, 2):
        got = _items(TL.LoadImagesAndVideos(path, vid_stride=stride))
        _assert_items_equal(got, _items(JL.LoadImagesAndVideos(path, vid_stride=stride)))
        assert len(got) == (5 if stride == 1 else 3)


def test_pil_numpy_and_tensor_loaders_match_jax():
    arrays = [_image(20, 30, 4), _image(16, 16, 5)]
    pil = Image.fromarray(arrays[0]).convert("L")
    _assert_items_equal(_items(TL.LoadPilAndNumpy([pil, arrays[1]])),
                        _items(JL.LoadPilAndNumpy([pil, arrays[1]])))
    _assert_items_equal(_items(TL.LoadPilAndNumpy(arrays[0])), _items(JL.LoadPilAndNumpy(arrays[0])))
    batch = np.stack([_image(12, 18, s) for s in range(3)])
    _assert_items_equal(_items(TL.LoadTensor(torch.from_numpy(batch))), _items(JL.LoadTensor(batch)))
    assert isinstance(TL.load_inference_source(torch.from_numpy(batch)), TL.LoadTensor)
    assert isinstance(TL.load_inference_source(batch), TL.LoadTensor)
    assert isinstance(TL.load_inference_source(arrays), TL.LoadPilAndNumpy)
    with pytest.raises(AssertionError):
        TL.LoadTensor(torch.zeros(2, 3, 8, 8))


# ----------------------------------------------------------- native loader


def test_native_decode_matches_jax(media, tmp_path):
    for name in ("a.jpg", "b.png"):
        got, want = native.decode_file(media / name), jax_native.decode_file(media / name)
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    Image.fromarray(_image(21, 13, 6)[..., 0]).save(tmp_path / "g.png")
    np.testing.assert_array_equal(native.decode_file(tmp_path / "g.png"),
                                  jax_native.decode_file(tmp_path / "g.png"))
    assert native.decode_file(media / "c.bmp") is None is jax_native.decode_file(media / "c.bmp")
    assert native.decode_file(tmp_path / "missing.jpg") is None


@pytest.mark.parametrize("hw,size,scaleup", [((50, 70), 64, True), ((300, 120), 128, True),
                                             ((30, 41), 64, False), ((64, 64), 64, True)])
def test_native_letterbox_matches_jax(hw, size, scaleup):
    img = _image(*hw, seed=7)
    got = native.letterbox_u8(img, size, scaleup=scaleup)
    want = jax_native.letterbox_u8(img, size, scaleup=scaleup)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_native_batch_decode_matches_jax(media):
    paths = [media / "a.jpg", media / "b.png", media / "c.bmp", media / "missing.jpg"]
    pool, jpool = native.NativePool(2), jax_native.NativePool(2)
    try:
        for scaleup in (True, False):
            got = pool.decode_letterbox_batch(paths, 64, scaleup=scaleup)
            want = jpool.decode_letterbox_batch(paths, 64, scaleup=scaleup)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            assert list(got[-1]) == [0, 0, 2, 1]
    finally:
        pool.close()
        jpool.close()


# ------------------------------------------------------ DataLoader lanes


@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    return make_shapes_dataset(tmp_path_factory.mktemp("lshapes"), n_train=0, n_val=7, imgsz=160)


def _val_batches(loader_cls, dataset_cls, root, imgsz=96):
    dl = loader_cls(dataset_cls(root, split="val", imgsz=imgsz), batch_size=3, imgsz=imgsz,
                    augment=False, drop_last=False, prefetch=0)
    batches = list(dl)
    lane = dl._native not in (None, False)
    dl.close()
    return batches, lane


def test_native_val_lane_matches_jax(shapes_root, monkeypatch):
    monkeypatch.delenv("YOLO_DBL_NATIVE_LOADER", raising=False)
    got, lane = _val_batches(DataLoader, YOLODataset, shapes_root)
    want, jax_lane = _val_batches(JaxDataLoader, JaxDataset, shapes_root)
    assert lane and jax_lane, "the native lane did not engage"
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("img", "gt_boxes", "gt_cls", "gt_mask", "indices"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        for lg, lw in zip(g["labels"], w["labels"]):
            assert lg["orig_shape"] == lw["orig_shape"] and lg["ratio_pad"] == lw["ratio_pad"]
            np.testing.assert_array_equal(lg["boxes"], lw["boxes"])
            np.testing.assert_array_equal(lg["cls"], lw["cls"])


def test_native_val_lane_against_the_python_lane(shapes_root, monkeypatch):
    monkeypatch.delenv("YOLO_DBL_NATIVE_LOADER", raising=False)
    nat, lane = _val_batches(DataLoader, YOLODataset, shapes_root)
    monkeypatch.setenv("YOLO_DBL_NATIVE_LOADER", "0")
    py, py_lane = _val_batches(DataLoader, YOLODataset, shapes_root)
    assert lane and not py_lane
    for n, p in zip(nat, py):
        assert n["img"].shape == p["img"].shape and n["img"].dtype == np.uint8
        np.testing.assert_array_equal(n["gt_cls"], p["gt_cls"])
        np.testing.assert_array_equal(n["gt_mask"], p["gt_mask"])
        np.testing.assert_allclose(n["gt_boxes"], p["gt_boxes"], atol=1.5 / 96)
        for ln, lp in zip(n["labels"], p["labels"]):
            assert ln["orig_shape"] == lp["orig_shape"]
            np.testing.assert_allclose(ln["boxes"], lp["boxes"], atol=1.5)
        assert np.abs(n["img"].astype(int) - p["img"].astype(int)).mean() < 4.0


def test_native_lane_off_for_training(tmp_path):
    root = make_shapes_dataset(tmp_path, n_train=4, n_val=0, imgsz=64)
    dl = DataLoader(YOLODataset(root, split="train", imgsz=64), batch_size=2, imgsz=64, prefetch=0)
    next(iter(dl))
    assert dl._native is None


# ------------------------------------------------------------ Results


def _result_pair(seed, n=5, track=False):
    rng = np.random.default_rng(seed)
    h, w = 90, 130
    xy = rng.uniform(-5, 100, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    cols = [xy, xy + wh]
    if track:
        cols.append(rng.integers(1, 9, (n, 1)))
    cols += [rng.uniform(0.2, 1.0, (n, 1)), rng.integers(0, 3, (n, 1))]
    data = np.concatenate(cols, 1)
    img = _image(h, w, seed)
    names = {0: "box", 1: "circle", 2: "dark"}
    return (TP.Results(TP.Boxes(data), orig_shape=(h, w), path=f"im{seed}.jpg", names=names,
                       orig_img=img),
            JP.Results(JP.Boxes(data), orig_shape=(h, w), path=f"im{seed}.jpg", names=names,
                       orig_img=img))


@pytest.mark.parametrize("seed,n,track", [(0, 5, False), (1, 1, False), (2, 0, False), (3, 4, True)])
def test_results_match_jax(seed, n, track, tmp_path):
    t, j = _result_pair(seed, n, track)
    assert len(t) == len(j) == n
    assert t.to_json_dicts() == j.to_json_dicts()
    assert t.verbose() == j.verbose()
    for save_conf in (True, False):
        a = t.save_txt(tmp_path / "t" / f"{save_conf}.txt", save_conf=save_conf)
        b = j.save_txt(tmp_path / "j" / f"{save_conf}.txt", save_conf=save_conf)
        assert a.read_text() == b.read_text()
    ct, cj = t.save_crop(tmp_path / "tc"), j.save_crop(tmp_path / "jc")
    assert [p.relative_to(tmp_path / "tc") for p in ct] == [p.relative_to(tmp_path / "jc") for p in cj]
    for a, b in zip(ct, cj):
        assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(t.plot(), j.plot())
    np.testing.assert_array_equal(t.plot(np.zeros_like(t.orig_img), color=(0, 255, 0)),
                                  j.plot(np.zeros_like(j.orig_img), color=(0, 255, 0)))
    b_t, b_j = t.boxes, j.boxes
    for attr in ("xyxy", "conf", "cls", "xywh"):
        np.testing.assert_array_equal(getattr(b_t, attr), getattr(b_j, attr))
    assert b_t.is_track == b_j.is_track == track
    if n:
        np.testing.assert_array_equal(b_t[0].data, b_j[0].data)


def test_native_loader_gives_way_when_its_library_does_not_load(monkeypatch, tmp_path):
    """A library that does not load (built where libjpeg or libpng is not
    the same) leaves the loader unavailable, and the val loader takes its
    Python lane, as it does where g++ or the headers are missing."""
    def refuse(path, *args, **kwargs):
        raise OSError(f"{path}: cannot open shared object file")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERR", None)
    monkeypatch.setattr(native.ctypes, "CDLL", refuse)
    monkeypatch.delenv("YOLO_DBL_NATIVE_LOADER", raising=False)
    assert not native.is_available() and "cannot open" in native.build_error()
    assert native.decode_file(tmp_path / "a.jpg") is None
    root = make_shapes_dataset(tmp_path / "ds", n_train=0, n_val=2, imgsz=64)
    dl = DataLoader(YOLODataset(root, split="val", imgsz=64), batch_size=2, imgsz=64,
                    augment=False, prefetch=0)
    batch = next(iter(dl))
    assert dl._native is False and batch["img"].shape == (2, 64, 64, 3)
