"""The port's data pipeline and YAML reader against the JAX package.

- `load_yaml` (the port's YAML reader) gives PyYAML's `safe_load` on every
  dataset recipe and on yolov8.yaml, and the recipes are byte copies.
- `check_det_dataset` gives JAX's result for each of the 30 recipes (or
  raises the same error) and for a shapes-set directory.
- Seeded `YOLODataset`, transforms and `DataLoader` on a shapes set (8 train
  and 4 val images): batches equal to JAX's bit for bit (`img`, `gt_boxes`,
  `gt_cls`, `gt_mask`, `indices`, the val `labels`), with the JAX loader's
  native lane off (`YOLO_DBL_NATIVE_LOADER=0`), so both run their Python
  lanes: mosaic training over two epochs and `set_epoch`, with 0 and 2
  workers; a heavier augmentation recipe; `close_mosaic`; validation; and
  the segment transforms, whose copy-paste needs polygons.
"""

from pathlib import Path

import numpy as np
import pytest
import yaml

from yolo_dbl_tpu.data import augment as JA
from yolo_dbl_tpu.data.build import DataLoader as JaxDataLoader
from yolo_dbl_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_dbl_tpu.data.utils import check_det_dataset as jax_check_det_dataset

from yolo_dbl_tpu_torch.data import augment as TA
from yolo_dbl_tpu_torch.data.build import DataLoader
from yolo_dbl_tpu_torch.data.dataset import YOLODataset
from yolo_dbl_tpu_torch.data.utils import check_det_dataset
from yolo_dbl_tpu_torch.utils.yaml_subset import load_yaml

from tests.fixtures import make_shapes_dataset, make_task_dataset
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
RECIPES = sorted(p.name for p in (REPO / "yolo_dbl_tpu/cfg/datasets").glob("*.yaml"))
IMGSZ = 64
# every draw of TrainTransforms on: mixup, rotation, shear, perspective,
# vertical flips, the channel swap and erasing
HEAVY = {"mosaic": 1.0, "mixup": 0.5, "degrees": 10.0, "shear": 2.0, "perspective": 0.0005,
         "flipud": 0.5, "bgr": 0.5, "erasing": 0.4, "translate": 0.2, "scale": 0.6}


@pytest.fixture(autouse=True)
def python_lane(monkeypatch):
    """The JAX val loader takes its native lane by default; both sides run
    their Python lanes here."""
    monkeypatch.setenv("YOLO_DBL_NATIVE_LOADER", "0")


@pytest.mark.parametrize("name", RECIPES + ["v8/yolov8.yaml"])
def test_yaml_reader_matches_pyyaml(name):
    rel = f"models/{name}" if "/" in name else f"datasets/{name}"
    port = REPO / "yolo_dbl_tpu_torch/cfg" / rel
    assert port.read_bytes() == (REPO / "yolo_dbl_tpu/cfg" / rel).read_bytes()
    assert load_yaml(port.read_text()) == yaml.safe_load(port.read_text())


def test_recipes_are_all_copied():
    assert len(RECIPES) == 30
    assert sorted(p.name for p in (REPO / "yolo_dbl_tpu_torch/cfg/datasets").glob("*.yaml")) \
        == RECIPES


def _resolved(fn, arg):
    try:
        return fn(arg), None
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        return None, type(e)


@pytest.mark.parametrize("name", RECIPES)
def test_check_det_dataset_matches_jax(name, tmp_path, monkeypatch):
    """Each recipe's relative `path` resolves against the working directory;
    its train split is made there when it is one directory, so most recipes
    resolve and the rest raise (a list of splits, as GlobalWheat2020's)."""
    d = yaml.safe_load((REPO / "yolo_dbl_tpu/cfg/datasets" / name).read_text())
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    if isinstance(d.get("train"), str):
        (work / d["path"] / d["train"]).mkdir(parents=True)
    want, want_err = _resolved(jax_check_det_dataset, name)
    got, got_err = _resolved(check_det_dataset, name)
    assert got_err is want_err
    if want is None:
        return
    assert Path(got.pop("yaml_file")).name == Path(want.pop("yaml_file")).name == name
    assert got == want
    assert got["names"] and got["nc"] == len(got["names"])


def test_check_det_dataset_directory_and_dict(tmp_path):
    root = make_shapes_dataset(tmp_path / "shapes", n_train=2, n_val=1, imgsz=64)
    assert check_det_dataset(root) == jax_check_det_dataset(root)
    d = {"path": str(root), "train": "images/train", "val": "images/val",
         "names": ["box", "circle", "dark"]}
    assert check_det_dataset(d) == jax_check_det_dataset(d)
    with pytest.raises(FileNotFoundError):
        check_det_dataset(tmp_path / "missing.yaml")


@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    return make_shapes_dataset(tmp_path_factory.mktemp("shapes"), n_train=8, n_val=4, imgsz=160)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("img", "gt_boxes", "gt_cls", "gt_mask", "indices"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for lg, lw in zip(g.get("labels", []), w.get("labels", [])):
            assert set(lg) == set(lw)
            np.testing.assert_array_equal(lg["boxes"], lw["boxes"])
            np.testing.assert_array_equal(lg["cls"], lw["cls"])
            assert lg["orig_shape"] == lw["orig_shape"] and lg["ratio_pad"] == lw["ratio_pad"]


def _epochs(loader, n=2):
    """n epochs in a row, then epoch 0 again after set_epoch(0)."""
    out = [list(loader) for _ in range(n)]
    loader.set_epoch(0)
    out.append(list(loader))
    loader.close()
    return out


@pytest.mark.parametrize("workers,hyp,prefetch", [(0, None, 0), (2, None, 2), (0, HEAVY, 2)],
                         ids=["mosaic_w0", "mosaic_w2", "heavy_w0"])
def test_train_loader_matches_jax(shapes_root, workers, hyp, prefetch):
    kw = dict(batch_size=4, imgsz=IMGSZ, augment=True, hyp=hyp, max_gt=16, seed=3,
              workers=workers, prefetch=prefetch)
    got = _epochs(DataLoader(YOLODataset(shapes_root, split="train", imgsz=IMGSZ), **kw))
    want = _epochs(JaxDataLoader(JaxDataset(shapes_root, split="train", imgsz=IMGSZ), **kw))
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    _assert_batches_equal(got[2], got[0])  # set_epoch(0) replays the first epoch
    assert not np.array_equal(got[0][0]["indices"], got[1][0]["indices"])


def test_close_mosaic_matches_jax(shapes_root):
    kw = dict(batch_size=4, imgsz=IMGSZ, augment=True, max_gt=16, seed=5, prefetch=0)
    loaders = (DataLoader(YOLODataset(shapes_root, split="train", imgsz=IMGSZ), **kw),
               JaxDataLoader(JaxDataset(shapes_root, split="train", imgsz=IMGSZ), **kw))
    for dl in loaders:
        dl.close_mosaic()
    got, want = (list(dl) for dl in loaders)
    _assert_batches_equal(got, want)


def test_val_loader_matches_jax(shapes_root):
    kw = dict(batch_size=3, imgsz=IMGSZ, augment=False, drop_last=False)
    got = list(DataLoader(YOLODataset(shapes_root, split="val", imgsz=IMGSZ), **kw))
    want = list(JaxDataLoader(JaxDataset(shapes_root, split="val", imgsz=IMGSZ), **kw))
    _assert_batches_equal(got, want)
    assert [len(b["labels"]) for b in got] == [3, 1]
    np.testing.assert_array_equal(np.concatenate([b["indices"] for b in got]), np.arange(4))


def test_dataset_labels_and_cache_match_jax(shapes_root, tmp_path):
    root = make_shapes_dataset(tmp_path / "shapes", n_train=4, n_val=0, imgsz=96, seed=2)
    jds = JaxDataset(root, split="train", imgsz=IMGSZ)  # writes the label cache
    cache = next((root / "labels" / "train").glob(".detect.labels.cache"))
    stamp = cache.stat().st_mtime_ns
    ds = YOLODataset(root, split="train", imgsz=IMGSZ, cache_images="ram")
    assert cache.stat().st_mtime_ns == stamp  # the port read JAX's cache
    assert [p.name for p in ds.im_files] == [p.name for p in jds.im_files]
    for a, b in zip(ds.labels, jds.labels):
        np.testing.assert_array_equal(a["xywhn"], b["xywhn"])
        np.testing.assert_array_equal(a["cls"], b["cls"])
    for i in range(len(ds)):
        (ia, la), (ib, lb) = ds.load_resized(i, IMGSZ), jds.load_resized(i, IMGSZ)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la["boxes"], lb["boxes"])
    assert len(ds._cache) == len(ds)


@pytest.mark.parametrize("mode", ["flip", "mixup"])
def test_segment_transforms_match_jax(tmp_path, mode):
    """Copy-paste needs polygons: the segment transforms, fed one generator
    stream on each side, give JAX's images, boxes and polygons."""
    root = make_task_dataset(tmp_path / "seg", task="segment", n_train=4, imgsz=96)
    hyp = {"mosaic": 1.0, "copy_paste": 0.5, "copy_paste_mode": mode, "mixup": 0.5}
    sides = [(TA.TrainTransforms(IMGSZ, hyp), YOLODataset(root, imgsz=IMGSZ, task="segment")),
             (JA.TrainTransforms(IMGSZ, hyp), JaxDataset(root, imgsz=IMGSZ, task="segment"))]
    rngs = [np.random.default_rng(9), np.random.default_rng(9)]
    for i in range(4):
        (ig, lg), (iw, lw) = (tt(ds, i, rng) for (tt, ds), rng in zip(sides, rngs))
        np.testing.assert_array_equal(ig, iw)
        np.testing.assert_array_equal(lg["boxes"], lw["boxes"])
        np.testing.assert_array_equal(lg["cls"], lw["cls"])
        assert len(lg["segments"]) == len(lw["segments"]) == len(lg["boxes"])
        for a, b in zip(lg["segments"], lw["segments"]):
            np.testing.assert_array_equal(a, b)


def test_port_loader_takes_detect_datasets_only(tmp_path):
    """Detect, segment, pose and obb datasets load (tests/test_torch_tasks.py
    and tests/test_torch_obb.py hold their batches to JAX's): an obb loader
    turns augmentation off and gives (B, max_gt, 5) rotated boxes; classify
    is refused."""
    root = make_task_dataset(tmp_path / "obb", task="obb", n_train=2, imgsz=64)
    loader = DataLoader(YOLODataset(root, task="obb"), batch_size=2, imgsz=IMGSZ, prefetch=0)
    assert loader.task == "obb" and not loader.augment and not loader.shuffle
    batch = next(iter(loader))
    assert batch["gt_boxes"].shape == (2, loader.max_gt, 5) and batch["gt_mask"].sum() > 0
    with pytest.raises(NotImplementedError, match="classify"):
        DataLoader(YOLODataset(root, task="obb"), batch_size=2, imgsz=IMGSZ, task="classify")
