"""YOLO-format dataset on the host (a copy of yolo_dbl_tpu/data/dataset.py).

The JAX module is numpy and cv2 only, so the port keeps its own copy:
`images/*.jpg` + `labels/*.txt` with lines `cls cx cy w h` normalized to
[0, 1] (segment, pose and obb label lines too). Labels are parsed once and
kept in a hash-validated `.cache` file beside the labels, in the JAX
package's format and version, so either package reads the other's cache;
images are decoded per access, with an optional RAM or disk (`.npy`) cache
behind a budget check that turns the cache off when the dataset won't fit.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}

# the JAX package's label-cache version (npz, read with allow_pickle=False):
# one cache file serves both packages
CACHE_VERSION = "yolo_dbl_tpu.cache.v2"


def _labels_to_arrays(labels: List[Dict]) -> Dict[str, np.ndarray]:
    """Flatten ragged per-image label dicts into dense arrays for np.savez
    (non-executable on load, unlike pickle: np.load(allow_pickle=False))."""
    ncol = labels[0]["xywhn"].shape[1] if labels else 4
    counts = np.array([len(l["cls"]) for l in labels], np.int64)
    out = {
        "counts": counts,
        "ncol": np.int64(ncol),
        "xywhn": (np.concatenate([l["xywhn"] for l in labels], 0)
                  if labels else np.zeros((0, ncol), np.float32)),
        "cls": (np.concatenate([l["cls"] for l in labels], 0)
                if labels else np.zeros((0,), np.int32)),
    }
    if labels and "segments" in labels[0]:
        segs = [s for l in labels for s in l["segments"]]
        out["seg_counts"] = np.array([len(l["segments"]) for l in labels], np.int64)
        out["seg_lens"] = np.array([len(s) for s in segs], np.int64)
        out["seg_points"] = (np.concatenate(segs, 0) if segs
                             else np.zeros((0, 2), np.float32))
    if labels and "keypoints" in labels[0]:
        out["kpt_ks"] = np.array([l["keypoints"].shape[1] for l in labels], np.int64)
        out["kpt_flat"] = (np.concatenate(
            [l["keypoints"].reshape(-1, 3) for l in labels], 0)
            if labels else np.zeros((0, 3), np.float32))
    return out


def _labels_from_arrays(z) -> List[Dict]:
    """Inverse of _labels_to_arrays."""
    counts = z["counts"]
    ncol = int(z["ncol"])
    box_off = np.concatenate([[0], np.cumsum(counts)])
    labels = []
    has_seg, has_kpt = "seg_counts" in z, "kpt_ks" in z
    if has_seg:
        seg_counts = z["seg_counts"]
        seg_lens = z["seg_lens"]
        poly_off = np.concatenate([[0], np.cumsum(seg_counts)])
        pt_off = np.concatenate([[0], np.cumsum(seg_lens)])
        seg_points = z["seg_points"]
    if has_kpt:
        kpt_ks = z["kpt_ks"]
        kpt_off = np.concatenate([[0], np.cumsum(counts * kpt_ks)])
        kpt_flat = z["kpt_flat"]
    for i, n in enumerate(counts):
        lab = {
            "xywhn": z["xywhn"][box_off[i]:box_off[i + 1]].reshape(-1, ncol).astype(np.float32),
            "cls": z["cls"][box_off[i]:box_off[i + 1]].astype(np.int32),
        }
        if has_seg:
            polys = []
            for j in range(poly_off[i], poly_off[i + 1]):
                polys.append(seg_points[pt_off[j]:pt_off[j + 1]].astype(np.float32))
            lab["segments"] = polys
        if has_kpt:
            k = int(kpt_ks[i])
            lab["keypoints"] = kpt_flat[kpt_off[i]:kpt_off[i + 1]].reshape(
                int(n), k, 3).astype(np.float32)
        labels.append(lab)
    return labels


def _available_ram() -> int:
    """MemAvailable from /proc/meminfo (the budget the reference reads via
    psutil.virtual_memory().available); unknown → effectively unlimited."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 1 << 62


class YOLODataset:
    def __init__(self, root, split: str = "train", imgsz: int = 640, cache_images: bool = False,
                 names: Optional[Dict[int, str]] = None, img_dir=None, task: str = "detect",
                 single_cls: bool = False, fraction: float = 1.0):
        self.task = task
        self.fraction = float(fraction)
        if img_dir is None and isinstance(root, (str, Path)) and str(root).endswith((".yaml", ".yml")):
            # dataset recipe yaml (reference data/utils.py check_det_dataset)
            from .utils import check_det_dataset

            info = check_det_dataset(root)
            img_dir = info["val"] if split in ("val", "test") and info["val"] else info["train"]
            root = info["root"]
            if names is None:
                names = info["names"]
        self.root = Path(root)
        if img_dir is not None:
            img_dir = Path(img_dir)
        else:
            img_dir = self.root / "images" / split
            if not img_dir.is_dir():
                img_dir = self.root / "images"
            if not img_dir.is_dir():
                img_dir = self.root / split / "images"
        if not img_dir.is_dir():
            raise FileNotFoundError(f"no images directory under {self.root}")
        self.im_files: List[Path] = sorted(
            p for p in img_dir.rglob("*") if p.suffix.lower() in IMG_EXTS
        )
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {img_dir}")
        if self.fraction < 1.0:
            # reference data/base.py: train on the first `fraction` of images
            self.im_files = self.im_files[: max(1, round(len(self.im_files) * self.fraction))]
        self.labels = self._load_labels()
        if single_cls:
            # reference BaseDataset.update_labels(single_cls): every object
            # becomes class 0 (train the detector class-agnostically)
            for lab in self.labels:
                lab["cls"] = np.zeros_like(lab["cls"])
        self.imgsz = imgsz
        self.names = names or {}
        # cache_images: False | True/'ram' (decoded arrays in RAM) | 'disk'
        # (.npy spill beside each image) — reference data/base.py:93-101
        mode = "ram" if cache_images is True else cache_images
        if mode and not self._check_cache_budget(mode):
            mode = False
        self._cache: Optional[Dict[int, np.ndarray]] = {} if mode == "ram" else None
        self._disk_cache = mode == "disk"

    # ---- persistent label cache (reference data/dataset.py:66) ----

    def _cache_path(self) -> Path:
        """<labels-dir>/<task>.cache beside the label files (reference puts
        it at `Path(label_files[0]).parent.with_suffix('.cache')`; keeping it
        inside the labels dir avoids clobbering sibling-split caches)."""
        return self._label_path(self.im_files[0]).parent / f".{self.task}.labels.cache"

    def _labels_hash(self) -> str:
        """Hash of every label file's (path, size, mtime) plus the image
        list and task — any added/removed/edited label invalidates."""
        h = hashlib.sha256(self.task.encode())
        for p in self.im_files:
            lp = self._label_path(p)
            try:
                st = lp.stat()
                h.update(f"{lp}|{st.st_size}|{st.st_mtime_ns};".encode())
            except OSError:
                h.update(f"{lp}|absent;".encode())
        return h.hexdigest()

    def _load_labels(self) -> List[Dict]:
        """Load labels from the .cache when its hash validates; otherwise
        parse every label file and (best-effort) write a fresh cache."""
        cache_path = self._cache_path()
        want_hash = self._labels_hash()
        if cache_path.is_file():
            try:
                with np.load(cache_path, allow_pickle=False) as z:
                    if (
                        str(z["version"]) == CACHE_VERSION
                        and str(z["hash"]) == want_hash
                        and len(z["counts"]) == len(self.im_files)
                    ):
                        return _labels_from_arrays(z)
            except Exception:
                pass  # corrupt/unreadable/old-format cache → re-scan
        labels = [self._read_label(p) for p in self.im_files]
        if self.fraction < 1.0:
            return labels  # don't overwrite the full-dataset cache with a slice
        try:
            # per-process tmp name: concurrent openers can't race on one .tmp
            tmp = cache_path.with_suffix(f".{os.getpid()}.tmp")
            arrays = _labels_to_arrays(labels)
            with open(tmp, "wb") as f:
                np.savez(f, version=CACHE_VERSION, hash=want_hash, **arrays)
            tmp.replace(cache_path)  # atomic: readers never see a partial file
        except OSError:
            pass  # read-only dataset dir — cache is an optimization only
        return labels

    @staticmethod
    def _label_path(img_path: Path) -> Path:
        parts = list(img_path.parts)
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] == "images":
                parts[i] = "labels"
                break
        return Path(*parts).with_suffix(".txt")

    def _read_label(self, img_path: Path) -> Dict:
        """Parse one YOLO label file by task (reference data/utils.py
        verify_image_label): detect `cls xywh`; segment `cls poly…`; pose
        `cls xywh (x y v)×K`; obb `cls x1 y1 … x4 y4` (DOTA corners)."""
        lp = self._label_path(img_path)
        boxes, cls, segs, kpts = [], [], [], []
        if lp.is_file():
            for line in lp.read_text().splitlines():
                vals = [float(v) for v in line.split()]
                if len(vals) < 5:
                    continue
                cls.append(int(vals[0]))
                if self.task == "segment":
                    poly = np.array(vals[1:], np.float32).reshape(-1, 2)
                    segs.append(poly)
                    x1, y1 = poly.min(0)
                    x2, y2 = poly.max(0)
                    boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                elif self.task == "pose":
                    boxes.append(vals[1:5])
                    kpts.append(np.array(vals[5:], np.float32).reshape(-1, 3))
                elif self.task == "obb":
                    pts = np.array(vals[1:9], np.float32).reshape(4, 2)
                    (cx, cy), (bw, bh), ang = cv2.minAreaRect(pts)
                    boxes.append([cx, cy, bw, bh, np.deg2rad(ang)])
                else:
                    boxes.append(vals[1:5])
        ncol = 5 if self.task == "obb" else 4
        out = {
            "xywhn": np.array(boxes, np.float32).reshape(-1, ncol),
            "cls": np.array(cls, np.int32),
        }
        if self.task == "segment":
            out["segments"] = segs
        elif self.task == "pose":
            out["keypoints"] = (np.stack(kpts) if kpts else
                                np.zeros((0, 17, 3), np.float32))
        return out

    def __len__(self):
        return len(self.im_files)

    # ---- image cache budget (reference data/base.py check_cache_ram /
    # check_cache_disk, base.py:93-101) ----

    def _check_cache_budget(self, mode: str) -> bool:
        """Sample-decode up to 30 images, extrapolate the full dataset's
        decoded bytes with a 1.1 safety factor, and compare against available
        RAM ('ram') or free disk next to the images ('disk'). Returns False
        (with a warning) when the dataset won't fit — caching then stays off
        rather than OOMing mid-epoch."""
        n = len(self.im_files)
        sample = [self.im_files[i] for i in np.linspace(0, n - 1, min(30, n)).astype(int)]
        nbytes, ok = 0, 0
        for p in sample:
            img = cv2.imread(str(p))
            if img is not None:
                nbytes += img.nbytes
                ok += 1
        if not ok:
            return False
        need = nbytes / ok * n * 1.1
        if mode == "ram":
            have = _available_ram()
            kind = "available RAM"
        else:
            import shutil

            have = shutil.disk_usage(self.im_files[0].parent).free
            kind = "free disk"
        if need > have:
            logging.getLogger(__name__).warning(
                f"cache='{mode}' needs ~{need / 2**30:.1f} GiB for {n} images but only "
                f"{have / 2**30:.1f} GiB {kind} — caching disabled")
            return False
        return True

    def _npy_path(self, index: int) -> Path:
        return self.im_files[index].with_suffix(".npy")

    def load_image(self, index: int) -> np.ndarray:
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        if self._disk_cache:
            npy = self._npy_path(index)
            if npy.is_file():
                try:
                    return np.load(npy, allow_pickle=False)
                except Exception:
                    pass  # truncated/foreign .npy → decode the original
        img = cv2.imread(str(self.im_files[index]))
        if img is None:
            raise IOError(f"failed to read {self.im_files[index]}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if self._cache is not None:
            self._cache[index] = img
        elif self._disk_cache:
            try:
                tmp = self._npy_path(index).with_suffix(f".{os.getpid()}.npytmp")
                with open(tmp, "wb") as f:  # handle write: np.save(path) would append '.npy'
                    np.save(f, img)
                tmp.replace(self._npy_path(index))  # atomic vs concurrent readers
            except OSError:
                pass  # read-only dataset dir — spill is an optimization only
        return img

    def load_resized(self, index: int, imgsz: int) -> Tuple[np.ndarray, Dict]:
        """Load + resize long side to imgsz (reference data/base.py load_image),
        labels converted to pixel xyxy."""
        img = self.load_image(index)
        h0, w0 = img.shape[:2]
        r = imgsz / max(h0, w0)
        if r != 1:
            img = cv2.resize(img, (round(w0 * r), round(h0 * r)), interpolation=cv2.INTER_LINEAR)
        h, w = img.shape[:2]
        lab = self.labels[index]
        xywhn = lab["xywhn"]
        if len(xywhn):
            cx, cy, bw, bh = xywhn[:, 0] * w, xywhn[:, 1] * h, xywhn[:, 2] * w, xywhn[:, 3] * h
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=1).astype(np.float32)
        else:
            boxes = np.zeros((0, 4), np.float32)
        extra = {}
        if self.task == "segment":
            extra["segments"] = [p * np.array([w, h], np.float32) for p in lab.get("segments", [])]
        elif self.task == "pose":
            kp = lab.get("keypoints", np.zeros((0, 17, 3), np.float32)).copy()
            kp[..., 0] *= w
            kp[..., 1] *= h
            extra["keypoints"] = kp
        elif self.task == "obb":
            extra["rboxes"] = lab["xywhn"].copy()  # normalized xywhr
        return img, {"boxes": boxes, "cls": lab["cls"].copy(), "orig_shape": (h0, w0), **extra}
