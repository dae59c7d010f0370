"""Batch assembly: fixed-shape padded batches (port of yolo_dbl_tpu/data/build.py).

`format_batch` (:22) stacks uint8 images and pads each image's boxes to
`max_gt` with a validity mask, the batch contract of the loss and the
validator. `DataLoader` (:94) is the JAX loader's Python lane: the same
shuffle, the same per-sample generators (one stream, or one spawned per
sample with `workers > 1`) and the same background prefetch thread, so a
seeded run gives the JAX package's batches bit for bit. Validation batches
take the native lane (:169-241) where the native loader built: decode,
letterbox and collate of the whole batch in its C++ worker pool, with the
Python transform's semantics; `YOLO_DBL_NATIVE_LOADER=0` turns it off, and
without g++, libjpeg or libpng the loader runs the Python lane. The task
batches (`format_batch_task`: masks, keypoints, rotated boxes) come with
their heads.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..parallel.mesh import local_rows
from .augment import TrainTransforms, ValTransforms
from .dataset import YOLODataset


def format_batch(images, labels_list, imgsz: int, max_gt: int) -> Dict[str, np.ndarray]:
    """Stack images and pad labels. Boxes become normalized xywh (the loss
    contract, losses/detection.py). uint8 images stay uint8 (the device
    normalizes them); float images are divided by 255 here."""
    b = len(images)
    img = np.stack(images)
    if img.dtype != np.uint8:
        img = img.astype(np.float32) / 255.0  # NHWC [0,1]
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_cls = np.zeros((b, max_gt), np.int32)
    gt_mask = np.zeros((b, max_gt), np.float32)
    for i, lab in enumerate(labels_list):
        boxes = lab["boxes"][:max_gt]
        n = len(boxes)
        if n:
            x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
            cx, cy = (x1 + x2) / 2 / imgsz, (y1 + y2) / 2 / imgsz
            w, h = (x2 - x1) / imgsz, (y2 - y1) / imgsz
            gt_boxes[i, :n] = np.stack([cx, cy, w, h], axis=1)
            gt_cls[i, :n] = lab["cls"][:max_gt][:n]
            gt_mask[i, :n] = 1.0
    return {"img": img, "gt_boxes": gt_boxes, "gt_cls": gt_cls, "gt_mask": gt_mask}


class DataLoader:
    """Epoch iterator over a detect dataset with a background prefetch thread.

    Decode and augmentation run on a host thread while the card runs the
    previous step. With ``workers > 1`` the per-sample work also fans out
    over a thread pool (cv2 releases the GIL), each sample drawing from its
    own generator, spawned from the epoch's (``Generator.spawn``): still
    deterministic for a fixed (seed, epoch, workers > 1), but another stream
    than the sequential one, as in JAX. Batches are dicts of numpy arrays:
    ``img`` (B, S, S, 3) uint8, ``gt_boxes``, ``gt_cls``, ``gt_mask``,
    ``indices``, and, without augmentation, ``labels`` (per-image boxes in
    letterboxed pixels, classes, ``ratio_pad``, ``orig_shape``).

    With a ``mesh`` (parallel/mesh.py) ``batch_size`` is the global batch and
    each batch holds the rows of this rank's data coordinate (d of N: rows
    d B/N to (d + 1) B/N), bit for bit those rows of the one-process
    loader's batch, so the data ranks' batches joined in order are the
    global batch. With
    ``workers > 1`` a rank spawns every row's generator of the batch and
    draws only its own rows. The sequential stream (``workers <= 1``) draws
    the rows one after another from one generator, so there a rank makes the
    whole global batch and keeps its rows.
    """

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, imgsz: int = 640,
                 augment: bool = True, hyp: Optional[dict] = None, max_gt: int = 64,
                 shuffle: Optional[bool] = None, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, workers: int = 0, mesh=None):
        if getattr(dataset, "task", "detect") != "detect":
            raise NotImplementedError(f"only detect batches are ported, got task {dataset.task!r}")
        if mesh is not None and batch_size % mesh.n_data:
            raise ValueError(f"a global batch of {batch_size} does not split over "
                             f"{mesh.n_data} ranks")
        self.mesh = mesh
        self.dataset = dataset
        self.batch_size = batch_size
        self.imgsz = imgsz
        self.max_gt = max_gt
        self.augment = augment
        self.transforms = TrainTransforms(imgsz, hyp) if augment else ValTransforms(imgsz)
        self.shuffle = augment if shuffle is None else shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = int(workers)
        self._pool = None
        self._native = None  # native decode pool: None = untried, False = off
        self._epoch = 0

    def close_mosaic(self):
        if isinstance(self.transforms, TrainTransforms):
            self.transforms.close_mosaic()

    def close(self):
        """Shut down the worker pools. Idempotent; a later iteration makes new ones."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._native not in (None, False):
            self._native.close()
            self._native = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_epoch(self, epoch: int):
        """Make the NEXT iteration reproduce epoch `epoch` (0-based) of a
        fresh run (the resume counterpart of DistributedSampler.set_epoch)."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _native_val_batch(self, idxs):
        """The validation lane of the native loader: decode, letterbox and
        collate the whole batch in the C++ worker pool (native/loader.py)
        into the (B, S, S, 3) uint8 batch. The semantics are ValTransforms':
        gain min(S/h0, S/w0) with scale-up, centered 114 padding, boxes in
        letterboxed pixels. Returns None for the Python lane."""
        if self.augment or os.environ.get("YOLO_DBL_NATIVE_LOADER", "1") == "0":
            return None
        ds = self.dataset
        if getattr(ds, "_cache", None) is not None or not hasattr(ds, "im_files"):
            return None  # RAM-cached datasets: decode happens once anyway
        if self._native is None:
            try:
                from ..native.loader import NativePool

                self._native = NativePool(self.workers if self.workers > 1
                                          else (os.cpu_count() or 4))
            except Exception:
                self._native = False
        if self._native is False:
            return None
        paths = [ds.im_files[int(j)] for j in idxs]
        img, gains, pads, orig_hw, status = self._native.decode_letterbox_batch(
            paths, self.imgsz, scaleup=True)
        b = len(idxs)
        gt_boxes = np.zeros((b, self.max_gt, 4), np.float32)
        gt_cls = np.zeros((b, self.max_gt), np.int32)
        gt_mask = np.zeros((b, self.max_gt), np.float32)
        labels_meta = []
        for i, j in enumerate(idxs):
            if status[i] != 0:
                # unreadable, undecodable or neither JPEG nor PNG: this slot
                # goes through the Python transform
                im_i, lab = self.transforms(ds, int(j), None)
                img[i] = im_i
                boxes, cls = lab["boxes"], lab["cls"]
                labels_meta.append(lab)
            else:
                lab0 = ds.labels[int(j)]
                h0, w0 = int(orig_hw[i, 0]), int(orig_hw[i, 1])
                xywhn = lab0["xywhn"][:, :4]
                g, (px, py) = float(gains[i]), pads[i]
                if len(xywhn):
                    cx, cy = xywhn[:, 0] * w0 * g + px, xywhn[:, 1] * h0 * g + py
                    bw, bh = xywhn[:, 2] * w0 * g, xywhn[:, 3] * h0 * g
                    boxes = np.stack(
                        [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1
                    ).astype(np.float32)
                else:
                    boxes = np.zeros((0, 4), np.float32)
                cls = lab0["cls"].copy()
                labels_meta.append({"boxes": boxes, "cls": cls,
                                    "orig_shape": (h0, w0),
                                    "ratio_pad": (g, (float(px), float(py)))})
            n = min(len(boxes), self.max_gt)
            if n:
                bx = boxes[:n]
                x1, y1, x2, y2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
                gt_boxes[i, :n] = np.stack(
                    [(x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1), (y2 - y1)], 1
                ) / self.imgsz
                gt_cls[i, :n] = cls[:n]
                gt_mask[i, :n] = 1.0
        batch = {"img": img, "gt_boxes": gt_boxes, "gt_cls": gt_cls,
                 "gt_mask": gt_mask, "indices": np.asarray(idxs),
                 "labels": labels_meta}
        return batch

    def _make_batches(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        order = rng.permutation(len(self.dataset)) if self.shuffle else np.arange(len(self.dataset))
        for bi in range(len(self)):
            idxs = order[bi * self.batch_size : (bi + 1) * self.batch_size]
            if len(idxs) == 0:
                break
            mine = slice(None) if self.mesh is None else local_rows(self.mesh, len(idxs))
            native = self._native_val_batch(idxs[mine])
            if native is not None:
                yield native
                continue
            if self.workers > 1:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                                    thread_name_prefix="yolo-dbl-data")
                rngs = rng.spawn(len(idxs))
                out = list(self._pool.map(
                    lambda a: self.transforms(self.dataset, int(a[0]), a[1]),
                    zip(idxs[mine], rngs[mine])))
                images = [o[0] for o in out]
                labels = [o[1] for o in out]
            else:
                images, labels = [], []
                for j in idxs:
                    img, lab = self.transforms(self.dataset, int(j), rng)
                    images.append(img)
                    labels.append(lab)
                images, labels = images[mine], labels[mine]
            batch = format_batch(images, labels, self.imgsz, self.max_gt)
            batch["indices"] = np.asarray(idxs[mine])
            if not self.augment:
                batch["labels"] = labels  # eval metadata (ratio_pad, orig_shape)
            yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        if self.prefetch <= 0:
            yield from self._make_batches()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for b in self._make_batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
