"""Inference source loaders on the host (port of yolo_dbl_tpu/data/loaders.py).

`LoadImagesAndVideos` iterates the image and video files of a path, decoding
JPEG and PNG with the native loader where it built and everything else with
cv2; `LoadStreams` keeps the latest frame of each stream on reader threads;
`LoadPilAndNumpy` takes PIL images or HWC arrays; `LoadTensor` takes a
(B, H, W, 3) torch tensor (where JAX takes an array) and yields its frames as
numpy arrays; `load_inference_source` picks one. Every loader yields
(path, RGB frame) pairs.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}
VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".webm", ".gif"}


class LoadImagesAndVideos:
    """Iterate image and video files, yielding (path, RGB frame)."""

    def __init__(self, source: Union[str, Path], vid_stride: int = 1):
        p = Path(source)
        if p.is_dir():
            self.files = sorted(
                f for f in p.rglob("*") if f.suffix.lower() in IMG_EXTS | VID_EXTS
            )
        elif p.is_file():
            self.files = [p]
        else:
            raise FileNotFoundError(source)
        self.vid_stride = vid_stride

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        import cv2

        for f in self.files:
            if f.suffix.lower() in IMG_EXTS:
                # the native decoder first (JPEG and PNG, RGB out); cv2 takes
                # the other formats, and every file where it did not build
                from ..native import loader as _native

                im_rgb = _native.decode_file(f) if _native.is_available() else None
                if im_rgb is None:
                    im = cv2.imread(str(f))
                    im_rgb = cv2.cvtColor(im, cv2.COLOR_BGR2RGB) if im is not None else None
                if im_rgb is not None:
                    yield str(f), im_rgb
            else:
                cap = cv2.VideoCapture(str(f))
                idx = 0
                while cap.isOpened():
                    ok, frame = cap.read()
                    if not ok:
                        break
                    if idx % self.vid_stride == 0:
                        yield f"{f}#{idx}", cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    idx += 1
                cap.release()


class LoadStreams:
    """Reader threads keeping the latest frame of each stream."""

    def __init__(self, sources: Union[str, List[str]], buffer: bool = False):
        import cv2

        self.sources = [sources] if isinstance(sources, (str, int)) else list(sources)
        self.caps = []
        self.frames: List[Optional[np.ndarray]] = [None] * len(self.sources)
        self.running = True
        self.threads = []
        for i, s in enumerate(self.sources):
            cap = cv2.VideoCapture(int(s) if str(s).isdigit() else s)
            if not cap.isOpened():
                raise ConnectionError(f"failed to open stream {s}")
            self.caps.append(cap)
            t = threading.Thread(target=self._reader, args=(i,), daemon=True)
            t.start()
            self.threads.append(t)

    def _reader(self, i: int):
        import cv2

        while self.running and self.caps[i].isOpened():
            ok, frame = self.caps[i].read()
            if ok:
                self.frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            else:
                time.sleep(0.01)

    def __iter__(self):
        while self.running:
            if all(f is not None for f in self.frames):
                yield list(self.sources), [f.copy() for f in self.frames]
            time.sleep(0.005)

    def close(self):
        self.running = False
        for cap in self.caps:
            cap.release()


class LoadPilAndNumpy:
    """PIL images or HWC arrays as RGB arrays."""

    def __init__(self, im0):
        ims = im0 if isinstance(im0, (list, tuple)) else [im0]
        self.images = [self._single(im) for im in ims]

    @staticmethod
    def _single(im) -> np.ndarray:
        if hasattr(im, "convert"):  # PIL
            return np.asarray(im.convert("RGB"))
        arr = np.asarray(im)
        assert arr.ndim == 3 and arr.shape[-1] == 3, f"expected HWC RGB, got {arr.shape}"
        return arr

    def __iter__(self):
        for i, im in enumerate(self.images):
            yield f"array{i}", im


class LoadTensor:
    """The frames of a (B, H, W, 3) tensor, as numpy arrays on the host."""

    def __init__(self, batch):
        batch = torch.as_tensor(batch)
        assert batch.ndim == 4 and batch.shape[-1] == 3, f"expected NHWC, got {tuple(batch.shape)}"
        self.batch = batch.cpu().numpy()

    def __iter__(self):
        for i, im in enumerate(self.batch):
            yield f"tensor{i}", im


def load_inference_source(source, vid_stride: int = 1):
    """The loader of a source: streams, paths, 4-D tensors or arrays, or
    single images."""
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.startswith(("rtsp://", "rtmp://", "http://", "https://", "tcp://")) or s.isdigit():
            return LoadStreams(s)
        return LoadImagesAndVideos(source, vid_stride)
    if isinstance(source, (np.ndarray, torch.Tensor)) and source.ndim == 4:
        return LoadTensor(source)
    return LoadPilAndNumpy(source)
