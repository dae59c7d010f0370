"""ctypes binding and build on first use of the native data-loader core
(port of yolo_dbl_tpu/native/loader.py; src/loader.cc is a copy of the JAX
package's source).

The C++ side has a plain C interface. g++ compiles it on first use into
`build/yolo_dbl_tpu_torch/` at the repository root (or
`$YOLO_DBL_TORCH_BUILD_DIR`, where the CUDA kernels are built too), named
by a hash of the source, so the two packages never share a library. Every
entry point returns None or False when g++, libjpeg or libpng is missing,
and its callers (`data/build.py`, `data/loaders.py`) then take the cv2 lane.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).parent / "src" / "loader.cc"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERR: Optional[str] = None


def _build_dir() -> Path:
    from ..kernels.build import build_dir

    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    return d


def _build() -> Optional[ctypes.CDLL]:
    global _BUILD_ERR
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = _build_dir() / f"libloader-{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            str(_SRC), "-o", str(tmp), "-ljpeg", "-lpng", "-lz",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
            _BUILD_ERR = getattr(e, "stderr", b"") or str(e)
            if isinstance(_BUILD_ERR, bytes):
                _BUILD_ERR = _BUILD_ERR.decode(errors="replace")
            return None
        os.replace(tmp, so)  # atomic: concurrent builds race benignly
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:  # built on a host whose libjpeg or libpng this one lacks
        _BUILD_ERR = str(e)
        return None
    lib.ydt_pool_create.restype = ctypes.c_void_p
    lib.ydt_pool_create.argtypes = [ctypes.c_int]
    lib.ydt_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.ydt_decode_file.restype = ctypes.c_int
    lib.ydt_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.ydt_decode_letterbox_batch.restype = ctypes.c_int
    lib.ydt_decode_letterbox_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ydt_letterbox.restype = None
    lib.ydt_letterbox.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None and _BUILD_ERR is None:
        with _LOCK:
            if _LIB is None and _BUILD_ERR is None:
                _LIB = _build()
    return _LIB


def is_available() -> bool:
    """True iff the native core compiled and loaded on this host."""
    return _get_lib() is not None


def build_error() -> Optional[str]:
    return _BUILD_ERR


def decode_file(path: str | os.PathLike) -> Optional[np.ndarray]:
    """Decode one JPEG/PNG to an (H, W, 3) RGB uint8 array, or None on
    failure (caller falls back to cv2)."""
    lib = _get_lib()
    if lib is None:
        return None
    cap = 64 * 1024 * 1024 * 3  # 192 MB ceiling: a 8k x 8k x 3 image is 201 MB
    buf = np.empty(cap, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.ydt_decode_file(
        str(path).encode(), buf.ctypes.data_as(ctypes.c_void_p), cap,
        ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


class NativePool:
    """Persistent native worker pool. One per DataLoader; thread-safe for a
    single submit-and-wait batch call at a time per pool (DataLoader's
    producer thread is the only caller)."""

    def __init__(self, workers: int):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_BUILD_ERR}")
        self._lib = lib
        self._pool = lib.ydt_pool_create(int(workers))

    def close(self):
        if self._pool is not None:
            self._lib.ydt_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def decode_letterbox_batch(
        self,
        paths: Sequence[str],
        imgsz: int,
        out: Optional[np.ndarray] = None,
        pad_value: int = 114,
        scaleup: bool = False,
        center: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Decode + letterbox n files into a (n, imgsz, imgsz, 3) u8 batch.

        Returns (batch, gains (n,), pads (n, 2) [left, top] px, orig_hw
        (n, 2), status (n,) — 0 ok / 1 read / 2 decode). Failed slots are
        solid pad_value; callers retry those through the Python path.
        """
        n = len(paths)
        if out is None:
            out = np.empty((n, imgsz, imgsz, 3), np.uint8)
        assert out.shape == (n, imgsz, imgsz, 3) and out.dtype == np.uint8
        assert out.flags["C_CONTIGUOUS"]
        gains = np.empty(n, np.float32)
        pads = np.empty((n, 2), np.float32)
        orig_hw = np.empty((n, 2), np.int32)
        status = np.empty(n, np.int32)
        arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
        self._lib.ydt_decode_letterbox_batch(
            self._pool, arr, n, int(imgsz), int(pad_value), int(scaleup),
            int(center),
            out.ctypes.data_as(ctypes.c_void_p),
            gains.ctypes.data_as(ctypes.c_void_p),
            pads.ctypes.data_as(ctypes.c_void_p),
            orig_hw.ctypes.data_as(ctypes.c_void_p),
            status.ctypes.data_as(ctypes.c_void_p),
        )
        return out, gains, pads, orig_hw, status


def letterbox_u8(img: np.ndarray, imgsz: int, pad_value: int = 114,
                 scaleup: bool = True, center: bool = True
                 ) -> Optional[Tuple[np.ndarray, float, Tuple[float, float]]]:
    """Native letterbox of a decoded RGB u8 array — same return contract as
    data/augment.py letterbox(). None when the native core is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    out = np.empty((imgsz, imgsz, 3), np.uint8)
    gain = ctypes.c_float()
    pad = (ctypes.c_float * 2)()
    lib.ydt_letterbox(
        img.ctypes.data_as(ctypes.c_void_p), h, w,
        out.ctypes.data_as(ctypes.c_void_p), int(imgsz), int(pad_value),
        int(scaleup), int(center), ctypes.byref(gain), pad)
    return out, float(gain.value), (float(pad[0]), float(pad[1]))
