"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for `sm_90a`.
Libraries land in `build/yolo_dbl_tpu_torch/` at the repository root (or
`$YOLO_DBL_TORCH_BUILD_DIR`), named by a hash of source and flags, so an
edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("preprocess", "sampling", "attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("YOLO_DBL_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "yolo_dbl_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library not built yet, one nvcc per source, all started
    together. Returns {name: {"seconds", "log"}}; raises if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.is_file():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str):
    """Raise if a C launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
