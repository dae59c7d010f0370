"""Run-directory helpers (port of yolo_dbl_tpu/utils/files.py)."""

from __future__ import annotations

from pathlib import Path


def increment_path(path, exist_ok: bool = False, sep: str = "") -> Path:
    """`path` or, when it exists and `exist_ok` is False, the first free
    `path{sep}2`, `path{sep}3`, ... (the run-directory numbering behind
    project/name and exist_ok)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    suffix = path.suffix
    stem = path if suffix == "" else path.with_suffix("")
    for n in range(2, 9999):
        p = Path(f"{stem}{sep}{n}{suffix}")
        if not p.exists():
            return p
    raise FileExistsError(f"no free increment for {path}")
