"""Dataset resolution (port of yolo_dbl_tpu/data/utils.py:20-84).

A dataset is named by a directory, a recipe YAML (path/train/val/test/names)
or a dict. The recipes are the JAX package's, copied under the port's
cfg/datasets/ and read with the port's YAML reader in place of PyYAML. No
download runs: a missing path raises with the expected layout instead.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from ..utils.yaml_subset import load_yaml

DATASETS_DIR = Path(__file__).resolve().parent.parent / "cfg" / "datasets"


def check_det_dataset(data: Union[str, Path, Dict]) -> Dict:
    """Resolve a dataset spec to {root, train, val, test, names, nc}.

    Accepts:
      * a directory with images/{train,val} + labels/{train,val},
      * a recipe yaml path (or a name found under cfg/datasets/),
      * an already-resolved dict.
    """
    if isinstance(data, dict):
        d = dict(data)
    else:
        p = Path(data)
        if p.is_dir():
            return {
                "root": p, "train": p / "images" / "train", "val": p / "images" / "val",
                "test": None, "names": None, "nc": None, "yaml_file": None,
            }
        if p.suffix in (".yaml", ".yml"):
            cand = p if p.is_file() else DATASETS_DIR / p.name
            if not cand.is_file():
                raise FileNotFoundError(
                    f"dataset yaml '{data}' not found (looked in {DATASETS_DIR})")
            d = load_yaml(cand.read_text())
            d["yaml_file"] = str(cand)
        else:
            raise FileNotFoundError(
                f"dataset '{data}' is neither a directory nor a yaml recipe")

    root = Path(d.get("path", "."))
    if not root.is_absolute():
        # like the reference, relative paths resolve against a datasets dir
        # (here: next to the recipe, then CWD)
        yf = d.get("yaml_file")
        base = Path(yf).parent if yf else Path.cwd()
        cand = (base / root).resolve()
        root = cand if cand.exists() else (Path.cwd() / root).resolve()

    def _split(key):
        v = d.get(key)
        if v is None:
            return None
        return root / v if not Path(v).is_absolute() else Path(v)

    names = d.get("names")
    if isinstance(names, dict):
        names = {int(k): v for k, v in names.items()}
    elif isinstance(names, list):
        names = dict(enumerate(names))
    out = {
        "root": root,
        "train": _split("train"),
        "val": _split("val") or _split("train"),
        "test": _split("test"),
        "names": names,
        "nc": d.get("nc", len(names) if names else None),
        "yaml_file": d.get("yaml_file"),
        "kpt_shape": d.get("kpt_shape"),
    }
    tr = out["train"]
    if tr is not None and not Path(tr).exists():
        raise FileNotFoundError(
            f"dataset images not found at {tr}; nothing is downloaded: place the data "
            "at the recipe's `path` (images/<split> + labels/<split>)")
    return out
