"""Preemption-safe training: a supervisor that survives the death of its
trainer (port of yolo_dbl_tpu/utils/elastic.py).

Training runs in a CHILD process; the supervisor watches its exit code and,
on any abnormal death (SIGTERM from a preemption, SIGKILL from the OOM
killer, a CUDA fault), relaunches it from ``<run_dir>/last.ckpt`` through
the facade's resume path (engine/model.py ``train(resume=True)``), with
bounded retries and a fixed pause between attempts.

One departure from the JAX supervisor: the child trains with
``exist_ok=True``. The supervisor makes ``<run_dir>`` before the first
child starts, so a child without it would train in ``<run_dir>2`` (the
facade numbers an existing run directory), and every relaunch would start
afresh in the next number instead of resuming (ROADMAP Queue 3).

The train loop writes the checkpoint every epoch, so a death loses at most
the epoch in flight: ``last.ckpt`` holds the whole training state
(parameters, optimizer state, EMA, BatchNorm statistics, epoch,
best_fitness, train args).

Usage::

    from yolo_dbl_tpu_torch.utils.elastic import elastic_train
    out = elastic_train("yolov13s_DBL.yaml", "datasets/tea", nc=3,
                        epochs=300, max_restarts=5)

Child entry point: ``python -m yolo_dbl_tpu_torch.utils.elastic <spec.json>``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from . import LOGGER


def _run_dir(train_kwargs: Dict) -> Path:
    return Path(train_kwargs.get("project") or "runs") / (train_kwargs.get("name") or "train")


def elastic_train(model: str, data, nc: Optional[int] = None, device: Optional[str] = None,
                  max_restarts: int = 3, backoff_s: float = 2.0,
                  env: Optional[Dict[str, str]] = None, _crash_after_epoch: Optional[int] = None,
                  **train_kwargs) -> Dict:
    """Supervise ``YOLO(model, nc=nc, device=device).train(data,
    **train_kwargs)`` in a child process, resuming from last.ckpt after an
    abnormal exit.

    Returns {attempts, restarts, run_dir, returncode}. Raises RuntimeError
    when the child fails more than ``max_restarts`` times.

    ``_crash_after_epoch`` is the tests' fault injector: the FIRST child
    kills itself (os._exit) at the end of that epoch, before its
    checkpoint is written, as a preemption mid-run would.
    """
    run_dir = _run_dir(train_kwargs)
    run_dir.mkdir(parents=True, exist_ok=True)
    spec_path = run_dir / "elastic_spec.json"
    marker = run_dir / "elastic_crash_done"  # the injector fires once only

    attempts = 0
    while True:
        attempts += 1
        # exist_ok: the child trains in this run directory, which exists by
        # now, and not in a numbered sibling (name2, name3, ...), so that a
        # relaunch finds its last.ckpt
        spec = {"model": model, "nc": nc, "device": device, "data": str(data),
                "train": {**train_kwargs, "exist_ok": True}}
        if (run_dir / "last.ckpt").is_file():
            spec["train"]["resume"] = True
        if _crash_after_epoch is not None and not marker.exists():
            spec["crash_after_epoch"] = int(_crash_after_epoch)
            spec["crash_marker"] = str(marker)
        spec_path.write_text(json.dumps(spec))

        LOGGER.info("elastic: attempt %d/%d (%s)", attempts, max_restarts + 1,
                    "resume" if spec["train"].get("resume") else "fresh")
        # the child must find this package whatever the caller's working
        # directory: the install root goes first on PYTHONPATH
        pkg_root = str(Path(__file__).resolve().parents[2])
        child_env = {**os.environ, **(env or {})}
        child_env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + ([child_env["PYTHONPATH"]] if child_env.get("PYTHONPATH") else []))
        rc = subprocess.call([sys.executable, "-m", "yolo_dbl_tpu_torch.utils.elastic",
                              str(spec_path)], env=child_env)
        if rc == 0:
            return {"attempts": attempts, "restarts": attempts - 1, "run_dir": str(run_dir),
                    "returncode": 0}
        if attempts > max_restarts:
            raise RuntimeError(f"elastic: child failed {attempts} times (last rc={rc}); "
                               f"giving up — inspect {run_dir}")
        LOGGER.warning("elastic: child died rc=%d — restarting in %.1fs (%s available)", rc,
                       backoff_s, "last.ckpt" if (run_dir / "last.ckpt").is_file()
                       else "no checkpoint")
        time.sleep(backoff_s)


def _child(spec: Dict) -> None:
    """The child process: build the facade model and train as the spec says."""
    from ..engine.model import YOLO

    kw = {"nc": spec["nc"]} if spec.get("nc") is not None else {}
    y = YOLO(spec["model"], device=spec.get("device"), **kw)

    crash_epoch = spec.get("crash_after_epoch")
    if crash_epoch is not None:
        marker = Path(spec["crash_marker"])

        def _preempt(epoch=None, **_):
            if epoch == crash_epoch and not marker.exists():
                marker.write_text("crashed")
                os._exit(17)  # a hard death, as SIGKILL: no teardown runs

        # on_train_epoch_end fires after epoch-1's last.ckpt exists and
        # before this epoch's is written, so the relaunch trains the crashed
        # epoch again: the worst case the supervisor promises
        y.add_callback("on_train_epoch_end", _preempt)

    y.train(spec["data"], **spec["train"])


if __name__ == "__main__":
    _child(json.loads(Path(sys.argv[1]).read_text()))
