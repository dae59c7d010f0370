"""The user-facing `YOLO` facade (port of yolo_dbl_tpu/engine/model.py).

One object holding a detection model with `train`, `val`, `predict`
(`__call__`) and `tune`. `YOLO('yolov13s_DBL.yaml', nc=3)` builds the
model from its YAML with seeded weights; `YOLO('runs/train/best.ckpt')`
loads a deploy checkpoint (utils/checkpoint.py). The model lives on
`device` (None means the card, through utils/device.py; tests pass "cpu")
and computes in `dtype` (float32, or bfloat16 with float32 parameters).

`train` mirrors the JAX facade: loaders, the Trainer with the model drawn
anew from `seed` (as JAX's `setup` does, even for a model loaded from a
checkpoint), warmup and schedule, EMA, validation of the EMA weights each
epoch, `results.csv`, `best.ckpt` (deploy), `last.ckpt` and
`epoch{N}.ckpt` (every `save_period`), `patience`, `close_mosaic`,
`multi_scale`, callbacks, and `resume`, which restores the train args, the
state and the epoch from `last.ckpt`. The JAX facade chunks its steps into
`lax.scan` dispatches, which is numerically a loop of steps; the port steps
one batch at a time. `train(data, mesh=make_mesh())` in every process of a
`torchrun` launch trains data-parallel, and with `make_mesh(n_data,
n_model)` tensor-parallel as well (engine/trainer.py): `batch` is the
global batch, each rank loads its data coordinate's rows, rank 0 alone
(with a 'model' axis, the model ranks of data coordinate 0 together)
validates, rank 0 alone writes the run directory, whose checkpoints hold
whole leaves in the one-process layout, and runs the callbacks, and every
rank returns the same history. Only detection models are ported; `track`, `export`
and `benchmark` wait for the trackers and the exporter (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..cfg import get_cfg
from ..nn.tasks import DetectionModel
from ..utils.callbacks import Callbacks
from ..utils.checkpoint import load_deploy, peek_checkpoint_meta, save_checkpoint, save_deploy
from ..utils.checks import check_imgsz
from .predictor import DetectionPredictor
from .trainer import Trainer
from .validator import DetectionValidator

NOT_PORTED = "not ported yet: it waits for the trackers and the exporter (ROADMAP Queue 1 item 6)"


class YOLO:
    """`YOLO('yolov13s_DBL.yaml')` or `YOLO('runs/train/best.ckpt')`."""

    def __init__(self, model: Union[str, Path] = "yolov13s_DBL.yaml", nc: Optional[int] = None,
                 device=None, dtype=torch.float32):
        model = str(model)
        self.ckpt_meta = None
        if model.endswith((".ckpt", ".pkl", ".bin")):
            variables, self.ckpt_meta = load_deploy(model)
            self.model = DetectionModel(self.ckpt_meta["model_yaml"], nc=self.ckpt_meta.get("nc"),
                                        device=device, dtype=dtype)
            self.model.load_state_dict({**variables["params"], **variables["batch_stats"]})
        else:
            self.model = DetectionModel(model, nc=nc, device=device, dtype=dtype)
        self.trainer: Optional[Trainer] = None
        self.callbacks = Callbacks()

    def add_callback(self, event: str, fn):
        """Register a hook; utils/callbacks.HOOKS names the events, and
        `callbacks.integrate('tensorboard' | 'jsonl', ...)` adds a sink."""
        self.callbacks.add(event, fn)

    @property
    def task(self) -> str:
        return {"Segment": "segment", "Pose": "pose", "OBB": "obb",
                "Classify": "classify"}.get(self.model.spec.layers[-1].name, "detect")

    @property
    def nc(self):
        return self.model.nc

    @property
    def names(self):
        return self.model.names

    def info(self) -> Dict:
        m = self.model
        return {"layers": len(m.spec.layers), "parameters": sum(p.numel() for p in m.parameters()),
                "strides": m.strides, "nc": m.nc, "scale": m.spec.scale}

    def _stride(self) -> int:
        return max(self.model.strides, default=1)

    # ------------------------------------------------------------------ train
    def train(self, data: Union[str, Path], mesh=None, **overrides) -> Dict:
        """Train on a YOLO-format dataset; returns {history, best_fitness,
        run_dir}. With a `mesh` (parallel/mesh.py), this process is one rank
        of a parallel run (module note); the model moves to the rank's
        device, and with a 'model' axis the trainer shards it (the facade
        then holds the tensor-parallel EMA model)."""
        from ..data.build import DataLoader
        from ..data.dataset import YOLODataset
        from ..utils import set_verbosity

        main = mesh is None or mesh.is_main
        # the ranks that validate: rank 0 alone, or under tensor parallelism
        # the model ranks of data coordinate 0, whose sharded forward is one
        validates = main or (mesh.n_model > 1 and mesh.coords["data"] == 0)
        callbacks = self.callbacks if main else Callbacks()  # rank 0 runs the callbacks
        if mesh is not None and self.model.device != mesh.device:
            self.model.to(mesh.device)
            if mesh.device.type == "cuda":
                self.model.to(memory_format=torch.channels_last)

        resume = overrides.get("resume", False)
        ckpt_path = None
        if resume:
            # the checkpoint's train args, under this call's explicit ones,
            # before the loaders and the optimizer's schedule are built
            probe = get_cfg(overrides=overrides)
            probe_dir = Path(probe.project or "runs") / (probe.name or "train")
            ckpt_path = Path(resume) if isinstance(resume, (str, Path)) else probe_dir / "last.ckpt"
            if not ckpt_path.is_file():
                raise FileNotFoundError(f"resume checkpoint not found: {ckpt_path}")
            restored = {k: v for k, v in peek_checkpoint_meta(ckpt_path)["train_args"].items()
                        if k != "resume" and hasattr(probe, k)}
            restored.update(overrides)
            overrides = restored
        cfg = get_cfg(overrides=overrides)
        set_verbosity(bool(cfg.verbose))
        callbacks.run("on_pretrain_routine_start", model=self, cfg=cfg)
        cfg.imgsz = check_imgsz(cfg.imgsz, stride=self._stride())
        train_ds = YOLODataset(data, split="train", imgsz=cfg.imgsz, single_cls=cfg.single_cls,
                               fraction=cfg.fraction, cache_images=cfg.cache)
        try:
            val_ds = YOLODataset(data, split="val", imgsz=cfg.imgsz, single_cls=cfg.single_cls,
                                 cache_images=cfg.cache)
        except FileNotFoundError:
            val_ds = train_ds
        hyp = {k: getattr(cfg, k) for k in
               ("mosaic", "mixup", "copy_paste", "copy_paste_mode", "degrees", "translate",
                "scale", "shear", "perspective", "hsv_h", "hsv_s", "hsv_v", "fliplr",
                "flipud", "bgr", "erasing")}
        workers = int(cfg.workers or 0)
        train_loader = DataLoader(train_ds, batch_size=cfg.batch, imgsz=cfg.imgsz, augment=True,
                                  hyp=hyp, seed=cfg.seed, workers=workers, mesh=mesh)
        val_loader = DataLoader(val_ds, batch_size=cfg.batch, imgsz=cfg.imgsz, augment=False,
                                shuffle=False, drop_last=False, workers=workers)

        trainer = Trainer(self.model, overrides=dict(overrides), mesh=mesh)
        trainer.setup(steps_per_epoch=max(len(train_loader), 1), seed=cfg.seed)
        self.trainer = trainer
        validator = DetectionValidator(trainer.ema_model()) if validates else None

        run_dir = None
        if resume:
            run_dir = ckpt_path.parent
        elif main:
            from ..utils.files import increment_path

            run_dir = increment_path(Path(cfg.project or "runs") / (cfg.name or "train"),
                                     exist_ok=cfg.exist_ok)
        if mesh is not None:
            run_dir = mesh.broadcast_object(run_dir)
        if main:
            run_dir.mkdir(parents=True, exist_ok=True)
        best_fitness, best_epoch, start_epoch = -1.0, -1, 0
        if resume:
            meta = trainer.restore(ckpt_path)
            best_fitness = float(meta["best_fitness"])
            best_epoch = int(meta["best_epoch"])
            start_epoch = int(meta["epoch"]) + 1
            train_loader.set_epoch(start_epoch)
        train_args = {k: v for k, v in vars(cfg).items() if k != "resume"}
        history = []
        mosaic_closed = False
        callbacks.run("on_pretrain_routine_end", model=self, cfg=cfg)
        callbacks.run("on_train_start", model=self, cfg=cfg)
        for epoch in range(start_epoch, cfg.epochs):
            callbacks.run("on_train_epoch_start", model=self, epoch=epoch)
            if cfg.close_mosaic and not mosaic_closed and epoch >= cfg.epochs - cfg.close_mosaic:
                train_loader.close_mosaic()
                mosaic_closed = True
            t0 = time.time()
            running, count = {}, 0
            if cfg.multi_scale:
                from ..data.rect import multi_scale_sizes, resize_batch, sample_scale

                ms_sizes = multi_scale_sizes(cfg.imgsz, self._stride())
                ms_rng = np.random.default_rng(cfg.seed + epoch)
            for batch in train_loader:
                batch = {k: v for k, v in batch.items() if k not in ("labels", "indices")}
                if cfg.multi_scale:  # one draw of the scale on every rank: one seeded stream
                    batch["img"] = resize_batch(batch["img"], sample_scale(ms_sizes, ms_rng))
                # in key order, as JAX's metrics pytree gives them (results.csv columns)
                for k, v in sorted(trainer.step(batch, local=True).items()):
                    running[k] = running.get(k, 0.0) + float(v)
                count += 1
            avg = {k: v / max(count, 1) for k, v in running.items()}

            val_metrics = None
            if validates:
                trainer.ema_model()  # the EMA weights with the live BatchNorm statistics
                val_metrics = validator(val_loader)
                avg.update(epoch=epoch, seconds=time.time() - t0,
                           **{f"val_{k}": v for k, v in val_metrics.items()
                              if isinstance(v, (int, float))})
            if mesh is not None:  # rank 0's validation and clock on every rank
                avg, val_metrics = mesh.broadcast_object((avg, val_metrics))
            fitness = val_metrics["fitness"]
            history.append(avg)
            if main:
                csv_path = run_dir / "results.csv"
                num_keys = [k for k in avg if isinstance(avg[k], (int, float))]
                if not csv_path.is_file():
                    csv_path.write_text(",".join(num_keys) + "\n")
                with open(csv_path, "a") as f:
                    f.write(",".join(f"{avg.get(k, float('nan')):.6g}" for k in num_keys) + "\n")
            callbacks.run("on_train_epoch_end", model=self, epoch=epoch, metrics=avg)
            callbacks.run("on_fit_epoch_end", model=self, epoch=epoch, metrics=avg)
            state = trainer.state_dict()
            if fitness > best_fitness:
                best_fitness, best_epoch = fitness, epoch
                if main:
                    save_deploy(run_dir / "best.ckpt",
                                {"params": state["ema_params"], "batch_stats": state["batch_stats"]},
                                model_yaml=self.model.yaml, nc=self.model.nc)
                callbacks.run("on_model_save", model=self, path=run_dir / "best.ckpt")
            # the full effective config, so that a bare resume=True rebuilds the run
            names = ["last.ckpt"]
            if cfg.save_period and cfg.save_period > 0 and epoch % cfg.save_period == 0:
                names.append(f"epoch{epoch}.ckpt")
            for name in names if main else ():
                save_checkpoint(run_dir / name, state, best_fitness=best_fitness,
                                train_args=train_args, metrics=val_metrics, epoch=epoch,
                                best_epoch=best_epoch)
            if cfg.patience and epoch - best_epoch >= cfg.patience:
                break
        train_loader.close()
        val_loader.close()
        if cfg.plots and history and main:
            from ..utils.plotting import plot_results

            try:
                plot_results(history, save_path=str(run_dir / "results.png"))
            except Exception:
                pass  # best effort: matplotlib may be missing or headless-broken
        if mesh is not None:
            mesh.barrier()  # the run directory is whole when any rank returns
        # from here on the facade serves the EMA weights, as JAX's does
        self.model = trainer.ema_model()
        out = {"history": history, "best_fitness": best_fitness, "run_dir": str(run_dir)}
        callbacks.run("on_train_end", model=self, metrics=history[-1] if history else {})
        callbacks.run("teardown", model=self)
        return out

    # -------------------------------------------------------------------- val
    def val(self, data: Union[str, Path], split: str = "val", batch: int = 16, imgsz: int = 640,
            conf: float = 0.001, iou: float = 0.7, coco_stats: bool = True, **kw) -> Dict:
        from ..data.build import DataLoader
        from ..data.dataset import YOLODataset

        imgsz = check_imgsz(imgsz, stride=self._stride())
        ds = YOLODataset(data, split=split, imgsz=imgsz)
        loader = DataLoader(ds, batch_size=batch, imgsz=imgsz, augment=False, shuffle=False,
                            drop_last=False)
        validator = DetectionValidator(self.model, conf=conf, iou=iou, use_coco_stats=coco_stats,
                                       save_json=bool(kw.get("save_json", False)),
                                       save_dir=kw.get("save_dir"))
        self.callbacks.run("on_val_start", model=self)
        metrics = validator(loader)
        self.callbacks.run("on_val_end", model=self, metrics=metrics)
        loader.close()
        return metrics

    # ---------------------------------------------------------------- predict
    def predict(self, source, conf: float = 0.25, iou: float = 0.45, imgsz: int = 640, **kw):
        """One `Results` per image of `source` (engine/predictor.py);
        `agnostic_nms`, `classes`, `device_preprocess` and `max_det` go to
        the predictor."""
        imgsz = check_imgsz(imgsz, stride=self._stride())
        extra = {k: kw[k] for k in ("agnostic_nms", "classes", "device_preprocess", "max_det")
                 if k in kw}
        predictor = DetectionPredictor(self.model, conf=conf, iou=iou, imgsz=imgsz, **extra)
        self.callbacks.run("on_predict_start", model=self)
        results = predictor.predict(source)
        self.callbacks.run("on_predict_end", model=self, results=results)
        return results

    __call__ = predict

    def track(self, *args, **kwargs):
        raise NotImplementedError(f"YOLO.track is {NOT_PORTED}")

    def export(self, *args, **kwargs):
        raise NotImplementedError(f"YOLO.export is {NOT_PORTED}")

    def benchmark(self, *args, **kwargs):
        raise NotImplementedError(f"YOLO.benchmark is {NOT_PORTED}")

    # ------------------------------------------------------------------- tune
    def tune(self, data: Union[str, Path], iterations: int = 10, epochs: int = 3,
             space: Optional[Dict] = None, **kw) -> Dict:
        """Mutation-evolution hyperparameter search over short trainings (engine/tuner.py)."""
        from .tuner import Tuner

        def train_fn(hyp: Dict) -> float:
            return float(self.train(data, epochs=epochs, **{**kw, **hyp})["best_fitness"])

        tuner = Tuner(train_fn, space=space)
        best_hyp, best_fitness = tuner(iterations=iterations)
        return {"best_hyp": best_hyp, "best_fitness": best_fitness}
