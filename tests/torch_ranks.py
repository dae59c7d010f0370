"""Rank bodies of the port's data-parallel tests, and their launcher.

`launch(fn, world, *args)` runs `fn(mesh, *args)` in `world` spawned
processes joined by one torch.distributed group (Gloo on the CPU through a
`file://` store, no ports), and returns each rank's result in rank order.
This module imports no JAX: a child imports it to find its body. Each child
takes one torch thread (the test lane already runs several workers of 8
threads each).
"""

from __future__ import annotations

import hashlib
import multiprocessing
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch


def _rank_main(fn, rank, world, init_method, backend, devices, args, out_path, n_model=1):
    import torch.distributed as dist

    from yolo_dbl_tpu_torch.parallel import distributed_init, make_mesh

    torch.set_num_threads(1)
    try:
        distributed_init(init_method, world, rank, backend)
        result = {"ok": fn(make_mesh(n_model=n_model, devices=devices, backend=backend), *args)}
    except BaseException:  # noqa: BLE001 - the parent raises it with the traceback
        result = {"error": traceback.format_exc()}
    torch.save(result, out_path)
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn, world, *args, devices="cpu", backend="gloo", timeout=600.0, workdir=None,
           n_model=1):
    """[fn(mesh, *args) of rank 0, ..., of rank world-1], each in a process of
    its own on a mesh of world / n_model x n_model; raises with the child's
    traceback if a rank fails, and kills every rank after `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tmp = Path(tmp)
        outs = [tmp / f"rank{r}.pt" for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, f"file://{tmp / 'store'}", backend, devices,
                                   args, str(outs[r]), n_model))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still ran after {timeout} s")
        results = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if not out.is_file():
                raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no result")
            res = torch.load(out, weights_only=False)  # written by our own child
            if "error" in res:
                raise RuntimeError(f"rank {r} of {world} failed:\n{res['error']}")
            results.append(res["ok"])
        return results


def checksum(tensors) -> str:
    """sha256 of the bytes of `tensors`, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _numpy(t):
    """A float32 numpy copy (never a view of the live tensor)."""
    return t.detach().float().cpu().numpy().copy()


# ------------------------------------------------------------------ bodies


def batch_norm_rank(mesh, x, weight, bias, dy, dtype, momentum, eps):
    """This rank's rows of a cross-rank BatchNorm over NHWC `x` and the
    gradient of sum(y * dy): y, dx (its rows), the running statistics, and
    this rank's parts of the weight's and bias's gradients."""
    from yolo_dbl_tpu_torch.nn.common import BatchNorm, cross_rank
    from yolo_dbl_tpu_torch.parallel import local_rows

    rows = local_rows(mesh, x.shape[0])
    bn = BatchNorm(x.shape[-1], eps=eps, momentum=momentum).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x[rows]).permute(0, 3, 1, 2).to(getattr(torch, dtype)).requires_grad_()
    with cross_rank(bn, mesh):
        y = bn(xt)
    loss = (y.float() * torch.from_numpy(dy[rows]).permute(0, 3, 1, 2)).sum()
    dx, dw, db = torch.autograd.grad(loss, [xt, bn.weight, bn.bias])
    return dict(y=_numpy(y.permute(0, 2, 3, 1)), y_dtype=str(y.dtype),
                dx=_numpy(dx.permute(0, 2, 3, 1)), mean=_numpy(bn.running_mean),
                var=_numpy(bn.running_var), dw=_numpy(dw), db=_numpy(db))


def detection_loss_rank(mesh, feats, batch, strides, nc):
    """This rank's share of the detection loss of the global batch (total and
    items) and its gradient with respect to this rank's rows of `feats`."""
    from yolo_dbl_tpu_torch.losses.detection import detection_loss
    from yolo_dbl_tpu_torch.parallel import local_rows, shard_batch

    rows = local_rows(mesh, feats[0].shape[0])
    fs = [torch.from_numpy(f[rows]).requires_grad_() for f in feats]
    total, items = detection_loss(fs, shard_batch(mesh, batch), strides, nc, mesh=mesh)
    grads = torch.autograd.grad(total, fs)
    return dict(total=float(total), items=[float(v) for v in items], grads=[_numpy(g) for g in grads])


def trainer_rank(mesh, cfg, nc, variables, overrides, spe, batches, noise_seed=None):
    """`Trainer(mesh=...)` steps over the global `batches` from JAX
    `variables` (dropout off). With `noise_seed`, ranks other than 0 perturb
    their weights before `setup`, whose broadcast must undo it. Returns the
    losses, rank 0's parameters before and after each step, and the final
    state (parameters, BatchNorm statistics, EMA) with a checksum of every
    parameter, buffer and EMA tensor."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.engine.trainer import Trainer
    from yolo_dbl_tpu_torch.utils.convert import load_jax_variables

    model = DetectionModel(cfg, nc=nc, device="cpu")
    load_jax_variables(model, variables)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    if noise_seed is not None and mesh.rank:
        gen = torch.Generator().manual_seed(noise_seed + mesh.rank)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=gen), alpha=0.1)
    trainer = Trainer(model, overrides, mesh=mesh).setup(spe)
    params = [{n: _numpy(p) for n, p in model.named_parameters()}]
    losses = []
    for b in batches:
        losses.append({k: float(v) for k, v in trainer.step(b).items()})
        params.append({n: _numpy(p) for n, p in model.named_parameters()})
    state = trainer.state_dict()
    sums = checksum([*state["params"].values(), *state["batch_stats"].values(), *trainer.ema])
    keep = mesh.rank == 0
    return dict(losses=losses, params=params if keep else None, checksum=sums,
                batch_stats={k: _numpy(v) for k, v in state["batch_stats"].items()} if keep else None,
                ema=[_numpy(e) for e in trainer.ema] if keep else None,
                steps=trainer.steps, training=model.training)


def facade_rank(mesh, data, runs, kw, resume_after=None):
    """`YOLO('yolov8n.yaml', nc=3).train(data, mesh=mesh, ...)` on the CPU in
    `runs`/dp: the whole run, or `resume_after` epochs and then a resume to
    the end. Returns the history (each call's), the run directory, the
    callbacks this rank ran, and its calls of the checkpoint writers."""
    from yolo_dbl_tpu_torch.engine import model as facade

    written = []
    for name in ("save_checkpoint", "save_deploy"):
        real = getattr(facade, name)

        def record(path, *a, _real=real, **k):
            written.append(Path(path).name)
            return _real(path, *a, **k)

        setattr(facade, name, record)
    events = []

    def yolo():
        y = facade.YOLO("yolov8n.yaml", nc=3, device="cpu")
        y.add_callback("on_train_epoch_end", lambda epoch=None, **_: events.append(epoch))
        return y

    if resume_after is None:
        out = yolo().train(data, mesh=mesh, project=str(runs), name="dp", **kw)
        history = out["history"]
    else:
        first = yolo().train(data, mesh=mesh, project=str(runs), name="dp",
                             **{**kw, "epochs": resume_after})
        out = yolo().train(data, mesh=mesh, project=str(runs), name="dp", resume=True, **kw)
        history = first["history"] + out["history"]
    return dict(history=history, run_dir=out["run_dir"], events=events, written=written,
                best_fitness=out["best_fitness"])


# ------------------------------------------------ the card: the dp phase (b), (c)


def record_max_choices(model):
    """Forward hooks recording, at each non-smooth max of YOLO-DBL's forward
    (LSKblock's max over channels, AdaHyperedgeGen's max over nodes), which
    element won, by module name: a float32 near-tie there decides which
    element the gradient goes to. Returns (choices, remove)."""
    from yolo_dbl_tpu_torch.nn.blocks import AdaHyperedgeGen, LSKblock

    choices, handles = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, LSKblock):
            parts = {}

            def keep(key, parts=parts):
                return lambda m, args, out: parts.__setitem__(key, out.detach())

            def done(m, args, out, name=name, parts=parts):
                choices[name] = torch.cat([parts["a1"], parts["a2"]], 1).argmax(1).cpu()

            handles += [mod.conv1.register_forward_hook(keep("a1")),
                        mod.conv2.register_forward_hook(keep("a2")),
                        mod.register_forward_hook(done)]
        elif isinstance(mod, AdaHyperedgeGen):
            def pre(m, args, name=name):
                choices[name] = args[0].detach().argmax(1).cpu()

            handles.append(mod.register_forward_pre_hook(pre))

    def remove():
        for h in handles:
            h.remove()

    return choices, remove


def card_steps(model, batches, mesh=None, profile=False, pair=True):
    """`Trainer` steps of `model` over the global `batches` on the card, one
    process (`mesh` None) or one rank of a mesh; TF32 off. Returns the loss
    items of each step, the first step's gradient as the optimizer took it
    (summed over the ranks) and the winners of its non-smooth maxima
    (`record_max_choices`, this rank's rows), the BatchNorm statistics after
    the steps, a checksum of every parameter, the kernels' launch counts,
    each step's ms on the host clock and each step's ms in the gradients'
    all-reduce (CUDA events), and with `profile` the device-busy share of
    one more step and its operations of most host time. Under a mesh with
    a 'model' axis (the Trainer shards the model; `pair` as `Trainer.pair`)
    the gradients and the checksum are of whole leaves (gathered), and the
    results add this rank's bytes of parameters, EMA and moments against
    the whole ones, the pairs, and the collectives of the steps by kind
    ({"<op>:<axis>": [calls, bytes]})."""

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    whole_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    trainer = Trainer(model, {"batch": len(batches[0]["img"])}, mesh=mesh)
    trainer.pair = pair
    trainer.setup(steps_per_epoch=100)
    tp = trainer.tp
    first, reduce_ms = [], []
    step = trainer.optimizer.step

    def keep_first(grads):
        if not first:
            first.extend(g.detach().cpu() for g in grads)
        return step(grads)

    trainer.optimizer.step = keep_first
    if mesh is not None:
        reduce = trainer.all_reduce_grads

        def timed(grads):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = reduce(grads)
            end.record()
            end.synchronize()
            reduce_ms.append(start.elapsed_time(end))
            return out

        trainer.all_reduce_grads = timed
    torch.cuda.synchronize()
    kernels.reset_launches()
    if mesh is not None:
        mesh.collectives.clear()
    losses, step_ms = [], []
    choices, remove = record_max_choices(model)
    for b in batches:
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(b).items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics)
        remove()
    launches = {k: v for k, v in kernels.launches.items() if v}
    steps_collectives = {k: list(v) for k, v in (mesh.collectives if mesh else {}).items()}
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    if tp is not None:  # whole leaves: a collective on every rank
        first = [tp.gather_leaf(n, g) for n, g in zip(names, first)]
        params = [tp.gather_leaf(n, p) for n, p in zip(names, params)]
    out = dict(losses=losses, grads=dict(zip(names, first)),
               stats={k: v.detach().cpu() for k, v in model.state_dict().items()
                      if k.endswith(("_mean", "_var"))},
               checksum=checksum(params), launches=launches,
               step_ms=step_ms, allreduce_ms=reduce_ms, max_choices=choices,
               collectives=steps_collectives)
    if tp is not None:
        opt = trainer.optimizer.state_dict()
        moments = [t for k in ("trace", "mu", "nu", "acc") for t in (opt.get(k) or [])]
        per_copy = 2 + len(moments) // len(names)
        out.update(local_bytes=sum(t.numel() * t.element_size()
                                   for t in [*trainer._params, *trainer.ema, *moments]),
                   whole_bytes=per_copy * whole_bytes, pairs=tp.pairs, sharded=len(tp.dims))
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as trace

        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.step(batches[-1])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)
                        and not e.key.startswith("ProfilerStep")) / 1e3
        host = sorted(((e.key[:60], e.self_cpu_time_total / 1e3, e.count) for e in events
                       if e.device_type == DeviceType.CPU), key=lambda t: -t[1])[:8]
        out.update(profiled_step_ms=wall, device_ms=device_ms, device_busy_share=device_ms / wall,
                   top_host_ms=host)
    return out


def dp_card_rank(mesh, cfg, nc, dtypes, state_path, batches, profile=False):
    """`card_steps` on this rank of the mesh, for each compute type in
    `dtypes`, from the weights in `state_path`: {dtype: results}, the
    first-step gradients on rank 0 only."""
    from yolo_dbl_tpu_torch import DetectionModel

    out = {}
    for dtype in dtypes:
        model = DetectionModel(cfg, nc=nc, device=mesh.device, dtype=getattr(torch, dtype))
        model.load_state_dict(torch.load(state_path, map_location=mesh.device, weights_only=True))
        res = card_steps(model, batches, mesh, profile)
        if mesh.rank:
            res["grads"] = None
        out[dtype] = res
        del model
        torch.cuda.empty_cache()
    return out


def max_choice_flips(one, ranks):
    """{module name: positions whose max went to another element} between
    the rank run (its ranks' rows joined in rank order) and the one-process
    run, at the first step's non-smooth maxima."""
    flips = {}
    for name, want in one["max_choices"].items():
        got = torch.cat([r["max_choices"][name] for r in ranks])
        flips[name] = int((got != want).sum())
    return {k: v for k, v in flips.items() if v}


def check_dp_float32(one, ranks, float64=None, loss_rel=1e-4, grad_bar=1e-3, stats_bar=1e-4,
                     n_model=1):
    """The dp phase's float32 bars, a rank run (`ranks`: card_steps of each
    rank) against the one-process run `one` on the same weights and global
    batches: loss items of every step within `loss_rel`; the first step's
    gradient of every leaf within `grad_bar` of its largest |g|, or, for a
    leaf that misses that, both runs against `float64()` (the float64
    {name: gradient}, computed only then) within max(grad_bar of its largest,
    4x the one-process run's distance) plus 1e-10 of the model's largest;
    BatchNorm statistics after the steps within `stats_bar` of 1 + |s|; the
    parameters bit for bit equal on every rank. A leaf that misses both is
    excused only inside a module whose max went to another element in the
    two runs (`max_choice_flips`: a float32 near-tie resolved the other way
    sends that position's gradient elsewhere, a jump no float64 reference
    can split); the readings list those leaves and the flips. With a
    'model' axis of `n_model` ranks, every n_model-th rank holds a data
    coordinate's rows. Returns the readings and the failures ({} when all
    hold)."""
    g1, gd = one["grads"], ranks[0]["grads"]
    flips = max_choice_flips(one, ranks[::n_model])
    loss_err = max(abs(d[k] - o[k]) / max(abs(o[k]), 1e-30)
                   for r in ranks for d, o in zip(r["losses"], one["losses"]) for k in o)
    rel = {n: float((gd[n] - g1[n]).abs().max() / max(float(g1[n].abs().max()), 1e-30))
           for n in g1}
    g_max = max(float(g.abs().max()) for g in g1.values())
    missed = {n: e for n, e in rel.items()
              if float((gd[n] - g1[n]).abs().max()) > grad_bar * float(g1[n].abs().max())
              + 1e-10 * g_max}
    against64 = {}
    if missed:
        g64 = float64()
        g_max64 = max(float(g.abs().max()) for g in g64.values())
        for n in missed:
            ref = g64[n]
            dp, op = (float((g[n].double() - ref).abs().max()) for g in (gd, g1))
            tol = max(grad_bar * float(ref.abs().max()), 4 * op) + 1e-10 * g_max64
            against64[n] = dict(dp=dp, one_process=op, tol=tol)
    stats_err = max(float(((r["stats"][k] - one["stats"][k]).abs()
                           / (1 + one["stats"][k].abs())).max())
                    for r in ranks for k in one["stats"])
    sums = {r["checksum"] for r in ranks}
    failures = {}
    if loss_err > loss_rel:
        failures["loss_rel"] = loss_err
    beyond = {n: e for n, e in against64.items() if e["dp"] > e["tol"]}
    excused = {n: e for n, e in beyond.items() if any(n.startswith(m + ".") for m in flips)}
    bad = {n: e for n, e in beyond.items() if n not in excused}
    if bad:
        failures["grads_vs_float64"] = bad
    if stats_err > stats_bar:
        failures["bn_stats_rel"] = stats_err
    if len(sums) != 1:
        failures["param_checksums"] = sorted(sums)
    readings = dict(loss_rel=loss_err, grad_rel_of_leaf_max=max(rel.values()),
                    worst_leaves=sorted(rel.items(), key=lambda kv: -kv[1])[:3],
                    leaves_past_bar=len(missed), leaves_vs_float64=against64,
                    max_choice_flips=flips, excused_by_flips=sorted(excused),
                    bn_stats_rel=stats_err, param_checksums_equal=len(sums) == 1)
    return readings, failures


def check_dp_bf16(f32, one16, dp16, fed, n_fed):
    """The dp phase's bfloat16 bars: with the one-process float32 card step
    `f32` (TF32 off) as the yardstick, the rank run's first-step loss items
    and the gradients of the leaves whose names hold `fed` (`n_fed` of them:
    those only a kernel's backward feeds) within 4x the one-process bfloat16
    step's distance from it, plus 1e-10 of the model's largest |g|."""
    g_max = max(float(g.abs().max()) for g in f32["grads"].values())
    loss = {k: dict(dp=abs(dp16["losses"][0][k] - v), one_process=abs(one16["losses"][0][k] - v))
            for k, v in f32["losses"][0].items()}
    leaves = {n: dict(dp=float((dp16["grads"][n] - g).abs().max()),
                      one_process=float((one16["grads"][n] - g).abs().max()),
                      leaf_max=float(g.abs().max()))
              for n, g in f32["grads"].items() if fed in n}
    failures = {}
    if len(leaves) != n_fed:
        failures["kernel_fed_leaves"] = sorted(leaves)
    bad = {n: e for n, e in leaves.items() if e["dp"] > 4 * e["one_process"] + 1e-10 * g_max}
    if bad:
        failures["leaves"] = bad
    bad = {k: e for k, e in loss.items() if e["dp"] > 4 * e["one_process"]}
    if bad:
        failures["loss"] = bad
    return dict(loss_distance_from_f32=loss, kernel_fed_leaves=leaves), failures


def all_reduce_rank(mesh):
    """One all-reduce of a one on this rank's device: the world size."""
    return float(mesh.all_reduce(torch.ones(1, device=mesh.device)))


# ------------------------------------------------ tensor and spatial parallelism


def _model_from(mesh, cfg, nc, weights, dtype="float32"):
    """DetectionModel `cfg` on this rank's device with `weights` (JAX
    variables as nested numpy dicts, or a state_dict) and dropout off."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.utils.convert import load_jax_variables

    model = DetectionModel(cfg, nc=nc, device=mesh.device, dtype=getattr(torch, dtype))
    if "params" in weights:
        load_jax_variables(model, weights)
    else:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def tp_predict_rank(mesh, cfg, nc, weights, x, pairs=(True,), dtype="float32"):
    """`DetectionModel.predict` of `shard_variables(model, mesh, pair=...)`
    on the NHWC images `x` (this rank's data rows), for each setting in
    `pairs`: {pair: the prediction, the pairs, this rank's parameter bytes
    and the collectives of the predict}."""
    from yolo_dbl_tpu_torch.parallel import local_rows, shard_variables

    out = {}
    for pair in pairs:
        model = _model_from(mesh, cfg, nc, weights, dtype)
        shard_variables(model, mesh, pair=pair)
        mesh.collectives.clear()
        pred = model.predict(torch.as_tensor(x[local_rows(mesh, len(x))]).to(mesh.device))
        out[pair] = dict(pred=_numpy(pred), pairs=model.tp.pairs,
                         param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
                         collectives={k: list(v) for k, v in mesh.collectives.items()})
    return out


def sp_predict_rank(mesh, cfg, nc, weights, x, dtype="float32"):
    """`DetectionModel.predict` under `spatial(model, mesh)` on the NHWC
    images `x` (this rank's data rows; the context takes the model
    coordinate's image rows): the prediction and the halo and gather bytes."""
    from yolo_dbl_tpu_torch.parallel import local_rows
    from yolo_dbl_tpu_torch.parallel.spatial import spatial

    model = _model_from(mesh, cfg, nc, weights, dtype)
    with spatial(model, mesh) as sp:
        pred = model.predict(torch.as_tensor(x[local_rows(mesh, len(x))]).to(mesh.device))
    return dict(pred=_numpy(pred), halo_bytes=sp.halo_bytes, gather_bytes=sp.gather_bytes)


def tp_trainer_rank(mesh, cfg, nc, weights, overrides, spe, batches, ckpt=None, ckpt_after=1,
                    restore=None):
    """`Trainer(mesh=...)` steps over the global `batches` on a mesh with a
    'model' axis from `weights` (dropout off), or from the checkpoint
    `restore` after `setup`. Returns the losses, rank 0's whole parameters
    (gathered, `state_dict()`) before and after each step, its final whole
    state, this rank's bytes of parameters, EMA and moments, the specs'
    count of them, and a checksum of this rank's replicated leaves
    (parameters, EMA, moments) and statistics; with `ckpt`, rank 0 writes
    the state after `ckpt_after` steps there (utils/checkpoint.py)."""
    from yolo_dbl_tpu_torch.engine.trainer import Trainer
    from yolo_dbl_tpu_torch.utils.checkpoint import save_checkpoint

    model = _model_from(mesh, cfg, nc, weights)
    whole = {n: p.numel() * p.element_size() for n, p in model.named_parameters()}
    trainer = Trainer(model, overrides, mesh=mesh).setup(spe)
    if restore is not None:
        trainer.restore(restore)
    tp = trainer.tp
    keep = mesh.rank == 0

    def params():
        state = trainer.state_dict()
        return {n: _numpy(p) for n, p in state["params"].items()} if keep else None

    trace = [params()]
    losses = []
    for i, b in enumerate(batches):
        losses.append({k: float(v) for k, v in trainer.step(b).items()})
        trace.append(params())
        if ckpt is not None and i + 1 == ckpt_after:
            state = trainer.state_dict()  # every rank gathers; rank 0 writes
            if keep:
                save_checkpoint(ckpt, state, epoch=0)
    state = trainer.state_dict()
    names = [n for n, _ in model.named_parameters()]
    opt = trainer.optimizer.state_dict()
    moments = [t for k in ("trace", "mu", "nu", "acc") for t in (opt.get(k) or [])]
    per_copy = 1 + 1 + len(moments) // len(names)  # parameters, EMA, each moment
    local = sum(t.numel() * t.element_size()
                for t in [*trainer._params, *trainer.ema, *moments])
    want = per_copy * sum(b // (mesh.n_model if n in tp.dims else 1) for n, b in whole.items())
    replicated = [i for i, n in enumerate(names) if n not in tp.dims]
    sums = checksum([*(trainer._params[i] for i in replicated), *(trainer.ema[i] for i in replicated),
                     *(m for k in ("trace", "mu", "nu") for j, m in enumerate(opt.get(k) or [])
                       if j in replicated),
                     *state["batch_stats"].values()])
    return dict(losses=losses, params=trace, checksum=sums, local_bytes=local, spec_bytes=want,
                whole_bytes=per_copy * sum(whole.values()), sharded=len(tp.dims),
                pairs=tp.pairs, steps=trainer.steps, training=model.training,
                batch_stats={k: _numpy(v) for k, v in state["batch_stats"].items()} if keep else None,
                ema={n: _numpy(e) for n, e in state["ema_params"].items()} if keep else None,
                opt={k: [_numpy(t) for t in v] for k, v in state["opt_state"].items()
                     if isinstance(v, list)} if keep else None)


def mesh_rank(mesh):
    """This rank's view of a two-axis mesh: coordinates, the sums of a one
    over each axis and the world, its model row's ranks gathered, its rows
    of 8 global rows, and the sample ids of its first `MultiHostLoader`
    batch (global batch 8 of 16 samples)."""
    from yolo_dbl_tpu_torch.parallel import MultiHostLoader, local_rows

    one = lambda: torch.ones(1, device=mesh.device)  # noqa: E731
    ds = [{"y": np.int32(i)} for i in range(16)]
    first = next(iter(MultiHostLoader(ds, global_batch=8, mesh=mesh, seed=0)))
    rank = torch.tensor([float(mesh.rank)], device=mesh.device)
    world = one()
    torch.distributed.all_reduce(world)
    return dict(coords=mesh.coords, shape=mesh.shape, sum_data=float(mesh.all_reduce(one())),
                sum_model=float(mesh.all_reduce(one(), axis="model")), sum_world=float(world),
                gather_model=[int(v) for v in mesh.all_gather(rank, axis="model")],
                rows=list(range(8))[local_rows(mesh, 8)], loader=first["y"].tolist())


# ------------------------------------------------ the card: the tp and sp phases


def _busy(fn):
    """(wall ms, device ms, device-busy share) of one call of fn on the card
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and not e.key.startswith("ProfilerStep")) / 1e3
    return wall, device, device / wall


def _serve(model, frames, imgsz, requests, out_dtype, mesh, sp=None):
    """Requests of the u8 `frames` through DetectionPredictor (K1, the
    forward, the decode, NMS) on the card: each request's ms, the kernels'
    launches and the collectives a request, the device-busy share of one
    more request, the boxes kept per image and the decode of the K1 batch
    (float32, on the CPU)."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    pred = DetectionPredictor(model, conf=0.25, iou=0.45, max_det=300, imgsz=imgsz)
    pred(frames)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    mesh.collectives.clear()
    halo0 = (sp.halo_bytes, sp.gather_bytes) if sp is not None else (0, 0)
    ms, kept = [], None
    for _ in range(requests):
        t0 = time.perf_counter()
        out = pred(frames)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        kept = [len(o) for o in out]
    launches = {k: v for k, v in kernels.launches.items() if v}
    per_request = {k: [v[0] / requests, v[1] / requests]
                   for k, v in mesh.collectives.items()}
    res = dict(request_ms=ms, launches=launches, collectives_per_request=per_request, kept=kept)
    if sp is not None:
        res.update(halo_bytes_per_request=(sp.halo_bytes - halo0[0]) / requests,
                   gather_bytes_per_request=(sp.gather_bytes - halo0[1]) / requests)
    wall, device, share = _busy(lambda: pred(frames))
    res.update(profiled_request_ms=wall, device_ms=device, device_busy_share=share)
    u8 = torch.from_numpy(frames).to(model.device)
    res["decode"] = model.predict(letterbox_normalize(u8, (imgsz, imgsz),
                                                      out_dtype=out_dtype)).float().cpu()
    return res


def tp_card_rank(mesh, cfg, nc, state_path, batches, frames, imgsz, requests, serve=True,
                 serve_path=None):
    """The tp phase on this rank of a mesh with a 'model' axis: `card_steps`
    of the Trainer (which shards the model; float32, TF32 off, a profiled
    step) from the weights in `state_path`, the collectives of one more
    step with the pairing off, and with `serve` requests of the u8 `frames`
    through a model (weights in `serve_path`, else `state_path`) sharded by
    `shard_variables`, in float32 and bfloat16 (`_serve`); the gradients
    and decodes on rank 0 only."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.parallel import shard_variables

    def fresh(dtype=torch.float32, path=state_path):
        model = DetectionModel(cfg, nc=nc, device=mesh.device, dtype=dtype)
        model.load_state_dict(torch.load(path, map_location=mesh.device, weights_only=True))
        return model

    out = {"train": card_steps(fresh(), batches, mesh, profile=True)}
    torch.cuda.empty_cache()
    out["unpaired"] = card_steps(fresh(), batches[:1], mesh, pair=False)["collectives"]
    torch.cuda.empty_cache()
    if serve:
        for dtype in (torch.float32, torch.bfloat16):
            with torch.no_grad():
                model = shard_variables(fresh(dtype, serve_path or state_path).eval(), mesh)
            res = _serve(model, frames, imgsz, requests, dtype, mesh)
            res["pairs"] = len(model.tp.pairs)
            out[str(dtype).split(".")[-1]] = res
            del model
            torch.cuda.empty_cache()
    if mesh.rank:
        out["train"]["grads"] = None
        for k in ("float32", "bfloat16"):
            if k in out:
                out[k]["decode"] = None
    return out


def sp_card_rank(mesh, cfg, nc, state_path, frames, imgsz, requests):
    """The sp phase on this rank: requests of the u8 `frames` through a
    float32 model inside `spatial(model, mesh)` (`_serve`, with the halo and
    gather bytes a request); the decode on rank 0 only."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.parallel.spatial import spatial

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    model = DetectionModel(cfg, nc=nc, device=mesh.device)
    model.load_state_dict(torch.load(state_path, map_location=mesh.device, weights_only=True))
    with spatial(model, mesh) as sp:
        res = _serve(model, frames, imgsz, requests, torch.float32, mesh, sp)
    if mesh.rank:
        res["decode"] = None
    return res
