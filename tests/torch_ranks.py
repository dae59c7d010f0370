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


def _rank_main(fn, rank, world, init_method, backend, devices, args, out_path):
    import torch.distributed as dist

    from yolo_dbl_tpu_torch.parallel import distributed_init, make_mesh

    torch.set_num_threads(1)
    try:
        distributed_init(init_method, world, rank, backend)
        result = {"ok": fn(make_mesh(devices=devices, backend=backend), *args)}
    except BaseException:  # noqa: BLE001 - the parent raises it with the traceback
        result = {"error": traceback.format_exc()}
    torch.save(result, out_path)
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn, world, *args, devices="cpu", backend="gloo", timeout=600.0, workdir=None):
    """[fn(mesh, *args) of rank 0, ..., of rank world-1], each in a process of
    its own; raises with the child's traceback if a rank fails, and kills
    every rank after `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tmp = Path(tmp)
        outs = [tmp / f"rank{r}.pt" for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, f"file://{tmp / 'store'}", backend, devices,
                                   args, str(outs[r])))
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


def card_steps(model, batches, mesh=None, profile=False):
    """`Trainer` steps of `model` over the global `batches` on the card, one
    process (`mesh` None) or one rank of a mesh; TF32 off. Returns the loss
    items of each step, the first step's gradient as the optimizer took it
    (summed over the ranks) and the winners of its non-smooth maxima
    (`record_max_choices`, this rank's rows), the BatchNorm statistics after
    the steps, a checksum of every parameter, the kernels' launch counts,
    each step's ms on the host clock and each step's ms in the gradients'
    all-reduce (CUDA events), and with `profile` the device-busy share of
    one more step and its operations of most host time."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    trainer = Trainer(model, {"batch": len(batches[0]["img"])}, mesh=mesh).setup(steps_per_epoch=100)
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
    names = [n for n, _ in model.named_parameters()]
    out = dict(losses=losses, grads=dict(zip(names, first)),
               stats={k: v.detach().cpu() for k, v in model.state_dict().items()
                      if k.endswith(("_mean", "_var"))},
               checksum=checksum(p for _, p in model.named_parameters()), launches=launches,
               step_ms=step_ms, allreduce_ms=reduce_ms, max_choices=choices)
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


def check_dp_float32(one, ranks, float64=None, loss_rel=1e-4, grad_bar=1e-3, stats_bar=1e-4):
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
    can split); the readings list those leaves and the flips. Returns the
    readings and the failures ({} when all hold)."""
    g1, gd = one["grads"], ranks[0]["grads"]
    flips = max_choice_flips(one, ranks)
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
