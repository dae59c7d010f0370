#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (yolo_dbl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build  - compile every CUDA kernel of the main path from csrc/ (one nvcc
              per source, all started together);
  2. k1     - letterbox kernel vs its plain PyTorch version at 8x512x768 -> 640^2;
  3. k2     - DySample sampler kernel vs its plain version at the three
              YOLO-DBL-s DySample sites, both padding modes;
  4. main   - YOLO-DBL-s (nc=3, 640, f32, seeded random weights, FullPAD gates
              0.5, Detect class biases 0) serving requests of 8 distinct uint8
              512x768 frames through DetectionPredictor; launch counts of every
              kernel are read around these requests;
  5. profile - device time of a request by kernel and by part of the path
              (torch.profiler), and the device's busy share;
  6. k2_backward - the sampler's backward kernel vs autograd through the plain
              version, and its forward kernel vs the plain forward, at the three
              sites at training batch 16, both padding modes; the zero fill of
              dx timed alone; F.grid_sample's backward kernel as the library
              yardstick;
  7. train  - YOLO-DBL-s (nc=3, 640, f32, batch 16, default training config)
              taking 2 warm-up and 10 timed steps through Trainer.step on
              seeded synthetic batches; losses, step times, peak memory, launch
              counts of both K2 kernels (3 each per step), then the device time
              of one step by part and the device's busy share;
  8. parity - the same weights and 2 frames on the CPU (plain versions) and on
              the card (kernels, TF32 off): decoded boxes < 0.05 px, scores <= 1e-3;
  9. train_parity - one train-mode loss and backward of the same weights on a
              batch of 2 at 256 px on the CPU and on the card (TF32 off, dropout
              off on both): loss items within 1e-4 relative, the gradient of
              every leaf within 1e-3 of that leaf's largest (plus 1e-10 of the
              model's largest, for leaves whose exact gradient is 0), named for
              the DySample offset convs, m0 and a Detect conv; BatchNorm
              running statistics within 1e-4.
Then the kernel table line ({"kernels": [...]}), the card's name and power limit
from nvidia-smi, and last {"ok": true, "device": {...}}. Any failure raises and
exits non-zero before the result lines; without CUDA it exits 2.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
TOL = 1e-5
B, SRC_HW, IMGSZ, NC = 8, (512, 768), 640, 3
REQUESTS, WARMUP = 5, 2
TRAIN_B, TRAIN_M, TRAIN_WARMUP, TRAIN_STEPS = 16, 16, 2, 10
# (H, W, C) of the DySample inputs of YOLO-DBL-s at 640 (rows 13, 18, 22); scale 2, 4 groups
DYSAMPLE_SITES = {"row13": (40, 40, 256), "row18": (20, 20, 512), "row22": (40, 40, 256)}
GROUPS = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(what)


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def timings(fn, iters, warmup=3, only=None):
    """(device_ms, call_ms) per call of fn(i). device_ms sums the device time
    of the kernels a call runs (torch.profiler), or of those whose name holds
    `only`, so host launch overhead does not count; call_ms is CUDA-event time
    over back-to-back calls, which does include it when the host is slower
    than the card."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in _device_events(prof)
                    if only is None or only in e.key)
    if device_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return device_us / 1e3 / iters, call_ms


def bound(n_bytes, n_flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def copies_for(n_bytes):
    """Input copies to rotate through so a timed loop reads past the 50 MB L2."""
    return max(2, int(np.ceil(100e6 / n_bytes)))


def phase_k1(gen):
    from yolo_dbl_tpu_torch.kernels.preprocess import (letterbox_geometry, letterbox_normalize,
                                                       letterbox_normalize_plain)

    frames = [torch.randint(0, 256, (B, *SRC_HW, 3), dtype=torch.uint8, generator=gen).cuda()
              for _ in range(copies_for(B * SRC_HW[0] * SRC_HW[1] * 3))]
    out = letterbox_normalize(frames[0], (IMGSZ, IMGSZ))
    ref = letterbox_normalize_plain(frames[0], (IMGSZ, IMGSZ))
    err = float((out - ref).abs().max())
    err_bf16 = float((letterbox_normalize(frames[0], (IMGSZ, IMGSZ), out_dtype=torch.bfloat16).float()
                      - ref.to(torch.bfloat16).float()).abs().max())
    require(err <= TOL, f"letterbox kernel vs plain: max |d| {err} > {TOL}")
    require(err_bf16 <= 4e-3, f"letterbox kernel bf16 vs plain: max |d| {err_bf16}")

    _, new_h, new_w, top, left = letterbox_geometry(*SRC_HW, IMGSZ, IMGSZ, scaleup=False)

    def library(f):
        x = F.interpolate(f.permute(0, 3, 1, 2).float(), size=(new_h, new_w), mode="bilinear",
                          align_corners=False, antialias=False)
        x = F.pad(x, (left, IMGSZ - new_w - left, top, IMGSZ - new_h - top), value=114.0)
        return x / 255.0

    lib_err = float((library(frames[0]).permute(0, 2, 3, 1) - out).abs().max())
    n = len(frames)
    ms, call_ms = timings(lambda i: letterbox_normalize(frames[i % n], (IMGSZ, IMGSZ)), 50)
    plain_ms, plain_call_ms = timings(
        lambda i: letterbox_normalize_plain(frames[i % n], (IMGSZ, IMGSZ)), 10)
    library_ms, library_call_ms = timings(lambda i: library(frames[i % n]), 20)
    n_bytes = B * SRC_HW[0] * SRC_HW[1] * 3 + B * IMGSZ * IMGSZ * 3 * 4
    # per output value: 2 row blends + 1 column blend (3 ops each) and the /255
    bound_ms, bound_by = bound(n_bytes, B * new_h * new_w * 3 * 10)
    row = dict(name="letterbox_normalize", route="cuda",
               source="yolo_dbl_tpu_torch/csrc/preprocess.cu",
               replaces="yolo_dbl_tpu/kernels/preprocess.py:144", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    emit({"phase": "k1", "shape": [B, *SRC_HW, 3], "out": [B, IMGSZ, IMGSZ, 3],
          "max_abs_err_f32": err, "max_abs_err_bf16": err_bf16, "library_vs_kernel": lib_err,
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
          "call_ms": call_ms, "plain_call_ms": plain_call_ms, "library_call_ms": library_call_ms})
    return row


def _site_coords(gen, h, w, s=2, b=B):
    """DySample-like pixel coordinates (B, N, G): each output point near its
    source position with offsets of about a pixel, so edges clip."""
    oy = (torch.arange(h * s, dtype=torch.float32) + 0.5) / s - 0.5
    ox = (torch.arange(w * s, dtype=torch.float32) + 0.5) / s - 0.5
    gy, gx = torch.meshgrid(oy, ox, indexing="ij")
    shape = (b, h * s * w * s, GROUPS)
    gy = gy.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    gx = gx.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    return gy.cuda().contiguous(), gx.cuda().contiguous()


def _library_layout(xs, gy, gx):
    """The library yardstick's layout: F.grid_sample over (B*G, C/G, H, W)
    planes of each NHWC x, with one normalized grid per group."""
    b, h, w, c = xs[0].shape
    cg = c // GROUPS
    planes = [x.reshape(b, h, w, GROUPS, cg).permute(0, 3, 4, 1, 2).reshape(b * GROUPS, cg, h, w)
              .contiguous() for x in xs]
    grid = torch.stack([(gx + 0.5) * 2 / w - 1, (gy + 0.5) * 2 / h - 1], -1)
    grid = grid.permute(0, 2, 1, 3).reshape(b * GROUPS, 2 * h, 2 * w, 2).contiguous()
    return planes, grid


def phase_k2(gen):
    from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear, sample_bilinear_plain

    sites, worst = {}, 0.0
    for site, (h, w, c) in DYSAMPLE_SITES.items():
        n_x = B * h * w * c
        xs = [torch.randn((B, h, w, c), generator=gen).cuda() for _ in range(copies_for(n_x * 4))]
        gy, gx = _site_coords(gen, h, w)
        uy = (torch.rand(gy.shape, generator=gen) * (h + 2) - 1.5).cuda()
        ux = (torch.rand(gx.shape, generator=gen) * (w + 2) - 1.5).cuda()
        errs = {}
        for mode in ("border", "zeros"):
            for name, (cy, cx) in {"dysample": (gy, gx), "uniform": (uy, ux)}.items():
                d = sample_bilinear(xs[0], cy, cx, mode) - sample_bilinear_plain(xs[0], cy, cx, mode)
                errs[f"{mode}/{name}"] = float(d.abs().max())
        err = max(errs.values())
        require(err <= TOL, f"sampler kernel vs plain at {site}: {errs}")
        worst = max(worst, err)

        cg, n = c // GROUPS, gy.shape[1]
        planes, grid = _library_layout(xs, gy, gx)

        def library(p):
            return F.grid_sample(p, grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        lib = library(planes[0]).reshape(B, GROUPS, cg, n).permute(0, 3, 1, 2).reshape(B, n, c)
        lib_err = float((lib - sample_bilinear(xs[0], gy, gx)).abs().max())
        k = len(xs)
        ms, call_ms = timings(lambda i: sample_bilinear(xs[i % k], gy, gx), 50)
        plain_ms, plain_call_ms = timings(lambda i: sample_bilinear_plain(xs[i % k], gy, gx), 10)
        library_ms, library_call_ms = timings(lambda i: library(planes[i % k]), 50)
        n_bytes = (n_x + B * n * c + 2 * B * n * GROUPS) * 4
        bound_ms, bound_by = bound(n_bytes, B * n * c * 11)
        sites[site] = dict(x=[B, h, w, c], n=n, groups=GROUPS, max_abs_err=errs,
                           library_vs_kernel=lib_err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                           call_ms=call_ms, plain_call_ms=plain_call_ms,
                           library_call_ms=library_call_ms)
    emit({"phase": "k2", "sites": sites})
    total = {key: sum(s[key] for s in sites.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = {s["bound_by"] for s in sites.values()}
    return dict(name="sample_bilinear", route="cuda", source="yolo_dbl_tpu_torch/csrc/sampling.cu",
                replaces="yolo_dbl_tpu/kernels/sampling.py:102", max_abs_err=worst,
                bound_by="bytes" if by == {"bytes"} else "operations", **total)


def phase_k2_backward(gen):
    """The sampler's backward kernel at the three sites at training batch 16,
    and its forward kernel at the same shapes (the train step runs both).
    Returns the backward's kernel row and the forward's worst error here."""
    from yolo_dbl_tpu_torch.kernels.sampling import (sample_bilinear, sample_bilinear_backward,
                                                     sample_bilinear_backward_plain,
                                                     sample_bilinear_plain)

    b, sites, worst = TRAIN_B, {}, {"dx": 0.0, "dgy_rel": 0.0, "dgx_rel": 0.0}
    worst_fwd = 0.0
    for site, (h, w, c) in DYSAMPLE_SITES.items():
        n_x, n = b * h * w * c, 4 * h * w
        k = copies_for((n_x + b * n * c) * 4)
        xs = [torch.randn((b, h, w, c), generator=gen).cuda() for _ in range(k)]
        gs = [torch.randn((b, n, c), generator=gen).cuda() for _ in range(k)]
        gy, gx = _site_coords(gen, h, w, b=b)
        uy = (torch.rand(gy.shape, generator=gen) * (h + 2) - 1.5).cuda()
        ux = (torch.rand(gx.shape, generator=gen) * (w + 2) - 1.5).cuda()
        errs, fwd_errs = {}, {}
        for mode in ("border", "zeros"):
            for name, (cy, cx) in {"dysample": (gy, gx), "uniform": (uy, ux)}.items():
                d = sample_bilinear(xs[0], cy, cx, mode) - sample_bilinear_plain(xs[0], cy, cx, mode)
                fwd_errs[f"{mode}/{name}"] = float(d.abs().max())
                dx, dgy, dgx = sample_bilinear_backward(xs[0], cy, cx, gs[0], mode)
                rx, ry, rxx = sample_bilinear_backward_plain(xs[0], cy, cx, gs[0], mode)
                e = {"dx": float((dx - rx).abs().max()),
                     "dgy_rel": float((dgy - ry).abs().max() / ry.abs().max()),
                     "dgx_rel": float((dgx - rxx).abs().max() / rxx.abs().max())}
                errs[f"{mode}/{name}"] = e
                worst = {key: max(worst[key], e[key]) for key in worst}
        bad = {key: e for key, e in errs.items()
               if e["dx"] > 1e-4 or e["dgy_rel"] > 1e-4 or e["dgx_rel"] > 1e-4}
        require(not bad, f"sampler backward kernel vs plain at {site}: {bad}")
        require(max(fwd_errs.values()) <= TOL,
                f"sampler kernel vs plain at {site}, batch {b}: {fwd_errs}")
        worst_fwd = max(worst_fwd, max(fwd_errs.values()))

        planes, grid = _library_layout(xs, gy, gx)
        planes = [p.requires_grad_() for p in planes]
        grid.requires_grad_()
        g_planes = [g.reshape(b, 2 * h, 2 * w, GROUPS, c // GROUPS).permute(0, 3, 4, 1, 2)
                    .reshape(b * GROUPS, c // GROUPS, 2 * h, 2 * w).contiguous() for g in gs]

        def library(i):
            out = F.grid_sample(planes[i % k], grid, mode="bilinear", padding_mode="border",
                                align_corners=False)
            return torch.autograd.grad(out, (planes[i % k], grid), g_planes[i % k])

        ms, call_ms = timings(lambda i: sample_bilinear_backward(xs[i % k], gy, gx, gs[i % k]), 30)
        plain_ms, plain_call_ms = timings(
            lambda i: sample_bilinear_backward_plain(xs[i % k], gy, gx, gs[i % k]), 5)
        library_ms, _ = timings(library, 20, only="grid_sampler_2d_backward")
        # the zero fill of dx that the atomic scatter needs; it is part of `ms`
        zero_fill_ms, _ = timings(lambda i: torch.zeros_like(xs[i % k]), 30)
        # the function's own I/O: x and g read, dx written, coordinates read
        # and their gradients written (the zero fill is this design's cost)
        n_bytes = (n_x + b * n * c + n_x + 4 * b * n * GROUPS) * 4
        bound_ms, bound_by = bound(n_bytes, b * n * c * 24)
        sites[site] = dict(x=[b, h, w, c], n=n, groups=GROUPS, errors=errs,
                           forward_errors=fwd_errs, ms=ms, zero_fill_ms=zero_fill_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=n_bytes, call_ms=call_ms,
                           plain_call_ms=plain_call_ms)
    emit({"phase": "k2_backward", "batch": b, "tolerance": {"dx": 1e-4, "dg_rel": 1e-4,
                                                            "forward": TOL},
          "forward_max_abs_err": worst_fwd, "sites": sites})
    total = {key: sum(st[key] for st in sites.values())
             for key in ("ms", "zero_fill_ms", "plain_ms", "library_ms", "bound_ms")}
    by = {st["bound_by"] for st in sites.values()}
    return dict(name="sample_bilinear_backward", route="cuda",
                source="yolo_dbl_tpu_torch/csrc/sampling.cu",
                replaces="yolo_dbl_tpu/kernels/sampling.py:142", max_abs_err=worst["dx"],
                max_rel_err_dgy_dgx=max(worst["dgy_rel"], worst["dgx_rel"]),
                bound_by="bytes" if by == {"bytes"} else "operations", **total), worst_fwd


def build_models():
    """One seeded YOLO-DBL-s on the CPU with the smoke settings, and its copy on the card."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.nn.blocks import FullPAD_Tunnel

    cpu = DetectionModel("yolov13s_DBL.yaml", nc=NC, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, FullPAD_Tunnel):
                mod.gate.fill_(0.5)  # gates start at 0, which would hide the tunnel inputs
        for lvl in range(len(cpu.strides)):
            getattr(cpu.detect, f"cv3_{lvl}_2").conv.bias.zero_()  # give NMS real candidates
    gpu = DetectionModel("yolov13s_DBL.yaml", nc=NC, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def phase_main(gpu_model, rng, card):
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor

    pred = DetectionPredictor(gpu_model, conf=0.25, iou=0.45, max_det=300, imgsz=IMGSZ)
    requests = [rng.integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8)
                for _ in range(WARMUP + REQUESTS)]
    for frames in requests[:WARMUP]:
        pred(frames)
    torch.cuda.synchronize()
    kernels.reset_launches()
    lat, n_boxes = [], []
    for frames in requests[WARMUP:]:
        t0 = time.perf_counter()
        out = pred(frames)
        lat.append(time.perf_counter() - t0)
        require(len(out) == B and all(o.shape[1] == 6 and np.isfinite(o).all() for o in out),
                "predictor output: expected 8 finite (n, 6) arrays")
        n_boxes.append([len(o) for o in out])
    launches = dict(kernels.launches)
    require(launches["letterbox_normalize"] == REQUESTS, f"K1 launches {launches}")
    require(launches["sample_bilinear"] == 3 * REQUESTS, f"K2 launches {launches}")
    require(sum(map(sum, n_boxes)) > 0, "no detections: NMS saw no candidates")
    med = statistics.median(lat)
    emit({"phase": "main", "model": "yolov13s_DBL", "nc": NC, "imgsz": IMGSZ, "batch": B,
          "frames": list(SRC_HW), "requests": REQUESTS, "latency_ms": [t * 1e3 for t in lat],
          "median_ms": med * 1e3, "img_per_s": B / med, "boxes_per_image": n_boxes,
          "launches": launches, "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})
    return launches, requests[WARMUP][:2], pred, med


# substrings of device event names → the part of a path they belong to (first match)
_CATEGORIES = (("letterbox", "k1 letterbox"), ("sample_bilinear_backward", "k2 sampler backward"),
               ("sample_bilinear", "k2 sampler"), ("memcpy", "memcpy"), ("memset", "memset"),
               ("bn_fw", "batchnorm"), ("bn_bw", "batchnorm"), ("batch_norm", "batchnorm"),
               ("batchnorm", "batchnorm"), ("conv", "convolution"), ("xmma", "convolution"),
               ("cudnn::cnn", "convolution"), ("gemm", "matmul"),
               ("multi_tensor", "optimizer/EMA (foreach)"), ("sort", "sort/topk"),
               ("reduce", "reduction"), ("softmax", "reduction"), ("elementwise", "elementwise"),
               ("cat", "concat/copy"), ("copy", "concat/copy"), ("scatter", "gather/index"),
               ("gather", "gather/index"), ("index", "gather/index"))


def by_part(fn, calls):
    """Device time per call of fn(i) by kernel and by part (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    per_kernel, per_part, n_ops = {}, {}, 0
    for evt in _device_events(prof):
        ms = evt.self_device_time_total / 1e3 / calls
        n_ops += evt.count
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + ms
        part = next((p for s, p in _CATEGORIES if s in evt.key.lower()), "other")
        per_part[part] = per_part.get(part, 0.0) + ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return dict(device_ms=sum(per_kernel.values()), device_ops=n_ops / calls,
                by_part_ms=dict(sorted(per_part.items(), key=lambda kv: -kv[1])),
                top_kernels_ms=[[k[:90], v] for k, v in top])


def phase_profile(pred, rng, median_ms, requests=2):
    """Device time of one request by kernel and by part of the path."""
    frames = [rng.integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8) for _ in range(requests)]
    p = by_part(lambda i: pred(frames[i]), requests)
    emit({"phase": "profile", "requests": requests, "device_ms_per_request": p["device_ms"],
          "device_ops_per_request": p["device_ops"], "unprofiled_median_ms": median_ms,
          "device_busy_share": p["device_ms"] / median_ms, "by_part_ms": p["by_part_ms"],
          "top_kernels_ms": p["top_kernels_ms"]})


def train_batches(rng, n, b=TRAIN_B, imgsz=IMGSZ, m=TRAIN_M):
    """Seeded synthetic batches of the loss's batch contract: uint8 images,
    1-8 real boxes per image (normalized xywh, classes 0..NC-1) padded to m."""
    out = []
    for _ in range(n):
        real = rng.integers(1, 9, b)
        xy = rng.uniform(0.15, 0.85, (b, m, 2))
        wh = rng.uniform(0.04, 0.3, (b, m, 2))
        out.append(dict(img=rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8),
                        gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                        gt_cls=rng.integers(0, NC, (b, m)).astype(np.int32),
                        gt_mask=(np.arange(m)[None] < real[:, None]).astype(np.float32)))
    return out


def phase_train(card):
    """YOLO-DBL-s training steps on the card through Trainer.step."""
    from yolo_dbl_tpu_torch import DetectionModel, kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer

    model = DetectionModel("yolov13s_DBL.yaml", nc=NC, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, {"batch": TRAIN_B}).setup(steps_per_epoch=100)
    batches = train_batches(np.random.default_rng(1), TRAIN_WARMUP + TRAIN_STEPS + 1)
    params = [p for _, p in model.named_parameters()]
    losses, step_ms = [], []
    for i, batch in enumerate(batches[:TRAIN_WARMUP + TRAIN_STEPS]):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            after_first = [p.detach().clone() for p in params]
            ema_first = [e.clone() for e in trainer.ema]
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics)
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(v) for m in losses for v in m.values()), f"non-finite losses {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in params + trainer.ema),
            "non-finite parameters or EMA after training")
    moved = sum(not torch.equal(a, p) for a, p in zip(after_first, params))
    ema_moved = sum(not torch.equal(a, e) for a, e in zip(ema_first, trainer.ema))
    require(moved > 0.9 * len(params) and ema_moved > 0.9 * len(params),
            f"{moved} parameters and {ema_moved} EMA tensors of {len(params)} changed")
    for name in ("sample_bilinear", "sample_bilinear_backward"):
        require(launches[name] == 3 * TRAIN_STEPS, f"{name} launches {launches} in {TRAIN_STEPS} steps")
    med = statistics.median(step_ms)
    emit({"phase": "train", "model": "yolov13s_DBL", "nc": NC, "imgsz": IMGSZ, "batch": TRAIN_B,
          "optimizer": trainer.optimizer.name, "steps": TRAIN_STEPS, "step_ms": step_ms,
          "median_ms": med, "img_per_s": TRAIN_B / (med / 1e3), "losses": losses,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "params_changed": moved, "ema_changed": ema_moved, "n_params": len(params),
          "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})
    last = batches[-1]
    p = by_part(lambda i: (trainer.step(last), torch.cuda.synchronize()), 1)
    emit({"phase": "train_profile", "steps": 1, "device_ms_per_step": p["device_ms"],
          "device_ops_per_step": p["device_ops"], "unprofiled_median_ms": med,
          "device_busy_share": p["device_ms"] / med, "by_part_ms": p["by_part_ms"],
          "top_kernels_ms": p["top_kernels_ms"]})
    return launches


def phase_parity(cpu_model, gpu_model, frames):
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    u8 = torch.from_numpy(frames)
    pred_c = cpu_model.predict(letterbox_normalize(u8, (IMGSZ, IMGSZ)))
    pred_g = gpu_model.predict(letterbox_normalize(u8.cuda(), (IMGSZ, IMGSZ))).cpu()
    anchors = sum((IMGSZ // s) ** 2 for s in gpu_model.strides)
    require(pred_g.shape == pred_c.shape == (2, 4 + NC, anchors) and torch.isfinite(pred_g).all(),
            f"predictions: card {tuple(pred_g.shape)}, CPU {tuple(pred_c.shape)}")
    box_err = float((pred_g[:, :4] - pred_c[:, :4]).abs().max())
    score_err = float((pred_g[:, 4:] - pred_c[:, 4:]).abs().max())
    emit({"phase": "parity", "frames": 2, "box_max_abs_px": box_err, "score_max_abs": score_err,
          "max_score": float(pred_c[:, 4:].max())})
    require(box_err < 0.05 and score_err <= 1e-3,
            f"card vs CPU: boxes {box_err} px (< 0.05), scores {score_err} (<= 1e-3)")


def _float64_grads(cpu_model, cfg, batch):
    """{name: gradient} of the train-mode loss of a float64 copy of the CPU
    model (the plain sampler takes float64): train_loss's steps, with the
    images normalized to float64."""
    import copy

    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize
    from yolo_dbl_tpu_torch.losses.detection import detection_loss

    model = copy.deepcopy(cpu_model).double().train()
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    names, params = zip(*model.named_parameters())
    loss, _ = detection_loss(model(device_normalize(batch["img"], torch.float64)), batch,
                             model.strides, model.nc, box_gain=cfg.box, cls_gain=cfg.cls,
                             dfl_gain=cfg.dfl)
    return dict(zip(names, torch.autograd.grad(loss, params)))


def phase_train_parity(cpu_model, gpu_model):
    """One train-mode loss and backward of the same weights on the CPU (plain
    versions) and on the card (kernels, TF32 off). Dropout is off on both:
    the two devices draw different random bits."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.cfg import get_cfg
    from yolo_dbl_tpu_torch.engine.trainer import train_loss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_cfg()
    batch = train_batches(np.random.default_rng(2), 1, b=2, imgsz=256)[0]
    results = {}
    for model in (cpu_model, gpu_model):
        for mod in model.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        dev = model.device
        names, params = zip(*model.named_parameters())
        kernels.reset_launches()
        loss, items = train_loss(model, cfg, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, params)
        stats = {k: v.cpu() for k, v in model.state_dict().items() if k.endswith(("_mean", "_var"))}
        results[dev.type] = (dict(loss=float(loss.detach()),
                                  **{k: float(v.detach()) for k, v in items._asdict().items()}),
                             dict(zip(names, (g.cpu() for g in grads))), stats,
                             dict(kernels.launches))
    (lc, gc, sc, _), (lg, gg, sg, launches) = results["cpu"], results["cuda"]
    require(launches["sample_bilinear"] == 3 and launches["sample_bilinear_backward"] == 3,
            f"K2 launches in one card step: {launches}")
    loss_rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
    detect = f"m{len(gpu_model.spec.layers) - 1}"
    checked = [n for n in gc if ".offset.conv." in n or n.startswith("m0.")
               or n.startswith(f"{detect}.cv2_0_2.") or n.startswith(f"{detect}.cv3_0_2.")]
    grad_rel = {n: float((gg[n] - gc[n]).abs().max() / gc[n].abs().max()) for n in checked}
    # Every leaf against the float64 gradient (g64) of the same weights and
    # batch on the CPU: the card within 1e-3 of the leaf's largest |g64|, or,
    # where float32 itself does not reach that (a leaf whose gradient is a sum
    # that cancels), within 4x the CPU float32's own distance from g64; plus
    # 1e-10 of the model's largest |g64| for leaves whose exact gradient is 0.
    g64 = _float64_grads(cpu_model, cfg, batch)
    g_max = max(float(g.abs().max()) for g in g64.values())
    leaves = {}
    for n, ref in g64.items():
        card, cpu = (float((g[n].double() - ref).abs().max()) for g in (gg, gc))
        m = float(ref.abs().max())
        tol = max(1e-3 * m, 4 * cpu) + 1e-10 * g_max
        leaves[n] = dict(card_err=card, cpu_err=cpu, leaf_max=m, tol=tol,
                         card_vs_cpu=float((gg[n] - gc[n]).abs().max()))
    failing = {n: e for n, e in leaves.items() if e["card_err"] > e["tol"]}
    worst = sorted(leaves.items(), key=lambda kv: -kv[1]["card_err"] / max(kv[1]["leaf_max"], 1e-30))
    stats_err = max(float(((sg[k] - sc[k]).abs() / (1 + sc[k].abs())).max()) for k in sc)
    emit({"phase": "train_parity", "batch": 2, "imgsz": 256, "losses_cpu": lc, "losses_card": lg,
          "loss_rel": loss_rel, "grad_rel_of_leaf_max": grad_rel, "model_max_abs_grad": g_max,
          "leaves": len(leaves), "zero_leaves": sum(e["leaf_max"] == 0 for e in leaves.values()),
          "leaves_past_1e-3_of_leaf_max": sum(e["card_err"] > 1e-3 * e["leaf_max"] + 1e-10 * g_max
                                              for e in leaves.values()),
          "worst_leaves_vs_float64": [dict(name=n, **e) for n, e in worst[:5]],
          "bn_stats_rel": stats_err, "launches": launches})
    require(max(loss_rel.values()) <= 1e-4, f"loss items card vs CPU: {loss_rel}")
    require(len([n for n in checked if ".offset." in n]) == 6 and max(grad_rel.values()) <= 1e-3,
            f"gradients card vs CPU (of each leaf's max |g|): {grad_rel}")
    require(set(leaves) == set(gg) and not failing,
            f"leaf gradients on the card vs float64 past their tolerance: {failing}")
    require(stats_err <= 1e-4, f"BatchNorm running statistics card vs CPU: {stats_err}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from yolo_dbl_tpu_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    report = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines() if "registers" in ln]
                    for k, v in report.items()},
          "card": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    gen = torch.Generator().manual_seed(0)
    k1_row, k2_row = phase_k1(gen), phase_k2(gen)
    k2_backward_row, k2_train_err = phase_k2_backward(gen)
    k2_row["max_abs_err_by_path"] = {"serve": k2_row["max_abs_err"], "train": k2_train_err}
    k2_row["max_abs_err"] = max(k2_row["max_abs_err"], k2_train_err)
    rows = [k1_row, k2_row, k2_backward_row]
    cpu_model, gpu_model = build_models()
    rng = np.random.default_rng(0)
    serve, parity_frames, predictor, median_ms = phase_main(gpu_model, rng, card)
    phase_profile(predictor, rng, median_ms * 1e3)
    train = phase_train(card)
    phase_parity(cpu_model, gpu_model, parity_frames)
    phase_train_parity(cpu_model, gpu_model)
    # launches: per the path's run (5 requests; 10 train steps) on the path each row serves
    for row in rows:
        name = row["name"]
        row["launches"] = train[name] if name == "sample_bilinear_backward" else serve[name]
        row["launches_by_path"] = {"serve": serve[name], "train": train[name]}
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
