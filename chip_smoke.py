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
  6. parity - the same weights and 2 frames on the CPU (plain versions) and on
              the card (kernels, TF32 off): decoded boxes < 0.05 px, scores <= 1e-3.
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


def timings(fn, iters, warmup=3):
    """(device_ms, call_ms) per call of fn(i). device_ms sums the device time
    of the kernels a call runs (torch.profiler), so host launch overhead does
    not count; call_ms is CUDA-event time over back-to-back calls, which does
    include it when the host is slower than the card."""
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
    device_us = sum(e.self_device_time_total for e in _device_events(prof))
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


def _site_coords(gen, h, w, s=2):
    """DySample-like pixel coordinates (B, N, G): each output point near its
    source position with offsets of about a pixel, so edges clip."""
    oy = (torch.arange(h * s, dtype=torch.float32) + 0.5) / s - 0.5
    ox = (torch.arange(w * s, dtype=torch.float32) + 0.5) / s - 0.5
    gy, gx = torch.meshgrid(oy, ox, indexing="ij")
    shape = (B, h * s * w * s, GROUPS)
    gy = gy.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    gx = gx.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    return gy.cuda().contiguous(), gx.cuda().contiguous()


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
        # the library yardstick: F.grid_sample over (B*G, C/G, H, W) planes, one grid per group
        planes = [x.reshape(B, h, w, GROUPS, cg).permute(0, 3, 4, 1, 2).reshape(B * GROUPS, cg, h, w)
                  .contiguous() for x in xs]
        grid = torch.stack([(gx + 0.5) * 2 / w - 1, (gy + 0.5) * 2 / h - 1], -1)
        grid = grid.permute(0, 2, 1, 3).reshape(B * GROUPS, 2 * h, 2 * w, 2).contiguous()

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


# substrings of device event names → the part of the main path they belong to
_CATEGORIES = (("letterbox", "k1 letterbox"), ("sample_bilinear", "k2 sampler"),
               ("memcpy", "memcpy"), ("bn_fw", "batchnorm"), ("batch_norm", "batchnorm"),
               ("conv", "convolution"), ("xmma", "convolution"), ("gemm", "matmul"),
               ("sort", "sort/topk"), ("reduce", "reduction"), ("softmax", "reduction"), ("elementwise", "elementwise"), ("cat", "concat/copy"),
               ("copy", "concat/copy"), ("gather", "gather/index"), ("index", "gather/index"))


def phase_profile(pred, rng, median_ms, requests=2):
    """Device time of one request by kernel and by part of the path (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    frames = [rng.integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8) for _ in range(requests)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames:
            pred(f)
        torch.cuda.synchronize()
    per_kernel, per_part, n_ops = {}, {}, 0
    for evt in _device_events(prof):
        ms = evt.self_device_time_total / 1e3 / requests
        n_ops += evt.count
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + ms
        part = next((p for s, p in _CATEGORIES if s in evt.key.lower()), "other")
        per_part[part] = per_part.get(part, 0.0) + ms
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "requests": requests, "device_ms_per_request": device_ms,
          "device_ops_per_request": n_ops / requests,
          "unprofiled_median_ms": median_ms, "device_busy_share": device_ms / median_ms,
          "by_part_ms": dict(sorted(per_part.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms": [[k[:90], v] for k, v in top]})


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
    rows = [phase_k1(gen), phase_k2(gen)]
    cpu_model, gpu_model = build_models()
    rng = np.random.default_rng(0)
    launches, parity_frames, predictor, median_ms = phase_main(gpu_model, rng, card)
    phase_profile(predictor, rng, median_ms * 1e3)
    phase_parity(cpu_model, gpu_model, parity_frames)
    for row in rows:
        row["launches"] = launches[row["name"]]
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
