#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (yolo_dbl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build  - compile every CUDA kernel of the main paths from csrc/ (one nvcc
              per source, all started together); ptxas registers, spills and
              static shared bytes per kernel, and the dynamic shared bytes of
              the kernels that take them;
  2. k1     - letterbox kernel vs its plain PyTorch version at 8x512x768 -> 640^2,
              float32 and bfloat16 out (each timed beside its own byte bound), and
              at one odd geometry (odd canvas width, a batch starting mid-chunk);
  3. k2     - DySample sampler kernel vs its plain version at the three
              YOLO-DBL-s DySample sites and two of YOLO-DBL2-l's (20x20x1024
              -> 40^2, 256 channels a group; 40x40x512, 128), both padding
              modes;
  4. k2_backward - the sampler's backward kernel vs autograd through the plain
              version, and its forward kernel vs the plain forward, at the three
              sites at training batch 16 (and the two YOLO-DBL2-l sites),
              both padding modes, DySample and uniform coordinates; the share
              of taps that missed their tile's
              window of dx; the zero fill of dx timed alone; F.grid_sample's
              backward kernel as the library yardstick;
  5. k3     - area attention forward kernel (3xTF32 on the tensor cores) vs
              its plain version (the einsum path) at the two YOLOv13-s A2C2f
              sites at serving batch 8, on the packed qkv views AAttn passes;
              a second run on the same inputs must give the same bits;
              lse vs logsumexp; both float32 sides read against float64; SDPA
              as the library yardstick; the bound is the largest of the bytes,
              the products (on their cheapest route at the accuracy the bars
              ask for) and the exponentials on the special-function units;
  6. k3_backward - the dq and dkv kernels (3xTF32 on the tensor cores) vs
              autograd through the plain version, and the forward kernel vs
              the plain forward, at the two sites at training batch 16; a
              second backward on the same inputs must give the same bits;
              SDPA's backward as the yardstick;
  7. main   - YOLO-DBL-s (nc=3, 640, f32, seeded random weights, FullPAD gates
              0.5, Detect class biases 0) serving requests of 8 distinct uint8
              512x768 frames through DetectionPredictor; launch counts of every
              kernel are read around these requests;
  8. profile - device time of a request by kernel and by part of the path
              (torch.profiler), and the device's busy share;
  9. train  - YOLO-DBL-s (nc=3, 640, f32, batch 16, default training config)
              taking 2 warm-up and 10 timed steps through Trainer.step on
              seeded synthetic batches; losses, step times, peak memory, launch
              counts of every kernel (K2 forward and backward 3 each per step),
              then the device time of one step by part and the device's busy
              share (train_profile);
 10. main_v13, profile_v13 - as main and profile for the stock YOLOv13-s
              (nc=80, the config's own): K1 once and K3 8 times per request;
 11. train_v13 - as train for YOLOv13-s (nc=80, batch 16, 2 warm-up and 10
              timed steps): each K3 kernel 8 times per step (train_profile_v13);
 12. parity, parity_v13 - the same weights and 2 frames on the CPU (plain
              versions) and on the card (kernels, TF32 off): decoded boxes
              < 0.05 px, scores <= 1e-3;
 13. train_parity, train_parity_v13 - one train-mode loss and backward of the
              same weights on a batch of 2 at 256 px on the CPU and on the card
              (TF32 off, dropout off on both): loss items within 1e-4 relative,
              the gradient of every leaf within 1e-3 of that leaf's largest
              (plus 1e-10 of the model's largest, for leaves whose exact
              gradient is 0) against a float64 CPU gradient, and card against
              CPU for named leaves (YOLO-DBL: the DySample offset convs, m0 and
              a Detect conv; YOLOv13: the 8 attn.qkv convs, whose gradient
              comes only through K3's backward and pe, m0 and a Detect conv);
              BatchNorm running statistics within 1e-4.
The bfloat16 policy (DetectionModel(..., dtype=torch.bfloat16): float32
parameters, bfloat16 compute), beside each float32 phase:
 14. k2_bf16, k2_backward_bf16, k3_bf16, k3_backward_bf16 - phases 3-6 for
              the bfloat16 kernels (bfloat16 in and out, float32 inside; the
              three K3 kernels on bfloat16 tensor cores), with
              the same inputs rounded to bfloat16, against the bfloat16 plain
              versions (float32 on the upcast inputs, rounded once): within
              one bfloat16 step of the result plus 1e-6 of the terms' scale;
              the library yardsticks in bfloat16;
 15. main_bf16, profile_bf16, main_v13_bf16, profile_v13_bf16 - the requests
              of main with a bfloat16 model: K1 writes bfloat16, and the K2 or
              K3 bfloat16 kernels run, no float32 kernel;
 16. train_bf16, train_profile_bf16, train_v13_bf16, train_profile_v13_bf16 -
              as train, with bfloat16 models (float32 loss, optimizer, EMA);
 17. parity_bf16, parity_v13_bf16 - the card's bfloat16 decode against the
              CPU's float32 one at the same weights and frames, within
              check_amp's bars (yolo_dbl_tpu/utils/checks.py:43-45: boxes 0.02
              of imgsz, scores 0.05); card bfloat16 against CPU bfloat16 printed
              beside the CPU's own bfloat16-against-float32 spread;
 18. train_parity_bf16, train_parity_v13_bf16 - one train-mode backward at 256
              px of bfloat16 models on the CPU and the card: loss items and
              the leaves K2 or K3 feed against the CPU's float64, within 4x the
              CPU bfloat16's own distance from it.
The engine slice (DetectionValidator over 4 batches of 16 seeded 640x640
images with 1-3 filled rectangles each, conf 0.001, iou 0.7, max_det 300, the
COCO 12 stats; random weights, so the mAP is no quality claim):
 19. val      - YOLO-DBL-s (nc=3, f32; main's weights with the Detect class
              biases of the model's own init): metrics, img/s, K2 launches (3 a
              batch); gate: the first 2 images through the same validator on
              the CPU (TF32 off): the same kept count per image, rows within
              0.05 px and 1e-3, each metric within 1e-3;
 20. val_bf16 - the same with a bfloat16 model (the bfloat16 K2 kernel only),
              its metrics beside the float32 ones; gate: its decode on 2 images
              against the CPU's float32 within check_amp's bars;
 21. v8       - yolov8n (nc=3, f32, 3,011,417 parameters; no hand kernel):
              card decode against the CPU's on 2 images (0.05 px, 1e-3), 2
              warm-up and 10 timed Trainer.steps at batch 16 (step ms, img/s,
              peak memory), then the validator over the val batches.
The engine slice, part 2 (the facade; needs cv2, through tests/fixtures.py):
 22. facade   - YOLO-DBL-s (nc=3, 640, f32, full width and depth) through
              YOLO on a seeded shapes set (32 train, 16 val images): train 1
              epoch (batch 16), then resume=True to 2 (it must continue at
              epoch 1 and step 2); YOLO(best.ckpt) validates (the native val
              lane where the native loader built) and predicts a directory of
              12 JPEG frames of two sizes (two buckets; K1 once a bucket, the
              K2 forward 3 times a forward, its backward 3 times a train step),
              with classes=[1] and agnostic_nms=True; request ms, launches,
              loader lane, checkpoint bytes and wall seconds; gate: 2 frames
              through the same checkpoint on the CPU (TF32 off, conf 0.001):
              equal kept counts, boxes < 0.05 px, scores <= 1e-3; and
              `python -m yolo_dbl_tpu_torch detect predict` in a process of
              its own prints the same counts;
 23. converge - the convergence run of record through the facade: yolov8n
              from random init on the shapes set (32 train, 16 val at 160 px),
              60 epochs, tests/test_convergence.py's arguments; gate: best val
              mAP50 >= 0.8 and best fitness > 0.2.
The rest of the v13/DBL family:
 24. main_dbl2, profile_dbl2, train_dbl2, train_profile_dbl2, parity_dbl2
              and their _bf16 phases (parity_dbl2_bf16: parity_bf16's bars) -
              YOLO-DBL2-l (yolov13l_DBL2, C3Ghost, nc=3, 640) as main,
              profile, train and parity: K1 and 3 K2 forward launches a
              request, 3 K2 forward and 3 backward launches a step (DySample
              at 128, 256 and 128 channels a group);
 25. family   - the other six configs (edit9, edit10, v3edit5_attn,
              v3edit5_attn2, v3edit6, edit_template) at scale s and 320:
              card decode against the CPU's on 2 frames (TF32 off; 0.05 px,
              1e-3) and one train step at batch 4 each, with each config's
              launches (edit9: K2; v3edit6, edit_template: K3; edit10 runs
              DLU, the v3edit5 pair SLA, neither a kernel); SLA's first
              module also card against CPU with non-zero proj_l and out_proj
              (inert at init) and its block top-k margin;
 26. facade_dbl2 - YOLO-DBL2-l through YOLO on the shapes set: train 1
              epoch (2 steps at batch 16, 640), val, predict 8 frames from
              memory; gate as facade's.
Data parallel (parallel/, Trainer(mesh=...); rank bodies in tests/torch_ranks.py):
 27. dp       - YOLO-DBL-s (nc=3, 640, global batch 16, 3 steps, TF32 off)
              through Trainer(mesh=...) against the one-process Trainer on
              the same weights and batches: NCCL at world 1 in this process,
              and Gloo at world 2 in two processes on this one card (8 rows
              each; NCCL refuses two ranks on one card, which the phase
              tries and prints), in float32 and bfloat16; loss items 1e-4,
              the first step's gradient 1e-3 of each leaf's largest (float64
              CPU where a leaf misses it by float32 order), BatchNorm
              statistics 1e-4, the parameters bit for bit equal on the
              ranks; bfloat16 within 4x the one-process bfloat16 step's
              distance from the float32 one; K2 forward and backward 3
              launches a step on every rank; per rank step ms, all-reduce ms
              and device-busy share.
The mesh's 'model' axis (parallel/shardings.py, tensor.py, spatial.py):
 28. tp       - YOLO-DBL-s (nc=3, 640, float32, TF32 off) tensor-parallel
              over Gloo on this one card: a 1x2 mesh (2 processes) and a 2x2
              mesh (4) train 3 steps at global batch 8 through
              Trainer(mesh=...) against the one-process Trainer, at dp's
              bars (replicated leaves and whole gathered parameters bit for
              bit equal on the ranks); each rank holds the specs' share of
              the parameter, EMA and moment bytes; then the 1x2 ranks serve
              3 requests of 8 u8 frames through a `shard_variables` model in
              float32 and bfloat16 (decode against the one-process float32
              one: 0.05 px and 1e-3, bf16 at parity_bf16's bars; float32
              kept counts equal); the collectives a step by kind and bytes,
              with the column -> row pairing and without it (one more step);
              K2 forward and backward 3 launches a step, K1 once and K2 3
              times a request, on every rank;
 29. sp       - YOLO-DBL-s (nc=3, 640, float32) spatial-parallel over Gloo
              1x2 on this card: 3 requests of 8 u8 frames through
              `spatial(model, mesh)` (320 image rows a rank, halo
              exchanges, DySample and the hypergraph on gathered maps),
              held as tp's serving; halo and gather bytes a request.
Then a line counting the profiler traces the kernel times took again ("timing"),
the kernel table line ({"kernels": [...]}, each row's `time_sources` saying
whether a time is the profiler's device time or, where three traces lost
kernel events, CUDA-event time), the card's name and power limit
from nvidia-smi, and last {"ok": true, "device": {...}}. Any failure raises and
exits non-zero before the result lines; without CUDA it exits 2.
"""

import contextlib
import functools
import json
import os
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
PEAK_TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_PASSES = 3  # 3xTF32: float32-accurate products on the tensor cores
MUFU_PER_CLOCK = 16  # exponentials a clock per SM on the special-function units (sm_90)
# bfloat16 terms a float32 P or dS is split into, for its product with a
# bfloat16 input to meet the bars: the fewest, as csrc/attention.cu ships them
# (tests/test_torch_attention_split.py emulates the forward's P V, dq's dS K
# and dkv's dV and dK, and holds this line to the source)
BF16_TERMS = {"forward": 2, "dq": 3, "dkv": 3}
TOL = 1e-5
B, SRC_HW, IMGSZ, NC = 8, (512, 768), 640, 3
REQUESTS, WARMUP = 5, 2
TRAIN_B, TRAIN_M, TRAIN_WARMUP, TRAIN_STEPS = 16, 16, 2, 10
# (H, W, C) of the DySample inputs of YOLO-DBL-s at 640 (rows 13, 18, 22); scale 2, 4 groups
DYSAMPLE_SITES = {"row13": (40, 40, 256), "row18": (20, 20, 512), "row22": (40, 40, 256)}
GROUPS = 4
# (H, W, C) of two of YOLO-DBL2-l's DySample inputs at 640 (rows 18 and 13;
# row 22 is row 13's shape): 256 and 128 channels a group
DBL2_SITES = {"dbl2_row18": (20, 20, 1024), "dbl2_row13": (40, 40, 512)}
DBL, V13, DBL2 = ("yolov13s_DBL.yaml", NC), ("yolov13s.yaml", 80), ("yolov13l_DBL2.yaml", NC)
SUFFIX = {DBL: "", V13: "_v13", DBL2: "_dbl2"}
# YOLOv13-s A2C2f sites at 640: (areas, N, heads) per image; each site runs
# 4 AAttn (2 repeats x 2 ABlocks), hd 32. Row 6: 40x40 tokens in 4 areas.
K3_SITES = {"row6": (4, 400, 4), "row8": (1, 400, 8)}
K3_CALLS_PER_SITE = 4
HD = 32
# kernel launches per request (serving) and per step (training) on each path
BF16 = torch.bfloat16
KERNELS = ("letterbox_normalize", "sample_bilinear", "sample_bilinear_backward",
           "area_attention", "area_attention_backward_dq", "area_attention_backward_dkv")
NO_LAUNCH = {name + suffix: 0 for suffix in ("", "_bf16") for name in KERNELS}


def _launches(counts, dtype):
    """Launch counts of the kernels of `dtype` ({name: n}), every other 0."""
    suffix = "_bf16" if dtype == BF16 else ""
    return {**NO_LAUNCH, **{name + suffix: n for name, n in counts.items()}}


PER_REQUEST = {(cfg, dt): _launches(c, dt) for dt in (torch.float32, BF16) for cfg, c in (
    (DBL, {"letterbox_normalize": 1, "sample_bilinear": 3}),
    (DBL2, {"letterbox_normalize": 1, "sample_bilinear": 3}),
    (V13, {"letterbox_normalize": 1, "area_attention": 8}))}
PER_STEP = {(cfg, dt): _launches(c, dt) for dt in (torch.float32, BF16) for cfg, c in (
    (DBL, {"sample_bilinear": 3, "sample_bilinear_backward": 3}),
    (DBL2, {"sample_bilinear": 3, "sample_bilinear_backward": 3}),
    (V13, {"area_attention": 8, "area_attention_backward_dq": 8,
           "area_attention_backward_dkv": 8}))}


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(what)


def _device_events(prof):
    """The device's kernel, copy and fill events of a trace: not the
    annotations that span a profiler step (`ProfilerStep*`), whose device
    time is the whole step's."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


def _trace(fn, calls):
    """The device events of fn(0), ..., fn(calls - 1), traced by
    torch.profiler. Tracing starts one warm-up call before the recorded ones
    (the profiler's schedule), so no recorded call runs while the profiler
    sets itself up."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn(0)
        torch.cuda.synchronize()
        prof.step()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        prof.step()
    return _device_events(prof)


# traces timings took, those it took again, and the times it gave from CUDA events
TRACES = {"traces": 0, "retaken": 0, "cuda_event_times": 0}


def timings(fn, iters, warmup=3, only=None):
    """(device_ms, call_ms, source) per call of fn(i). device_ms sums the
    device time of the kernels a call runs (torch.profiler), or of those
    whose name holds `only`, so host launch overhead does not count;
    call_ms is CUDA-event time over back-to-back calls, which does include
    it when the host is slower than the card. Every call launches the same
    kernels, so in a trace that kept them all each kernel's events number a
    multiple of `iters` (a check of the total alone passed a trace that had
    lost whole calls' records); one that did not is taken again, and after
    three such traces device_ms is call_ms and `source` says "cuda_event"
    (else "profiler")."""
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
    for attempt in range(3):
        TRACES["traces"] += 1
        TRACES["retaken"] += attempt > 0
        events = [e for e in _trace(fn, iters) if only is None or only in e.key]
        n_events = sum(e.count for e in events)
        device_us = sum(e.self_device_time_total for e in events)
        short = [(e.key[:60], e.count) for e in events if e.count % iters]
        if n_events and not short and device_us > 0:
            return device_us / 1e3 / iters, call_ms, "profiler"
        print(f"chip_smoke: a trace of {iters} calls held {n_events} kernel events, these not a "
              f"multiple of the calls: {short[:6]}", file=sys.stderr)
    TRACES["cuda_event_times"] += 1
    print("chip_smoke: torch.profiler lost kernel events in three traces; CUDA-event time "
          "used", file=sys.stderr)
    return call_ms, call_ms, "cuda_event"


def source_of(*sources):
    """One source for a time summed from timings of these sources."""
    return "profiler" if set(sources) == {"profiler"} else "cuda_event"


def _larger(t_bytes, t_ops):
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound(n_bytes, n_flops, peak_flops=PEAK_FP32_FLOPS):
    return _larger(n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops)


@functools.cache
def sm_clock_max_mhz():
    """The card's top SM clock, as nvidia-smi gives it (clocks.max.sm)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def mufu_per_s():
    """Exponentials a second on the card's special-function units:
    MUFU_PER_CLOCK a clock per SM at the top SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return MUFU_PER_CLOCK * sms * sm_clock_max_mhz() * 1e6


def bound_products(dtype, n_bytes, input_flops, mixed_flops, exps, terms):
    """{bound_ms, bound_by, bound_route, bound_simt_ms, bound_mufu_ms} of
    area attention: the largest of three times. The bytes. The matrix
    products at the accuracy the bars ask for, on the faster of two routes:
    `input_flops` are products of two inputs (q kT, dO vT), `mixed_flops`
    products of a float32 intermediate (P, dS) and an input. On the CUDA
    cores fp32 FMAs (bound_simt_ms: that route with the bytes). On the
    tensor cores float32 inputs take 3 TF32 passes a product (3xTF32).
    bfloat16 inputs are exact in bfloat16, and the product of two is exact
    in float32: one bfloat16 pass; a float32 intermediate times a bfloat16
    input takes one bfloat16 pass a term of the intermediate, `terms` the
    fewest that meet the bars (BF16_TERMS; 2 or 3 bfloat16 passes beat the
    2 TF32 passes, each at half the bfloat16 rate, that the same product
    takes with its bfloat16 input exact in TF32). And the `exps`
    exponentials (one a score) on the special-function units
    (bound_mufu_ms, at mufu_per_s). bound_by is "bytes" or "operations";
    bound_route says which of bytes, products and mufu sets the bound."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    if dtype == BF16:
        t_tensor = (input_flops + terms * mixed_flops) / PEAK_BF16_FLOPS
    else:
        t_tensor = TF32_PASSES * (input_flops + mixed_flops) / PEAK_TF32_FLOPS
    t_products = min(t_tensor, (input_flops + mixed_flops) / PEAK_FP32_FLOPS)
    t_mufu = exps / mufu_per_s()
    bound_ms, bound_by = _larger(t_bytes, max(t_products, t_mufu))
    route = ("bytes" if bound_by == "bytes" else "products" if t_products >= t_mufu else "mufu")
    return dict(bound_ms=bound_ms, bound_by=bound_by, bound_route=route,
                bound_simt_ms=bound(n_bytes, input_flops + mixed_flops)[0],
                bound_mufu_ms=t_mufu * 1e3)


def bf16_excess(got, want, scale):
    """(max |got - want|, the largest excess over one bfloat16 step of `want`
    plus 1e-6 of `scale`: <= 0 passes). Both are float32 results of the same
    sums in other orders, each rounded once to bfloat16; near 0 the rounding
    of the float32 sums' last bits shows, hence the floor."""
    require(got.dtype == want.dtype == BF16, f"expected bfloat16, got {got.dtype}, {want.dtype}")
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    d = (g - w).abs()
    return float(d.max()), float((d - ulp - 1e-6 * scale).max())


def meets_bar(got, want, f32_bar, scale):
    """Whether a kernel's result meets its bar against the plain version's:
    float32 within `f32_bar`; bfloat16 within one bfloat16 step of `want`
    plus 1e-6 of `scale` (bf16_excess)."""
    if got.dtype == BF16:
        return bf16_excess(got, want, scale)[1] <= 0
    return float((got - want).abs().max()) <= f32_bar


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def _kphase(base, dtype):
    """The name of kernel phase `base` for a type: `k2`, `k2_bf16`, ..."""
    return base + ("_bf16" if dtype == BF16 else "")


BF16_BAR = "one bfloat16 step + 1e-6 of the terms' scale"


def copies_for(n_bytes):
    """Input copies to rotate through so a timed loop reads past the 50 MB L2."""
    return max(2, int(np.ceil(100e6 / n_bytes)))


# (batch, frame, canvas) of the odd geometry k1 checks: canvas width 330, 4
# rows of top pad, 333 x 3 bytes a frame row, frames starting mid-chunk
K1_ODD = (2, (251, 333), (257, 330))


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
    ob, o_in, o_out = K1_ODD
    odd = torch.randint(0, 256, (ob + 1, *o_in, 3), dtype=torch.uint8, generator=gen).cuda()[1:]
    odd_err = {str(dt).split(".")[-1]: float((letterbox_normalize(odd, o_out, out_dtype=dt).float()
                                              - letterbox_normalize_plain(odd, o_out, out_dtype=dt)
                                              .float()).abs().max())
               for dt in (torch.float32, torch.bfloat16)}
    require(odd_err["float32"] <= TOL and odd_err["bfloat16"] <= 4e-3,
            f"letterbox kernel vs plain at {K1_ODD}: {odd_err}")

    _, new_h, new_w, top, left = letterbox_geometry(*SRC_HW, IMGSZ, IMGSZ, scaleup=False)

    def library(f):
        x = F.interpolate(f.permute(0, 3, 1, 2).float(), size=(new_h, new_w), mode="bilinear",
                          align_corners=False, antialias=False)
        x = F.pad(x, (left, IMGSZ - new_w - left, top, IMGSZ - new_h - top), value=114.0)
        return x / 255.0

    lib_err = float((library(frames[0]).permute(0, 2, 3, 1) - out).abs().max())
    n = len(frames)
    ms, call_ms, s1 = timings(lambda i: letterbox_normalize(frames[i % n], (IMGSZ, IMGSZ)), 50)
    ms_bf16, call_ms_bf16, s1_bf16 = timings(lambda i: letterbox_normalize(
        frames[i % n], (IMGSZ, IMGSZ), out_dtype=torch.bfloat16), 50)
    plain_ms, plain_call_ms, s2 = timings(
        lambda i: letterbox_normalize_plain(frames[i % n], (IMGSZ, IMGSZ)), 10)
    plain_ms_bf16, _, s2_bf16 = timings(lambda i: letterbox_normalize_plain(
        frames[i % n], (IMGSZ, IMGSZ), out_dtype=torch.bfloat16), 10)
    library_ms, library_call_ms, s3 = timings(lambda i: library(frames[i % n]), 20)
    library_ms_bf16, _, s3_bf16 = timings(lambda i: library(frames[i % n]).to(torch.bfloat16), 20)
    n_in, n_out = B * SRC_HW[0] * SRC_HW[1] * 3, B * IMGSZ * IMGSZ * 3
    # per output value: 2 row blends + 1 column blend (3 ops each) and the /255
    bound_ms, bound_by = bound(n_in + n_out * 4, B * new_h * new_w * 3 * 10)
    bound_ms_bf16, bound_by_bf16 = bound(n_in + n_out * 2, B * new_h * new_w * 3 * 10)
    common = dict(route="cuda", source="yolo_dbl_tpu_torch/csrc/preprocess.cu",
                  replaces="yolo_dbl_tpu/kernels/preprocess.py:144")
    row = dict(name="letterbox_normalize", max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               time_sources=_time_sources([(s1, s2, s3)]), **common)
    row_bf16 = dict(name="letterbox_normalize_bf16", max_abs_err=err_bf16, ms=ms_bf16,
                    plain_ms=plain_ms_bf16, bound_ms=bound_ms_bf16, bound_by=bound_by_bf16,
                    library_ms=library_ms_bf16,
                    time_sources=_time_sources([(s1_bf16, s2_bf16, s3_bf16)]), **common)
    emit({"phase": "k1", "shape": [B, *SRC_HW, 3], "out": [B, IMGSZ, IMGSZ, 3],
          "max_abs_err_f32": err, "max_abs_err_bf16": err_bf16, "library_vs_kernel": lib_err,
          "odd_geometry": {"batch": ob, "frame": list(o_in), "canvas": list(o_out),
                           "max_abs_err": odd_err},
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
          "ms_bf16": ms_bf16, "bound_ms_bf16": bound_ms_bf16, "plain_ms_bf16": plain_ms_bf16,
          "library_ms_bf16": library_ms_bf16,
          "call_ms": call_ms, "call_ms_bf16": call_ms_bf16, "plain_call_ms": plain_call_ms,
          "library_call_ms": library_call_ms})
    return row, row_bf16


def _site_coords(gen, h, w, s=2, b=B, dtype=torch.float32):
    """DySample-like pixel coordinates (B, N, G) in `dtype`: each output point
    near its source position with offsets of about a pixel, so edges clip."""
    oy = (torch.arange(h * s, dtype=torch.float32) + 0.5) / s - 0.5
    ox = (torch.arange(w * s, dtype=torch.float32) + 0.5) / s - 0.5
    gy, gx = torch.meshgrid(oy, ox, indexing="ij")
    shape = (b, h * s * w * s, GROUPS)
    gy = gy.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    gx = gx.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    return gy.cuda().to(dtype).contiguous(), gx.cuda().to(dtype).contiguous()


def _site_inputs(gen, b, h, w, c, dtype, n_bytes):
    """Copies of a site's x (B, H, W, C) in `dtype`, to rotate through so a
    timed loop reads past L2 (`n_bytes` a copy, with what is read beside it)."""
    return [torch.randn((b, h, w, c), generator=gen).cuda().to(dtype)
            for _ in range(copies_for(n_bytes))]


def _uniform_coords(gen, gy, h, w, dtype):
    """Coordinates drawn uniformly over the image and a pixel past its edges."""
    uy = (torch.rand(gy.shape, generator=gen) * (h + 2) - 1.5).cuda().to(dtype)
    ux = (torch.rand(gy.shape, generator=gen) * (w + 2) - 1.5).cuda().to(dtype)
    return uy, ux


def _library_layout(xs, gy, gx):
    """The library yardstick's layout: F.grid_sample over (B*G, C/G, H, W)
    planes of each NHWC x, with one normalized grid per group, in x's type
    (formed in float32)."""
    b, h, w, c = xs[0].shape
    cg = c // GROUPS
    planes = [x.reshape(b, h, w, GROUPS, cg).permute(0, 3, 4, 1, 2).reshape(b * GROUPS, cg, h, w)
              .contiguous() for x in xs]
    gy, gx = gy.float(), gx.float()
    grid = torch.stack([(gx + 0.5) * 2 / w - 1, (gy + 0.5) * 2 / h - 1], -1)
    grid = grid.permute(0, 2, 1, 3).reshape(b * GROUPS, 2 * h, 2 * w, 2).to(xs[0].dtype)
    return planes, grid.contiguous()


def _by(rows, key="bound_by"):
    return "bytes" if {r[key] for r in rows} == {"bytes"} else "operations"


def _route(rows, prefix=""):
    """The route that bounds every site, or "mixed"."""
    routes = {r[prefix + "bound_route"] for r in rows}
    return routes.pop() if len(routes) == 1 else "mixed"


def phase_k2(gen, dtype=torch.float32):
    """The sampler's forward kernel of `dtype` against its plain version at
    the three sites at serving batch 8, both padding modes, DySample and
    uniform coordinates; F.grid_sample in `dtype` as the yardstick."""
    from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear, sample_bilinear_plain

    es, sites, worst, src = dtype.itemsize, {}, 0.0, []
    for site, (h, w, c) in {**DYSAMPLE_SITES, **DBL2_SITES}.items():
        n_x = B * h * w * c
        xs = _site_inputs(gen, B, h, w, c, dtype, n_x * es)
        gy, gx = _site_coords(gen, h, w, dtype=dtype)
        uy, ux = _uniform_coords(gen, gy, h, w, dtype)
        x_max, errs, ok = float(xs[0].abs().max()), {}, True
        for mode in ("border", "zeros"):
            for name, (cy, cx) in {"dysample": (gy, gx), "uniform": (uy, ux)}.items():
                got = sample_bilinear(xs[0], cy, cx, mode)
                want = sample_bilinear_plain(xs[0], cy, cx, mode)
                errs[f"{mode}/{name}"] = max_abs(got, want)
                ok = ok and meets_bar(got, want, TOL, x_max)
        require(ok, f"sampler kernel vs plain at {site} ({dtype}): {errs}")
        worst = max(worst, max(errs.values()))

        cg, n = c // GROUPS, gy.shape[1]
        planes, grid = _library_layout(xs, gy, gx)

        def library(p):
            return F.grid_sample(p, grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        lib = library(planes[0]).reshape(B, GROUPS, cg, n).permute(0, 3, 1, 2).reshape(B, n, c)
        lib_err = max_abs(lib, sample_bilinear(xs[0], gy, gx))
        k = len(xs)
        ms, call_ms, s1 = timings(lambda i: sample_bilinear(xs[i % k], gy, gx), 50)
        plain_ms, plain_call_ms, s2 = timings(lambda i: sample_bilinear_plain(xs[i % k], gy, gx),
                                              10)
        library_ms, library_call_ms, s3 = timings(lambda i: library(planes[i % k]), 50)
        src.append((s1, s2, s3))
        # x read, out written, the coordinates read
        n_bytes = (n_x + B * n * c + 2 * B * n * GROUPS) * es
        bound_ms, bound_by = bound(n_bytes, B * n * c * 11)
        sites[site] = dict(x=[B, h, w, c], n=n, groups=GROUPS, max_abs_err=errs,
                           library_vs_kernel=lib_err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                           call_ms=call_ms, plain_call_ms=plain_call_ms,
                           library_call_ms=library_call_ms)
    emit({"phase": _kphase("k2", dtype), "sites": sites,
          **({"tolerance": BF16_BAR} if dtype == BF16 else {})})
    total = {key: sum(sites[s][key] for s in DYSAMPLE_SITES)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(name=_kphase("sample_bilinear", dtype), route="cuda",
                source="yolo_dbl_tpu_torch/csrc/sampling.cu",
                replaces="yolo_dbl_tpu/kernels/sampling.py:102", max_abs_err=worst,
                bound_by=_by(sites[s] for s in DYSAMPLE_SITES), time_sources=_time_sources(src),
                dbl2_l_sites=_dbl2_sites(sites, ("max_abs_err", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")), **total)


def _dbl2_sites(sites, keys):
    """The YOLO-DBL2-l sites' numbers for a kernel row (its own totals are
    YOLO-DBL-s's three sites, a request or step of its path)."""
    return {site: {"x": sites[site]["x"], "channels_a_group": sites[site]["x"][3] // GROUPS,
                   **{k: sites[site][k] for k in keys}} for site in DBL2_SITES}


def _time_sources(src, keys=("ms", "plain_ms", "library_ms")):
    """{row time: its source} from the sites' (source, ...) tuples."""
    return {key: source_of(*col) for key, col in zip(keys, zip(*src))}


def phase_k2_backward(gen, dtype=torch.float32):
    """The sampler's backward kernel of `dtype` at the three sites at
    training batch 16, and its forward kernel at the same shapes (the train
    step runs both), against their plain versions. Returns the backward's
    kernel row and the forward's worst error here."""
    from yolo_dbl_tpu_torch.kernels.sampling import (backward_shared_bytes,
                                                     backward_window_misses, sample_bilinear,
                                                     sample_bilinear_backward,
                                                     sample_bilinear_backward_plain,
                                                     sample_bilinear_plain)

    b, es, sites, src = TRAIN_B, dtype.itemsize, {}, []
    worst, worst_fwd = {"dx": 0.0, "dgy_rel": 0.0, "dgx_rel": 0.0}, 0.0
    for site, (h, w, c) in {**DYSAMPLE_SITES, **DBL2_SITES}.items():
        n_x, n, cg = b * h * w * c, 4 * h * w, c // GROUPS
        xs = _site_inputs(gen, b, h, w, c, dtype, (n_x + b * n * c) * es)
        k = len(xs)
        gs = [torch.randn((b, n, c), generator=gen).cuda().to(dtype) for _ in range(k)]
        gy, gx = _site_coords(gen, h, w, b=b, dtype=dtype)
        uy, ux = _uniform_coords(gen, gy, h, w, dtype)
        x_max, g_max = float(xs[0].abs().max()), float(gs[0].abs().max())
        errs, fwd_errs, missed, ok = {}, {}, {}, True
        for mode in ("border", "zeros"):
            for name, (cy, cx) in {"dysample": (gy, gx), "uniform": (uy, ux)}.items():
                case = f"{mode}/{name}"
                got = sample_bilinear(xs[0], cy, cx, mode)
                want = sample_bilinear_plain(xs[0], cy, cx, mode)
                fwd_errs[case] = max_abs(got, want)
                require(meets_bar(got, want, TOL, x_max),
                        f"sampler kernel vs plain at {site}, batch {b} ({dtype}): {case} "
                        f"{fwd_errs[case]}")
                # the window is the coordinates' (the kernels form taps in
                # float32 from either type): read on the counted float32 build
                taps, miss = backward_window_misses(*(t.float() for t in (xs[0], cy, cx, gs[0])),
                                                    mode)
                missed[case] = miss / taps
                got = sample_bilinear_backward(xs[0], cy, cx, gs[0], mode)
                want = sample_bilinear_backward_plain(xs[0], cy, cx, gs[0], mode)
                e = {"dx": max_abs(got[0], want[0])}
                e.update({f"{nm}_rel": max_abs(a, r) / float(r.float().abs().max())
                          for nm, a, r in zip(("dgy", "dgx"), got[1:], want[1:])})
                errs[case] = e
                worst = {key: max(worst[key], e[key]) for key in worst}
                ok = ok and meets_bar(got[0], want[0], 1e-4, 4 * g_max) and all(
                    meets_bar(a, r, 1e-4 * float(r.abs().max()), cg * g_max * x_max)
                    for a, r in zip(got[1:], want[1:]))
        require(ok, f"sampler backward kernel vs plain at {site} ({dtype}): {errs}")
        worst_fwd = max(worst_fwd, max(fwd_errs.values()))

        planes, grid = _library_layout(xs, gy, gx)
        planes = [p.requires_grad_() for p in planes]
        grid.requires_grad_()
        g_planes = [g.reshape(b, 2 * h, 2 * w, GROUPS, cg).permute(0, 3, 4, 1, 2)
                    .reshape(b * GROUPS, cg, 2 * h, 2 * w).contiguous() for g in gs]

        def library(i):
            out = F.grid_sample(planes[i % k], grid, mode="bilinear", padding_mode="border",
                                align_corners=False)
            return torch.autograd.grad(out, (planes[i % k], grid), g_planes[i % k])

        ms, call_ms, s1 = timings(lambda i: sample_bilinear_backward(xs[i % k], gy, gx, gs[i % k]),
                                  30)
        plain_ms, plain_call_ms, s2 = timings(
            lambda i: sample_bilinear_backward_plain(xs[i % k], gy, gx, gs[i % k]), 5)
        library_ms, _, s3 = timings(library, 20, only="grid_sampler_2d_backward")
        # the zero fill of the float32 sums that the window sums and missed
        # taps are added into (dx itself for float32); it is part of `ms`
        zero_fill_ms, _, s4 = timings(lambda i: torch.zeros(xs[i % k].shape, device="cuda"), 30)
        src.append((s1, s2, s3, s4))
        # the function's own I/O: x and g read, dx written, coordinates read
        # and their gradients written; bfloat16 adds its float32 sums (the
        # zero fill writes them, the rounding pass reads them), float32's
        # zero fill is this design's cost
        n_bytes = (n_x + b * n * c + n_x + 4 * b * n * GROUPS) * es
        scratch = 8 * n_x if dtype == BF16 else 0
        bound_ms, bound_by = bound(n_bytes + scratch, b * n * c * 24)
        sites[site] = dict(x=[b, h, w, c], n=n, groups=GROUPS, errors=errs,
                           forward_errors=fwd_errs, window_missed_share=missed,
                           shared_bytes=backward_shared_bytes(c, GROUPS), ms=ms,
                           zero_fill_ms=zero_fill_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=n_bytes + scratch, call_ms=call_ms,
                           plain_call_ms=plain_call_ms)
        if scratch:
            sites[site]["bound_ms_without_scratch"] = bound(n_bytes, b * n * c * 24)[0]
    tolerance = BF16_BAR if dtype == BF16 else {"dx": 1e-4, "dg_rel": 1e-4, "forward": TOL}
    emit({"phase": _kphase("k2_backward", dtype), "batch": b, "tolerance": tolerance,
          "forward_max_abs_err": worst_fwd, "sites": sites})
    keys = ("ms", "zero_fill_ms", "plain_ms", "library_ms", "bound_ms")
    if dtype == BF16:
        keys += ("bound_ms_without_scratch",)
    total = {key: sum(sites[st][key] for st in DYSAMPLE_SITES) for key in keys}
    return dict(name=_kphase("sample_bilinear_backward", dtype), route="cuda",
                source="yolo_dbl_tpu_torch/csrc/sampling.cu",
                replaces="yolo_dbl_tpu/kernels/sampling.py:142", max_abs_err=worst["dx"],
                max_rel_err_dgy_dgx=max(worst["dgy_rel"], worst["dgx_rel"]),
                bound_by=_by(sites[st] for st in DYSAMPLE_SITES),
                dbl2_l_sites=_dbl2_sites(sites, ("ms", "zero_fill_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "window_missed_share",
                                                 "shared_bytes")),
                time_sources=_time_sources(src, ("ms", "plain_ms", "library_ms", "zero_fill_ms")),
                **total), worst_fwd


def _k3_inputs(gen, b, site, dtype=torch.float32):
    """Copies (to rotate past L2) of AAttn's packed (BB, N, H, 3 x 32) qkv
    tensor in `dtype` at one site, as (q, k, v) views, and the shape
    (BB, N, H)."""
    areas, n, h = K3_SITES[site]
    bb = b * areas
    k = copies_for(bb * n * h * 3 * HD * dtype.itemsize)
    packs = [torch.randn((bb, n, h, 3 * HD), generator=gen).cuda().to(dtype) for _ in range(k)]
    return [p.split(HD, -1) for p in packs], (bb, n, h)


def _sdpa_layout(qkvs):
    """The library yardstick's layout: contiguous (BB, H, N, hd) copies."""
    return [tuple(t.transpose(1, 2).contiguous() for t in qkv) for qkv in qkvs]


K3_REPLACES = "yolo_dbl_tpu/nn/blocks.py:883 -> jax 0.9.0 pallas/ops/tpu/flash_attention.py:"


def phase_k3(gen, dtype=torch.float32):
    """The forward kernel of `dtype` at the two YOLOv13-s A2C2f sites at
    serving batch 8, on the packed qkv views AAttn passes. Times are per
    call; the row sums the 8 calls of a request."""
    from yolo_dbl_tpu_torch.kernels.attention import (area_attention_forward,
                                                      area_attention_lse_plain,
                                                      area_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsums in full fp32
    es, sites, worst, src = dtype.itemsize, {}, 0.0, []
    for site in K3_SITES:
        qkvs, (bb, n, h) = _k3_inputs(gen, B, site, dtype)
        o, lse = area_attention_forward(*qkvs[0])
        plain, plain_lse = area_attention_plain(*qkvs[0]), area_attention_lse_plain(*qkvs[0][:2])
        err, lse_err = max_abs(o, plain), max_abs(lse, plain_lse)
        require(meets_bar(o, plain, TOL, float(qkvs[0][2].abs().max())) and lse_err <= TOL,
                f"area attention kernel vs plain at {site} ({dtype}): out {err}, lse {lse_err}")
        worst = max(worst, err)
        again = area_attention_forward(*qkvs[0])
        require(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
                f"area attention forward at {site} ({dtype}): a second run gave other bits")
        # both sides against float64 (read, not gated)
        qkv64 = [t.double() for t in qkvs[0]]
        o64, lse64 = area_attention_plain(*qkv64), area_attention_lse_plain(*qkv64[:2])
        vs64 = {name: [float((a.double() - r).abs().max()) for a in pair]
                for name, pair, r in (("o", (o, plain), o64), ("lse", (lse, plain_lse), lse64))}
        lib = _sdpa_layout(qkvs)
        lib_err = max_abs(F.scaled_dot_product_attention(*lib[0]).transpose(1, 2), o)
        k = len(qkvs)
        ms, call_ms, s1 = timings(lambda i: area_attention_forward(*qkvs[i % k]), 50)
        plain_ms, plain_call_ms, s2 = timings(lambda i: area_attention_plain(*qkvs[i % k]), 10)
        library_ms, library_call_ms, s3 = timings(
            lambda i: F.scaled_dot_product_attention(*lib[i % k]), 50)
        src.append((s1, s2, s3))
        tokens, rows = bb * n * h * HD, bb * h * n
        # q, k, v read, o written, lse (float32) written; the products q kT
        # (two inputs) and P v (P float32), 2 N^2 hd each per sequence-head
        # (one exponential a score)
        product = bb * h * 2 * n * n * HD
        bounds = bound_products(dtype, 4 * tokens * es + rows * 4, product, product, bb * h * n * n,
                                BF16_TERMS["forward"])
        sites[site] = dict(qkv=[bb, n, h, HD], calls_per_request=K3_CALLS_PER_SITE,
                           max_abs_err=err, lse_max_abs_err=lse_err, bitwise_repeat=True,
                           kernel_and_plain_max_abs_vs_float64=vs64, library_vs_kernel=lib_err,
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bounds,
                           call_ms=call_ms, plain_call_ms=plain_call_ms,
                           library_call_ms=library_call_ms)
    tolerance = {"o": BF16_BAR, "lse": TOL} if dtype == BF16 else TOL
    emit({"phase": _kphase("k3", dtype), "batch": B, "tolerance": tolerance, "tf32_matmul": False,
          "sites": sites})
    total = {key: K3_CALLS_PER_SITE * sum(st[key] for st in sites.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_simt_ms",
                         "bound_mufu_ms")}
    return dict(name=_kphase("area_attention", dtype), route="cuda",
                source="yolo_dbl_tpu_torch/csrc/attention.cu",
                replaces=K3_REPLACES + "758 (forward)", max_abs_err=worst,
                bound_by=_by(sites.values()), bound_route=_route(sites.values()),
                time_sources=_time_sources(src), **total)


def phase_k3_backward(gen, dtype=torch.float32):
    """The dq and dkv kernels (and the forward kernel) of `dtype` at the two
    sites at training batch 16, against the plain versions; a second
    backward on the same inputs must give the same bits. Returns the dkv and
    dq kernel rows (times summed over the 8 calls of a step) and the
    forward's worst error at these shapes."""
    from yolo_dbl_tpu_torch.kernels.attention import (area_attention_backward,
                                                      area_attention_backward_plain,
                                                      area_attention_forward,
                                                      area_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    b, es, sites, src = TRAIN_B, dtype.itemsize, {}, []
    worst, worst_fwd = {"dq": 0.0, "dk": 0.0, "dv": 0.0}, 0.0
    worst_rel = dict(worst)
    for site in K3_SITES:
        qkvs, (bb, n, h) = _k3_inputs(gen, b, site, dtype)
        k = len(qkvs)
        grads = [torch.randn((bb, n, h, HD), generator=gen).cuda().to(dtype) for _ in range(k)]
        fwd = [area_attention_forward(*qkv, residual=True) for qkv in qkvs]
        saved = [(o32, lse) for _, lse, o32 in fwd]  # what the backward reads
        o, plain_o = fwd[0][0], area_attention_plain(*qkvs[0])
        fwd_err = max_abs(o, plain_o)
        require(meets_bar(o, plain_o, TOL, float(qkvs[0][2].abs().max())),
                f"area attention kernel vs plain at {site}, batch {b} ({dtype}): {fwd_err}")
        worst_fwd = max(worst_fwd, fwd_err)
        got = area_attention_backward(*qkvs[0], *saved[0], grads[0])
        want = area_attention_backward_plain(*qkvs[0], grads[0])
        errs = {name: max_abs(a, r) for name, a, r in zip(("dq", "dk", "dv"), got, want)}
        rel = {name: errs[name] / float(r.float().abs().max()) for name, r in zip(errs, want)}
        # dq and dk are near 0 where a row's attention is near uniform: their
        # bfloat16 bar's floor is 1e-6 of 1e-2 of dv's largest
        floor = 1e-2 * float(want[2].float().abs().max())
        require(all(meets_bar(a, r, 1e-4 * float(r.abs().max()),
                              max(float(r.float().abs().max()), floor))
                    for a, r in zip(got, want)),
                f"area attention backward kernels vs plain at {site} ({dtype}): {errs}, of "
                f"each largest {rel}")
        again = area_attention_backward(*qkvs[0], *saved[0], grads[0])
        require(all(torch.equal(a, r) for a, r in zip(got, again)),
                f"area attention backward at {site} ({dtype}): a second run gave other bits")
        # both sides against float64 autograd (read, not gated)
        leaves64 = [t.detach().double().requires_grad_() for t in qkvs[0]]
        want64 = torch.autograd.grad(area_attention_plain(*leaves64), leaves64, grads[0].double())
        rel64 = {name: [float((x.double() - r).abs().max() / r.abs().max()) for x in (a, w)]
                 for name, a, w, r in zip(errs, got, want, want64)}
        worst = {key: max(worst[key], errs[key]) for key in worst}
        worst_rel = {key: max(worst_rel[key], rel[key]) for key in worst_rel}

        def backward(i):
            return area_attention_backward(*qkvs[i % k], *saved[i % k], grads[i % k])

        def plain(i, wrt):
            qkv = [t.detach().requires_grad_(j in wrt) for j, t in enumerate(qkvs[i % k])]
            return torch.autograd.grad(area_attention_plain(*qkv), [qkv[j] for j in wrt],
                                       grads[i % k])

        lib = [tuple(t.requires_grad_() for t in qkv) for qkv in _sdpa_layout(qkvs)]
        lib_g = [g.transpose(1, 2).contiguous() for g in grads]

        def library(i):
            out = F.scaled_dot_product_attention(*lib[i % k])
            return torch.autograd.grad(out, lib[i % k], lib_g[i % k])

        dq_ms, call_ms, s1 = timings(backward, 30, only="attention_bwd_dq_kernel")
        dkv_ms, _, s2 = timings(backward, 30, only="attention_bwd_dkv_kernel")
        plain_dq_ms, _, s3 = timings(lambda i: plain(i, (0,)), 5)
        plain_dkv_ms, _, s4 = timings(lambda i: plain(i, (1, 2)), 5)
        lib_total_ms, _, s5 = timings(library, 20)
        lib_fwd_ms, _, s6 = timings(lambda i: F.scaled_dot_product_attention(*lib[i % k]), 20)
        src.append((s1, s2, s3, s4, source_of(s5, s6)))
        tokens, rows = bb * n * h * HD, bb * h * n
        # The products each kernel must form from its inputs, 2 N^2 hd each
        # per sequence-head: dq: S = q kT and dP = dO vT (two inputs), dQ =
        # dS k (dS float32); dkv: S and dP again, dV = PT dO and dK = dST q.
        # dq: q, k, v, dO read and dq written in the inputs' type, o (float32)
        # and lse read, delta written; dkv: q, k, v, dO read and dk, dv
        # written in the inputs' type, lse and delta read
        # Each forms P again: one exponential a score.
        product, scores = bb * h * 2 * n * n * HD, bb * h * n * n
        dq_bytes = 5 * tokens * es + tokens * 4 + 2 * rows * 4
        dq_b = bound_products(dtype, dq_bytes, 2 * product, product, scores, BF16_TERMS["dq"])
        dkv_b = bound_products(dtype, 6 * tokens * es + 2 * rows * 4, 2 * product, 2 * product,
                               scores, BF16_TERMS["dkv"])
        sites[site] = dict(qkv=[bb, n, h, HD], calls_per_step=K3_CALLS_PER_SITE,
                           max_abs_errors=errs, rel_errors_of_largest=rel, bitwise_repeat=True,
                           kernel_and_plain_rel_errors_vs_float64=rel64,
                           forward_max_abs_err=fwd_err,
                           dq_ms=dq_ms, dkv_ms=dkv_ms, backward_call_ms=call_ms,
                           plain_dq_ms=plain_dq_ms, plain_dkv_ms=plain_dkv_ms,
                           library_backward_ms=lib_total_ms - lib_fwd_ms,
                           library_forward_backward_ms=lib_total_ms,
                           **{f"dq_{key}": val for key, val in dq_b.items()},
                           **{f"dkv_{key}": val for key, val in dkv_b.items()})
    tolerance = ({"d": BF16_BAR + " (floor: 1e-2 of dv's largest)", "forward": BF16_BAR}
                 if dtype == BF16 else {"d_rel_of_largest": 1e-4, "forward": TOL})
    emit({"phase": _kphase("k3_backward", dtype), "batch": b, "tf32_matmul": False,
          "tolerance": tolerance, "forward_max_abs_err": worst_fwd, "sites": sites})

    def total(key):
        return K3_CALLS_PER_SITE * sum(st[key] for st in sites.values())

    common = dict(route="cuda", source="yolo_dbl_tpu_torch/csrc/attention.cu",
                  library_ms=total("library_backward_ms"),
                  library_scope="SDPA backward, dq dk dv together")
    dkv = dict(name=_kphase("area_attention_backward_dkv", dtype),
               replaces=K3_REPLACES + "1121 (bwd dkv)",
               max_abs_err=max(worst["dk"], worst["dv"]),
               max_rel_err_of_largest=max(worst_rel["dk"], worst_rel["dv"]),
               ms=total("dkv_ms"), plain_ms=total("plain_dkv_ms"), bound_ms=total("dkv_bound_ms"),
               bound_by=_by(sites.values(), "dkv_bound_by"),
               bound_route=_route(sites.values(), "dkv_"),
               bound_simt_ms=total("dkv_bound_simt_ms"), bound_mufu_ms=total("dkv_bound_mufu_ms"),
               time_sources=_time_sources([(s[1], s[3], s[4]) for s in src]), **common)
    dq = dict(name=_kphase("area_attention_backward_dq", dtype),
              replaces=K3_REPLACES + "1456 (bwd dq)",
              max_abs_err=worst["dq"], max_rel_err_of_largest=worst_rel["dq"],
              ms=total("dq_ms"), plain_ms=total("plain_dq_ms"), bound_ms=total("dq_bound_ms"),
              bound_by=_by(sites.values(), "dq_bound_by"),
              bound_route=_route(sites.values(), "dq_"),
              bound_simt_ms=total("dq_bound_simt_ms"), bound_mufu_ms=total("dq_bound_mufu_ms"),
              time_sources=_time_sources([(s[0], s[2], s[4]) for s in src]), **common)
    return dkv, dq, worst_fwd


def build_models(cfg, dtype=torch.float32, zero_class_bias=True):
    """One seeded model of `cfg` computing in `dtype` on the CPU with the
    smoke settings, and its copy on the card (the same weights in both
    types: parameters are float32). `zero_class_bias=False` keeps the Detect
    class biases of the model's own init (the stride-aware prior), whose
    spread of scores keeps NMS away from near-ties at a low threshold."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.nn.blocks import FullPAD_Tunnel

    name, nc = cfg
    cpu = DetectionModel(name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0),
                         dtype=dtype)
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, FullPAD_Tunnel):
                mod.gate.fill_(0.5)  # gates start at 0, which would hide the tunnel inputs
        for lvl in range(len(cpu.strides) if zero_class_bias else 0):
            getattr(cpu.detect, f"cv3_{lvl}_2").conv.bias.zero_()  # give NMS real candidates
    gpu = DetectionModel(name, nc=nc, device="cuda", dtype=dtype)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _phase(base, cfg, dtype=torch.float32):
    """The phase name of `base` for a model and type: `main`, `main_v13`,
    `main_dbl2`, `main_bf16`, `main_v13_bf16`, ..."""
    return base + SUFFIX[cfg] + ("_bf16" if dtype == BF16 else "")


def phase_main(cfg, gpu_model, rng, card):
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
    dtype = gpu_model.dtype
    want = {k: v * REQUESTS for k, v in PER_REQUEST[cfg, dtype].items()}
    require(launches == want, f"launches in {REQUESTS} requests: {launches}, expected {want}")
    require(sum(map(sum, n_boxes)) > 0, "no detections: NMS saw no candidates")
    med = statistics.median(lat)
    emit({"phase": _phase("main", cfg, dtype), "model": cfg[0][:-5], "nc": cfg[1],
          "dtype": str(dtype).split(".")[-1], "imgsz": IMGSZ,
          "batch": B, "frames": list(SRC_HW), "requests": REQUESTS,
          "latency_ms": [t * 1e3 for t in lat], "median_ms": med * 1e3, "img_per_s": B / med,
          "boxes_per_image": n_boxes, "launches": launches,
          "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})
    return launches, requests[WARMUP][:2], pred, med


# substrings of device event names → the part of a path they belong to (first match)
_CATEGORIES = (("letterbox", "k1 letterbox"), ("sample_bilinear_backward", "k2 sampler backward"),
               ("sample_bilinear", "k2 sampler"), ("attention_bwd", "k3 attention backward"),
               ("attention_fwd", "k3 attention"), ("memcpy", "memcpy"), ("memset", "memset"),
               ("bn_fw", "batchnorm"), ("bn_bw", "batchnorm"), ("batch_norm", "batchnorm"),
               ("batchnorm", "batchnorm"), ("conv", "convolution"), ("xmma", "convolution"),
               ("cudnn::cnn", "convolution"), ("gemm", "matmul"),
               ("multi_tensor", "optimizer/EMA (foreach)"), ("sort", "sort/topk"),
               ("reduce", "reduction"), ("softmax", "reduction"), ("elementwise", "elementwise"),
               ("cat", "concat/copy"), ("copy", "concat/copy"), ("scatter", "gather/index"),
               ("gather", "gather/index"), ("index", "gather/index"))


def by_part(fn, calls):
    """Device time per call of fn(i) by kernel and by part (torch.profiler)."""
    return _parts(_trace(fn, calls), calls)


def traced_once(fn):
    """(fn()'s device time by kernel and by part, its result): one call
    under torch.profiler, with no warm-up call, for work that cannot run
    twice (a training run that resumes from its own checkpoint)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return _parts(_device_events(prof), 1), out


def _parts(events, calls):
    per_kernel, per_part, n_ops = {}, {}, 0
    for evt in events:
        ms = evt.self_device_time_total / 1e3 / calls
        n_ops += evt.count
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + ms
        part = next((p for s, p in _CATEGORIES if s in evt.key.lower()), "other")
        per_part[part] = per_part.get(part, 0.0) + ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return dict(device_ms=sum(per_kernel.values()), device_ops=n_ops / calls,
                by_part_ms=dict(sorted(per_part.items(), key=lambda kv: -kv[1])),
                top_kernels_ms=[[k[:90], v] for k, v in top])


def phase_profile(cfg, pred, rng, median_ms, requests=2):
    """Device time of one request by kernel and by part of the path."""
    frames = [rng.integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8) for _ in range(requests)]
    p = by_part(lambda i: pred(frames[i]), requests)
    emit({"phase": _phase("profile", cfg, pred.model.dtype), "requests": requests,
          "device_ms_per_request": p["device_ms"],
          "device_ops_per_request": p["device_ops"], "unprofiled_median_ms": median_ms,
          "device_busy_share": p["device_ms"] / median_ms, "by_part_ms": p["by_part_ms"],
          "top_kernels_ms": p["top_kernels_ms"]})


def train_batches(rng, n, b=TRAIN_B, imgsz=IMGSZ, m=TRAIN_M, nc=NC):
    """Seeded synthetic batches of the loss's batch contract: uint8 images,
    1-8 real boxes per image (normalized xywh, classes 0..nc-1) padded to m."""
    out = []
    for _ in range(n):
        real = rng.integers(1, 9, b)
        xy = rng.uniform(0.15, 0.85, (b, m, 2))
        wh = rng.uniform(0.04, 0.3, (b, m, 2))
        out.append(dict(img=rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8),
                        gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                        gt_cls=rng.integers(0, nc, (b, m)).astype(np.int32),
                        gt_mask=(np.arange(m)[None] < real[:, None]).astype(np.float32)))
    return out


def phase_train(cfg, card, dtype=torch.float32):
    """Training steps of `cfg` computing in `dtype` on the card through Trainer.step."""
    from yolo_dbl_tpu_torch import DetectionModel, kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer

    name, nc = cfg
    model = DetectionModel(name, nc=nc, device="cuda", generator=torch.Generator().manual_seed(0),
                           dtype=dtype)
    trainer = Trainer(model, {"batch": TRAIN_B}).setup(steps_per_epoch=100)
    batches = train_batches(np.random.default_rng(1), TRAIN_WARMUP + TRAIN_STEPS + 1, nc=nc)
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
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP[cfg, dtype].items()}
    require(launches == want, f"launches in {TRAIN_STEPS} steps: {launches}, expected {want}")
    require(all(t.dtype == torch.float32 for t in params + trainer.ema),
            "parameters and EMA must stay float32")
    med = statistics.median(step_ms)
    emit({"phase": _phase("train", cfg, dtype), "model": name[:-5], "nc": nc,
          "dtype": str(dtype).split(".")[-1], "imgsz": IMGSZ,
          "batch": TRAIN_B, "optimizer": trainer.optimizer.name, "steps": TRAIN_STEPS,
          "step_ms": step_ms, "median_ms": med, "img_per_s": TRAIN_B / (med / 1e3),
          "losses": losses, "max_memory_allocated_bytes": peak, "launches": launches,
          "params_changed": moved, "ema_changed": ema_moved, "n_params": len(params),
          "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})
    last = batches[-1]
    p = by_part(lambda i: (trainer.step(last), torch.cuda.synchronize()), 1)
    emit({"phase": _phase("train_profile", cfg, dtype), "steps": 1,
          "device_ms_per_step": p["device_ms"],
          "device_ops_per_step": p["device_ops"], "unprofiled_median_ms": med,
          "device_busy_share": p["device_ms"] / med, "by_part_ms": p["by_part_ms"],
          "top_kernels_ms": p["top_kernels_ms"]})
    return launches


def phase_parity(cfg, cpu_model, gpu_model, frames):
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    u8 = torch.from_numpy(frames)
    pred_c = cpu_model.predict(letterbox_normalize(u8, (IMGSZ, IMGSZ)))
    pred_g = gpu_model.predict(letterbox_normalize(u8.cuda(), (IMGSZ, IMGSZ))).cpu()
    anchors = sum((IMGSZ // s) ** 2 for s in gpu_model.strides)
    require(pred_g.shape == pred_c.shape == (2, 4 + cfg[1], anchors)
            and torch.isfinite(pred_g).all(),
            f"predictions: card {tuple(pred_g.shape)}, CPU {tuple(pred_c.shape)}")
    box_err = float((pred_g[:, :4] - pred_c[:, :4]).abs().max())
    score_err = float((pred_g[:, 4:] - pred_c[:, 4:]).abs().max())
    emit({"phase": _phase("parity", cfg), "frames": 2, "box_max_abs_px": box_err,
          "score_max_abs": score_err, "max_score": float(pred_c[:, 4:].max())})
    require(box_err < 0.05 and score_err <= 1e-3,
            f"card vs CPU: boxes {box_err} px (< 0.05), scores {score_err} (<= 1e-3)")


def _float64_grads(cpu_model, cfg, batch):
    """({loss item: value}, {name: gradient}) of the train-mode loss of a
    float64 copy of the CPU model (the plain sampler and attention take
    float64): train_loss's steps, with the images normalized to float64."""
    import copy

    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize
    from yolo_dbl_tpu_torch.losses.detection import detection_loss

    model = copy.deepcopy(cpu_model).double().train()
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    names, params = zip(*model.named_parameters())
    loss, items = detection_loss(model(device_normalize(batch["img"], torch.float64)), batch,
                                 model.strides, model.nc, box_gain=cfg.box, cls_gain=cfg.cls,
                                 dfl_gain=cfg.dfl)
    values = dict(loss=float(loss.detach()),
                  **{k: float(v.detach()) for k, v in items._asdict().items()})
    return values, dict(zip(names, torch.autograd.grad(loss, params)))


# leaves named in train_parity, whose gradient comes only through a kernel's
# backward: the DySample offset convs (K2), the AAttn qkv convs (K3, and pe)
KERNEL_FED_LEAVES = {DBL: (".offset.conv.", 6), V13: (".attn.qkv.conv.", 8)}


def phase_train_parity(cfg, cpu_model, gpu_model):
    """One train-mode loss and backward of the same weights on the CPU (plain
    versions) and on the card (kernels, TF32 off). Dropout is off on both:
    the two devices draw different random bits."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.cfg import get_cfg
    from yolo_dbl_tpu_torch.engine.trainer import train_loss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_cfg = get_cfg()
    batch = train_batches(np.random.default_rng(2), 1, b=2, imgsz=256, nc=cfg[1])[0]
    results = {}
    for model in (cpu_model, gpu_model):
        for mod in model.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        dev = model.device
        names, params = zip(*model.named_parameters())
        kernels.reset_launches()
        loss, items = train_loss(model, train_cfg,
                                 {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, params)
        stats = {k: v.cpu() for k, v in model.state_dict().items() if k.endswith(("_mean", "_var"))}
        results[dev.type] = (dict(loss=float(loss.detach()),
                                  **{k: float(v.detach()) for k, v in items._asdict().items()}),
                             dict(zip(names, (g.cpu() for g in grads))), stats,
                             dict(kernels.launches))
    (lc, gc, sc, _), (lg, gg, sg, launches) = results["cpu"], results["cuda"]
    require(launches == PER_STEP[cfg, torch.float32], f"launches in one card step: {launches}")
    loss_rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
    detect = f"m{len(gpu_model.spec.layers) - 1}"
    fed, n_fed = KERNEL_FED_LEAVES[cfg]
    checked = [n for n in gc if fed in n or n.startswith("m0.")
               or n.startswith(f"{detect}.cv2_0_2.") or n.startswith(f"{detect}.cv3_0_2.")]
    grad_rel = {n: float((gg[n] - gc[n]).abs().max() / gc[n].abs().max()) for n in checked}
    # Every leaf against the float64 gradient (g64) of the same weights and
    # batch on the CPU: the card within 1e-3 of the leaf's largest |g64|, or,
    # where float32 itself does not reach that (a leaf whose gradient is a sum
    # that cancels), within 4x the CPU float32's own distance from g64; plus
    # 1e-10 of the model's largest |g64| for leaves whose exact gradient is 0.
    _, g64 = _float64_grads(cpu_model, train_cfg, batch)
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
    emit({"phase": _phase("train_parity", cfg), "batch": 2, "imgsz": 256, "losses_cpu": lc,
          "losses_card": lg, "loss_rel": loss_rel, "grad_rel_of_leaf_max": grad_rel,
          "model_max_abs_grad": g_max, "leaves": len(leaves),
          "zero_leaves": sum(e["leaf_max"] == 0 for e in leaves.values()),
          "leaves_past_1e-3_of_leaf_max": sum(e["card_err"] > 1e-3 * e["leaf_max"] + 1e-10 * g_max
                                              for e in leaves.values()),
          "worst_leaves_vs_float64": [dict(name=n, **e) for n, e in worst[:5]],
          "bn_stats_rel": stats_err, "launches": launches})
    require(max(loss_rel.values()) <= 1e-4, f"loss items card vs CPU: {loss_rel}")
    require(len([n for n in checked if fed in n]) == n_fed and max(grad_rel.values()) <= 1e-3,
            f"gradients card vs CPU (of each leaf's max |g|): {grad_rel}")
    require(set(leaves) == set(gg) and not failing,
            f"leaf gradients on the card vs float64 past their tolerance: {failing}")
    require(stats_err <= 1e-4, f"BatchNorm running statistics card vs CPU: {stats_err}")


def _boxes_scores(a, b):
    """(max |d| of the boxes in px, max |d| of the scores) of two (B, 4+nc, A) decodes."""
    a, b = a.float(), b.float()
    return float((a[:, :4] - b[:, :4]).abs().max()), float((a[:, 4:] - b[:, 4:]).abs().max())


def phase_parity_bf16(cfg, cpu32, cpu16, gpu16, frames):
    """The card's bfloat16 decode against the CPU's float32 one at the same
    weights and frames, within check_amp's bars; card bfloat16 against CPU
    bfloat16 beside the CPU's own bfloat16-against-float32 spread."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    u8 = torch.from_numpy(frames)
    pred32 = cpu32.predict(letterbox_normalize(u8, (IMGSZ, IMGSZ)))
    pred_c16 = cpu16.predict(letterbox_normalize(u8, (IMGSZ, IMGSZ), out_dtype=BF16))
    pred_g16 = gpu16.predict(letterbox_normalize(u8.cuda(), (IMGSZ, IMGSZ), out_dtype=BF16)).cpu()
    anchors = sum((IMGSZ // s) ** 2 for s in gpu16.strides)
    require(pred_g16.dtype == pred_c16.dtype == BF16
            and pred_g16.shape == pred32.shape == (2, 4 + cfg[1], anchors)
            and bool(torch.isfinite(pred_g16.float()).all()),
            f"bf16 predictions: card {pred_g16.dtype} {tuple(pred_g16.shape)}")
    card_vs_f32 = _boxes_scores(pred_g16, pred32)
    card_vs_cpu16 = _boxes_scores(pred_g16, pred_c16)
    cpu16_vs_f32 = _boxes_scores(pred_c16, pred32)
    box_bar, score_bar = 0.02 * IMGSZ, 0.05
    emit({"phase": _phase("parity", cfg, BF16), "frames": 2,
          "card_bf16_vs_cpu_f32": {"box_px": card_vs_f32[0], "score": card_vs_f32[1]},
          "card_bf16_vs_cpu_bf16": {"box_px": card_vs_cpu16[0], "score": card_vs_cpu16[1]},
          "cpu_bf16_vs_cpu_f32": {"box_px": cpu16_vs_f32[0], "score": cpu16_vs_f32[1]},
          "bars": {"box_px": box_bar, "score": score_bar},
          "max_score": float(pred32[:, 4:].max())})
    require(card_vs_f32[0] < box_bar and card_vs_f32[1] < score_bar,
            f"card bf16 vs CPU f32: boxes {card_vs_f32[0]} px (< {box_bar}), scores "
            f"{card_vs_f32[1]} (< {score_bar})")


def phase_train_parity_bf16(cfg, cpu32, cpu16, gpu16):
    """One train-mode loss and backward of bfloat16 models on the CPU (plain
    versions) and on the card (kernels): loss items and the leaves a
    kernel's backward feeds against the CPU's float64, within 4x the CPU
    bfloat16's own distance from it."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.cfg import get_cfg
    from yolo_dbl_tpu_torch.engine.trainer import train_loss

    train_cfg = get_cfg()
    batch = train_batches(np.random.default_rng(2), 1, b=2, imgsz=256, nc=cfg[1])[0]
    results = []
    for model in (cpu32, cpu16, gpu16):
        for mod in model.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
    for model in (cpu16, gpu16):
        dev = model.device
        names, params = zip(*model.named_parameters())
        kernels.reset_launches()
        loss, items = train_loss(model, train_cfg,
                                 {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, params)
        results.append((dict(loss=float(loss.detach()),
                             **{k: float(v.detach()) for k, v in items._asdict().items()}),
                        dict(zip(names, (g.cpu() for g in grads))), dict(kernels.launches)))
    (lc, gc, _), (lg, gg, launches) = results
    require(launches == PER_STEP[cfg, BF16], f"launches in one bf16 card step: {launches}")
    l64, g64 = _float64_grads(cpu32, train_cfg, batch)
    loss_d = {k: dict(card=abs(lg[k] - l64[k]), cpu_bf16=abs(lc[k] - l64[k]), float64=l64[k])
              for k in l64}
    fed, n_fed = KERNEL_FED_LEAVES[cfg]
    g_max = max(float(g.abs().max()) for g in g64.values())
    leaves = {n: dict(card=float((gg[n].double() - g64[n]).abs().max()),
                      cpu_bf16=float((gc[n].double() - g64[n]).abs().max()),
                      leaf_max=float(g64[n].abs().max()))
              for n in g64 if fed in n}
    emit({"phase": _phase("train_parity", cfg, BF16), "batch": 2, "imgsz": 256,
          "loss_distance_from_float64": loss_d, "kernel_fed_leaves": leaves,
          "model_max_abs_grad": g_max, "launches": launches})
    require(len(leaves) == n_fed and all(
        e["card"] <= 4 * e["cpu_bf16"] + 1e-10 * g_max for e in leaves.values()),
        f"kernel-fed leaves, card bf16 vs CPU float64 past 4x the CPU bf16's distance: {leaves}")
    require(all(e["card"] <= 4 * e["cpu_bf16"] for e in loss_d.values()),
            f"loss items, card bf16 vs CPU float64: {loss_d}")

# validation: 4 batches of 16 seeded 640x640 images, each with 1-3 filled
# rectangles of a class colour on a noise background
VAL_BATCHES, VAL_B = 4, 16
VAL_COLOURS = ((230, 200, 60), (60, 220, 220), (10, 10, 120))
V8, V8_PARAMS = ("yolov8n.yaml", NC), 3011417
METRIC_KEYS = ("mAP50", "mAP50-95", "precision", "recall")
NOT_A_QUALITY_CLAIM = "random weights: the mAP shows the path runs, it is no quality claim"


@contextlib.contextmanager
def tf32_off():
    """TF32 off for a card-against-CPU check; the previous settings after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def val_batches(rng, n=VAL_BATCHES, b=VAL_B, imgsz=IMGSZ, m=TRAIN_M, nc=NC):
    """Seeded validation batches: uint8 images with 1-3 filled rectangles
    each (drawn by slicing) and their boxes in the loss's form (normalized
    xywh, classes, mask; padded to m)."""
    out = []
    for _ in range(n):
        img = rng.integers(30, 70, (b, imgsz, imgsz, 3), dtype=np.uint8)
        boxes = np.zeros((b, m, 4), np.float32)
        cls = np.zeros((b, m), np.int32)
        mask = np.zeros((b, m), np.float32)
        for i in range(b):
            for j in range(int(rng.integers(1, 4))):
                w, h = (int(v) for v in rng.integers(imgsz // 10, imgsz // 3, 2))
                x1, y1 = int(rng.integers(0, imgsz - w)), int(rng.integers(0, imgsz - h))
                c = int(rng.integers(0, nc))
                img[i, y1:y1 + h, x1:x1 + w] = VAL_COLOURS[c]
                boxes[i, j] = ((x1 + w / 2) / imgsz, (y1 + h / 2) / imgsz, w / imgsz, h / imgsz)
                cls[i, j], mask[i, j] = c, 1.0
        out.append(dict(img=img, gt_boxes=boxes, gt_cls=cls, gt_mask=mask))
    return out


def _first_images(batch, n=2):
    return {k: v[:n] for k, v in batch.items()}


def _metrics(res):
    return {**{k: res[k] for k in METRIC_KEYS}, **res["coco_stats"]}


def run_validator(model, batches):
    """The port's DetectionValidator over `batches` (conf 0.001, iou 0.7,
    max_det 300, the COCO 12 stats) after one warm-up batch: its results,
    the kernels it launched, its wall seconds, the loop's img/s, and the
    device time of one batch's inference by part (`infer`: /255, forward,
    decode, NMS) with the device's busy share over the loop's inference."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.validator import DetectionValidator

    val = DetectionValidator(model, conf=0.001, iou=0.7, max_det=300, use_coco_stats=True)
    val(batches[:1])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = val(batches)
    wall = time.perf_counter() - t0
    speed = res["speed_ms_per_image"]
    launches = dict(kernels.launches)
    img = torch.from_numpy(batches[-1]["img"]).to(model.device)
    p = by_part(lambda i: val.infer(img), 1)
    per_batch_ms = speed["inference"] * len(batches[-1]["img"])
    profile = {"device_ms_per_batch": p["device_ms"], "device_ops_per_batch": p["device_ops"],
               "inference_ms_per_batch": per_batch_ms,
               "device_busy_share": p["device_ms"] / per_batch_ms, "by_part_ms": p["by_part_ms"],
               "top_kernels_ms": p["top_kernels_ms"][:6]}
    return res, launches, wall, 1e3 / (speed["inference"] + speed["postprocess"]), profile


def _gt_near(dets, counts, rng, top=6):
    """Ground truth next to detections: each image's top `top` rows, moved
    by 2 px and given another class now and then. Random weights score 0 on
    the drawn rectangles; against these boxes the metrics compared are not 0."""
    labels = []
    for d, k in zip(dets, counts):
        d = d[:min(int(k), top)].astype(np.float64)
        cls = np.where(rng.random(len(d)) < 0.8, d[:, 5], rng.integers(0, NC, len(d)))
        labels.append({"boxes": (d[:, :4] + rng.normal(0, 2, (len(d), 4))).astype(np.float32),
                       "cls": cls.astype(np.int32)})
    return labels


def check_val_against_cpu(gpu_model, cpu_model, batch):
    """The first 2 images through the validator on the card and on the CPU
    (TF32 off): the same kept count per image, rows within 0.05 px and 1e-3,
    each metric and COCO stat within 1e-3, against the drawn rectangles and
    against boxes next to the CPU's detections (where the metrics are not 0)."""
    from yolo_dbl_tpu_torch.engine.validator import DetectionValidator

    two = _first_images(batch)
    with tf32_off():
        vals = [DetectionValidator(m, conf=0.001, iou=0.7, max_det=300, use_coco_stats=True)
                for m in (gpu_model, cpu_model)]
        (dg, ng), (dc, nc) = ([t.cpu().numpy() for t in v.infer(torch.from_numpy(two["img"])
                                                                  .to(v.model.device))]
                              for v in vals)
        near = [{"img": two["img"], "labels": _gt_near(dc, nc, np.random.default_rng(5))}]
        mg, mc = ({**_metrics(v([two])), **{f"near_{k}": x for k, x in _metrics(v(near)).items()}}
                  for v in vals)
    require(np.array_equal(ng, nc) and nc.sum() > 0,
            f"kept per image, card {ng.tolist()} vs CPU {nc.tolist()} (some must be kept)")
    box_err = max(float(np.abs(dg[i, :k, :4] - dc[i, :k, :4]).max(initial=0))
                  for i, k in enumerate(nc))
    score_err = max(float(np.abs(dg[i, :k, 4] - dc[i, :k, 4]).max(initial=0))
                    for i, k in enumerate(nc))
    cls_equal = all(np.array_equal(dg[i, :k, 5], dc[i, :k, 5]) for i, k in enumerate(nc))
    metric_err = max(abs(mg[k] - mc[k]) for k in mc)
    gate = {"images": 2, "kept": nc.tolist(), "box_max_abs_px": box_err,
            "score_max_abs": score_err, "classes_equal": cls_equal,
            "metric_max_abs": metric_err, "tf32": False,
            "metrics_gt_near_detections_cpu": {k[5:]: v for k, v in mc.items()
                                               if k.startswith("near_")}}
    require(box_err < 0.05 and score_err <= 1e-3 and cls_equal and metric_err <= 1e-3
            and mc["near_mAP50"] > 0, f"validator card vs CPU on 2 images: {gate}")
    return gate


def phase_val(card, dtype=torch.float32, cpu32=None, f32_metrics=None):
    """YOLO-DBL-s (nc=3, 640) through DetectionValidator on the card: the
    main phase's seeded weights with the Detect class biases of the model's
    own init. Float32: gated against the CPU on 2 images; bfloat16: its
    decode on 2 images against the CPU's float32 within check_amp's bars.
    Returns the CPU float32 model, the metrics and the launches."""
    batches = val_batches(np.random.default_rng(4))
    cpu, gpu = build_models(DBL, dtype, zero_class_bias=False)
    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    res, launches, wall, img_s, profile = run_validator(gpu, batches)
    want = _launches({"sample_bilinear": 3 * VAL_BATCHES}, dtype)
    require(launches == want, f"launches in {VAL_BATCHES} val batches: {launches}, expected {want}")
    require(res["images"] == VAL_BATCHES * VAL_B and all(np.isfinite(v) and v >= -1
                                                         for v in _metrics(res).values()),
            f"validator results {res}")
    if dtype == torch.float32:
        cpu32, gate = cpu, check_val_against_cpu(gpu, cpu, batches[0])
    else:
        from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize

        img = torch.from_numpy(batches[0]["img"][:2])
        with tf32_off():
            pred32 = cpu32.predict(device_normalize(img))
            pred16 = gpu.predict(device_normalize(img.cuda(), BF16)).cpu()
        box, score = _boxes_scores(pred16, pred32)
        gate = {"images": 2, "card_bf16_vs_cpu_f32": {"box_px": box, "score": score},
                "bars": {"box_px": 0.02 * IMGSZ, "score": 0.05}}
        require(box < 0.02 * IMGSZ and score < 0.05, f"val bf16 decode vs CPU f32: {gate}")
    metrics = _metrics(res)
    emit({"phase": "val" + ("_bf16" if dtype == BF16 else ""), "model": DBL[0][:-5], "nc": NC,
          "dtype": str(dtype).split(".")[-1], "imgsz": IMGSZ, "batches": VAL_BATCHES,
          "batch": VAL_B, "images": res["images"], "conf": 0.001, "iou": 0.7, "max_det": 300,
          **{k: res[k] for k in METRIC_KEYS}, "coco_stats": res["coco_stats"],
          **({"float32": f32_metrics} if f32_metrics else {}),
          "speed_ms_per_image": res["speed_ms_per_image"], "img_per_s": img_s,
          "validator_seconds": wall, "launches": launches, "profile": profile, "gate": gate,
          "tf32_conv": torch.backends.cudnn.allow_tf32, "note": NOT_A_QUALITY_CLAIM,
          "card": card})
    return cpu32, metrics, launches


def phase_v8(card):
    """yolov8n (nc=3, 640, float32): card decode against the CPU's on 2
    images, training steps through Trainer.step, then the validator over
    the val batches. No hand kernel runs on this model."""
    from yolo_dbl_tpu_torch import DetectionModel, kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer
    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize

    name, nc = V8
    cpu = DetectionModel(name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = DetectionModel(name, nc=nc, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    n_params = sum(p.numel() for p in gpu.parameters())
    require(n_params == V8_PARAMS, f"yolov8n parameters {n_params}, expected {V8_PARAMS}")
    batches = val_batches(np.random.default_rng(4))
    img = torch.from_numpy(batches[0]["img"][:2])
    kernels.reset_launches()
    with tf32_off():
        pred_c = cpu.predict(device_normalize(img))
        pred_g = gpu.predict(device_normalize(img.cuda())).cpu()
    require(pred_g.shape == pred_c.shape and bool(torch.isfinite(pred_g).all()),
            f"yolov8n predictions {tuple(pred_g.shape)}")
    box_err, score_err = _boxes_scores(pred_g, pred_c)
    require(box_err < 0.05 and score_err <= 1e-3,
            f"yolov8n card vs CPU: boxes {box_err} px (< 0.05), scores {score_err} (<= 1e-3)")

    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    trainer = Trainer(gpu, {"batch": TRAIN_B}).setup(steps_per_epoch=100)
    train = train_batches(np.random.default_rng(1), TRAIN_WARMUP + TRAIN_STEPS, nc=nc)
    losses, step_ms = [], []
    for i, batch in enumerate(train):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(v) for m in losses for v in m.values()), f"non-finite losses {losses}")
    step_profile = by_part(lambda i: (trainer.step(train[-1]), torch.cuda.synchronize()), 1)
    res, val_launches, wall, img_s, val_profile = run_validator(gpu, batches)
    launches = dict(kernels.launches)
    require(launches == NO_LAUNCH and val_launches == NO_LAUNCH,
            f"a hand kernel ran on yolov8n: {launches}, {val_launches}")
    require(res["images"] == VAL_BATCHES * VAL_B, f"validator results {res}")
    med = statistics.median(step_ms)
    emit({"phase": "v8", "model": name[:-5], "nc": nc, "dtype": "float32", "imgsz": IMGSZ,
          "n_params": n_params, "parity": {"frames": 2, "box_max_abs_px": box_err,
                                           "score_max_abs": score_err, "tf32": False},
          "train": {"batch": TRAIN_B, "optimizer": trainer.optimizer.name,
                    "steps": TRAIN_STEPS, "step_ms": step_ms, "median_ms": med,
                    "img_per_s": TRAIN_B / (med / 1e3), "losses": losses,
                    "max_memory_allocated_bytes": peak,
                    "profile": {"device_ms_per_step": step_profile["device_ms"],
                                "device_ops_per_step": step_profile["device_ops"],
                                "device_busy_share": step_profile["device_ms"] / med,
                                "by_part_ms": step_profile["by_part_ms"],
                                "top_kernels_ms": step_profile["top_kernels_ms"][:6]}},
          "val": {"images": res["images"], **{k: res[k] for k in METRIC_KEYS},
                  "coco_stats": res["coco_stats"], "speed_ms_per_image": res["speed_ms_per_image"],
                  "img_per_s": img_s, "validator_seconds": wall, "profile": val_profile,
                  "note": NOT_A_QUALITY_CLAIM},
          "launches": launches, "hand_kernels": "none: yolov8n runs no hand kernel",
          "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})


# the facade phase: YOLO-DBL-s through YOLO at full width and depth on a
# shapes set at 640 (32 train, 16 val images), batch 16; then the best
# checkpoint validates and predicts 12 JPEG frames of two sizes (two buckets)
FACADE_TRAIN, FACADE_VAL, FACADE_B = 32, 16, 16
FACADE_SIZES, FACADE_FRAMES, FACADE_REQUESTS = ((512, 768), (480, 640)), 12, 3
# the convergence run of record (tests/test_convergence.py's arguments)
CONVERGE = dict(epochs=60, batch=8, imgsz=160, lr0=0.01, patience=61, mosaic=1.0, close_mosaic=15,
                warmup_epochs=3.0, workers=0, plots=False, verbose=False)


def _counts(results):
    return [len(r) for r in results]


def _facade_gate(best, frames):
    """The best checkpoint on the card and on the CPU (TF32 off) over 2
    frames of the two sizes at conf 0.001: equal kept counts, boxes within
    0.05 px, scores within 1e-3, equal classes."""
    from yolo_dbl_tpu_torch.engine.model import YOLO

    with tf32_off():
        got = YOLO(best).predict(frames, conf=0.001)
        want = YOLO(best, device="cpu").predict(frames, conf=0.001)
    box = max(float(np.abs(g.boxes.xyxy - w.boxes.xyxy).max(initial=0)) for g, w in zip(got, want))
    score = max(float(np.abs(g.boxes.conf - w.boxes.conf).max(initial=0)) for g, w in zip(got, want))
    cls_equal = all(np.array_equal(g.boxes.cls, w.boxes.cls) for g, w in zip(got, want))
    gate = {"frames": 2, "conf": 0.001, "kept_card": _counts(got), "kept_cpu": _counts(want),
            "box_max_abs_px": box, "score_max_abs": score, "classes_equal": cls_equal, "tf32": False}
    require(_counts(got) == _counts(want) and sum(_counts(want)) > 0 and box < 0.05
            and score <= 1e-3 and cls_equal, f"facade card vs CPU: {gate}")
    return gate


def phase_facade(card):
    """YOLO-DBL-s (nc=3, 640, float32, full width and depth) through the
    facade on the card: train 1 epoch, resume to 2, then the best checkpoint
    validates and predicts (plain, classes=[1], agnostic_nms), and the CLI
    predicts in a process of its own. Returns the launches by path."""
    import tempfile

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.model import YOLO
    from yolo_dbl_tpu_torch.native import loader as native

    from tests.fixtures import make_shapes_dataset
    from tests.torch_fixtures import write_jpeg_frames

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    launches, wall = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = make_shapes_dataset(tmp / "shapes", n_train=FACADE_TRAIN, n_val=FACADE_VAL,
                                   imgsz=IMGSZ)
        frames_dir = tmp / "frames"
        paths = write_jpeg_frames(frames_dir, FACADE_SIZES, FACADE_FRAMES, seed=6)
        args = dict(batch=FACADE_B, imgsz=IMGSZ, project=str(tmp / "runs"), name="facade",
                    workers=0, plots=False, verbose=False)
        legs = []
        for epochs, extra in ((1, {}), (2, {"resume": True})):
            y = YOLO(DBL[0], nc=NC)
            kernels.reset_launches()
            t0 = time.perf_counter()
            if extra:  # the resumed epoch runs under the profiler: its device time by part
                epoch_profile, out = traced_once(lambda: y.train(data, epochs=epochs, **args,
                                                                 **extra))
            else:
                out = y.train(data, epochs=epochs, **args)
            torch.cuda.synchronize()
            wall[f"train_epochs_{epochs}"] = time.perf_counter() - t0
            legs.append((out, y.trainer.steps, dict(kernels.launches)))
        (out1, steps1, l1), (out2, steps2, l2) = legs
        epoch_profile["device_busy_share"] = epoch_profile["device_ms"] / (wall["train_epochs_2"] * 1e3)
        per_epoch = FACADE_TRAIN // FACADE_B  # steps; the val set is one batch
        want = _launches({"sample_bilinear": 3 * (per_epoch + 1),
                          "sample_bilinear_backward": 3 * per_epoch}, torch.float32)
        require([h["epoch"] for h in out1["history"]] == [0]
                and [h["epoch"] for h in out2["history"]] == [1]
                and (steps1, steps2) == (per_epoch, 2 * per_epoch),
                f"resume: epochs {out1['history']}, {out2['history']}, steps {steps1}, {steps2}")
        require(l1 == want and l2 == want, f"train launches {l1}, {l2}, expected {want} an epoch")
        require(all(np.isfinite(v) for h in out1["history"] + out2["history"] for v in h.values()),
                "non-finite train history")
        launches["facade_train"] = {k: l1[k] + l2[k] for k in l1}
        run = Path(out2["run_dir"])
        best = run / "best.ckpt"
        ckpt_bytes = {f.name: f.stat().st_size for f in sorted(run.glob("*.ckpt"))}

        yb = YOLO(best)
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = yb.val(data, imgsz=IMGSZ, batch=FACADE_B)
        torch.cuda.synchronize()
        wall["val"] = time.perf_counter() - t0
        launches["facade_val"] = dict(kernels.launches)
        require(launches["facade_val"] == _launches({"sample_bilinear": 3}, torch.float32)
                and metrics["images"] == FACADE_VAL, f"val: {metrics}, {launches['facade_val']}")
        # the val loader's lane: native wherever the native loader built and is not turned off
        lane = ("native" if native.is_available() and os.environ.get("YOLO_DBL_NATIVE_LOADER") != "0"
                else "python")

        per_request = _launches({"letterbox_normalize": len(FACADE_SIZES),
                                 "sample_bilinear": 3 * len(FACADE_SIZES)}, torch.float32)
        yb.predict(frames_dir)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        request_ms, counts = [], []
        for _ in range(FACADE_REQUESTS):
            t0 = time.perf_counter()
            res = yb.predict(frames_dir)
            request_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(_counts(res))
        launches["facade_predict"] = dict(kernels.launches)
        require(launches["facade_predict"] == {k: v * FACADE_REQUESTS for k, v in per_request.items()}
                and len(res) == FACADE_FRAMES
                and [r.orig_shape for r in res] == [FACADE_SIZES[i % 2] for i in range(FACADE_FRAMES)],
                f"predict: {launches['facade_predict']}, {[r.orig_shape for r in res]}")
        request_profile = by_part(lambda i: yb.predict(frames_dir), 1)
        request_profile["device_busy_share"] = (request_profile["device_ms"]
                                                / statistics.median(request_ms))
        frames = [r.orig_img for r in res]
        t0 = time.perf_counter()
        decoded = yb.predict(frames)
        list_ms = (time.perf_counter() - t0) * 1e3
        require(_counts(decoded) == counts[-1], "predict on decoded frames vs on the directory")

        plain, one_class, agnostic = (yb.predict(frames_dir, conf=0.001, **kw) for kw in
                                      ({}, {"classes": [1]}, {"agnostic_nms": True}))
        require(sum(_counts(one_class)) > 0 and all((r.boxes.cls == 1).all() for r in one_class),
                "classes=[1] must keep class 1 only")
        require(sum(_counts(agnostic)) <= sum(_counts(plain)), "agnostic NMS kept more boxes")
        gate = _facade_gate(best, frames[:2])

        # the CLI in a process of its own, against this process at its settings
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "yolo_dbl_tpu_torch", "detect", "predict",
                              f"model={best}", f"source={frames_dir}", "conf=0.001"],
                             capture_output=True, text=True, cwd=Path(__file__).resolve().parent)
        wall["cli_predict"] = time.perf_counter() - t0
        cli_counts = [int(ln.split()[-2]) for ln in cli.stdout.splitlines()
                      if ln.endswith(" detections")]
        require(cli.returncode == 0 and cli_counts == _counts(plain),
                f"CLI predict: rc {cli.returncode}, counts {cli_counts} vs {_counts(plain)}; "
                f"{cli.stderr[-2000:]}")
    emit({"phase": "facade", "model": DBL[0][:-5], "nc": NC, "dtype": "float32", "imgsz": IMGSZ,
          "train": {"images": FACADE_TRAIN, "batch": FACADE_B, "steps": [steps1, steps2],
                    "history": out1["history"] + out2["history"], "resumed_at_epoch": 1},
          "val": {"images": metrics["images"], **{k: metrics[k] for k in METRIC_KEYS},
                  "speed_ms_per_image": metrics["speed_ms_per_image"], "loader_lane": lane,
                  "native_build_error": (native.build_error() or "")[-500:]},
          "predict": {"frames": FACADE_FRAMES, "sizes": FACADE_SIZES, "requests": FACADE_REQUESTS,
                      "request_ms": request_ms, "median_request_ms": statistics.median(request_ms),
                      "decoded_frames_request_ms": list_ms, "boxes_per_image": counts[-1],
                      "conf_0.001_boxes": sum(_counts(plain)),
                      "classes_1_boxes": sum(_counts(one_class)),
                      "agnostic_boxes": sum(_counts(agnostic))},
          "cli": {"rc": cli.returncode, "counts": cli_counts},
          "profile": {"request": request_profile,
                      "resumed_epoch": {"steps": per_epoch, "val_batches": 1, **epoch_profile}},
          "checkpoint_bytes": ckpt_bytes, "launches": launches, "gate": gate,
          "wall_s": {**wall, "phase": time.perf_counter() - t_start},
          "tf32_conv": torch.backends.cudnn.allow_tf32, "note": NOT_A_QUALITY_CLAIM, "card": card})
    return launches


def phase_converge(card):
    """yolov8n (nc=3) from random init on the shapes set (32 train, 16 val
    images at 160 px) through the facade for 60 epochs: the convergence run
    of record, gated at best val mAP50 >= 0.8 and best fitness > 0.2."""
    import tempfile

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.model import YOLO

    from tests.fixtures import make_shapes_dataset

    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        data = make_shapes_dataset(Path(tmp) / "shapes", n_train=32, n_val=16,
                                   imgsz=CONVERGE["imgsz"], seed=0, max_objects=3)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = YOLO(V8[0], nc=NC).train(data, project=str(Path(tmp) / "runs"), name="conv",
                                       **CONVERGE)
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    hist = out["history"]
    map50 = [h["val_mAP50"] for h in hist]
    best = int(np.argmax(map50))
    first = next((h["epoch"] for h in hist if h["val_mAP50"] >= 0.8), None)
    emit({"phase": "converge", "model": V8[0][:-5], "nc": NC, "args": CONVERGE,
          "epochs_run": len(hist), "first_epoch_at_0.8": first, "best_mAP50": map50[best],
          "best_epoch": hist[best]["epoch"], "best_fitness": out["best_fitness"],
          "seconds_per_epoch": statistics.median(h["seconds"] for h in hist), "wall_s": wall,
          "mAP50_by_epoch": map50, "mAP50-95_by_epoch": [h["val_mAP50-95"] for h in hist],
          "loss_by_epoch": [h["loss"] for h in hist], "launches": launches,
          "jax_record": {"first_epoch_at_0.8": 19, "best_mAP50": 0.9514, "best_epoch": 44,
                         "source": "runs/convergence_r5/results.csv"},
          "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})
    require(map50[best] >= 0.8 and out["best_fitness"] > 0.2,
            f"no convergence: best val mAP50 {map50[best]} (epoch {hist[best]['epoch']}), "
            f"best fitness {out['best_fitness']}")
    require(launches == NO_LAUNCH, f"a hand kernel ran on yolov8n: {launches}")
    return launches


# the other six configs of the family at scale s and 320: {name: the
# kernels a forward launches and a train step launches}
FAMILY_IMGSZ, FAMILY_TRAIN_B = 320, 4
FAMILY = {
    "yolov13s_edit9.yaml": ({"letterbox_normalize": 1, "sample_bilinear": 3},
                            {"sample_bilinear": 3, "sample_bilinear_backward": 3}),
    "yolov13s_edit10.yaml": ({"letterbox_normalize": 1}, {}),
    "yolov13s_v3edit5_attn.yaml": ({"letterbox_normalize": 1}, {}),
    "yolov13s_v3edit5_attn2.yaml": ({"letterbox_normalize": 1}, {}),
    "yolov13s_v3edit6.yaml": ({"letterbox_normalize": 1, "area_attention": 8},
                              {"area_attention": 8, "area_attention_backward_dq": 8,
                               "area_attention_backward_dkv": 8}),
    "yolov13s_edit_template.yaml": ({"letterbox_normalize": 1, "area_attention": 8},
                                    {"area_attention": 8, "area_attention_backward_dq": 8,
                                     "area_attention_backward_dkv": 8}),
}


def _sla_check(cpu_model, gpu_model, gen):
    """The first SLA module (P3) of a config, card against CPU (TF32 off) on
    its own input shape with random non-zero proj_l and out_proj (both zero
    at init, where the block is inert): the same key blocks picked on both
    devices (a near-tie between the k-th and (k+1)-th block scores could
    part them; the smallest gap, over the scores' scale, is printed), then
    the outputs within 1e-4 of their largest."""
    from yolo_dbl_tpu_torch.nn.attention.sla import SLA, block_mask

    name, cpu = next((n, m) for n, m in cpu_model.named_modules() if isinstance(m, SLA))
    gpu = gpu_model.get_submodule(name)
    c = cpu.out_proj.in_channels
    hw = FAMILY_IMGSZ // 8
    x = torch.randn((2, c, hw, hw), generator=gen)
    with torch.no_grad():
        for p in (cpu.out_proj.weight, cpu.proj_l.weight, cpu.proj_l.bias):
            p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))
        gpu.load_state_dict(cpu.state_dict())
        with tf32_off():
            masks = []
            x_card = x.cuda().contiguous(memory_format=torch.channels_last)
            for mod, xd in ((cpu, x), (gpu, x_card)):
                qkv = mod.qkv_proj(xd).flatten(2).transpose(1, 2)
                q, k, _ = (t.reshape(2, hw * hw, mod.num_heads, mod.head_dim).transpose(1, 2)
                           for t in qkv.split(c, -1))
                mask, score = block_mask(q, k, mod.topk, mod.blkq, mod.blkk)
                masks.append(mask.cpu())
            want, got = cpu(x), gpu(x_card).cpu()
        topk = int(masks[0].sum(-1).max())
        top = score.cpu().topk(topk + 1, -1).values
        gap = float((top[..., topk - 1] - top[..., topk]).min() / top.abs().max())
    err = float((got - want).abs().max() / want.abs().max())
    out = {"module": name, "tokens": hw * hw, "key_blocks": score.shape[-1], "topk": topk,
           "same_key_blocks": torch.equal(*masks), "topk_gap_of_scale": gap,
           "max_rel_err": err, "max_abs_out": float(want.abs().max())}
    require(out["same_key_blocks"] and err <= 1e-4 and float(want.abs().max()) > 0,
            f"SLA card vs CPU with non-zero projections: {out}")
    return out


def phase_family(card):
    """The other six configs of the family at scale s and 320: the card's
    decode against the CPU's on 2 frames (TF32 off; boxes 0.05 px, scores
    1e-3), launches of a forward, and one train step at batch 4 each."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    t_start = time.perf_counter()
    rng, gen = np.random.default_rng(8), torch.Generator().manual_seed(8)
    frames = torch.from_numpy(rng.integers(0, 256, (2, *SRC_HW, 3), dtype=np.uint8))
    size = (FAMILY_IMGSZ, FAMILY_IMGSZ)
    out, launches = {}, {}
    for name, (per_forward, per_step) in FAMILY.items():
        cpu, gpu = build_models((name, NC))
        n_params = sum(p.numel() for p in gpu.parameters())
        row = {"params": n_params}
        kernels.reset_launches()
        with tf32_off():
            pred_c = cpu.predict(letterbox_normalize(frames, size))
            pred_g = gpu.predict(letterbox_normalize(frames.cuda(), size)).cpu()
        fwd = dict(kernels.launches)
        anchors = sum((FAMILY_IMGSZ // st) ** 2 for st in gpu.strides)
        require(pred_g.shape == pred_c.shape == (2, 4 + NC, anchors)
                and bool(torch.isfinite(pred_g).all()), f"{name}: predictions {pred_g.shape}")
        box, score = _boxes_scores(pred_g, pred_c)
        row.update(box_max_abs_px=box, score_max_abs=score, forward_launches=fwd)
        require(box < 0.05 and score <= 1e-3 and fwd == _launches(per_forward, torch.float32),
                f"{name} card vs CPU: {row}")
        if any(m.__class__.__name__ == "SLA" for m in cpu.modules()):
            row["sla"] = _sla_check(cpu, gpu, gen)
        torch.backends.cudnn.allow_tf32 = True
        trainer = Trainer(gpu, {"batch": FAMILY_TRAIN_B}).setup(steps_per_epoch=100)
        batch = train_batches(rng, 1, b=FAMILY_TRAIN_B, imgsz=FAMILY_IMGSZ)[0]
        kernels.reset_launches()
        t0 = time.perf_counter()
        losses = {k: float(v) for k, v in trainer.step(batch).items()}
        torch.cuda.synchronize()
        row.update(step_ms=(time.perf_counter() - t0) * 1e3, losses=losses,
                   step_launches=dict(kernels.launches))
        require(all(np.isfinite(v) for v in losses.values())
                and row["step_launches"] == _launches(per_step, torch.float32),
                f"{name} train step: {row}")
        launches[name] = {k: fwd[k] + row["step_launches"][k] for k in fwd}
        out[name[:-5]] = row
        del cpu, gpu, trainer
    emit({"phase": "family", "imgsz": FAMILY_IMGSZ, "nc": NC, "frames": 2,
          "train_batch": FAMILY_TRAIN_B, "configs": out, "tf32_parity": False,
          "seconds": time.perf_counter() - t_start, "card": card})
    return launches


def phase_facade_dbl2(card):
    """YOLO-DBL2-l (nc=3, 640, float32) through the facade on the card:
    train 1 epoch (2 steps of 16), validate, predict 8 frames from memory;
    gate: the best checkpoint on the card and on the CPU over 2 frames."""
    import tempfile

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.model import YOLO

    from tests.fixtures import make_shapes_dataset

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    frames = list(np.random.default_rng(9).integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8))
    launches, wall = {}, {}
    per_epoch = FACADE_TRAIN // FACADE_B
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = make_shapes_dataset(tmp / "shapes", n_train=FACADE_TRAIN, n_val=FACADE_VAL,
                                   imgsz=IMGSZ)
        y = YOLO(DBL2[0], nc=NC)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = y.train(data, epochs=1, batch=FACADE_B, imgsz=IMGSZ, project=str(tmp / "runs"),
                      name="dbl2", workers=0, plots=False, verbose=False)
        torch.cuda.synchronize()
        wall["train_epoch"] = time.perf_counter() - t0
        launches["facade_dbl2_train"] = dict(kernels.launches)
        want = _launches({"sample_bilinear": 3 * (per_epoch + 1),
                          "sample_bilinear_backward": 3 * per_epoch}, torch.float32)
        require(launches["facade_dbl2_train"] == want and y.trainer.steps == per_epoch
                and all(np.isfinite(v) for h in out["history"] for v in h.values()),
                f"train: {out['history']}, launches {launches['facade_dbl2_train']}")
        best = Path(out["run_dir"]) / "best.ckpt"
        ckpt_bytes = {f.name: f.stat().st_size for f in sorted(best.parent.glob("*.ckpt"))}
        yb = YOLO(best)
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = yb.val(data, imgsz=IMGSZ, batch=FACADE_B)
        torch.cuda.synchronize()
        wall["val"] = time.perf_counter() - t0
        launches["facade_dbl2_val"] = dict(kernels.launches)
        require(launches["facade_dbl2_val"] == _launches({"sample_bilinear": 3}, torch.float32)
                and metrics["images"] == FACADE_VAL, f"val: {metrics}")
        yb.predict(frames)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        request_ms = []
        for _ in range(FACADE_REQUESTS):
            t0 = time.perf_counter()
            res = yb.predict(frames)
            request_ms.append((time.perf_counter() - t0) * 1e3)
        launches["facade_dbl2_predict"] = dict(kernels.launches)
        require(launches["facade_dbl2_predict"] == {
            k: v * FACADE_REQUESTS for k, v in PER_REQUEST[DBL2, torch.float32].items()}
            and len(res) == B, f"predict: {launches['facade_dbl2_predict']}")
        gate = _facade_gate(best, frames[:2])
    emit({"phase": "facade_dbl2", "model": DBL2[0][:-5], "nc": NC, "dtype": "float32",
          "imgsz": IMGSZ, "train": {"images": FACADE_TRAIN, "batch": FACADE_B,
                                    "steps": per_epoch, "history": out["history"]},
          "val": {"images": metrics["images"], **{k: metrics[k] for k in METRIC_KEYS},
                  "speed_ms_per_image": metrics["speed_ms_per_image"]},
          "predict": {"frames": B, "requests": FACADE_REQUESTS, "request_ms": request_ms,
                      "median_request_ms": statistics.median(request_ms),
                      "boxes_per_image": _counts(res)},
          "checkpoint_bytes": ckpt_bytes, "launches": launches, "gate": gate,
          "wall_s": {**wall, "phase": time.perf_counter() - t_start},
          "tf32_conv": torch.backends.cudnn.allow_tf32, "note": NOT_A_QUALITY_CLAIM, "card": card})
    return launches


DP_B, DP_STEPS = 16, 3


def phase_dp(card):
    """Data-parallel training of YOLO-DBL-s (nc=3, 640, global batch 16, 3
    steps) through `Trainer(mesh=...)` against the one-process Trainer on the
    same weights and batches, TF32 off on both: (a) NCCL at world 1 in this
    process; (b) Gloo at world 2, two processes on this one card, 8 rows
    each (NCCL refuses two ranks on one card: "Duplicate GPU detected",
    tried and printed here); (c) (b) in bfloat16. Bars: loss items 1e-4
    relative; the first step's gradient 1e-3 of each leaf's largest (a leaf
    that misses it by float32 order: both runs against a float64 CPU
    gradient, as train_parity); BatchNorm statistics after the steps 1e-4;
    the parameters bit for bit equal on the ranks; bfloat16: loss items and
    the K2-fed leaves within 4x the one-process bfloat16 step's distance from
    the float32 one. K2's forward and backward launch 3 times a step on
    every rank. Per rank: step ms, the gradient all-reduce's ms a step (CUDA
    events) and the device-busy share of one more step."""
    import tempfile

    import torch.distributed as dist

    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.parallel import distributed_init, make_mesh

    from yolo_dbl_tpu_torch.cfg import get_cfg

    from tests.torch_ranks import (all_reduce_rank, card_steps, check_dp_bf16, check_dp_float32,
                                   dp_card_rank, launch)

    t_start = time.perf_counter()
    name, nc = DBL
    cpu = DetectionModel(name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0))
    for mod in cpu.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0  # as card_steps sets it on the card's models
    batches = train_batches(np.random.default_rng(5), DP_STEPS, b=DP_B)
    fed, n_fed = KERNEL_FED_LEAVES[DBL]
    per_step = {dt: {k: v * DP_STEPS for k, v in PER_STEP[DBL, dt].items() if v}
                for dt in (torch.float32, BF16)}
    g64 = {}

    def float64():  # computed once, and only for a leaf that misses the float32 bar
        if not g64:
            g64.update(_float64_grads(cpu, get_cfg(), batches[0])[1])
        return g64

    def on_card(dtype):
        model = DetectionModel(name, nc=nc, device="cuda", dtype=dtype)
        model.load_state_dict(cpu.state_dict())
        return model

    with tempfile.TemporaryDirectory() as tmp, tf32_off():
        state_path = str(Path(tmp) / "state.pt")
        torch.save(cpu.state_dict(), state_path)
        one = card_steps(on_card(torch.float32), batches, profile=True)
        one16 = card_steps(on_card(BF16), batches[:1])
        torch.cuda.empty_cache()
        # (a) NCCL at world 1: the group, cross-rank BatchNorm and the bucket all-reduce
        distributed_init(f"file://{Path(tmp) / 'nccl_store'}", 1, 0, "nccl")
        try:
            nccl = dp_card_rank(make_mesh(), name, nc, ["float32"], state_path, batches,
                                True)["float32"]
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        nccl_two_ranks = None  # NCCL's refusal of two ranks on one card, which (b) works around
        try:
            launch(all_reduce_rank, 2, devices="cuda:0", backend="nccl", timeout=120, workdir=tmp)
        except (RuntimeError, TimeoutError) as err:
            lines = str(err).splitlines()
            nccl_two_ranks = next((ln.strip() for ln in lines if "Duplicate GPU" in ln),
                                  lines[-1] if lines else repr(err))
        require(nccl_two_ranks is not None, "NCCL ran two ranks on one card: (b) could use it")
        # (b), (c): Gloo at world 2 on this card
        ranks = launch(dp_card_rank, 2, name, nc, ["float32", "bfloat16"], state_path, batches,
                       True, devices="cuda:0", backend="gloo", timeout=900, workdir=tmp)
    f32 = {"nccl_world1": check_dp_float32(one, [nccl], float64),
           "gloo_world2": check_dp_float32(one, [r["float32"] for r in ranks], float64)}
    bf16 = check_dp_bf16(one, one16, ranks[0]["bfloat16"], fed, n_fed)
    sums16 = {r["bfloat16"]["checksum"] for r in ranks}
    runs = {"one_process": one, "nccl_world1": nccl,
            **{f"gloo_rank{i}": r["float32"] for i, r in enumerate(ranks)},
            **{f"gloo_bf16_rank{i}": r["bfloat16"] for i, r in enumerate(ranks)}}

    def timing(r):
        return {"step_ms": r["step_ms"], "median_ms": statistics.median(r["step_ms"][1:]),
                "allreduce_ms": r["allreduce_ms"], "device_ms": r["device_ms"],
                "profiled_step_ms": r["profiled_step_ms"],
                "device_busy_share": r["device_busy_share"], "top_host_ms": r["top_host_ms"]}

    launches = {k: r["launches"] for k, r in runs.items() if k != "one_process"}
    emit({"phase": "dp", "model": name[:-5], "nc": nc, "imgsz": IMGSZ, "global_batch": DP_B,
          "steps": DP_STEPS, "world": {"nccl": 1, "gloo": 2}, "tf32": False,
          "nccl_two_ranks_one_card": nccl_two_ranks,
          "float32": {k: v[0] for k, v in f32.items()}, "bfloat16": bf16[0],
          "bf16_param_checksums_equal": len(sums16) == 1, "launches": launches,
          "timing": {k: timing(r) for k, r in runs.items() if "device_ms" in r},
          "wall_s": time.perf_counter() - t_start, "card": card})
    for k, (_, failures) in f32.items():
        require(not failures, f"dp {k} against the one-process step: {failures}")
    require(not bf16[1], f"dp bf16 against the one-process bf16 step: {bf16[1]}")
    require(len(sums16) == 1, f"dp bf16: the ranks' parameters differ: {sums16}")
    for k, got in launches.items():
        want = per_step[BF16 if "bf16" in k else torch.float32]
        require(got == want, f"dp {k}: launches {got}, expected {want} in {DP_STEPS} steps")
    return launches


TP_B, TP_STEPS, TP_REQUESTS = 8, 3, 3


def _parallel_models(tmp):
    """The tp and sp phases' YOLO-DBL-s (nc=3, seeded, dropout off) saved to
    `tmp` for training and, with main's serving settings (`build_models`:
    FullPAD gates 0.5, Detect class biases 0, so that NMS keeps boxes), for
    serving; its global batches, 8 u8 frames, and the one-process card
    decode of their K1 batch in float32 and bfloat16 (TF32 off)."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    name, nc = DBL
    cpu = DetectionModel(name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0))
    for mod in cpu.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    state_path = str(Path(tmp) / "parallel_state.pt")
    torch.save(cpu.state_dict(), state_path)
    serve_path = str(Path(tmp) / "parallel_serve_state.pt")
    serve_state = build_models(DBL)[0].state_dict()
    torch.save(serve_state, serve_path)
    frames = np.random.default_rng(8).integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8)
    refs, kept = {}, {}
    with tf32_off(), torch.no_grad():
        for dtype in (torch.float32, BF16):
            model = DetectionModel(name, nc=nc, device="cuda", dtype=dtype).eval()
            model.load_state_dict(serve_state)
            u8 = torch.from_numpy(frames).cuda()
            refs[dtype] = model.predict(letterbox_normalize(u8, (IMGSZ, IMGSZ),
                                                            out_dtype=dtype)).float().cpu()
            kept[dtype] = [len(o) for o in DetectionPredictor(
                model, conf=0.25, iou=0.45, max_det=300, imgsz=IMGSZ)(frames)]
            del model
    torch.cuda.empty_cache()
    return dict(cpu=cpu, state_path=state_path, serve_path=serve_path, frames=frames, refs=refs,
                kept=kept,
                batches=train_batches(np.random.default_rng(7), TP_STEPS, b=TP_B))


def _serve_checks(tag, res, setup, dtype, requests, launches_per_request):
    """The serving bars of a rank's `_serve` result against the one-process
    float32 decode: float32 boxes < 0.05 px, scores <= 1e-3 and the boxes
    NMS keeps per image; bfloat16 at parity_bf16's bars (boxes 0.02 of
    imgsz, scores 0.05); the launches."""
    ref32 = setup["refs"][torch.float32]
    want_kept = setup["kept"][dtype]
    require(sum(res["kept"]) > 0, f"{tag}: no detections: NMS saw no candidates")
    if dtype == torch.float32:
        require(res["kept"] == want_kept, f"{tag}: kept {res['kept']}, one process {want_kept}")
    if res["decode"] is not None:
        box, score = _boxes_scores(res["decode"], ref32)
        res["box_max_abs_px"], res["score_max_abs"] = box, score
        bars = (0.05, 1e-3) if dtype == torch.float32 else (0.02 * IMGSZ, 0.05)
        require(res["decode"].shape == ref32.shape and bool(torch.isfinite(res["decode"]).all()),
                f"{tag}: decode {tuple(res['decode'].shape)}, one process {tuple(ref32.shape)}")
        require(box < bars[0] and score <= bars[1],
                f"{tag}: boxes {box} px (< {bars[0]}), scores {score} (<= {bars[1]}) "
                "against the one-process float32 decode")
        res["decode"] = None
    want = {k: v * requests for k, v in launches_per_request.items() if v}
    require(res["launches"] == want, f"{tag}: launches {res['launches']}, expected {want}")


def _model_bytes_share(cpu, n_model):
    """The share of the parameter bytes a rank holds under the specs at
    n_model: the replicated leaves whole, the sharded ones 1 / n_model."""
    from yolo_dbl_tpu_torch.parallel import Mesh, model_parallel_shardings

    specs = model_parallel_shardings(cpu, Mesh(0, n_model, torch.device("cpu"), n_model=n_model))
    whole = {n: p.numel() * p.element_size() for n, p in cpu.named_parameters()}
    return sum(b / (n_model if specs[n] else 1) for n, b in whole.items()) / sum(whole.values())


def phase_tp(card, tmp, setup):
    """Tensor parallelism of YOLO-DBL-s (nc=3, 640) over Gloo ranks on this
    one card (NCCL refuses two ranks on one card): (a) a 1x2 mesh (2
    processes) and (b) a 2x2 mesh (4 processes) train 3 steps at global
    batch 8, float32 with TF32 off, against the one-process Trainer on the
    same weights and batches at the dp phase's bars (`check_dp_float32`);
    (a) then serves 3 requests of 8 u8 frames in float32 and bfloat16
    through a model `shard_variables` sharded (K1, the forward, decode,
    NMS): its decode against the one-process float32 decode at the parity
    bars (bfloat16: parity_bf16's). K2 forward and backward launch 3 times
    a step on every rank, K1 once and K2 3 times a request. Printed: each
    rank's bytes of parameters, EMA and moments against the one-process
    bytes, the collectives a step by kind and bytes with and without the
    column -> row pairing, step and request ms and device-busy shares."""
    from tests.torch_ranks import card_steps, check_dp_float32, launch, tp_card_rank

    t_start = time.perf_counter()
    name, nc = DBL
    cpu, batches, frames = setup["cpu"], setup["batches"], setup["frames"]
    g64 = {}

    def float64():
        if not g64:
            from yolo_dbl_tpu_torch.cfg import get_cfg

            g64.update(_float64_grads(cpu, get_cfg(), batches[0])[1])
        return g64

    from yolo_dbl_tpu_torch import DetectionModel

    with tf32_off():
        model = DetectionModel(name, nc=nc, device="cuda")
        model.load_state_dict(cpu.state_dict())
        one = card_steps(model, batches, profile=True)
        del model
        torch.cuda.empty_cache()
        runs = {}
        for mesh_name, world, serve in (("1x2", 2, True), ("2x2", 4, False)):
            runs[mesh_name] = launch(tp_card_rank, world, name, nc, setup["state_path"], batches,
                                     frames, IMGSZ, TP_REQUESTS, serve, setup["serve_path"],
                                     devices="cuda:0", backend="gloo", timeout=900, workdir=tmp,
                                     n_model=2)
    checks = {k: check_dp_float32(one, [r["train"] for r in ranks], float64, n_model=2)
              for k, ranks in runs.items()}
    share = _model_bytes_share(cpu, 2)
    per_step = {k: v * TP_STEPS for k, v in PER_STEP[DBL, torch.float32].items() if v}
    launches, serving, memory, collectives, timing = {}, {}, {}, {}, {}
    for mesh_name, ranks in runs.items():
        for i, r in enumerate(ranks):
            tag = f"tp_{mesh_name}_rank{i}"
            t = r["train"]
            launches[f"{mesh_name}_train_rank{i}"] = t["launches"]
            require(t["launches"] == per_step,
                    f"{tag}: train launches {t['launches']}, expected {per_step} in {TP_STEPS} steps")
            memory[tag] = {"local_bytes": t["local_bytes"], "whole_bytes": t["whole_bytes"],
                           "share": t["local_bytes"] / t["whole_bytes"]}
            require(abs(t["local_bytes"] / t["whole_bytes"] - share) < 1e-6,
                    f"{tag}: holds {t['local_bytes'] / t['whole_bytes']} of the bytes, the specs "
                    f"give {share}")
            timing[tag] = {"step_ms": t["step_ms"], "median_ms": statistics.median(t["step_ms"][1:]),
                           "allreduce_ms": t["allreduce_ms"], "device_ms": t["device_ms"],
                           "profiled_step_ms": t["profiled_step_ms"],
                           "device_busy_share": t["device_busy_share"]}
            if i == 0:
                collectives[mesh_name] = {
                    "paired_per_step": {k: [v[0] / TP_STEPS, v[1] / TP_STEPS]
                                        for k, v in t["collectives"].items()},
                    "unpaired_per_step": r["unpaired"], "pairs": len(t["pairs"]),
                    "sharded_leaves": t["sharded"]}
            for dt in ("float32", "bfloat16"):
                if dt not in r:
                    continue
                dtype = getattr(torch, dt)
                res = r[dt]
                _serve_checks(f"{tag} {dt}", res, setup, dtype, TP_REQUESTS, PER_REQUEST[DBL, dtype])
                if res.get("box_max_abs_px") is not None and dtype == BF16:
                    res["one_process_bf16_vs_f32"] = _boxes_scores(setup["refs"][BF16],
                                                                   setup["refs"][torch.float32])
                launches[f"{mesh_name}_serve_{dt}_rank{i}"] = res["launches"]
                serving[f"{tag}_{dt}"] = {k: v for k, v in res.items() if k not in ("decode", "launches")}
    emit({"phase": "tp", "model": name[:-5], "nc": nc, "imgsz": IMGSZ, "global_batch": TP_B,
          "steps": TP_STEPS, "requests": TP_REQUESTS, "backend": "gloo", "tf32": False,
          "meshes": {k: len(v) for k, v in runs.items()},
          "float32": {k: v[0] for k, v in checks.items()}, "bytes_share_of_specs": share,
          "memory": memory, "collectives": collectives, "serve": serving,
          "timing": {"one_process": {"step_ms": one["step_ms"],
                                     "median_ms": statistics.median(one["step_ms"][1:]),
                                     "device_ms": one["device_ms"],
                                     "device_busy_share": one["device_busy_share"]}, **timing},
          "launches": launches, "wall_s": time.perf_counter() - t_start, "card": card})
    for k, (_, failures) in checks.items():
        require(not failures, f"tp {k} against the one-process step: {failures}")
    return launches


def phase_sp(card, tmp, setup):
    """Spatial parallelism of YOLO-DBL-s (nc=3, 640, float32, TF32 off) over
    Gloo at world 2 on this one card (a 1x2 mesh, 320 image rows a rank):
    3 requests of 8 u8 frames through `spatial(model, mesh)` (K1 on the
    whole frames, the forward on row shards with halos, DySample and the
    hypergraph on gathered maps: K2 3 times a request on every rank); its
    decode against the one-process float32 decode at the parity bars. Prints
    the halo and gather bytes a request, request ms and device-busy share."""
    from tests.torch_ranks import launch, sp_card_rank

    t_start = time.perf_counter()
    name, nc = DBL
    ranks = launch(sp_card_rank, 2, name, nc, setup["serve_path"], setup["frames"], IMGSZ,
                   TP_REQUESTS, devices="cuda:0", backend="gloo", timeout=600, workdir=tmp,
                   n_model=2)
    launches = {}
    for i, res in enumerate(ranks):
        _serve_checks(f"sp rank{i}", res, setup, torch.float32, TP_REQUESTS,
                      PER_REQUEST[DBL, torch.float32])
        launches[f"serve_rank{i}"] = res.pop("launches")
        res.pop("decode")
    emit({"phase": "sp", "model": name[:-5], "nc": nc, "imgsz": IMGSZ, "batch": B,
          "requests": TP_REQUESTS, "backend": "gloo", "world": 2, "mesh": "1x2", "tf32": False,
          "ranks": ranks, "launches": launches, "wall_s": time.perf_counter() - t_start,
          "card": card})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from yolo_dbl_tpu_torch.kernels import attention, build, preprocess, sampling

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    report = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                        if "entry function" in ln or "registers" in ln or "spill" in ln]
                    for k, v in report.items()},
          "dynamic_shared_bytes": {
              "letterbox_kernel": {str(dt).split(".")[-1]: preprocess.shared_bytes(
                  SRC_HW, (IMGSZ, IMGSZ), B, out_dtype=dt) for dt in (torch.float32, torch.bfloat16)},
              **attention.shared_bytes(),
              "sample_bilinear_backward_kernel": {
                  f"C/G={c // GROUPS}": sampling.backward_shared_bytes(c, GROUPS)
                  for c in sorted({c for _, _, c in (*DYSAMPLE_SITES.values(),
                                                     *DBL2_SITES.values())})}},
          "card": card, "sm_clock_max_mhz": sm_clock_max_mhz(),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype, k1_row in zip((torch.float32, BF16), phase_k1(gen)):
        k2_row = phase_k2(gen, dtype)
        k2_backward_row, k2_train_err = phase_k2_backward(gen, dtype)
        k3_row = phase_k3(gen, dtype)
        k3_dkv_row, k3_dq_row, k3_train_err = phase_k3_backward(gen, dtype)
        for row, train_err in ((k2_row, k2_train_err), (k3_row, k3_train_err)):
            row["max_abs_err_by_path"] = {"serve": row["max_abs_err"], "train": train_err}
            row["max_abs_err"] = max(row["max_abs_err"], train_err)
        rows += [k1_row, k2_row, k2_backward_row, k3_row, k3_dkv_row, k3_dq_row]
    rng = np.random.default_rng(0)
    serve, train, models = {}, {}, {}
    for cfg in (DBL, V13, DBL2):
        for dtype in (torch.float32, BF16):
            cpu_model, gpu_model = build_models(cfg, dtype)
            serve[cfg, dtype], frames, predictor, median_ms = phase_main(cfg, gpu_model, rng, card)
            phase_profile(cfg, predictor, rng, median_ms * 1e3)
            train[cfg, dtype] = phase_train(cfg, card, dtype)
            models[cfg, dtype] = (cpu_model, gpu_model, frames)
    for cfg in (DBL, V13, DBL2):
        phase_parity(cfg, *models[cfg, torch.float32])
    for cfg in (DBL, V13, DBL2):
        cpu32, _, frames = models[cfg, torch.float32]
        cpu16, gpu16, _ = models[cfg, BF16]
        phase_parity_bf16(cfg, cpu32, cpu16, gpu16, frames)
    for cfg in (DBL, V13):
        phase_train_parity(cfg, *models[cfg, torch.float32][:2])
    for cfg in (DBL, V13):
        phase_train_parity_bf16(cfg, models[cfg, torch.float32][0], *models[cfg, BF16][:2])
    del models
    cpu32, f32_metrics, val = phase_val(card)
    _, _, val_bf16 = phase_val(card, BF16, cpu32, f32_metrics)
    phase_v8(card)
    facade = phase_facade(card)
    converge = phase_converge(card)
    family = phase_family(card)
    facade.update(phase_facade_dbl2(card))
    dp = phase_dp(card)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        setup = _parallel_models(tmp)
        tp = phase_tp(card, tmp, setup)
        sp = phase_sp(card, tmp, setup)
        del setup
    # launches: per the path's run (5 requests; 10 train steps) on the path each row serves
    f32, bf16 = torch.float32, BF16
    home = {"letterbox_normalize": serve[DBL, f32], "sample_bilinear": serve[DBL, f32],
            "sample_bilinear_backward": train[DBL, f32], "area_attention": serve[V13, f32],
            "area_attention_backward_dkv": train[V13, f32],
            "area_attention_backward_dq": train[V13, f32],
            "letterbox_normalize_bf16": serve[DBL, bf16], "sample_bilinear_bf16": serve[DBL, bf16],
            "sample_bilinear_backward_bf16": train[DBL, bf16],
            "area_attention_bf16": serve[V13, bf16],
            "area_attention_backward_dkv_bf16": train[V13, bf16],
            "area_attention_backward_dq_bf16": train[V13, bf16]}
    for row in rows:
        name = row["name"]
        row["launches"] = home[name][name]
        require(row["launches"] > 0, f"{name} was not launched on its path")
        row["launches_by_path"] = {_phase(path, cfg, dt): runs[cfg, dt][name]
                                   for path, runs in (("serve", serve), ("train", train))
                                   for cfg in (DBL, V13, DBL2) for dt in (f32, bf16)}
        row["launches_by_path"].update(val=val[name], val_bf16=val_bf16[name],
                                       converge=converge[name],
                                       **{path: runs[name] for path, runs in facade.items()},
                                       **{f"family_{cfg[9:-5]}": runs.get(name, 0)
                                          for cfg, runs in family.items()},
                                       **{f"dp_{path}": runs.get(name, 0)
                                          for path, runs in dp.items()},
                                       **{f"tp_{path}": runs.get(name, 0)
                                          for path, runs in tp.items()},
                                       **{f"sp_{path}": runs.get(name, 0)
                                          for path, runs in sp.items()})
    # how often torch.profiler's trace had to be taken again, or gave way
    # to CUDA-event time (each row's `time_sources` says which it holds)
    emit({"phase": "timing", **TRACES})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
