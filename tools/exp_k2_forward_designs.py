#!/usr/bin/env python3
"""The DySample sampler's forward kernel (K2) against its first design, and
knock-outs of both, on one GPU.

    python3 tools/exp_k2_forward_designs.py

Builds with nvcc, into build/exp_k2_forward/, one library a design (one
nvcc each, all started together):
  - `first`: tools/exp_k2_forward_first.cu, the design the shipped kernel
    replaced (one thread a 16-byte output vector, its point and channel
    found by 64-bit division, the coordinates loaded by every lane), and
    copies of it edited:
      `first_index32` (the flat index and its divisions in 32 bits),
      `first_coords_once` (the coordinates loaded by one lane of each point
      and group and shuffled to the others; valid at these sites only),
    and, timed only, their output being wrong:
      `first_store_only` (no coordinates, no taps: each thread stores a
      zero vector; the output-write roof),
      `first_fixed_pixel` (every tap reads the image's first pixel: the
      same work with no gather spread);
  - `shipped`: yolo_dbl_tpu_torch/csrc/sampling.cu as it is (no division;
    a thread blends FWD_VECS vectors of one point and group from one set of
    taps, for FWD_RUN runs of points in turn; FWD_THREADS threads a block,
    ptxas told to fit FWD_MIN_BLOCKS an SM; evict-first stores), and
    copies of it with those constants edited: `run_N` (N runs a block,
    against 2), `uncapped` and `min_blocks_12` (against 8), `threads_64`
    (also with 4 runs) and `threads_256` (against 128, at the same
    registers), `vecs_1` and `vecs_4` (against 2); or its code: `plain_stores` (no evict-first
    hint), `weights4` (the blend as four weighted taps, not three lerps;
    other bits, within the bars); and, timed only: `no_taps` (the tap loads
    replaced by zeros, which folds the blend away too: the coordinates and
    the stores), `fixed_pixel` (every tap reads the group's channels of the
    image's first pixel: all of the work, no gather spread).
Then at the three YOLO-DBL-s DySample sites at serving batch 8 (row 22 has
row 13's shape, so it is timed once and counted twice), in float32 and in
bfloat16, with the smoke's DySample coordinates, it checks every full design
against the plain version (float32 1e-5; bfloat16 one bfloat16 step of the
result + 1e-6 of x's largest), both padding modes, DySample and uniform
coordinates, and times each with x rotated past the 50 MB L2: the device
time torch.profiler records over 30 back-to-back launches, in turns
(A B ... B A) over 4 rounds; the median per launch. The last line is JSON:
ms a request (2 x row 13 + row 18) per design and type.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from yolo_dbl_tpu_torch.kernels.build import NVCC_FLAGS  # noqa: E402
from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear_plain  # noqa: E402

OUT = ROOT / "build" / "exp_k2_forward"
CUDA = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
SITES = {"row13": (40, 40, 256), "row18": (20, 20, 512)}
PER_REQUEST = {"row13": 2, "row18": 1}  # row 22 has row 13's shape
B, G = 8, 4
ITERS, ROUNDS = 30, 4
TIMED_ONLY = ("first_store_only", "first_fixed_pixel", "no_taps", "fixed_pixel")

FIRST_BODY = """  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvec = C / V;
  const int c = (int)(i % cvec) * V;
  const long long bn = i / cvec;  // b * N + n
  const long long b = bn / N;
  const int g = c / (C / G);
  const float fy = to_float(gy[bn * G + g]);
  const float fx = to_float(gx[bn * G + g]);
"""
# the first design's edits
FIRST_EDITS = {
    "first_index32": [(FIRST_BODY, """  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvec = C / V;
  const int c = (i % cvec) * V;
  const int bn = i / cvec;  // b * N + n
  const int b = bn / N;
  const int g = c / (C / G);
  const float fy = to_float(gy[bn * G + g]);
  const float fx = to_float(gx[bn * G + g]);
""")],
    # a group's lanes are cg / V consecutive lanes of one warp here: C / V
    # is a multiple of 32 and the block 256 threads
    "first_coords_once": [(FIRST_BODY, """  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvec = C / V;
  const int c = (int)(i % cvec) * V;
  const long long bn = i / cvec;  // b * N + n
  const long long b = bn / N;
  const int g = c / (C / G);
  const int lane = threadIdx.x & 31, lead = lane & ~(C / G / V - 1);
  float fy = 0.f, fx = 0.f;
  if (lane == lead) {
    fy = to_float(gy[bn * G + g]);
    fx = to_float(gx[bn * G + g]);
  }
  fy = __shfl_sync(0xffffffffu, fy, lead);
  fx = __shfl_sync(0xffffffffu, fx, lead);
""")],
    "first_store_only": [(FIRST_BODY + """  const float y0 = floorf(fy);
  const float x0 = floorf(fx);
  const float wy = fy - y0;
  const float wx = fx - x0;
  const T* img = x + b * H * W * C + c;
  const Vec<V> v00 = tap<T, V>(img, y0, x0, H, W, C, zeros);
  const Vec<V> v01 = tap<T, V>(img, y0, x0 + 1.f, H, W, C, zeros);
  const Vec<V> v10 = tap<T, V>(img, y0 + 1.f, x0, H, W, C, zeros);
  const Vec<V> v11 = tap<T, V>(img, y0 + 1.f, x0 + 1.f, H, W, C, zeros);
  Vec<V> r;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float top = v00.v[k] * (1.f - wx) + v01.v[k] * wx;
    const float bot = v10.v[k] * (1.f - wx) + v11.v[k] * wx;
    r.v[k] = top * (1.f - wy) + bot * wy;
  }
  store_vec<T, V>(out + bn * C + c, r.v);""", """  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float r[V] = {};
  store_vec<T, V>(out + i * V, r);""")],
    "first_fixed_pixel": [("  load_vec<T, V>(img + ((long long)yi * W + xi) * C, r.v);",
                           "  load_vec<T, V>(img + 0 * (yi * W + xi), r.v);")]}
# (threads a block, blocks an SM for ptxas, vectors a thread, points a run)
SHIPPED = (128, 8, 2, 2)
# the shipped design's edits: its constants, or code
SHIPPED_EDITS = {
    "run_1": (128, 8, 2, 1), "run_3": (128, 8, 2, 3), "run_4": (128, 8, 2, 4),
    "run_8": (128, 8, 2, 8), "uncapped": (128, 1, 2, 2), "min_blocks_12": (128, 12, 2, 2),
    "threads_64": (64, 16, 2, 2), "threads_64_run_4": (64, 16, 2, 4),
    "threads_256": (256, 4, 2, 2), "vecs_1": (128, 8, 1, 2), "vecs_4": (128, 8, 4, 2),
    "plain_stores": [
        ("    __stcs(reinterpret_cast<uint4*>(p), make_uint4(o[0], o[1], o[2], o[3]));",
         "    *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);")],
    "weights4": [("""  const float top = v00 * (1.f - wx) + v01 * wx;
  const float bot = v10 * (1.f - wx) + v11 * wx;
  return top * (1.f - wy) + bot * wy;""", """  return v00 * ((1.f - wx) * (1.f - wy)) + v01 * (wx * (1.f - wy)) +
         v10 * ((1.f - wx) * wy) + v11 * (wx * wy);""")],
    "no_taps": [("? load_raw<T, V>(img + off[k] + c) : zero_raw<T, V>();",
                 "? zero_raw<T, V>() : zero_raw<T, V>();")],
    "fixed_pixel": [("        off[k] = (long long)(yi * W + xi) * C + grp * cg;",
                     "        off[k] = grp * cg + 0 * (yi * W + xi);")]}


def _constants(threads, min_blocks, vecs, run):
    return (f"constexpr int FWD_THREADS = {threads}, FWD_MIN_BLOCKS = {min_blocks}, "
            f"FWD_VECS = {vecs}, FWD_RUN = {run};")


def edited(src, cuts):
    """src with each (old, new) of cuts replaced; old must occur once."""
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"the source changed: {old!r} does not occur once")
        src = src.replace(old, new)
    return src


def sources():
    """{design: CUDA source}."""
    first = (ROOT / "tools/exp_k2_forward_first.cu").read_text()
    shipped = (ROOT / "yolo_dbl_tpu_torch/csrc/sampling.cu").read_text()
    out = {"first": first, "shipped": shipped}
    out.update({name: edited(first, cuts) for name, cuts in FIRST_EDITS.items()})
    for name, edit in SHIPPED_EDITS.items():
        cuts = edit if isinstance(edit, list) else [(_constants(*SHIPPED), _constants(*edit))]
        out[name] = edited(shipped, cuts)
    return out


def build():
    """{design: {dtype: launch fn}}: every library built, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [str(CUDA / "bin/nvcc"), *NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        ptxas, kernel = {}, None
        for ln in log.splitlines():
            if "entry function" in ln:
                kernel = ln.split("'")[1] if "sample_bilinear_kernel" in ln else None
            elif kernel and ("registers" in ln or "spill" in ln):
                ptxas.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        fns[name] = {}
        for dtype, entry in ((torch.float32, "sample_bilinear_f32"),
                             (torch.bfloat16, "sample_bilinear_bf16")):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name][dtype] = fn
    return fns


def launch(fn, x, gy, gx, out, zeros=False):
    b, h, w, c = x.shape
    err = fn(x.data_ptr(), gy.data_ptr(), gx.data_ptr(), out.data_ptr(), b, h, w, c,
             gy.shape[1], gy.shape[2], int(zeros), torch.cuda.current_device(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")


def coords(gen, h, w, dtype, uniform):
    """chip_smoke.py's coordinates of a site: DySample's or uniform."""
    n = 4 * h * w
    if uniform:
        return [(torch.rand((B, n, G), generator=gen) * (s + 2) - 1.5).cuda().to(dtype)
                for s in (h, w)]
    oy = (torch.arange(2 * h, dtype=torch.float32) + 0.5) / 2 - 0.5
    ox = (torch.arange(2 * w, dtype=torch.float32) + 0.5) / 2 - 0.5
    gy, gx = torch.meshgrid(oy, ox, indexing="ij")
    return [(t.reshape(1, -1, 1) + torch.randn((B, n, G), generator=gen) * 0.75).cuda()
            .to(dtype).contiguous() for t in (gy, gx)]


def excess(got, want, dtype, scale):
    """The largest excess of |got - want| over the bar (<= 0 meets it):
    float32 1e-5; bfloat16 one bfloat16 step of want + 1e-6 of scale."""
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(d.max()) - 1e-5
    _, e = torch.frexp(want.float())
    return float((d - torch.ldexp(torch.ones_like(d), e - 8) - 1e-6 * scale).max())


def timed(runs, n_sets):
    """{name: median device ms per launch} of each run(i), in turns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = list(runs)
    times = {name: [] for name in names}
    for name in (names + names[::-1]) * (ROUNDS // 2):
        for i in range(3):
            runs[name](i % n_sets)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(ITERS):
                runs[name](i % n_sets)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        # a turn where the profiler missed launches is dropped
        if sum(e.count for e in events) == ITERS:
            times[name].append(sum(e.self_device_time_total for e in events) / 1e3 / ITERS)
    if not all(times.values()):
        raise RuntimeError(f"torch.profiler recorded no device time for {times}")
    return {name: statistics.median(t) for name, t in times.items()}


def main():
    if not torch.cuda.is_available():
        print("exp_k2_forward_designs: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    fns = build()
    gen = torch.Generator().manual_seed(0)
    total = {}
    for dtype in (torch.float32, torch.bfloat16):
        kind = str(dtype).split(".")[-1]
        total[kind] = {}
        for site, (h, w, c) in SITES.items():
            n_x = B * h * w * c
            xs = [torch.randn((B, h, w, c), generator=gen).cuda().to(dtype)
                  for _ in range(max(2, int(np.ceil(100e6 / (n_x * dtype.itemsize)))))]
            gy, gx = coords(gen, h, w, dtype, False)
            uy, ux = coords(gen, h, w, dtype, True)
            out = torch.empty((B, 4 * h * w, c), dtype=dtype, device="cuda")
            scale = float(xs[0].float().abs().max())
            errors, same_bits = {}, {}
            for zeros in (False, True):
                for cname, (cy, cx) in {"dysample": (gy, gx), "uniform": (uy, ux)}.items():
                    case = f"{'zeros' if zeros else 'border'}/{cname}"
                    want = sample_bilinear_plain(xs[0], cy, cx, "zeros" if zeros else "border")
                    launch(fns["first"][dtype], xs[0], cy, cx, out, zeros)
                    first = out.clone()
                    for name, by_type in fns.items():
                        if name in TIMED_ONLY:
                            continue
                        launch(by_type[dtype], xs[0], cy, cx, out, zeros)
                        torch.cuda.synchronize()
                        err = excess(out, want, dtype, scale)
                        errors[name] = max(errors.get(name, -np.inf), err)
                        if err > 0:
                            raise RuntimeError(f"{name} at {site} {kind} {case}: misses the bar "
                                               f"by {err}")
                        same_bits[name] = same_bits.get(name, True) and torch.equal(out, first)
            k = len(xs)
            runs = {name: (lambda i, f=by_type[dtype]: launch(f, xs[i % k], gy, gx, out))
                    for name, by_type in fns.items()}
            ms = timed(runs, k)
            for name, t in ms.items():
                total[kind][name] = total[kind].get(name, 0.0) + PER_REQUEST[site] * t
            print(json.dumps({"site": site, "dtype": kind, "x": [B, h, w, c], "n": 4 * h * w,
                              "groups": G, "bar_excess": errors,
                              "same_bits_as_first": same_bits, "ms": ms}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ms_per_request": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
