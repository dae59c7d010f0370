#!/usr/bin/env python3
"""The DySample sampler's backward kernel (K2) against its first design, on
one GPU, and where the first design spent its time.

    python3 tools/exp_k2_backward_designs.py

Builds with nvcc, into build/exp_k2_backward/:
  - `shipped`: the counting-sort kernel in yolo_dbl_tpu_torch/csrc/sampling.cu
    (128 threads and 16 KB of g a block), and `shipped_counted`, its build
    with the window-miss counter (the same library's other entry point);
  - `sort_256`: the shipped source at 256 threads and 64 KB of g a block;
  - `scatter`: tools/exp_k2_backward_scatter.cu, the first design (every tap
    a global float4 atomic), and three copies of it with a part knocked out,
    whose gradients are wrong and only whose times count:
    `scatter_no_atomics` (no dx atomics), `scatter_no_x` (no loads of x's
    taps), `scatter_no_x_no_atomics`;
and prints the SASS that a float and an int atomicAdd on shared memory
compile to. Then, at the YOLO-DBL-s DySample sites at training batch 16
(rows 13 and 18; row 22 has row 13's shape) with the smoke's DySample and
uniform coordinates, it checks every full design against autograd through
the plain version and times each: CUDA events over 30 back-to-back calls,
each with the zero fill of dx, in turns (A B ... B A) over 4 rounds; the
least per call. The last line is JSON: the time per train step, 2 x row 13
+ row 18, DySample coordinates.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear_backward_plain  # noqa: E402

OUT = ROOT / "build" / "exp_k2_backward"
CUDA = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v"]
SITES = {"row13": (40, 40, 256), "row18": (20, 20, 512)}
B, G, COPIES = 16, 4, 6
PROBE = """
__global__ void shared_float_add(float* out) {
  __shared__ float s[32];
  s[threadIdx.x % 32] = 0.f;
  __syncthreads();
  atomicAdd(&s[threadIdx.x % 4], 1.f);
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x % 32];
}
__global__ void shared_int_add(int* out) {
  __shared__ int s[32];
  s[threadIdx.x % 32] = 0;
  __syncthreads();
  atomicAdd(&s[threadIdx.x % 4], 1);
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x % 32];
}
"""


def edited(src, cuts):
    """src with each (old, new) of cuts replaced; old must occur once."""
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"the source changed: {old!r} does not occur once")
        src = src.replace(old, new)
    return src


def knocked_out(src, parts):
    """The scatter source without the dx atomics and/or the x tap loads."""
    cuts = {"atomics": ("if (use[k]) add_vec<V>(dx + base + off[k] + c, g, w[k]);", ";"),
            "x": ("if (use[k]) {\n          load_vec<V>(x + base", "if (false) {\n          load_vec<V>(x + base")}
    return edited(src, [cuts[part] for part in parts])


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    shipped = (ROOT / "yolo_dbl_tpu_torch/csrc/sampling.cu").read_text()
    scatter = (ROOT / "tools/exp_k2_backward_scatter.cu").read_text()
    sources = {"shipped": shipped,
               "sort_256": edited(shipped, [("BWD_THREADS = 128;", "BWD_THREADS = 256;"),
                                            ("G_FLOATS = 4096;", "G_FLOATS = 16384;")]),
               "scatter": scatter,
               "scatter_no_atomics": knocked_out(scatter, ["atomics"]),
               "scatter_no_x": knocked_out(scatter, ["x"]),
               "scatter_no_x_no_atomics": knocked_out(scatter, ["x", "atomics"])}
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [str(CUDA / "bin/nvcc"), *FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (OUT / "probe.cu").write_text(PROBE)
    subprocess.run([str(CUDA / "bin/nvcc"), *FLAGS[:2], "-cubin", "-o", str(OUT / "probe.cubin"),
                    str(OUT / "probe.cu")], check=True, capture_output=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = [ln.split("Used")[-1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(json.dumps({"build": name, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        fn = lib.sample_bilinear_backward_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        if name == "shipped":
            counted = lib.sample_bilinear_backward_taps_f32
            counted.argtypes = fn.argtypes + [ctypes.c_void_p]
            counted.restype = ctypes.c_int
            taps = torch.zeros(2, dtype=torch.int64, device="cuda")
            fns["shipped_counted"] = lambda *args, f=counted: f(*args, taps.data_ptr())
    sass = subprocess.run([str(CUDA / "bin/cuobjdump"), "-sass", str(OUT / "probe.cubin")],
                          capture_output=True, text=True, check=True).stdout
    for name, body in zip(*[iter(re.split(r"\n\s*Function : (\S+)", sass)[1:])] * 2):
        ops = sorted({ln.split(";")[0].split("*/")[-1].strip().split(" ")[0]
                      for ln in body.splitlines() if "ATOMS" in ln})
        print(json.dumps({"sass": name, "shared_atomics": ops}), flush=True)
    return fns


def coords(gen, h, w, uniform):
    """chip_smoke.py's coordinates of a site: DySample's or uniform."""
    n = 4 * h * w
    if uniform:
        return [(torch.rand((B, n, G), generator=gen) * (s + 2) - 1.5).cuda() for s in (h, w)]
    oy = (torch.arange(2 * h, dtype=torch.float32) + 0.5) / 2 - 0.5
    ox = (torch.arange(2 * w, dtype=torch.float32) + 0.5) / 2 - 0.5
    gy, gx = torch.meshgrid(oy, ox, indexing="ij")
    return [(t.reshape(1, -1, 1) + torch.randn((B, n, G), generator=gen) * 0.75).cuda()
            .contiguous() for t in (gy, gx)]


def backward(fn, x, gy, gx, g):
    b, h, w, c = x.shape
    dx = torch.zeros_like(x)
    dgy, dgx = torch.empty_like(gy), torch.empty_like(gx)
    err = fn(x.data_ptr(), gy.data_ptr(), gx.data_ptr(), g.data_ptr(), dx.data_ptr(),
             dgy.data_ptr(), dgx.data_ptr(), b, h, w, c, gy.shape[1], G, 0,
             torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return dx, dgy, dgx


def main():
    if not torch.cuda.is_available():
        print("exp_k2_backward_designs: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    fns = build()
    gen = torch.Generator().manual_seed(0)
    best = {}
    for site, (h, w, c) in SITES.items():
        xs = [torch.randn((B, h, w, c), generator=gen).cuda() for _ in range(COPIES)]
        gs = [torch.randn((B, 4 * h * w, c), generator=gen).cuda() for _ in range(COPIES)]
        for kind in ("dysample", "uniform"):
            gy, gx = coords(gen, h, w, kind == "uniform")
            want = sample_bilinear_backward_plain(xs[0], gy, gx, gs[0])
            for name, fn in fns.items():
                if "_no_" in name:
                    continue
                got = backward(fn, xs[0], gy, gx, gs[0])
                errs = [float((got[0] - want[0]).abs().max())] + [
                    float((a - r).abs().max() / r.abs().max()) for a, r in zip(got[1:], want[1:])]
                if errs[0] > 1e-4 or max(errs[1:]) > 1e-4:
                    raise RuntimeError(f"{name} at {site}/{kind}: dx, dgy, dgx errors {errs}")
            times = {name: [] for name in fns}
            for name in (list(fns) + list(fns)[::-1]) * 2:
                for i in range(3):
                    backward(fns[name], xs[i % COPIES], gy, gx, gs[i % COPIES])
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for i in range(30):
                    backward(fns[name], xs[i % COPIES], gy, gx, gs[i % COPIES])
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / 30)
            best[f"{site}/{kind}"] = {name: min(t) for name, t in times.items()}
            print(json.dumps({"site": site, "coords": kind, "ms": best[f"{site}/{kind}"]}),
                  flush=True)
    print(card, flush=True)
    print(json.dumps({"ms_per_step": {name: 2 * best["row13/dysample"][name]
                                      + best["row18/dysample"][name] for name in fns}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
