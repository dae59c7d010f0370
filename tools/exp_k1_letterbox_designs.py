#!/usr/bin/env python3
"""The fused letterbox (K1) against its first design and this card's
practical roof for its bytes, on one GPU.

    python3 tools/exp_k1_letterbox_designs.py

Builds with nvcc, into build/exp_k1_letterbox/:
  - `shipped`: yolo_dbl_tpu_torch/csrc/preprocess.cu, and copies of it
    with one choice changed: `stages_2` and `stages_4` (row slots a warp,
    against 3), `cache_all` (cp.async.ca: the staged rows also kept in L1),
    `ieee_div` (the IEEE x / 255 in place of div255), `magic_cvt` (byte ->
    float as the bits of 2^23 + byte less 2^23, PRMT + FADD, in place of
    one conversion instruction), `warps_4`
    (4 warps a block, against 8), `min_blocks_6` (registers capped for 6
    blocks an SM);
  - `px_8`: 8 pixels a lane, run at 256-pixel tiles;
  - three copies timed only, their output being wrong: `no_loads` (no
    cp.async of the frame rows), `no_blend` (zeros in place of the staged
    bytes: no shared reads, and the blend's arithmetic folds away) and
    `stores_only` (both: the kernel's stores alone);
  - `per_pixel`: tools/exp_k1_per_pixel.cu, the first design (a thread a
    pixel, 12 byte loads from the frame, 3 scalar stores);
  - `roof`: a fill of the canvas with the pad value (16-byte stores only),
    a streaming kernel that reads the frames once and writes the canvas
    once, a thread a 16-byte output chunk, neighbouring lanes on
    neighbouring addresses (u8 / 255 where there is a frame byte, the pad
    value past them): the bytes K1 must move, at the card's practical rate
    for them; and a check of the shipped div255 against __fdiv_rn on every
    float32 in [0, 256);
and prints, from cuobjdump -sass, each kernel's instruction count, its
calls (64-bit integer division is a called subroutine) and its 30 most
common opcodes (the whole SASS of `shipped` and `per_pixel` is written
beside the libraries). Then, at the smoke's shapes (batch 8, 512x768 -> 640x640,
float32 and bfloat16 out), it checks every full design against the plain
version and times each with its inputs resident in L2 (one batch of frames)
and rotated past it (11 copies, 104 MB): the device time torch.profiler
records over 30 back-to-back launches, in turns (A B ... B A) over 4
rounds; the median per launch. `shipped` also runs at 1, 2, 4, 8 and 16 rows
a warp and at 64-pixel tiles. The last line is JSON: ms per launch with
rotated inputs, float32 out.
"""

import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from yolo_dbl_tpu_torch.kernels.preprocess import (_plan, _tap_rule, letterbox_geometry,  # noqa: E402
                                                   letterbox_normalize_plain)

OUT = ROOT / "build" / "exp_k1_letterbox"
CUDA = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v"]
B, SRC_HW, IMGSZ, PAD = 8, (512, 768), 640, 114
ITERS, ROUNDS = 30, 4
ROOF = r"""
#include <cuda_bf16.h>
#include <stdint.h>

__global__ void fill16(uint4* out, long long n16, uint4 v) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n16) out[i] = v;
}

// output chunk i (16 bytes: 4 floats or 8 bfloat16) from frame bytes
// [V i, V i + V), the pad value past the frame: neighbouring lanes read and
// write neighbouring addresses
template <typename T>
__global__ void stream16(const uint8_t* in, long long n_in, T* out, long long n_chunks, float pad) {
  constexpr int V = 16 / sizeof(T);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n_chunks) {
    float v[V];
    if ((i + 1) * V <= n_in) {
      uint32_t w[V / 4];
      if constexpr (V == 4) {
        w[0] = reinterpret_cast<const uint32_t*>(in)[i];
      } else {
        const uint2 q = reinterpret_cast<const uint2*>(in)[i];
        w[0] = q.x;
        w[1] = q.y;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = (float)((w[k / 4] >> (8 * (k % 4))) & 0xff) / 255.0f;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = pad;
    }
    if constexpr (V == 4) {
      reinterpret_cast<uint4*>(out)[i] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                                    __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      uint32_t p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        p[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
      reinterpret_cast<uint4*>(out)[i] = make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
}

extern "C" int roof_fill(void* out, long long bytes, unsigned word, void* stream) {
  fill16<<<(unsigned)((bytes / 16 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (uint4*)out, bytes / 16, make_uint4(word, word, word, word));
  return (int)cudaGetLastError();
}

// every float32 in [0, 256) through div255 against __fdiv_rn: the count that differ
__global__ void div_check(unsigned* differ) {
  const unsigned u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= 0x43800000u) return;
  const float v = __uint_as_float(u);
  if (__float_as_uint(div255(v)) != __float_as_uint(__fdiv_rn(v, 255.0f))) atomicAdd(differ, 1u);
}

extern "C" int roof_div_check(unsigned* differ) {
  div_check<<<(0x43800000u + 255) / 256, 256>>>(differ);
  return (int)cudaGetLastError();
}

extern "C" int roof_stream(const void* in, long long in_bytes, void* out, long long out_values,
                           int out_bf16, float pad, void* stream) {
  const long long chunks = out_values / (out_bf16 ? 8 : 4);
  const unsigned blocks = (unsigned)((chunks + 255) / 256);
  if (out_bf16)
    stream16<__nv_bfloat16><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, in_bytes, (__nv_bfloat16*)out, chunks, pad);
  else
    stream16<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, in_bytes, (float*)out, chunks, pad);
  return (int)cudaGetLastError();
}
"""


# the blend's shared reads replaced by zeros, which folds its arithmetic away
NO_BLEND = ("""        pixel_pair(row0, h.sh0 + off[j], second[j], p0);
        pixel_pair(row1, h.sh1 + off[j], second[j], p1);""",
            """        for (int i = 0; i < 6; ++i) p0[i] = p1[i] = 0.f;""")


def div255_source(shipped):
    """The shipped kernel's div255, for the exhaustive check."""
    start = shipped.index("__device__ __forceinline__ float div255(float v) {")
    return shipped[start:shipped.index("\n}\n", start) + 3]


def edited(src, cuts):
    """src with each (old, new) of cuts replaced; old must occur once."""
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"the source changed: {old!r} does not occur once")
        src = src.replace(old, new)
    return src


def sass_counts(lib):
    """{kernel: {instructions, calls, opcodes of note}} from cuobjdump -sass."""
    sass = subprocess.run([str(CUDA / "bin/cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        ops = Counter()
        calls = []
        for ln in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
            if not m:
                continue
            op = m.group(1)
            ops[op.split(".")[0]] += 1
            if op.startswith("CALL"):
                calls.append(ln.split(";")[0].split("*/")[-1].strip())
        kind = "bf16" if "nv_bfloat16" in name else "f32"
        out[f"{name.split('_cu_')[-1][:40]} ({kind})"] = {
            "instructions": sum(ops.values()), "calls": calls, "opcodes": dict(ops.most_common(30))}
    return out


def sources():
    """{design: CUDA source}"""
    shipped = (ROOT / "yolo_dbl_tpu_torch/csrc/preprocess.cu").read_text()
    return {"shipped": shipped,
               "stages_2": edited(shipped, [("STAGES = 3;", "STAGES = 2;")]),
               "stages_4": edited(shipped, [("STAGES = 3;", "STAGES = 4;")]),
               "cache_all": edited(shipped, [("cp.async.cg.shared", "cp.async.ca.shared")]),
               "ieee_div": edited(shipped, [("div255((1.f - wx[j]) * left_col + wx[j] * right_col)",
                                             "((1.f - wx[j]) * left_col + wx[j] * right_col) / 255.0f")]),
               "magic_cvt": edited(shipped, [(
                   "return (float)((w >> (8 * K)) & 0xff);",
                   "return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + K)) - 8388608.0f;")]),
               "warps_4": edited(shipped, [("WARPS = 8;", "WARPS = 4;")]),
               "min_blocks_6": edited(shipped, [("__launch_bounds__(WARPS * 32)",
                                                 "__launch_bounds__(WARPS * 32, 6)")]),
               "px_8": edited(shipped, [("PX = 4;", "PX = 8;")]),
               "no_loads": edited(shipped, [("cp_async16(dst + q, g);", ";")]),
               "stores_only": edited(shipped, [("cp_async16(dst + q, g);", ";"), NO_BLEND]),
               "no_blend": edited(shipped, [NO_BLEND]),
               "per_pixel": (ROOT / "tools/exp_k1_per_pixel.cu").read_text(),
               "roof": "#include <stdint.h>\n" + div255_source(shipped) + ROOF}


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [str(CUDA / "bin/nvcc"), *FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        ptxas = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        if name in ("shipped", "per_pixel"):
            print(json.dumps({"sass": name, "kernels": sass_counts(OUT / f"lib{name}.so")}),
                  flush=True)
            (OUT / f"{name}.sass").write_text(subprocess.run(
                [str(CUDA / "bin/cuobjdump"), "-sass", str(OUT / f"lib{name}.so")],
                capture_output=True, text=True, check=True).stdout)
    return libs


def launchers(libs):
    """{design: fn(frames, out, rows=None, tile=None)} for one geometry."""
    h_in, w_in = SRC_HW
    _, new_h, new_w, top, left = letterbox_geometry(h_in, w_in, IMGSZ, IMGSZ, scaleup=False)
    sy, oy = _tap_rule(new_h, h_in)
    sx, ox = _tap_rule(new_w, w_in)
    geo = [B, h_in, w_in, IMGSZ, IMGSZ, new_h, new_w, top, left, sy, oy, sx, ox, float(PAD)]
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}

    def call(fn, *args):
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    for name, lib in libs.items():
        if name == "roof":
            continue
        fn = lib.letterbox_normalize_u8
        plan_args = [] if name == "per_pixel" else [ctypes.c_int] * 3
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_double] * 4
                       + [ctypes.c_float] + plan_args + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def run(frames, out, rows=None, tile=None, fn=fn, planned=bool(plan_args)):
            bf16 = out.dtype == torch.bfloat16
            plan = []
            if planned:
                t, slot, r = _plan(w_in, new_w, IMGSZ, IMGSZ, B, out.dtype)
                if tile is not None:
                    t, slot = tile, -(-((math.floor((tile - 1) * w_in / new_w) + 4) * 3 + 24)
                                      // 16) * 16
                plan = [t, slot, rows or r]
            call(fn, frames.data_ptr(), out.data_ptr(), int(bf16), *geo, *plan, dev, stream)
        fns[name] = run
    roof = libs["roof"]
    roof.roof_fill.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p]
    roof.roof_stream.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

    words = {}
    for dtype, view, mask, rep in ((torch.float32, torch.int32, 0xFFFFFFFF, 1),
                                   (torch.bfloat16, torch.int16, 0xFFFF, 0x10001)):
        bits = torch.tensor([PAD / 255.0], dtype=torch.float32).to(dtype).view(view).item()
        words[dtype] = (bits & mask) * rep

    def fill(frames, out, **_):
        call(roof.roof_fill, out.data_ptr(), out.numel() * out.element_size(), words[out.dtype],
             stream)

    def stream_roof(frames, out, **_):
        call(roof.roof_stream, frames.data_ptr(), frames.numel(), out.data_ptr(), out.numel(),
             int(out.dtype == torch.bfloat16), PAD / 255.0, stream)
    fns["stores_only_fill"] = fill
    fns["streaming_roof"] = stream_roof
    return fns


def timed(runs, frames, out):
    """{name: median device ms per launch} of each run, in turns: the device
    time torch.profiler records over ITERS back-to-back launches (host time
    between launches does not count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = list(runs)
    times = {name: [] for name in names}
    for name in (names + names[::-1]) * (ROUNDS // 2):
        for i in range(3):
            runs[name](frames[i % len(frames)], out)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(ITERS):
                runs[name](frames[i % len(frames)], out)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in events) == ITERS:  # a turn where the profiler missed launches is dropped
            times[name].append(sum(e.self_device_time_total for e in events) / 1e3 / ITERS)
    if not all(times.values()):
        raise RuntimeError(f"torch.profiler recorded no device time for {times}")
    return {name: statistics.median(t) for name, t in times.items()}


def main():
    if not torch.cuda.is_available():
        print("exp_k1_letterbox_designs: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = build()
    differ = torch.zeros(1, dtype=torch.int32, device="cuda")
    libs["roof"].roof_div_check.argtypes = [ctypes.c_void_p]
    if libs["roof"].roof_div_check(differ.data_ptr()):
        raise RuntimeError("div_check launch failed")
    print(json.dumps({"div255_vs_fdiv_rn": {"floats_checked": 0x43800000,
                                            "differ": int(differ.item())}}), flush=True)
    fns = launchers(libs)
    gen = torch.Generator().manual_seed(0)
    n_in = B * SRC_HW[0] * SRC_HW[1] * 3
    frames = [torch.randint(0, 256, (B, *SRC_HW, 3), dtype=torch.uint8, generator=gen).cuda()
              for _ in range(math.ceil(100e6 / n_in))]
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.empty((B, IMGSZ, IMGSZ, 3), dtype=dtype, device="cuda")
        want = letterbox_normalize_plain(frames[0], (IMGSZ, IMGSZ), PAD, out_dtype=dtype).float()
        tol = 1e-5 if dtype == torch.float32 else 4e-3
        runs = {name: fn for name, fn in fns.items() if name not in ("stores_only_fill",
                                                                      "streaming_roof",
                                                                      "stores_only")
                and not name.startswith("no_")}
        for name, fn in runs.items():
            out.fill_(float("nan"))
            fn(frames[0], out)
            err = float((out.float() - want).abs().max())
            if not err <= tol:
                raise RuntimeError(f"{name} ({dtype}): max |d| {err} > {tol}")
        runs = dict(fns)
        sweep = {f"shipped_rows{r}": (lambda f, o, r=r: fns["shipped"](f, o, rows=r))
                 for r in (1, 2, 4, 8, 16)}
        sweep["shipped_tile64"] = lambda f, o: fns["shipped"](f, o, tile=64)
        sweep.update({f"px_8_tile256_rows{r}": (lambda f, o, r=r: fns["px_8"](f, o, rows=r,
                                                                            tile=256))
                      for r in (1, 2, 4)})
        runs.update(sweep)
        for name in sweep:
            out.fill_(float("nan"))
            runs[name](frames[0], out)
            err = float((out.float() - want).abs().max())
            if not err <= tol:
                raise RuntimeError(f"{name} ({dtype}): max |d| {err} > {tol}")
        n_out = out.numel() * out.element_size()
        key = "f32" if dtype == torch.float32 else "bf16"
        for inputs, fr in (("l2_resident", frames[:1]), ("rotated", frames)):
            ms = timed(runs, fr, out)
            result[f"{key}/{inputs}"] = ms
            print(json.dumps({"out": key, "inputs": inputs, "bytes": n_in + n_out,
                              "bound_ms": (n_in + n_out) / 3.35e12 * 1e3,
                              "stores_only_bound_ms": n_out / 3.35e12 * 1e3, "ms": ms}),
                  flush=True)
    print(card, flush=True)
    print(json.dumps({"ms_per_launch_f32_rotated": result["f32/rotated"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
