#!/usr/bin/env python3
"""The bfloat16 area-attention kernels (K3: forward, dq, dkv) against the
bfloat16 kernels they replaced, and knock-outs of their design, on one GPU.

    python3 tools/exp_k3_bf16_designs.py

Builds with nvcc, into build/exp_k3_bf16/, one library a design (one nvcc
each, all started together), each a copy of the shipped
yolo_dbl_tpu_torch/csrc/attention.cu with its bfloat16 kernels'
constants (warps a block, bfloat16 terms of P or dS, blocks an SM for
ptxas) or code edited:
  - `shipped`: the file as it is, with entry points added for `tf32`: the
    template the float32 kernels share, instantiated for bfloat16
    (converted on load, TF32 `mma.sync` m16n8k8, the passes that add exact
    zeros skipped), which shipped for bfloat16 before (the dq kernel until
    its redesign, the forward and dkv kernels before theirs);
  - `terms_3` (forward), `terms_2` (dkv, dq): the other split (the
    forward's 3-term split is exact; the 2-term one of dkv and dq misses
    its bar, by CPU emulation: tests/test_torch_attention_split.py);
  - `min_blocks_N`: ptxas told to fit N blocks an SM (the register cap),
    against the shipped 4 (forward, dq) and 3 (dkv);
  - `warps_4`, `warps_8`: 4 or 8 warps a block, against 5, at about the
    same registers a thread (min blocks 5 and 2 forward and dq, 4 and 2
    dkv);
  - three copies timed only, their output being wrong: `no_exp` (the
    per-score exponentials replaced by a multiply), `no_products` (the
    products of P or dS with a tile skipped: forward P V, dkv dV and dK,
    dq dS K; P and dS are still formed) and `no_exp_no_products` (both);
and prints, from cuobjdump -sass, each bfloat16 kernel's instruction count
and its most common opcodes. Then, at the smoke's two YOLOv13-s sites
(forward at serving batch 8, dq and dkv at training batch 16, on the
packed bfloat16 qkv views AAttn passes), it checks every full design
against the plain version under the tests' bar (one bfloat16 step + 1e-6
of the scale, floored at 1e-2 of dv's largest for dq, dk and dv) and times
each with its inputs rotated past the 50 MB L2: the device time
torch.profiler records over 30 back-to-back launches, in turns (A B ... B A)
over 4 rounds; the median per launch. The last line is JSON: ms a request
(forward, 8 calls) and a step (dq and dkv, 8 calls each) per design.
"""

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from yolo_dbl_tpu_torch.kernels.attention import (HEAD_DIM, area_attention_backward_plain,  # noqa: E402
                                                  area_attention_forward, area_attention_plain)
from yolo_dbl_tpu_torch.kernels.build import NVCC_FLAGS  # noqa: E402

OUT = ROOT / "build" / "exp_k3_bf16"
CUDA = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
SITES = {"row6": (4, 400, 4), "row8": (1, 400, 8)}  # (areas, N, heads) an image
CALLS_PER_SITE = 4
SERVE_B, TRAIN_B = 8, 16
ITERS, ROUNDS = 30, 4
KERNELS = ("FWD", "DKV", "DQ")  # the constants' prefixes in attention.cu
# library: ((forward design, its warps, terms, min blocks), (dkv design, ...),
# (dq design, ...), knock-outs). The knock-outs keep the shipped constants,
# so that they change only what they knock out.
LIBRARIES = {
    "shipped": (("shipped", 5, 2, 4), ("shipped", 5, 3, 3), ("shipped", 5, 3, 4), ()),
    "terms": (("terms_3", 5, 3, 4), ("terms_2", 5, 2, 3), ("terms_2", 5, 2, 4), ()),
    "min_blocks_fewer": (("min_blocks_3", 5, 2, 3), ("min_blocks_2", 5, 3, 2),
                         ("min_blocks_3", 5, 3, 3), ()),
    "min_blocks_more": (("min_blocks_5", 5, 2, 5), ("min_blocks_4", 5, 3, 4),
                        ("min_blocks_5", 5, 3, 5), ()),
    "warps_4": (("warps_4", 4, 2, 5), ("warps_4", 4, 3, 4), ("warps_4", 4, 3, 5), ()),
    "warps_8": (("warps_8", 8, 2, 2), ("warps_8", 8, 3, 2), ("warps_8", 8, 3, 2), ()),
    "no_exp": (("no_exp", 5, 2, 4), ("no_exp", 5, 3, 3), ("no_exp", 5, 3, 4), ("exp",)),
    "no_products": (("no_products", 5, 2, 4), ("no_products", 5, 3, 3),
                    ("no_products", 5, 3, 4), ("products",)),
    "no_exp_no_products": (("no_exp_no_products", 5, 2, 4), ("no_exp_no_products", 5, 3, 3),
                           ("no_exp_no_products", 5, 3, 4), ("exp", "products"))}
TIMED_ONLY = ("no_exp", "no_products", "no_exp_no_products")
# (warps, terms, min blocks an SM) as attention.cu ships them
SHIPPED = {kernel: design[1:] for kernel, design in zip(KERNELS, LIBRARIES["shipped"])}
# the knock-outs' edits of the kernels' code
KNOCK_OUTS = {
    "exp": [("          s[j][nt][e] = exp2_approx(x);", "          s[j][nt][e] = x * 0.03125f;"),
            ("""          const float x = fmaf(sp[nt][e], c, -lg[e & 1]);
          float p = exp2_approx(x);""", """          const float x = fmaf(sp[nt][e], c, -lg[e & 1]);
          float p = x * 0.03125f;"""),
            ("""          const float x = fmaf(s[nt][e], c, -lse2[e >> 1]);
          float p = exp2_approx(x);""", """          const float x = fmaf(s[nt][e], c, -lse2[e >> 1]);
          float p = x * 0.03125f;""")],
    "products": [
        ("""      uint32_t pa[FWD_TERMS][4], vb[2][4];
      frag_a_terms<FWD_TERMS>(pa, s[j]);
      frag_b_cols_bf16(vb[0], Vt, STEP * j, 0, lane);
      frag_b_cols_bf16(vb[1], Vt, STEP * j, 2, lane);
#pragma unroll
      for (int i = FWD_TERMS - 1; i >= 0; --i) {  // the smallest term first
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          mma_bf16(part[nd], pa[i], vb[nd >> 1][2 * (nd & 1)], vb[nd >> 1][2 * (nd & 1) + 1]);
        }
      }
""", ""),
        ("""      uint32_t pa[DKV_TERMS][4], dsa[DKV_TERMS][4], db[2][4], qb[2][4];
      frag_a_terms<DKV_TERMS>(pa, sp);
      frag_a_terms<DKV_TERMS>(dsa, ds);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        frag_b_cols_bf16(db[u], st.d, j0, 2 * u, lane);
        frag_b_cols_bf16(qb[u], st.q, j0, 2 * u, lane);
      }
#pragma unroll
      for (int i = DKV_TERMS - 1; i >= 0; --i) {  // the smallest term first
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          const int u = nd >> 1, w = 2 * (nd & 1);
          mma_bf16(pv[nd], pa[i], db[u][w], db[u][w + 1]);   // dV += P^T dO
          mma_bf16(pk[nd], dsa[i], qb[u][w], qb[u][w + 1]);  // dK += dS^T Q
        }
      }
""", """#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // keep P and dS alive: all but their products
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[0][e] += sp[nt][e];
          pk[0][e] += ds[nt][e];
        }
      }
"""),
        ("""      uint32_t dsa[DQ_TERMS][4], kb[2][4];
      frag_a_terms<DQ_TERMS>(dsa, s);
      frag_b_cols_bf16(kb[0], Kt, j0, 0, lane);
      frag_b_cols_bf16(kb[1], Kt, j0, 2, lane);
#pragma unroll
      for (int i = DQ_TERMS - 1; i >= 0; --i) {  // the smallest term first
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          mma_bf16(part[nd], dsa[i], kb[nd >> 1][2 * (nd & 1)], kb[nd >> 1][2 * (nd & 1) + 1]);
        }
      }
""", """#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // keep dS alive: all but its product
#pragma unroll
        for (int e = 0; e < 4; ++e) part[0][e] += s[nt][e];
      }
""")]}
TF32_ENTRY_POINTS = """
extern "C" int fwd_tf32(QKV_ARGS, void* o, void* o32, void* lse, TAIL_ARGS) {
  return forward<bf16>(QKV, o, o32, lse, TAIL);
}
extern "C" int dkv_tf32(QKV_ARGS, const void* lse, const void* dout, const void* delta, void* dk,
                       void* dv, TAIL_ARGS) {
  return backward_dkv<bf16>(QKV, lse, dout, delta, dk, dv, TAIL);
}
extern "C" int dq_tf32(QKV_ARGS, const void* o, const void* lse, const void* dout, void* dq,
                      void* delta, TAIL_ARGS) {
  return backward_dq<bf16>(QKV, o, lse, dout, dq, delta, TAIL);
}
"""


def edited(src, cuts):
    """src with each (old, new) of cuts replaced; old must occur once."""
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"the source changed: {old!r} does not occur once")
        src = src.replace(old, new)
    return src


def _constants(kernel, warps, terms, min_blocks):
    return (f"constexpr int {kernel}_WARPS = {warps}, {kernel}_TERMS = {terms}, "
            f"{kernel}_MIN_BLOCKS = {min_blocks};")


def sources():
    """{library: CUDA source}: attention.cu, its bfloat16 designs edited."""
    shipped = (ROOT / "yolo_dbl_tpu_torch/csrc/attention.cu").read_text()
    out = {}
    for lib, (*designs, knocks) in LIBRARIES.items():
        cuts = [(_constants(kernel, *SHIPPED[kernel]), _constants(kernel, *design[1:]))
                for kernel, design in zip(KERNELS, designs)]
        out[lib] = edited(shipped, cuts + [c for k in knocks for c in KNOCK_OUTS[k]])
    out["shipped"] += TF32_ENTRY_POINTS
    return out


def _short(name):
    """attention_fwd_kernel_bf16 (shipped design) or attention_fwd_kernel
    (the float32 template's instance) from a mangled kernel name."""
    return re.search(r"attention_(?:fwd|bwd_dq|bwd_dkv)_kernel(?:_bf16)?", name).group(0)


def _designed(name):
    """Whether a kernel is one of the bfloat16 kernels of this design."""
    return "_kernel_bf16" in name


def sass_counts(lib):
    """{kernel: {instructions, opcodes of note}} of the bfloat16 kernels,
    from cuobjdump -sass."""
    sass = subprocess.run([str(CUDA / "bin/cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        if not _designed(name):
            continue
        ops = Counter()
        for ln in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
            if m:
                ops[m.group(1).split(".")[0]] += 1
        out[_short(name)] = {"instructions": sum(ops.values()),
                             "opcodes": dict(ops.most_common(20))}
    return out


def ptxas_lines(log):
    """{kernel: its ptxas -v lines} of the bfloat16 kernels."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name = _short(m.group(1)) if _designed(m.group(1)) else None
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def build():
    """{library: ctypes.CDLL}: every library built, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [str(CUDA / "bin/nvcc"), *NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        print(json.dumps({"build": name, "ptxas": ptxas_lines(log),
                          "sass": sass_counts(OUT / f"lib{name}.so")}), flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def launchers(libs):
    """{"forward": {design: fn(q, k, v, o, lse)},
    "dkv": {design: fn(q, k, v, lse, dout, delta, dk, dv)},
    "dq": {design: fn(q, k, v, o32, lse, dout, dq, delta)}}."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    qkv_args = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 9
    tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

    def fn(lib, name, n_ptrs):
        f = getattr(libs[lib], name)
        f.argtypes = qkv_args + [ctypes.c_void_p] * n_ptrs + tail
        f.restype = ctypes.c_int
        return f

    def call(f, q, k, v, *ptrs):
        bb, n, h, hd = q.shape
        strides = [s for t in (q, k, v) for s in t.stride()[:-1]]
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                *[p.data_ptr() if p is not None else None for p in ptrs], bb, n, h, hd ** -0.5,
                dev, stream)
        if err:
            raise RuntimeError(f"{f.__name__}: cudaError_t {err}")

    fwd = {"tf32": fn("shipped", "fwd_tf32", 3)}
    dkv = {"tf32": fn("shipped", "dkv_tf32", 5)}
    dq = {"tf32": fn("shipped", "dq_tf32", 5)}
    for lib, (fwd_design, dkv_design, dq_design, _) in LIBRARIES.items():
        fwd[fwd_design[0]] = fn(lib, "area_attention_fwd_bf16", 3)
        dkv[dkv_design[0]] = fn(lib, "area_attention_bwd_dkv_bf16", 5)
        dq[dq_design[0]] = fn(lib, "area_attention_bwd_dq_bf16", 5)
    return {"forward": {name: (lambda q, k, v, o, lse, f=f: call(f, q, k, v, o, None, lse))
                        for name, f in fwd.items()},
            "dkv": {name: (lambda q, k, v, lse, d, delta, dk, dv, b=b:
                           call(b, q, k, v, lse, d, delta, dk, dv)) for name, b in dkv.items()},
            "dq": {name: (lambda q, k, v, o32, lse, d, dq, delta, b=b:
                          call(b, q, k, v, o32, lse, d, dq, delta)) for name, b in dq.items()}}


def inputs(gen, b, site):
    """Copies (rotated past L2) of the packed bfloat16 qkv views at a site,
    with an output gradient, the forward's lse, delta = rowsum(dO O) and
    the forward's float32 O."""
    areas, n, h = SITES[site]
    bb = b * areas
    copies = max(2, int(np.ceil(100e6 / (bb * n * h * 4 * HEAD_DIM * 2))))
    sets = []
    for _ in range(copies):
        q, k, v = torch.randn((bb, n, h, 3 * HEAD_DIM), generator=gen).cuda().bfloat16().split(
            HEAD_DIM, -1)
        d = torch.randn((bb, n, h, HEAD_DIM), generator=gen).cuda().bfloat16()
        _, lse, o32 = area_attention_forward(q, k, v, residual=True)
        delta = (d.float() * o32).sum(-1).transpose(1, 2).contiguous()
        sets.append((q, k, v, d, lse, delta, o32))
    return sets


def excess(got, want, scale):
    """The largest excess of |got - want| over one bfloat16 step of want
    plus 1e-6 of scale (<= 0 meets the tests' bar)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return float(((got.float() - w).abs() - ulp - 1e-6 * scale).max())


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
        print("exp_k3_bf16_designs: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = launchers(build())
    gen = torch.Generator().manual_seed(0)
    total = {"forward": {}, "dkv": {}, "dq": {}}
    for site in SITES:
        for kernel, b in (("forward", SERVE_B), ("dkv", TRAIN_B), ("dq", TRAIN_B)):
            sets = inputs(gen, b, site)
            q, k, v, d, lse, delta, o32 = sets[0]
            shape = q.shape
            o = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
            lse_out, delta_out = torch.empty_like(lse), torch.empty_like(delta)
            dq, dk, dv = (torch.empty(shape, dtype=torch.bfloat16, device="cuda") for _ in range(3))
            if kernel == "forward":
                want = [area_attention_plain(q, k, v)]
                scales = [float(v.float().abs().max())]
            else:
                grads = area_attention_backward_plain(q, k, v, d)
                want = [grads[0]] if kernel == "dq" else list(grads[1:])
                floor = 1e-2 * float(grads[2].float().abs().max())
                scales = [max(float(w.float().abs().max()), floor) for w in want]
            errors = {}
            for name, fn in fns[kernel].items():
                if name in TIMED_ONLY:
                    continue
                if kernel == "forward":
                    fn(q, k, v, o, lse_out)
                    got = [o]
                elif kernel == "dkv":
                    fn(q, k, v, lse, d, delta, dk, dv)
                    got = [dk, dv]
                else:
                    fn(q, k, v, o32, lse, d, dq, delta_out)
                    got = [dq]
                torch.cuda.synchronize()
                errors[name] = max(excess(g, w, s) for g, w, s in zip(got, want, scales))

            def run(fn, kernel=kernel):
                if kernel == "forward":
                    return lambda i: fn(*sets[i][:3], o, lse_out)
                if kernel == "dkv":
                    return lambda i: fn(*sets[i][:3], sets[i][4], sets[i][3], sets[i][5], dk, dv)
                return lambda i: fn(*sets[i][:3], sets[i][6], sets[i][4], sets[i][3], dq,
                                    delta_out)

            ms = timed({name: run(fn) for name, fn in fns[kernel].items()}, len(sets))
            for name, t in ms.items():
                total[kernel][name] = total[kernel].get(name, 0.0) + CALLS_PER_SITE * t
            print(json.dumps({"kernel": kernel, "site": site, "qkv": list(shape),
                              "bar_excess": errors, "ms": ms}), flush=True)
    print(card, flush=True)
    print(json.dumps({"forward_ms_per_request": total["forward"],
                      "dkv_ms_per_step": total["dkv"], "dq_ms_per_step": total["dq"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
