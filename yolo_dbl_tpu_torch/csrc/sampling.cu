// Group-aware bilinear point sampler: the sampling inside every DySample.
//
// Replaces the TPU kernel yolo_dbl_tpu/kernels/sampling.py (`_pallas_sample`,
// body `_kernel`, pallas_call at :102) and computes the gather form of
// yolo_dbl_tpu/ops/resample.py:sample_bilinear_pixel (:278-305):
//
//   out[b, n, c] = bilinear(x[b, :, :, c], gy[b, n, g], gx[b, n, g]),  g = c / (C / G)
//
// x is NHWC (B, H, W, C), gy/gx are pixel coordinates (B, N, G) with
// one coordinate pair per contiguous channel group, out is (B, N, C).
// Padding is "border" (taps clamped, so coincident taps add) or "zeros"
// (out-of-range taps read 0).
//
// Types: float32 (sample_bilinear_f32) or bfloat16 (sample_bilinear_bf16)
// for x, the coordinates and out, all of one type. A bfloat16 run forms the
// taps and weights in float32 from the bfloat16 coordinates, blends in
// float32 (the TPU kernel accumulates in float32, sampling.py:77-80) and
// rounds each output to bfloat16 once; its plain version is the float32 one
// on the upcast inputs, rounded once.
//
// Bound: bytes. Each output element costs 4 loads and ~10 flops, far below
// the card's 67 TFLOP/s fp32 rate; the least traffic is x read once, out
// written once and the coordinates read once (DySample row 13 of YOLO-DBL-s
// at batch 8: 13.1 MB + 52.4 MB + 1.6 MB, about 20 us at 3.35 TB/s).
//
// Design (PERF.md has the times; tools/exp_k2_forward_designs.py builds
// the designs and knock-outs). The TPU kernel turned the gather into dense
// one-hot matmuls because Mosaic rejects gathers; Hopper gathers from L1
// and L2 directly. The first design (tools/exp_k2_forward_first.cu: a
// thread a 16-byte output vector, its point and channel found from its
// flat index by 64-bit division, the coordinates loaded and the taps
// formed by every lane) ran at 2x (float32) and 3.6x (bfloat16) its byte
// bound. Its knock-outs showed what held it: the spread of its tap
// gathers (all taps from one pixel: 28% and 43% faster) and, in bfloat16,
// its index math (32-bit: 21%); not the repeated coordinate loads, and not
// the output's writes (zeros stored alone: under half its time). So:
// - No division: a 3D block (lanes along a group's 16-byte vectors, then
//   points, then groups) over a 2D grid (runs of points, images).
// - A thread forms its point's taps once (offsets, clamps, zeros-mode
//   flags, weights) and blends FWD_VECS vectors of its group from them,
//   their 4 FWD_VECS tap loads in flight together; the blend goes 32 bits
//   at a time, so few values are live (at most 64 registers: 8 blocks of
//   128 threads an SM).
// - A block takes FWD_RUN runs of consecutive points in turn. DySample's
//   points are row-major over its 2H x 2W output, so a run's taps fall on
//   the source pixels the last run brought into L1.
// - 16-byte evict-first stores: the output streams past L2, where x stays.
// A band of source rows staged in shared memory (as the backward stages
// its window) was not built: at DySample's offsets a run's taps spread
// over several source rows, and staging them would read from L2 about as
// many bytes as the gather's L1 misses do. One launch covers all G groups;
// where C / G or the alignment refuses 16 bytes, a lane takes one channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// V consecutive values of p as float32 (the backward's): one 16-byte load
// for 4 floats, one 8-byte load for 4 bfloat16.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_float(__ldg(p + k));
  }
}

// 4 floats to p in bfloat16, each rounded once: one 8-byte store.
__device__ __forceinline__ void store_bf16x4(bf16* __restrict__ p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// 16 bytes (or one value, V = 1) of p as they are: V values of T.
template <typename T, int V>
struct Raw {
  typedef uint4 type;
};
template <typename T>
struct Raw<T, 1> {
  typedef T type;
};

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load_raw(const T* __restrict__ p) {
  if constexpr (V == 1) {
    return __ldg(p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type zero_raw() {
  if constexpr (V == 1) {
    return from_float<T>(0.f);
  } else {
    return make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The bilinear blend of one channel's 4 taps, in the plain version's order.
__device__ __forceinline__ float bilerp(float v00, float v01, float v10, float v11, float wy,
                                        float wx) {
  const float top = v00 * (1.f - wx) + v01 * wx;
  const float bot = v10 * (1.f - wx) + v11 * wx;
  return top * (1.f - wy) + bot * wy;
}

// The blend of 4 raw taps (00, 01, 10, 11) to p, each value rounded once to
// T, 32 bits at a time (one float32 or two bfloat16 channels), so few of
// the V x 4 values are live at once; a 16-byte vector goes by an
// evict-first store (st.global.cs), so the output streams past L2 instead
// of pushing x out of it.
template <typename T, int V>
__device__ __forceinline__ void blend_store(T* __restrict__ p,
                                            const typename Raw<T, V>::type (&tap)[4], float wy,
                                            float wx) {
  if constexpr (V == 1) {
    *p = from_float<T>(bilerp(to_float(tap[0]), to_float(tap[1]), to_float(tap[2]),
                              to_float(tap[3]), wy, wx));
  } else {
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        o[i] = __float_as_uint(bilerp(__uint_as_float(word(tap[0], i)),
                                      __uint_as_float(word(tap[1], i)),
                                      __uint_as_float(word(tap[2], i)),
                                      __uint_as_float(word(tap[3], i)), wy, wx));
      } else {
        float2 f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t w = word(tap[k], i);
          f[k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
        }
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(bilerp(f[0].x, f[1].x, f[2].x, f[3].x, wy, wx),
                                  bilerp(f[0].y, f[1].y, f[2].y, f[3].y, wy, wx));
        o[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// The forward's block: FWD_THREADS threads, ptxas told to fit
// FWD_MIN_BLOCKS of them an SM (the register cap); each thread blends
// FWD_VECS output vectors of one point and group from one set of taps, for
// FWD_RUN points in turn (tools/exp_k2_forward_designs.py builds copies of
// this file with these changed).
constexpr int FWD_THREADS = 128, FWD_MIN_BLOCKS = 8, FWD_VECS = 2, FWD_RUN = 2;

// grid (ceil(N / (FWD_RUN blockDim.y)), B); block (lanes along a group's
// vectors, points, groups): a thread blends vectors threadIdx.x + k
// blockDim.x of its group of its points; cg = C / G channels a group, V a
// vector.
template <typename T, int V>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)
    sample_bilinear_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                           const T* __restrict__ gx, T* __restrict__ out, int H, int W, int C,
                           int N, int G, int cg, bool zeros) {
  const T* img = x + (long long)blockIdx.y * H * W * C;
  for (int run = 0; run < FWD_RUN; ++run) {
    const int n = (blockIdx.x * FWD_RUN + run) * blockDim.y + threadIdx.y;
    if (n >= N) return;
    const long long pt = (long long)blockIdx.y * N + n;  // b N + n
    for (int grp = threadIdx.z; grp < G; grp += blockDim.z) {
      // the point's taps, once for the thread's vectors: clamped pixel
      // offsets, whether each counts (zeros mode drops taps out of range),
      // and the weights
      const float fy = to_float(gy[pt * G + grp]), fx = to_float(gx[pt * G + grp]);
      const float y0 = floorf(fy), x0 = floorf(fx);
      const float wy = fy - y0, wx = fx - x0;
      long long off[4];
      bool use[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float yf = y0 + (float)(k >> 1), xf = x0 + (float)(k & 1);
        use[k] =
            !zeros || (yf >= 0.f && yf <= (float)(H - 1) && xf >= 0.f && xf <= (float)(W - 1));
        const int yi = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
        const int xi = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
        off[k] = (long long)(yi * W + xi) * C + grp * cg;
      }
      T* dst = out + pt * C + grp * cg;
      for (int c0 = threadIdx.x * V; c0 < cg; c0 += FWD_VECS * blockDim.x * V) {
        // every tap of every vector in flight before the first blend; a tap
        // that does not count reads as 0
        typename Raw<T, V>::type raw[FWD_VECS][4];
#pragma unroll
        for (int j = 0; j < FWD_VECS; ++j) {
          const int c = c0 + j * blockDim.x * V;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            raw[j][k] = c < cg && use[k] ? load_raw<T, V>(img + off[k] + c) : zero_raw<T, V>();
          }
        }
#pragma unroll
        for (int j = 0; j < FWD_VECS; ++j) {
          const int c = c0 + j * blockDim.x * V;
          if (c < cg) blend_store<T, V>(dst + c, raw[j], wy, wx);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- backward
//
// Replaces the backward of the TPU kernel: the custom_vjp `_bwd` of
// yolo_dbl_tpu/kernels/sampling.py:142-148, which differentiates the
// one-hot form. Computes the exact gradient of the gather form above, as
// JAX's autodiff does (floor, the clamps and the in-bounds mask carry none):
//
//   dx[b, tap, c]  += g[b, n, c] * w_tap          (4 taps; zeros mode drops
//                                                   out-of-range taps)
//   dgy[b, n, grp]  = sum over the group's C/G channels of g * (bot - top)
//   dgx[b, n, grp]  = sum of g * ((v01 - v00)(1 - wy) + (v11 - v10) wy)
//
// Bound: bytes. Per point it reads x's 4 taps, g and the coordinates and
// adds 4 taps into dx; the least traffic is x and g read once, dx written
// once (it is zero-filled first) and the coordinates and their gradients
// (row 13 at training batch 16: 26 + 105 + 2 x 26 + 7 MB, ~57 us at 3.35 TB/s).
//
// bfloat16 (sample_bilinear_backward_bf16): x, the coordinates and g arrive
// in bfloat16 and dx, dgy and dgx leave in it, with float32 sums: the taps
// and weights are formed in float32 from the bfloat16 coordinates, dgy and
// dgx are reduced in float32 and rounded once, and dx is summed in a float32
// scratch (zero-filled by the wrapper, windows of neighbouring tiles overlap)
// that a second pass rounds once into dx. A bfloat16 atomicAdd would round
// at every add. The scratch's write and read are this design's extra bytes.
//
// Design: a block of 128 threads owns one (image, group) and a tile of P
// consecutive output points, P C/G <= 4096 (P = 64 at C/G = 64, 32 at 128).
// dx is a scatter: at DySample's 2x upsampling each source pixel takes 4
// taps from each of about 4 output points. Adding every tap into dx with a
// global float4 atomic (the first design) costs ~16 atomics per dx element,
// and they compete in L2 with the gathers of x's taps. Here a block sorts
// its taps by pixel and adds each pixel of a window of dx once.
// - The window is a range of pixel indices y W + x. DySample's points are
//   row-major over the 2H x 2W output, so a tile's taps fall in a band of
//   source rows, which is one range: at most WINDOW_PIXELS long, from the
//   least to the largest index of the tile's taps; where they spread wider,
//   the window is centred on their mean index and kept inside their range.
//   Taps outside it (the offsets are unbounded) go straight to dx with
//   global float4 atomics.
// - The sort is a counting sort in shared memory on integer atomics, which
//   Hopper runs natively: count each window pixel's taps, scan the counts,
//   and each tap writes its point and weight into its pixel's slots. A
//   float atomicAdd on shared memory is a compare-and-swap loop
//   (ATOMS.CAST.SPIN) per add; windows summed that way ran slower than the
//   global atomics alone (PERF.md).
// - A team of lanes (a power of two <= 32) per point, lanes over the group's
//   channels with float4 loads of g and of the taps, forms dgy and dgx
//   (team reduction by __shfl_xor_sync, plain stores) and copies the
//   point's g into shared memory. Then a team per window pixel sums
//   g * weight over the pixel's taps in registers and adds the sum into dx
//   with one global float4 atomic. Neighbouring tiles' windows overlap, so
//   dx is still zero-filled by the wrapper.
// - Small blocks keep many in flight: ~19 KB of shared memory and under 64
//   registers a thread let 8 blocks (32 warps) share an SM, so one block's
//   sort overlaps another's gathers; at 256 threads and 64 KB of g a block
//   the same design ran no faster than the scatter (PERF.md).

constexpr int BWD_THREADS = 128;
constexpr int MAX_POINTS = BWD_THREADS;         // a tile's points: one per thread in the sort
constexpr int G_FLOATS = 4096;                  // a tile's g in shared memory: 16 KB
constexpr int WINDOW_PIXELS = 2 * BWD_THREADS;  // the scan takes two counts per thread

// Points per tile at cg channels a group.
int tile_points(int cg) {
  const int p = G_FLOATS / cg;
  return p < 1 ? 1 : p < MAX_POINTS ? p : MAX_POINTS;
}

// Dynamic shared memory of a block: g [P][cg], slots [WINDOW_PIXELS + 1],
// points [4 P], weights [4 P].
int backward_shared_bytes(int cg) {
  const int p = tile_points(cg);
  return (int)sizeof(float) * (p * cg + WINDOW_PIXELS + 1 + 8 * p);
}

template <int V>
__device__ __forceinline__ void add_vec(float* p, const float* v, float w) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0] * w, v[1] * w, v[2] * w, v[3] * w));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) atomicAdd(p + k, v[k] * w);
  }
}

// The 4 taps of one point, in the order 00, 01, 10, 11: pixel index y W + x
// (clamped), whether the tap counts (zeros mode drops taps out of range), and
// the bilinear weights.
struct Taps {
  int pix[4];
  bool use[4];
  float w[4], wy, wx;
};

__device__ __forceinline__ Taps taps_of(float fy, float fx, int H, int W, bool zeros) {
  Taps tp;
  const float y0 = floorf(fy);
  const float x0 = floorf(fx);
  tp.wy = fy - y0;
  tp.wx = fx - x0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float yf = y0 + (float)(k >> 1);
    const float xf = x0 + (float)(k & 1);
    tp.use[k] = !zeros || (yf >= 0.f && yf <= (float)(H - 1) && xf >= 0.f && xf <= (float)(W - 1));
    const int yi = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
    const int xi = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
    tp.pix[k] = yi * W + xi;
  }
  tp.w[0] = (1.f - tp.wx) * (1.f - tp.wy);
  tp.w[1] = tp.wx * (1.f - tp.wy);
  tp.w[2] = (1.f - tp.wx) * tp.wy;
  tp.w[3] = tp.wx * tp.wy;
  return tp;
}

// grid (ceil(N / P), G, B), BWD_THREADS threads, backward_shared_bytes(C / G)
// of dynamic shared memory. dx is float32 (dx itself, or the scratch of a
// bfloat16 run). With COUNT, also adds to taps[0] the tile's taps and to
// taps[1] those that missed the window (a separate build: the counter costs
// registers).
template <typename T, int V, bool COUNT>
__global__ void __launch_bounds__(BWD_THREADS) sample_bilinear_backward_kernel(
    const T* __restrict__ x, const T* __restrict__ gy, const T* __restrict__ gx,
    const T* __restrict__ gout, float* __restrict__ dx, T* __restrict__ dgy,
    T* __restrict__ dgx, int H, int W, int C, int N, int G, bool zeros, int team, int P,
    unsigned long long* __restrict__ taps) {
  extern __shared__ __align__(16) float smem[];
  const int cg = C / G;
  float* gs = smem;                                   // [P][cg]: the tile's g
  int* slot = reinterpret_cast<int*>(gs + P * cg);    // [WINDOW_PIXELS + 1]: counts, then starts
  int* pt = slot + WINDOW_PIXELS + 1;                 // [4 P]: the taps' points, by pixel
  float* wt = reinterpret_cast<float*>(pt + 4 * P);   // [4 P]: their weights
  __shared__ int lo_s, hi_s;
  __shared__ unsigned long long sum_s;
  __shared__ unsigned int used_s, missed_s;
  __shared__ int warp_sum[BWD_THREADS / 32];
  const int grp = blockIdx.y;
  const long long b = blockIdx.z;
  const int n0 = blockIdx.x * P;
  const long long img = b * H * W * C + (long long)grp * cg;  // + pixel C + channel
  if (threadIdx.x == 0) {
    lo_s = INT_MAX;
    hi_s = -1;
    sum_s = 0;
    used_s = 0;
    missed_s = 0;
  }
  __syncthreads();

  // 1. The window: the least and largest pixel index of the tile's taps,
  // and their sum and count. Thread i takes point n0 + i in steps 1 and 2.
  const bool mine = (int)threadIdx.x < P && n0 + (int)threadIdx.x < N;
  Taps own;
  if (mine) {
    const long long p = (b * N + n0 + threadIdx.x) * G + grp;
    own = taps_of(to_float(gy[p]), to_float(gx[p]), H, W, zeros);
  }
  {
    int lo = INT_MAX, hi = -1;
    unsigned int used = 0;
    unsigned long long sum = 0;
    if (mine) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (own.use[k]) {
          lo = min(lo, own.pix[k]);
          hi = max(hi, own.pix[k]);
          sum += (unsigned long long)own.pix[k];
          ++used;
        }
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    used = __reduce_add_sync(0xffffffffu, used);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (threadIdx.x % 32 == 0) {
      atomicMin(&lo_s, lo);
      atomicMax(&hi_s, hi);
      atomicAdd(&sum_s, sum);
      atomicAdd(&used_s, used);
    }
  }
  __syncthreads();
  const int lo = lo_s, hi = hi_s;
  int p0 = 0, span = 0;
  if (used_s > 0) {
    if (hi - lo < WINDOW_PIXELS) {
      p0 = lo;
      span = hi - lo + 1;
    } else {
      const long long mean = (long long)(sum_s / used_s);
      p0 = (int)min(max(mean - WINDOW_PIXELS / 2, (long long)lo),
                    (long long)(hi - WINDOW_PIXELS + 1));
      span = WINDOW_PIXELS;
    }
  }
  for (int i = threadIdx.x; i <= span; i += BWD_THREADS) slot[i] = 0;
  __syncthreads();

  // 2. The counting sort: each window pixel's taps counted (a tap's rank is
  // the count it found), the counts scanned into starts, then each tap's
  // point and weight written at start + rank.
  int rank[4] = {-1, -1, -1, -1};
  if (mine) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = own.pix[k] - p0;
      if (own.use[k] && r >= 0 && r < span) rank[k] = atomicAdd(&slot[r], 1);
    }
  }
  __syncthreads();
  {
    const int i = 2 * threadIdx.x, lane = threadIdx.x % 32;
    const int a = i < span ? slot[i] : 0, c = i + 1 < span ? slot[i + 1] : 0;
    int incl = a + c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[threadIdx.x / 32] = incl;
    __syncthreads();
    for (int w = 0; w < (int)threadIdx.x / 32; ++w) incl += warp_sum[w];
    if (i < span) slot[i] = incl - a - c;
    if (i + 1 < span) slot[i + 1] = incl - c;
    if (threadIdx.x == BWD_THREADS - 1) slot[span] = incl;  // the total
  }
  __syncthreads();
  if (mine) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (rank[k] < 0) continue;
      const int e = slot[own.pix[k] - p0] + rank[k];
      pt[e] = threadIdx.x;
      wt[e] = own.w[k];
    }
  }

  // 3. A team per point: dgy and dgx, the point's g into shared memory, and
  // its taps that missed the window into dx.
  const int teams = BWD_THREADS / team, tm = threadIdx.x / team, lane = threadIdx.x % team;
  unsigned int missed = 0;
  for (int j0 = 0; j0 < P; j0 += teams) {
    const int j = j0 + tm, n = n0 + j;
    const long long p = (b * N + n) * G + grp;
    float sy = 0.f, sx = 0.f;
    if (j < P && n < N) {
      const Taps tp = taps_of(to_float(gy[p]), to_float(gx[p]), H, W, zeros);
      const T* go = gout + (b * N + n) * C + (long long)grp * cg;
      for (int c = lane * V; c < cg; c += team * V) {
        float g[V], v[4][V];
        load_vec<T, V>(go + c, g);
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(gs + j * cg + c) = make_float4(g[0], g[1], g[2], g[3]);
        } else {
          gs[j * cg + c] = g[0];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (tp.use[k]) {
            load_vec<T, V>(x + img + (long long)tp.pix[k] * C + c, v[k]);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) v[k][i] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float top = v[0][i] * (1.f - tp.wx) + v[1][i] * tp.wx;
          const float bot = v[2][i] * (1.f - tp.wx) + v[3][i] * tp.wx;
          sy += g[i] * (bot - top);
          sx += g[i] * ((v[1][i] - v[0][i]) * (1.f - tp.wy) + (v[3][i] - v[2][i]) * tp.wy);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = tp.pix[k] - p0;
          if (tp.use[k] && (r < 0 || r >= span)) {
            add_vec<V>(dx + img + (long long)tp.pix[k] * C + c, g, tp.w[k]);
            if constexpr (COUNT) missed += c == 0;  // once per tap: lane 0's first channels
          }
        }
      }
    }
    // every lane of the warp takes part: teams are aligned powers of two <= 32
    for (int o = team >> 1; o > 0; o >>= 1) {
      sy += __shfl_xor_sync(0xffffffffu, sy, o);
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
    }
    if (j < P && n < N && lane == 0) {
      dgy[p] = from_float<T>(sy);
      dgx[p] = from_float<T>(sx);
    }
  }
  __syncthreads();

  // 4. A team per window pixel: g * weight summed over the pixel's taps in
  // registers, then added into dx once.
  for (int r = tm; r < span; r += teams) {
    const int e0 = slot[r], e1 = slot[r + 1];
    if (e0 == e1) continue;
    for (int c = lane * V; c < cg; c += team * V) {
      float acc[V] = {};
      for (int e = e0; e < e1; ++e) {
        const float w = wt[e];
        const float* g = gs + pt[e] * cg + c;
        if constexpr (V == 4) {
          const float4 q = *reinterpret_cast<const float4*>(g);
          acc[0] = fmaf(q.x, w, acc[0]);
          acc[1] = fmaf(q.y, w, acc[1]);
          acc[2] = fmaf(q.z, w, acc[2]);
          acc[3] = fmaf(q.w, w, acc[3]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(g[k], w, acc[k]);
        }
      }
      add_vec<V>(dx + img + (long long)(p0 + r) * C + c, acc, 1.f);
    }
  }
  if constexpr (COUNT) {
    missed = __reduce_add_sync(0xffffffffu, missed);
    if (threadIdx.x % 32 == 0) atomicAdd(&missed_s, missed);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(&taps[0], (unsigned long long)used_s);
      atomicAdd(&taps[1], (unsigned long long)missed_s);
    }
  }
}

// The float32 sums of a bfloat16 run's dx, each rounded once into dx: 4
// elements a thread, 16-byte loads and 8-byte stores when both are aligned.
__global__ void round_to_bf16_kernel(const float* __restrict__ acc, bf16* __restrict__ out,
                                     long long n, bool vec) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (vec && i + 4 <= n) {
    float v[4];
    load_vec<float, 4>(acc + i, v);
    store_bf16x4(out + i, v);
  } else {
    for (long long j = i; j < i + 4 && j < n; ++j) out[j] = __float2bfloat16(acc[j]);
  }
}

// dx_acc: the float32 dx the kernel adds into, zero-filled; for bfloat16,
// dx_out receives it rounded (for float32 it is dx_acc itself).
template <typename T, bool COUNT>
int backward(const void* x, const void* gy, const void* gx, const void* gout, void* dx_acc,
             void* dx_out, void* dgy, void* dgx, int B, int H, int W, int C, int N, int G,
             int zeros, int device, void* stream, void* taps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr uintptr_t VEC_BYTES = 4 * sizeof(T);
  const bool vec4 = (C / G) % 4 == 0 && (uintptr_t)x % VEC_BYTES == 0 &&
                    (uintptr_t)gout % VEC_BYTES == 0 && (uintptr_t)dx_acc % 16 == 0;
  const int v = vec4 ? 4 : 1;
  if ((long long)B * N * G == 0) return 0;
  if (B > 65535 || G > 65535) return (int)cudaErrorInvalidConfiguration;
  int team = 1;
  while (team < 32 && team * 2 <= (C / G) / v) team *= 2;
  const int P = tile_points(C / G), smem = backward_shared_bytes(C / G);
  const dim3 grid((unsigned)((N + P - 1) / P), (unsigned)G, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* gyt = static_cast<const T*>(gy);
  const T* gxt = static_cast<const T*>(gx);
  const T* got = static_cast<const T*>(gout);
  float* acc = static_cast<float*>(dx_acc);
  T* dgyt = static_cast<T*>(dgy);
  T* dgxt = static_cast<T*>(dgx);
  unsigned long long* count = static_cast<unsigned long long*>(taps);
  if (vec4) {
    err = cudaFuncSetAttribute(sample_bilinear_backward_kernel<T, 4, COUNT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sample_bilinear_backward_kernel<T, 4, COUNT><<<grid, BWD_THREADS, smem, s>>>(
        xt, gyt, gxt, got, acc, dgyt, dgxt, H, W, C, N, G, zeros != 0, team, P, count);
  } else {
    err = cudaFuncSetAttribute(sample_bilinear_backward_kernel<T, 1, COUNT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sample_bilinear_backward_kernel<T, 1, COUNT><<<grid, BWD_THREADS, smem, s>>>(
        xt, gyt, gxt, got, acc, dgyt, dgxt, H, W, C, N, G, zeros != 0, team, P, count);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || sizeof(T) == 4) return (int)err;
  const long long n = (long long)B * H * W * C;
  const long long blocks = (n + 4 * 256 - 1) / (4 * 256);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = (uintptr_t)dx_acc % 16 == 0 && (uintptr_t)dx_out % 8 == 0;
  round_to_bf16_kernel<<<(unsigned)blocks, 256, 0, s>>>(acc, static_cast<bf16*>(dx_out), n, vec);
  return (int)cudaGetLastError();
}

// A vector is VEC channels, one 16-byte load a tap (4 floats, 8 bfloat16),
// where C / G and the alignment allow, else one channel. A block takes
// FWD_THREADS threads: lanes along a group's vectors (FWD_VECS a lane, at
// most 32 lanes), then up to 64 groups, then points.
template <typename T>
int forward(const void* x, const void* gy, const void* gx, void* out, int B, int H, int W, int C,
            int N, int G, int zeros, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int VEC = 16 / sizeof(T);
  const int cg = C / G;
  const bool vec = cg % VEC == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int v = vec ? VEC : 1;
  if ((long long)B * N * C == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const int cgv = cg / v;
  const int lanes = (cgv + FWD_VECS - 1) / FWD_VECS, tx = lanes < 32 ? lanes : 32;
  const int groups = G < 64 ? G : 64, tz = groups < FWD_THREADS / tx ? groups : FWD_THREADS / tx;
  const int ty = FWD_THREADS / (tx * tz);  // points a block
  const dim3 block(tx, ty, tz), grid((unsigned)((N + FWD_RUN * ty - 1) / (FWD_RUN * ty)),
                                     (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* gyt = static_cast<const T*>(gy);
  const T* gxt = static_cast<const T*>(gx);
  T* ot = static_cast<T*>(out);
  if (vec) {
    sample_bilinear_kernel<T, VEC><<<grid, block, 0, s>>>(xt, gyt, gxt, ot, H, W, C, N, G, cg,
                                                          zeros != 0);
  } else {
    sample_bilinear_kernel<T, 1><<<grid, block, 0, s>>>(xt, gyt, gxt, ot, H, W, C, N, G, cg,
                                                        zeros != 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dx (B, H, W, C) must be zero-filled; dgy, dgx are (B, N, G). Launches on
// `stream` of `device`; returns cudaGetLastError() of the launch.
extern "C" int sample_bilinear_backward_f32(const void* x, const void* gy, const void* gx,
                                            const void* gout, void* dx, void* dgy, void* dgx,
                                            int B, int H, int W, int C, int N, int G, int zeros,
                                            int device, void* stream) {
  return backward<float, false>(x, gy, gx, gout, dx, dx, dgy, dgx, B, H, W, C, N, G, zeros,
                                device, stream, nullptr);
}

// bfloat16 x, gy, gx, gout, dx, dgy and dgx; dx_acc is a zero-filled float32
// (B, H, W, C) scratch that holds dx's float32 sums. Launches the backward
// kernel and the rounding pass on `stream` of `device`; returns
// cudaGetLastError() of the launches.
extern "C" int sample_bilinear_backward_bf16(const void* x, const void* gy, const void* gx,
                                             const void* gout, void* dx_acc, void* dx, void* dgy,
                                             void* dgx, int B, int H, int W, int C, int N, int G,
                                             int zeros, int device, void* stream) {
  return backward<bf16, false>(x, gy, gx, gout, dx_acc, dx, dgy, dgx, B, H, W, C, N, G, zeros,
                               device, stream, nullptr);
}

// As sample_bilinear_backward_f32, and adds to taps[0] the taps it scattered
// and to taps[1] those that missed their tile's window (two zeroed 64-bit
// counters on the card).
extern "C" int sample_bilinear_backward_taps_f32(const void* x, const void* gy, const void* gx,
                                                 const void* gout, void* dx, void* dgy, void* dgx,
                                                 int B, int H, int W, int C, int N, int G,
                                                 int zeros, int device, void* stream,
                                                 void* taps) {
  return backward<float, true>(x, gy, gx, gout, dx, dx, dgy, dgx, B, H, W, C, N, G, zeros, device,
                               stream, taps);
}

// Bytes of dynamic shared memory a backward block takes at C / G channels a
// group.
extern "C" int sample_bilinear_backward_shared_bytes(int C, int G) {
  return backward_shared_bytes(C / G);
}

// Launches on `stream` of `device`; returns cudaGetLastError() of the launch.
extern "C" int sample_bilinear_f32(const void* x, const void* gy, const void* gx, void* out,
                                   int B, int H, int W, int C, int N, int G, int zeros,
                                   int device, void* stream) {
  return forward<float>(x, gy, gx, out, B, H, W, C, N, G, zeros, device, stream);
}

// x, gy, gx and out in bfloat16; taps, weights and the blend in float32.
extern "C" int sample_bilinear_bf16(const void* x, const void* gy, const void* gx, void* out,
                                    int B, int H, int W, int C, int N, int G, int zeros,
                                    int device, void* stream) {
  return forward<bf16>(x, gy, gx, out, B, H, W, C, N, G, zeros, device, stream);
}
