// Group-aware bilinear point sampler: the sampling inside every DySample.
//
// Replaces the TPU kernel yolo_dbl_tpu/kernels/sampling.py (`_pallas_sample`,
// body `_kernel`, pallas_call at :102) and computes the gather form of
// yolo_dbl_tpu/ops/resample.py:sample_bilinear_pixel (:278-305):
//
//   out[b, n, c] = bilinear(x[b, :, :, c], gy[b, n, g], gx[b, n, g]),  g = c / (C / G)
//
// x is NHWC (B, H, W, C) float32, gy/gx are pixel coordinates (B, N, G) with
// one coordinate pair per contiguous channel group, out is (B, N, C).
// Padding is "border" (taps clamped, so coincident taps add) or "zeros"
// (out-of-range taps read 0).
//
// Bound: bytes. Each output element costs 4 loads and ~10 flops, far below
// the card's 67 TFLOP/s fp32 rate; the least traffic is x read once, out
// written once and the coordinates read once (DySample row 13 of YOLO-DBL-s
// at batch 8: 13.1 MB + 52.4 MB + 1.6 MB, about 20 us at 3.35 TB/s).
//
// Design: the TPU kernel turned the gather into dense one-hot matmuls
// because Mosaic rejects gathers; Hopper gathers from L1/L2 directly, so
// each thread computes one output vector of 4 channels (float4 loads and
// stores) and threads run along C, so that a warp's taps and its store are
// contiguous. Neighbouring output points reuse the same source pixels, and
// a DySample source (<= 13 MB at batch 8) stays in the 50 MB L2, so x is
// read from device memory about once. One launch covers all G groups.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> tap(const float* __restrict__ img, float yf, float xf, int H,
                                      int W, int C, bool zeros) {
  Vec<V> r;
  if (zeros && !(yf >= 0.f && yf <= (float)(H - 1) && xf >= 0.f && xf <= (float)(W - 1))) {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = 0.f;
    return r;
  }
  const int yi = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
  const int xi = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
  const float* p = img + ((long long)yi * W + xi) * C;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = __ldg(p + k);
  }
  return r;
}

template <int V>
__global__ void sample_bilinear_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                                       const float* __restrict__ gx, float* __restrict__ out,
                                       int H, int W, int C, int N, int G, bool zeros,
                                       long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvec = C / V;
  const int c = (int)(i % cvec) * V;
  const long long bn = i / cvec;  // b * N + n
  const long long b = bn / N;
  const int g = c / (C / G);
  const float fy = gy[bn * G + g];
  const float fx = gx[bn * G + g];
  const float y0 = floorf(fy);
  const float x0 = floorf(fx);
  const float wy = fy - y0;
  const float wx = fx - x0;
  const float* img = x + b * H * W * C + c;
  const Vec<V> v00 = tap<V>(img, y0, x0, H, W, C, zeros);
  const Vec<V> v01 = tap<V>(img, y0, x0 + 1.f, H, W, C, zeros);
  const Vec<V> v10 = tap<V>(img, y0 + 1.f, x0, H, W, C, zeros);
  const Vec<V> v11 = tap<V>(img, y0 + 1.f, x0 + 1.f, H, W, C, zeros);
  Vec<V> r;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float top = v00.v[k] * (1.f - wx) + v01.v[k] * wx;
    const float bot = v10.v[k] * (1.f - wx) + v11.v[k] * wx;
    r.v[k] = top * (1.f - wy) + bot * wy;
  }
  float* o = out + bn * C + c;
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = r.v[k];
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
// Design: a team of lanes (a power of two <= 32) per (b, n, group) point,
// lanes over the group's channels with float4 loads of g and of the taps.
// Each lane keeps partial sums of dgy/dgx over its channels and the team
// reduces them with __shfl_xor_sync. dx is a scatter: neighbouring output
// points share taps, so the taps are added with atomicAdd (the float4
// overload of sm_90) into the buffer the wrapper zeroes. x and dx of one
// DySample site (<= 26 MB at batch 16) stay mostly in the 50 MB L2.

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* v) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(p + k);
  }
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

template <int V>
__global__ void sample_bilinear_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ gy, const float* __restrict__ gx,
    const float* __restrict__ gout, float* __restrict__ dx, float* __restrict__ dgy,
    float* __restrict__ dgx, int H, int W, int C, int N, int G, bool zeros, long long points,
    int team) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = t / team;  // (b * N + n) * G + group
  const int lane = (int)(t % team);
  float sy = 0.f, sx = 0.f;
  if (p < points) {
    const long long bn = p / G;
    const int grp = (int)(p % G);
    const long long b = bn / N;
    const int cg = C / G;
    const float fy = gy[p];
    const float fx = gx[p];
    const float y0 = floorf(fy);
    const float x0 = floorf(fx);
    const float wy = fy - y0;
    const float wx = fx - x0;
    // the 4 taps in the order 00, 01, 10, 11: pixel offset and whether it counts
    long long off[4];
    bool use[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float yf = y0 + (float)(k >> 1);
      const float xf = x0 + (float)(k & 1);
      use[k] = !zeros || (yf >= 0.f && yf <= (float)(H - 1) && xf >= 0.f && xf <= (float)(W - 1));
      const int yi = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
      const int xi = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
      off[k] = ((long long)yi * W + xi) * C;
    }
    const float w[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy};
    const long long base = b * H * W * C + (long long)grp * cg;
    const float* go = gout + bn * C + (long long)grp * cg;
    for (int c = lane * V; c < cg; c += team * V) {
      float g[V], v[4][V];
      load_vec<V>(go + c, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (use[k]) {
          load_vec<V>(x + base + off[k] + c, v[k]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[k][j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float top = v[0][j] * (1.f - wx) + v[1][j] * wx;
        const float bot = v[2][j] * (1.f - wx) + v[3][j] * wx;
        sy += g[j] * (bot - top);
        sx += g[j] * ((v[1][j] - v[0][j]) * (1.f - wy) + (v[3][j] - v[2][j]) * wy);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (use[k]) add_vec<V>(dx + base + off[k] + c, g, w[k]);
      }
    }
  }
  // every lane of the warp takes part: teams are aligned powers of two <= 32
  for (int o = team >> 1; o > 0; o >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
  if (p < points && lane == 0) {
    dgy[p] = sy;
    dgx[p] = sx;
  }
}

}  // namespace

// dx (B, H, W, C) must be zero-filled; dgy, dgx are (B, N, G). Launches on
// `stream` of `device`; returns cudaGetLastError() of the launch.
extern "C" int sample_bilinear_backward_f32(const void* x, const void* gy, const void* gx,
                                            const void* gout, void* dx, void* dgy, void* dgx,
                                            int B, int H, int W, int C, int N, int G, int zeros,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = (C / G) % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)gout % 16 == 0 &&
                    (uintptr_t)dx % 16 == 0;
  const int v = vec4 ? 4 : 1;
  const long long points = (long long)B * N * G;
  if (points == 0) return 0;
  int team = 1;
  while (team < 32 && team * 2 <= (C / G) / v) team *= 2;
  const int threads = 256;
  const long long blocks = (points * team + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gyf = static_cast<const float*>(gy);
  const float* gxf = static_cast<const float*>(gx);
  const float* gof = static_cast<const float*>(gout);
  float* dxf = static_cast<float*>(dx);
  float* dgyf = static_cast<float*>(dgy);
  float* dgxf = static_cast<float*>(dgx);
  if (vec4) {
    sample_bilinear_backward_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
        xf, gyf, gxf, gof, dxf, dgyf, dgxf, H, W, C, N, G, zeros != 0, points, team);
  } else {
    sample_bilinear_backward_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
        xf, gyf, gxf, gof, dxf, dgyf, dgxf, H, W, C, N, G, zeros != 0, points, team);
  }
  return (int)cudaGetLastError();
}

// Launches on `stream` of `device`; returns cudaGetLastError() of the launch.
extern "C" int sample_bilinear_f32(const void* x, const void* gy, const void* gx, void* out,
                                   int B, int H, int W, int C, int N, int G, int zeros,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = C % 4 == 0 && (C / G) % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  const int v = vec4 ? 4 : 1;
  const long long total = (long long)B * N * (C / v);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gyf = static_cast<const float*>(gy);
  const float* gxf = static_cast<const float*>(gx);
  float* of = static_cast<float*>(out);
  if (vec4) {
    sample_bilinear_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(xf, gyf, gxf, of, H, W, C, N, G,
                                                                   zeros != 0, total);
  } else {
    sample_bilinear_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(xf, gyf, gxf, of, H, W, C, N, G,
                                                                   zeros != 0, total);
  }
  return (int)cudaGetLastError();
}
