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

}  // namespace

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
