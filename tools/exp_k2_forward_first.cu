// The first design of the DySample sampler's forward kernel (K2), as
// yolo_dbl_tpu_torch/csrc/sampling.cu shipped it until its redesign: one
// thread a 16-byte output vector (4 float32 or 8 bfloat16 channels, or one
// channel where C / G or the alignment refuses 16 bytes), threads along C,
// the point and channel found from the thread's flat index by 64-bit
// division, the point's coordinates loaded by every lane of its group.
// Kept for tools/exp_k2_forward_designs.py, which times it beside the
// shipped kernel and builds knocked-out copies of it.

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

// V consecutive values of p as float32: one 16-byte load for 4 floats or 8
// bfloat16, one 8-byte load for 4 bfloat16.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (V == 8) {
    static_assert(sizeof(T) == 2, "8 values a load are bfloat16");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else if constexpr (V == 4 && sizeof(T) == 4) {
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

// V floats to p in T, each rounded once.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (V == 8) {
    static_assert(sizeof(T) == 2, "8 values a store are bfloat16");
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&a);
    q.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = from_float<T>(v[k]);
  }
}

template <int V>
struct Vec {
  float v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<V> tap(const T* __restrict__ img, float yf, float xf, int H,
                                      int W, int C, bool zeros) {
  Vec<V> r;
  if (zeros && !(yf >= 0.f && yf <= (float)(H - 1) && xf >= 0.f && xf <= (float)(W - 1))) {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = 0.f;
    return r;
  }
  const int yi = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
  const int xi = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
  load_vec<T, V>(img + ((long long)yi * W + xi) * C, r.v);
  return r;
}

template <typename T, int V>
__global__ void sample_bilinear_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                                       const T* __restrict__ gx, T* __restrict__ out,
                                       int H, int W, int C, int N, int G, bool zeros,
                                       long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvec = C / V;
  const int c = (int)(i % cvec) * V;
  const long long bn = i / cvec;  // b * N + n
  const long long b = bn / N;
  const int g = c / (C / G);
  const float fy = to_float(gy[bn * G + g]);
  const float fx = to_float(gx[bn * G + g]);
  const float y0 = floorf(fy);
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
  store_vec<T, V>(out + bn * C + c, r.v);
}

// A thread blends VEC channels: one 16-byte load a tap (4 floats, 8
// bfloat16) where C / G and the alignment allow, else one channel.
template <typename T>
int forward(const void* x, const void* gy, const void* gx, void* out, int B, int H, int W, int C,
            int N, int G, int zeros, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = C % VEC == 0 && (C / G) % VEC == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int v = vec ? VEC : 1;
  const long long total = (long long)B * N * (C / v);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* gyt = static_cast<const T*>(gy);
  const T* gxt = static_cast<const T*>(gx);
  T* ot = static_cast<T*>(out);
  if (vec) {
    sample_bilinear_kernel<T, VEC><<<(unsigned)blocks, threads, 0, s>>>(xt, gyt, gxt, ot, H, W,
                                                                        C, N, G, zeros != 0, total);
  } else {
    sample_bilinear_kernel<T, 1><<<(unsigned)blocks, threads, 0, s>>>(xt, gyt, gxt, ot, H, W, C,
                                                                      N, G, zeros != 0, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

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
