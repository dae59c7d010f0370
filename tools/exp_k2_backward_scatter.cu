// The first design of the DySample sampler's backward (K2), which the port
// ran until the counting sort in yolo_dbl_tpu_torch/csrc/sampling.cu took
// its place: a team of lanes per (point, group) adds each of its 4 taps into
// dx with a global float4 atomic. tools/exp_k2_backward_designs.py builds it,
// and copies of it with parts knocked out, to time against the kernel the
// port ships. Same C interface: dx must be zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
