// Area attention: softmax(q k^T / sqrt(hd)) v over (BB, N, H, hd) tokens.
//
// Replaces the TPU kernels that yolo_dbl_tpu/nn/blocks.py:868-884
// (`_area_attention`, the attention of every AAttn) reaches through JAX's
// Pallas `flash_attention` (jax 0.9.0, jax/experimental/pallas/ops/tpu/
// flash_attention.py): the forward (`_flash_attention_impl`, pallas_call at
// :758) and the two backward kernels of its custom_vjp
// (`_flash_attention_bwd_dkv`, :1121, and `_flash_attention_bwd_dq`, :1456).
// It computes the function, not the TPU blocking: the Pallas call pads N to
// 128 and masks the pad with segment ids; these kernels mask their own
// ragged tiles and take any N >= 1.
//
// Layout: q, k and v are (BB, N, H, 32) float32 with the head dim contiguous
// and any strides on BB, N and H, so AAttn passes the three views of its
// (BB, N, H, 3 x 32) qkv tensor (each head holds [q_h | k_h | v_h]) without
// copies. o, do, dq, dk and dv are contiguous (BB, N, H, 32); lse and
// delta are contiguous (BB, H, N).
//
// Bound: operations. The forward is 4 N^2 hd flops per sequence-head (two
// products), the backward 8 N^2 hd (four products), against a few bytes per
// token: row 6 of YOLOv13-s at serving batch 8 (BB 32, H 4, N 400) is
// 2.6 GFLOP, 39 us at 67 TFLOP/s fp32, and moves 26 MB, 8 us at 3.35 TB/s.
//
// Design (simple first: fp32 FMAs on the CUDA cores, no tensor cores, no
// TMA). One thread owns one row; the rows of the other operand stream
// through shared memory in 64-row tiles, read as float4 broadcasts (every
// lane of a warp reads the same row). All sums are float32.
// - forward: a thread per query row keeps q, the output accumulator and an
//   online softmax (running max m, sum l), 16 keys at a time; it writes
//   o = acc / l and the row's log-sum-exp m + log l for the backward.
// - backward, dq: a thread per query row; delta = rowsum(do * o) first (it
//   also writes delta for the dkv kernel), then over all keys
//   p = exp(s - lse), ds = p (do . v - delta), dq += ds k.
// - backward, dkv: a thread per key row, over all queries:
//   dv += p do, dk += ds q.
// Each output element is written by one thread: no atomics, and the result
// is the same from run to run. The dq kernel runs first, since the dkv
// kernel reads its delta.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 32;      // head dim: A2C2f's heads are c_ / 32 wide
constexpr int V4 = HD / 4;  // float4s per row
constexpr int ROWS = 64;    // rows a block owns (threads per block)
constexpr int TILE = 64;    // rows of the other operand per shared-memory tile
constexpr int CHUNK = 16;   // keys per online-softmax update in the forward

struct Strides {
  long long b, n, h;  // in elements; the head dim has stride 1
};

__device__ __forceinline__ const float* row_ptr(const float* base, const Strides& s,
                                                long long b, long long n, long long h) {
  return base + b * s.b + n * s.n + h * s.h;
}

__device__ __forceinline__ void load_row(const float* __restrict__ p, float* r) {
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + c);
    r[4 * c] = t.x;
    r[4 * c + 1] = t.y;
    r[4 * c + 2] = t.z;
    r[4 * c + 3] = t.w;
  }
}

__device__ __forceinline__ void store_row(float* p, const float* r, float scale) {
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    reinterpret_cast<float4*>(p)[c] =
        make_float4(r[4 * c] * scale, r[4 * c + 1] * scale, r[4 * c + 2] * scale,
                    r[4 * c + 3] * scale);
  }
}

__device__ __forceinline__ float dot_smem(const float* r, const float4* s) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    const float4 t = s[c];
    acc = fmaf(r[4 * c], t.x, acc);
    acc = fmaf(r[4 * c + 1], t.y, acc);
    acc = fmaf(r[4 * c + 2], t.z, acc);
    acc = fmaf(r[4 * c + 3], t.w, acc);
  }
  return acc;
}

__device__ __forceinline__ void axpy_smem(float* acc, float a, const float4* s) {
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    const float4 t = s[c];
    acc[4 * c] = fmaf(a, t.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(a, t.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, t.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, t.w, acc[4 * c + 3]);
  }
}

// Rows [t0, t0 + TILE) of one (b, h) sequence of x into shared memory; rows
// past N are zero.
__device__ __forceinline__ void load_tile(float4 (*dst)[V4], const float* __restrict__ x,
                                          const Strides& s, long long b, long long h, int t0,
                                          int N) {
  for (int idx = threadIdx.x; idx < TILE * V4; idx += blockDim.x) {
    const int r = idx / V4, c = idx % V4;
    const int n = t0 + r;
    dst[r][c] = n < N ? __ldg(reinterpret_cast<const float4*>(row_ptr(x, s, b, n, h)) + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// grid (BB * H, ceil(N / ROWS)), ROWS threads
__global__ void __launch_bounds__(ROWS)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
                         float* __restrict__ o, float* __restrict__ lse, int N, int H,
                         float scale) {
  __shared__ float4 Ks[TILE][V4];
  __shared__ float4 Vs[TILE][V4];
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int i = blockIdx.y * ROWS + threadIdx.x;
  const bool valid = i < N;
  float qr[HD], acc[HD];
  if (valid) {
    load_row(row_ptr(q, qs, b, i, h), qr);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] *= scale;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < N; t0 += TILE) {
    __syncthreads();
    load_tile(Ks, k, ks, b, h, t0, N);
    load_tile(Vs, v, vs, b, h, t0, N);
    __syncthreads();
    const int nk = min(TILE, N - t0);
    for (int j0 = 0; j0 < nk; j0 += CHUNK) {
      float s[CHUNK];
      float mc = m;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        s[u] = j0 + u < nk ? dot_smem(qr, Ks[j0 + u]) : -INFINITY;
        mc = fmaxf(mc, s[u]);
      }
      // mc is finite: key j0 < nk is real
      const float alpha = expf(m - mc);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const float p = expf(s[u] - mc);  // 0 past the last key
        l += p;
        axpy_smem(acc, p, Vs[j0 + u]);
      }
      m = mc;
    }
  }
  if (valid) {
    store_row(o + ((b * N + i) * H + h) * HD, acc, 1.f / l);
    lse[seq * N + i] = m + logf(l);
  }
}

// grid (BB * H, ceil(N / ROWS)), ROWS threads
__global__ void __launch_bounds__(ROWS)
    attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
                            const float* __restrict__ o, const float* __restrict__ lse,
                            const float* __restrict__ dout, float* __restrict__ dq,
                            float* __restrict__ delta, int N, int H, float scale) {
  __shared__ float4 Ks[TILE][V4];
  __shared__ float4 Vs[TILE][V4];
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int i = blockIdx.y * ROWS + threadIdx.x;
  const bool valid = i < N;
  float qr[HD], dor[HD], acc[HD];
  float li = 0.f, di = 0.f;
  if (valid) {
    const long long r = ((b * N + i) * H + h) * HD;
    load_row(row_ptr(q, qs, b, i, h), qr);
    load_row(o + r, acc);
    load_row(dout + r, dor);
#pragma unroll
    for (int d = 0; d < HD; ++d) di = fmaf(dor[d], acc[d], di);
    li = lse[seq * N + i];
    delta[seq * N + i] = di;
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = dor[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] *= scale;
    acc[d] = 0.f;
  }
  for (int t0 = 0; t0 < N; t0 += TILE) {
    __syncthreads();
    load_tile(Ks, k, ks, b, h, t0, N);
    load_tile(Vs, v, vs, b, h, t0, N);
    __syncthreads();
    const int nk = min(TILE, N - t0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float p = expf(dot_smem(qr, Ks[j]) - li);
      const float ds = p * (dot_smem(dor, Vs[j]) - di);
      axpy_smem(acc, ds, Ks[j]);
    }
  }
  if (valid) store_row(dq + ((b * N + i) * H + h) * HD, acc, scale);
}

// grid (BB * H, ceil(N / ROWS)), ROWS threads; reads the delta of the dq kernel
__global__ void __launch_bounds__(ROWS)
    attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
                             const float* __restrict__ lse, const float* __restrict__ dout,
                             const float* __restrict__ delta, float* __restrict__ dk,
                             float* __restrict__ dv, int N, int H, float scale) {
  __shared__ float4 Qs[TILE][V4];
  __shared__ float4 Ds[TILE][V4];
  __shared__ float Ls[TILE];
  __shared__ float Es[TILE];
  const Strides os = {(long long)N * H * HD, (long long)H * HD, HD};
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int j = blockIdx.y * ROWS + threadIdx.x;
  const bool valid = j < N;
  float kr[HD], vr[HD], dkr[HD], dvr[HD];
  if (valid) {
    load_row(row_ptr(k, ks, b, j, h), kr);
    load_row(row_ptr(v, vs, b, j, h), vr);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) kr[d] = vr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    kr[d] *= scale;
    dkr[d] = dvr[d] = 0.f;
  }
  for (int t0 = 0; t0 < N; t0 += TILE) {
    __syncthreads();
    load_tile(Qs, q, qs, b, h, t0, N);
    load_tile(Ds, dout, os, b, h, t0, N);
    for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
      Ls[r] = t0 + r < N ? lse[seq * N + t0 + r] : 0.f;
      Es[r] = t0 + r < N ? delta[seq * N + t0 + r] : 0.f;
    }
    __syncthreads();
    const int nq = min(TILE, N - t0);
#pragma unroll 4
    for (int i = 0; i < nq; ++i) {
      const float p = expf(dot_smem(kr, Qs[i]) - Ls[i]);
      axpy_smem(dvr, p, Ds[i]);
      const float ds = p * (dot_smem(vr, Ds[i]) - Es[i]);
      axpy_smem(dkr, ds, Qs[i]);
    }
  }
  if (valid) {
    const long long r = ((b * N + j) * H + h) * HD;
    store_row(dk + r, dkr, scale);
    store_row(dv + r, dvr, 1.f);
  }
}

bool grid_for(int BB, int N, int H, dim3* grid) {
  const long long seqs = (long long)BB * H;
  const long long tiles = (N + ROWS - 1) / ROWS;
  if (seqs > 0x7fffffffLL || tiles > 65535) return false;
  *grid = dim3((unsigned)seqs, (unsigned)tiles);
  return true;
}

}  // namespace

// q, k, v: (BB, N, H, 32) with element strides (b, n, h) given per tensor and
// 16-byte aligned rows; o (BB, N, H, 32) and lse (BB, H, N) contiguous.
// Launches on `stream` of `device`; returns cudaGetLastError() of the launch.
extern "C" int area_attention_fwd_f32(const void* q, const void* k, const void* v,
                                      long long qsb, long long qsn, long long qsh,
                                      long long ksb, long long ksn, long long ksh,
                                      long long vsb, long long vsn, long long vsh, void* o,
                                      void* lse, int BB, int N, int H, float scale, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid)) return (int)cudaErrorInvalidConfiguration;
  attention_fwd_kernel<<<grid, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
      static_cast<float*>(o), static_cast<float*>(lse), N, H, scale);
  return (int)cudaGetLastError();
}

// dq, delta (BB, H, N) from q, k, v (strided as above), o, lse and do
// (contiguous). Launches on `stream` of `device`; returns cudaGetLastError().
extern "C" int area_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                         long long qsb, long long qsn, long long qsh,
                                         long long ksb, long long ksn, long long ksh,
                                         long long vsb, long long vsn, long long vsh,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* delta, int BB, int N, int H,
                                         float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid)) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dq_kernel<<<grid, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
      static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(delta), N,
      H, scale);
  return (int)cudaGetLastError();
}

// dk, dv from q, k, v (strided as above), lse, do and the delta of
// area_attention_bwd_dq_f32. Launches on `stream` of `device`; returns
// cudaGetLastError() of the launch.
extern "C" int area_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                          long long qsb, long long qsn, long long qsh,
                                          long long ksb, long long ksn, long long ksh,
                                          long long vsb, long long vsn, long long vsh,
                                          const void* lse, const void* dout, const void* delta,
                                          void* dk, void* dv, int BB, int N, int H,
                                          float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid)) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dkv_kernel<<<grid, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), N, H,
      scale);
  return (int)cudaGetLastError();
}
