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
// and any 16-byte aligned strides on BB, N and H, so AAttn passes the three
// views of its (BB, N, H, 3 x 32) qkv tensor (each head holds
// [q_h | k_h | v_h]) without copies. o, do, dq, dk and dv are contiguous
// (BB, N, H, 32); lse (natural log, of the scaled scores) and delta are
// contiguous (BB, H, N).
//
// Forward (attention_fwd_kernel): fp32 FMAs on the CUDA cores. One thread
// owns one query row and keeps q, the output accumulator and an online
// softmax (running max m, sum l), 16 keys at a time, over 64-key tiles of k
// and v in shared memory read as float4 broadcasts; it writes o = acc / l and
// the row's log-sum-exp m + log l for the backward.
//
// Backward: the dq kernel, then the dkv kernel, as Pallas splits them.
// - dq: delta = rowsum(dO * O) (written for the dkv kernel), then over all
//   keys S = q k^T, P = exp(S scale - lse), dP = dO v^T, dS = P (dP - delta),
//   dQ = scale dS k.
// - dkv: over all queries, from the key side: S^T = k q^T, dP^T = v dO^T,
//   dV = P^T dO, dK = scale dS^T q.
// Each output element is written by one lane of one block: no atomics, and
// the result is the same bits from run to run.
//
// Bound: operations. Each backward kernel needs two gradient products,
// 4 N^2 hd flops per sequence-head, against six token tensors of bytes: at
// row 6 of YOLOv13-s at training batch 16 (BB 64, H 4, N 400) that is
// 5.2 GFLOP and 79 MB. On the CUDA cores (67 TFLOP/s fp32) 78 us; on the
// tensor cores at float32 accuracy (3 TF32 passes at 495 TFLOP/s) 32 us;
// the bytes 24 us at 3.35 TB/s. The designs recompute S (and dP) in both
// kernels: 6 (dq) and 8 (dkv) N^2 hd flops issued.
//
// Backward design: the products run on the tensor cores, mma.sync m16n8k8
// with TF32 operands, each in three passes (3xTF32, as CUTLASS's
// OpMultiplyAddFastF32): A B = A_small B_big + A_big B_small + A_big B_big,
// X_big = tf32(X), X_small = tf32(X - X_big), summed in float32 accumulators.
// One TF32 pass misses the 1e-4 bar on the gradients (about 7e-4 of the
// largest at these shapes); three passes keep the error near float32's
// (PERF.md gives both against float64) and still outrun the CUDA cores. The
// exp and the softmax algebra stay in float32 on the CUDA cores (ex2.approx,
// log2(e) folded into the scale; lse is natural log at the interface).
// - A block has 4 warps and owns 64 rows of one sequence-head: queries (dq)
//   or keys (dkv); a warp owns 16 of them, the mma's M. The warp keeps its
//   own two operands in registers as A fragments, split once: q and dO (dq),
//   k and v (dkv). So dkv computes S^T and dP^T directly, and their
//   accumulators P^T and dS^T are the A operands of dV and dK.
// - An accumulator becomes the next A operand in its lane: the lane holds
//   columns 2t, 2t + 1 of an n8 tile, which A wants at k positions t, t + 4,
//   so the next product's B rows are read in that order (the sum over k does
//   not care). The 16 rows x 16 streamed rows of one inner step stay in
//   registers.
// - The long sums (dQ over all keys, dK and dV over all queries) are not
//   left to the tensor cores: each step's contribution (6 mma) goes to a
//   fresh accumulator, which is then added to the running float32 sum. The
//   tensor cores' own float32 accumulation loses low bits, and ~150 mma into
//   one accumulator read several times float32's error (PERF.md).
// - The other operands stream through shared memory in 64-row tiles: k and v
//   (dq); q, dO, lse and delta (dkv). cp.async copies the next tile into a
//   raw staging tile while the warps run the current one; each tile is then
//   split into big and small parts once per block, not once per warp, so the
//   warps only load fragments. Split rows are 36 words apart, which makes
//   both fragment reads conflict-free: B of S = X Y^T (lane reads row g,
//   column t: bank 4 g + t) and B of dQ = dS K (row 2t, column g: bank
//   8 t + g).
// - Masking: keys (dq) or queries (dkv) past N get P = 0 and read k, v, q,
//   dO, lse and delta as 0; rows past N are not written.
// Budget per block of 128 threads (ptxas -v, sm_90a): dq 156 registers,
// dkv 217, no spills, so 3 and 2 blocks per SM. Shared memory (dynamic: over
// the 48 KB of static) two split tiles of 2 x 64 x 36 x 4 B and two raw tiles
// of 8 KB, 53,248 B (dkv 53,760 with lse and delta).
// Per warp and 16-row step the dq kernel issues 72 mma (three products,
// three passes, 8 each), the dkv kernel 96.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 32;      // head dim: A2C2f's heads are c_ / 32 wide
constexpr int V4 = HD / 4;  // float4s per row
constexpr int ROWS = 64;    // rows a block owns (the forward's threads per block)
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

// ------------------------------------------------------------------ backward
//
// Tensor-core helpers for the two backward kernels. Fragment layouts are
// those of mma.sync.m16n8k8 with TF32 operands; lane = 4 g + t.
//   A (16 x 8, row):   a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):    b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):        c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

constexpr int BWD_THREADS = 128;  // 4 warps
constexpr int WARP_ROWS = 16;     // rows of the block's own operand per warp (the mma's M)
constexpr int STEP = 16;          // rows of the streamed operand per inner step (two n8 tiles)
constexpr int PAD = 36;           // words per shared tile row: both B patterns conflict-free
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BWD_THREADS / 32 * WARP_ROWS == ROWS, "a block's warps cover its rows");
static_assert(BWD_THREADS * 4 * 4 == TILE * HD, "a tile is 4 float4 per thread");

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds; the low 13 bits are 0, so the bits are a float too.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 2^x on the special-function unit (ex2.approx.ftz: 2 ulp; 0 below 2^-126).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The 3xTF32 split: x = big + small + O(2^-22 |x|) (x - big is exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass `pass` of d += A B in three TF32 passes, small-by-big terms first:
// 0: A_small B_big, 1: A_big B_small, 2: A_big B_big. b = {b0, b1} big, then
// small. Callers run pass 0 of several independent products, then pass 1,
// then pass 2, so that back-to-back mma are independent.
__device__ __forceinline__ void mma_pass(float (&d)[4], const FragA& a, const uint32_t (&b)[4],
                                         int pass) {
  if (pass == 0) {
    mma_tf32(d, a.small, b[0], b[1]);
  } else if (pass == 1) {
    mma_tf32(d, a.big, b[2], b[3]);
  } else {
    mma_tf32(d, a.big, b[0], b[1]);
  }
}

// A tile of TILE rows x HD of the streamed operand, every element split once
// into its big and small TF32 parts.
struct SplitTile {
  uint32_t big[TILE][PAD];
  uint32_t small[TILE][PAD];
};

// The same tile as it arrives, before the split.
typedef float4 RawTile[TILE][HD / 4];

// 16 bytes from global to shared memory, not through registers; zeros
// (src not read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [t0, t0 + TILE) of x into raw. A thread's share is
// float4 column threadIdx.x % 8 of rows threadIdx.x / 8 + 16 i; rows past N
// are 0.
__device__ __forceinline__ void fetch_tile(RawTile& raw, const float* __restrict__ x,
                                           const Strides& s, long long b, long long h, int t0,
                                           int N) {
  const int c = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = threadIdx.x / 8 + 16 * i, n = t0 + row;
    cp_async16(&raw[row][c], n < N ? row_ptr(x, s, b, n, h) + 4 * c : x, n < N);
  }
}

// The thread's own share of raw (no barrier needed after cp_async_wait_all),
// split, into dst.
__device__ __forceinline__ void store_split(SplitTile& dst, const RawTile& raw) {
  const int c = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = threadIdx.x / 8 + 16 * i;
    const float4 v = raw[row][c];
    uint4 big, small;
    split_tf32(v.x, big.x, small.x);
    split_tf32(v.y, big.y, small.y);
    split_tf32(v.z, big.z, small.z);
    split_tf32(v.w, big.w, small.w);
    *reinterpret_cast<uint4*>(&dst.big[row][4 * c]) = big;
    *reinterpret_cast<uint4*>(&dst.small[row][4 * c]) = small;
  }
}

// Dynamic shared memory of the two kernels (over the 48 KB of static).
struct DqShared {
  SplitTile k, v;
  RawTile raw_k, raw_v;
};
struct DkvShared {
  SplitTile q, d;
  RawTile raw_q, raw_d;
  float lse[TILE];    // lse * log2(e) of the tile's queries
  float delta[TILE];  // their delta
};

// A fragments, one per 8 head dims, of rows w0 .. w0 + 15 of x (the
// warp's own rows, kept in registers); rows past N are 0.
__device__ __forceinline__ void frag_a_rows(FragA (&a)[HD / 8], const float* __restrict__ x,
                                            const Strides& s, long long b, long long h, int w0,
                                            int N, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = w0 + g + 8 * r;
    const float* p = n < N ? row_ptr(x, s, b, n, h) : nullptr;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float lo = p ? __ldg(p + 8 * kk + t) : 0.f;
      const float hi = p ? __ldg(p + 8 * kk + t + 4) : 0.f;
      split_tf32(lo, a[kk].big[r], a[kk].small[r]);
      split_tf32(hi, a[kk].big[2 + r], a[kk].small[2 + r]);
    }
  }
}

// B = (rows r0 .. r0 + 7 of the tile)^T over columns c0 .. c0 + 7: k runs
// over the head dim, n over the rows (S = X Y^T). Lanes read banks 4 g + t.
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4], const SplitTile& tile, int r0,
                                            int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  b[0] = tile.big[r0 + g][c0 + t];
  b[1] = tile.big[r0 + g][c0 + t + 4];
  b[2] = tile.small[r0 + g][c0 + t];
  b[3] = tile.small[r0 + g][c0 + t + 4];
}

// B = rows r0 .. r0 + 7 of the tile over columns c0 .. c0 + 7, k running
// over the rows in the order that frag_a_acc gives A: k position t is row
// r0 + 2t and t + 4 is r0 + 2t + 1. Lanes read banks 8 t + g (+ 4).
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], const SplitTile& tile, int r0,
                                            int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  b[0] = tile.big[r0 + 2 * t][c0 + g];
  b[1] = tile.big[r0 + 2 * t + 1][c0 + g];
  b[2] = tile.small[r0 + 2 * t][c0 + g];
  b[3] = tile.small[r0 + 2 * t + 1][c0 + g];
}

// An m16n8 accumulator as the A operand of the next product, whose k runs
// over the accumulator's 8 columns: the lane holds columns 2t and 2t + 1,
// taken as k positions t and t + 4 (frag_b_cols reads B in that order), so
// no value leaves its lane.
__device__ __forceinline__ void frag_a_acc(FragA& a, const float (&c)[4]) {
  split_tf32(c[0], a.big[0], a.small[0]);
  split_tf32(c[2], a.big[1], a.small[1]);
  split_tf32(c[1], a.big[2], a.small[2]);
  split_tf32(c[3], a.big[3], a.small[3]);
}

// Rows g + 8 r of an m16 x HD accumulator (columns 8 nd + 2t, + 1), times
// scale, to the contiguous (BB, N, H, HD) tensor out; rows past N are not written.
__device__ __forceinline__ void store_acc(float* __restrict__ out, const float (&acc)[HD / 8][4],
                                          float scale, long long b, long long h, int w0, int N,
                                          int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = w0 + g + 8 * r;
    if (n >= N) continue;
    float* p = out + ((b * N + n) * H + h) * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      *reinterpret_cast<float2*>(p + 8 * nd) =
          make_float2(acc[nd][2 * r] * scale, acc[nd][2 * r + 1] * scale);
    }
  }
}

// grid (BB * H, ceil(N / ROWS)), BWD_THREADS threads; a warp owns 16 query rows
__global__ void __launch_bounds__(BWD_THREADS)
    attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
                            const float* __restrict__ o, const float* __restrict__ lse,
                            const float* __restrict__ dout, float* __restrict__ dq,
                            float* __restrict__ delta, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char shared[];
  DqShared& sh = *reinterpret_cast<DqShared*>(shared);
  SplitTile &Kt = sh.k, &Vt = sh.v;
  const Strides os = {(long long)N * H * HD, (long long)H * HD, HD};
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.y * ROWS + threadIdx.x / 32 * WARP_ROWS;
  const bool active = w0 < N;  // the warp has a query row
  fetch_tile(sh.raw_k, k, ks, b, h, 0, N);
  fetch_tile(sh.raw_v, v, vs, b, h, 0, N);
  cp_async_commit();

  FragA qa[HD / 8], da[HD / 8];
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // rows g, g + 8; 0 past N
  if (active) {
    frag_a_rows(qa, q, qs, b, h, w0, N, lane);
    frag_a_rows(da, dout, os, b, h, w0, N, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // delta = rowsum(dO * O): the lane's 8 of the row's 32 products, then
      // the sum over the 4 lanes of the row
      const int n = w0 + g + 8 * r;
      float part = 0.f;
      if (n < N) {
        const float* po = o + ((b * N + n) * H + h) * HD + t;
        const float* pd = dout + ((b * N + n) * H + h) * HD + t;
#pragma unroll
        for (int m = 0; m < HD / 4; ++m) part = fmaf(__ldg(pd + 4 * m), __ldg(po + 4 * m), part);
        lse2[r] = lse[seq * N + n] * LOG2E;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dl[r] = part;
      if (t == 0 && n < N) delta[seq * N + n] = part;
    }
  }

  const float c = scale * LOG2E;
  float acc[HD / 8][4] = {};  // dQ / scale, summed step by step in float32
  for (int t0 = 0; t0 < N; t0 += TILE) {
    cp_async_wait_all();
    __syncthreads();  // the last tile's readers are done
    store_split(Kt, sh.raw_k);
    store_split(Vt, sh.raw_v);
    __syncthreads();
    if (t0 + TILE < N) {  // the next tile's copies fly during this tile's products
      fetch_tile(sh.raw_k, k, ks, b, h, t0 + TILE, N);
      fetch_tile(sh.raw_v, v, vs, b, h, t0 + TILE, N);
      cp_async_commit();
    }
    if (!active) continue;
    const int nk = min(TILE, N - t0);
    for (int j0 = 0; j0 < nk; j0 += STEP) {
      float s[STEP / 8][4] = {}, dp[STEP / 8][4] = {};  // S = Q K^T, dP = dO V^T: 16 keys
      float part[HD / 8][4] = {};                       // this step's dS K
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t bk[STEP / 8][4], bv[STEP / 8][4];
#pragma unroll
        for (int nt = 0; nt < STEP / 8; ++nt) {
          frag_b_rows(bk[nt], Kt, j0 + 8 * nt, 8 * kk, lane);
          frag_b_rows(bv[nt], Vt, j0 + 8 * nt, 8 * kk, lane);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
          for (int nt = 0; nt < STEP / 8; ++nt) {
            mma_pass(s[nt], qa[kk], bk[nt], pass);
            mma_pass(dp[nt], da[kk], bv[nt], pass);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < STEP / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // dS = P (dP - delta); keys past N have P = 0
          const int key = t0 + j0 + 8 * nt + 2 * t + (e & 1);
          const float p = key < N ? exp2_approx(fmaf(s[nt][e], c, -lse2[e >> 1])) : 0.f;
          s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
        }
        FragA ds;
        frag_a_acc(ds, s[nt]);
        uint32_t bk[HD / 8][4];
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) frag_b_cols(bk[nd], Kt, j0 + 8 * nt, 8 * nd, lane);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
          for (int nd = 0; nd < HD / 8; ++nd) mma_pass(part[nd], ds, bk[nd], pass);  // dQ += dS K
        }
      }
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
      }
    }
  }
  if (active) store_acc(dq, acc, scale, b, h, w0, N, H, lane);
}

// grid (BB * H, ceil(N / ROWS)), BWD_THREADS threads; a warp owns 16 key
// rows; reads the delta of the dq kernel
__global__ void __launch_bounds__(BWD_THREADS)
    attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
                             const float* __restrict__ lse, const float* __restrict__ dout,
                             const float* __restrict__ delta, float* __restrict__ dk,
                             float* __restrict__ dv, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char shared[];
  DkvShared& sh = *reinterpret_cast<DkvShared*>(shared);
  SplitTile &Qt = sh.q, &Dt = sh.d;
  float *Ls = sh.lse, *Es = sh.delta;
  const Strides os = {(long long)N * H * HD, (long long)H * HD, HD};
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int w0 = blockIdx.y * ROWS + threadIdx.x / 32 * WARP_ROWS;
  const bool active = w0 < N;  // the warp has a key row
  float lr = 0.f, er = 0.f;  // queries past N read lse = delta = 0
  fetch_tile(sh.raw_q, q, qs, b, h, 0, N);
  fetch_tile(sh.raw_d, dout, os, b, h, 0, N);
  cp_async_commit();
  if (threadIdx.x < TILE && (int)threadIdx.x < N) {
    lr = lse[seq * N + threadIdx.x] * LOG2E;
    er = delta[seq * N + threadIdx.x];
  }

  FragA ka[HD / 8], va[HD / 8];
  if (active) {
    frag_a_rows(ka, k, ks, b, h, w0, N, lane);
    frag_a_rows(va, v, vs, b, h, w0, N, lane);
  }

  const float c = scale * LOG2E;
  float dka[HD / 8][4] = {}, dva[HD / 8][4] = {};  // dK / scale, dV, summed in float32
  for (int t0 = 0; t0 < N; t0 += TILE) {
    cp_async_wait_all();
    __syncthreads();
    store_split(Qt, sh.raw_q);
    store_split(Dt, sh.raw_d);
    if (threadIdx.x < TILE) {
      Ls[threadIdx.x] = lr;
      Es[threadIdx.x] = er;
    }
    __syncthreads();
    const int t1 = t0 + TILE;
    if (t1 < N) {
      fetch_tile(sh.raw_q, q, qs, b, h, t1, N);
      fetch_tile(sh.raw_d, dout, os, b, h, t1, N);
      cp_async_commit();
      const bool real = threadIdx.x < TILE && t1 + (int)threadIdx.x < N;
      lr = real ? lse[seq * N + t1 + threadIdx.x] * LOG2E : 0.f;
      er = real ? delta[seq * N + t1 + threadIdx.x] : 0.f;
    }
    if (!active) continue;
    const int nq = min(TILE, N - t0);
    for (int j0 = 0; j0 < nq; j0 += STEP) {
      // S^T = K Q^T and dP^T = V dO^T over 16 queries
      float st[STEP / 8][4] = {}, dpt[STEP / 8][4] = {};
      float pv[HD / 8][4] = {}, pk[HD / 8][4] = {};  // this step's P^T dO, dS^T Q
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t bq[STEP / 8][4], bd[STEP / 8][4];
#pragma unroll
        for (int nt = 0; nt < STEP / 8; ++nt) {
          frag_b_rows(bq[nt], Qt, j0 + 8 * nt, 8 * kk, lane);
          frag_b_rows(bd[nt], Dt, j0 + 8 * nt, 8 * kk, lane);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
          for (int nt = 0; nt < STEP / 8; ++nt) {
            mma_pass(st[nt], ka[kk], bq[nt], pass);
            mma_pass(dpt[nt], va[kk], bd[nt], pass);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < STEP / 8; ++nt) {
        const int i0 = j0 + 8 * nt + 2 * t;  // the lane's queries i0, i0 + 1 in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(&Ls[i0]);
        const float2 d2 = *reinterpret_cast<const float2*>(&Es[i0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // P^T and dS^T = P^T (dP^T - delta); P = 0 past N
          const float li = e & 1 ? l2.y : l2.x, di = e & 1 ? d2.y : d2.x;
          const float p = t0 + i0 + (e & 1) < N ? exp2_approx(fmaf(st[nt][e], c, -li)) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - di);
        }
        FragA pa, dsa;
        frag_a_acc(pa, st[nt]);
        frag_a_acc(dsa, dpt[nt]);
#pragma unroll
        for (int n2 = 0; n2 < HD / 8; n2 += 2) {  // dV += P^T dO, dK += dS^T Q, 16 dims
          uint32_t bd[2][4], bq[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            frag_b_cols(bd[u], Dt, j0 + 8 * nt, 8 * (n2 + u), lane);
            frag_b_cols(bq[u], Qt, j0 + 8 * nt, 8 * (n2 + u), lane);
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              mma_pass(pv[n2 + u], pa, bd[u], pass);
              mma_pass(pk[n2 + u], dsa, bq[u], pass);
            }
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[nd][e] += pv[nd][e];
          dka[nd][e] += pk[nd][e];
        }
    }
  }
  if (!active) return;
  store_acc(dk, dka, scale, b, h, w0, N, H, lane);
  store_acc(dv, dva, 1.f, b, h, w0, N, H, lane);
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
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sizeof(DqShared));
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<<<grid, BWD_THREADS, sizeof(DqShared),
                            static_cast<cudaStream_t>(stream)>>>(
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
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(DkvShared));
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<<<grid, BWD_THREADS, sizeof(DkvShared),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), N, H,
      scale);
  return (int)cudaGetLastError();
}
