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
// Layout: q, k and v are (BB, N, H, 32) with the head dim contiguous and any
// 16-byte aligned strides on BB, N and H, so AAttn passes the three views of
// its (BB, N, H, 3 x 32) qkv tensor (each head holds [q_h | k_h | v_h])
// without copies. o, do, dq, dk and dv are contiguous (BB, N, H, 32); lse
// (natural log, of the scaled scores) and delta are contiguous (BB, H, N).
//
// Types: q, k, v, o, do, dq, dk and dv are all float32 (the *_f32 entry
// points) or all bfloat16 (*_bf16); lse and delta are float32 in both. A
// bfloat16 run computes in float32 inside, as the JAX flash path casts q, k
// and v to float32 and its output back (yolo_dbl_tpu/nn/blocks.py:876,885):
// the softmax runs in float32 and each output is rounded to bfloat16 once.
// The bfloat16 dq and dkv kernels form their products to float32 accuracy;
// the bfloat16 forward keeps P's leading 16 bits in P V (within 2^-16 of
// each P), so its O is within about 2^-16 of v's largest of the float32
// one: far inside the one bfloat16 step its output is held to. The
// bfloat16 kernels are a design of their own (attention_fwd_kernel_bf16,
// attention_bwd_dq_kernel_bf16 and attention_bwd_dkv_kernel_bf16, after
// the float32 kernels); the float32 kernels are one template, built for
// float32 only. The backward's delta = rowsum(dO * O) takes O in float32,
// as JAX's flash backward gets its float32 output as residual: a bfloat16
// forward run for training also writes its O before the rounding to
// bfloat16 (o32, with the forward's accuracy above; the dq and dkv
// emulations in tests/test_torch_attention_split.py take lse and delta
// from it), and the dq kernel reads o in float32 in both types.
//
// Forward (attention_fwd_kernel): over all keys, S = q k^T, an online
// softmax (running row max m and row sum l) and O += P v; it writes
// o = O / l and the row's log-sum-exp for the backward.
// Backward: the dq kernel, then the dkv kernel, as Pallas splits them.
// - dq: delta = rowsum(dO * O) (written for the dkv kernel), then over all
//   keys S = q k^T, P = exp(S scale - lse), dP = dO v^T, dS = P (dP - delta),
//   dQ = scale dS k.
// - dkv: over all queries, from the key side: S^T = k q^T, dP^T = v dO^T,
//   dV = P^T dO, dK = scale dS^T q.
// Each output element is written by one lane of one block: no atomics, and
// the result is the same bits from run to run.
//
// Bound: operations. Each kernel needs two products, 4 N^2 hd flops per
// sequence-head. The forward reads q, k, v and writes o and lse: at row 6 of
// YOLOv13-s at serving batch 8 (BB 32, H 4, N 400) 2.6 GFLOP and 26 MB, so
// 39 us on the CUDA cores (67 TFLOP/s fp32), 16 us on the tensor cores at
// float32 accuracy (3 TF32 passes at 495 TFLOP/s), 8 us for the bytes at
// 3.35 TB/s. A backward kernel moves six token tensors: at row 6 at training
// batch 16 (BB 64) 5.2 GFLOP and 79 MB, 78 us on the CUDA cores, 32 us on
// the tensor cores, 24 us for the bytes. The backward designs recompute S
// (and dP) in both kernels: 6 (dq) and 8 (dkv) N^2 hd flops issued.
//
// Design, all three kernels: the products run on the tensor cores,
// mma.sync m16n8k8 with TF32 operands, each in three passes (3xTF32, as
// CUTLASS's OpMultiplyAddFastF32): A B = A_small B_big + A_big B_small +
// A_big B_big, X_big = tf32(X), X_small = tf32(X - X_big), summed in float32
// accumulators. One TF32 pass misses the bars (the forward's 1e-5 on o and
// lse by about 3e-4; the gradients' 1e-4 of the largest by about 7e-4);
// three passes keep the error near float32's (PERF.md gives both against
// float64) and still outrun the CUDA cores. The exp and the softmax algebra
// stay in float32 on the CUDA cores (ex2.approx, log2(e) folded into the
// scale, applied to S after the product; lse is natural log at the
// interface).
// - A block has 4 warps and owns 64 rows of one sequence-head: queries
//   (forward, dq) or keys (dkv); a warp owns 16 of them, the mma's M. The
//   warp keeps its own operands in registers as A fragments, split once: q
//   (forward), q and dO (dq), k and v (dkv). So dkv computes S^T and dP^T
//   directly, and their accumulators P^T and dS^T are the A operands of dV
//   and dK.
// - An accumulator becomes the next A operand in its lane: the lane holds
//   columns 2t, 2t + 1 of an n8 tile, which A wants at k positions t, t + 4,
//   so the next product's B rows are read in that order (the sum over k does
//   not care). The 16 rows x 16 streamed rows of one inner step stay in
//   registers: P (forward), dS (dq), P^T and dS^T (dkv).
// - The long sums (O and dQ over all keys, dK and dV over all queries) are
//   not left to the tensor cores: each step's contribution goes to a fresh
//   accumulator, which is then added to the running float32 sum (in the
//   forward, after the running sum is rescaled to the new row max). The
//   tensor cores' own float32 accumulation loses low bits, and ~150 mma into
//   one accumulator read several times float32's error (PERF.md).
// - The forward's softmax runs in registers in the log2 domain: per 16-key
//   step, the row max of S scale log2(e) over the 4 lanes that hold a row
//   (two shuffles), the running sums rescaled by 2^(m_old - m_new), then
//   P = 2^(S scale log2(e) - m); each lane keeps a partial row sum, and the
//   4 parts meet once, at the end. lse = m ln 2 + log(l), with the accurate
//   logf.
// - The other operands stream through shared memory in 64-row tiles: k and v
//   (forward, dq); q, dO, lse and delta (dkv). cp.async copies the next tile
//   into a raw staging tile while the warps run the current one; each tile
//   is then split into big and small parts once per block, not once per
//   warp, so the warps only load fragments. Split rows are 36 words apart,
//   which makes both fragment reads conflict-free: B of S = X Y^T (lane reads
//   row g, column t: bank 4 g + t) and B of O = P V or dQ = dS K (row 2t,
//   column g: bank 8 t + g).
// - Masking: keys (forward, dq) or queries (dkv) past N get P = 0 and read
//   k, v, q, dO, lse and delta as 0; rows past N are not written.
// - Blocks: BB H x ceil(N / 64). At row 8 of YOLOv13-s at serving batch 8
//   (BB 8, H 8) that is 448 blocks, 3.4 per SM, all resident at once (up to
//   4 a SM by shared memory); 32-row blocks would double the blocks but not
//   the warps in flight, since each block still holds two 64-row tiles.
// Budget per block of 128 threads (ptxas -v, sm_90a): forward 126
// registers, dq 156, dkv 217, no spills, so 4, 3 and 2 blocks per SM.
// Shared memory (dynamic: over the 48 KB of static) two split tiles of
// 2 x 64 x 36 x 4 B and two raw tiles of 8 KB, 53,248 B (forward and dq;
// dkv 53,760 with lse and delta).
// Per warp and 16-row step the forward issues 48 mma (two products, three
// passes, 8 each), the dq kernel 72 (three products), the dkv kernel 96.
//
// The bfloat16 kernels (PERF.md has their times and knock-outs, from
// tools/exp_k3_bf16_designs.py). They issue 16 (forward), 20 (dq) and 32
// (dkv) bf16 mma per warp and 16 x 16 scores, against 24, 32 and 48 TF32
// mma of half the depth in the float32 template that ran them in bfloat16
// before (converting on load, the TF32 passes that add exact zeros
// skipped), and cut the work around each score.
// - Tiles reach shared memory as they are, in bfloat16, by 16-byte
//   cp.async into a ring of two stages of 80 rows (as many as a block
//   owns, two chunks a thread): one barrier a tile, no conversion pass.
//   Rows are 80 B apart, which keeps every ldmatrix phase (8 rows of 16 B)
//   off shared bank conflicts.
// - Products run on mma.sync m16n8k16 with bfloat16 operands and float32
//   accumulators. The warp's own 16 rows (q; q and dO; k and v) sit in
//   registers as bfloat16 A fragments, 8 registers for 16 x 32, loaded
//   once. B fragments come by ldmatrix.x4, 16 x 16 of a tile each: plain
//   for S = q kT (forward, dq), dP = dO vT (dq), S^T = k qT and
//   dP^T = v dOT (dkv), .trans for P v, dS k, P^T dO and dS^T q, whose k
//   runs over the tile's rows.
// - A product of two bfloat16 inputs is exact in float32, one pass. A
//   float32 P or dS times an input is split into bfloat16 terms, one pass a
//   term (split_bf16x2: leading 8 bits by truncation, PRMT for two values,
//   the last term rounded): the forward splits P in 2 terms (within 2^-16
//   of each P), dq dS and dkv P and dS in 3 (exact): the fewest that meet
//   the bars (tests/test_torch_attention_split.py emulates the three; 2
//   terms miss dq's and dkv's by under 1e-6 near 0). Two n8 accumulator
//   tiles are, lane for lane, the next product's A fragment.
// - Each 16-row step's products go to a fresh accumulator, added to the
//   float32 sum, as in the float32 kernels.
// - The forward takes one softmax step a tile: S for all 80 keys, one row
//   max (two shuffles) and one rescale, then P V chunk by chunk. scale
//   log2(e) is folded into the FFMA before ex2.approx; the row max is
//   taken on the raw scores and scaled once.
// - The dq kernel is dkv's design seen from the query side: k and v
//   stream through the forward's ring, q and dO are the warp's fragments,
//   and delta comes from o32 and dO as in the float32 kernel.
// - A block has 5 warps (80 rows: N = 400 is 5 blocks, no warp idle), and
//   the inner loops over a tile's 16-row chunks are unrolled.
// Budget (ptxas -v, sm_90a, 160 threads): forward 96 registers (capped
// for 4 blocks an SM), dq 92 (capped for 4), dkv 128 (3 blocks), no
// spills; dynamic shared memory 25,600 B (forward, dq) and 26,880 B (dkv,
// with lse and delta).
// What binds them (the knock-outs, PERF.md): not the exponentials (taking
// them out saves 0-2%); the products of P or dS with a tile take 26% of
// the forward and of dq and half of dkv, where each bf16 mma a chunk costs
// about as much as the tensor-core issue of mma.sync allows: wgmma is the
// next step. The rest, about 0.26 ms a training step in dq and in dkv
// alike (S and dP, the tiles, the fragments), is common to both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 32;  // head dim: A2C2f's heads are c_ / 32 wide

struct Strides {
  long long b, n, h;  // in elements; the head dim has stride 1
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, const Strides& s, long long b,
                                            long long n, long long h) {
  return base + b * s.b + n * s.n + h * s.h;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------ tensor cores
//
// Helpers of the three kernels. Fragment layouts are those of
// mma.sync.m16n8k8 with TF32 operands; lane = 4 g + t.
//   A (16 x 8, row):   a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):    b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):        c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = 64;      // rows of its own operand a block owns
constexpr int TILE = 64;      // rows of the streamed operand per shared-memory tile
constexpr int WARP_ROWS = 16; // rows of the block's own operand per warp (the mma's M)
constexpr int STEP = 16;      // rows of the streamed operand per inner step (two n8 tiles)
constexpr int PAD = 36;       // words per shared tile row: both B patterns conflict-free
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(THREADS / 32 * WARP_ROWS == ROWS, "a block's warps cover its rows");
static_assert(THREADS * 4 * 4 == TILE * HD, "a tile is 4 float4 per thread");

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

// Whether a product needs pass `pass`. A bfloat16 input is exact in TF32
// (its small part is 0), so with bfloat16 inputs a product of two inputs
// (q kT, dO vT, ...) needs only A_big B_big, and one of a float32 A (P, dS)
// and an input B skips A_big B_small: the skipped passes would add exact
// zeros. Every product's B is an input, so a bfloat16 run never reads the
// small parts of a tile.
template <typename T>
__device__ __forceinline__ constexpr bool inputs_need(int pass) {
  return sizeof(T) == 4 || pass == 2;
}
template <typename T>
__device__ __forceinline__ constexpr bool acc_input_needs(int pass) {
  return sizeof(T) == 4 || pass != 1;
}

// A tile of TILE rows x HD of the streamed operand, every element split once
// into its big and small TF32 parts.
struct SplitTile {
  uint32_t big[TILE][PAD];
  uint32_t small[TILE][PAD];
};

// The same tile as it arrives, before the split: TILE rows of HD values of
// the input type, CHUNKS<T> 16-byte chunks a row (float32 uses all of it).
typedef float4 RawTile[TILE][HD / 4];
template <typename T>
constexpr int CHUNKS = HD * (int)sizeof(T) / 16;

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
// 16-byte chunk threadIdx.x % CHUNKS of rows threadIdx.x / CHUNKS + (THREADS
// / CHUNKS) i; rows past N are 0.
template <typename T>
__device__ __forceinline__ void fetch_tile(RawTile& raw, const T* __restrict__ x,
                                           const Strides& s, long long b, long long h, int t0,
                                           int N) {
  constexpr int C = CHUNKS<T>, VALS = 16 / sizeof(T);
  uint4(&chunks)[TILE][C] = *reinterpret_cast<uint4(*)[TILE][C]>(&raw);
  const int c = threadIdx.x % C;
#pragma unroll
  for (int i = 0; i < TILE * C / THREADS; ++i) {
    const int row = threadIdx.x / C + THREADS / C * i, n = t0 + row;
    cp_async16(&chunks[row][c], n < N ? row_ptr(x, s, b, n, h) + VALS * c : x, n < N);
  }
}

// 4 values of the input type as float32.
__device__ __forceinline__ float4 unpack4(const float4& v) { return v; }
__device__ __forceinline__ float4 unpack4(const uint2& v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The thread's own share of raw (no barrier needed after cp_async_wait_all),
// converted to float32 and split, into dst.
template <typename T>
__device__ __forceinline__ void store_split(SplitTile& dst, const RawTile& raw) {
  constexpr int C = CHUNKS<T>, VALS = 16 / sizeof(T);
  typedef typename std::conditional<sizeof(T) == 4, float4, uint2>::type Quad;
  const Quad(&quads)[TILE][HD / 4] = *reinterpret_cast<const Quad(*)[TILE][HD / 4]>(&raw);
  const int c = threadIdx.x % C;
#pragma unroll
  for (int i = 0; i < TILE * C / THREADS; ++i) {
    const int row = threadIdx.x / C + THREADS / C * i;
#pragma unroll
    for (int j = 0; j < VALS / 4; ++j) {
      const int col = VALS * c + 4 * j;  // the quad's first head dim
      const float4 v = unpack4(quads[row][col / 4]);
      uint4 big, small;
      split_tf32(v.x, big.x, small.x);
      split_tf32(v.y, big.y, small.y);
      split_tf32(v.z, big.z, small.z);
      split_tf32(v.w, big.w, small.w);
      *reinterpret_cast<uint4*>(&dst.big[row][col]) = big;
      if constexpr (sizeof(T) == 4) *reinterpret_cast<uint4*>(&dst.small[row][col]) = small;
    }
  }
}

// Dynamic shared memory of the kernels (over the 48 KB of static): the k and
// v tiles of the forward and the dq kernel; q, dO, lse and delta of dkv.
struct KvShared {
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
template <typename T>
__device__ __forceinline__ void frag_a_rows(FragA (&a)[HD / 8], const T* __restrict__ x,
                                            const Strides& s, long long b, long long h, int w0,
                                            int N, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = w0 + g + 8 * r;
    const T* p = n < N ? row_ptr(x, s, b, n, h) : nullptr;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float lo = p ? to_float(__ldg(p + 8 * kk + t)) : 0.f;
      const float hi = p ? to_float(__ldg(p + 8 * kk + t + 4)) : 0.f;
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

// Two values to p in the output type, each rounded once.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows g + 8 r of an m16 x HD accumulator (columns 8 nd + 2t, + 1), times
// scale, to the contiguous (BB, N, H, HD) tensor out; rows past N are not written.
template <typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ out, const float (&acc)[HD / 8][4],
                                          float scale, long long b, long long h, int w0, int N,
                                          int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = w0 + g + 8 * r;
    if (n >= N) continue;
    T* p = out + ((b * N + n) * H + h) * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      store2(p + 8 * nd, acc[nd][2 * r] * scale, acc[nd][2 * r + 1] * scale);
    }
  }
}

// grid (BB * H, ceil(N / ROWS)), THREADS threads; a warp owns 16 query rows
template <typename T>
__global__ void __launch_bounds__(THREADS)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, Strides qs, Strides ks, Strides vs,
                         T* __restrict__ o, float* __restrict__ o32, float* __restrict__ lse,
                         int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char shared[];
  KvShared& sh = *reinterpret_cast<KvShared*>(shared);
  SplitTile &Kt = sh.k, &Vt = sh.v;
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.y * ROWS + threadIdx.x / 32 * WARP_ROWS;
  const bool active = w0 < N;  // the warp has a query row
  fetch_tile(sh.raw_k, k, ks, b, h, 0, N);
  fetch_tile(sh.raw_v, v, vs, b, h, 0, N);
  cp_async_commit();

  FragA qa[HD / 8];
  if (active) frag_a_rows(qa, q, qs, b, h, w0, N, lane);

  const float c = scale * LOG2E;
  float acc[HD / 8][4] = {};           // O at the running max, summed step by step in float32
  float m[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: running max of S c
  float l[2] = {0.f, 0.f};              // the lane's part of their running sums
  for (int t0 = 0; t0 < N; t0 += TILE) {
    cp_async_wait_all();
    __syncthreads();  // the last tile's readers are done
    store_split<T>(Kt, sh.raw_k);
    store_split<T>(Vt, sh.raw_v);
    __syncthreads();
    if (t0 + TILE < N) {  // the next tile's copies fly during this tile's products
      fetch_tile(sh.raw_k, k, ks, b, h, t0 + TILE, N);
      fetch_tile(sh.raw_v, v, vs, b, h, t0 + TILE, N);
      cp_async_commit();
    }
    if (!active) continue;
    const int nk = min(TILE, N - t0);
    for (int j0 = 0; j0 < nk; j0 += STEP) {
      // S = Q K^T over 16 keys, the even and odd k8 slices in two accumulators
      // so that more of the mma are independent
      float s2[2][STEP / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t bk[STEP / 8][4];
#pragma unroll
        for (int nt = 0; nt < STEP / 8; ++nt) frag_b_rows(bk[nt], Kt, j0 + 8 * nt, 8 * kk, lane);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          if (!inputs_need<T>(pass)) continue;
#pragma unroll
          for (int nt = 0; nt < STEP / 8; ++nt) mma_pass(s2[kk & 1][nt], qa[kk], bk[nt], pass);
        }
      }
      float s[STEP / 8][4], mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < STEP / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // keys past N get -inf, so P = 0
          const int key = t0 + j0 + 8 * nt + 2 * t + (e & 1);
          s[nt][e] = key < N ? (s2[0][nt][e] + s2[1][nt][e]) * c : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the row max over the row's 4 lanes; finite, since key t0 + j0 < N
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m[r] - mx[r]);  // 0 at the first step
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      float part[HD / 8][4] = {};  // this step's P V
#pragma unroll
      for (int nt = 0; nt < STEP / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2_approx(s[nt][e] - m[e >> 1]);
          l[e >> 1] += s[nt][e];
        }
        FragA pa;
        frag_a_acc(pa, s[nt]);
        uint32_t bv[HD / 8][4];
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) frag_b_cols(bv[nd], Vt, j0 + 8 * nt, 8 * nd, lane);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          if (!acc_input_needs<T>(pass)) continue;
#pragma unroll
          for (int nd = 0; nd < HD / 8; ++nd) mma_pass(part[nd], pa, bv[nd], pass);  // O += P V
        }
      }
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], alpha[e >> 1], part[nd][e]);
      }
    }
  }
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    const int n = w0 + g + 8 * r;
    if (t == 0 && n < N) lse[seq * N + n] = fmaf(m[r], LN2, logf(l[r]));
  }
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] *= inv[e >> 1];
  }
  store_acc(o, acc, 1.f, b, h, w0, N, H, lane);
  if (o32 != nullptr) store_acc(o32, acc, 1.f, b, h, w0, N, H, lane);
}

// The dq kernels' statistics of the lane's rows w0 + g and w0 + g + 8:
// lse2 = lse log2(e), and dl = delta = rowsum(dO * O) with O in float32,
// each lane forming 8 of the row's 32 products and the row's 4 lanes
// summing them; delta is also written for the dkv kernel. Rows past N
// read 0.
template <typename T>
__device__ __forceinline__ void dq_row_stats(float (&lse2)[2], float (&dl)[2],
                                             const float* __restrict__ o,
                                             const float* __restrict__ lse,
                                             const T* __restrict__ dout, float* __restrict__ delta,
                                             long long seq, long long b, long long h, int w0,
                                             int N, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = w0 + g + 8 * r;
    float part = 0.f;
    if (n < N) {
      const float* po = o + ((b * N + n) * H + h) * HD + t;
      const T* pd = dout + ((b * N + n) * H + h) * HD + t;
#pragma unroll
      for (int m = 0; m < HD / 4; ++m) {
        part = fmaf(to_float(__ldg(pd + 4 * m)), __ldg(po + 4 * m), part);
      }
      lse2[r] = lse[seq * N + n] * LOG2E;
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dl[r] = part;
    if (t == 0 && n < N) delta[seq * N + n] = part;
  }
}

// grid (BB * H, ceil(N / ROWS)), THREADS threads; a warp owns 16 query rows
template <typename T>
__global__ void __launch_bounds__(THREADS)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, Strides qs, Strides ks, Strides vs,
                            const float* __restrict__ o, const float* __restrict__ lse,
                            const T* __restrict__ dout, T* __restrict__ dq,
                            float* __restrict__ delta, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char shared[];
  KvShared& sh = *reinterpret_cast<KvShared*>(shared);
  SplitTile &Kt = sh.k, &Vt = sh.v;
  const Strides os = {(long long)N * H * HD, (long long)H * HD, HD};
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int lane = threadIdx.x % 32, t = lane & 3;
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
    dq_row_stats(lse2, dl, o, lse, dout, delta, seq, b, h, w0, N, H, lane);
  }

  const float c = scale * LOG2E;
  float acc[HD / 8][4] = {};  // dQ / scale, summed step by step in float32
  for (int t0 = 0; t0 < N; t0 += TILE) {
    cp_async_wait_all();
    __syncthreads();  // the last tile's readers are done
    store_split<T>(Kt, sh.raw_k);
    store_split<T>(Vt, sh.raw_v);
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
          if (!inputs_need<T>(pass)) continue;
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
          if (!acc_input_needs<T>(pass)) continue;
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

// grid (BB * H, ceil(N / ROWS)), THREADS threads; a warp owns 16 key
// rows; reads the delta of the dq kernel
template <typename T>
__global__ void __launch_bounds__(THREADS)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, Strides qs, Strides ks, Strides vs,
                             const float* __restrict__ lse, const T* __restrict__ dout,
                             const float* __restrict__ delta, T* __restrict__ dk,
                             T* __restrict__ dv, int N, int H, float scale) {
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
    store_split<T>(Qt, sh.raw_q);
    store_split<T>(Dt, sh.raw_d);
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
          if (!inputs_need<T>(pass)) continue;
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
            if (!acc_input_needs<T>(pass)) continue;
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

bool grid_for(int BB, int N, int H, dim3* grid, int rows = ROWS) {
  const long long seqs = (long long)BB * H;
  const long long tiles = (N + rows - 1) / rows;
  if (seqs > 0x7fffffffLL || tiles > 65535) return false;
  *grid = dim3((unsigned)seqs, (unsigned)tiles);
  return true;
}

// The launchers of the three kernels in the input type T.
template <typename T>
int forward(const void* q, const void* k, const void* v, Strides qs, Strides ks, Strides vs,
            void* o, void* o32, void* lse, int BB, int N, int H, float scale, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid)) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sizeof(KvShared));
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T><<<grid, THREADS, sizeof(KvShared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs,
      static_cast<T*>(o), static_cast<float*>(o32), static_cast<float*>(lse), N, H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dq(const void* q, const void* k, const void* v, Strides qs, Strides ks, Strides vs,
                const void* o, const void* lse, const void* dout, void* dq, void* delta, int BB,
                int N, int H, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid)) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(KvShared));
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<T><<<grid, THREADS, sizeof(KvShared),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs,
      static_cast<const float*>(o), static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(delta), N, H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dkv(const void* q, const void* k, const void* v, Strides qs, Strides ks, Strides vs,
                 const void* lse, const void* dout, const void* delta, void* dk, void* dv, int BB,
                 int N, int H, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid)) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(DkvShared));
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<T><<<grid, THREADS, sizeof(DkvShared),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qs, ks, vs,
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), N, H, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bfloat16 tensor cores
//
// The bfloat16 forward, dq and dkv kernels. Fragment layouts of
// mma.sync.m16n8k16 with bfloat16
// operands, two values a 32-bit register, the lower column or k index in
// the low half; lane = 4 g + t.
//   A (16 x 16, row):  a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                      a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):        c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// Two n8 accumulator tiles side by side are, lane for lane, the A fragment
// of a product whose k runs over their 16 columns: P and dS^T feed the next
// product with no shuffle and no reordering of B.

constexpr int BROW = 40;  // bfloat16 a shared tile row: 80 B, so the 8 rows of an ldmatrix phase
                          // fall in 8 distinct 16-byte bank groups
constexpr int STAGES = 2;  // shared tiles in the ring: one read while the next arrives
// The designs: warps a block (16 rows each; 5 x 16 = 80 divides N = 400),
// bfloat16 terms a float32 P or dS is split into, and the blocks an SM
// ptxas is told to fit (__launch_bounds__): 4 caps the forward and dq at
// 96 registers (20 warps an SM), 3 dkv at 136 (15 warps); left to itself
// ptxas takes 145 and 169 for the forward and dkv, 2 blocks an SM, and
// both run slower (tools/exp_k3_bf16_designs.py, which builds copies of
// this file with these constants changed). A ring stage holds as many rows of the
// streamed operand as the block owns of its own, 16 WARPS, so each thread
// copies two 16-byte chunks of a tile.
constexpr int FWD_WARPS = 5, FWD_TERMS = 2, FWD_MIN_BLOCKS = 4;
constexpr int DKV_WARPS = 5, DKV_TERMS = 3, DKV_MIN_BLOCKS = 3;
constexpr int DQ_WARPS = 5, DQ_TERMS = 3, DQ_MIN_BLOCKS = 4;

typedef bf16 Bf16Row[BROW];
// One stage of the ring, R rows: the k and v tiles (forward); q, dO, lse
// and delta (dkv).
template <int R>
struct Bf16KvStage {
  Bf16Row k[R], v[R];
};
template <int R>
struct Bf16DkvStage {
  Bf16Row q[R], d[R];
  float lse[R];    // natural log, as the forward wrote it
  float delta[R];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory, zeros (src not read) when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += A B, bfloat16 A (16 x 16) and B (16 x 8), float32 d: the products are exact.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The float32 pair (x, y) as TERMS bfloat16 pairs (x in the low half) that
// sum to it: each term but the last is the leading 8 significant bits of
// what is left (its upper 16 bits, one PRMT for the pair; the rest, x less
// them, is exact in float32), the last what is left rounded to nearest.
// Three terms carry a float32 exactly (barring underflow below ~2^-110);
// two keep its leading 16 bits and round the rest, within 2^-16 of it.
template <int TERMS>
__device__ __forceinline__ void split_bf16x2(uint32_t (&out)[TERMS], float x, float y) {
#pragma unroll
  for (int i = 0; i < TERMS - 1; ++i) {
    const uint32_t ux = __float_as_uint(x), uy = __float_as_uint(y);
    out[i] = __byte_perm(ux, uy, 0x7632);
    x -= __uint_as_float(ux & 0xffff0000u);
    y -= __uint_as_float(uy & 0xffff0000u);
  }
  const __nv_bfloat162 last = __floats2bfloat162_rn(x, y);
  out[TERMS - 1] = *reinterpret_cast<const uint32_t*>(&last);
}

// Two n8 accumulator tiles (columns 0-7 and 8-15 of 16 x 16 float32
// values) as the A fragments of their TERMS bfloat16 terms, k running over
// the 16 columns; a[0] holds the leading term.
template <int TERMS>
__device__ __forceinline__ void frag_a_terms(uint32_t (&a)[TERMS][4], const float (&c)[2][4]) {
  uint32_t p[4][TERMS];
  split_bf16x2<TERMS>(p[0], c[0][0], c[0][1]);  // a0: row g, columns 2t, 2t + 1
  split_bf16x2<TERMS>(p[1], c[0][2], c[0][3]);  // a1: row g + 8
  split_bf16x2<TERMS>(p[2], c[1][0], c[1][1]);  // a2: row g, columns 2t + 8, 2t + 9
  split_bf16x2<TERMS>(p[3], c[1][2], c[1][3]);  // a3: row g + 8
#pragma unroll
  for (int j = 0; j < TERMS; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[j][i] = p[i][j];
  }
}

// The A fragments (head dims 0-15 and 16-31) of rows w0 .. w0 + 15 of x,
// the warp's own rows, kept in registers as they are; rows past N are 0.
__device__ __forceinline__ void frag_a_rows_bf16(uint32_t (&a)[HD / 16][4],
                                                 const bf16* __restrict__ x, const Strides& s,
                                                 long long b, long long h, int w0, int N,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = w0 + g + 8 * r;
    const bf16* p = n < N ? row_ptr(x, s, b, n, h) : nullptr;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        a[kc][r + 2 * half] =
            p ? __ldg(reinterpret_cast<const unsigned*>(p + 16 * kc + 8 * half + 2 * t)) : 0u;
      }
    }
  }
}

// Start copying rows [t0, t0 + 16 WARPS) of x into dst by 16-byte
// cp.async, as they are: 4 chunks a row, two a thread; rows past N are 0.
template <int WARPS>
__device__ __forceinline__ void fetch_rows(Bf16Row* dst, const bf16* __restrict__ x,
                                           const Strides& s, long long b, long long h, int t0,
                                           int N) {
  static_assert(WARPS * WARP_ROWS * HD * 2 / 16 == 2 * WARPS * 32, "two chunks a thread");
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = threadIdx.x + u * WARPS * 32, row = i >> 2, c = i & 3, n = t0 + row;
    cp_async16(&dst[row][8 * c], n < N ? row_ptr(x, s, b, n, h) + 8 * c : x, n < N);
  }
}

// B fragments of S = X Y^T over 8 rows r0 .. r0 + 7 of a tile of Y (n)
// and all HD head dims (k): b[2 kc], b[2 kc + 1] are b0, b1 of head dims
// 16 kc .. 16 kc + 15. Lane l points ldmatrix at row r0 + l % 8, head dim
// 8 (l / 8).
__device__ __forceinline__ void frag_b_rows_bf16(uint32_t (&b)[4], const Bf16Row* tile, int r0,
                                                 int lane) {
  ldmatrix_x4(b, &tile[r0 + (lane & 7)][8 * (lane >> 3)]);
}

// B fragments of X = P Y over rows r0 .. r0 + 15 of a tile of Y (k) and
// head dims 8 n0 .. 8 n0 + 15 (n): b[0], b[1] are b0, b1 of n8 tile n0,
// b[2], b[3] those of n0 + 1 (ldmatrix.trans: lane l points at row
// r0 + l % 16, head dim 8 (n0 + l / 16)).
__device__ __forceinline__ void frag_b_cols_bf16(uint32_t (&b)[4], const Bf16Row* tile, int r0,
                                                 int n0, int lane) {
  ldmatrix_x4_trans(b, &tile[r0 + (lane & 15)][8 * (n0 + (lane >> 4))]);
}

// grid (BB * H, ceil(N / (16 FWD_WARPS))), 32 FWD_WARPS threads; a warp owns
// 16 query rows
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_MIN_BLOCKS)
    attention_fwd_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, Strides qs, Strides ks, Strides vs,
                              bf16* __restrict__ o, float* __restrict__ o32,
                              float* __restrict__ lse, int N, int H, float scale) {
  constexpr int R = FWD_WARPS * WARP_ROWS, CH = R / STEP;  // rows a tile, 16-key chunks a tile
  extern __shared__ __align__(16) unsigned char shared[];
  Bf16KvStage<R>* ring = reinterpret_cast<Bf16KvStage<R>*>(shared);
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.y * R + threadIdx.x / 32 * WARP_ROWS;
  const bool active = w0 < N;  // the warp has a query row
  fetch_rows<FWD_WARPS>(ring[0].k, k, ks, b, h, 0, N);
  fetch_rows<FWD_WARPS>(ring[0].v, v, vs, b, h, 0, N);
  cp_async_commit();

  uint32_t qa[HD / 16][4] = {};
  if (active) frag_a_rows_bf16(qa, q, qs, b, h, w0, N, lane);

  const float c = scale * LOG2E;
  float acc[HD / 8][4] = {};            // O at the running max, summed chunk by chunk in float32
  float m[2] = {-INFINITY, -INFINITY};  // rows g, g + 8: running max of S c
  float l[2] = {0.f, 0.f};              // the lane's part of their running sums
  int stage = 0;
  for (int t0 = 0; t0 < N; t0 += R, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile has landed, and every warp is done with the other stage
    if (t0 + R < N) {  // the next tile's copies fly during this tile's products
      fetch_rows<FWD_WARPS>(ring[stage ^ 1].k, k, ks, b, h, t0 + R, N);
      fetch_rows<FWD_WARPS>(ring[stage ^ 1].v, v, vs, b, h, t0 + R, N);
      cp_async_commit();
    }
    if (!active) continue;
    const Bf16Row *Kt = ring[stage].k, *Vt = ring[stage].v;
    const int nk = min(R, N - t0);
    // S = Q K^T over the tile's keys, two n8 tiles a chunk (keys past N
    // read 0); one softmax step a tile
    float s[CH][2][4];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t kb[4];
        frag_b_rows_bf16(kb, Kt, STEP * j + 8 * nt, lane);
        s[j][nt][0] = s[j][nt][1] = s[j][nt][2] = s[j][nt][3] = 0.f;
        mma_bf16(s[j][nt], qa[0], kb[0], kb[1]);
        mma_bf16(s[j][nt], qa[1], kb[2], kb[3]);
      }
    }
    if (nk < R) {  // a ragged tile: keys past N get P = 0
#pragma unroll
      for (int j = 0; j < CH; ++j) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (STEP * j + 8 * nt + 2 * t + (e & 1) >= nk) s[j][nt][e] = -INFINITY;
          }
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][nt][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the row max over the row's 4 lanes, times c > 0; finite, since key t0 < N
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r] * c);
      alpha[r] = exp2_approx(m[r] - mx[r]);  // 0 at the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (STEP * j >= nk) break;  // chunks wholly past N
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // P = 2^(S c - m), scale and log2(e) in one FFMA
          const float x = fmaf(s[j][nt][e], c, -m[e >> 1]);
          s[j][nt][e] = exp2_approx(x);
          l[e >> 1] += s[j][nt][e];
        }
      }
      float part[HD / 8][4] = {};  // this chunk's P V, in a fresh accumulator
      uint32_t pa[FWD_TERMS][4], vb[2][4];
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
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
      }
    }
  }
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    const int n = w0 + g + 8 * r;
    if (t == 0 && n < N) lse[seq * N + n] = fmaf(m[r], LN2, logf(l[r]));
  }
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] *= inv[e >> 1];
  }
  store_acc(o, acc, 1.f, b, h, w0, N, H, lane);
  if (o32 != nullptr) store_acc(o32, acc, 1.f, b, h, w0, N, H, lane);
}

// Start copying the lse and delta of queries [t0, t0 + 16 WARPS) into st,
// one value a thread; queries past N read 0.
template <int WARPS>
__device__ __forceinline__ void fetch_rowstats(Bf16DkvStage<WARPS * WARP_ROWS>& st,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, long long seq,
                                               int t0, int N) {
  constexpr int R = WARPS * WARP_ROWS;
  static_assert(2 * R == WARPS * 32, "one value a thread");
  const bool first = threadIdx.x < R;
  const int j = first ? threadIdx.x : threadIdx.x - R, n = t0 + j;
  const float* src = first ? lse : delta;
  cp_async4(first ? &st.lse[j] : &st.delta[j], n < N ? src + seq * N + n : src, n < N);
}

// grid (BB * H, ceil(N / (16 DKV_WARPS))), 32 DKV_WARPS threads; a warp owns
// 16 key rows; reads the delta of the dq kernel
__global__ void __launch_bounds__(DKV_WARPS * 32, DKV_MIN_BLOCKS)
    attention_bwd_dkv_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, Strides qs, Strides ks, Strides vs,
                                  const float* __restrict__ lse, const bf16* __restrict__ dout,
                                  const float* __restrict__ delta, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int N, int H, float scale) {
  constexpr int R = DKV_WARPS * WARP_ROWS, CH = R / STEP;  // rows a tile, 16-query chunks a tile
  extern __shared__ __align__(16) unsigned char shared[];
  Bf16DkvStage<R>* ring = reinterpret_cast<Bf16DkvStage<R>*>(shared);
  const Strides os = {(long long)N * H * HD, (long long)H * HD, HD};
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int w0 = blockIdx.y * R + threadIdx.x / 32 * WARP_ROWS;
  const bool active = w0 < N;  // the warp has a key row
  fetch_rows<DKV_WARPS>(ring[0].q, q, qs, b, h, 0, N);
  fetch_rows<DKV_WARPS>(ring[0].d, dout, os, b, h, 0, N);
  fetch_rowstats<DKV_WARPS>(ring[0], lse, delta, seq, 0, N);
  cp_async_commit();

  uint32_t ka[HD / 16][4] = {}, va[HD / 16][4] = {};
  if (active) {
    frag_a_rows_bf16(ka, k, ks, b, h, w0, N, lane);
    frag_a_rows_bf16(va, v, vs, b, h, w0, N, lane);
  }

  const float c = scale * LOG2E;
  float dka[HD / 8][4] = {}, dva[HD / 8][4] = {};  // dK / scale, dV, summed in float32
  int stage = 0;
  for (int t0 = 0; t0 < N; t0 += R, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile has landed, and every warp is done with the other stage
    if (t0 + R < N) {
      fetch_rows<DKV_WARPS>(ring[stage ^ 1].q, q, qs, b, h, t0 + R, N);
      fetch_rows<DKV_WARPS>(ring[stage ^ 1].d, dout, os, b, h, t0 + R, N);
      fetch_rowstats<DKV_WARPS>(ring[stage ^ 1], lse, delta, seq, t0 + R, N);
      cp_async_commit();
    }
    if (!active) continue;
    const Bf16DkvStage<R>& st = ring[stage];
    const int nq = min(R, N - t0);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int j0 = STEP * j;
      if (j0 >= nq) break;  // chunks wholly past N
      // S^T = K Q^T and dP^T = V dO^T over 16 queries
      float sp[2][4] = {}, ds[2][4] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t qb[4], db[4];
        frag_b_rows_bf16(qb, st.q, j0 + 8 * nt, lane);
        frag_b_rows_bf16(db, st.d, j0 + 8 * nt, lane);
        mma_bf16(sp[nt], ka[0], qb[0], qb[1]);
        mma_bf16(ds[nt], va[0], db[0], db[1]);
        mma_bf16(sp[nt], ka[1], qb[2], qb[3]);
        mma_bf16(ds[nt], va[1], db[2], db[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int i0 = j0 + 8 * nt + 2 * t;  // the lane's queries i0, i0 + 1 in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(&st.lse[i0]);
        const float2 d2 = *reinterpret_cast<const float2*>(&st.delta[i0]);
        const float lg[2] = {l2.x * LOG2E, l2.y * LOG2E}, dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // P^T and dS^T = P^T (dP^T - delta); P = 0 past N
          const float x = fmaf(sp[nt][e], c, -lg[e & 1]);
          float p = exp2_approx(x);
          if (nq < R && i0 + (e & 1) >= nq) p = 0.f;
          sp[nt][e] = p;
          ds[nt][e] = p * (ds[nt][e] - dl[e & 1]);
        }
      }
      float pv[HD / 8][4] = {}, pk[HD / 8][4] = {};  // this chunk's P^T dO, dS^T Q
      uint32_t pa[DKV_TERMS][4], dsa[DKV_TERMS][4], db[2][4], qb[2][4];
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
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[nd][e] += pv[nd][e];
          dka[nd][e] += pk[nd][e];
        }
      }
    }
  }
  if (!active) return;
  store_acc(dk, dka, scale, b, h, w0, N, H, lane);
  store_acc(dv, dva, 1.f, b, h, w0, N, H, lane);
}

// grid (BB * H, ceil(N / (16 DQ_WARPS))), 32 DQ_WARPS threads; a warp owns
// 16 query rows; writes delta for the dkv kernel
__global__ void __launch_bounds__(DQ_WARPS * 32, DQ_MIN_BLOCKS)
    attention_bwd_dq_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, Strides qs, Strides ks, Strides vs,
                                 const float* __restrict__ o, const float* __restrict__ lse,
                                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                 float* __restrict__ delta, int N, int H, float scale) {
  constexpr int R = DQ_WARPS * WARP_ROWS, CH = R / STEP;  // rows a tile, 16-key chunks a tile
  extern __shared__ __align__(16) unsigned char shared[];
  Bf16KvStage<R>* ring = reinterpret_cast<Bf16KvStage<R>*>(shared);
  const Strides os = {(long long)N * H * HD, (long long)H * HD, HD};
  const long long seq = blockIdx.x;
  const long long b = seq / H, h = seq % H;
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int w0 = blockIdx.y * R + threadIdx.x / 32 * WARP_ROWS;
  const bool active = w0 < N;  // the warp has a query row
  fetch_rows<DQ_WARPS>(ring[0].k, k, ks, b, h, 0, N);
  fetch_rows<DQ_WARPS>(ring[0].v, v, vs, b, h, 0, N);
  cp_async_commit();

  uint32_t qa[HD / 16][4] = {}, da[HD / 16][4] = {};
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // rows g, g + 8; 0 past N
  if (active) {
    frag_a_rows_bf16(qa, q, qs, b, h, w0, N, lane);
    frag_a_rows_bf16(da, dout, os, b, h, w0, N, lane);
    dq_row_stats(lse2, dl, o, lse, dout, delta, seq, b, h, w0, N, H, lane);
  }

  const float c = scale * LOG2E;
  float acc[HD / 8][4] = {};  // dQ / scale, summed chunk by chunk in float32
  int stage = 0;
  for (int t0 = 0; t0 < N; t0 += R, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile has landed, and every warp is done with the other stage
    if (t0 + R < N) {  // the next tile's copies fly during this tile's products
      fetch_rows<DQ_WARPS>(ring[stage ^ 1].k, k, ks, b, h, t0 + R, N);
      fetch_rows<DQ_WARPS>(ring[stage ^ 1].v, v, vs, b, h, t0 + R, N);
      cp_async_commit();
    }
    if (!active) continue;
    const Bf16Row *Kt = ring[stage].k, *Vt = ring[stage].v;
    const int nk = min(R, N - t0);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int j0 = STEP * j;
      if (j0 >= nk) break;  // chunks wholly past N
      // S = Q K^T and dP = dO V^T over 16 keys
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t kb[4], vb[4];
        frag_b_rows_bf16(kb, Kt, j0 + 8 * nt, lane);
        frag_b_rows_bf16(vb, Vt, j0 + 8 * nt, lane);
        mma_bf16(s[nt], qa[0], kb[0], kb[1]);
        mma_bf16(dp[nt], da[0], vb[0], vb[1]);
        mma_bf16(s[nt], qa[1], kb[2], kb[3]);
        mma_bf16(dp[nt], da[1], vb[2], vb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // dS = P (dP - delta); keys past N have P = 0
          const float x = fmaf(s[nt][e], c, -lse2[e >> 1]);
          float p = exp2_approx(x);
          if (nk < R && j0 + 8 * nt + 2 * t + (e & 1) >= nk) p = 0.f;
          s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
        }
      }
      float part[HD / 8][4] = {};  // this chunk's dS K, in a fresh accumulator
      uint32_t dsa[DQ_TERMS][4], kb[2][4];
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
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
      }
    }
  }
  if (active) store_acc(dq, acc, scale, b, h, w0, N, H, lane);
}

// Dynamic shared memory of a block of the bfloat16 kernels.
constexpr int BF16_FWD_SHARED = STAGES * sizeof(Bf16KvStage<FWD_WARPS * WARP_ROWS>);
constexpr int BF16_DKV_SHARED = STAGES * sizeof(Bf16DkvStage<DKV_WARPS * WARP_ROWS>);
constexpr int BF16_DQ_SHARED = STAGES * sizeof(Bf16KvStage<DQ_WARPS * WARP_ROWS>);

// The launchers of the bfloat16 kernels.
int forward_bf16(const void* q, const void* k, const void* v, Strides qs, Strides ks, Strides vs,
                 void* o, void* o32, void* lse, int BB, int N, int H, float scale, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid, FWD_WARPS * WARP_ROWS)) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(attention_fwd_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BF16_FWD_SHARED);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel_bf16<<<grid, FWD_WARPS * 32, BF16_FWD_SHARED,
                              static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          qs, ks, vs, static_cast<bf16*>(o), static_cast<float*>(o32), static_cast<float*>(lse),
          N, H, scale);
  return (int)cudaGetLastError();
}

int backward_dkv_bf16(const void* q, const void* k, const void* v, Strides qs, Strides ks,
                      Strides vs, const void* lse, const void* dout, const void* delta, void* dk,
                      void* dv, int BB, int N, int H, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid, DKV_WARPS * WARP_ROWS)) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BF16_DKV_SHARED);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel_bf16<<<grid, DKV_WARPS * 32, BF16_DKV_SHARED,
                                  static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          qs, ks, vs, static_cast<const float*>(lse), static_cast<const bf16*>(dout),
          static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H,
          scale);
  return (int)cudaGetLastError();
}

int backward_dq_bf16(const void* q, const void* k, const void* v, Strides qs, Strides ks,
                     Strides vs, const void* o, const void* lse, const void* dout, void* dq,
                     void* delta, int BB, int N, int H, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)BB * N * H == 0) return 0;
  dim3 grid;
  if (!grid_for(BB, N, H, &grid, DQ_WARPS * WARP_ROWS)) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BF16_DQ_SHARED);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel_bf16<<<grid, DQ_WARPS * 32, BF16_DQ_SHARED,
                                 static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          qs, ks, vs, static_cast<const float*>(o), static_cast<const float*>(lse),
          static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<float*>(delta), N,
          H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points, one set per type: q, k, v are (BB, N, H, 32) with
// element strides (b, n, h) given per tensor and 16-byte aligned rows; o, do,
// dq, dk, dv (BB, N, H, 32) and lse, delta (BB, H, N, float32) contiguous.
// The dq kernel's o is float32 in both types. Each launches on `stream` of
// `device` and returns cudaGetLastError().
#define QKV_ARGS                                                                           \
  const void *q, const void *k, const void *v, long long qsb, long long qsn, long long qsh, \
      long long ksb, long long ksn, long long ksh, long long vsb, long long vsn, long long vsh
#define QKV q, k, v, Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh}
#define TAIL_ARGS int BB, int N, int H, float scale, int device, void *stream
#define TAIL BB, N, H, scale, device, stream

// o (BB, N, H, 32) and lse (BB, H, N); for bfloat16, also O in float32 into
// o32 unless it is null.
extern "C" int area_attention_fwd_f32(QKV_ARGS, void* o, void* lse, TAIL_ARGS) {
  return forward<float>(QKV, o, nullptr, lse, TAIL);
}
extern "C" int area_attention_fwd_bf16(QKV_ARGS, void* o, void* o32, void* lse, TAIL_ARGS) {
  return forward_bf16(QKV, o, o32, lse, TAIL);
}

// dq and delta (BB, H, N) from q, k, v, o (float32), lse and do.
extern "C" int area_attention_bwd_dq_f32(QKV_ARGS, const void* o, const void* lse,
                                         const void* dout, void* dq, void* delta, TAIL_ARGS) {
  return backward_dq<float>(QKV, o, lse, dout, dq, delta, TAIL);
}
extern "C" int area_attention_bwd_dq_bf16(QKV_ARGS, const void* o, const void* lse,
                                          const void* dout, void* dq, void* delta, TAIL_ARGS) {
  return backward_dq_bf16(QKV, o, lse, dout, dq, delta, TAIL);
}

// dk and dv from q, k, v, lse, do and the delta of the dq kernel.
extern "C" int area_attention_bwd_dkv_f32(QKV_ARGS, const void* lse, const void* dout,
                                          const void* delta, void* dk, void* dv, TAIL_ARGS) {
  return backward_dkv<float>(QKV, lse, dout, delta, dk, dv, TAIL);
}
extern "C" int area_attention_bwd_dkv_bf16(QKV_ARGS, const void* lse, const void* dout,
                                           const void* delta, void* dk, void* dv, TAIL_ARGS) {
  return backward_dkv_bf16(QKV, lse, dout, delta, dk, dv, TAIL);
}

// Bytes of dynamic shared memory a block of each kernel takes: 0 forward,
// 1 dq, 2 dkv; of the bfloat16 kernels when bf16 is not 0.
extern "C" int area_attention_shared_bytes(int kernel, int bf16) {
  if (bf16) return kernel == 0 ? BF16_FWD_SHARED : kernel == 1 ? BF16_DQ_SHARED : BF16_DKV_SHARED;
  return kernel == 2 ? (int)sizeof(DkvShared) : (int)sizeof(KvShared);
}
