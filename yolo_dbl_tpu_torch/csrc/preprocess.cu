// Fused letterbox + normalize of uint8 frames.
//
// Replaces the TPU kernel yolo_dbl_tpu/kernels/preprocess.py
// (`letterbox_normalize`, body `_letterbox_kernel`, pallas_call at :144):
// uint8 (B, H, W, 3) frames are resized with cv2's INTER_LINEAR half-pixel
// bilinear rule (`_bilinear_matrix`, :168) into a (B, h_out, w_out, 3)
// canvas padded with `pad_value`, and everything is divided by 255.
// Output is float32 or bfloat16, NHWC, which is the channels_last layout of
// the NCHW image the stem convolution reads.
//
// Bound: bytes. The frames are read once as uint8 and the canvas written
// once (batch 8, 512x768 -> 640x640, f32: 9.4 MB + 39.3 MB, 14.6 us at
// 3.35 TB/s); the arithmetic (~30 flops a pixel) is small beside it. The
// first design (a thread a pixel, 12 byte loads from the frame; kept as
// tools/exp_k1_per_pixel.cu) took twice that, and not for want of bytes in
// flight: it read the same with its frames in L2 as past it. It was bound
// by instruction issue and by uneven work across SMs, as the first cut of
// this kernel was (tools/exp_k1_letterbox_designs.py, PERF.md).
//
// Design. The TPU kernel ran two dense 2-sparse interpolation matmuls per
// channel plane because Mosaic rejects gathers. Here every warp owns a run of
// output rows of one column tile (at most 128 output pixels wide) of one
// image, and works through it as a pipeline:
//  - the two source rows an output row blends are staged into shared memory
//    with 16-byte cp.async, only the column span the tile reads, STAGES - 1
//    rows ahead of the row being blended; the tile width is planned on the
//    host (kernels/preprocess.py `_plan`) so that a span fits its slot for
//    any W, and so are the rows a warp takes: few (2 at the smoke's shape),
//    so the grid has enough blocks to share out evenly over the SMs;
//  - the column taps are computed once per block into shared memory, the
//    row taps once per row, both in float64 and rounded exactly as
//    `_bilinear_matrix` rounds them (32-bit floor: no 64-bit integer work);
//  - a lane blends 4 output pixels of a row, the lanes on neighbouring
//    pixels, so the words a warp reads from a staged row fall in distinct
//    banks; a pixel's 6 bytes of one row are three 32-bit shared loads and
//    funnel shifts, each byte a float by one conversion, and x / 255 is the
//    IEEE quotient in 3 FMA-pipe instructions (div255); a tile wholly in
//    the resized frame takes a branch-free path, so a lane's 4 pixels
//    interleave;
//  - the blended row tile is written to a staging buffer in shared memory,
//    placed at the row's own 16-byte phase, and leaves as 16-byte stores
//    (scalar ones only at an unaligned head or tail); rows and tiles wholly
//    in the pad are a 16-byte fill of the pad value.
// There is no index division per thread: the grid is (row group x column
// tile, image).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // warps a block, each on its own run of rows
constexpr int STAGES = 3;  // staged rows a warp holds: the one it blends and those in flight
constexpr int PX = 4;      // output pixels a lane blends per row; a tile is at most 32 * PX wide

// Two taps and the weight of the second one for output coordinate r, as
// `_bilinear_matrix`: s = r * scale + shift in float64, lo = floor(s),
// w = float32(s - lo), taps clamped to [0, n_in - 1]. |s| < n_in + 1, so
// floor(s) is exact as an int.
__device__ __forceinline__ void taps(int r, double scale, double shift, int n_in, int* i0, int* i1,
                                     float* w) {
  const double s = __dadd_rn(__dmul_rn((double)r, scale), shift);
  const int lo = __double2int_rd(s);
  *w = __double2float_rn(__dsub_rn(s, (double)lo));
  *i0 = min(max(lo, 0), n_in - 1);
  *i1 = min(max(lo + 1, 0), n_in - 1);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Bytes of one warp's shared memory: STAGES x 2 row slots, then the staging
// buffer of one blended row tile (3 values a pixel, at a phase of < 16 bytes),
// then STAGES 16-byte headers (a staged row's weight and its two phases).
__host__ __device__ constexpr int warp_bytes(int tile, int slot, int esize) {
  return STAGES * 2 * slot + round16(tile * 3 * esize + 16) + STAGES * 16;
}

struct RowHeader {
  float wy;  // weight of the second source row
  int sh0, sh1;  // phase (address & 15) of the span's first byte in each source row
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of one repeated value
__device__ __forceinline__ uint4 repeated(float v) {
  const uint32_t u = __float_as_uint(v);
  return make_uint4(u, u, u, u);
}
__device__ __forceinline__ uint4 repeated(__nv_bfloat16 v) {
  const uint32_t h = __bfloat16_as_ushort(v);
  const uint32_t u = h | (h << 16);
  return make_uint4(u, u, u, u);
}

// Byte K of w as a float: one I2F.U8 with a byte selector.
template <int K>
__device__ __forceinline__ float byte_float(uint32_t w) {
  return (float)((w >> (8 * K)) & 0xff);
}

// The 6 bytes (two pixels x 3 channels) at byte `at` of a staged row (its
// 32-bit words), as floats. `second` is 24 (bits) where the second tap is the
// next pixel, 0 where both taps are clamped to one pixel.
__device__ __forceinline__ void pixel_pair(const uint32_t* row, int at, uint32_t second,
                                           float* p) {
  const uint32_t* w = row + (at >> 2);
  const uint32_t sh = (uint32_t)(at & 3) * 8;
  const uint32_t lo = __funnelshift_r(w[0], w[1], sh);
  const uint32_t hi = __funnelshift_r(w[1], w[2], sh);
  const uint32_t nx = __funnelshift_r(lo, hi, second);
  p[0] = byte_float<0>(lo);
  p[1] = byte_float<1>(lo);
  p[2] = byte_float<2>(lo);
  p[3] = byte_float<0>(nx);
  p[4] = byte_float<1>(nx);
  p[5] = byte_float<2>(nx);
}

// v / 255 as the IEEE division rounds it, for v in [0, 256): the quotient by
// the rounded reciprocal, corrected once by its FMA residual (Markstein);
// tools/exp_k1_letterbox_designs.py checks every float32 in [0, 256) on the
// card against __fdiv_rn.
__device__ __forceinline__ float div255(float v) {
  constexpr float r = 1.0f / 255.0f;
  const float q = v * r;
  return fmaf(fmaf(q, -255.0f, v), r, q);
}

// Writes n values of type T to dst, reading them from `stage`, whose byte
// (dst & 15) + i holds dst's byte i: whole 16-byte chunks as vectors, the
// unaligned head and tail value by value. With stage == nullptr it writes
// `fill` (16 bytes of one repeated value, `one` that value) instead.
template <typename T>
__device__ __forceinline__ void store_row(T* dst, int n, const uint8_t* stage, uint4 fill, T one,
                                          int lane) {
  constexpr int E = (int)sizeof(T);
  const uintptr_t g = reinterpret_cast<uintptr_t>(dst);
  uint8_t* base = reinterpret_cast<uint8_t*>(g & ~uintptr_t(15));
  const int lo = (int)(g & 15), hi = lo + n * E;
  if (lo == 0 && (hi & 15) == 0) {  // whole chunks only
    uint4* d = reinterpret_cast<uint4*>(base);
    const uint4* st = reinterpret_cast<const uint4*>(stage);
    for (int q = lane; q < (hi >> 4); q += 32) d[q] = stage ? st[q] : fill;
    return;
  }
  for (int q = lane; 16 * q < hi; q += 32) {
    const int b0 = 16 * q;
    if (b0 >= lo && b0 + 16 <= hi) {
      *reinterpret_cast<uint4*>(base + b0) =
          stage ? *reinterpret_cast<const uint4*>(stage + b0) : fill;
    } else {
      for (int b = max(b0, lo); b < min(b0 + 16, hi); b += E) {
        *reinterpret_cast<T*>(base + b) = stage ? *reinterpret_cast<const T*>(stage + b) : one;
      }
    }
  }
}

// A column of the tile: its two source pixels and the second's weight,
// padded to 16 bytes so a lane reads it with one shared load.
struct ColumnTap {
  int x0, x1;
  float wx;
  int unused;
};

// Dynamic shared bytes of a block: the tile's column taps, then each warp's.
__host__ __device__ constexpr int block_bytes(int tile, int slot, int esize) {
  return (int)sizeof(ColumnTap) * 32 * PX + WARPS * warp_bytes(tile, slot, esize);
}

// grid (row groups x column tiles, B), WARPS * 32 threads,
// block_bytes(tile, slot, sizeof(T)) bytes of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    letterbox_kernel(const uint8_t* __restrict__ src, T* __restrict__ out, int H, int W, int h_out,
                     int w_out, int new_h, int new_w, int top, int left, double sy, double oy,
                     double sx, double ox, float pad_value, int tile, int n_tiles, int slot,
                     int rows_per_warp, bool src_aligned) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x % n_tiles) * tile, c1 = min(c0 + tile, w_out);
  // content columns of the tile; their taps, once a block
  const int cl = max(c0, left), cr = min(c1, left + new_w);
  const bool content_cols = cl < cr;
  ColumnTap* columns = reinterpret_cast<ColumnTap*>(smem);
  for (int i = threadIdx.x; i < cr - cl; i += WARPS * 32) {
    ColumnTap t;
    taps(cl - left + i, sx, ox, W, &t.x0, &t.x1, &t.wx);
    columns[cl - c0 + i] = t;
  }
  __syncthreads();

  const int row0 = (blockIdx.x / n_tiles) * WARPS * rows_per_warp + warp * rows_per_warp;
  const int rows = min(rows_per_warp, h_out - row0);
  if (rows <= 0) return;  // no block-wide barrier below
  uint8_t* ring = smem + sizeof(ColumnTap) * 32 * PX + warp * warp_bytes(tile, slot, (int)sizeof(T));
  uint8_t* stage = ring + STAGES * 2 * slot;
  RowHeader* headers = reinterpret_cast<RowHeader*>(stage + round16(tile * 3 * sizeof(T) + 16));
  const long long W3 = W * 3LL;
  const uint8_t* frame = src + (long long)b * H * W3;
  const uintptr_t src_lo = reinterpret_cast<uintptr_t>(src);
  const uintptr_t src_hi = src_lo + (uintptr_t)gridDim.y * H * W3;

  // the source span the tile reads, and each lane's pixels: byte offset of
  // the first tap in the span (-1: pad), the second tap's shift, its weight
  int x_lo = 0, x_hi = 0;
  if (content_cols) {
    x_lo = columns[cl - c0].x0;
    x_hi = columns[cr - 1 - c0].x1;
  }
  int off[PX];
  uint32_t second[PX];
  float wx[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int c = c0 + lane + 32 * j;
    off[j] = -1;
    second[j] = 24;
    wx[j] = 0.f;
    if (c >= cl && c < cr) {
      const ColumnTap t = columns[c - c0];
      off[j] = (t.x0 - x_lo) * 3;
      second[j] = t.x1 == t.x0 ? 0 : 24;
      wx[j] = t.wx;
    }
  }
  // every lane's every pixel lies in the resized frame
  const bool full = cl == c0 && cr == c0 + 32 * PX;
  const int span_bytes = (x_hi - x_lo + 1) * 3, x_lo3 = x_lo * 3;

  // stage one source row's span at a (phase sh = a & 15) into dst: whole
  // 16-byte chunks by cp.async; byte by byte only where a chunk would pass
  // an end of the frames' buffer (which needs a buffer not 16-byte aligned)
  auto stage_row = [&](const uint8_t* a, uint8_t* dst) {
    const int sh = (int)(reinterpret_cast<uintptr_t>(a) & 15);
    const uint8_t* g0 = a - sh;
    const int n = min(round16(sh + span_bytes), slot);
    for (int q = 16 * lane; q < n; q += 16 * 32) {
      const uint8_t* g = g0 + q;
      const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
      if (src_aligned || (ga >= src_lo && ga + 16 <= src_hi)) {
        cp_async16(dst + q, g);
      } else {
        for (int i = 0; i < 16; ++i) {
          if (ga + i >= src_lo && ga + i < src_hi) dst[q + i] = g[i];
        }
      }
    }
    return sh;
  };

  // stage the two source rows of the warp's k-th row into slot pair `ring_k`
  // and their weight and phases into header `ring_k`
  auto issue = [&](int k, int ring_k) {
    const int r = row0 + k - top;
    if (k < rows && content_cols && r >= 0 && r < new_h) {
      int y0, y1;
      float wy;
      taps(r, sy, oy, H, &y0, &y1, &wy);
      uint8_t* dst = ring + ring_k * 2 * slot;
      const int sh0 = stage_row(frame + y0 * W3 + x_lo3, dst);
      const int sh1 = stage_row(frame + y1 * W3 + x_lo3, dst + slot);
      if (lane == 0) headers[ring_k] = RowHeader{wy, sh0, sh1};
    }
    cp_async_commit();  // an empty group for a row with nothing to stage
  };

  const float pad = pad_value / 255.0f;
  const T pad_t = from_float<T>(pad);
  const uint4 fill = repeated(pad_t);

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k, k);
  T* dst = out + (((long long)b * h_out + row0) * w_out + c0) * 3;
  const int n = (c1 - c0) * 3;
  for (int k = 0, ring_k = 0; k < rows; ++k, dst += w_out * 3) {
    issue(k + STAGES - 1, ring_k == 0 ? STAGES - 1 : ring_k - 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int r = row0 + k - top;
    if (!content_cols || r < 0 || r >= new_h) {
      store_row<T>(dst, n, nullptr, fill, pad_t, lane);
    } else {
      const RowHeader h = headers[ring_k];
      const float wy = h.wy, wy1 = 1.f - wy;
      const uint32_t* row0 = reinterpret_cast<const uint32_t*>(ring + ring_k * 2 * slot);
      const uint32_t* row1 = reinterpret_cast<const uint32_t*>(ring + (ring_k * 2 + 1) * slot);
      T* st = reinterpret_cast<T*>(stage) + (reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T);
      // pixel j of the lane, blended into the staging buffer
      auto blend = [&](int j) {
        float p0[6], p1[6];
        pixel_pair(row0, h.sh0 + off[j], second[j], p0);
        pixel_pair(row1, h.sh1 + off[j], second[j], p1);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float left_col = wy1 * p0[ch] + wy * p1[ch];
          const float right_col = wy1 * p0[ch + 3] + wy * p1[ch + 3];
          st[(lane + 32 * j) * 3 + ch] =
              from_float<T>(div255((1.f - wx[j]) * left_col + wx[j] * right_col));
        }
      };
      if (full) {
#pragma unroll
        for (int j = 0; j < PX; ++j) blend(j);
      } else {
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          if (c0 + lane + 32 * j >= c1) continue;
          if (off[j] >= 0) {
            blend(j);
          } else {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) st[(lane + 32 * j) * 3 + ch] = pad_t;
          }
        }
      }
      __syncwarp();
      store_row<T>(dst, n, stage, fill, pad_t, lane);
    }
    __syncwarp();  // the slots and the staging buffer are refilled next
    ring_k = ring_k == STAGES - 1 ? 0 : ring_k + 1;
  }
}

template <typename T>
int launch(const uint8_t* src, T* out, int B, int H, int W, int h_out, int w_out, int new_h,
           int new_w, int top, int left, double sy, double oy, double sx, double ox,
           float pad_value, int tile, int slot, int rows_per_warp, cudaStream_t s) {
  const int smem = block_bytes(tile, slot, (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(letterbox_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (w_out + tile - 1) / tile;
  const long long groups = (h_out + (long long)WARPS * rows_per_warp - 1) /
                           ((long long)WARPS * rows_per_warp);
  if (groups * n_tiles > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 && (long long)B * H * W * 3 % 16 == 0;
  letterbox_kernel<T><<<dim3((unsigned)(groups * n_tiles), (unsigned)B), WARPS * 32, smem, s>>>(
      src, out, H, W, h_out, w_out, new_h, new_w, top, left, sy, oy, sx, ox, pad_value, tile,
      n_tiles, slot, rows_per_warp, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared bytes of a block for a tile plan.
extern "C" int letterbox_shared_bytes(int out_bf16, int tile, int slot) {
  return block_bytes(tile, slot, out_bf16 ? 2 : 4);
}

// Launches on `stream` of `device`; returns a cudaError_t. The plan (tile
// width <= 32 * PX, slot bytes: a multiple of 16 that holds a tile's source
// span + 24 bytes, rows a warp) comes from kernels/preprocess.py `_plan`.
extern "C" int letterbox_normalize_u8(const void* src, void* out, int out_bf16, int B, int H, int W,
                                      int h_out, int w_out, int new_h, int new_w, int top, int left,
                                      double sy, double oy, double sx, double ox, float pad_value,
                                      int tile, int slot, int rows_per_warp, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * h_out * w_out == 0) return 0;
  if (tile < 1 || tile > 32 * PX || slot < 32 || slot % 16 || rows_per_warp < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  if (out_bf16) {
    return launch(in, static_cast<__nv_bfloat16*>(out), B, H, W, h_out, w_out, new_h, new_w, top,
                  left, sy, oy, sx, ox, pad_value, tile, slot, rows_per_warp, s);
  }
  return launch(in, static_cast<float*>(out), B, H, W, h_out, w_out, new_h, new_w, top, left, sy,
                oy, sx, ox, pad_value, tile, slot, rows_per_warp, s);
}
