// The first design of the fused letterbox (K1), which the port ran until the
// staged kernel in yolo_dbl_tpu_torch/csrc/preprocess.cu took its place: one
// thread per output pixel, 12 single-byte loads of its 4 taps x 3 channels
// straight from the uint8 frame, 3 scalar stores, and the pixel's row, column
// and image taken from its flat index with 64-bit % and /.
// tools/exp_k1_letterbox_designs.py builds it to time against the kernel the
// port ships. Its C interface is this design's own: the geometry and tap rule
// of yolo_dbl_tpu_torch/kernels/preprocess.py, no tile plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Two taps and the weight of the second one for output coordinate r, as
// `_bilinear_matrix`: s = r * scale + shift in float64, lo = floor(s),
// w = float32(s - lo), taps clamped to [0, n_in - 1].
__device__ __forceinline__ void taps(int r, double scale, double shift, int n_in, int* i0, int* i1,
                                     float* w) {
  const double s = __dadd_rn(__dmul_rn((double)r, scale), shift);
  const double lo = floor(s);
  *w = __double2float_rn(__dsub_rn(s, lo));
  const long long l = (long long)lo;
  *i0 = (int)min(max(l, 0LL), (long long)(n_in - 1));
  *i1 = (int)min(max(l + 1, 0LL), (long long)(n_in - 1));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void letterbox_kernel(const uint8_t* __restrict__ src, T* __restrict__ out, int H, int W,
                                 int h_out, int w_out, int new_h, int new_w, int top, int left,
                                 double sy, double oy, double sx, double ox, float pad_value,
                                 long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int col = (int)(i % w_out);
  const long long t = i / w_out;
  const int row = (int)(t % h_out);
  const long long b = t / h_out;
  T* o = out + i * 3;
  const int rr = row - top;
  const int cc = col - left;
  if (rr < 0 || rr >= new_h || cc < 0 || cc >= new_w) {
    const float v = pad_value / 255.0f;
    store(o, v);
    store(o + 1, v);
    store(o + 2, v);
    return;
  }
  int y0, y1, x0, x1;
  float wy, wx;
  taps(rr, sy, oy, H, &y0, &y1, &wy);
  taps(cc, sx, ox, W, &x0, &x1, &wx);
  const uint8_t* img = src + b * H * W * 3;
  const uint8_t* p00 = img + ((long long)y0 * W + x0) * 3;
  const uint8_t* p01 = img + ((long long)y0 * W + x1) * 3;
  const uint8_t* p10 = img + ((long long)y1 * W + x0) * 3;
  const uint8_t* p11 = img + ((long long)y1 * W + x1) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float left_col = (1.f - wy) * (float)p00[ch] + wy * (float)p10[ch];
    const float right_col = (1.f - wy) * (float)p01[ch] + wy * (float)p11[ch];
    const float v = (1.f - wx) * left_col + wx * right_col;
    store(o + ch, v / 255.0f);
  }
}

}  // namespace

// Launches on `stream` of `device`; returns cudaGetLastError() of the launch.
extern "C" int letterbox_normalize_u8(const void* src, void* out, int out_bf16, int B, int H, int W,
                                      int h_out, int w_out, int new_h, int new_w, int top, int left,
                                      double sy, double oy, double sx, double ox, float pad_value,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * h_out * w_out;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  if (out_bf16) {
    letterbox_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(out), H, W, h_out, w_out, new_h, new_w, top, left, sy, oy,
        sx, ox, pad_value, total);
  } else {
    letterbox_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        in, static_cast<float*>(out), H, W, h_out, w_out, new_h, new_w, top, left, sy, oy, sx, ox,
        pad_value, total);
  }
  return (int)cudaGetLastError();
}
