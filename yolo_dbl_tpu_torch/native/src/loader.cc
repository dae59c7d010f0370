// Native data-loader core: JPEG/PNG decode + aspect-preserving letterbox
// resize + collate into a caller-owned batch buffer, fanned out over a
// persistent worker pool.
//
// This is the TPU-framework counterpart of the reference's native input
// path: torch DataLoader's C++ worker pool (reference data/build.py:135
// InfiniteDataLoader / torch C++ core) + cv2's native imread/resize
// (reference data/base.py load_image, augment.py:1477 LetterBox). Python
// orchestrates epochs/shuffling/augment policy; the per-image byte work —
// file IO, entropy decode, bilinear resample, padded collate — happens here
// with the GIL released, writing directly into the preallocated uint8
// (N, S, S, 3) batch the jitted step consumes (device_normalize handles
// /255 on-chip — kernels/preprocess.py).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Semantics contract (tested against the Python path in
// tests/test_native_loader.py):
//   - letterbox == data/augment.py:23 letterbox(): r = min(S/h, S/w)
//     (clamped to 1 when !scaleup), new_unpad = round(w*r), round(h*r),
//     centered padding with the same round(d±0.1) tie-breaks, pad value 114.
//   - resize == cv2.INTER_LINEAR: pixel-center alignment
//     src = (dst + 0.5) * (in/out) - 0.5, edge-clamped.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cstdint>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- file IO

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

// ------------------------------------------------------------ JPEG decode

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode JPEG bytes to RGB u8. Returns false on any decode error.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                 int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts YCbCr + grayscale
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  rgb.resize(static_cast<size_t>(*h) * *w * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------------- PNG decode

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) png_error(png, "png: read past end");
  std::memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                int* h, int* w) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);
  // normalize every PNG flavor to 8-bit RGB
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);
  *h = static_cast<int>(png_get_image_height(png, info));
  *w = static_cast<int>(png_get_image_width(png, info));
  if (png_get_rowbytes(png, info) != static_cast<size_t>(*w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  rgb.resize(static_cast<size_t>(*h) * *w * 3);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) rows[y] = rgb.data() + static_cast<size_t>(y) * *w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_image(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                  int* h, int* w) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) return decode_jpeg(data, len, rgb, h, w);
  if (len >= 8 && !png_sig_cmp(data, 0, 8)) return decode_png(data, len, rgb, h, w);
  return false;
}

// ------------------------------------------------- bilinear resize (u8 RGB)

// cv2.INTER_LINEAR-compatible: pixel-center alignment, edge clamp.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  // precompute x taps once per row sweep
  std::vector<int> x0(dw), x1(dw);
  std::vector<float> fx(dw);
  for (int x = 0; x < dw; ++x) {
    float xs = (x + 0.5f) * sx - 0.5f;
    float xf = std::floor(xs);
    fx[x] = xs - xf;
    int xi = static_cast<int>(xf);
    x0[x] = std::clamp(xi, 0, sw - 1);
    x1[x] = std::clamp(xi + 1, 0, sw - 1);
  }
  for (int y = 0; y < dh; ++y) {
    float ys = (y + 0.5f) * sy - 0.5f;
    float yf = std::floor(ys);
    float wy = ys - yf;
    int yi = static_cast<int>(yf);
    const uint8_t* r0 = src + static_cast<size_t>(std::clamp(yi, 0, sh - 1)) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(std::clamp(yi + 1, 0, sh - 1)) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p00 = r0 + x0[x] * 3;
      const uint8_t* p01 = r0 + x1[x] * 3;
      const uint8_t* p10 = r1 + x0[x] * 3;
      const uint8_t* p11 = r1 + x1[x] * 3;
      float wx = fx[x];
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        float v = top + (bot - top) * wy;
        out[x * 3 + c] = static_cast<uint8_t>(std::lround(std::clamp(v, 0.0f, 255.0f)));
      }
    }
  }
}

// --------------------------------------------------------------- letterbox

// Mirrors data/augment.py:23 letterbox() exactly (round() is Python banker's
// rounding only for .5 ties on even — augment.py relies on round(x*r) where
// ties are vanishingly rare; we use llround and accept the shared contract
// is pinned by the parity test on real sizes).
void letterbox_into(const uint8_t* rgb, int h, int w, uint8_t* out, int size,
                    int pad_value, bool scaleup, bool center, float* gain,
                    float* pad_xy) {
  float r = std::min(static_cast<float>(size) / h, static_cast<float>(size) / w);
  if (!scaleup) r = std::min(r, 1.0f);
  int nw = static_cast<int>(std::lround(w * r));
  int nh = static_cast<int>(std::lround(h * r));
  nw = std::clamp(nw, 1, size);
  nh = std::clamp(nh, 1, size);
  float dw = (size - nw) / (center ? 2.0f : 1.0f);
  float dh = (size - nh) / (center ? 2.0f : 1.0f);
  int left = static_cast<int>(std::lround(dw - 0.1f));
  int top = static_cast<int>(std::lround(dh - 0.1f));
  if (!center) {
    left = 0;
    top = 0;
  }
  std::memset(out, pad_value, static_cast<size_t>(size) * size * 3);
  std::vector<uint8_t> resized;
  const uint8_t* src = rgb;
  if (nw != w || nh != h) {
    resized.resize(static_cast<size_t>(nh) * nw * 3);
    resize_bilinear(rgb, h, w, resized.data(), nh, nw);
    src = resized.data();
  }
  for (int y = 0; y < nh; ++y) {
    std::memcpy(out + (static_cast<size_t>(y + top) * size + left) * 3,
                src + static_cast<size_t>(y) * nw * 3, static_cast<size_t>(nw) * 3);
  }
  *gain = r;
  pad_xy[0] = static_cast<float>(left);
  pad_xy[1] = static_cast<float>(top);
}

// ------------------------------------------------------------- worker pool

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    n = std::max(1, n);
    for (int i = 0; i < n; ++i)
      threads_.emplace_back([this] { worker(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  void worker() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      job();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> jobs_;
  std::vector<std::thread> threads_;
  bool stop_;
};

struct Latch {
  std::mutex mu;
  std::condition_variable cv;
  int remaining;
  explicit Latch(int n) : remaining(n) {}
  void count_down() {
    std::lock_guard<std::mutex> lk(mu);
    if (--remaining == 0) cv.notify_all();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return remaining == 0; });
  }
};

}  // namespace

// ------------------------------------------------------------------ C ABI

extern "C" {

void* ydt_pool_create(int n_workers) { return new Pool(n_workers); }

void ydt_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Decode one image file to RGB u8 at native size. Caller passes a buffer of
// cap bytes; on success *h/*w are set and h*w*3 bytes are written.
// Returns 0 ok, 1 read error, 2 decode error, 3 buffer too small.
int ydt_decode_file(const char* path, uint8_t* out, long long cap, int* h, int* w) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, bytes)) return 1;
  std::vector<uint8_t> rgb;
  if (!decode_image(bytes.data(), bytes.size(), rgb, h, w)) return 2;
  if (static_cast<long long>(rgb.size()) > cap) return 3;
  std::memcpy(out, rgb.data(), rgb.size());
  return 0;
}

// The batched hot path: for each of n files, decode + letterbox to
// (size, size, 3) u8 directly into out[i], recording gain/pad for box
// remapping (apply_letterbox_to_boxes) and the original (h, w).
// status[i]: 0 ok, 1 read error, 2 decode error. Returns #failures.
int ydt_decode_letterbox_batch(void* pool_ptr, const char** paths, int n,
                               int size, int pad_value, int scaleup, int center,
                               uint8_t* out, float* gains, float* pads,
                               int* orig_hw, int* status) {
  Pool* pool = static_cast<Pool*>(pool_ptr);
  Latch latch(n);
  std::atomic<int> failures{0};
  const size_t img_bytes = static_cast<size_t>(size) * size * 3;
  for (int i = 0; i < n; ++i) {
    pool->submit([&, i] {
      std::vector<uint8_t> bytes, rgb;
      int h = 0, w = 0;
      int st = 0;
      if (!read_file(paths[i], bytes)) {
        st = 1;
      } else if (!decode_image(bytes.data(), bytes.size(), rgb, &h, &w)) {
        st = 2;
      }
      if (st == 0) {
        letterbox_into(rgb.data(), h, w, out + img_bytes * i, size, pad_value,
                       scaleup != 0, center != 0, &gains[i], &pads[2 * i]);
        orig_hw[2 * i] = h;
        orig_hw[2 * i + 1] = w;
      } else {
        std::memset(out + img_bytes * i, pad_value, img_bytes);
        gains[i] = 1.0f;
        pads[2 * i] = pads[2 * i + 1] = 0.0f;
        orig_hw[2 * i] = orig_hw[2 * i + 1] = 0;
        failures.fetch_add(1, std::memory_order_relaxed);
      }
      status[i] = st;
      latch.count_down();
    });
  }
  latch.wait();
  return failures.load();
}

// Letterbox an already-decoded RGB u8 image (parity shim + non-file sources).
void ydt_letterbox(const uint8_t* rgb, int h, int w, uint8_t* out, int size,
                   int pad_value, int scaleup, int center, float* gain,
                   float* pad_xy) {
  letterbox_into(rgb, h, w, out, size, pad_value, scaleup != 0, center != 0,
                 gain, pad_xy);
}

}  // extern "C"
