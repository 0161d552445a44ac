// DecNet-TPU native host library.
//
// TPU-native replacement for the reference's host-side hot loops: the
// Gaussian-pyramid detail detector (reference utils/utils.py:392-534, run in
// cv2 per image at demo.py:161-162) and PFM disparity decoding
// (utils/utils.py:281-327).  Runs multi-threaded on the host CPUs so the data
// pipeline keeps the TPU fed; exposed to Python via a C ABI + ctypes
// (decnet_tpu/data/native.py).
//
// Build: make -C native  (produces libdecnet_native.so)

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Reflect-101 border index (cv2 default border for GaussianBlur).
inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// Separable Gaussian blur, kernel size k (odd), sigma, on (H, W, C) f32.
void gaussian_blur(const float* src, float* dst, int H, int W, int C, int k,
                   float sigma) {
  const int r = k / 2;
  std::vector<float> kern(k);
  float sum = 0.f;
  for (int i = 0; i < k; ++i) {
    const float x = i - r;
    kern[i] = std::exp(-(x * x) / (2.f * sigma * sigma));
    sum += kern[i];
  }
  for (auto& v : kern) v /= sum;

  std::vector<float> tmp((size_t)H * W * C);
  // horizontal
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
        for (int i = 0; i < k; ++i)
          acc += kern[i] * src[((size_t)y * W + reflect101(x - r + i, W)) * C + c];
        tmp[((size_t)y * W + x) * C + c] = acc;
      }
  // vertical
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
        for (int i = 0; i < k; ++i)
          acc += kern[i] * tmp[((size_t)reflect101(y - r + i, H) * W + x) * C + c];
        dst[((size_t)y * W + x) * C + c] = acc;
      }
}

// Bilinear resize with half-pixel centers (cv2 INTER_LINEAR / torch
// align_corners=False semantics), edge-clamped taps.
void resize_bilinear(const float* src, int H, int W, int C, float* dst,
                     int OH, int OW) {
  const float sy = (float)H / OH, sx = (float)W / OW;
  for (int y = 0; y < OH; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    const float wy = fy - y0;
    const int y1 = std::min(std::max(y0 + 1, 0), H - 1);
    y0 = std::min(std::max(y0, 0), H - 1);
    for (int x = 0; x < OW; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      const float wx = fx - x0;
      const int x1 = std::min(std::max(x0 + 1, 0), W - 1);
      x0 = std::min(std::max(x0, 0), W - 1);
      for (int c = 0; c < C; ++c) {
        const float v00 = src[((size_t)y0 * W + x0) * C + c];
        const float v01 = src[((size_t)y0 * W + x1) * C + c];
        const float v10 = src[((size_t)y1 * W + x0) * C + c];
        const float v11 = src[((size_t)y1 * W + x1) * C + c];
        dst[((size_t)y * OW + x) * C + c] =
            (1 - wy) * ((1 - wx) * v00 + wx * v01) +
            wy * ((1 - wx) * v10 + wx * v11);
      }
    }
  }
}

}  // namespace

extern "C" {

// Gaussian-pyramid residual detail masks (utils/utils.py:483-534 semantics).
// img: (H, W, C) f32 in [0,1]; H, W divisible by scale^levels.
// out_masks: `levels` caller-allocated buffers; level i has shape
// (H/scale^i, W/scale^i), FULL-RES FIRST (i=0).  Values in {0, 1}.
void decnet_detail_masks(const float* img, int H, int W, int C, int scale,
                         int levels, float thold, float** out_masks) {
  std::vector<float> data(img, img + (size_t)H * W * C);
  int h = H, w = W;
  for (int lvl = 0; lvl < levels; ++lvl) {
    std::vector<float> blurred((size_t)h * w * C);
    gaussian_blur(data.data(), blurred.data(), h, w, C, 3, 1.f);
    const int dh = h / scale, dw = w / scale;
    std::vector<float> down((size_t)dh * dw * C);
    resize_bilinear(blurred.data(), h, w, C, down.data(), dh, dw);
    std::vector<float> up((size_t)h * w * C);
    resize_bilinear(down.data(), dh, dw, C, up.data(), h, w);
    std::vector<float> up_blurred((size_t)h * w * C);
    gaussian_blur(up.data(), up_blurred.data(), h, w, C, 5, 1.f);

    // |residual| summed over channels, min-max normalised, thresholded.
    float* mask = out_masks[lvl];
    float lo = 1e30f, hi = -1e30f;
    for (int i = 0; i < h * w; ++i) {
      float acc = 0.f;
      for (int c = 0; c < C; ++c)
        acc += std::fabs(data[(size_t)i * C + c] - up_blurred[(size_t)i * C + c]);
      mask[i] = acc;
      lo = std::min(lo, acc);
      hi = std::max(hi, acc);
    }
    const float range = std::max(hi - lo, 1e-12f);
    for (int i = 0; i < h * w; ++i)
      mask[i] = ((mask[i] - lo) / range >= thold) ? 1.f : 0.f;

    data.swap(down);
    h = dh;
    w = dw;
  }
}

// PFM decode (utils/utils.py:281-327): returns 0 on success. Caller provides
// the file payload; header parsing is done here. out must hold h*w*(3|1).
int decnet_decode_pfm(const uint8_t* buf, int64_t len, float* out,
                      int* out_h, int* out_w, int* out_c) {
  // Parse "PF\n<w> <h>\n<scale>\n"
  if (len < 8) return -1;
  int c;
  if (buf[0] != 'P') return -1;
  if (buf[1] == 'F') c = 3;
  else if (buf[1] == 'f') c = 1;
  else return -1;
  int64_t pos = 2;
  auto skip_ws = [&]() { while (pos < len && std::isspace(buf[pos])) ++pos; };
  auto read_num = [&]() -> double {
    skip_ws();
    char* end = nullptr;
    double v = std::strtod((const char*)buf + pos, &end);
    pos = end - (const char*)buf;
    return v;
  };
  const int w = (int)read_num();
  const int h = (int)read_num();
  const double scale = read_num();
  ++pos;  // single whitespace after scale
  const int64_t need = (int64_t)h * w * c * 4;
  if (len - pos < need) return -2;
  const bool little = scale < 0;
  const uint8_t* p = buf + pos;
  // PFM stores rows bottom-to-top; flip vertically.
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = p + (size_t)(h - 1 - y) * w * c * 4;
    float* dst = out + (size_t)y * w * c;
    if (little) {
      std::memcpy(dst, row, (size_t)w * c * 4);
    } else {
      for (int i = 0; i < w * c; ++i) {
        uint8_t b[4] = {row[i * 4 + 3], row[i * 4 + 2], row[i * 4 + 1],
                        row[i * 4]};
        std::memcpy(dst + i, b, 4);
      }
    }
  }
  *out_h = h;
  *out_w = w;
  *out_c = c;
  return 0;
}

// Batched detail-mask computation across a host thread pool.
// imgs: N images of identical (H, W, C); out_masks: N*levels pointers laid
// out image-major (image 0 levels, image 1 levels, ...).
void decnet_detail_masks_batch(const float* imgs, int N, int H, int W, int C,
                               int scale, int levels, float thold,
                               float** out_masks, int num_threads) {
  if (num_threads <= 0)
    num_threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < N; i = next.fetch_add(1))
      decnet_detail_masks(imgs + (size_t)i * H * W * C, H, W, C, scale,
                          levels, thold, out_masks + (size_t)i * levels);
  };
  std::vector<std::thread> pool;
  const int n = std::min(num_threads, N);
  for (int t = 0; t < n; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
