// PNG scanline unfiltering (PNG specification, section 9: filter method 0)
// for the port's host image reader, decnet_tpu_torch/data/io.py.
//
// Sub, Average and Paeth rows depend on the previous bytes of the same row,
// so a row is undone byte by byte: too slow in Python for a 375x1242 image,
// a few milliseconds here.  Built by g++ at first use
// (decnet_tpu_torch/ops/kernels/build.py) and called through ctypes.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// raw: `rows` scanlines of 1 + `stride` bytes each, as inflated from the
// IDAT stream: the filter type, then the filtered bytes.  out: rows *
// stride bytes of unfiltered scanlines.  bpp: bytes per complete pixel,
// rounded up to 1 (the distance to the byte "a" of the specification).
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0-4 (out is then partly written).
int64_t decnet_png_unfilter(const uint8_t* raw, int64_t rows, int64_t stride,
                            int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y > 0 ? dst - stride : nullptr;
    switch (type) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) dst[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
