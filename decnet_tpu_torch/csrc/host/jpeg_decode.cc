// Baseline JPEG decoding for the port's host image reader,
// decnet_tpu_torch/data/io.py::read_jpeg.  Built by g++ at first use
// (decnet_tpu_torch/ops/kernels/build.py) and called through ctypes.
//
// Decodes SOF0 and SOF1 frames of 8-bit samples with 1 (gray) or 3 (YCbCr)
// components, Huffman-coded, interleaved or not, with restart intervals.
// Its output equals libjpeg-turbo's under its default decompression
// settings (what cv2.imread reads), pixel for pixel:
//   * the ISLOW integer inverse DCT of jidctint.c, with the wrap-around
//     range limit of jdmaster.c's post-IDCT table;
//   * fancy upsampling (jdsample.c): the h2v1 and h2v2 triangle filters
//     with their rounding biases (1/2 and 8/7, alternating by output
//     column), h1v2 with biases 1 and 2 by output row, box replication for
//     every other integral factor (and for h2v1/h2v2 planes at most 2
//     samples wide).  The planes are edge-replicated at their own
//     (downsampled) size before upsampling, as jdmainct.c's context rows
//     and the filters' end columns are;
//   * the fixed-point YCbCr->RGB tables of jdcolor.c (16 fraction bits).
// Refused, each with its own return code and message: progressive,
// arithmetic-coded, lossless, hierarchical and 12-bit frames, CMYK and
// other component counts, RGB-coded colour (Adobe transform 0 or 'R','G',
// 'B' component ids), and an EXIF orientation other than 1 (cv2.imread
// would rotate the pixels).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

enum Rc { kOk = 0, kUnsupported = 1, kCorrupt = 2, kSmallBuffer = 3 };

struct Error {
  int rc;
  char msg[200];
};

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a run past the end of a corrupt block, as
    // libjpeg's jpeg_natural_order has them
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // lookup[code of 16 bits, MSB first] = (length << 8) | value; 0 = no code
  std::vector<uint16_t> lookup;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;              // the current scan's tables
  int bw = 0, bh = 0;              // blocks of the MCU-padded plane
  int dw = 0, dh = 0;              // the downsampled size
  int pred = 0;
  std::vector<uint8_t> plane;      // bw*8 x bh*8 samples
};

struct Decoder {
  Decoder(const uint8_t* d, int64_t size, Error* e)
      : data(d), n(size), err(e) {}

  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  Error* err;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  // bit reader
  uint64_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;

  bool fail(int rc, const char* fmt, int a = 0, int b = 0) {
    err->rc = rc;
    snprintf(err->msg, sizeof(err->msg), fmt, a, b);
    return false;
  }

  int u16(int64_t p) const { return (data[p] << 8) | data[p + 1]; }

  // -- markers -----------------------------------------------------------

  bool segment(int64_t* len) {
    if (pos + 2 > n) return fail(kCorrupt, "truncated marker segment");
    *len = u16(pos);
    if (*len < 2 || pos + *len > n)
      return fail(kCorrupt, "marker segment of length %d past the end",
                  static_cast<int>(*len));
    return true;
  }

  bool read_dqt(int64_t end) {
    int64_t p = pos + 2;
    while (p < end) {
      const int pq = data[p] >> 4, tq = data[p] & 15;
      ++p;
      if (tq > 3) return fail(kCorrupt, "DQT table %d", tq);
      const int size = pq ? 128 : 64;
      if (p + size > end) return fail(kCorrupt, "truncated DQT");
      for (int k = 0; k < 64; ++k)
        qt[tq][kZigzag[k]] = pq ? u16(p + 2 * k) : data[p + k];
      qt_defined[tq] = true;
      p += size;
    }
    return true;
  }

  bool read_dht(int64_t end) {
    int64_t p = pos + 2;
    while (p < end) {
      if (p + 17 > end) return fail(kCorrupt, "truncated DHT");
      const int tc = data[p] >> 4, th = data[p] & 15;
      if (tc > 1 || th > 3) return fail(kCorrupt, "DHT class %d id %d", tc, th);
      int counts[17], total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = data[p + l];
      p += 17;
      if (total > 256 || p + total > end)
        return fail(kCorrupt, "DHT with %d codes", total);
      Huffman& t = tc ? ac[th] : dc[th];
      t.lookup.assign(1 << 16, 0);
      int code = 0, k = 0;
      for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < counts[l]; ++i, ++k) {
          if (code >= (1 << l)) return fail(kCorrupt, "bad Huffman table");
          const int shift = 16 - l;
          const uint16_t entry = static_cast<uint16_t>((l << 8) | data[p + k]);
          for (int j = 0; j < (1 << shift); ++j)
            t.lookup[(code << shift) | j] = entry;
          ++code;
        }
        code <<= 1;
      }
      t.defined = true;
      p += total;
    }
    return true;
  }

  bool read_sof(int64_t end) {
    if (frame) return fail(kCorrupt, "two frame headers");
    const int64_t p = pos + 2;
    if (p + 6 > end) return fail(kCorrupt, "truncated SOF");
    const int precision = data[p];
    height = u16(p + 1);
    width = u16(p + 3);
    const int nc = data[p + 5];
    if (precision != 8)
      return fail(kUnsupported, "%d-bit samples (only 8-bit JPEG is "
                  "decoded)", precision);
    if (nc == 4)
      return fail(kUnsupported, "a CMYK/YCCK JPEG (4 components)");
    if (nc != 1 && nc != 3)
      return fail(kUnsupported, "a JPEG of %d components", nc);
    if (height == 0)
      return fail(kUnsupported, "a JPEG whose height comes in a DNL "
                  "marker");
    if (width == 0) return fail(kCorrupt, "a JPEG of width 0");
    if (p + 6 + 3 * nc > end) return fail(kCorrupt, "truncated SOF");
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = data[p + 6 + 3 * i];
      c.h = data[p + 7 + 3 * i] >> 4;
      c.v = data[p + 7 + 3 * i] & 15;
      c.tq = data[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return fail(kCorrupt, "component sampling %d or table %d",
                    c.h * 16 + c.v, c.tq);
      if (nc == 1) c.h = c.v = 1;   // a lone component is never subsampled
    }
    hmax = vmax = 1;
    for (const Component& c : comps) {
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.plane.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    frame = true;
    return true;
  }

  void read_app(int marker, int64_t end) {
    const int64_t p = pos + 2;
    const int64_t len = end - p;
    if (marker == 0xE0 && len >= 5 && !memcmp(data + p, "JFIF\0", 5))
      jfif = true;
    if (marker == 0xEE && len >= 12 && !memcmp(data + p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = data[p + 11];
    }
    if (marker == 0xE1 && len >= 14 && !memcmp(data + p, "Exif\0\0", 6))
      read_exif(p + 6, end);
  }

  // The orientation tag (0x0112) of IFD0 of the EXIF block's TIFF header.
  void read_exif(int64_t t, int64_t end) {
    if (t + 8 > end) return;
    const bool le = data[t] == 'I';
    auto rd16 = [&](int64_t q) {
      return le ? data[q] | (data[q + 1] << 8) : (data[q] << 8) | data[q + 1];
    };
    auto rd32 = [&](int64_t q) {
      return le ? static_cast<uint32_t>(rd16(q) | (rd16(q + 2) << 16))
                : static_cast<uint32_t>((rd16(q) << 16) | rd16(q + 2));
    };
    if (rd16(t + 2) != 42) return;
    const int64_t ifd = t + rd32(t + 4);
    if (ifd + 2 > end) return;
    const int count = rd16(ifd);
    for (int i = 0; i < count; ++i) {
      const int64_t e = ifd + 2 + 12 * i;
      if (e + 12 > end) return;
      if (rd16(e) == 0x0112) {
        orientation = rd16(e + 8);
        return;
      }
    }
  }

  // -- entropy decoding ----------------------------------------------------

  void reset_bits() {
    bits = 0;
    nbits = 0;
    hit_marker = false;
  }

  // Keeps at least 32 bits buffered.  At a marker no more bytes are read
  // and zeros are fed, as libjpeg does.
  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!hit_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          const int next = pos + 1 < n ? data[pos + 1] : -1;
          if (next == 0) {
            pos += 2;
          } else {
            hit_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      bits |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  int get(int s) {
    if (s == 0) return 0;
    fill();
    const int v = static_cast<int>(bits >> (64 - s));
    bits <<= s;
    nbits -= s;
    return v;
  }

  bool decode(const Huffman& t, int* value) {
    fill();
    const uint16_t entry = t.lookup[bits >> 48];
    if (!entry) return fail(kCorrupt, "bad Huffman code");
    const int len = entry >> 8;
    bits <<= len;
    nbits -= len;
    *value = entry & 255;
    return true;
  }

  static int extend(int x, int s) {
    return x < (1 << (s - 1)) ? x + 1 - (1 << s) : x;
  }

  bool decode_block(Component& c, int bx, int by) {
    int16_t coef[64] = {0};
    int t;
    if (!decode(dc[c.td], &t)) return false;
    if (t > 16) return fail(kCorrupt, "DC magnitude %d", t);
    const int diff = t ? extend(get(t), t) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs;
      if (!decode(ac[c.ta], &rs)) return false;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kZigzag[k]] = static_cast<int16_t>(extend(get(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(coef, qt[c.tq], c.plane.data() +
               (static_cast<size_t>(by) * 8 * c.bw + bx) * 8, c.bw * 8);
    return true;
  }

  // jidctint.c's jpeg_idct_islow.
  static inline uint8_t range_limit(int64_t x) {
    // jdmaster.c's post-IDCT table: the index is masked to 10 bits, so x
    // wraps into [-512, 511] before the clamp of x + 128 to [0, 255]
    const int w = static_cast<int>(((x + 512) & 1023) - 512) + 128;
    return static_cast<uint8_t>(w < 0 ? 0 : (w > 255 ? 255 : w));
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    const int CB = 13, P1 = 2;
    auto descale = [](int64_t x, int n) {
      return (x + (int64_t{1} << (n - 1))) >> n;
    };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      auto dq = [&](int r) {
        return static_cast<int64_t>(ip[8 * r]) * static_cast<int64_t>(qp[8 * r]);
      };
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        const int dcval = static_cast<int>(dq(0) * (1 << P1));
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = dq(2), z3 = dq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = dq(0);
      z3 = dq(4);
      int64_t tmp0 = (z2 + z3) * (int64_t{1} << CB);
      int64_t tmp1 = (z2 - z3) * (int64_t{1} << CB);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = dq(7);
      tmp1 = dq(5);
      tmp2 = dq(3);
      tmp3 = dq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, CB - P1));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, CB - P1));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, CB - P1));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, CB - P1));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, CB - P1));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, CB - P1));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, CB - P1));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, CB - P1));
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + r * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        const uint8_t v = range_limit(descale(wp[0], P1 + 3));
        for (int i = 0; i < 8; ++i) op[i] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (int64_t{1} << CB);
      int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (int64_t{1} << CB);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      op[0] = range_limit(descale(tmp10 + tmp3, sh));
      op[7] = range_limit(descale(tmp10 - tmp3, sh));
      op[1] = range_limit(descale(tmp11 + tmp2, sh));
      op[6] = range_limit(descale(tmp11 - tmp2, sh));
      op[2] = range_limit(descale(tmp12 + tmp1, sh));
      op[5] = range_limit(descale(tmp12 - tmp1, sh));
      op[3] = range_limit(descale(tmp13 + tmp0, sh));
      op[4] = range_limit(descale(tmp13 - tmp0, sh));
    }
  }

  // Drops the bits left, consumes the RSTn marker and resets the DC
  // predictors (libjpeg's process_restart).
  bool restart_marker() {
    reset_bits();
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
                            data[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 >= n) return fail(kCorrupt, "missing restart marker");
    pos += 2;
    for (Component& c : comps) c.pred = 0;
    return true;
  }

  bool read_scan(int64_t end) {
    if (!frame) return fail(kCorrupt, "scan before the frame header");
    int64_t p = pos + 2;
    const int ns = data[p++];
    if (ns < 1 || ns > 4 || p + 2 * ns + 3 > end)
      return fail(kCorrupt, "scan of %d components", ns);
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i, p += 2) {
      Component* found = nullptr;
      for (Component& c : comps)
        if (c.id == data[p]) found = &c;
      if (!found) return fail(kCorrupt, "scan names component %d", data[p]);
      found->td = data[p + 1] >> 4;
      found->ta = data[p + 1] & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        return fail(kCorrupt, "scan uses undefined Huffman table %d/%d",
                    found->td, found->ta);
      if (!qt_defined[found->tq])
        return fail(kCorrupt, "undefined quantisation table %d", found->tq);
      sc.push_back(found);
    }
    if (data[p] != 0 || data[p + 1] != 63 || data[p + 2] != 0)
      return fail(kUnsupported, "a progressive scan (Ss %d, Se %d)", data[p],
                  data[p + 1]);
    pos = end;
    reset_bits();
    for (Component& c : comps) c.pred = 0;
    int mcux, mcuy;
    if (ns == 1) {
      mcux = (sc[0]->dw + 7) / 8;
      mcuy = (sc[0]->dh + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int todo = restart;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart && todo == 0) {
          if (!restart_marker()) return false;
          todo = restart;
        }
        if (ns == 1) {
          if (!decode_block(*sc[0], mx, my)) return false;
        } else {
          for (Component* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x)
                if (!decode_block(*c, mx * c->h + x, my * c->v + y))
                  return false;
        }
        --todo;
      }
    }
    // skip to the next marker
    reset_bits();
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      ++pos;
    return true;
  }

  bool parse(bool decode_scans) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      return fail(kCorrupt, "not a JPEG file (no SOI marker)");
    pos = 2;
    bool scanned = false;
    while (true) {
      while (pos < n && data[pos] != 0xFF) ++pos;   // garbage before a marker
      while (pos < n && data[pos] == 0xFF) ++pos;   // fill bytes
      if (pos >= n) {
        if (scanned) return true;   // a missing EOI, as libjpeg tolerates
        return fail(kCorrupt, "truncated JPEG (no scan)");
      }
      const int marker = data[pos++];
      if (marker == 0xD9) {
        if (!scanned) return fail(kCorrupt, "EOI before any scan");
        return true;
      }
      if (marker >= 0xD0 && marker <= 0xD7) continue;   // stray RSTn
      if (marker == 0x01) continue;                       // TEM
      int64_t len;
      if (!segment(&len)) return false;
      const int64_t end = pos + len;
      switch (marker) {
        case 0xC0:
        case 0xC1:
          if (!read_sof(end)) return false;
          if (!check_colour()) return false;
          if (!decode_scans) return true;
          break;
        case 0xC2:
        case 0xC6:
          return fail(kUnsupported, "a progressive JPEG (SOF%d)",
                      marker - 0xC0);
        case 0xC3:
        case 0xC7:
          return fail(kUnsupported, "a lossless JPEG (SOF%d)", marker - 0xC0);
        case 0xC5:
          return fail(kUnsupported, "a hierarchical JPEG (SOF%d)",
                      marker - 0xC0);
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
          return fail(kUnsupported, "an arithmetic-coded JPEG (marker 0x%X)",
                      marker);
        case 0xC4:
          if (!read_dht(end)) return false;
          break;
        case 0xDB:
          if (!read_dqt(end)) return false;
          break;
        case 0xDD:
          if (len < 4) return fail(kCorrupt, "short DRI");
          restart = u16(pos + 2);
          break;
        case 0xDA:
          if (!read_scan(end)) return false;
          scanned = true;
          continue;   // read_scan left pos at the next marker
        default:
          if (marker >= 0xE0 && marker <= 0xEF) read_app(marker, end);
          break;   // COM and the rest are skipped
      }
      pos = end;
    }
  }

  // libjpeg's colour-space rule for 3 components (jdapimin.c
  // default_decompress_parms), and cv2's EXIF rotation.
  bool check_colour() {
    if (comps.size() == 3 && !jfif) {
      const bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' &&
                           comps[2].id == 'B';
      if ((adobe && adobe_transform == 0) || (!adobe && rgb_ids))
        return fail(kUnsupported, "an RGB-coded JPEG (no YCbCr transform)");
    }
    if (orientation >= 2 && orientation <= 8)
      return fail(kUnsupported, "EXIF orientation %d (cv2.imread rotates "
                  "such files; only orientation 1 is read)", orientation);
    return true;
  }

  // -- upsampling and colour ----------------------------------------------

  // The component's samples at full size (width x height), from its plane
  // edge-replicated at its downsampled size (dw x dh).
  bool upsample(const Component& c, std::vector<uint8_t>* out) {
    out->assign(static_cast<size_t>(width) * height, 0);
    const int pw = c.bw * 8;
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);
      x = x < 0 ? 0 : (x >= c.dw ? c.dw - 1 : x);
      return c.plane[static_cast<size_t>(y) * pw + x];
    };
    const int fh = hmax / c.h, fv = vmax / c.v;
    if (hmax % c.h || vmax % c.v)
      return fail(kUnsupported, "fractional sampling factors %d/%d",
                  c.h * 16 + c.v, hmax * 16 + vmax);
    uint8_t* o = out->data();
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < height; ++y)
        memcpy(o + static_cast<size_t>(y) * width,
               c.plane.data() + static_cast<size_t>(y) * pw, width);
    } else if (fh == 2 && fv == 1 && c.dw > 2) {
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          const int i = x >> 1;
          const int near3 = at(y, i) * 3;
          o[static_cast<size_t>(y) * width + x] = static_cast<uint8_t>(
              x & 1 ? (near3 + at(y, i + 1) + 2) >> 2
                    : (near3 + at(y, i - 1) + 1) >> 2);
        }
    } else if (fh == 1 && fv == 2) {
      for (int y = 0; y < height; ++y) {
        const int i = y >> 1;
        const int other = y & 1 ? i + 1 : i - 1;
        const int bias = y & 1 ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[static_cast<size_t>(y) * width + x] = static_cast<uint8_t>(
              (at(i, x) * 3 + at(other, x) + bias) >> 2);
      }
    } else if (fh == 2 && fv == 2 && c.dw > 2) {
      for (int y = 0; y < height; ++y) {
        const int i = y >> 1;
        const int other = y & 1 ? i + 1 : i - 1;
        for (int x = 0; x < width; ++x) {
          const int j = x >> 1;
          const int jn = x & 1 ? j + 1 : j - 1;
          const int this_sum = at(i, j) * 3 + at(other, j);
          const int next_sum = at(i, jn) * 3 + at(other, jn);
          o[static_cast<size_t>(y) * width + x] = static_cast<uint8_t>(
              x & 1 ? (this_sum * 3 + next_sum + 7) >> 4
                    : (this_sum * 3 + next_sum + 8) >> 4);
        }
      }
    } else {
      // box replication (int_upsample, and h2v1/h2v2 of narrow planes);
      // it reads the plane as decoded, inside the downsampled size
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x)
          o[static_cast<size_t>(y) * width + x] =
              c.plane[static_cast<size_t>(y / fv) * pw + x / fh];
    }
    return true;
  }

  bool to_pixels(uint8_t* out) {
    if (comps.size() == 1) {
      const Component& c = comps[0];
      for (int y = 0; y < height; ++y)
        memcpy(out + static_cast<size_t>(y) * width,
               c.plane.data() + static_cast<size_t>(y) * c.bw * 8, width);
      return true;
    }
    std::vector<uint8_t> up[3];
    for (int i = 0; i < 3; ++i)
      if (!upsample(comps[i], &up[i])) return false;
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int64_t one_half = int64_t{1} << 15;
    auto fix = [](double x) {
      return static_cast<int64_t>(x * 65536.0 + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    const size_t np = static_cast<size_t>(width) * height;
    for (size_t i = 0; i < np; ++i) {
      const int y = up[0][i], cb = up[1][i], cr = up[2][i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
    return true;
  }
};

}  // namespace

extern "C" {

// Decodes the JPEG file `data` (n bytes).  Writes its height, width and
// channels (1 gray, 3 RGB) to *h, *w, *c; with `out` (room for `cap`
// bytes) it also writes the h x w x c pixels.  Returns 0; 1 for a file of
// a kind this decoder refuses, 2 for a corrupt file, 3 when `out` is null
// or too small (the sizes are then set); `msg` (msg_len bytes) says why.
int decnet_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                       int64_t cap, int* h, int* w, int* c, char* msg,
                       int msg_len) {
  Error err{kOk, ""};
  Decoder dec(data, n, &err);
  auto finish = [&](int rc) {
    if (msg && msg_len > 0) snprintf(msg, msg_len, "%s", err.msg);
    return rc;
  };
  if (!dec.parse(false)) return finish(err.rc);
  *h = dec.height;
  *w = dec.width;
  *c = static_cast<int>(dec.comps.size());
  const int64_t need = static_cast<int64_t>(*h) * *w * *c;
  if (!out || cap < need) {
    snprintf(err.msg, sizeof(err.msg), "output buffer too small");
    return finish(kSmallBuffer);
  }
  Decoder full(data, n, &err);
  if (!full.parse(true) || !full.to_pixels(out)) return finish(err.rc);
  return finish(kOk);
}

}  // extern "C"
