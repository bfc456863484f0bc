// Image decoders of the port's datasets, behind a C ABI read from Python
// through ctypes (gaussian_splatting_torch/dataio/native.py builds this file
// with g++ into the package's _build_cache/ at first use).
//
// - gs_png_unfilter: PNG row unfiltering (None, Sub, Up, Average, Paeth) of
//   the inflated IDAT stream; dataio/png.py parses the chunks, inflates with
//   zlib and expands the samples.
// - gs_jpeg_header / gs_jpeg_decode: a baseline and extended-sequential
//   Huffman JPEG decoder for 8-bit samples (SOF0/SOF1; DQT with 8- and
//   16-bit tables, DHT, DRI and RSTn restarts; one grey or three YCbCr
//   components, sampling factors up to 2x2) into (H, W, 3) RGB.  It follows
//   libjpeg-turbo's defaults, which OpenCV's cv2.imread decodes with: the
//   ISLOW integer IDCT (jidctint.c), "fancy" triangular chroma upsampling
//   (jdsample.c) and the fixed-point YCbCr->RGB tables (jdcolor.c).  The
//   EXIF orientation tag (APP1, 0x0112) is returned by gs_jpeg_header and
//   applied by dataio/jpeg.py.
//
// Every entry point returns 0 on success, else nonzero with a message in
// the caller's err buffer; a truncated or corrupt file is an error, never a
// partial image.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

int fail(char* err, int64_t errlen, const char* msg) {
  if (err != nullptr && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
  return 1;
}

// ---------------------------------------------------------------- PNG

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// ---------------------------------------------------------------- JPEG

// zigzag index -> natural (row-major) index of an 8x8 block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer than kLookBits
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // symbol index of a code = code + valoffset[len]
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, static_cast<size_t>(n));
    std::memset(look_len, 0, sizeof(look_len));
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) throw DecodeError("bad Huffman table");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = static_cast<uint8_t>(len);
            look_val[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// Bits of one entropy-coded segment: 0xFF00 is a data byte 0xFF; reading
// stops at any other marker and the reader is then fed zero bits, counted in
// `padded`, so consuming one of them means the data ended early.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;
  int nbits = 0;
  int padded = 0;
  bool at_marker = false;

  void reset(const uint8_t* pos, const uint8_t* stop) {
    p = pos;
    end = stop;
    acc = 0;
    nbits = 0;
    padded = 0;
    at_marker = false;
  }

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // p stays on the marker
            byte = 0;
            padded += 8;
          }
        } else {
          ++p;
        }
      } else {
        padded += 8;
      }
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  void consume(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < padded)
      throw DecodeError("entropy-coded data ends early (truncated or corrupt file)");
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = static_cast<int>(acc >> (64 - n));
    consume(n);
    return v;
  }

  int decode(const Huffman& h) {
    if (nbits < 16) fill();
    uint32_t look = static_cast<uint32_t>(acc >> (64 - kLookBits));
    if (h.look_len[look]) {
      int v = h.look_val[look];
      consume(h.look_len[look]);
      return v;
    }
    uint32_t code16 = static_cast<uint32_t>(acc >> 48);
    for (int len = kLookBits + 1; len <= 16; ++len) {
      int32_t code = static_cast<int32_t>(code16 >> (16 - len));
      if (code <= h.maxcode[len]) {
        consume(len);
        return h.vals[h.valoffset[len] + code];
      }
    }
    throw DecodeError("bad Huffman code (corrupt file)");
  }
};

// the signed value of the s-bit magnitude category v (s = 0: a zero diff)
inline int extend(int v, int s) {
  if (s == 0) return 0;
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// libjpeg-turbo's IDCT output range limit (jdmaster.c
// prepare_range_limit_table): index (x & 1023) of a descaled value x
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) idct[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) idct[i] = 255;
      else if (i < 896) idct[i] = 0;
      else idct[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

// jdcolor.c's YCbCr->RGB tables: SCALEBITS 16, rounded with ONE_HALF
struct ColourTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColourTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const ColourTables kColour;

inline uint8_t clamp255(int x) { return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x)); }

// jidctint.c, jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// One 1-D pass of the ISLOW IDCT over in[0], in[s], ..., in[7s]; writes the
// 8 outputs descaled by `shift` through `store`.
template <typename Store>
inline void idct_1d(const int64_t* in, int s, int shift, Store store) {
  int64_t z2 = in[2 * s], z3 = in[6 * s];
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
  int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  z2 = in[0];
  z3 = in[4 * s];
  int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
  int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  tmp0 = in[7 * s];
  tmp1 = in[5 * s];
  tmp2 = in[3 * s];
  tmp3 = in[1 * s];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 *= -FIX_1_961570560;
  z4 *= -FIX_0_390180644;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;

  store(0, descale(tmp10 + tmp3, shift));
  store(7, descale(tmp10 - tmp3, shift));
  store(1, descale(tmp11 + tmp2, shift));
  store(6, descale(tmp11 - tmp2, shift));
  store(2, descale(tmp12 + tmp1, shift));
  store(5, descale(tmp12 - tmp1, shift));
  store(3, descale(tmp13 + tmp0, shift));
  store(4, descale(tmp13 - tmp0, shift));
}

// coef: 64 quantised coefficients in natural order; q: the quantisation
// table in natural order; out: 8 rows of 8 samples, `stride` apart
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int64_t stride) {
  int64_t ws[64];
  int64_t col[8];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    for (int r = 0; r < 8; ++r) {
      // ISLOW_MULT_TYPE is a short in libjpeg-turbo's SIMD builds
      col[r] = static_cast<int64_t>(coef[r * 8 + c]) * static_cast<int16_t>(q[r * 8 + c]);
    }
    idct_1d(col, 1, kConstBits - kPass1Bits,
            [&](int r, int64_t v) { ws[r * 8 + c] = static_cast<int32_t>(v); });
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    uint8_t* o = out + r * stride;
    idct_1d(ws + r * 8, 1, kConstBits + kPass1Bits + 3,
            [&](int c, int64_t v) { o[c] = kRange.idct[static_cast<int>(v) & 1023]; });
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;      // Huffman tables of the current scan
  int width = 0, height = 0;  // downsampled size (libjpeg's downsampled_width/height)
  int bw = 0, bh = 0;      // blocks across and down in the plane
  int64_t stride = 0;
  std::vector<uint8_t> plane;
  int dc_pred = 0;
  bool decoded = false;
};

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  int orientation = 1;
  bool have_frame = false, saw_jfif = false, saw_adobe = false, saw_eoi = false;
  int adobe_transform = -1;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) throw DecodeError("file ends inside a marker segment (truncated file)");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // the next marker code, skipping 0xFF fill bytes
  int next_marker() {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;  // bytes before a marker
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) throw DecodeError("no EOI marker (truncated file)");
      int m = data[pos++];
      if (m != 0) return m;  // 0xFF00 is a stuffed data byte, not a marker
    }
  }

  void parse_app(int marker, size_t seg_end) {
    size_t n = seg_end - pos;
    const uint8_t* s = data + pos;
    if (marker == 0xE0 && n >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = s[11];
    }
    if (marker == 0xE1 && n >= 14 && std::memcmp(s, "Exif\0\0", 6) == 0) parse_exif(s + 6, n - 6);
  }

  // the orientation tag (0x0112) of IFD0 of an EXIF block
  void parse_exif(const uint8_t* t, size_t n) {
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto r16 = [&](size_t o) -> uint32_t {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](size_t o) -> uint32_t {
      return le ? (r16(o) | (r16(o + 2) << 16)) : ((r16(o) << 16) | r16(o + 2));
    };
    if (r16(2) != 42) return;
    size_t ifd = r32(4);
    if (ifd + 2 > n) return;
    uint32_t count = r16(ifd);
    for (uint32_t i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
      if (e + 12 > n) return;
      if (r16(e) == 0x0112 && r16(e + 2) == 3) {  // SHORT
        uint32_t o = r16(e + 8);
        orientation = (o >= 1 && o <= 8) ? static_cast<int>(o) : 1;
        return;
      }
    }
  }

  void parse_dqt(size_t seg_end) {
    while (pos < seg_end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw DecodeError("bad DQT table");
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
  }

  void parse_dht(size_t seg_end) {
    while (pos < seg_end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw DecodeError("bad DHT table");
      uint8_t counts[16], symbols[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = static_cast<uint8_t>(u8());
      if (total > 256) throw DecodeError("bad DHT table");
      for (int i = 0; i < total; ++i) symbols[i] = static_cast<uint8_t>(u8());
      (tc ? ac[th] : dc[th]).build(counts, symbols, total);
    }
  }

  void parse_sof(int marker) {
    if (have_frame) throw DecodeError("more than one frame");
    int precision = u8();
    if (precision != 8) {
      throw DecodeError(std::to_string(precision) +
                        "-bit samples are not supported (8-bit baseline and extended "
                        "sequential only)");
    }
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) throw DecodeError("image height 0 (a DNL marker) is not supported");
    if (width == 0) throw DecodeError("image width 0");
    if (ncomp == 4) throw DecodeError("CMYK (4-component) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
      throw DecodeError(std::to_string(ncomp) + "-component JPEG is not supported");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        throw DecodeError("sampling factors above 2x2 are not supported");
      if (c.tq > 3) throw DecodeError("bad quantisation table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (ncomp == 1) {  // a single component is never interleaved
      comp[0].h = comp[0].v = hmax = vmax = 1;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.width = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.stride = static_cast<int64_t>(c.bw) * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.bh * 8, 0);
    }
    have_frame = true;
    (void)marker;
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64] = {0};
    int s = br.decode(dc[c.td]);
    if (s > 11) throw DecodeError("bad DC coefficient size (corrupt file)");
    c.dc_pred += extend(br.bits(s), s);
    coef[0] = static_cast<int16_t>(c.dc_pred);
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = br.decode(h);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw DecodeError("AC run past the end of a block (corrupt file)");
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;  // end of block
      }
    }
    idct_islow(coef, qt[c.tq], c.plane.data() + static_cast<int64_t>(by) * 8 * c.stride + bx * 8,
               c.stride);
  }

  void parse_sos(size_t seg_end) {
    if (!have_frame) throw DecodeError("SOS before the frame header");
    int ns = u8();
    if (ns < 1 || ns > ncomp) throw DecodeError("bad SOS component count");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (c == nullptr) throw DecodeError("SOS names an unknown component");
      if (c->decoded) throw DecodeError("a component in two scans (not a sequential JPEG)");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        throw DecodeError("SOS names an undefined Huffman table");
      if (!qt_defined[c->tq]) throw DecodeError("component's quantisation table undefined");
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) throw DecodeError("bad spectral selection for a sequential scan");
    pos = seg_end;

    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    BitReader br;
    br.reset(data + pos, data + size);
    // a scan of one component codes its blocks one by one over the
    // component's own size; a scan of several codes MCUs of h x v blocks
    int64_t units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->width + 7) / 8;
      units_y = (sc[0]->height + 7) / 8;
    } else {
      units_x = (width + 8 * hmax - 1) / (8 * hmax);
      units_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int64_t total = units_x * units_y;
    int togo = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && togo == 0) {
        // byte-align, then the RSTn marker, then fresh predictors
        const uint8_t* q = br.p;
        while (q + 1 < data + size && q[0] == 0xFF && q[1] == 0xFF) ++q;  // fill bytes
        if (q + 1 >= data + size || q[0] != 0xFF || q[1] != (0xD0 + next_rst))
          throw DecodeError("expected a restart marker (corrupt or truncated file)");
        br.reset(q + 2, data + size);
        next_rst = (next_rst + 1) & 7;
        togo = restart_interval;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
      }
      int64_t mx = m % units_x, my = m / units_x;
      if (ns == 1) {
        decode_block(br, *sc[0], static_cast<int>(mx), static_cast<int>(my));
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx)
              decode_block(br, c, static_cast<int>(mx * c.h + xx), static_cast<int>(my * c.v + yy));
        }
      }
      if (restart_interval) --togo;
    }
    for (int i = 0; i < ns; ++i) sc[i]->decoded = true;
    pos = static_cast<size_t>(br.p - data);  // at the marker that ends the scan
  }

  // SOI, then marker segments until the first SOS (header only) or EOI
  void parse(bool header_only) {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) throw DecodeError("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {
        saw_eoi = true;
        break;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray restart marker
      if (m == 0x01) continue;                // TEM
      int len = u16();
      if (len < 2 || pos + len - 2 > size) throw DecodeError("marker segment runs past the end (truncated file)");
      size_t seg_end = pos + len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
          parse_sof(m);
          break;
        case 0xC2:
          throw DecodeError("progressive JPEG (SOF2) is not supported");
        case 0xC3:
          throw DecodeError("lossless JPEG (SOF3) is not supported");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          throw DecodeError("hierarchical JPEG (SOF5-SOF7) is not supported");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          throw DecodeError("arithmetic-coded JPEG (SOF9-SOF15) is not supported");
        case 0xCC:
          throw DecodeError("arithmetic coding (DAC) is not supported");
        case 0xC4:
          parse_dht(seg_end);
          break;
        case 0xDB:
          parse_dqt(seg_end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDC:
          throw DecodeError("DNL marker is not supported");
        case 0xDA:
          if (header_only) {
            check_colour();
            return;
          }
          check_colour();
          parse_sos(seg_end);
          continue;  // pos is at the marker after the scan
        default:
          if (m >= 0xE0 && m <= 0xEF) parse_app(m, seg_end);
          break;  // COM and others: skipped
      }
      pos = seg_end;
    }
    if (header_only) throw DecodeError("no scan before EOI");
  }

  void check_colour() {
    if (!have_frame) throw DecodeError("SOS before the frame header");
    if (ncomp != 3) return;
    // libjpeg's default_decompress_parms: the colour space of 3 components
    bool rgb = false;
    if (!saw_jfif && saw_adobe) rgb = adobe_transform == 0;
    else if (!saw_jfif && comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') rgb = true;
    if (rgb) throw DecodeError("RGB-coded JPEG (Adobe transform 0) is not supported");
  }

  // upsample component c to width x height into out (jdsample.c's methods)
  void upsample(const Component& c, uint8_t* out) const {
    int hr = hmax / c.h, vr = vmax / c.v;
    const int cw = c.width, ch = c.height;
    auto row = [&](int y) { return c.plane.data() + static_cast<int64_t>(y) * c.stride; };
    std::vector<uint8_t> tmp(static_cast<size_t>(2 * cw + 2));
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + static_cast<int64_t>(y) * width;
      int iy = y / vr;
      if (hr == 1 && vr == 1) {
        std::memcpy(o, row(y), static_cast<size_t>(width));
      } else if (hr == 2 && vr == 1) {
        const uint8_t* in = row(iy);
        if (cw > 2) {  // h2v1_fancy_upsample
          tmp[0] = in[0];
          tmp[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
          for (int j = 1; j < cw - 1; ++j) {
            int v = in[j] * 3;
            tmp[2 * j] = static_cast<uint8_t>((v + in[j - 1] + 1) >> 2);
            tmp[2 * j + 1] = static_cast<uint8_t>((v + in[j + 1] + 2) >> 2);
          }
          tmp[2 * cw - 2] = static_cast<uint8_t>((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
          tmp[2 * cw - 1] = in[cw - 1];
        } else {
          for (int j = 0; j < cw; ++j) tmp[2 * j] = tmp[2 * j + 1] = in[j];
        }
        std::memcpy(o, tmp.data(), static_cast<size_t>(width));
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        bool below = y & 1;
        const uint8_t* in0 = row(iy);
        const uint8_t* in1 = row(below ? std::min(iy + 1, ch - 1) : std::max(iy - 1, 0));
        int bias = below ? 2 : 1;
        for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else if (hr == 2 && vr == 2) {
        const uint8_t* in0 = row(iy);
        if (cw > 2) {  // h2v2_fancy_upsample
          bool below = y & 1;
          const uint8_t* in1 = row(below ? std::min(iy + 1, ch - 1) : std::max(iy - 1, 0));
          int last = in0[0] * 3 + in1[0];
          int cur = last;
          int next = in0[1] * 3 + in1[1];
          tmp[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
          tmp[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
          last = cur;
          cur = next;
          for (int j = 1; j < cw - 1; ++j) {
            next = in0[j + 1] * 3 + in1[j + 1];
            tmp[2 * j] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
            tmp[2 * j + 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
            last = cur;
            cur = next;
          }
          tmp[2 * cw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
          tmp[2 * cw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
        } else {
          for (int j = 0; j < cw; ++j) tmp[2 * j] = tmp[2 * j + 1] = in0[j];
        }
        std::memcpy(o, tmp.data(), static_cast<size_t>(width));
      } else {
        throw DecodeError("unsupported sampling ratio");
      }
    }
  }

  void to_rgb(uint8_t* out) const {
    const size_t n = static_cast<size_t>(width) * height;
    if (ncomp == 1) {
      std::vector<uint8_t> y(n);
      upsample(comp[0], y.data());
      for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    std::vector<uint8_t> p[3];
    for (int i = 0; i < 3; ++i) {
      p[i].resize(n);
      upsample(comp[i], p[i].data());
    }
    const ColourTables& t = kColour;
    for (size_t i = 0; i < n; ++i) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      out[3 * i] = clamp255(y + t.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
  }

  void finish() {
    if (!saw_eoi) throw DecodeError("no EOI marker (truncated file)");
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].decoded) throw DecodeError("a component has no scan (truncated file)");
  }
};

}  // namespace

extern "C" {

// in: height rows of (filter byte, row_bytes bytes); out: height x row_bytes
// unfiltered bytes; bpp: bytes per complete pixel (at least 1)
int gs_png_unfilter(const void* in_, int64_t height, int64_t row_bytes, int64_t bpp, void* out_,
                    char* err, int64_t errlen) {
  const uint8_t* in = static_cast<const uint8_t*>(in_);
  uint8_t* out = static_cast<uint8_t*>(out_);
  std::vector<uint8_t> zero(static_cast<size_t>(row_bytes), 0);
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (row_bytes + 1);
    int filter = *src++;
    uint8_t* dst = out + y * row_bytes;
    const uint8_t* up = y ? dst - row_bytes : zero.data();
    int64_t b = std::min(bpp, row_bytes);
    switch (filter) {
      case 0:
        std::memcpy(dst, src, static_cast<size_t>(row_bytes));
        break;
      case 1:
        for (int64_t x = 0; x < b; ++x) dst[x] = src[x];
        for (int64_t x = b; x < row_bytes; ++x) dst[x] = static_cast<uint8_t>(src[x] + dst[x - bpp]);
        break;
      case 2:
        for (int64_t x = 0; x < row_bytes; ++x) dst[x] = static_cast<uint8_t>(src[x] + up[x]);
        break;
      case 3:
        for (int64_t x = 0; x < b; ++x) dst[x] = static_cast<uint8_t>(src[x] + (up[x] >> 1));
        for (int64_t x = b; x < row_bytes; ++x)
          dst[x] = static_cast<uint8_t>(src[x] + ((dst[x - bpp] + up[x]) >> 1));
        break;
      case 4:
        for (int64_t x = 0; x < b; ++x) dst[x] = static_cast<uint8_t>(src[x] + up[x]);
        for (int64_t x = b; x < row_bytes; ++x)
          dst[x] = static_cast<uint8_t>(src[x] + paeth(dst[x - bpp], up[x], up[x - bpp]));
        break;
      default: {
        char msg[96];
        std::snprintf(msg, sizeof(msg), "row %lld has filter type %d (not 0-4)",
                      static_cast<long long>(y), filter);
        return fail(err, errlen, msg);
      }
    }
  }
  return 0;
}

// info: width, height, components, EXIF orientation (1-8)
int gs_jpeg_header(const void* data, int64_t size, int32_t* info, char* err, int64_t errlen) {
  try {
    Jpeg j(static_cast<const uint8_t*>(data), static_cast<size_t>(size));
    j.parse(true);
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    info[3] = j.orientation;
    return 0;
  } catch (const std::exception& e) {
    return fail(err, errlen, e.what());
  }
}

// out: height x width x 3 RGB, as stored (the orientation is not applied)
int gs_jpeg_decode(const void* data, int64_t size, void* out, char* err, int64_t errlen) {
  try {
    Jpeg j(static_cast<const uint8_t*>(data), static_cast<size_t>(size));
    j.parse(false);
    j.finish();
    j.to_rgb(static_cast<uint8_t*>(out));
    return 0;
  } catch (const std::exception& e) {
    return fail(err, errlen, e.what());
  }
}

}  // extern "C"
