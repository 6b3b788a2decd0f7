// Baseline JFIF encoder (SOF0, Huffman, 8-bit): RGBA -> 4:2:0 YCbCr with
// the Annex-K quantization/Huffman tables and IJG quality scaling.
//
// Counterpart of the decoder in jpeg.cc (same full-range BT.601 JFIF
// color space, so encode->decode round trips within quantization loss).
// The reference has no JPEG encoder (it decodes overlays through
// CGImageSource, metaloverlayrenderer.m:180-264); this exists for the
// jpegenc sink-edge element (the GStreamer ecosystem analog).
//
// extern "C" entry: vf_jpeg_encode(rgba, w, h, quality, out, out_cap)
// returns bytes written, or -1 when out_cap is too small, -2 on bad args.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const uint8_t kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const uint8_t kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K Huffman specs (BITS[1..16], HUFFVAL).
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};

const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    std::memset(size, 0, sizeof(size));
    uint16_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len] && k < nvals; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = b;
  }

  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0x00);  // stuffing
      nbits -= 8;
    }
  }

  void flush() {
    if (nbits > 0) {
      uint8_t b = (uint8_t)((acc << (8 - nbits)) | ((1u << (8 - nbits)) - 1));
      byte(b);
      if (b == 0xFF) byte(0x00);
      nbits = 0;
    }
  }
};

int bit_size(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) { ++n; a >>= 1; }
  return n;
}

// Plain separable DCT-II with JPEG normalization (output already scaled
// for quantization).  O(8) per axis with a precomputed cosine table —
// fast enough for a host-edge encoder.
struct Dct {
  float c[8][8];
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0);
  }
  void forward(const float* in, float* out) const {
    float tmp[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        float s = 0;
        for (int x = 0; x < 8; ++x) s += in[y * 8 + x] * c[u][x];
        tmp[y * 8 + u] = s;
      }
    for (int u = 0; u < 8; ++u)
      for (int v = 0; v < 8; ++v) {
        float s = 0;
        for (int y = 0; y < 8; ++y) s += tmp[y * 8 + u] * c[v][y];
        float cu = u == 0 ? 0.70710678f : 1.0f;
        float cv = v == 0 ? 0.70710678f : 1.0f;
        out[v * 8 + u] = 0.25f * cu * cv * s;
      }
  }
};

void scale_table(const uint8_t* base, int quality, uint8_t* out) {
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int s = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int i = 0; i < 64; ++i) {
    int v = (base[i] * s + 50) / 100;
    if (v < 1) v = 1;
    if (v > 255) v = 255;
    out[i] = (uint8_t)v;
  }
}

struct Encoder {
  BitWriter w;
  HuffTable dc_l, ac_l, dc_c, ac_c;
  uint8_t ql[64], qc[64];
  Dct dct;

  void marker(uint8_t m) { w.byte(0xFF); w.byte(m); }

  void segment(uint8_t m, const uint8_t* payload, int len) {
    marker(m);
    w.byte((uint8_t)((len + 2) >> 8));
    w.byte((uint8_t)((len + 2) & 0xFF));
    for (int i = 0; i < len; ++i) w.byte(payload[i]);
  }

  void emit_dqt(int id, const uint8_t* tbl) {
    uint8_t p[65];
    p[0] = (uint8_t)id;
    for (int i = 0; i < 64; ++i) p[1 + i] = tbl[kZigzag[i]];
    segment(0xDB, p, 65);
  }

  void emit_dht(int cls, int id, const uint8_t* bits, const uint8_t* vals,
                int nvals) {
    uint8_t p[1 + 16 + 256];
    p[0] = (uint8_t)((cls << 4) | id);
    for (int i = 0; i < 16; ++i) p[1 + i] = bits[i + 1];
    for (int i = 0; i < nvals; ++i) p[17 + i] = vals[i];
    segment(0xC4, p, 17 + nvals);
  }

  // One 8x8 block: FDCT -> quantize -> Huffman.  Returns new DC pred.
  int block(const float* px, const uint8_t* qt, const HuffTable& dc,
            const HuffTable& ac, int pred) {
    float f[64];
    dct.forward(px, f);
    int16_t q[64];
    for (int i = 0; i < 64; ++i) {
      float v = f[kZigzag[i]] / qt[kZigzag[i]];
      q[i] = (int16_t)std::lround(v);
    }
    int diff = q[0] - pred;
    int n = bit_size(diff);
    w.put(dc.code[n], dc.size[n]);
    if (n) w.put(diff < 0 ? diff + ((1 << n) - 1) : diff, n);
    int run = 0;
    for (int i = 1; i < 64; ++i) {
      if (q[i] == 0) { ++run; continue; }
      while (run > 15) { w.put(ac.code[0xF0], ac.size[0xF0]); run -= 16; }
      int s = bit_size(q[i]);
      int sym = (run << 4) | s;
      w.put(ac.code[sym], ac.size[sym]);
      w.put(q[i] < 0 ? q[i] + ((1 << s) - 1) : q[i], s);
      run = 0;
    }
    if (run) w.put(ac.code[0x00], ac.size[0x00]);
    return q[0];
  }

  int64_t encode(const uint8_t* rgba, int width, int height, int quality,
                 uint8_t* out, int64_t cap) {
    w.out = out;
    w.cap = cap;
    scale_table(kLumaQ, quality, ql);
    scale_table(kChromaQ, quality, qc);
    dc_l.build(kDcLumaBits, kDcVals, 12);
    dc_c.build(kDcChromaBits, kDcVals, 12);
    ac_l.build(kAcLumaBits, kAcLumaVals, 162);
    ac_c.build(kAcChromaBits, kAcChromaVals, 162);

    // color convert + 4:2:0 subsample into padded MCU-aligned planes
    int mcu_w = (width + 15) / 16, mcu_h = (height + 15) / 16;
    int yw = mcu_w * 16, yh = mcu_h * 16;
    int cw = mcu_w * 8, ch = mcu_h * 8;
    std::vector<float> Y((size_t)yw * yh), Cb((size_t)cw * ch),
        Cr((size_t)cw * ch);
    for (int y = 0; y < yh; ++y) {
      int sy = y < height ? y : height - 1;
      for (int x = 0; x < yw; ++x) {
        int sx = x < width ? x : width - 1;
        const uint8_t* p = rgba + ((size_t)sy * width + sx) * 4;
        Y[(size_t)y * yw + x] =
            0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2] - 128.0f;
      }
    }
    for (int y = 0; y < ch; ++y) {
      for (int x = 0; x < cw; ++x) {
        float cb = 0, cr = 0;
        for (int dy = 0; dy < 2; ++dy)
          for (int dx = 0; dx < 2; ++dx) {
            int sy = 2 * y + dy, sx = 2 * x + dx;
            if (sy >= height) sy = height - 1;
            if (sx >= width) sx = width - 1;
            const uint8_t* p = rgba + ((size_t)sy * width + sx) * 4;
            cb += -0.168736f * p[0] - 0.331264f * p[1] + 0.5f * p[2];
            cr += 0.5f * p[0] - 0.418688f * p[1] - 0.081312f * p[2];
          }
        Cb[(size_t)y * cw + x] = cb * 0.25f;
        Cr[(size_t)y * cw + x] = cr * 0.25f;
      }
    }

    // headers
    marker(0xD8);  // SOI
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    segment(0xE0, jfif, 14);
    emit_dqt(0, ql);
    emit_dqt(1, qc);
    uint8_t sof[15] = {8,
                       (uint8_t)(height >> 8), (uint8_t)(height & 0xFF),
                       (uint8_t)(width >> 8),  (uint8_t)(width & 0xFF),
                       3,
                       1, 0x22, 0,   // Y: 2x2 sampling, table 0
                       2, 0x11, 1,   // Cb
                       3, 0x11, 1};  // Cr
    segment(0xC0, sof, 15);
    emit_dht(0, 0, kDcLumaBits, kDcVals, 12);
    emit_dht(1, 0, kAcLumaBits, kAcLumaVals, 162);
    emit_dht(0, 1, kDcChromaBits, kDcVals, 12);
    emit_dht(1, 1, kAcChromaBits, kAcChromaVals, 162);
    const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    segment(0xDA, sos, 10);

    // entropy-coded MCUs
    int pred_y = 0, pred_cb = 0, pred_cr = 0;
    float px[64];
    for (int my = 0; my < mcu_h; ++my) {
      for (int mx = 0; mx < mcu_w; ++mx) {
        for (int by = 0; by < 2; ++by)
          for (int bx = 0; bx < 2; ++bx) {
            int ox = mx * 16 + bx * 8, oy = my * 16 + by * 8;
            for (int y = 0; y < 8; ++y)
              for (int x = 0; x < 8; ++x)
                px[y * 8 + x] = Y[(size_t)(oy + y) * yw + ox + x];
            pred_y = block(px, ql, dc_l, ac_l, pred_y);
          }
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            px[y * 8 + x] = Cb[(size_t)(my * 8 + y) * cw + mx * 8 + x];
        pred_cb = block(px, qc, dc_c, ac_c, pred_cb);
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            px[y * 8 + x] = Cr[(size_t)(my * 8 + y) * cw + mx * 8 + x];
        pred_cr = block(px, qc, dc_c, ac_c, pred_cr);
      }
    }
    w.flush();
    marker(0xD9);  // EOI
    if (w.overflow) return -1;
    return w.pos;
  }
};

}  // namespace

extern "C" {

// RGBA (h, w, 4) -> baseline JFIF bytes.  Returns bytes written, -1 when
// out_cap is too small, -2 on bad arguments.
int64_t vf_jpeg_encode(const uint8_t* rgba, int32_t width, int32_t height,
                       int32_t quality, uint8_t* out, int64_t out_cap) {
  if (!rgba || !out || width <= 0 || height <= 0 || width > 65535 ||
      height > 65535)
    return -2;
  Encoder e;
  return e.encode(rgba, width, height, quality, out, out_cap);
}
}
