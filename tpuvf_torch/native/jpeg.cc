// JPEG decoder: baseline (SOF0), extended sequential (SOF1) and
// progressive (SOF2) Huffman, 8-bit, grayscale / YCbCr with sampling
// factors up to 2x2, restart markers.
//
// The reference decodes overlay JPEGs through CGImageSource
// (metaloverlayrenderer.m:180-264), which handles both baseline and
// progressive; this environment has no image library, so the native
// runtime ships its own.  JFIF full-range YCbCr -> RGB with the standard
// BT.601 full-range coefficients, matching CoreGraphics.
//
// Architecture: all scans decode into per-block coefficient stores
// (zigzag order, int16); after the marker loop, finish() dequantizes +
// IDCTs every block into uint8 component planes, then color-converts.
// This unifies sequential (one scan writes all coefficients) and
// progressive (many scans refine them: DC first/refine, AC first/refine
// with EOB runs per G.1.2 of T.81).
//
// Every segment parser validates its payload against the declared segment
// length and range-checks file-controlled table ids (DQT/DHT id <= 3,
// component tq/td/ta <= 3) before any array index.
//
// extern "C" entry: vf_jpeg_decode(data, len, out_rgba, w, h) with a probe
// call (out==null) to learn dimensions first.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t bits = 0;
  int count = 0;
  bool marker_hit = false;

  int next_byte() {
    if (p >= end) return -1;
    uint8_t b = *p++;
    if (b == 0xFF) {
      if (p >= end) return -1;
      uint8_t b2 = *p;
      if (b2 == 0x00) {
        ++p;  // stuffed zero
      } else {
        marker_hit = true;  // real marker: stop filling
        --p;                // leave 0xFF for the scan loop
        return -1;
      }
    }
    return b;
  }

  int get_bit() {
    if (count == 0) {
      int b = next_byte();
      if (b < 0) return 0;  // pad with zeros past the end (spec behavior)
      bits = (uint32_t)b;
      count = 8;
    }
    --count;
    return (bits >> count) & 1;
  }

  int get_bits(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | get_bit();
    return v;
  }

  void align() { count = 0; marker_hit = false; }
};

struct Huff {
  uint8_t counts[17] = {0};
  uint8_t symbols[256] = {0};
  int mincode[17], maxcode[17], valptr[17];
  bool valid = false;

  void build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l];
      k += counts[l];
      maxcode[l] = code - 1;
      code <<= 1;
    }
    valid = true;
  }

  int decode(BitReader& br) const {
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | br.get_bit();
      if (counts[l] && code <= maxcode[l]) {
        return symbols[valptr[l] + code - mincode[l]];
      }
    }
    return -1;
  }
};

int extend(int v, int n) {
  return (n && v < (1 << (n - 1))) ? v - (1 << n) + 1 : v;
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Simple separable float IDCT (exactness over speed; decode is one-time).
// `in` is natural (row-major) order, already dequantized.
void idct8x8(const int32_t* in, uint8_t* out, int stride) {
  double tmp[64];
  for (int u = 0; u < 64; ++u) tmp[u] = (double)in[u];
  double s[64];
  static double cosv[8][8];
  static bool init = false;
  if (!init) {
    for (int x = 0; x < 8; ++x)
      for (int u = 0; u < 8; ++u)
        cosv[x][u] = std::cos((2 * x + 1) * u * M_PI / 16.0) *
                     (u == 0 ? std::sqrt(0.125) : 0.5);
    init = true;
  }
  // rows
  for (int y = 0; y < 8; ++y) {
    for (int x = 0; x < 8; ++x) {
      double acc = 0;
      for (int u = 0; u < 8; ++u) acc += cosv[x][u] * tmp[y * 8 + u];
      s[y * 8 + x] = acc;
    }
  }
  for (int x = 0; x < 8; ++x) {
    for (int y = 0; y < 8; ++y) {
      double acc = 0;
      for (int v = 0; v < 8; ++v) acc += cosv[y][v] * s[v * 8 + x];
      int val = (int)std::lround(acc) + 128;
      out[y * stride + x] = (uint8_t)(val < 0 ? 0 : val > 255 ? 255 : val);
    }
  }
}

int16_t clamp16(int v) {
  return (int16_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  uint8_t* plane = nullptr;  // (rows x cols) at component resolution
  int cols = 0, rows = 0;
  int bw = 0, bh = 0;    // allocated block grid (MCU-padded)
  int nbw = 0, nbh = 0;  // non-interleaved scan block grid (image-sized)
  int16_t* coef = nullptr;  // bw*bh blocks x 64 coefficients, zigzag order
  int pred = 0;
};

struct Decoder {
  uint16_t qt[4][64] = {};  // zigzag order
  Huff hdc[4], hac[4];
  Component comp[3];
  int ncomp = 0, width = 0, height = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool progressive = false;
  bool allocated = false;
  unsigned eobrun = 0;

  ~Decoder() {
    for (auto& c : comp) {
      delete[] c.plane;
      delete[] c.coef;
    }
  }

  bool alloc_planes() {
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      comp[c].bw = mcux * comp[c].h;
      comp[c].bh = mcuy * comp[c].v;
      comp[c].cols = comp[c].bw * 8;
      comp[c].rows = comp[c].bh * 8;
      // image-sized block grid for non-interleaved scans (T.81 A.2.2)
      int cw = (width * comp[c].h + hmax - 1) / hmax;
      int ch = (height * comp[c].v + vmax - 1) / vmax;
      comp[c].nbw = (cw + 7) / 8;
      comp[c].nbh = (ch + 7) / 8;
      size_t nblocks = (size_t)comp[c].bw * comp[c].bh;
      comp[c].coef = new int16_t[nblocks * 64]();
      comp[c].plane = new uint8_t[(size_t)comp[c].cols * comp[c].rows];
      memset(comp[c].plane, 128, (size_t)comp[c].cols * comp[c].rows);
    }
    allocated = true;
    return true;
  }

  int16_t* block_at(Component& c, int bx, int by) {
    if (bx >= c.bw || by >= c.bh) return nullptr;
    return c.coef + ((size_t)by * c.bw + bx) * 64;
  }

  // --- sequential (baseline/extended): full block in one scan ---
  bool decode_block_seq(BitReader& br, Component& c, int16_t* blk) {
    const Huff& dc = hdc[c.td];
    const Huff& ac = hac[c.ta];
    if (!dc.valid || !ac.valid) return false;
    int t = dc.decode(br);
    if (t < 0 || t > 15) return false;
    int diff = extend(br.get_bits(t), t);
    c.pred += diff;
    blk[0] = clamp16(c.pred);
    for (int k = 1; k < 64;) {
      int rs = ac.decode(br);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r == 15) { k += 16; continue; }
        break;  // EOB
      }
      k += r;
      if (k > 63) return false;
      blk[k] = clamp16(extend(br.get_bits(s), s));
      ++k;
    }
    return true;
  }

  // --- progressive scan passes (T.81 G.1.2) ---
  bool decode_dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    const Huff& dc = hdc[c.td];
    if (!dc.valid) return false;
    int t = dc.decode(br);
    if (t < 0 || t > 15) return false;
    int diff = extend(br.get_bits(t), t);
    c.pred += diff;
    blk[0] = clamp16(c.pred * (1 << al));  // pred may be negative
    return true;
  }

  bool decode_dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get_bit()) blk[0] = clamp16(blk[0] | (1 << al));
    return true;
  }

  bool decode_ac_first(BitReader& br, Component& c, int16_t* blk, int ss,
                       int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return true;
    }
    const Huff& ac = hac[c.ta];
    if (!ac.valid) return false;
    int k = ss;
    while (k <= se) {
      int rs = ac.decode(br);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r < 15) {
          eobrun = (1u << r) - 1;
          if (r) eobrun += (unsigned)br.get_bits(r);
          break;
        }
        k += 16;  // ZRL
        continue;
      }
      k += r;
      if (k > 63) return false;
      blk[k] = clamp16(extend(br.get_bits(s), s) * (1 << al));
      ++k;
    }
    return true;
  }

  bool decode_ac_refine(BitReader& br, Component& c, int16_t* blk, int ss,
                        int se, int al) {
    const Huff& ac = hac[c.ta];
    if (!ac.valid) return false;
    int p1 = 1 << al;
    int m1 = -(1 << al);
    int k = ss;
    if (eobrun == 0) {
      while (k <= se) {
        int rs = ac.decode(br);
        if (rs < 0) return false;
        int r = rs >> 4, s = rs & 15;
        int newval = 0;
        if (s == 0) {
          if (r < 15) {
            eobrun = (1u << r);
            if (r) eobrun += (unsigned)br.get_bits(r);
            break;  // correction of remaining nonzeros happens below
          }
          // r == 15: skip over 16 zero-history coefficients
        } else {
          if (s != 1) return false;  // refinement magnitude must be 1
          newval = br.get_bit() ? p1 : m1;
        }
        // advance past r zero-history coefficients, applying correction
        // bits to every nonzero-history coefficient passed on the way
        while (k <= se) {
          int16_t& v = blk[k];
          if (v != 0) {
            if (br.get_bit() && (v & p1) == 0)
              v = clamp16(v + (v >= 0 ? p1 : m1));
          } else {
            if (r == 0) break;
            --r;
          }
          ++k;
        }
        if (newval && k <= se) blk[k] = (int16_t)newval;
        ++k;
      }
    }
    if (eobrun > 0) {
      // end-of-band: apply correction bits to remaining nonzero coeffs
      while (k <= se) {
        int16_t& v = blk[k];
        if (v != 0 && br.get_bit() && (v & p1) == 0)
          v = clamp16(v + (v >= 0 ? p1 : m1));
        ++k;
      }
      --eobrun;
    }
    return true;
  }

  void restart(BitReader& br) {
    br.align();
    while (br.p + 1 < br.end && br.p[0] == 0xFF && br.p[1] >= 0xD0 &&
           br.p[1] <= 0xD7)
      br.p += 2;
    for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
    eobrun = 0;
  }

  // Decode one scan's entropy data.  scomp/ns: components in this scan.
  // Returns pointer past the entropy data (at the next marker).
  const uint8_t* decode_scan(const uint8_t* start, const uint8_t* end,
                             int* scomp, int ns, int ss, int se, int ah,
                             int al) {
    BitReader br{start, end};
    eobrun = 0;
    for (int i = 0; i < ns; ++i) comp[scomp[i]].pred = 0;
    int unit = 0;
    bool bad = false;
    if (ns == 1) {
      // non-interleaved: one block per unit over the image-sized grid
      Component& c = comp[scomp[0]];
      for (int by = 0; by < c.nbh && !bad; ++by) {
        for (int bx = 0; bx < c.nbw && !bad; ++bx) {
          if (restart_interval && unit && unit % restart_interval == 0)
            restart(br);
          int16_t* blk = block_at(c, bx, by);
          if (!blk) { bad = true; break; }
          bool ok;
          if (!progressive)
            ok = decode_block_seq(br, c, blk);
          else if (ss == 0)
            ok = ah == 0 ? decode_dc_first(br, c, blk, al)
                         : decode_dc_refine(br, blk, al);
          else
            ok = ah == 0 ? decode_ac_first(br, c, blk, ss, se, al)
                         : decode_ac_refine(br, c, blk, ss, se, al);
          if (!ok) bad = true;  // truncated/corrupt: keep what we have
          ++unit;
        }
      }
    } else {
      int mcux = (width + 8 * hmax - 1) / (8 * hmax);
      int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int my = 0; my < mcuy && !bad; ++my) {
        for (int mx = 0; mx < mcux && !bad; ++mx) {
          if (restart_interval && unit && unit % restart_interval == 0)
            restart(br);
          for (int i = 0; i < ns && !bad; ++i) {
            Component& c = comp[scomp[i]];
            for (int by = 0; by < c.v && !bad; ++by) {
              for (int bx = 0; bx < c.h && !bad; ++bx) {
                int16_t* blk =
                    block_at(c, mx * c.h + bx, my * c.v + by);
                if (!blk) { bad = true; break; }
                bool ok;
                if (!progressive)
                  ok = decode_block_seq(br, c, blk);
                else  // interleaved progressive scans are DC-only
                  ok = ah == 0 ? decode_dc_first(br, c, blk, al)
                               : decode_dc_refine(br, blk, al);
                if (!ok) bad = true;
              }
            }
          }
          ++unit;
        }
      }
    }
    // skip to the next real marker (not RSTn / stuffed FF00)
    const uint8_t* p = br.p;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] != 0x00 &&
          !(p[1] >= 0xD0 && p[1] <= 0xD7))
        return p;
      ++p;
    }
    return end;
  }

  void finish_planes() {
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      const uint16_t* q = qt[c.tq];
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* blk =
              c.coef + ((size_t)by * c.bw + bx) * 64;
          int32_t nat[64];
          for (int k = 0; k < 64; ++k)
            nat[kZigzag[k]] = (int32_t)blk[k] * q[k];
          idct8x8(nat, c.plane + (size_t)by * 8 * c.cols + bx * 8,
                  c.cols);
        }
      }
    }
  }

  int decode(const uint8_t* data, size_t len, uint8_t* out_rgba,
             int* out_w, int* out_h) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return 1;  // not a JPEG
    p += 2;
    bool any_scan = false;
    while (p + 2 <= end) {
      if (p[0] != 0xFF) return 2;
      uint8_t m = p[1];
      p += 2;
      if (m == 0xD9) break;  // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (p + 2 > end) return 3;
      int seg = (p[0] << 8) | p[1];
      if (seg < 2) return 3;
      const uint8_t* sp = p + 2;
      const uint8_t* se = p + seg;
      if (se > end) return 3;
      switch (m) {
        case 0xDB:  // DQT
          while (sp < se) {
            int pq = sp[0] >> 4, tq_i = sp[0] & 15;
            if (tq_i > 3 || pq > 1) return 3;
            ++sp;
            if (sp + (pq ? 128 : 64) > se) return 3;
            for (int i = 0; i < 64; ++i) {
              int v = pq ? ((sp[0] << 8) | sp[1]) : sp[0];
              sp += pq ? 2 : 1;
              qt[tq_i][i] = (uint16_t)v;
            }
          }
          break;
        case 0xC4:  // DHT
          while (sp < se) {
            int tc = sp[0] >> 4, th = sp[0] & 15;
            if (th > 3 || tc > 1) return 3;
            ++sp;
            if (sp + 16 > se) return 3;
            Huff& hh = tc ? hac[th] : hdc[th];
            int total = 0;
            for (int i = 1; i <= 16; ++i) {
              hh.counts[i] = sp[i - 1];
              total += hh.counts[i];
            }
            sp += 16;
            if (total > 256 || sp + total > se) return 3;
            for (int i = 0; i < total; ++i) hh.symbols[i] = sp[i];
            sp += total;
            hh.build();
          }
          break;
        case 0xC0: case 0xC1: case 0xC2: {  // SOF0/1 sequential, SOF2 prog
          if (ncomp) return 4;  // multiple frames unsupported
          progressive = (m == 0xC2);
          if (sp + 6 > se) return 3;
          height = (sp[1] << 8) | sp[2];
          width = (sp[3] << 8) | sp[4];
          ncomp = sp[5];
          if (sp[0] != 8 || ncomp < 1 || ncomp > 3) return 4;
          sp += 6;
          if (sp + 3 * ncomp > se) return 3;
          for (int i = 0; i < ncomp; ++i) {
            comp[i].id = sp[0];
            comp[i].h = sp[1] >> 4;
            comp[i].v = sp[1] & 15;
            comp[i].tq = sp[2];
            if (comp[i].tq > 3) return 3;
            if (comp[i].h < 1 || comp[i].h > 2 || comp[i].v < 1 ||
                comp[i].v > 2)
              return 5;  // sampling beyond 2x2 unsupported
            sp += 3;
          }
          for (int i = 0; i < ncomp; ++i) {
            hmax = comp[i].h > hmax ? comp[i].h : hmax;
            vmax = comp[i].v > vmax ? comp[i].v : vmax;
          }
          break;
        }
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return 6;  // lossless/arithmetic/hierarchical unsupported
        case 0xDD:  // DRI
          if (sp + 2 > se) return 3;
          restart_interval = (sp[0] << 8) | sp[1];
          break;
        case 0xDA: {  // SOS
          if (width <= 0 || height <= 0 || ncomp == 0) return 7;
          if (out_rgba == nullptr) {
            *out_w = width;
            *out_h = height;
            return 0;  // probe only
          }
          if (sp + 1 > se) return 3;
          int ns = sp[0];
          ++sp;
          if (ns < 1 || ns > ncomp) return 3;
          if (sp + 2 * ns + 3 > se) return 3;
          int scomp[3];
          for (int i = 0; i < ns; ++i) {
            int cid = sp[0], tds = sp[1];
            int found = -1;
            for (int c = 0; c < ncomp; ++c)
              if (comp[c].id == cid) found = c;
            if (found < 0) return 3;
            comp[found].td = tds >> 4;
            comp[found].ta = tds & 15;
            if (comp[found].td > 3 || comp[found].ta > 3) return 3;
            scomp[i] = found;
            sp += 2;
          }
          int ss = sp[0], spectral_end = sp[1];
          int ah = sp[2] >> 4, al = sp[2] & 15;
          if (ss > 63 || spectral_end > 63 || spectral_end < ss) return 3;
          if (progressive && ss > 0 && ns != 1) return 3;  // AC: 1 comp
          if (!allocated && !alloc_planes()) return 3;
          p = decode_scan(p + seg, end, scomp, ns, ss, spectral_end, ah,
                          al);
          any_scan = true;
          continue;  // p already points at the next marker
        }
        default:
          break;  // skip APPn/COM/unknown
      }
      p += seg;
    }
    if (out_rgba == nullptr) return 8;  // probe never reached SOS
    if (!any_scan) return 8;
    finish_planes();
    // color convert (JFIF full-range YCbCr)
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        uint8_t* px = out_rgba + 4 * ((size_t)y * width + x);
        if (ncomp == 1) {
          uint8_t g = comp[0].plane[(size_t)y * comp[0].cols + x];
          px[0] = px[1] = px[2] = g;
        } else {
          auto samplec = [&](const Component& c) -> int {
            int cx = x * c.h / hmax;
            int cy = y * c.v / vmax;
            if (cx >= c.cols) cx = c.cols - 1;
            if (cy >= c.rows) cy = c.rows - 1;
            return c.plane[(size_t)cy * c.cols + cx];
          };
          int Y = samplec(comp[0]);
          int Cb = samplec(comp[1]) - 128;
          int Cr = samplec(comp[2]) - 128;
          auto clamp8 = [](double v) -> uint8_t {
            return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : std::lround(v));
          };
          px[0] = clamp8(Y + 1.402 * Cr);
          px[1] = clamp8(Y - 0.344136 * Cb - 0.714136 * Cr);
          px[2] = clamp8(Y + 1.772 * Cb);
        }
        px[3] = 255;
      }
    }
    *out_w = width;
    *out_h = height;
    return 0;
  }
};

}  // namespace

extern "C" {

// Probe: out_rgba == null -> fills w/h only.  Returns 0 on success.
int vf_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out_rgba,
                   int32_t* out_w, int32_t* out_h) {
  Decoder d;
  int w = 0, h = 0;
  int rc = d.decode(data, (size_t)len, out_rgba, &w, &h);
  *out_w = w;
  *out_h = h;
  return rc;
}
}
