// Per-pixel arithmetic that the kernels share (included by every csrc/*.cu
// source that needs it): the float32 ops in the plain versions' order, the
// RGBA8 quantization, limited-range BT.601/BT.709 conversion both ways, the
// 2-tap sample of the K1/K1b tables, and the 4:2:0 pack of a 2x2 quad; then
// the byte vectors and the 4:2:0 input and output planes of the fused routes
// (K5's and K6's, csrc/deinterlace.cu and csrc/overlay.cu).
//
// Bitwise parity with the plain PyTorch versions rests on these:
//   - every multiply and add is __fmul_rn / __fadd_rn / __fsub_rn in the
//     plain version's operand order, so nvcc contracts nothing into an FMA;
//   - quant is cvt.rni(clamp(x, 0, 1) * 255) (__float2uint_rn), half to even
//     as torch.round; the clamp is max.NaN / min.NaN, NaN-passing as
//     torch.clamp (and the cvt takes NaN to 0);
//   - dequant is v * f32(1/255), as color.dequant;
//   - the coefficients are double literals narrowed to float, which is how
//     numpy's float32 tables (color.YUV_TO_RGB, RGB_TO_YUV, YUV_OFFSET) and
//     torch's Python scalars reach the plain version.
//
// Everything here has internal linkage: each source that includes the header
// gets its own copy, and the separately compiled objects link together.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kInv255 = static_cast<float>(1.0 / 255.0);

// color.YUV_OFFSET
__constant__ float kYuvOffset[3] = {16.0 / 255.0, 128.0 / 255.0,
                                    128.0 / 255.0};
// color.YUV_TO_RGB: [matrix][row r/g/b][column y/u/v]
__constant__ float kYuvToRgb[2][3][3] = {
    {{1.164383, 0.0, 1.596027},
     {1.164383, -0.391762, -0.812968},
     {1.164383, 2.017232, 0.0}},
    {{1.164383, 0.0, 1.792741},
     {1.164383, -0.213249, -0.532909},
     {1.164383, 2.112402, 0.0}},
};
// color.RGB_TO_YUV: [matrix][row y/u/v][column r/g/b]
__constant__ float kRgbToYuv[2][3][3] = {
    {{0.256788, 0.504129, 0.097906},
     {-0.148223, -0.290993, 0.439216},
     {0.439216, -0.367788, -0.071427}},
    {{0.182586, 0.614231, 0.062007},
     {-0.100644, -0.338572, 0.439216},
     {0.439216, -0.398942, -0.040274}},
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp: NaN passes through (max.NaN and min.NaN return NaN when an
// operand is NaN; otherwise they are max and min).
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(hi));
  return r;
}
__device__ __forceinline__ float clamp01(float x) { return clampf(x, 0.0f, 1.0f); }

// color.quant: rounding half to even, as torch.round, in one cvt.rni of the
// clamped value.
__device__ __forceinline__ uint8_t quant(float x) {
  return static_cast<uint8_t>(__float2uint_rn(mul(clamp01(x), 255.0f)));
}

// color.dequant
__device__ __forceinline__ float dequant(uint8_t v) {
  return mul(static_cast<float>(v), kInv255);
}

// One output of the K1/K1b sampler: w0 * in[i0] + w1 * in[i1], each product
// rounded, then the sum (resample.resample_rows_plain's separate mul and add
// ops).
__device__ __forceinline__ float tap2(float wa, float a, float wb, float b) {
  return add(mul(wa, a), mul(wb, b));
}

// color.yuv_to_rgb: (m0*yo + m1*uo) + m2*vo per row, clamped.
__device__ __forceinline__ void yuv_to_rgb(float y, float u, float v, int mi,
                                           float& r, float& g, float& b) {
  const float yo = sub(y, kYuvOffset[0]);
  const float uo = sub(u, kYuvOffset[1]);
  const float vo = sub(v, kYuvOffset[2]);
  float out[3];
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const float* m = kYuvToRgb[mi][row];
    out[row] = clamp01(add(add(mul(m[0], yo), mul(m[1], uo)), mul(m[2], vo)));
  }
  r = out[0];
  g = out[1];
  b = out[2];
}

// Row `row` (0 Y, 1 U, 2 V) of color.rgb_to_yuv: ((m0*r + m1*g) + m2*b) +
// offset, unclamped (quant clamps at the store).
__device__ __forceinline__ float rgb_to_yuv(float r, float g, float b, int mi,
                                            int row) {
  const float* m = kRgbToYuv[mi][row];
  return add(add(add(mul(m[0], r), mul(m[1], g)), mul(m[2], b)),
             kYuvOffset[row]);
}

// convert.pack_rgba's 4:2:0 chroma of one 2x2 quad
// (color.rgb_to_chroma_downsampled): p[row][column][r/g/b], the dequantized
// RGBA8 values with the last row or column already duplicated at an odd
// edge; row pairs averaged first, then the column pair, then rgb_to_yuv.
__device__ __forceinline__ void quad_chroma(const float (&p)[2][2][3], int mi,
                                            uint8_t& u, uint8_t& v) {
  float avg[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    avg[c] = mul(add(mul(add(p[0][0][c], p[1][0][c]), 0.5f),
                     mul(add(p[0][1][c], p[1][1][c]), 0.5f)),
                 0.5f);
  }
  u = quant(rgb_to_yuv(avg[0], avg[1], avg[2], mi, 1));
  v = quant(rgb_to_yuv(avg[0], avg[1], avg[2], mi, 2));
}

// -- the fused routes' planes ------------------------------------------------

// N consecutive uint8 pixels of a row as little-endian 32-bit words.
template <int N>
struct Px {
  static constexpr int kWords = (N + 3) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ uint8_t at(int i) const {
    return static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
  __device__ __forceinline__ float dq(int i) const { return dequant(at(i)); }
  // Build with clear() then set() of every pixel.
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = 0;
  }
  __device__ __forceinline__ void set(int i, uint8_t b) {
    w[i >> 2] |= static_cast<uint32_t>(b) << (8 * (i & 3));
  }
};

// Pixels x0 .. x0 + N - 1 of `row`.  kVec: one N-byte access (N is 4, 8 or
// 16; the caller has checked alignment and that the run lies inside the
// row).  Otherwise byte by byte with the column clamped to width - 1: past
// an odd width the last column repeats, as the 4:2:0 pack duplicates it.
template <int N, bool kVec>
__device__ __forceinline__ Px<N> load_px(const uint8_t* row, int x0,
                                         int width) {
  Px<N> p;
  if constexpr (kVec && N == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + x0));
    p.w[0] = q.x;
    p.w[1] = q.y;
    p.w[2] = q.z;
    p.w[3] = q.w;
  } else if constexpr (kVec && N == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(row + x0));
    p.w[0] = q.x;
    p.w[1] = q.y;
  } else if constexpr (kVec && N == 4) {
    p.w[0] = __ldg(reinterpret_cast<const unsigned int*>(row + x0));
  } else {
    p.clear();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      p.set(i, __ldg(row + min(x0 + i, width - 1)));
    }
  }
  return p;
}

// Store pixels x0 .. x0 + N - 1 of `row`: one N-byte access (kVec), or byte
// by byte, leaving out the columns at or past `width`.
template <int N, bool kVec>
__device__ __forceinline__ void store_px(uint8_t* row, int x0, int width,
                                         const Px<N>& p) {
  if constexpr (kVec && N == 16) {
    *reinterpret_cast<uint4*>(row + x0) =
        make_uint4(p.w[0], p.w[1], p.w[2], p.w[3]);
  } else if constexpr (kVec && N == 8) {
    *reinterpret_cast<uint2*>(row + x0) = make_uint2(p.w[0], p.w[1]);
  } else if constexpr (kVec && N == 4) {
    *reinterpret_cast<unsigned int*>(row + x0) = p.w[0];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (x0 + i < width) row[x0 + i] = p.at(i);
    }
  }
}

// An RGBA8 run: N pixels of each of the 4 channels.
template <int N>
struct Rgba {
  Px<N> c[4];
};

// One axis's 2-tap table on the device (kernels/resample.py Taps: i0, i1,
// w0, w1 per output), or all null for an identity axis.
struct AxisTaps {
  const int* i0;
  const int* i1;
  const float* w0;
  const float* w1;
};

struct Tap {
  int a, b;
  float wa, wb;
};

// Output o's taps.  An identity axis reads in[o] with weights (1, 0), which
// tap2 returns exactly (1 * a + 0 * b == a for the finite, non-negative
// dequantized values), as the plain sampler passes the plane through.
__device__ __forceinline__ Tap tap_at(const AxisTaps& t, int o) {
  if (t.i0 == nullptr) return {o, o, 1.0f, 0.0f};
  return {__ldg(t.i0 + o), __ldg(t.i1 + o), __ldg(t.w0 + o), __ldg(t.w1 + o)};
}

// A 4:2:0 input: uint8 Y (height, width) and U, V (ch, cw) planes, and the
// row and column taps that bring the chroma to the luma grid
// (convert.plan_chroma_taps: the tables of plan_rgba_sampler's K1 and K1b
// launches).
struct Yuv420In {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  int cw;
  AxisTaps rows, cols;
  int matrix;
};

// A 4:2:0 output: Y (height, width) and U, V (ch, cw), convert.pack_rgba's
// planes, and its matrix.
struct Yuv420Out {
  uint8_t* y;
  uint8_t* u;
  uint8_t* v;
  int cw;
  int matrix;
};

// The chroma plane at luma pixel (row taps ty, column taps tx) as the
// sampler computes it: dequant, the row taps (K1's pass), then the column
// taps (K1b's pass) on the two row-sampled values.
__device__ __forceinline__ float chroma_at(const uint8_t* plane, int cw,
                                           const Tap& ty, const Tap& tx) {
  const uint8_t* ra = plane + static_cast<size_t>(ty.a) * cw;
  const uint8_t* rb = plane + static_cast<size_t>(ty.b) * cw;
  const float ca = tap2(ty.wa, dequant(__ldg(ra + tx.a)), ty.wb,
                        dequant(__ldg(rb + tx.a)));
  const float cb = tap2(ty.wa, dequant(__ldg(ra + tx.b)), ty.wb,
                        dequant(__ldg(rb + tx.b)));
  return tap2(tx.wa, ca, tx.wb, cb);
}

// -- a run's shared chroma: the fused routes' vector path ------------------
//
// kCols luma columns x0 .. x0 + kCols - 1 (x0 even) of a 2x chroma upsample
// at scale 1 read the chroma columns base = x0 / 2 - 1 .. base + kCols / 2
// + 1: LINEAR reads (m - 1, m) at x = 2m and (m, m + 1) at x = 2m + 1,
// NEAREST m at both.  ChromaRun computes each of those columns' row pass
// once for the run, where chroma_at computes it for every pixel and tap
// (four times as often), and takes each pixel's column pass from it.  The
// slots are fixed, so they stay in registers; the run uses them only where
// the tables' indices are exactly these (`matches`), and the weights are
// always the tables'.  Interior runs match; a run at the left or right edge
// (clamped taps), an odd size or another scale does not and gathers per
// pixel with chroma_at, with the same bits either way.
template <int kCols, bool kLinear>
struct ChromaRun {
  static constexpr int kSlots = kCols / 2 + 2;
  static constexpr int kFirst = kLinear ? 0 : 1;  // slots the taps read
  static constexpr int kLast = kLinear ? kSlots - 1 : kSlots - 2;
  float u[kSlots], v[kSlots];

  static __device__ __forceinline__ int slot_a(int q) {
    return kLinear ? (q + 1) / 2 : q / 2 + 1;
  }
  static __device__ __forceinline__ int slot_b(int q) {
    return kLinear ? slot_a(q) + 1 : slot_a(q);
  }

  // Whether the column taps tx of the run at x0 read exactly the slots.
  static __device__ __forceinline__ bool matches(const Tap (&tx)[kCols],
                                                 int x0) {
    const int base = x0 / 2 - 1;
    bool ok = true;
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      ok = ok && tx[q].a == base + slot_a(q) && tx[q].b == base + slot_b(q);
    return ok;
  }

  // The row pass (K1's arithmetic) of the slots' columns at row taps ty.
  __device__ __forceinline__ void rows(const Yuv420In& in, const Tap& ty,
                                       int x0) {
    const int base = x0 / 2 - 1;
    const size_t ra = static_cast<size_t>(ty.a) * in.cw + base;
    const size_t rb = static_cast<size_t>(ty.b) * in.cw + base;
#pragma unroll
    for (int s = kFirst; s <= kLast; ++s) {
      u[s] = tap2(ty.wa, dequant(__ldg(in.u + ra + s)), ty.wb,
                  dequant(__ldg(in.u + rb + s)));
      v[s] = tap2(ty.wa, dequant(__ldg(in.v + ra + s)), ty.wb,
                  dequant(__ldg(in.v + rb + s)));
    }
  }

  // Pixel q's RGB from its luma byte: the column pass (K1b's arithmetic),
  // then yuv_to_rgb.
  __device__ __forceinline__ void rgb(const Yuv420In& in, uint8_t luma,
                                      const Tap& tx, int q,
                                      float (&out)[3]) const {
    yuv_to_rgb(dequant(luma), tap2(tx.wa, u[slot_a(q)], tx.wb, u[slot_b(q)]),
               tap2(tx.wa, v[slot_a(q)], tx.wb, v[slot_b(q)]), in.matrix,
               out[0], out[1], out[2]);
  }
};

// The emit's unquantized RGB of luma byte `luma` at a pixel with taps (ty,
// tx): yuv_to_rgb(dequant(Y), sampled U, sampled V).
__device__ __forceinline__ void yuv420_rgb(const Yuv420In& in, uint8_t luma,
                                           const Tap& ty, const Tap& tx,
                                           float (&rgb)[3]) {
  yuv_to_rgb(dequant(luma), chroma_at(in.u, in.cw, ty, tx),
             chroma_at(in.v, in.cw, ty, tx), in.matrix, rgb[0], rgb[1],
             rgb[2]);
}

// dequant(quant(x)) without the bytes: the RGBA8 value as a float.  rintf
// rounds half to even as quant does, and the product is dequant's; a NaN
// stores 0 as quant's cvt does.
__device__ __forceinline__ float quant_dq(float x) {
  const float y = mul(clamp01(x), 255.0f);
  return isnan(y) ? 0.0f : mul(rintf(y), kInv255);
}

// convert.pack_rgba to 4:2:0 of an RGBA8 block: rows 2k (a) and 2k + 1 (b;
// a again past an odd height), columns x0 .. x0 + N - 1 (N even, so the
// block holds whole quads; the run's values past an odd width already
// repeat the last column).  value(r, c, q) is the dequantized RGBA8 value
// of channel c (< 3) at column q of row r (0: a, 1: b).  Y from each
// pixel's RGB, U and V from each quad's.
template <int N, bool kVec, typename Value>
__device__ __forceinline__ void store_yuv420_of(const Yuv420Out& out,
                                                int height, int width, int k,
                                                int x0, const Value& value) {
  static_assert(N % 2 == 0, "whole quads");
  Px<N> ya, yb;
  Px<N / 2> u, v;
  ya.clear();
  yb.clear();
  u.clear();
  v.clear();
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    float p[2][2][3];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[0][dx][c] = value(0, c, 2 * j + dx);
        p[1][dx][c] = value(1, c, 2 * j + dx);
      }
      ya.set(2 * j + dx, quant(rgb_to_yuv(p[0][dx][0], p[0][dx][1],
                                          p[0][dx][2], out.matrix, 0)));
      yb.set(2 * j + dx, quant(rgb_to_yuv(p[1][dx][0], p[1][dx][1],
                                          p[1][dx][2], out.matrix, 0)));
    }
    uint8_t uj, vj;
    quad_chroma(p, out.matrix, uj, vj);
    u.set(j, uj);
    v.set(j, vj);
  }
  const size_t ra = static_cast<size_t>(2 * k) * width;
  store_px<N, kVec>(out.y + ra, x0, width, ya);
  if (2 * k + 1 < height) store_px<N, kVec>(out.y + ra + width, x0, width, yb);
  const size_t rc = static_cast<size_t>(k) * out.cw;
  store_px<N / 2, kVec>(out.u + rc, x0 / 2, out.cw, u);
  store_px<N / 2, kVec>(out.v + rc, x0 / 2, out.cw, v);
}

// store_yuv420_of an RGBA8 block held as bytes.
template <int N, bool kVec>
__device__ __forceinline__ void store_yuv420(const Yuv420Out& out, int height,
                                             int width, int k, int x0,
                                             const Rgba<N>& a,
                                             const Rgba<N>& b) {
  store_yuv420_of<N, kVec>(out, height, width, k, x0,
                           [&](int r, int c, int q) {
                             return r == 0 ? a.c[c].dq(q) : b.c[c].dq(q);
                           });
}

// store_yuv420_of an RGBA8 block held as quant_dq's floats, a[c][q] and
// b[c][q] (c < 3): no byte is packed and unpacked again.
template <int N, bool kVec>
__device__ __forceinline__ void store_yuv420(const Yuv420Out& out, int height,
                                             int width, int k, int x0,
                                             const float (&a)[3][N],
                                             const float (&b)[3][N]) {
  store_yuv420_of<N, kVec>(out, height, width, k, x0,
                           [&](int r, int c, int q) {
                             return r == 0 ? a[c][q] : b[c][q];
                           });
}

// 1 when p sits on a `bytes` boundary.
inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// A launcher's facts about a card (its resident blocks, a function
// attribute it set) are kept per card: one process may launch on several
// (dp/sp sharding), and occupancy and attributes belong to one device.
constexpr int kMaxDevices = 64;
using PerDevice = int[kMaxDevices];

// The current card's index, or -1 past kMaxDevices.
inline int device_slot() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  return device >= 0 && device < kMaxDevices ? device : -1;
}

// The blocks `kernel` holds resident on the current card with `threads` a
// block (no dynamic shared memory), asked on its first launch there into
// `cache`; 0, an empty grid the launch reports, for a card past
// kMaxDevices.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, PerDevice& cache) {
  const int slot = device_slot();
  if (slot < 0) return 0;
  if (cache[slot] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, slot);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cache[slot] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[slot];
}

// Launch a grid-stride kernel over `items` work items: enough blocks of
// `threads` for one trip, at most the blocks the card holds resident at
// once (`resident_blocks`, into the caller's `resident`, which each kernel
// keeps).  -> the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_resident(Kernel kernel, PerDevice& resident,
                            long long items, int threads, cudaStream_t stream,
                            Args... args) {
  const int blocks = resident_blocks(kernel, threads, resident);
  const long long needed = (items + threads - 1) / threads;
  kernel<<<static_cast<int>(needed < blocks ? needed : blocks), threads, 0,
           stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
