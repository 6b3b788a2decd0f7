// vfoverlay for Hopper (sm_90a): K6, the element's whole body in one launch.
//
// Replaces the XLA fusion of tpuvf's canonical overlay body
// (tpuvf/elements/overlay.py:581-607): the input's sampler, the rect blend of
// the premultiplied overlay (resampled to its rect on the host at build
// time), and `pack_rgba_t` (tpuvf/kernels/convert.py:2651-2659) to the
// output format.  Per pixel:
//
//   v   = the frame's float32 RGB (below, per route)
//   inside [x0, x1) x [y0, y1):  a = ov[3] * alpha
//                                v[c] = v[c] * (1 - a) + ov[c] * a   (c < 3)
//   q   = quant(v)                         (the RGBA8 render target)
//   out = q (RGB), or pack 4:2:0 from dequant(q)
//
// tpuvf zero-pads the overlay to the frame, which makes the blend an exact
// identity outside the rect (v * 1 + 0 == v); the kernels do not blend
// there.  An empty rect (an overlay fully off the frame) only converts.
//
// Two routes, each one launch:
//   - overlay_blend_u8, RGB in and out: v = dequant of the (4, H, W) uint8
//     planes.  Outside the rect quant(dequant(v)) == v, so a run of pixels
//     that misses the rect is copied as it is.
//   - overlay_yuv420_u8, 4:2:0 in and out (NV12 and I420 are both three
//     planes on the device): v = yuv_to_rgb(dequant(Y), U, V) with U and V
//     sampled at each pixel through the row taps, then the column taps, of
//     the tables plan_rgba_sampler's K1 and K1b launches read; then the
//     blend, quant, and the 4:2:0 pack with the output matrix.  The round
//     trip YUV -> RGBA8 -> YUV is not the identity, so every quad is
//     computed, outside the rect too.  Before this route the element ran K1,
//     K1b, the emit K2 to a float32 RGBA frame, the blend and ~30 plain
//     torch launches of the pack.
//
// The plain versions are tpuvf_torch.kernels.overlay.overlay_frame_plain
// (the same composition of plain parts) and overlay_blend_plain.
//
// What bounds it.  At chain (e')'s 4K NV12 shape with the 256x256 rect the
// 4:2:0 route reads Y 8.29 MB, U and V 4.15 MB and the 1.05 MB rect, and
// writes the same 12.44 MB: 25.9 MB, 7.7 us at 3.35 TB/s.  Its float ops
// (the chroma sample, the matrices, the quantizations, the quad average:
// ~90 a pixel) take 11.1 us at 67 TFLOP/s, so operations bound it, and
// with the byte work and the conversions it is an instruction-issue and
// latency problem more than a bandwidth one.  The design: a thread owns a
// 2-row x 4-column block of whole quads (rows 2k and 2k + 1), so the 4:2:0
// pack needs nothing from another thread; Y is read and written 4 bytes a
// row at once; an interior run computes the row pass of the 4 chroma
// columns its taps read once (ChromaRun) and each pixel's column pass from
// them; each pixel's RGBA8 value stays a float (quant_dq) until the pack;
// the kernel is held to 80 registers (3 blocks an SM).  The first design
// (8 columns a thread, 128 registers, no shared row pass, bytes packed and
// unpacked between the quantization and the pack) took 72.8 us on an NVIDIA
// H100 80GB HBM3 at 700.00 W (chip_smoke.py); each of the four changes took
// time off in builds timed side by side on the card, and full-rate integer
// tricks in place of the byte-float conversions added time (PERF.md, PR
// 7).  A width that is not a multiple of
// 4, or a plane off its access's boundary, takes the scalar path: byte by
// byte, the last column repeated past an odd width and the last row past
// an odd height, as the pack does.  The RGB route reads and writes the 66
// MB of a 4K RGBA8 frame 16 pixels (16 bytes a plane) a thread, or 1 pixel
// a thread when the width is not a multiple of 16 or a plane is off 16
// bytes.
//
// Bitwise parity with the plain version (yuv420.cuh): every op is __fmul_rn
// / __fadd_rn / __fsub_rn in tpuvf's order, so nvcc contracts nothing (the
// blend is an FMA site); quant rounds half to even.

#include "yuv420.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRgbCols = 16;  // RGB route: pixels a thread on the vector path
constexpr int kYuvCols = 4;   // 4:2:0 route: columns a thread, either path

// The overlay's rect and planes; ov is null for an empty rect.
struct Rect {
  const float* ov;  // (4, y1 - y0, x1 - x0) float32, premultiplied
  int x0, x1, y0, y1;
  const float* alpha;  // the float32 opacity, on the device
};

// Blend pixel (x, y)'s rgb with the overlay when it lies in the rect.
__device__ __forceinline__ void blend(const Rect& r, float k, int x, int y,
                                      float (&v)[3]) {
  if (x < r.x0 || x >= r.x1 || y < r.y0 || y >= r.y1) return;
  const int rw = r.x1 - r.x0;
  const size_t rplane = static_cast<size_t>(r.y1 - r.y0) * rw;
  const size_t j = static_cast<size_t>(y - r.y0) * rw + (x - r.x0);
  const float a = mul(__ldg(r.ov + 3 * rplane + j), k);
  const float keep = sub(1.0f, a);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = add(mul(v[c], keep), mul(__ldg(r.ov + c * rplane + j), a));
}

// -- the RGB route ------------------------------------------------------------

// kVec: kRgbCols pixels of one row a thread, else one pixel a thread; either
// way in a grid-stride loop over the frame.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
overlay_blend_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                     int height, int width, const Rect r) {
  constexpr int kCols = kVec ? kRgbCols : 1;
  const size_t plane = static_cast<size_t>(height) * width;
  const int groups = width / kCols;
  const long long items = static_cast<long long>(height) * groups;
  const float k = r.ov != nullptr ? __ldg(r.alpha) : 0.0f;
  for (long long it = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int y = static_cast<int>(it / groups);
    const int x0 = static_cast<int>(it - static_cast<long long>(y) * groups) *
                   kCols;
    const size_t i = static_cast<size_t>(y) * width + x0;
    Rgba<kCols> p;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      p.c[c] = load_px<kCols, kVec>(src + c * plane + i, 0, kCols);
    const bool touches = r.ov != nullptr && y >= r.y0 && y < r.y1 &&
                         x0 + kCols > r.x0 && x0 < r.x1;
    if (touches) {  // the other channels: quant(dequant(v)) == v
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        float v[3] = {p.c[0].dq(q), p.c[1].dq(q), p.c[2].dq(q)};
        blend(r, k, x0 + q, y, v);
        // rebuild the pixel's byte in each word
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int s = 8 * (q & 3);
          p.c[c].w[q >> 2] = (p.c[c].w[q >> 2] & ~(0xffu << s)) |
                             (static_cast<uint32_t>(quant(v[c])) << s);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store_px<kCols, kVec>(out + c * plane + i, 0, kCols, p.c[c]);
  }
}

// -- the 4:2:0 route ----------------------------------------------------------

// Rows 2k and 2k + 1, columns x0 .. x0 + kCols - 1: each pixel's RGB from
// the planes, blended, quantized; then the 4:2:0 pack.  Three blocks an SM
// (80 registers): the occupancy hides the chroma gathers' latency.
template <int kCols, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
overlay_yuv420_kernel(const Yuv420In in, const Yuv420Out out, int height,
                      int width, const Rect r) {
  const int groups = (width + kCols - 1) / kCols;
  const long long items = static_cast<long long>((height + 1) / 2) * groups;
  const float k = r.ov != nullptr ? __ldg(r.alpha) : 0.0f;
  for (long long it = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int qk = static_cast<int>(it / groups);
    const int x0 = static_cast<int>(it - static_cast<long long>(qk) * groups) *
                   kCols;
    Tap tx[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      tx[q] = tap_at(in.cols, min(x0 + q, width - 1));
    // the vector path's interior runs share their chroma row pass
    const bool run = kVec && ChromaRun<kCols, true>::matches(tx, x0);
    float rows[2][3][kCols];  // dequant(quant(rgb)) of rows 2k, 2k + 1
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = min(2 * qk + dy, height - 1);  // an odd height repeats
      const Tap ty = tap_at(in.rows, y);
      const Px<kCols> luma = load_px<kCols, kVec>(
          in.y + static_cast<size_t>(y) * width, x0, width);
      ChromaRun<kCols, true> chroma;
      if (run) chroma.rows(in, ty, x0);
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        float v[3];
        if (run) {
          chroma.rgb(in, luma.at(q), tx[q], q, v);
        } else {
          yuv420_rgb(in, luma.at(q), ty, tx[q], v);
        }
        if (r.ov != nullptr) blend(r, k, min(x0 + q, width - 1), y, v);
#pragma unroll
        for (int c = 0; c < 3; ++c) rows[dy][c][q] = quant_dq(v[c]);
      }
    }
    store_yuv420<kCols, kVec>(out, height, width, qk, x0, rows[0], rows[1]);
  }
}

// The rect's checks: an empty rect, or no planes, blends nowhere.
bool make_rect(const float* ov, int x0, int x1, int y0, int y1,
               const float* alpha, int height, int width, Rect& r) {
  if (alpha == nullptr) return false;
  if (ov == nullptr || x1 <= x0 || y1 <= y0) {
    r = Rect{nullptr, 0, 0, 0, 0, alpha};
    return true;
  }
  if (x0 < 0 || y0 < 0 || x1 > width || y1 > height) return false;
  r = Rect{ov, x0, x1, y0, y1, alpha};
  return true;
}

}  // namespace

// RGB route: one launch over the (4, height, width) uint8 frame `src` into
// the uint8 planes `out`, on `stream`.  `ov` holds the (4, y1 - y0, x1 - x0)
// float32 premultiplied overlay of the rect, or is nullptr for an empty
// rect; `alpha` points to the float32 opacity on the device.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int overlay_blend_u8(const uint8_t* src, uint8_t* out, int height,
                                int width, const float* ov, int x0, int x1,
                                int y0, int y1, const float* alpha,
                                cudaStream_t stream) {
  Rect r;
  if (src == nullptr || out == nullptr || height <= 0 || width <= 0 ||
      !make_rect(ov, x0, x1, y0, y1, alpha, height, width, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = static_cast<long long>(height) * width;
  if (width % kRgbCols == 0 && aligned(src, kRgbCols) &&
      aligned(out, kRgbCols)) {
    static PerDevice resident = {};
    return static_cast<int>(
        launch_resident(overlay_blend_kernel<true>, resident,
                        plane / kRgbCols, kThreads, stream, src, out, height,
                        width, r));
  }
  static PerDevice resident = {};
  return static_cast<int>(launch_resident(overlay_blend_kernel<false>,
                                          resident, plane, kThreads, stream,
                                          src, out, height, width, r));
}

// 4:2:0 route: the uint8 planes y (height, width), u and v (ceil(height / 2),
// ceil(width / 2)) into out_y, out_u, out_v of the same shapes, on `stream`.
// The chroma taps (row_* for the rows, col_* for the columns, each i0, i1,
// w0, w1 per output, or all null for an identity axis) are
// convert.plan_chroma_taps'.  ov, the rect and alpha as for
// overlay_blend_u8.  Returns the launch's cudaError_t (0 on success).
extern "C" int overlay_yuv420_u8(
    const uint8_t* y, const uint8_t* u, const uint8_t* v, const int* row_i0,
    const int* row_i1, const float* row_w0, const float* row_w1,
    const int* col_i0, const int* col_i1, const float* col_w0,
    const float* col_w1, uint8_t* out_y, uint8_t* out_u, uint8_t* out_v,
    int height, int width, const float* ov, int x0, int x1, int y0, int y1,
    const float* alpha, int matrix_in, int matrix_out, cudaStream_t stream) {
  Rect r;
  const bool bad_taps = (row_i0 == nullptr) != (row_w1 == nullptr) ||
                        (col_i0 == nullptr) != (col_w1 == nullptr);
  if (y == nullptr || u == nullptr || v == nullptr || out_y == nullptr ||
      out_u == nullptr || out_v == nullptr || height <= 0 || width <= 0 ||
      bad_taps || matrix_in < 0 || matrix_in > 1 || matrix_out < 0 ||
      matrix_out > 1 ||
      !make_rect(ov, x0, x1, y0, y1, alpha, height, width, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cw = (width + 1) / 2;
  const Yuv420In in{y, u, v, cw,
                    AxisTaps{row_i0, row_i1, row_w0, row_w1},
                    AxisTaps{col_i0, col_i1, col_w0, col_w1}, matrix_in};
  const Yuv420Out out{out_y, out_u, out_v, cw, matrix_out};
  const long long pairs = (height + 1) / 2;
  const long long groups = (width + kYuvCols - 1) / kYuvCols;
  if (width % kYuvCols == 0 && aligned(y, kYuvCols) &&
      aligned(out_y, kYuvCols) && aligned(out_u, kYuvCols / 2) &&
      aligned(out_v, kYuvCols / 2)) {
    static PerDevice resident = {};
    return static_cast<int>(
        launch_resident(overlay_yuv420_kernel<kYuvCols, true>, resident,
                        pairs * groups, kThreads, stream, in, out, height,
                        width, r));
  }
  static PerDevice resident = {};
  return static_cast<int>(
      launch_resident(overlay_yuv420_kernel<kYuvCols, false>, resident,
                      pairs * groups, kThreads, stream, in, out, height,
                      width, r));
}
