// vfdeinterlace for Hopper (sm_90a): K5, the element's whole body in one
// launch.
//
// Replaces the XLA fusion of tpuvf's full-frame deinterlace body
// (tpuvf/elements/deinterlace.py:441-480: the NEAREST sampler, the RGBA8
// texture, the field logic of tpuvf/kernels/deinterlace.py:135-152 `bob_t`,
// `weave_t`, `greedyh_t` with the first-frame fallback, and `pack_rgba_t` to
// the output format).  On the RGBA8 texture of the input `cur` and of the
// previous input `prev`, per pixel:
//
//   keep = ((y % 2) == 0) == tff                 (rows of the full frame)
//   keep:  out = quant(dq(cur)) = cur
//   else:  bob = (dq(cur[y - 1]) + dq(cur[y + 1])) * 0.5   (rows clamped)
//          prev == nullptr (bob, linear, or no previous frame yet): bob
//          weave:    dq(prev)
//          greedy-H: dq(prev) where sqrt(d0*d0 + d1*d1 + d2*d2) < thr,
//                    else bob    (d_c = dq(cur_c) - dq(prev_c), c < 3)
//          out = quant(...)
//   then out as RGBA8 planes, or packed to 4:2:0 (convert.pack_rgba).
//
// Two routes, each one launch of one kernel template:
//   - deinterlace_u8, RGB in: the texture is the (4, H, W) uint8 input
//     itself, and it is the next frame's `prev` as it is;
//   - deinterlace_yuv420_u8, 4:2:0 in: the texture is computed in registers,
//     quant(yuv_to_rgb(dq(Y), U, V)) with U and V sampled through the NEAREST
//     row and column taps of plan_rgba_sampler's K1 and K1b tables, and, for
//     weave and greedy-H, written out as the next frame's `prev` (bob and
//     linear carry no state).  Before this route the element ran K1, K1b, the
//     emit K2 to the texture, the field kernel, then ~30 plain torch launches
//     of the pack.
// Either route writes RGBA8 planes or 4:2:0 planes.  The state layout is
// unchanged: `prev` is the (4, H, W) uint8 RGBA8 texture.
//
// The plain versions are tpuvf_torch.kernels.deinterlace's
// deinterlace_frame_plain (the same composition of plain parts) and
// deinterlace_plain.
//
// The design: a thread owns an aligned 2-row x kCols-column block, rows 2k
// and 2k + 1: one kept row and one rebuilt row.  It makes (loads, or
// computes) the texture of the kept row, of the rebuilt row (greedy-H's
// motion reads it) and of the one neighbour of the rebuilt row outside the
// pair (2k + 2 for tff, 2k - 1 for bff; the other neighbour is the kept
// row), so the 4:2:0 pack of the pair's quads needs nothing from another
// thread.  The neighbour row is made twice, once by each pair it borders.
// Uint8 planes are read and written kCols bytes a row at once: 16 for RGB
// in; 4 for 4:2:0 in, whose texture is computed in registers (8 columns
// held 138-170 registers, one block an SM), an interior run computing the
// row pass of its chroma columns once (ChromaRun).  A width that is not a
// multiple of kCols, or a plane off its access's boundary, takes the
// scalar path: 4 columns a thread, byte by byte, the last column repeated
// past an odd width and the last row past an odd height, as the pack does.
//
// What bounds it: memory.  At chain (g)'s I420 1080p greedy-H shape it reads
// Y, U and V (3.11 MB) and `prev` on the rebuilt rows (4.15 MB), writes the
// 8.29 MB texture for the next frame and the 3.11 MB output: 18.7 MB, 5.6 us
// at 3.35 TB/s; the float ops (~146 a pixel: 1.5 texture rows a row, the
// field logic, the pack) take 4.5 us at 67 TFLOP/s, and the instructions
// and the gathers' latency hold it at several times either.  The first
// design, 8 columns a thread, took 36.0 us on an NVIDIA H100 80GB HBM3 at
// 700.00 W (chip_smoke.py); 4 columns and the shared row pass each took time
// off in builds timed side by side on the card (PERF.md, PR 7).  At chain
// (g')'s BGRA 1080p weave shape it reads the 8.3 MB texture, `prev` on half
// the rows, and writes 8.3 MB: 6.2 us.  The threshold is read from device
// memory (a 0-dim tensor), so no frame waits for the host.
//
// Bitwise parity with the plain version (yuv420.cuh): greedy-H's
// `motion < thr` is a knife edge that one ulp moves, so every op is
// __fmul_rn / __fadd_rn / __fsub_rn / __fsqrt_rn in tpuvf's order
// (__fsqrt_rn(((d0*d0) + (d1*d1)) + (d2*d2))) and nvcc contracts nothing into
// an FMA; bob's sum is commutative, so which of the two neighbours is the
// kept row does not matter; odd heights clamp the last row's row + 1 to
// itself.

#include "yuv420.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRgbCols = 16;  // RGB in: columns a thread on the vector path
constexpr int kYuvCols = 4;   // 4:2:0 in: columns a thread on the vector path
constexpr int kScalarCols = 4;

// kernels/deinterlace.py METHOD_BOB, METHOD_WEAVE, METHOD_LINEAR,
// METHOD_GREEDYH
enum Method : int { kBob, kWeave, kLinear, kGreedyH };

struct FieldArgs {
  const uint8_t* rgba;  // RGB in: the (4, H, W) texture
  Yuv420In yuv;         // 4:2:0 in
  const uint8_t* prev;  // (4, H, W), or null: bob
  uint8_t* rgba_out;    // RGBA out: (4, H, W)
  Yuv420Out yuv_out;    // 4:2:0 out
  uint8_t* tex;         // 4:2:0 in, weave / greedy-H: the texture, (4, H, W)
  const float* threshold;
  int height, width, method, tff;
};

// Row `row`'s texture at columns x0 .. x0 + kCols - 1 (clamped to the last
// column byte by byte): the RGB planes, or computed from the 4:2:0 planes
// with the columns' taps tx.
template <int kCols, bool kVec, bool kYuvIn>
__device__ __forceinline__ Rgba<kCols> texel_row(const FieldArgs& a, int row,
                                                 int x0,
                                                 const Tap (&tx)[kCols],
                                                 bool run) {
  Rgba<kCols> t;
  const size_t r = static_cast<size_t>(row) * a.width;
  if constexpr (kYuvIn) {
    const Tap ty = tap_at(a.yuv.rows, row);
    const Px<kCols> luma = load_px<kCols, kVec>(a.yuv.y + r, x0, a.width);
    ChromaRun<kCols, false> chroma;  // NEAREST
    if (run) chroma.rows(a.yuv, ty, x0);
#pragma unroll
    for (int c = 0; c < 4; ++c) t.c[c].clear();
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      float v[3];
      if (run) {
        chroma.rgb(a.yuv, luma.at(q), tx[q], q, v);
      } else {
        yuv420_rgb(a.yuv, luma.at(q), ty, tx[q], v);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) t.c[c].set(q, quant(v[c]));
      t.c[3].set(q, 255);  // quant(1.0)
    }
  } else {
    const size_t plane = static_cast<size_t>(a.height) * a.width;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      t.c[c] = load_px<kCols, kVec>(a.rgba + c * plane + r, x0, a.width);
  }
  return t;
}

// The rebuilt row: bob of the kept row and the outer neighbour, or weave /
// greedy-H against prev.
template <int kCols, bool kVec>
__device__ __forceinline__ Rgba<kCols> rebuild(const FieldArgs& a, int row,
                                               int x0, bool greedy, float thr,
                                               const Rgba<kCols>& cur,
                                               const Rgba<kCols>& kept,
                                               const Rgba<kCols>& outer) {
  Rgba<kCols> out, p;
  const size_t plane = static_cast<size_t>(a.height) * a.width;
  const size_t r = static_cast<size_t>(row) * a.width;
  if (a.prev != nullptr) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      p.c[c] = load_px<kCols, kVec>(a.prev + c * plane + r, x0, a.width);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out.c[c].clear();
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    bool take_prev = a.prev != nullptr;  // weave
    if (greedy) {
      const float d0 = sub(cur.c[0].dq(q), p.c[0].dq(q));
      const float d1 = sub(cur.c[1].dq(q), p.c[1].dq(q));
      const float d2 = sub(cur.c[2].dq(q), p.c[2].dq(q));
      const float motion =
          __fsqrt_rn(add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2)));
      take_prev = motion < thr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // quant(dq(prev)) == prev
      out.c[c].set(q, take_prev ? p.c[c].at(q)
                                : quant(mul(add(kept.c[c].dq(q),
                                                outer.c[c].dq(q)),
                                            0.5f)));
    }
  }
  return out;
}

// c ? x : y, word by word (selects, where a conditional reference to one of
// two register arrays could send both to local memory).
template <int kCols>
__device__ __forceinline__ Rgba<kCols> pick(bool c, const Rgba<kCols>& x,
                                            const Rgba<kCols>& y) {
  Rgba<kCols> r;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
    for (int k = 0; k < Px<kCols>::kWords; ++k)
      r.c[ch].w[k] = c ? x.c[ch].w[k] : y.c[ch].w[k];
  }
  return r;
}

template <int kCols, bool kVec>
__device__ __forceinline__ void store_rgba(uint8_t* planes, int height,
                                           int width, int row, int x0,
                                           const Rgba<kCols>& t) {
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t r = static_cast<size_t>(row) * width;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    store_px<kCols, kVec>(planes + c * plane + r, x0, width, t.c[c]);
}

template <int kCols, bool kVec, bool kYuvIn, bool kYuvOut>
__global__ void __launch_bounds__(kThreads)
deinterlace_pair_kernel(const FieldArgs a) {
  const int h = a.height;
  const int groups = (a.width + kCols - 1) / kCols;
  const long long items = static_cast<long long>((h + 1) / 2) * groups;
  const bool tff = a.tff != 0;
  const bool greedy = a.prev != nullptr && a.method == kGreedyH;
  const float thr = greedy ? __ldg(a.threshold) : 0.0f;
  for (long long it = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(it / groups);
    const int x0 = static_cast<int>(it - static_cast<long long>(k) * groups) *
                   kCols;
    Tap tx[kCols];
    bool run = false;  // the vector path's interior runs share their chroma
    if constexpr (kYuvIn) {
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        tx[q] = tap_at(a.yuv.cols, min(x0 + q, a.width - 1));
      run = kVec && ChromaRun<kCols, false>::matches(tx, x0);
    }
    const bool has_b = 2 * k + 1 < h;  // row 2k + 1 exists
    // the kept row (past an odd height, bff: the rebuilt row itself, which
    // is then its own lower neighbour), the rebuilt row, its outer
    // neighbour
    const int kept_row = min(tff ? 2 * k : 2 * k + 1, h - 1);
    const int rebuilt_row = tff ? 2 * k + 1 : 2 * k;
    const bool rebuilt = rebuilt_row < h;
    const Rgba<kCols> kept =
        texel_row<kCols, kVec, kYuvIn>(a, kept_row, x0, tx, run);
    Rgba<kCols> cur = kept, out = kept;
    if (rebuilt) {
      const int outer_row = tff ? min(2 * k + 2, h - 1) : max(2 * k - 1, 0);
      cur = texel_row<kCols, kVec, kYuvIn>(a, rebuilt_row, x0, tx, run);
      const Rgba<kCols> outer =
          texel_row<kCols, kVec, kYuvIn>(a, outer_row, x0, tx, run);
      out = rebuild<kCols, kVec>(a, rebuilt_row, x0, greedy, thr, cur, kept,
                                 outer);
    }
    // rows 2k and 2k + 1 of the output (b repeats a past an odd height)
    const Rgba<kCols> out_a = pick(tff, kept, out);
    const Rgba<kCols> out_b = pick(has_b, pick(tff, out, kept), out_a);
    if constexpr (kYuvOut) {
      store_yuv420<kCols, kVec>(a.yuv_out, h, a.width, k, x0, out_a, out_b);
    } else {
      store_rgba<kCols, kVec>(a.rgba_out, h, a.width, 2 * k, x0, out_a);
      if (has_b)
        store_rgba<kCols, kVec>(a.rgba_out, h, a.width, 2 * k + 1, x0, out_b);
    }
    if (kYuvIn && a.tex != nullptr) {  // the input's texture, rows 2k, 2k + 1
      store_rgba<kCols, kVec>(a.tex, h, a.width, 2 * k, x0,
                              pick(tff, kept, cur));
      if (has_b)
        store_rgba<kCols, kVec>(a.tex, h, a.width, 2 * k + 1, x0,
                                pick(tff, cur, kept));
    }
  }
}

template <int kCols, bool kVec, bool kYuvIn, bool kYuvOut>
cudaError_t launch(const FieldArgs& a, cudaStream_t stream) {
  static PerDevice resident = {};
  const long long items = static_cast<long long>((a.height + 1) / 2) *
                          ((a.width + kCols - 1) / kCols);
  return launch_resident(deinterlace_pair_kernel<kCols, kVec, kYuvIn, kYuvOut>,
                         resident, items, kThreads, stream, a);
}

// The route's launch: the vector path where the width is a multiple of
// kCols and every uint8 plane starts on its access (kCols bytes; kCols / 2
// for the 4:2:0 output's chroma), else the scalar path.
template <int kCols, bool kYuvIn>
int launch_route(const FieldArgs& a, bool yuv_out, cudaStream_t stream) {
  const void* in = kYuvIn ? static_cast<const void*>(a.yuv.y) : a.rgba;
  bool vec = a.width % kCols == 0 && aligned(in, kCols) &&
             (a.prev == nullptr || aligned(a.prev, kCols)) &&
             (a.tex == nullptr || aligned(a.tex, kCols));
  vec = vec && (yuv_out ? aligned(a.yuv_out.y, kCols) &&
                              aligned(a.yuv_out.u, kCols / 2) &&
                              aligned(a.yuv_out.v, kCols / 2)
                        : aligned(a.rgba_out, kCols));
  cudaError_t err;
  if (vec) {
    err = yuv_out ? launch<kCols, true, kYuvIn, true>(a, stream)
                  : launch<kCols, true, kYuvIn, false>(a, stream);
  } else {
    err = yuv_out ? launch<kScalarCols, false, kYuvIn, true>(a, stream)
                  : launch<kScalarCols, false, kYuvIn, false>(a, stream);
  }
  return static_cast<int>(err);
}

// The checks both routes share; fills a's method, output and state fields.
bool make_args(const uint8_t* prev, uint8_t* out, uint8_t* out_u,
               uint8_t* out_v, const float* threshold, int height, int width,
               int method, int tff, int matrix_out, FieldArgs& a) {
  if (height <= 0 || width <= 0 || method < kBob || method > kGreedyH ||
      out == nullptr || (out_u == nullptr) != (out_v == nullptr) ||
      matrix_out < 0 || matrix_out > 1 ||
      (prev != nullptr && method != kWeave && method != kGreedyH) ||
      (prev != nullptr && method == kGreedyH && threshold == nullptr))
    return false;
  a.prev = prev;
  a.rgba_out = out_u == nullptr ? out : nullptr;
  a.yuv_out = Yuv420Out{out, out_u, out_v, (width + 1) / 2, matrix_out};
  a.threshold = threshold;
  a.height = height;
  a.width = width;
  a.method = method;
  a.tff = tff;
  return true;
}

}  // namespace

// RGB route: the (4, height, width) uint8 texture `cur` into `out`, RGBA8
// planes of the same shape, or with out_u and out_v 4:2:0 planes (out the Y
// plane; out_u, out_v (ceil(height / 2), ceil(width / 2))) in matrix
// `matrix_out`; on `stream`.  `prev` is nullptr where the method reads no
// previous frame (bob, linear) or none exists yet; `threshold` points to
// greedy-H's float32 motion threshold on the device.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int deinterlace_u8(const uint8_t* cur, const uint8_t* prev,
                              uint8_t* out, uint8_t* out_u, uint8_t* out_v,
                              const float* threshold, int height, int width,
                              int method, int tff, int matrix_out,
                              cudaStream_t stream) {
  FieldArgs a{};
  if (cur == nullptr || !make_args(prev, out, out_u, out_v, threshold, height,
                                   width, method, tff, matrix_out, a))
    return static_cast<int>(cudaErrorInvalidValue);
  a.rgba = cur;
  return launch_route<kRgbCols, false>(a, out_u != nullptr, stream);
}

// 4:2:0 route: the uint8 planes y (height, width), u and v (ceil(height /
// 2), ceil(width / 2)) with their NEAREST chroma taps (row_* and col_*, each
// i0, i1, w0, w1 per output, or all null for an identity axis;
// convert.plan_chroma_taps'), in matrix `matrix_in`; the output as for
// deinterlace_u8; `tex`, where not nullptr, receives the input's (4, height,
// width) RGBA8 texture for the next frame.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int deinterlace_yuv420_u8(
    const uint8_t* y, const uint8_t* u, const uint8_t* v, const int* row_i0,
    const int* row_i1, const float* row_w0, const float* row_w1,
    const int* col_i0, const int* col_i1, const float* col_w0,
    const float* col_w1, const uint8_t* prev, uint8_t* out, uint8_t* out_u,
    uint8_t* out_v, uint8_t* tex, const float* threshold, int height,
    int width, int method, int tff, int matrix_in, int matrix_out,
    cudaStream_t stream) {
  FieldArgs a{};
  const bool bad_taps = (row_i0 == nullptr) != (row_w1 == nullptr) ||
                        (col_i0 == nullptr) != (col_w1 == nullptr);
  if (y == nullptr || u == nullptr || v == nullptr || bad_taps ||
      matrix_in < 0 || matrix_in > 1 ||
      !make_args(prev, out, out_u, out_v, threshold, height, width, method,
                 tff, matrix_out, a))
    return static_cast<int>(cudaErrorInvalidValue);
  a.yuv = Yuv420In{y, u, v, (width + 1) / 2,
                   AxisTaps{row_i0, row_i1, row_w0, row_w1},
                   AxisTaps{col_i0, col_i1, col_w0, col_w1}, matrix_in};
  a.tex = tex;
  return launch_route<kYuvCols, true>(a, out_u != nullptr, stream);
}
