// vfcompositor's blend fold for Hopper (sm_90a): K4 `composite_fold`.
//
// Replaces the compositor fold of tpuvf: the Pallas band fold `pallas_fold`
// (scripts/bench_comp_pallas.py:163, kernel body :112) and its lane-roll
// placement probe `roll_bw` (:192, body :189), whose product is the fold the
// `render_*` bodies of tpuvf/elements/compositor.py run (render_fast :855-886,
// _blend_static :669-674), and the folded vfoverlay's final mix draws
// (apply_folds :676-686).  For each canvas pixel it computes the zorder fold
// of every draw covering it over the background, quantizing to the RGBA8
// render target after each draw, and writes the canvas once:
//
//   v = bg_drawn ? bg[((x >> 3) + ((y + row0) >> 3)) & 1] : 0  (or the canvas,
//       when this launch continues a chain of more than kMaxDraws draws)
//   for each draw d whose clamped rect holds (x, y):
//     s   = source texel at (y - d.y, x - d.x): dequant (u8) or as is (f32)
//     s_a = s[3] * k;  s_c = s[c] * s_a  (c < 3);  s_3 = s_a
//     dv  = dequant(v[c])
//     SOURCE: draw ? s_c : dv;  OVER: s_c + dv * (1 - s_a);  ADD: s_c + dv
//     v[c] = quant(...)        (keep_alpha: c < 3 only, v[3] stays)
//
// A keep_alpha OVER draw is tpuvf's overlay mix, rgb = quant(dequant(v) *
// (1 - a) + ov * a) with a = ov_3 * alpha: the same products and sum
// (addition commutes bit for bit), on the overlay's float32 rect planes.
// The plain version is tpuvf_torch.kernels.composite.composite_fold_plain.
//
// Placement is index arithmetic: the source texel of canvas (x, y) is
// (x - d.x, y - d.y), so negative positions crop the source and do not shift
// it.  The TPU probe's lane roll has no counterpart and is not needed.
//
// What bounds it: memory.  At the config-5 shape (4K canvas; a 4K u8, a
// 1080p f32, a 720p u8 and a 720p f32 source) it reads ~85 MB of sources and
// writes 33 MB of canvas; the fold is a dozen float ops a pixel and draw.
// The design, as K2's (emit.cu): each thread folds a quad of 4 neighbouring
// pixels of one row, in a grid-stride loop over the canvas's quads with as
// many blocks as the card holds resident.
//   - The canvas goes as one uchar4 a plane where its width is a multiple of
//     4 (every row, and so every quad, starts on 4 bytes), else byte by byte.
//   - A draw's source goes as one uchar4 (u8) or float4 (f32) a plane where
//     its placement keeps the quad aligned: d.x % 4 == 0, width % 4 == 0 and
//     the base on the access size (`draw_vector`, chosen per draw by the
//     launcher into DrawDesc::vector).  Then a quad that meets the rect lies
//     wholly inside the placed source.  Otherwise that draw reads lane by
//     lane, and only the lanes inside its rect.
//   - Rect edges that cut a quad are masked per lane; each pixel still folds
//     its draws in draw order.
// The draw descriptors travel in the kernel's by-value parameter (constant
// bank), so a quad's rect tests cost no memory traffic.
//
// Bitwise parity with the plain version, and what this source does for it:
//   - no FMA contraction: every multiply and add is __fmul_rn / __fadd_rn /
//     __fsub_rn, in the plain version's operand order (OVER is
//     s + dv * (1 - s_a));
//   - dequant is v * f32(1/255), as color.dequant;
//   - quant is cvt.rni(clamp(x, 0, 1) * 255) (__float2uint_rn), half to even
//     as torch.round; the clamp is max.NaN / min.NaN, NaN-passing as
//     torch.clamp;
//   - SOURCE replaces inside the clamped rect even where the source alpha is
//     0; ADD saturates through quant's clamp;
//   - a chain of launches is exact: the fold is sequential per pixel and the
//     canvas holds exactly the quantized value the next draw dequantizes.

#include "yuv420.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDraws = 8;
constexpr int kQuad = 4;  // pixels a thread

// kernels/composite.py DrawDesc, field for field.
struct DrawDesc {
  const void* src;  // (4, height, width) planes, uint8 or float32
  int src_f32;
  int width;
  int height;
  int x;  // canvas position of the source's (0, 0)
  int y;
  int x0;  // clamped rect [x0, x1) x [y0, y1), inside canvas and source
  int y0;
  int x1;
  int y1;
  int op;
  float k;  // f32(alpha) * draw
  int draw;
  int keep_alpha;  // 1: blend channels 0-2 only (the overlay mix)
  int vector;  // set by the launcher (draw_vector); the caller's is ignored
};

// kernels/composite.py FoldParams, field for field.
struct FoldParams {
  DrawDesc draws[kMaxDraws];
  int n_draws;
  int height;
  int width;
  int bg_drawn;
  int from_canvas;
  int row0;  // the frame row of canvas row 0 (a row band's checker)
  uint8_t bg[2][4];  // [checker cell][r, g, b, a]
};

// kernels/composite.py OP_SOURCE, OP_OVER, OP_ADD
enum Op : int { kOpSource, kOpOver, kOpAdd };

// The source quad of draw d at canvas (x .. x + 3, y), s[c][lane], as the
// plain version reads it: dequantized u8, or f32 as is.  Lanes outside the
// rect are left unread on the scalar path.
__device__ __forceinline__ void load_source(const DrawDesc& d, int x, int y,
                                            float s[4][kQuad]) {
  const size_t sp = static_cast<size_t>(d.height) * d.width;
  const size_t si = static_cast<size_t>(y - d.y) * d.width + (x - d.x);
  if (d.vector) {
    if (d.src_f32) {
      const float* src = static_cast<const float*>(d.src);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(src + c * sp + si));
        s[c][0] = t.x, s[c][1] = t.y, s[c][2] = t.z, s[c][3] = t.w;
      }
    } else {
      const uint8_t* src = static_cast<const uint8_t*>(d.src);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uchar4 t = __ldg(reinterpret_cast<const uchar4*>(src + c * sp + si));
        s[c][0] = dequant(t.x), s[c][1] = dequant(t.y);
        s[c][2] = dequant(t.z), s[c][3] = dequant(t.w);
      }
    }
    return;
  }
#pragma unroll
  for (int l = 0; l < kQuad; ++l) {
    if (x + l < d.x0 || x + l >= d.x1) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c][l] = d.src_f32
                    ? __ldg(static_cast<const float*>(d.src) + c * sp + si + l)
                    : dequant(__ldg(static_cast<const uint8_t*>(d.src) +
                                    c * sp + si + l));
    }
  }
}

// kVecCanvas: the canvas width is a multiple of kQuad, so every quad is one
// aligned uchar4 of each plane; else the canvas goes byte by byte and the
// last quad of a row is cut at the width.
template <bool kVecCanvas>
__global__ void __launch_bounds__(kThreads)
composite_fold_kernel(const FoldParams p, uint8_t* __restrict__ out) {
  const unsigned quads_row = (p.width + kQuad - 1) / kQuad;
  const unsigned quads = quads_row * p.height;
  const size_t plane = static_cast<size_t>(p.height) * p.width;
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += gridDim.x * blockDim.x) {
    const int y = q / quads_row;
    const int x = (q - y * quads_row) * kQuad;
    const size_t i = static_cast<size_t>(y) * p.width + x;
    uint8_t v[4][kQuad];
    if (p.from_canvas) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kVecCanvas) {
          const uchar4 t = *reinterpret_cast<const uchar4*>(out + c * plane + i);
          v[c][0] = t.x, v[c][1] = t.y, v[c][2] = t.z, v[c][3] = t.w;
        } else {
#pragma unroll
          for (int l = 0; l < kQuad; ++l) {
            v[c][l] = x + l < p.width ? out[c * plane + i + l] : 0;
          }
        }
      }
    } else {
      // the 4 lanes share x >> 3: a quad never straddles a checker cell
      const int cell = ((x >> 3) + ((y + p.row0) >> 3)) & 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int l = 0; l < kQuad; ++l) v[c][l] = p.bg_drawn ? p.bg[cell][c] : 0;
      }
    }
    for (int n = 0; n < p.n_draws; ++n) {
      const DrawDesc& d = p.draws[n];
      if (y < d.y0 || y >= d.y1 || x + kQuad <= d.x0 || x >= d.x1) continue;
      float s[4][kQuad];
      load_source(d, x, y, s);
      const int channels = d.keep_alpha ? 3 : 4;
#pragma unroll
      for (int l = 0; l < kQuad; ++l) {
        if (x + l < d.x0 || x + l >= d.x1) continue;
        const float sa = mul(s[3][l], d.k);
        const float sc[4] = {mul(s[0][l], sa), mul(s[1][l], sa),
                             mul(s[2][l], sa), sa};
        const float keep = sub(1.0f, sa);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= channels) break;
          const float dv = dequant(v[c][l]);
          float blended;
          if (d.op == kOpSource) {
            blended = d.draw > 0 ? sc[c] : dv;
          } else if (d.op == kOpAdd) {
            blended = add(sc[c], dv);
          } else {
            blended = add(sc[c], mul(dv, keep));
          }
          v[c][l] = quant(blended);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kVecCanvas) {
        *reinterpret_cast<uchar4*>(out + c * plane + i) =
            make_uchar4(v[c][0], v[c][1], v[c][2], v[c][3]);
      } else {
#pragma unroll
        for (int l = 0; l < kQuad; ++l) {
          if (x + l < p.width) out[c * plane + i + l] = v[c][l];
        }
      }
    }
  }
}

// Whether a draw's source reads a quad as one vector a plane: the quads
// start on canvas columns that are multiples of 4, so the placement must
// keep them aligned in the source (x % 4 == 0; C's % is 0 for negative
// multiples too), every row and plane must start on a quad (width % 4 ==
// 0), and the base must sit on the access (4 bytes u8, 16 bytes f32).
bool draw_vector(const void* src, int src_f32, int width, int x) {
  const uintptr_t access = src_f32 ? sizeof(float4) : sizeof(uchar4);
  return x % kQuad == 0 && width % kQuad == 0 &&
         reinterpret_cast<uintptr_t>(src) % access == 0;
}

// The grid: enough blocks for one trip over the canvas's quads, at most the
// blocks the card holds resident at once (asked once per kernel and card,
// `resident_blocks`).
template <bool kVecCanvas>
void launch(const FoldParams& p, uint8_t* out, unsigned quads,
            cudaStream_t stream) {
  static PerDevice resident = {};
  const auto kernel = composite_fold_kernel<kVecCanvas>;
  const int blocks = resident_blocks(kernel, kThreads, resident);
  const long long needed = (static_cast<long long>(quads) + kThreads - 1) / kThreads;
  kernel<<<static_cast<int>(needed < blocks ? needed : blocks), kThreads, 0,
           stream>>>(p, out);
}

}  // namespace

// One launch folding params->n_draws (<= kMaxDraws) draws into `out`
// ((4, height, width) uint8 planes), on `stream`.  `params` points to a
// FoldParams in host memory, copied into the launch; the launcher sets each
// draw's `vector` from `draw_vector`.  It travels as void*: declared with a
// parameter of FoldParams, a type of the anonymous namespace, the function's
// symbol was missing from the library nvcc built.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int composite_fold(const void* params, uint8_t* out,
                              cudaStream_t stream) {
  FoldParams p = *static_cast<const FoldParams*>(params);
  if (p.n_draws < 0 || p.n_draws > kMaxDraws || p.height <= 0 ||
      p.width <= 0 || out == nullptr ||
      (static_cast<long long>(p.width) + kQuad) * p.height > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int n = 0; n < p.n_draws; ++n) {
    DrawDesc& d = p.draws[n];
    d.vector = draw_vector(d.src, d.src_f32, d.width, d.x);
  }
  const unsigned quads =
      static_cast<unsigned>((p.width + kQuad - 1) / kQuad) * p.height;
  const bool vec_canvas = p.width % kQuad == 0 &&
                          reinterpret_cast<uintptr_t>(out) % sizeof(uchar4) == 0;
  vec_canvas ? launch<true>(p, out, quads, stream)
             : launch<false>(p, out, quads, stream);
  return static_cast<int>(cudaGetLastError());
}

// 1 where composite_fold reads a draw of this source (its base, uint8 or
// float32, its width and its canvas column x) a quad at a time, else 0 (lane
// by lane).  For reports: the launch decides by itself.
extern "C" int composite_draw_vector_path(const void* src, int src_f32,
                                          int width, int x) {
  return draw_vector(src, src_f32, width, x);
}
