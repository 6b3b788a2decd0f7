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
//   for each drawn draw d whose clamped rect holds (x, y):
//     s   = source texel at (y - d.y, x - d.x): dequant (u8) or as is (f32)
//     s_a = s[3] * k;  s_c = s[c] * s_a  (c < 3);  s_3 = s_a
//     dv  = dequant(v[c])
//     SOURCE: s_c;  OVER: s_c + dv * (1 - s_a);  ADD: s_c + dv
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
//     the base on the access size (`draw_vector`: the launcher checks the
//     source, the kernel the table's x).  Then a quad that meets the rect lies
//     wholly inside the placed source.  Otherwise that draw reads lane by
//     lane, and only the lanes inside its rect.
//   - Rect edges that cut a quad are masked per lane; each pixel still folds
//     its draws in draw order.
//
// The draw table.  What changes from frame to frame lies in an int32 table
// in device memory (kernels/composite.py pack_table): [bg_drawn, then per
// draw x, y, x0, y0, x1, y1, op, k (float32 bits), drawn], in frame
// coordinates.  The by-value parameter holds only what a captured CUDA graph
// fixes: the canvas size and row origin, the draw count and the chunk's
// first draw, each draw's source pointer, type, size and keep_alpha.  So a
// moving pad replays the same graph.  Each block reads its chunk's rows of
// the table once into shared memory (`place`): it clamps each rect to the
// canvas rows [row0, row0 + height) and columns and to the placed source,
// moves it to the canvas's rows, empties it where the draw's flag is 0, and
// decides the draw's vector path from its x.  A quad's rect tests then read
// shared memory, a broadcast.
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

// kernels/composite.py TABLE_HEAD, TABLE_FIELDS: the table's layout.
constexpr int kTableHead = 1;
constexpr int kTableFields = 9;

// kernels/composite.py DrawDesc, field for field.
struct DrawDesc {
  const void* src;  // (4, height, width) planes, uint8 or float32
  int src_f32;
  int width;
  int height;
  int keep_alpha;  // 1: blend channels 0-2 only (the overlay mix)
  int aligned;  // set by the launcher: width % 4 == 0, base on the access
};

// kernels/composite.py FoldParams, field for field.
struct FoldParams {
  DrawDesc draws[kMaxDraws];
  const int* table;  // the draw table on the card (see the header)
  int first;  // the table row of draws[0]
  int n_draws;
  int height;
  int width;
  int from_canvas;
  int row0;  // the frame row of canvas row 0 (a row band's rows)
  uint8_t bg[2][4];  // [checker cell][r, g, b, a]
};

// One draw as the block reads it from the table, in the canvas's rows.
struct Placed {
  int x;  // canvas position of the source's (0, 0)
  int y;
  int x0;  // clamped rect [x0, x1) x [y0, y1), inside canvas and source;
  int y0;  // empty where the draw is not drawn
  int x1;
  int y1;
  int op;
  float k;  // f32(alpha)
  int vector;  // draw_vector of the draw's source at x
};

// kernels/composite.py OP_SOURCE, OP_OVER, OP_ADD
enum Op : int { kOpSource, kOpOver, kOpAdd };

// The source quad of draw d (placed at q) at canvas (x .. x + 3, y),
// s[c][lane], as the plain version reads it: dequantized u8, or f32 as is.
// Lanes outside the rect are left unread on the scalar path.
__device__ __forceinline__ void load_source(const DrawDesc& d,
                                            const Placed& q, int x, int y,
                                            float s[4][kQuad]) {
  const size_t sp = static_cast<size_t>(d.height) * d.width;
  const size_t si = static_cast<size_t>(y - q.y) * d.width + (x - q.x);
  if (q.vector) {
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
    if (x + l < q.x0 || x + l >= q.x1) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c][l] = d.src_f32
                    ? __ldg(static_cast<const float*>(d.src) + c * sp + si + l)
                    : dequant(__ldg(static_cast<const uint8_t*>(d.src) +
                                    c * sp + si + l));
    }
  }
}

__device__ __forceinline__ long long lo_max(long long a, long long b) {
  return a > b ? a : b;
}
__device__ __forceinline__ long long lo_min(long long a, long long b) {
  return a < b ? a : b;
}

// Draw n of the launch as table row p.first + n gives it, in the canvas's
// rows (the plain version's `placed_draws`, integer for integer; the
// clamps run in 64 bits, as xpos has the full int range).
__device__ __forceinline__ Placed place(const FoldParams& p, int n) {
  const DrawDesc& d = p.draws[n];
  const int* t = p.table + kTableHead + (p.first + n) * kTableFields;
  const long long x = t[0], y = t[1], row0 = p.row0;
  const long long x0 = lo_max(lo_max(t[2], x), 0);
  const long long x1 = lo_min(lo_min(t[4], x + d.width), p.width);
  const long long y0 = lo_max(lo_max(t[3], y), row0);
  const long long y1 = lo_min(lo_min(t[5], y + d.height), row0 + p.height);
  Placed q = {0, 0, 0, 0, 0, 0, t[6], __int_as_float(t[7]), 0};
  if (t[8] == 0 || x1 <= x0 || y1 <= y0) return q;  // empty: never drawn
  // a rect that holds a pixel keeps x and y - row0 within a source's size
  // of the canvas, so they fit an int
  q.x = static_cast<int>(x);
  q.y = static_cast<int>(y - p.row0);
  q.x0 = static_cast<int>(x0);
  q.x1 = static_cast<int>(x1);
  q.y0 = static_cast<int>(y0 - p.row0);
  q.y1 = static_cast<int>(y1 - p.row0);
  q.vector = d.aligned && q.x % kQuad == 0;
  return q;
}

// kVecCanvas: the canvas width is a multiple of kQuad, so every quad is one
// aligned uchar4 of each plane; else the canvas goes byte by byte and the
// last quad of a row is cut at the width.
template <bool kVecCanvas>
__global__ void __launch_bounds__(kThreads)
composite_fold_kernel(const FoldParams p, uint8_t* __restrict__ out) {
  __shared__ Placed placed[kMaxDraws];
  __shared__ int bg_drawn;
  if (threadIdx.x < p.n_draws) placed[threadIdx.x] = place(p, threadIdx.x);
  if (threadIdx.x == 0) bg_drawn = p.table[0];
  __syncthreads();
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
        for (int l = 0; l < kQuad; ++l) v[c][l] = bg_drawn ? p.bg[cell][c] : 0;
      }
    }
    for (int n = 0; n < p.n_draws; ++n) {
      const Placed& d = placed[n];
      if (y < d.y0 || y >= d.y1 || x + kQuad <= d.x0 || x >= d.x1) continue;
      float s[4][kQuad];
      load_source(p.draws[n], d, x, y, s);
      const int channels = p.draws[n].keep_alpha ? 3 : 4;
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
            blended = sc[c];
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
// 0), and the base must sit on the access (4 bytes u8, 16 bytes f32).  The
// launcher decides the last two (`aligned`), the kernel the first from the
// table's x (`place`).
bool draw_aligned(const void* src, int src_f32, int width) {
  const uintptr_t access = src_f32 ? sizeof(float4) : sizeof(uchar4);
  return width % kQuad == 0 && reinterpret_cast<uintptr_t>(src) % access == 0;
}

bool draw_vector(const void* src, int src_f32, int width, int x) {
  return x % kQuad == 0 && draw_aligned(src, src_f32, width);
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

// One launch folding params->n_draws (<= kMaxDraws) draws, table rows
// params->first onward, into `out` ((4, height, width) uint8 planes), on
// `stream`.  `params` points to a FoldParams in host memory, copied into the
// launch; the launcher sets each draw's `aligned`.  It travels as void*:
// declared with a parameter of FoldParams, a type of the anonymous
// namespace, the function's symbol was missing from the library nvcc built.
// Returns the launch's cudaError_t (0 on success).
extern "C" int composite_fold(const void* params, uint8_t* out,
                              cudaStream_t stream) {
  FoldParams p = *static_cast<const FoldParams*>(params);
  if (p.n_draws < 0 || p.n_draws > kMaxDraws || p.first < 0 ||
      p.height <= 0 || p.width <= 0 || out == nullptr ||
      p.table == nullptr ||
      (static_cast<long long>(p.width) + kQuad) * p.height > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int n = 0; n < p.n_draws; ++n) {
    DrawDesc& d = p.draws[n];
    d.aligned = draw_aligned(d.src, d.src_f32, d.width);
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
