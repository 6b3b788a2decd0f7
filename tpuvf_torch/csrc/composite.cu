// vfcompositor's blend fold for Hopper (sm_90a): K4 `composite_fold`.
//
// Replaces the compositor fold of tpuvf: the Pallas band fold `pallas_fold`
// (scripts/bench_comp_pallas.py:163, kernel body :112) and its lane-roll
// placement probe `roll_bw` (:192, body :189), whose product is the fold the
// `render_*` bodies of tpuvf/elements/compositor.py run (render_fast :855-886,
// _blend_static :669-674).  For each canvas pixel it computes the zorder fold
// of every draw covering it over the background, quantizing to the RGBA8
// render target after each draw, and writes the canvas once:
//
//   v = bg_drawn ? bg[((x >> 3) + (y >> 3)) & 1] : 0      (or the canvas,
//       when this launch continues a chain of more than kMaxDraws draws)
//   for each draw d whose clamped rect holds (x, y):
//     s   = source texel at (y - d.y, x - d.x): dequant (u8) or as is (f32)
//     s_a = s[3] * k;  s_c = s[c] * s_a  (c < 3);  s_3 = s_a
//     dv  = dequant(v[c])
//     SOURCE: draw ? s_c : dv;  OVER: s_c + dv * (1 - s_a);  ADD: s_c + dv
//     v[c] = quant(...)
//
// The plain version is tpuvf_torch.kernels.composite.composite_fold_plain.
//
// Placement is index arithmetic: the source texel of canvas (x, y) is
// (x - d.x, y - d.y), so negative positions crop the source and do not shift
// it.  The TPU probe's lane roll has no counterpart and is not needed.
//
// What bounds it: memory.  At the config-5 shape (4K canvas; a 4K u8, a
// 1080p f32, a 720p u8 and a 720p f32 source) it reads ~85 MB of sources and
// writes 33 MB of canvas; the fold is a dozen float ops a pixel and draw.
// One thread per pixel along the width (grid-stride over rows): each warp
// reads 32 consecutive texels of each source plane and stores 32
// consecutive bytes of each canvas plane.  The draw descriptors travel in
// the kernel's by-value parameter (constant bank), so a pixel's rect tests
// cost no memory traffic.
//
// Bitwise parity with the plain version, and what this source does for it:
//   - no FMA contraction: every multiply and add is __fmul_rn / __fadd_rn /
//     __fsub_rn, in the plain version's operand order (OVER is
//     s + dv * (1 - s_a));
//   - dequant is v * f32(1/255), as color.dequant;
//   - quant is rintf(clamp(x, 0, 1) * 255), half to even as torch.round;
//   - SOURCE replaces inside the clamped rect even where the source alpha is
//     0; ADD saturates through quant's clamp;
//   - a chain of launches is exact: the fold is sequential per pixel and the
//     canvas holds exactly the quantized value the next draw dequantizes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxDraws = 8;

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
};

// kernels/composite.py FoldParams, field for field.
struct FoldParams {
  DrawDesc draws[kMaxDraws];
  int n_draws;
  int height;
  int width;
  int bg_drawn;
  int from_canvas;
  uint8_t bg[2][4];  // [checker cell][r, g, b, a]
};

// kernels/composite.py OP_SOURCE, OP_OVER, OP_ADD
enum Op : int { kOpSource, kOpOver, kOpAdd };

constexpr float kInv255 = static_cast<float>(1.0 / 255.0);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ uint8_t quant(float x) {
  return static_cast<uint8_t>(rintf(mul(clamp01(x), 255.0f)));
}

__device__ __forceinline__ float dequant(uint8_t v) {
  return mul(static_cast<float>(v), kInv255);
}

__global__ void __launch_bounds__(kThreads)
composite_fold_kernel(const FoldParams p, uint8_t* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= p.width) return;
  const size_t plane = static_cast<size_t>(p.height) * p.width;
  for (int y = blockIdx.y; y < p.height; y += gridDim.y) {
    const size_t i = static_cast<size_t>(y) * p.width + x;
    uint8_t v[4];
    if (p.from_canvas) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = out[c * plane + i];
    } else if (p.bg_drawn) {
      const int cell = ((x >> 3) + (y >> 3)) & 1;
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = p.bg[cell][c];
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = 0;
    }
    for (int n = 0; n < p.n_draws; ++n) {
      const DrawDesc& d = p.draws[n];
      if (x < d.x0 || x >= d.x1 || y < d.y0 || y >= d.y1) continue;
      const size_t sp = static_cast<size_t>(d.height) * d.width;
      const size_t si = static_cast<size_t>(y - d.y) * d.width + (x - d.x);
      float s[4];
      if (d.src_f32) {
        const float* src = static_cast<const float*>(d.src);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = __ldg(src + c * sp + si);
      } else {
        const uint8_t* src = static_cast<const uint8_t*>(d.src);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = dequant(__ldg(src + c * sp + si));
      }
      const float sa = mul(s[3], d.k);
      const float sc[4] = {mul(s[0], sa), mul(s[1], sa), mul(s[2], sa), sa};
      const float keep = sub(1.0f, sa);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float dv = dequant(v[c]);
        float blended;
        if (d.op == kOpSource) {
          blended = d.draw > 0 ? sc[c] : dv;
        } else if (d.op == kOpAdd) {
          blended = add(sc[c], dv);
        } else {
          blended = add(sc[c], mul(dv, keep));
        }
        v[c] = quant(blended);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * plane + i] = v[c];
  }
}

}  // namespace

// One launch folding params->n_draws (<= kMaxDraws) draws into `out`
// ((4, height, width) uint8 planes), on `stream`.  `params` points to a
// FoldParams in host memory, copied into the launch.  It travels as void*:
// declared with a parameter of FoldParams, a type of the anonymous
// namespace, the function's symbol was missing from the library nvcc built.
// Returns the launch's cudaError_t (0 on success).
extern "C" int composite_fold(const void* params, uint8_t* out,
                              cudaStream_t stream) {
  const FoldParams p = *static_cast<const FoldParams*>(params);
  if (p.n_draws < 0 || p.n_draws > kMaxDraws || p.height <= 0 || p.width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const dim3 grid((p.width + kThreads - 1) / kThreads,
                  p.height < kMaxGridY ? p.height : kMaxGridY);
  composite_fold_kernel<<<grid, block, 0, stream>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
