// Trilinear 3D-LUT lookup for Hopper (sm_90a): K3 `lut3d_trilinear_f32`.
//
// Replaces the LUT-gather Pallas probes of tpuvf (scripts/bench_gather.py:111
// `_pallas_take24`, :132, :161, :189; scripts/bench_gather2.py:129, :154,
// :184; scripts/bench_gather6.py:95, :133), whose product is
// tpuvf/kernels/filter.py::apply_lut_t (:363), vfvideofilter's trilinear
// lookup (metalvideofilter_shaders.h:188-194).  It computes exactly the
// plain version tpuvf_torch.kernels.filter.apply_lut_t_plain:
//
//     pr = r*(S-1);  r0 = clip(floor(pr), 0, S-1);  fr = pr - floor(pr)
//     cell = (b0*S + g0)*S + r0
//     wk = (w_fb[db]*w_fg[dg])*w_fr[dr],  db, dg, dr = (k>>2)&1, (k>>1)&1, k&1
//     out_c = sum over k = 0..7, in order, of wk * table[cell, 3k + c]
//
// on the corner-packed (S^3, 24) float32 table of pack_lut_corners (the 8
// corners of each cell, +1 neighbours clamped at the edges, in one 96-byte
// row).  Alpha passes through.  With `quantize` the epilogue writes all four
// channels as uint8 RGBA planes, the render-target store
// rint(clamp(x, 0, 1) * 255) (half to even, as torch.round), so the LUT
// stage ends in this one launch.
//
// What bounds it: one 96-byte table row per pixel (six 16-byte loads) plus
// 16 bytes in and 4 (u8) or 16 (f32) bytes out.  A 33^3 f32 table is
// 3.45 MB and a 64^3 table 25.2 MB, so either stays resident in the 50 MB
// L2 and the gather is an ordinary L2 load; device memory sees little more
// than the planes.  The TPU probes fought a ~2 ns/index gather wall with
// corner splitting and transposed gathers; none of that is carried over.
// The design is the simple one: one thread per pixel, grid-stride.
//
// Bitwise contract: every multiply and add is __fmul_rn / __fadd_rn (no FMA
// contraction), in the plain version's order, so the f32 output is
// torch.equal to it; rintf, not roundf, in the quantizer.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint8_t quant(float x) {
  return static_cast<uint8_t>(
      rintf(__fmul_rn(fminf(fmaxf(x, 0.0f), 1.0f), 255.0f)));
}

// -> (lower index, fraction, {1 - fraction, fraction}) of one axis.
__device__ __forceinline__ int axis_cell(float x, float s1, float w[2]) {
  const float p = __fmul_rn(x, s1);
  const float fl = floorf(p);
  const float f = __fsub_rn(p, fl);
  w[0] = __fsub_rn(1.0f, f);
  w[1] = f;
  return static_cast<int>(fminf(fmaxf(fl, 0.0f), s1));
}

// in: (4, n) float32 planes r, g, b, a; out: (4, n) float32 or uint8.
template <bool kQuantize>
__global__ void lut3d_kernel(const float* __restrict__ in,
                             const float* __restrict__ table, int size, int n,
                             void* __restrict__ out) {
  const float s1 = static_cast<float>(size - 1);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float wr[2], wg[2], wb[2];
    const int r0 = axis_cell(__ldg(in + i), s1, wr);
    const int g0 = axis_cell(__ldg(in + n + i), s1, wg);
    const int b0 = axis_cell(__ldg(in + 2 * n + i), s1, wb);
    const float alpha = __ldg(in + 3 * n + i);
    const int cell = (b0 * size + g0) * size + r0;
    const float4* row = reinterpret_cast<const float4*>(table) + cell * 6;
    float corner[24];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 v = __ldg(row + q);
      corner[4 * q] = v.x;
      corner[4 * q + 1] = v.y;
      corner[4 * q + 2] = v.z;
      corner[4 * q + 3] = v.w;
    }
    float acc[3];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wk =
          __fmul_rn(__fmul_rn(wb[(k >> 2) & 1], wg[(k >> 1) & 1]), wr[k & 1]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t = __fmul_rn(wk, corner[3 * k + c]);
        acc[c] = k == 0 ? t : __fadd_rn(acc[c], t);
      }
    }
    if (kQuantize) {
      uint8_t* o = static_cast<uint8_t*>(out);
      o[i] = quant(acc[0]);
      o[n + i] = quant(acc[1]);
      o[2 * n + i] = quant(acc[2]);
      o[3 * n + i] = quant(alpha);
    } else {
      float* o = static_cast<float*>(out);
      o[i] = acc[0];
      o[n + i] = acc[1];
      o[2 * n + i] = acc[2];
      o[3 * n + i] = alpha;
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 on success); the wrapper raises on non-zero.
// `table` must be 16-byte aligned (a torch allocation is).
extern "C" int lut3d_trilinear_f32(const float* in, const float* table,
                                   int size, int n, void* out, int quantize,
                                   cudaStream_t stream) {
  if (size < 2 || size > 64 || n <= 0 || n > INT32_MAX / 4 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long want = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  if (quantize) {
    lut3d_kernel<true><<<blocks, kThreads, 0, stream>>>(in, table, size, n,
                                                         out);
  } else {
    lut3d_kernel<false><<<blocks, kThreads, 0, stream>>>(in, table, size, n,
                                                          out);
  }
  return static_cast<int>(cudaGetLastError());
}
