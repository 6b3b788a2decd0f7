// Separable 2-tap resampler for Hopper (sm_90a): K1 (rows) and K1b (columns).
//
// K1 `resample_rows_f32` replaces tpuvf's Pallas kernel
// tpuvf/kernels/pallas/resample.py::banded_resample_rows; K1b
// `resample_cols_f32` replaces its column twin, the blockband MXU einsum
// tpuvf/kernels/sample.py::_blockband_cols.  Both compute
//
//     out[..., o, :] = w0[o] * in[..., i0[o], :] + w1[o] * in[..., i1[o], :]
//
// along their axis, with the taps read from per-output tables that
// tpuvf_torch.kernels.sample.plan_taps takes from the dense sampling
// matrix's nonzeros (clamp-to-edge and letterbox masks are folded into the
// tables).  Leading plane dims are flattened, so U and V go in one launch.
//
// What bounds them: memory.  Each output reads two inputs and writes one
// (12 bytes per 2 multiplies and 1 add); neighbouring output rows (K1) or
// columns (K1b) reuse the same input rows, which L2 (50 MB) holds, so device
// memory traffic is close to one read of the input plus one write of the
// output.  The design is the simple one: one thread per output element
// (K1: one float4 per thread along the contiguous width where the rows are
// 16-byte aligned), taps read from global memory, no shared-memory banding
// yet.  The Mosaic alignment rules of the TPU kernel (8-row bands, 128-lane
// padding, padded sample rows) do not apply here and are gone.
//
// Bitwise contract: the arithmetic uses __fmul_rn / __fadd_rn, so no FMA
// contraction happens and each output is round(round(w0*a) + round(w1*b)),
// exactly what the plain PyTorch version (separate mul and add ops) gives.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float tap2(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// in (planes, in_h, width) -> out (planes, out_h, width); `rows` is
// planes * out_h.  kVec4: x counts float4 groups (width % 4 == 0, aligned).
template <bool kVec4>
__global__ void resample_rows_kernel(const float* __restrict__ in,
                                     float* __restrict__ out,
                                     const int* __restrict__ i0,
                                     const int* __restrict__ i1,
                                     const float* __restrict__ w0,
                                     const float* __restrict__ w1, int rows,
                                     int in_h, int out_h, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int nx = kVec4 ? width / 4 : width;
  if (x >= nx) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int p = row / out_h;
    const int r = row - p * out_h;
    const size_t plane = static_cast<size_t>(p) * in_h * width;
    const float* a_row = in + plane + static_cast<size_t>(__ldg(i0 + r)) * width;
    const float* b_row = in + plane + static_cast<size_t>(__ldg(i1 + r)) * width;
    float* o_row = out + static_cast<size_t>(row) * width;
    const float wa = __ldg(w0 + r);
    const float wb = __ldg(w1 + r);
    if (kVec4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(a_row) + x);
      const float4 b = __ldg(reinterpret_cast<const float4*>(b_row) + x);
      float4 o;
      o.x = tap2(wa, a.x, wb, b.x);
      o.y = tap2(wa, a.y, wb, b.y);
      o.z = tap2(wa, a.z, wb, b.z);
      o.w = tap2(wa, a.w, wb, b.w);
      reinterpret_cast<float4*>(o_row)[x] = o;
    } else {
      o_row[x] = tap2(wa, __ldg(a_row + x), wb, __ldg(b_row + x));
    }
  }
}

// in (rows, in_w) -> out (rows, out_w); `rows` is planes * height.  The
// taps of a column are the same on every row, so each thread loads its own
// once and walks the rows.
__global__ void resample_cols_kernel(const float* __restrict__ in,
                                     float* __restrict__ out,
                                     const int* __restrict__ i0,
                                     const int* __restrict__ i1,
                                     const float* __restrict__ w0,
                                     const float* __restrict__ w1, int rows,
                                     int in_w, int out_w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= out_w) return;
  const int a = __ldg(i0 + c);
  const int b = __ldg(i1 + c);
  const float wa = __ldg(w0 + c);
  const float wb = __ldg(w1 + c);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* src = in + static_cast<size_t>(row) * in_w;
    out[static_cast<size_t>(row) * out_w + c] =
        tap2(wa, __ldg(src + a), wb, __ldg(src + b));
  }
}

bool fits_int(long long v) { return v >= 0 && v <= INT32_MAX; }

}  // namespace

// Returns a cudaError_t (0 on success); the wrapper raises on non-zero.
extern "C" int resample_rows_f32(const float* in, float* out, const int* i0,
                                 const int* i1, const float* w0,
                                 const float* w1, int planes, int in_h,
                                 int out_h, int width, cudaStream_t stream) {
  const long long rows = static_cast<long long>(planes) * out_h;
  if (planes <= 0 || in_h <= 0 || out_h <= 0 || width <= 0 || !fits_int(rows) ||
      !fits_int(static_cast<long long>(planes) * in_h * width) ||
      !fits_int(rows * width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = width % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int nx = vec4 ? width / 4 : width;
  const dim3 grid((nx + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  if (vec4) {
    resample_rows_kernel<true><<<grid, kThreads, 0, stream>>>(
        in, out, i0, i1, w0, w1, static_cast<int>(rows), in_h, out_h, width);
  } else {
    resample_rows_kernel<false><<<grid, kThreads, 0, stream>>>(
        in, out, i0, i1, w0, w1, static_cast<int>(rows), in_h, out_h, width);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resample_cols_f32(const float* in, float* out, const int* i0,
                                 const int* i1, const float* w0,
                                 const float* w1, int planes, int height,
                                 int in_w, int out_w, cudaStream_t stream) {
  const long long rows = static_cast<long long>(planes) * height;
  if (planes <= 0 || height <= 0 || in_w <= 0 || out_w <= 0 || !fits_int(rows) ||
      !fits_int(rows * in_w) || !fits_int(rows * out_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((out_w + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  resample_cols_kernel<<<grid, kThreads, 0, stream>>>(
      in, out, i0, i1, w0, w1, static_cast<int>(rows), in_w, out_w);
  return static_cast<int>(cudaGetLastError());
}
