// vfoverlay's rect blend for Hopper (sm_90a): K6 `overlay_blend_u8`.
//
// Replaces the XLA fusion of tpuvf's canonical overlay body
// (tpuvf/elements/overlay.py:595-607): the frame's float32 RGBA, the
// premultiplied overlay resampled to its rect on the host at build time, and
// per pixel
//
//   v   = src_f32 ? src : dq(src)
//   inside [x0, x1) x [y0, y1):  a = ov[3] * alpha
//                                v[c] = v[c] * (1 - a) + ov[c] * a   (c < 3)
//   out = quant(v)          (all four channels; alpha is not blended)
//
// tpuvf zero-pads the overlay to the frame, which makes the blend an exact
// identity outside the rect (v * 1 + 0 == v); the kernel does not blend
// there.  An empty rect (an overlay fully off the frame) quantizes only.
//
// The plain version is tpuvf_torch.kernels.overlay.overlay_blend_plain.
//
// What bounds it: memory.  At config 5's shape it reads the 33 MB 4K RGBA8
// canvas and writes 33 MB; the 256x256 rect adds 1 MB of float32 overlay.
// One thread per pixel along the width, grid-stride over rows; a warp
// reads 32 consecutive texels of each plane.  The rect test is per row and
// column, uniform across most warps.  `alpha` is read from device memory (a
// 0-dim tensor), so no frame waits for the host.
//
// Bitwise parity with the plain version, and what this source does for it:
//   - the blend v * (1 - a) + o * a is an FMA site: every op is __fmul_rn /
//     __fadd_rn / __fsub_rn in tpuvf's order, so nvcc contracts nothing;
//   - dequant is v * f32(1/255), as color.dequant; quant is
//     rintf(clamp(x, 0, 1) * 255), half to even as torch.round.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

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
overlay_blend_kernel(const void* __restrict__ src, int src_f32,
                     uint8_t* __restrict__ out, int height, int width,
                     const float* __restrict__ ov, int x0, int x1, int y0,
                     int y1, const float* __restrict__ alpha) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= width) return;
  const size_t plane = static_cast<size_t>(height) * width;
  const int rw = x1 - x0;
  const size_t rplane = static_cast<size_t>(y1 - y0) * rw;
  const bool in_x = x >= x0 && x < x1;
  const float k = in_x ? __ldg(alpha) : 0.0f;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    const size_t i = static_cast<size_t>(y) * width + x;
    float v[4];
    if (src_f32) {
      const float* s = static_cast<const float*>(src);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = __ldg(s + c * plane + i);
    } else {
      const uint8_t* s = static_cast<const uint8_t*>(src);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = dequant(__ldg(s + c * plane + i));
    }
    if (in_x && y >= y0 && y < y1) {
      const size_t j = static_cast<size_t>(y - y0) * rw + (x - x0);
      const float a = mul(__ldg(ov + 3 * rplane + j), k);
      const float keep = sub(1.0f, a);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = add(mul(v[c], keep), mul(__ldg(ov + c * rplane + j), a));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * plane + i] = quant(v[c]);
  }
}

}  // namespace

// One launch over the (4, height, width) frame `src` (uint8, or float32
// when src_f32) into the uint8 planes `out`, on `stream`.  `ov` holds the
// (4, y1 - y0, x1 - x0) float32 premultiplied overlay of the rect, or is
// nullptr for an empty rect; `alpha` points to the float32 opacity on the
// device.  Returns the launch's cudaError_t (0 on success).
extern "C" int overlay_blend_u8(const void* src, int src_f32, uint8_t* out,
                                int height, int width, const float* ov, int x0,
                                int x1, int y0, int y1, const float* alpha,
                                cudaStream_t stream) {
  if (height <= 0 || width <= 0 || alpha == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ov == nullptr || x1 <= x0 || y1 <= y0) {
    ov = nullptr;
    x0 = x1 = y0 = y1 = 0;  // no pixel is inside
  } else if (x0 < 0 || y0 < 0 || x1 > width || y1 > height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kThreads);
  const dim3 grid((width + kThreads - 1) / kThreads,
                  height < kMaxGridY ? height : kMaxGridY);
  overlay_blend_kernel<<<grid, block, 0, stream>>>(
      src, src_f32, out, height, width, ov, x0, x1, y0, y1, alpha);
  return static_cast<int>(cudaGetLastError());
}
