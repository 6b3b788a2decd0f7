// vfdeinterlace's field kernel for Hopper (sm_90a): K5 `deinterlace_u8`.
//
// Replaces the XLA fusion of tpuvf's full-frame deinterlace bodies
// (tpuvf/kernels/deinterlace.py:135-152, `bob_t`, `weave_t`, `greedyh_t`,
// with the first-frame fallback of tpuvf/elements/deinterlace.py:460-470).
// On the RGBA8 texture of the input `cur` and of the previous input `prev`
// ((4, H, W) uint8 planes), per pixel:
//
//   keep = ((y % 2) == 0) == tff                 (rows of the full frame)
//   keep:  out = quant(dq(cur))
//   else:  bob = (dq(cur[y - 1]) + dq(cur[y + 1])) * 0.5   (rows clamped)
//          prev == nullptr (bob, linear, or no previous frame yet): bob
//          weave:    dq(prev)
//          greedy-H: dq(prev) where sqrt(d0*d0 + d1*d1 + d2*d2) < thr,
//                    else bob    (d_c = dq(cur_c) - dq(prev_c), c < 3)
//          out = quant(...)
//
// The plain version is tpuvf_torch.kernels.deinterlace.deinterlace_plain.
//
// What bounds it: memory.  At 1080p it reads the 8.3 MB input texture (the
// neighbour rows of a discarded row come from L1/L2), the 8.3 MB previous
// texture on half the rows, and writes 8.3 MB; a pixel costs about twenty
// float ops.  One thread per pixel along the width, grid-stride over rows:
// the kept/discarded test is uniform across a warp (one row), so only
// greedy-H's per-pixel select diverges, and it is a select.  The threshold
// is read from device memory (a 0-dim tensor, like K2's params), so no frame
// waits for the host.
//
// Bitwise parity with the plain version, and what this source does for it:
//   - greedy-H's `motion < thr` is a knife edge: one ulp in motion moves a
//     pixel from prev to bob.  Every op is __fmul_rn / __fadd_rn / __fsub_rn
//     / __fsqrt_rn in tpuvf's order ((d0*d0 + d1*d1) + d2*d2), so nvcc
//     contracts nothing into an FMA;
//   - dequant is v * f32(1/255), as color.dequant; quant is
//     rintf(clamp(x, 0, 1) * 255), half to even as torch.round;
//   - odd heights: the last row's row + 1 clamps to itself.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// kernels/deinterlace.py METHOD_BOB, METHOD_WEAVE, METHOD_LINEAR,
// METHOD_GREEDYH
enum Method : int { kBob, kWeave, kLinear, kGreedyH };

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
deinterlace_kernel(const uint8_t* __restrict__ cur,
                   const uint8_t* __restrict__ prev, uint8_t* __restrict__ out,
                   const float* __restrict__ threshold, int height, int width,
                   int method, int tff) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= width) return;
  const size_t plane = static_cast<size_t>(height) * width;
  const bool greedy = prev != nullptr && method == kGreedyH;
  const float thr = greedy ? __ldg(threshold) : 0.0f;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    const size_t i = static_cast<size_t>(y) * width + x;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = dequant(__ldg(cur + c * plane + i));
    const bool keep = ((y & 1) == 0) == (tff != 0);
    if (!keep) {
      const size_t up = static_cast<size_t>(y > 0 ? y - 1 : 0) * width + x;
      const size_t down =
          static_cast<size_t>(y + 1 < height ? y + 1 : height - 1) * width + x;
      float repl[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        repl[c] = mul(add(dequant(__ldg(cur + c * plane + up)),
                          dequant(__ldg(cur + c * plane + down))),
                      0.5f);
      if (prev != nullptr) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) p[c] = dequant(__ldg(prev + c * plane + i));
        bool take_prev = true;  // weave
        if (greedy) {
          const float d0 = sub(v[0], p[0]);
          const float d1 = sub(v[1], p[1]);
          const float d2 = sub(v[2], p[2]);
          const float motion =
              __fsqrt_rn(add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2)));
          take_prev = motion < thr;
        }
        if (take_prev) {
#pragma unroll
          for (int c = 0; c < 4; ++c) repl[c] = p[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = repl[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * plane + i] = quant(v[c]);
  }
}

}  // namespace

// One launch over (4, height, width) uint8 planes on `stream`.  `prev` is
// nullptr where the method reads no previous frame (bob, linear) or none
// exists yet; `threshold` points to greedy-H's float32 motion threshold on
// the device.  Returns the launch's cudaError_t (0 on success).
extern "C" int deinterlace_u8(const uint8_t* cur, const uint8_t* prev,
                              uint8_t* out, const float* threshold, int height,
                              int width, int method, int tff,
                              cudaStream_t stream) {
  if (height <= 0 || width <= 0 || method < kBob || method > kGreedyH ||
      (prev != nullptr && method != kWeave && method != kGreedyH) ||
      (prev != nullptr && method == kGreedyH && threshold == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const dim3 grid((width + kThreads - 1) / kThreads,
                  height < kMaxGridY ? height : kMaxGridY);
  deinterlace_kernel<<<grid, block, 0, stream>>>(cur, prev, out, threshold,
                                                 height, width, method, tff);
  return static_cast<int>(cudaGetLastError());
}
