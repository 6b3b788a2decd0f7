// The host edge's raw copies, each one C call on `stream`:
//
// - `copy_rows_h2d`: one cudaMemcpy2DAsync of `rows` rows of `width` bytes
//   from page-locked host memory, `spitch` bytes apart, to device memory,
//   `dpitch` bytes apart.  The upload of a frame's region (core/frame.py
//   `HostLayout.upload_into`) copies a band narrower than its plane's rows
//   with it.  torch's copy_ of a non-contiguous host view gathers the view
//   into a contiguous host buffer first; the copy engine reads the rows
//   where they lie.
// - `copy_d2h`: `count` cudaMemcpyAsync calls, copy i `nbytes[i]` bytes
//   from device memory `src[i]` to page-locked host memory `dst[i]`.  A
//   batch's readback (core/frame.py `copy_d2h`, runtime/pipeline.py
//   `Pipeline._readback_batch`) enqueues its frames' pieces by one call:
//   torch's copy_ into pinned memory costs a dispatch and an event for its
//   host allocator a piece.
//
// Each returns the CUDA error code, 0 on success.

#include <cuda_runtime.h>

extern "C" int copy_rows_h2d(void* dst, int dpitch, const void* src,
                             int spitch, int width, int rows,
                             cudaStream_t stream) {
  if (dst == nullptr || src == nullptr || width < 0 || rows < 0 ||
      dpitch < width || spitch < width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaMemcpy2DAsync(
      dst, static_cast<size_t>(dpitch), src, static_cast<size_t>(spitch),
      static_cast<size_t>(width), static_cast<size_t>(rows),
      cudaMemcpyHostToDevice, stream));
}

extern "C" int copy_d2h(void* const* dst, const void* const* src,
                        const long long* nbytes, int count,
                        cudaStream_t stream) {
  if (count < 0 || (count > 0 && (dst == nullptr || src == nullptr ||
                                  nbytes == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i) {
    if (dst[i] == nullptr || src[i] == nullptr || nbytes[i] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaMemcpyAsync(dst[i], src[i],
                                      static_cast<size_t>(nbytes[i]),
                                      cudaMemcpyDeviceToHost, stream);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return 0;
}
