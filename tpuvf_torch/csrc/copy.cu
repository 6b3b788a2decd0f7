// The host edge's strided copy: `copy_rows_h2d`, one cudaMemcpy2DAsync of
// `rows` rows of `width` bytes from page-locked host memory, `spitch` bytes
// apart, to device memory, `dpitch` bytes apart, on `stream`.
//
// The upload of a frame's region (core/frame.py `HostLayout.upload_into`)
// copies a band narrower than its plane's rows with it.  torch's copy_ of a
// non-contiguous host view gathers the view into a contiguous host buffer
// first; the copy engine reads the rows where they lie.  Returns the CUDA
// error code, 0 on success.

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
