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
// columns (K1b) reuse the same input rows, so the bound is one read of the
// input plus one write of the output: at chain (b)'s 4K chroma shapes
// 16.6 + 33.2 MB (K1, 14.9 us at 3.35 TB/s) and 33.2 + 66.4 MB (K1b,
// 29.7 us).  The Mosaic alignment rules of the TPU kernel (8-row bands,
// 128-lane padding, padded sample rows) do not apply here and are gone.
//
// K1 is one thread per output element, a float4 along the contiguous width
// where the rows are 16-byte aligned: 20.2 us at 4K, 74% of its bound.
//
// K1b was one thread per output column, re-reading 16 bytes of taps for
// every 4-byte output and gathering its two inputs from device memory:
// 66.8 us, 45% of its bound.  It is now tpuvf's blockband plan
// (tpuvf/kernels/sample.py::blockband_plan) as a shared-memory tile.  A
// block owns kColTile output columns x kTileRows rows; each thread owns 4
// adjacent columns of one of kLanes row lanes, loads their taps once into
// registers and writes one float4 per row.  sample.plan_col_bands gives each
// tile the input span [lo, hi) its live taps read, and points the dead taps
// (masked columns, weight 0) inside it; the rows' spans, widened to 16-byte
// boundaries, stream through a kStages-deep cp.async ring in shared memory
// (16-byte copies where the rows are 16-byte aligned, 4-byte ones where not:
// a 959-wide chroma row), each thread reading its 8 tap inputs from there.
// A tile whose span is wider than kMaxPitch floats (a downscale past ~4x)
// or that has no live tap gathers from device memory instead, with the same
// arithmetic; sample.stage_plan chooses per tile.  Measured, NVIDIA H100
// 80GB HBM3, 700.00 W (chip_smoke.py): 38.3 us at 4K, 78% of its bound,
// where the one PyTorch call for it, bilinear F.interpolate, takes 145.4 us.
//
// Bitwise contract: the arithmetic uses __fmul_rn / __fadd_rn, so no FMA
// contraction happens and each output is round(round(w0*a) + round(w1*b)),
// exactly what the plain PyTorch version (separate mul and add ops) gives.

#include <cuda_pipeline.h>

#include "yuv420.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

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

// -- K1b: a block owns a tile of kColTile output columns x kTileRows rows --
constexpr int kColTile = 256;                     // sample.COL_TILE
constexpr int kColThreads = kColTile / 4;         // 4 adjacent columns each
constexpr int kLanes = 4;                         // rows computed at once
constexpr int kColBlock = kColThreads * kLanes;   // threads
constexpr int kStages = 4;                        // the shared-memory ring
constexpr int kTileRows = 16;
constexpr int kMaxPitch = 1024;                   // sample.MAX_PITCH, floats

// Start the copies of rows row0 .. row0 + kLanes - 1, input columns
// [lo4, lo4 + n), into one ring stage (kLanes rows of `pitch` floats):
// 16-byte cp.async where every row start is 16-byte aligned, else 4-byte.
template <bool kVec16>
__device__ __forceinline__ void stage_rows(float* stage,
                                           const float* __restrict__ in,
                                           int row0, int rows, int in_w,
                                           int lo4, int n, int pitch) {
  constexpr int kFloats = kVec16 ? 4 : 1;
  const int chunks = n / kFloats;
  for (int c = threadIdx.x; c < kLanes * chunks; c += kColBlock) {
    const int lane = c / chunks;
    const int j = (c - lane * chunks) * kFloats;
    const int row = row0 + lane;
    if (row < rows) {
      __pipeline_memcpy_async(stage + lane * pitch + j,
                              in + static_cast<size_t>(row) * in_w + lo4 + j,
                              kFloats * sizeof(float));
    }
  }
}

template <bool kVecOut>
__device__ __forceinline__ void store4(float* o, const float (&v)[4],
                                       int left) {
  if (kVecOut) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < left) o[j] = v[j];
    }
  }
}

// in (rows, in_w) -> out (rows, out_w); `rows` is planes * height.  Tile
// blockIdx.x reads the taps k (k0 row, then k1 row) and w0, w1 of its
// columns once, into registers, and keeps them for all its rows.
// stage[tile] = (lo4, n): n > 0 stages input columns [lo4, lo4 + n) of each
// row in shared memory through a kStages-deep cp.async ring (rows
// r + kLanes * (kStages - 1) load while rows r compute); n == 0 gathers
// from global memory (a span wider than kMaxPitch, or no live tap).
template <bool kVec16, bool kVecOut>
__global__ void __launch_bounds__(kColBlock)
resample_cols_kernel(const float* __restrict__ in, float* __restrict__ out,
                     const int* __restrict__ k, const float* __restrict__ w0,
                     const float* __restrict__ w1,
                     const int* __restrict__ stage, int rows, int in_w,
                     int out_w, int pitch) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  const int tile = blockIdx.x;
  const int lane = threadIdx.x / kColThreads;
  const int c0 = tile * kColTile + 4 * (threadIdx.x % kColThreads);
  const int lo4 = __ldg(stage + 2 * tile);
  const int n = __ldg(stage + 2 * tile + 1);
  int a[4], b[4];
  float wa[4], wb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = c0 + j < out_w;
    a[j] = live ? __ldg(k + c0 + j) - (n > 0 ? lo4 : 0) : 0;
    b[j] = live ? __ldg(k + out_w + c0 + j) - (n > 0 ? lo4 : 0) : 0;
    wa[j] = live ? __ldg(w0 + c0 + j) : 0.0f;
    wb[j] = live ? __ldg(w1 + c0 + j) : 0.0f;
  }
  const bool cols = c0 < out_w;
  const int left = out_w - c0;
  const int stage_floats = kLanes * pitch;
  for (int r0 = blockIdx.y * kTileRows; r0 < rows;
       r0 += gridDim.y * kTileRows) {
    const int trips = (min(kTileRows, rows - r0) + kLanes - 1) / kLanes;
    if (n == 0) {
      for (int t = 0; t < trips; ++t) {
        const int row = r0 + t * kLanes + lane;
        if (row >= rows || !cols) continue;
        const float* src = in + static_cast<size_t>(row) * in_w;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = tap2(wa[j], __ldg(src + a[j]), wb[j], __ldg(src + b[j]));
        }
        store4<kVecOut>(out + static_cast<size_t>(row) * out_w + c0, o, left);
      }
      continue;
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < trips) {
        stage_rows<kVec16>(ring + s * stage_floats, in, r0 + s * kLanes, rows,
                           in_w, lo4, n, pitch);
      }
      __pipeline_commit();
    }
    for (int t = 0; t < trips; ++t) {
      const int next = t + kStages - 1;
      if (next < trips) {
        stage_rows<kVec16>(ring + (next % kStages) * stage_floats, in,
                           r0 + next * kLanes, rows, in_w, lo4, n, pitch);
      }
      __pipeline_commit();
      __pipeline_wait_prior(kStages - 1);  // rows r0 + t * kLanes landed
      __syncthreads();
      const int row = r0 + t * kLanes + lane;
      if (row < rows && cols) {
        const float* s = ring + (t % kStages) * stage_floats + lane * pitch;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = tap2(wa[j], s[a[j]], wb[j], s[b[j]]);
        store4<kVecOut>(out + static_cast<size_t>(row) * out_w + c0, o, left);
      }
      __syncthreads();  // the stage is refilled next trip
    }
  }
}

bool fits_int(long long v) { return v >= 0 && v <= INT32_MAX; }

// The ring takes up to kStages * kLanes * kMaxPitch floats (64 KB), past
// the 48 KB a launch gets without asking: asked once per kernel and card
// (a function attribute belongs to one device).
template <bool kVec16, bool kVecOut>
cudaError_t launch_cols(dim3 grid, size_t smem, cudaStream_t stream,
                        const float* in, float* out, const int* k,
                        const float* w0, const float* w1, const int* stage,
                        int rows, int in_w, int out_w, int pitch) {
  const auto kernel = resample_cols_kernel<kVec16, kVecOut>;
  static PerDevice raised = {};  // 0: not asked yet, else 1 + its error
  const int slot = device_slot();
  if (slot < 0) return cudaErrorInvalidDevice;
  if (raised[slot] == 0) {
    raised[slot] = 1 + static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * kStages * kLanes * kMaxPitch)));
  }
  if (raised[slot] != 1) return static_cast<cudaError_t>(raised[slot] - 1);
  kernel<<<grid, kColBlock, smem, stream>>>(in, out, k, w0, w1, stage, rows,
                                            in_w, out_w, pitch);
  return cudaGetLastError();
}

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

// k: int32 (2, out_w), each tap's index pointed inside its tile's span;
// stage: int32 (ceil(out_w / kColTile), 2), (lo4, n) per tile; pitch: the
// widest staged span, a multiple of 4 floats, at most kMaxPitch
// (sample.plan_col_bands and sample.stage_plan).
extern "C" int resample_cols_f32(const float* in, float* out, const int* k,
                                 const float* w0, const float* w1,
                                 const int* stage, int planes, int height,
                                 int in_w, int out_w, int pitch,
                                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(planes) * height;
  if (planes <= 0 || height <= 0 || in_w <= 0 || out_w <= 0 || !fits_int(rows) ||
      !fits_int(rows * in_w) || !fits_int(rows * out_w) || pitch < 0 ||
      pitch > kMaxPitch || pitch % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec16 = in_w % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const bool vec_out =
      out_w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long row_tiles = (rows + kTileRows - 1) / kTileRows;
  const dim3 grid((out_w + kColTile - 1) / kColTile,
                  static_cast<unsigned>(row_tiles < kMaxGridY ? row_tiles
                                                              : kMaxGridY));
  const size_t smem = sizeof(float) * kStages * kLanes * pitch;
  const auto launch = vec16 ? (vec_out ? launch_cols<true, true>
                                       : launch_cols<true, false>)
                            : (vec_out ? launch_cols<false, true>
                                       : launch_cols<false, false>);
  return static_cast<int>(launch(grid, smem, stream, in, out, k, w0, w1,
                                 stage, static_cast<int>(rows), in_w, out_w,
                                 pitch));
}
