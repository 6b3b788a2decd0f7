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
// What bounds it.  Device memory sees the planes, 16 bytes in and 4 (u8) or
// 16 (f32) bytes out a pixel, and the table once: 44.9 MB for a 1080p frame
// and a 33^3 table.  But each pixel also gathers its 8 corners at a row the
// data picks, 96 bytes of the packed table: ~199 MB of L2 -> SM traffic on
// uniform noise at 1080p.  Gathered a row a lane, six float4 loads a pixel,
// a warp's load touches up to 32 cache lines, and the L1's line-by-line
// handling of those loads, not device memory, sets the pace on such a
// frame; on a spatially coherent one neighbouring lanes share rows and the
// planes set it.  The design:
//   - 4 pixels a thread: the r, g, b, a planes are read as one float4 each
//     and each output plane is written as one uchar4 (u8) or float4 (f32),
//     where the pixel count is a multiple of 4 and every plane starts on its
//     access (`vector_planes`); else one pixel a thread.
//   - The table path (`table_path`, by size):
//     * up to kMaxSharedSize (23^3, 194.7 KB as float4 nodes), the node
//       table in shared memory: each block stages it once (a persistent
//       grid of the blocks the card holds resident) and each pixel reads
//       its 8 corners there, at the clamped indices (min(b0 + db, S - 1),
//       ...).  A node is corner 0 of its packed row, table[cell, 0:3], so
//       the staging is built from the packed table and the values are the
//       packed row's, bit for bit;
//     * above it, each pixel's packed corner row, six float4 loads from
//       the table (an L2 hit).
// The TPU probes fought a ~2 ns/index gather wall with corner splitting and
// transposed gathers; none of that is carried over.
//
// Bitwise contract: every multiply and add is __fmul_rn / __fadd_rn (no FMA
// contraction), in the plain version's order, so the f32 output is
// torch.equal to it; the cell index clamps with fmaxf/fminf, which send NaN
// to cell 0 (its weights are NaN, so the pixel is NaN whichever cell it
// reads); rintf, not roundf, in the quantizer.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedThreads = 1024;  // one block an SM stages the table
constexpr int kMaxSharedSize = 23;  // 23^3 float4 nodes: 194,672 bytes
constexpr int kVec = 4;             // pixels a thread on the vector path

// Table paths (kernels/lut.py PATH_GATHER, PATH_SHARED).
constexpr int kPathGather = 0;
constexpr int kPathShared = 1;
constexpr int kRowVecs = 6;  // float4s in a packed 96-byte corner row

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ uint8_t quant(float x) {
  return static_cast<uint8_t>(rintf(mul(fminf(fmaxf(x, 0.0f), 1.0f), 255.0f)));
}

// -> (lower index, {1 - fraction, fraction}) of one axis.
__device__ __forceinline__ int axis_cell(float x, float s1, float w[2]) {
  const float p = mul(x, s1);
  const float fl = floorf(p);
  const float f = sub(p, fl);
  w[0] = sub(1.0f, f);
  w[1] = f;
  return static_cast<int>(fminf(fmaxf(fl, 0.0f), s1));
}

// One pixel's cell: its lower index on each axis and the axis weights.
struct Cell {
  int r0, g0, b0;
  float wr[2], wg[2], wb[2];
};

__device__ __forceinline__ Cell find_cell(int size, float r, float g,
                                          float b) {
  const float s1 = static_cast<float>(size - 1);
  Cell c;
  c.r0 = axis_cell(r, s1, c.wr);
  c.g0 = axis_cell(g, s1, c.wg);
  c.b0 = axis_cell(b, s1, c.wb);
  return c;
}

// out_c = sum over k of wk * corner[3k + c], in the plain version's order.
__device__ __forceinline__ void accumulate(const Cell& cell,
                                           const float corner[24],
                                           float acc[3]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wk = mul(mul(cell.wb[(k >> 2) & 1], cell.wg[(k >> 1) & 1]),
                         cell.wr[k & 1]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t = mul(wk, corner[3 * k + c]);
      acc[c] = k == 0 ? t : add(acc[c], t);
    }
  }
}

// The pixel's own packed row, six float4 loads (an L2 hit).
__device__ __forceinline__ void packed_row(const float4* __restrict__ table,
                                           int size, const Cell& cl,
                                           float corner[24]) {
  const int cell = (cl.b0 * size + cl.g0) * size + cl.r0;
#pragma unroll
  for (int q = 0; q < kRowVecs; ++q) {
    const float4 v = __ldg(table + cell * kRowVecs + q);
    corner[4 * q] = v.x, corner[4 * q + 1] = v.y;
    corner[4 * q + 2] = v.z, corner[4 * q + 3] = v.w;
  }
}

// The 8 corners from the node table in shared memory, at the clamped
// neighbour indices: the packed row's values, bit for bit.
__device__ __forceinline__ void node_corners(const float4* nodes, int size,
                                             const Cell& cl, float corner[24]) {
  const int rs[2] = {cl.r0, min(cl.r0 + 1, size - 1)};
  const int gs[2] = {cl.g0, min(cl.g0 + 1, size - 1)};
  const int bs[2] = {cl.b0, min(cl.b0 + 1, size - 1)};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 v =
        nodes[(bs[(k >> 2) & 1] * size + gs[(k >> 1) & 1]) * size + rs[k & 1]];
    corner[3 * k] = v.x, corner[3 * k + 1] = v.y, corner[3 * k + 2] = v.z;
  }
}

// in: (4, n) float32 planes r, g, b, a; out: (4, n) float32 or uint8.  Each
// thread takes kPix pixels a trip (4 on the vector path) in a grid-stride
// loop; their corners come from the node table in shared memory (kShared)
// or from their packed rows.
template <bool kQuantize, bool kShared, bool kVector>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kThreads)
lut3d_kernel(const float* __restrict__ in, const float* __restrict__ table,
             int size, int n, void* __restrict__ out) {
  constexpr int kPix = kVector ? kVec : 1;
  extern __shared__ float4 nodes[];
  if (kShared) {  // node (b, g, r): corner 0 of row (bS + g)S + r
    const int cells = size * size * size;
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const float* row = table + static_cast<size_t>(c) * 24;
      nodes[c] = make_float4(__ldg(row), __ldg(row + 1), __ldg(row + 2), 0.0f);
    }
    __syncthreads();
  }
  const float4* rows = reinterpret_cast<const float4*>(table);
  const int stride = gridDim.x * blockDim.x * kPix;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) * kPix; i < n;
       i += stride) {
    float px[4][kPix];  // [plane][pixel]
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (kVector) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(in + c * n + i));
        px[c][0] = t.x, px[c][1] = t.y, px[c][2] = t.z, px[c][3] = t.w;
      } else {
        px[c][0] = __ldg(in + c * n + i);
      }
    }
    // every pixel's cell first, so the corner loads of the next pixel need
    // not wait for this one's
    Cell cl[kPix];
#pragma unroll
    for (int l = 0; l < kPix; ++l) {
      cl[l] = find_cell(size, px[0][l], px[1][l], px[2][l]);
    }
    float o[4][kPix];  // [channel][pixel]; alpha passes through
#pragma unroll
    for (int l = 0; l < kPix; ++l) {
      float corner[24], acc[3];
      if constexpr (kShared) {
        node_corners(nodes, size, cl[l], corner);
      } else {
        packed_row(rows, size, cl[l], corner);
      }
      accumulate(cl[l], corner, acc);
      o[0][l] = acc[0], o[1][l] = acc[1], o[2][l] = acc[2], o[3][l] = px[3][l];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (kVector && kQuantize) {
        *reinterpret_cast<uchar4*>(static_cast<uint8_t*>(out) + c * n + i) =
            make_uchar4(quant(o[c][0]), quant(o[c][1]), quant(o[c][2]),
                        quant(o[c][3]));
      } else if constexpr (kVector) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + c * n + i) =
            make_float4(o[c][0], o[c][1], o[c][2], o[c][3]);
      } else if constexpr (kQuantize) {
        static_cast<uint8_t*>(out)[c * n + i] = quant(o[c][0]);
      } else {
        static_cast<float*>(out)[c * n + i] = o[c][0];
      }
    }
  }
}

int table_path(int size) {
  return size <= kMaxSharedSize ? kPathShared : kPathGather;
}

// The vector path needs every plane on its access: (4, n) planes start n
// elements apart, so n % 4 == 0, and the bases on 16 bytes (float32) or 4
// (the uint8 output).
bool vector_planes(const float* in, const void* out, int n, int quantize) {
  return n % kVec == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % (quantize ? 4 : 16) == 0;
}

// The grid: enough blocks for one trip of the threads over the pixels, at
// most the blocks the card holds resident at once with this launch's
// shared memory (the persistent grid of the shared-memory path, whose
// blocks each copy the table in once; asked again when the size changes).
// Kept per card (`device`, below kMaxDevices): one process may launch on
// several, and the shared-memory attribute belongs to one device.
constexpr int kMaxDevices = 64;

template <bool kQuantize, bool kShared, bool kVector>
void launch(const float* in, const float* table, int size, int n, void* out,
            int device, cudaStream_t stream) {
  static int resident[kMaxDevices] = {}, resident_size[kMaxDevices] = {};
  const auto kernel = lut3d_kernel<kQuantize, kShared, kVector>;
  const int threads = kShared ? kSharedThreads : kThreads;
  const size_t smem = kShared ? sizeof(float4) * size * size * size : 0;
  if (resident[device] == 0 || resident_size[device] != size) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (kShared) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(float4) * kMaxSharedSize *
                                            kMaxSharedSize * kMaxSharedSize));
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    resident[device] = sms * (per_sm > 0 ? per_sm : 1);
    resident_size[device] = size;
  }
  const long long per_block = static_cast<long long>(threads) * (kVector ? kVec : 1);
  const long long needed = (n + per_block - 1) / per_block;
  kernel<<<static_cast<int>(needed < resident[device] ? needed
                                                      : resident[device]),
           threads, smem, stream>>>(in, table, size, n, out);
}

template <bool kQuantize, bool kShared>
void launch_vector(const float* in, const float* table, int size, int n,
                   void* out, bool vector, int device, cudaStream_t stream) {
  vector ? launch<kQuantize, kShared, true>(in, table, size, n, out, device,
                                            stream)
         : launch<kQuantize, kShared, false>(in, table, size, n, out, device,
                                             stream);
}

template <bool kQuantize>
void launch_path(const float* in, const float* table, int size, int n,
                 void* out, bool vector, int device, cudaStream_t stream) {
  table_path(size) == kPathShared
      ? launch_vector<kQuantize, true>(in, table, size, n, out, vector,
                                       device, stream)
      : launch_vector<kQuantize, false>(in, table, size, n, out, vector,
                                        device, stream);
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
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const bool vector = vector_planes(in, out, n, quantize);
  quantize ? launch_path<true>(in, table, size, n, out, vector, device, stream)
           : launch_path<false>(in, table, size, n, out, vector, device,
                                stream);
  return static_cast<int>(cudaGetLastError());
}

// The paths a lut3d_trilinear_f32 launch takes for these planes: the table
// path (kPathGather or kPathShared) plus 4 if it takes the vector path (4
// pixels a thread).  For reports: the launch decides by itself.
extern "C" int lut3d_path(const float* in, const void* out, int size, int n,
                          int quantize) {
  return table_path(size) | (vector_planes(in, out, n, quantize) ? 4 : 0);
}
