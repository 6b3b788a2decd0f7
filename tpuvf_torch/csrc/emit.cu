// Fused emit for Hopper (sm_90a): K2 `emit_u8` / `emit_f32`.
//
// Replaces the quad-emit Pallas probes of tpuvf
// (scripts/probe_mosaic_emit.py:46 `try_kernel`, bodies k1-k6b :68-142, and
// :167, k7 :155), whose product is the emit that XLA fuses on the TPU:
// tpuvf/kernels/color.py::yuv_to_rgb (:116) -> the letterbox border ->
// tpuvf/kernels/filter.py::apply_color_adjustments_t (:122) -> quantize ->
// pack (tpuvf/kernels/convert.py::pack_rgba_t, :2651).  One thread per
// output pixel computes, from planes already at the output grid:
//
//   1. dequant (x * f32(1/255)) of a uint8 source (emit_u8; emit_f32 takes
//      the float32 planes the K1/K1b sampler wrote);
//   2. YUV sources: limited-range yuv_to_rgb with its clamp (BT.601 or
//      BT.709), alpha 1; RGBA sources: the four channels;
//   3. the letterbox border from separable row and column coverage vectors;
//   4. when `gates` >= 0, vfvideofilter's whole adjustment chain, each stage
//      behind its static gate bit (filter.GATES order) and its per-frame
//      uniform test, reading the per-frame scalars from device memory;
//   5. quantize to uint8 RGBA planes (the RGBA8 render-target store), or
//      write float32 channels when the 3D LUT (K3) follows.
//
// The plain version is tpuvf_torch.kernels.emit.emit_plain, which composes
// the port's torch functions op for op.
//
// What bounds it: memory.  At identity geometry it reads 1.5 (NV12) or 4
// (RGBA) bytes a pixel and writes 4 (u8) or 16 (f32) bytes a pixel; the
// adjustment chain is a few dozen float ops a pixel, far below the card's
// rate.  The plain version is ~40 elementwise launches, each a full
// read-modify-write of float32 planes; fusing them is the whole design.
// One thread per pixel along the width, rows walked by a grid-stride loop.
//
// Where bitwise parity with the plain version breaks first, and what this
// source does about each:
//   - FMA contraction: every multiply and add is __fmul_rn / __fadd_rn /
//     __fsub_rn, in the plain version's operand order;
//   - division and sqrt: __fdiv_rn for the tensor-by-tensor divisions
//     (rgb_to_hsv, the chroma-key smoothstep, hue / two_pi), __fsqrt_rn for
//     the chroma-key and vignette distances (torch divides and takes roots
//     correctly rounded on the card);
//   - 1.0 / gamma: PyTorch computes a Python scalar over a tensor as
//     reciprocal(gamma), i.e. __fdiv_rn(1, gamma);
//   - the vignette smoothstep divides by the Python scalar 0.5, which torch
//     on the card turns into a multiply by 2: both are exact;
//   - rounding in quant: rintf (half to even, as torch.round), not roundf;
//   - hash12's fract is x - floorf(x), as filter._fract;
//   - powf for gamma: torch.pow on the card calls the same powf from CUDA's
//     math library, so equality holds when both were built from one libdevice;
//   - constants: every coefficient below is a double literal converted to
//     float, which is how numpy's float32 tables and Python floats reach the
//     plain version;
//   - clamps propagate NaN like torch.clamp.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// Slots of the per-frame scalar vector (kernels/emit.py PARAM_KEYS, then
// coords["two_pi"]).
enum Param : int {
  kBrightness, kContrast, kSaturation, kHue, kGamma, kSepia, kInvert,
  kChromaKeyEnabled, kKeyR, kKeyG, kKeyB, kKeyTolerance, kKeySmoothness,
  kVignette, kNoise, kTwoPi,
};

// Static gate bits, filter.GATES order.
enum Gate : int {
  kGateHue = 1, kGateGamma = 2, kGateSepia = 4, kGateInvert = 8,
  kGateChromaKey = 16, kGateVignette = 32, kGateNoise = 64,
};

__constant__ float kYuvOffset[3] = {16.0 / 255.0, 128.0 / 255.0,
                                    128.0 / 255.0};
// color.YUV_TO_RGB: [matrix][row r/g/b][column y/u/v]
__constant__ float kYuvToRgb[2][3][3] = {
    {{1.164383, 0.0, 1.596027},
     {1.164383, -0.391762, -0.812968},
     {1.164383, 2.017232, 0.0}},
    {{1.164383, 0.0, 1.792741},
     {1.164383, -0.213249, -0.532909},
     {1.164383, 2.112402, 0.0}},
};
__constant__ float kLuma[3] = {0.2126, 0.7152, 0.0722};
__constant__ float kSepiaM[3][3] = {{0.393, 0.769, 0.189},
                                    {0.349, 0.686, 0.168},
                                    {0.272, 0.534, 0.131}};

constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kUniformEps = static_cast<float>(0.001);
constexpr float kGammaFloor = static_cast<float>(0.0001);
constexpr float kHsvEps = static_cast<float>(1.0e-10);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kTwoThirds = static_cast<float>(2.0 / 3.0);
constexpr float kVignetteScale = static_cast<float>(1.414);
constexpr float kFrameScale = static_cast<float>(0.00137);
constexpr float kHashScale = static_cast<float>(0.1031);
constexpr float kHashK = static_cast<float>(33.33);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp01(float x) { return clampf(x, 0.0f, 1.0f); }

__device__ __forceinline__ float fract(float x) { return sub(x, floorf(x)); }

// t*t*(3 - 2t) of an already clamped t (filter._smoothstep's tail).
__device__ __forceinline__ float smooth_tail(float t) {
  return mul(mul(t, t), sub(3.0f, mul(2.0f, t)));
}

__device__ __forceinline__ uint8_t quant(float x) {
  return static_cast<uint8_t>(rintf(mul(clamp01(x), 255.0f)));
}

__device__ __forceinline__ float dequant(uint8_t v) {
  return mul(static_cast<float>(v), kInv255);
}
__device__ __forceinline__ float load(const uint8_t* p, size_t i) {
  return dequant(__ldg(p + i));
}
__device__ __forceinline__ float load(const float* p, size_t i) {
  return __ldg(p + i);
}

// color.yuv_to_rgb: (m0*yo + m1*uo) + m2*vo per row, clamped.
__device__ __forceinline__ void yuv_to_rgb(float y, float u, float v, int mi,
                                           float& r, float& g, float& b) {
  const float yo = sub(y, kYuvOffset[0]);
  const float uo = sub(u, kYuvOffset[1]);
  const float vo = sub(v, kYuvOffset[2]);
  float out[3];
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const float* m = kYuvToRgb[mi][row];
    out[row] = clamp01(add(add(mul(m[0], yo), mul(m[1], uo)), mul(m[2], vo)));
  }
  r = out[0];
  g = out[1];
  b = out[2];
}

// filter.rgb_to_hsv, branch for branch.
__device__ __forceinline__ void rgb_to_hsv(float r, float g, float b,
                                           float& h, float& s, float& v) {
  const bool gb = g >= b;
  const float px = gb ? g : b;
  const float py = gb ? b : g;
  const float pz = gb ? 0.0f : -1.0f;
  const float pw = gb ? -kThird : kTwoThirds;
  const bool rp = r >= px;
  const float qx = rp ? r : px;
  const float qy = py;
  const float qz = rp ? pz : pw;
  const float qw = rp ? px : r;
  const float d = sub(qx, fminf(qw, qy));
  h = fabsf(add(qz, __fdiv_rn(sub(qw, qy), add(mul(6.0f, d), kHsvEps))));
  s = __fdiv_rn(d, add(qx, kHsvEps));
  v = qx;
}

// One channel of filter.hsv_to_rgb.
__device__ __forceinline__ float hsv_channel(float h, float s, float v,
                                             float offset) {
  const float p = fabsf(sub(mul(fract(add(h, offset)), 6.0f), 3.0f));
  return mul(v, add(sub(1.0f, s), mul(s, clamp01(sub(p, 1.0f)))));
}

// filter.hash12 at pixel centre (px, py).
__device__ __forceinline__ float hash12(float px, float py, float fi) {
  const float p3x = fract(add(mul(px, kHashScale), fi));
  const float p3y = fract(add(mul(py, kHashScale), fi));
  const float p3z = p3x;
  const float d = add(add(mul(p3x, add(p3y, kHashK)), mul(p3y, add(p3z, kHashK))),
                      mul(p3z, add(p3x, kHashK)));
  return fract(mul(add(add(p3x, d), add(p3y, d)), add(p3z, d)));
}

template <typename T>
struct EmitArgs {
  const T* src;  // (4, H, W) RGBA planes, or the (H, W) luma plane
  const float* u;
  const float* v;
  int is_rgba;
  void* out;  // (4, H, W) uint8, or float32 when out_f32
  int out_f32;
  int height;
  int width;
  int matrix_index;
  const uint8_t* border_rows;  // (H,) bool, or null: no border
  const uint8_t* border_cols;  // (W,) bool
  float border[4];
  const float* params;  // Param slots
  const long long* frame_index;
  const float* tx;  // vignette texcoords (W,) and (H,)
  const float* ty;
  const float* px;  // grain pixel centres (W,) and (H,)
  const float* py;
  int gates;  // Gate bits, or -1: no adjustment chain
};

// filter.apply_color_adjustments_t on one pixel.
template <typename T>
__device__ __forceinline__ void adjust(const EmitArgs<T>& a, int x, int y,
                                       float& r, float& g, float& b,
                                       float& alpha) {
  const float* p = a.params;
  const int gates = a.gates;

  // brightness -> contrast -> saturation folded into one affine
  const float c = __ldg(p + kContrast);
  const float s = __ldg(p + kSaturation);
  const float cs = mul(c, s);
  const float m = mul(sub(1.0f, s), c);
  const float k0 = add(mul(sub(__ldg(p + kBrightness), 0.5f), c), 0.5f);
  const float lum0 = add(add(mul(kLuma[0], r), mul(kLuma[1], g)),
                         mul(kLuma[2], b));
  const float base = add(mul(m, lum0), k0);
  r = add(mul(cs, r), base);
  g = add(mul(cs, g), base);
  b = add(mul(cs, b), base);

  if ((gates & kGateHue) && fabsf(__ldg(p + kHue)) > kUniformEps) {
    float h, hs, hv;
    rgb_to_hsv(clamp01(r), clamp01(g), clamp01(b), h, hs, hv);
    h = fract(add(h, __fdiv_rn(__ldg(p + kHue), __ldg(p + kTwoPi))));
    r = hsv_channel(h, hs, hv, 1.0f);
    g = hsv_channel(h, hs, hv, kTwoThirds);
    b = hsv_channel(h, hs, hv, kThird);
  }

  r = clampf(r, kGammaFloor, 1.0f);
  g = clampf(g, kGammaFloor, 1.0f);
  b = clampf(b, kGammaFloor, 1.0f);
  if (gates & kGateGamma) {
    const float inv_gamma = __fdiv_rn(1.0f, __ldg(p + kGamma));
    r = powf(r, inv_gamma);
    g = powf(g, inv_gamma);
    b = powf(b, inv_gamma);
  }

  if ((gates & kGateSepia) && __ldg(p + kSepia) > kUniformEps) {
    const float sep = __ldg(p + kSepia);
    float sc[3];
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      sc[row] = add(add(mul(kSepiaM[row][0], r), mul(kSepiaM[row][1], g)),
                    mul(kSepiaM[row][2], b));
    }
    r = add(r, mul(sub(sc[0], r), sep));
    g = add(g, mul(sub(sc[1], g), sep));
    b = add(b, mul(sub(sc[2], b), sep));
  }

  if ((gates & kGateInvert) && __ldg(p + kInvert) > 0.5f) {
    r = sub(1.0f, r);
    g = sub(1.0f, g);
    b = sub(1.0f, b);
  }

  if ((gates & kGateChromaKey) && __ldg(p + kChromaKeyEnabled) > 0.5f) {
    const float dr = sub(r, __ldg(p + kKeyR));
    const float dg = sub(g, __ldg(p + kKeyG));
    const float db = sub(b, __ldg(p + kKeyB));
    const float dist = __fsqrt_rn(add(add(mul(dr, dr), mul(dg, dg)), mul(db, db)));
    const float e0 = __ldg(p + kKeyTolerance);
    const float e1 = add(e0, __ldg(p + kKeySmoothness));
    const float t = clamp01(__fdiv_rn(sub(dist, e0), sub(e1, e0)));
    alpha = mul(alpha, smooth_tail(t));
  }

  if ((gates & kGateVignette) && __ldg(p + kVignette) > kUniformEps) {
    const float cx = sub(__ldg(a.tx + x), 0.5f);
    const float cy = sub(__ldg(a.ty + y), 0.5f);
    const float vdist = mul(__fsqrt_rn(add(mul(cx, cx), mul(cy, cy))),
                            kVignetteScale);
    const float t = clamp01(mul(sub(vdist, 0.5f), 2.0f));
    const float vig = sub(1.0f, mul(smooth_tail(t), __ldg(p + kVignette)));
    r = mul(r, vig);
    g = mul(g, vig);
    b = mul(b, vig);
  }

  if ((gates & kGateNoise) && __ldg(p + kNoise) > kUniformEps) {
    const float fi = mul(__ll2float_rn(__ldg(a.frame_index)), kFrameScale);
    float n = hash12(__ldg(a.px + x), __ldg(a.py + y), fi);
    n = mul(mul(sub(n, 0.5f), __ldg(p + kNoise)), 0.5f);
    r = add(r, n);
    g = add(g, n);
    b = add(b, n);
  }

  // sepia's rows sum past 1 and grain adds +-noise/4: only those gates keep
  // the final clip (filter.py elides it otherwise)
  if (gates & (kGateSepia | kGateNoise)) {
    r = clamp01(r);
    g = clamp01(g);
    b = clamp01(b);
  }
}

template <typename T>
__global__ void emit_kernel(const EmitArgs<T> a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= a.width) return;
  const size_t plane = static_cast<size_t>(a.height) * a.width;
  for (int y = blockIdx.y; y < a.height; y += gridDim.y) {
    const size_t i = static_cast<size_t>(y) * a.width + x;
    float r, g, b, alpha;
    if (a.is_rgba) {
      r = load(a.src, i);
      g = load(a.src, plane + i);
      b = load(a.src, 2 * plane + i);
      alpha = load(a.src, 3 * plane + i);
    } else {
      yuv_to_rgb(load(a.src, i), __ldg(a.u + i), __ldg(a.v + i),
                 a.matrix_index, r, g, b);
      alpha = 1.0f;
    }
    if (a.border_rows != nullptr &&
        !(__ldg(a.border_rows + y) && __ldg(a.border_cols + x))) {
      r = a.border[0];
      g = a.border[1];
      b = a.border[2];
      alpha = a.border[3];
    }
    if (a.gates >= 0) adjust(a, x, y, r, g, b, alpha);
    if (a.out_f32) {
      float* o = static_cast<float*>(a.out);
      o[i] = r;
      o[plane + i] = g;
      o[2 * plane + i] = b;
      o[3 * plane + i] = alpha;
    } else {
      uint8_t* o = static_cast<uint8_t*>(a.out);
      o[i] = quant(r);
      o[plane + i] = quant(g);
      o[2 * plane + i] = quant(b);
      o[3 * plane + i] = quant(alpha);
    }
  }
}

template <typename T>
int launch_emit(const void* src, const float* u, const float* v, int is_rgba,
                void* out, int out_f32, int height, int width,
                int matrix_index, const uint8_t* border_rows,
                const uint8_t* border_cols, float br, float bg, float bb,
                float ba, const float* params, const long long* frame_index,
                const float* tx, const float* ty, const float* px,
                const float* py, int gates, cudaStream_t stream) {
  const bool bad_yuv = !is_rgba && (u == nullptr || v == nullptr);
  const bool bad_border = (border_rows == nullptr) != (border_cols == nullptr);
  const bool bad_adjust =
      gates >= 0 && (params == nullptr || frame_index == nullptr ||
                     tx == nullptr || ty == nullptr || px == nullptr ||
                     py == nullptr);
  if (src == nullptr || out == nullptr || height <= 0 || width <= 0 ||
      static_cast<long long>(height) * width > INT32_MAX / 4 ||
      matrix_index < 0 || matrix_index > 1 || gates > 127 || bad_yuv ||
      bad_border || bad_adjust) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EmitArgs<T> a{static_cast<const T*>(src), u, v, is_rgba, out, out_f32,
                      height, width, matrix_index, border_rows, border_cols,
                      {br, bg, bb, ba}, params, frame_index, tx, ty, px, py,
                      gates};
  const dim3 grid((width + kThreads - 1) / kThreads,
                  height < kMaxGridY ? height : kMaxGridY);
  emit_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t (0 on success); the wrapper raises on non-zero.
// emit_u8: the source planes (RGBA stack or luma) are uint8; emit_f32:
// float32.  U and V are always float32 planes at the output grid.
#define TPUVF_EMIT_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                         \
      const void* src, const float* u, const float* v, int is_rgba,            \
      void* out, int out_f32, int height, int width, int matrix_index,         \
      const uint8_t* border_rows, const uint8_t* border_cols, float br,        \
      float bg, float bb, float ba, const float* params,                       \
      const long long* frame_index, const float* tx, const float* ty,          \
      const float* px, const float* py, int gates, cudaStream_t stream) {      \
    return launch_emit<T>(src, u, v, is_rgba, out, out_f32, height, width,     \
                          matrix_index, border_rows, border_cols, br, bg, bb,  \
                          ba, params, frame_index, tx, ty, px, py, gates,      \
                          stream);                                             \
  }

TPUVF_EMIT_ENTRY(emit_u8, uint8_t)
TPUVF_EMIT_ENTRY(emit_f32, float)
