// Fused emit for Hopper (sm_90a): K2 `emit_u8` / `emit_f32`.
//
// Replaces the quad-emit Pallas probes of tpuvf
// (scripts/probe_mosaic_emit.py:46 `try_kernel`, bodies k1-k6b :68-142, and
// :167, k7 :155), whose product is the emit that XLA fuses on the TPU:
// tpuvf/kernels/color.py::yuv_to_rgb (:116) -> the letterbox border ->
// tpuvf/kernels/filter.py::apply_color_adjustments_t (:122) -> quantize ->
// pack (tpuvf/kernels/convert.py::pack_rgba_t, :2651).  Each output pixel
// gets, from planes already at the output grid:
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
// What bounds it: memory, and close behind it the instruction issue.  A 4K
// NV12 emit (u8 luma, f32 U and V at the output grid, u8 RGBA out) moves
// 8.3 + 66.4 + 33.2 MB, 32.2 us at 3.35 TB/s; a 4K RGBA8 b/c/s emit 33.2 +
// 33.2 MB, 19.8 us, beside which chip_smoke.py times a torch clone of the
// same stack (read once, write once) as what a copy reaches.  The b/c/s
// chain, the clamps and the quantization add enough instructions a pixel
// that issue, not only bytes, holds it back.
// The first design (one pixel a thread, byte-wide loads and stores, the
// per-frame scalars re-read for every pixel) reached 64.1 and 57.3 us: 50%
// and 35% of those bounds.
//
// The design: the planes are walked as flat pixel arrays, each thread
// taking kVec = 4 consecutive pixels of every plane per trip of a
// grid-stride loop (the grid is the card's resident blocks): one 4-byte load
// per uint8 plane, one float4 per float32 plane, one 4-byte store per uint8
// output plane (a warp's access is 128 or 512 contiguous bytes).  The
// per-frame scalars are read once per thread; the adjustment chain runs
// stage by stage over the 4 pixels, so each stage's uniform test is taken
// once per 4 pixels, and the pixel position is computed only when a stage
// reads it (the border, vignette, grain); clamps are max.NaN / min.NaN.
// Wider vectors (8 or 16 pixels, two vectors in flight) cost registers and
// occupancy and were slower on the card (PERF.md).
// Measured, NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py): 40.2 us for the
// 4K NV12 emit (80% of its bound), 31.6 us for the RGBA8 one (63%).
// A launch whose planes do not all start on their access's boundary (an
// H*W that is not a multiple of 4, V as a view into a stacked (2, H, W)
// chroma tensor) takes the scalar path, one pixel a thread; the launch
// decides from the pointers and H*W (`vector_path`).  The plain version is
// ~40 elementwise launches, each a full read-modify-write of float32
// planes.
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
//   - rounding in quant: half to even (__float2uint_rn, as torch.round),
//     not half away from zero;
//   - hash12's fract is x - floorf(x), as filter._fract;
//   - powf for gamma: torch.pow on the card calls the same powf from CUDA's
//     math library, so equality holds when both were built from one libdevice;
//   - constants: every coefficient below is a double literal converted to
//     float, which is how numpy's float32 tables and Python floats reach the
//     plain version;
//   - clamps propagate NaN like torch.clamp.

#include "yuv420.cuh"

namespace {

constexpr int kThreads = 128;

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

__constant__ float kLuma[3] = {0.2126, 0.7152, 0.0722};
__constant__ float kSepiaM[3][3] = {{0.393, 0.769, 0.189},
                                    {0.349, 0.686, 0.168},
                                    {0.272, 0.534, 0.131}};

constexpr float kUniformEps = static_cast<float>(0.001);
constexpr float kGammaFloor = static_cast<float>(0.0001);
constexpr float kHsvEps = static_cast<float>(1.0e-10);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kTwoThirds = static_cast<float>(2.0 / 3.0);
constexpr float kVignetteScale = static_cast<float>(1.414);
constexpr float kFrameScale = static_cast<float>(0.00137);
constexpr float kHashScale = static_cast<float>(0.1031);
constexpr float kHashK = static_cast<float>(33.33);

__device__ __forceinline__ float fract(float x) { return sub(x, floorf(x)); }

// t*t*(3 - 2t) of an already clamped t (filter._smoothstep's tail).
__device__ __forceinline__ float smooth_tail(float t) {
  return mul(mul(t, t), sub(3.0f, mul(2.0f, t)));
}

__device__ __forceinline__ float load(const uint8_t* p, size_t i) {
  return dequant(__ldg(p + i));
}
__device__ __forceinline__ float load(const float* p, size_t i) {
  return __ldg(p + i);
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

// The adjustment chain's per-frame values, read from device memory once per
// thread, each computed as the plain version computes it.  A stage is on
// when its static gate bit is set and its uniform test passes.
struct Uniforms {
  float cs, m, k0;  // the b/c/s fold
  bool hue;
  float hue_shift;  // hue / two_pi
  bool gamma;
  float inv_gamma;
  bool sepia;
  float sepia_amount;
  bool invert;
  bool chroma_key;
  float key[3], e0, e_span;  // key colour; tolerance; e1 - e0
  bool vignette;
  float vignette_amount;
  bool noise;
  float noise_amount, fi;  // noise; frame index * kFrameScale
  bool clip;  // sepia or grain keep the final clip
  bool after_floor;  // any stage after the gamma floor is on
  bool xy;  // a stage reads the pixel's position (vignette, grain)
};

template <typename T>
__device__ Uniforms load_uniforms(const EmitArgs<T>& a) {
  Uniforms u{};
  const float* p = a.params;
  const int gates = a.gates;
  const float c = __ldg(p + kContrast);
  const float s = __ldg(p + kSaturation);
  u.cs = mul(c, s);
  u.m = mul(sub(1.0f, s), c);
  u.k0 = add(mul(sub(__ldg(p + kBrightness), 0.5f), c), 0.5f);
  u.hue = (gates & kGateHue) && fabsf(__ldg(p + kHue)) > kUniformEps;
  if (u.hue) u.hue_shift = __fdiv_rn(__ldg(p + kHue), __ldg(p + kTwoPi));
  u.gamma = (gates & kGateGamma) != 0;
  if (u.gamma) u.inv_gamma = __fdiv_rn(1.0f, __ldg(p + kGamma));
  u.sepia_amount = __ldg(p + kSepia);
  u.sepia = (gates & kGateSepia) && u.sepia_amount > kUniformEps;
  u.invert = (gates & kGateInvert) && __ldg(p + kInvert) > 0.5f;
  u.chroma_key =
      (gates & kGateChromaKey) && __ldg(p + kChromaKeyEnabled) > 0.5f;
  if (u.chroma_key) {
    u.key[0] = __ldg(p + kKeyR);
    u.key[1] = __ldg(p + kKeyG);
    u.key[2] = __ldg(p + kKeyB);
    u.e0 = __ldg(p + kKeyTolerance);
    u.e_span = sub(add(u.e0, __ldg(p + kKeySmoothness)), u.e0);
  }
  u.vignette_amount = __ldg(p + kVignette);
  u.vignette = (gates & kGateVignette) && u.vignette_amount > kUniformEps;
  u.noise_amount = __ldg(p + kNoise);
  u.noise = (gates & kGateNoise) && u.noise_amount > kUniformEps;
  if (u.noise) u.fi = mul(__ll2float_rn(__ldg(a.frame_index)), kFrameScale);
  u.clip = (gates & (kGateSepia | kGateNoise)) != 0;
  u.after_floor = u.gamma || u.sepia || u.invert || u.chroma_key ||
                  u.vignette || u.noise || u.clip;
  u.xy = u.vignette || u.noise;
  return u;
}

// filter.apply_color_adjustments_t on N pixels, stage by stage: each
// stage's uniform test is taken once for the N pixels.
template <typename T, int N>
__device__ __forceinline__ void adjust(const EmitArgs<T>& a, const Uniforms& u,
                                       const int (&x)[N], const int (&y)[N],
                                       float (&r)[N], float (&g)[N],
                                       float (&b)[N], float (&alpha)[N]) {
  // brightness -> contrast -> saturation folded into one affine
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float lum0 = add(add(mul(kLuma[0], r[k]), mul(kLuma[1], g[k])),
                           mul(kLuma[2], b[k]));
    const float base = add(mul(u.m, lum0), u.k0);
    r[k] = add(mul(u.cs, r[k]), base);
    g[k] = add(mul(u.cs, g[k]), base);
    b[k] = add(mul(u.cs, b[k]), base);
  }

  if (u.hue) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float h, hs, hv;
      rgb_to_hsv(clamp01(r[k]), clamp01(g[k]), clamp01(b[k]), h, hs, hv);
      h = fract(add(h, u.hue_shift));
      r[k] = hsv_channel(h, hs, hv, 1.0f);
      g[k] = hsv_channel(h, hs, hv, kTwoThirds);
      b[k] = hsv_channel(h, hs, hv, kThird);
    }
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    r[k] = clampf(r[k], kGammaFloor, 1.0f);
    g[k] = clampf(g[k], kGammaFloor, 1.0f);
    b[k] = clampf(b[k], kGammaFloor, 1.0f);
  }
  if (!u.after_floor) return;  // b/c/s (and hue) only

  if (u.gamma) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      r[k] = powf(r[k], u.inv_gamma);
      g[k] = powf(g[k], u.inv_gamma);
      b[k] = powf(b[k], u.inv_gamma);
    }
  }

  if (u.sepia) {
    const float sep = u.sepia_amount;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float sc[3];
#pragma unroll
      for (int row = 0; row < 3; ++row) {
        sc[row] = add(add(mul(kSepiaM[row][0], r[k]),
                          mul(kSepiaM[row][1], g[k])),
                      mul(kSepiaM[row][2], b[k]));
      }
      r[k] = add(r[k], mul(sub(sc[0], r[k]), sep));
      g[k] = add(g[k], mul(sub(sc[1], g[k]), sep));
      b[k] = add(b[k], mul(sub(sc[2], b[k]), sep));
    }
  }

  if (u.invert) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      r[k] = sub(1.0f, r[k]);
      g[k] = sub(1.0f, g[k]);
      b[k] = sub(1.0f, b[k]);
    }
  }

  if (u.chroma_key) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float dr = sub(r[k], u.key[0]);
      const float dg = sub(g[k], u.key[1]);
      const float db = sub(b[k], u.key[2]);
      const float dist =
          __fsqrt_rn(add(add(mul(dr, dr), mul(dg, dg)), mul(db, db)));
      const float t = clamp01(__fdiv_rn(sub(dist, u.e0), u.e_span));
      alpha[k] = mul(alpha[k], smooth_tail(t));
    }
  }

  if (u.vignette) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float cx = sub(__ldg(a.tx + x[k]), 0.5f);
      const float cy = sub(__ldg(a.ty + y[k]), 0.5f);
      const float vdist = mul(__fsqrt_rn(add(mul(cx, cx), mul(cy, cy))),
                              kVignetteScale);
      const float t = clamp01(mul(sub(vdist, 0.5f), 2.0f));
      const float vig = sub(1.0f, mul(smooth_tail(t), u.vignette_amount));
      r[k] = mul(r[k], vig);
      g[k] = mul(g[k], vig);
      b[k] = mul(b[k], vig);
    }
  }

  if (u.noise) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float n = hash12(__ldg(a.px + x[k]), __ldg(a.py + y[k]), u.fi);
      n = mul(mul(sub(n, 0.5f), u.noise_amount), 0.5f);
      r[k] = add(r[k], n);
      g[k] = add(g[k], n);
      b[k] = add(b[k], n);
    }
  }

  // sepia's rows sum past 1 and grain adds +-noise/4: only those gates keep
  // the final clip (filter.py elides it otherwise)
  if (u.clip) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      r[k] = clamp01(r[k]);
      g[k] = clamp01(g[k]);
      b[k] = clamp01(b[k]);
    }
  }
}

// Everything after the source values, on N pixels at (x[k], y[k]): the
// border, then the adjustments.
template <typename T, int N>
__device__ __forceinline__ void shade(const EmitArgs<T>& a, const Uniforms& u,
                                      const int (&x)[N], const int (&y)[N],
                                      float (&r)[N], float (&g)[N],
                                      float (&b)[N], float (&alpha)[N]) {
  if (a.border_rows != nullptr) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (!(__ldg(a.border_rows + y[k]) && __ldg(a.border_cols + x[k]))) {
        r[k] = a.border[0];
        g[k] = a.border[1];
        b[k] = a.border[2];
        alpha[k] = a.border[3];
      }
    }
  }
  if (a.gates >= 0) adjust(a, u, x, y, r, g, b, alpha);
}

// One pixel, scalar loads and stores: the scalar path.
template <typename T, bool kRgba>
__device__ __forceinline__ void emit_pixel(const EmitArgs<T>& a,
                                           const Uniforms& u, size_t plane,
                                           size_t i) {
  const int y[1] = {static_cast<int>(i) / a.width};
  const int x[1] = {static_cast<int>(i) - y[0] * a.width};
  float r[1], g[1], b[1], alpha[1];
  if (kRgba) {
    r[0] = load(a.src, i);
    g[0] = load(a.src, plane + i);
    b[0] = load(a.src, 2 * plane + i);
    alpha[0] = load(a.src, 3 * plane + i);
  } else {
    yuv_to_rgb(load(a.src, i), __ldg(a.u + i), __ldg(a.v + i), a.matrix_index,
               r[0], g[0], b[0]);
    alpha[0] = 1.0f;
  }
  shade(a, u, x, y, r, g, b, alpha);
  if (a.out_f32) {
    float* o = static_cast<float*>(a.out);
    o[i] = r[0];
    o[plane + i] = g[0];
    o[2 * plane + i] = b[0];
    o[3 * plane + i] = alpha[0];
  } else {
    uint8_t* o = static_cast<uint8_t*>(a.out);
    o[i] = quant(r[0]);
    o[plane + i] = quant(g[0]);
    o[2 * plane + i] = quant(b[0]);
    o[3 * plane + i] = quant(alpha[0]);
  }
}

// -- the vector path: kVec consecutive pixels of every plane a thread -------

constexpr int kVec = 4;

// kVec pixels of one plane in registers: one 4-byte word of uint8 pixels, or
// one float4.
template <typename T>
struct Vec;

template <>
struct Vec<uint8_t> {
  uint32_t w;
  __device__ __forceinline__ void load(const uint8_t* p, size_t vec) {
    w = __ldg(reinterpret_cast<const unsigned int*>(p) + vec);
  }
  __device__ __forceinline__ void get(float (&f)[kVec]) const {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      f[k] = dequant(static_cast<uint8_t>(w >> (8 * k)));
    }
  }
};

template <>
struct Vec<float> {
  float4 q;
  __device__ __forceinline__ void load(const float* p, size_t vec) {
    q = __ldg(reinterpret_cast<const float4*>(p) + vec);
  }
  __device__ __forceinline__ void get(float (&f)[kVec]) const {
    f[0] = q.x;
    f[1] = q.y;
    f[2] = q.z;
    f[3] = q.w;
  }
};

// One vector's source planes: the RGBA stack, or luma + float32 chroma.
template <typename T, bool kRgba>
struct Source {
  Vec<T> s[kRgba ? 4 : 1];
  Vec<float> u, v;

  __device__ __forceinline__ void load(const EmitArgs<T>& a, size_t plane,
                                       size_t vec) {
    if constexpr (kRgba) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c].load(a.src + c * plane, vec);
    } else {
      s[0].load(a.src, vec);
      u.load(a.u, vec);
      v.load(a.v, vec);
    }
  }

  // px[channel][pixel]: r, g, b, alpha of the vector's pixels
  __device__ __forceinline__ void get(const EmitArgs<T>& a,
                                      float (&px)[4][kVec]) const {
    if constexpr (kRgba) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c].get(px[c]);
    } else {
      float y4[kVec], u4[kVec], v4[kVec];
      s[0].get(y4);
      u.get(u4);
      v.get(v4);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        yuv_to_rgb(y4[k], u4[k], v4[k], a.matrix_index, px[0][k], px[1][k],
                   px[2][k]);
        px[3][k] = 1.0f;
      }
    }
  }
};

__device__ __forceinline__ uint32_t pack4(const float (&c)[kVec]) {
  return static_cast<uint32_t>(quant(c[0])) |
         static_cast<uint32_t>(quant(c[1])) << 8 |
         static_cast<uint32_t>(quant(c[2])) << 16 |
         static_cast<uint32_t>(quant(c[3])) << 24;
}

// Load, shade and store the vector `vec` (pixels kVec*vec ..): one 4-byte
// word per uint8 output plane, one float4 per float32 one.
template <typename T, bool kRgba>
__device__ __forceinline__ void emit_vec(const EmitArgs<T>& a,
                                         const Uniforms& u, size_t plane,
                                         size_t vec) {
  Source<T, kRgba> s;
  s.load(a, plane, vec);
  float px[4][kVec];
  s.get(a, px);
  int x[kVec] = {}, y[kVec] = {};
  if (a.border_rows != nullptr || u.xy) {
    const int i0 = static_cast<int>(vec) * kVec;  // H*W < 2^31 (launch_emit)
    y[0] = i0 / a.width;
    x[0] = i0 - y[0] * a.width;
#pragma unroll
    for (int k = 1; k < kVec; ++k) {
      const bool wrap = x[k - 1] + 1 == a.width;
      x[k] = wrap ? 0 : x[k - 1] + 1;
      y[k] = wrap ? y[k - 1] + 1 : y[k - 1];
    }
  }
  shade(a, u, x, y, px[0], px[1], px[2], px[3]);
  if (a.out_f32) {
    float4* o = static_cast<float4*>(a.out) + vec;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o[c * plane / kVec] = make_float4(px[c][0], px[c][1], px[c][2], px[c][3]);
    }
  } else {
    uint32_t* o = static_cast<uint32_t*>(a.out) + vec;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c * plane / kVec] = pack4(px[c]);
  }
}

// The vector path reads and writes kVec pixels of a plane in one access (4
// bytes of uint8, 16 of float32), so every plane must start on that
// access's boundary: each base pointer, and in a (4, H, W) stack (the
// output, an RGBA source) each plane, H*W pixels after the last, which
// takes H*W % kVec == 0 (and leaves no ragged tail).  A V plane that is a
// view into one stacked (2, H, W) chroma tensor (convert.plan_rgba_sampler)
// starts H*W floats after U, off 16 bytes when H*W % 4 != 0.
bool on(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

bool vector_path(const void* src, size_t src_item, const float* u,
                 const float* v, const void* out, size_t out_item,
                 long long plane) {
  return plane % kVec == 0 && on(src, kVec * src_item) &&
         (u == nullptr || on(u, sizeof(float4))) &&
         (v == nullptr || on(v, sizeof(float4))) && on(out, kVec * out_item);
}

// kVector: the frame goes as kVec-pixel vectors, else one pixel a thread;
// either way in a grid-stride loop.
template <typename T, bool kRgba, bool kVector>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const EmitArgs<T> a) {
  const Uniforms u = a.gates >= 0 ? load_uniforms(a) : Uniforms{};
  const size_t plane = static_cast<size_t>(a.height) * a.width;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVector) {
    for (size_t vec = tid; vec < plane / kVec; vec += stride) {
      emit_vec<T, kRgba>(a, u, plane, vec);
    }
  } else {
    for (size_t i = tid; i < plane; i += stride) {
      emit_pixel<T, kRgba>(a, u, plane, i);
    }
  }
}

// The grid: enough blocks for one trip of the loop over the frame, at most
// the blocks the card holds resident at once (asked once per kernel and
// card, `resident_blocks`).
template <typename T, bool kRgba, bool kVector>
void launch(const EmitArgs<T>& a, cudaStream_t stream) {
  static PerDevice resident = {};
  const auto kernel = emit_kernel<T, kRgba, kVector>;
  const int blocks = resident_blocks(kernel, kThreads, resident);
  const long long plane = static_cast<long long>(a.height) * a.width;
  const long long items = kVector ? plane / kVec : plane;
  const long long needed = (items + kThreads - 1) / kThreads;
  kernel<<<static_cast<int>(needed < blocks ? needed : blocks), kThreads, 0,
           stream>>>(a);
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
  const EmitArgs<T> a{static_cast<const T*>(src), u, v, out, out_f32,
                      height, width, matrix_index, border_rows, border_cols,
                      {br, bg, bb, ba}, params, frame_index, tx, ty, px, py,
                      gates};
  const bool vector =
      vector_path(src, sizeof(T), is_rgba ? nullptr : u, is_rgba ? nullptr : v,
                  out, out_f32 ? sizeof(float) : sizeof(uint8_t),
                  static_cast<long long>(height) * width);
  if (is_rgba) {
    vector ? launch<T, true, true>(a, stream) : launch<T, true, false>(a, stream);
  } else {
    vector ? launch<T, false, true>(a, stream)
           : launch<T, false, false>(a, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t (0 on success); the wrapper raises on non-zero.
// emit_u8: the source planes (RGBA stack or luma) are uint8; emit_f32:
// float32.  U and V are always float32 planes at the output grid.  Each
// launch takes the vector path where `vector_path` allows it.
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

// 1 where an emit of these planes takes the vector path, else 0 (the
// scalar path); src_f32 and out_f32 as for emit_f32 and `out_f32`.  For
// reports: the launch decides by itself.
extern "C" int emit_vector_path(const void* src, int src_f32, const float* u,
                                const float* v, const void* out, int out_f32,
                                int height, int width) {
  return vector_path(src, src_f32 ? sizeof(float) : sizeof(uint8_t), u, v,
                     out, out_f32 ? sizeof(float) : sizeof(uint8_t),
                     static_cast<long long>(height) * width);
}
