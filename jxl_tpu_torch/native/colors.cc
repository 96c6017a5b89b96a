// Fused XYB -> linear RGB -> sRGB -> dithered u8, row-buffered passes.
//
// Same math as color/xyb.py xyb_to_linear + color/tf.py linear_to_srgb +
// render/stages/core.py f32_to_u8 (capability ref render/stages/xyb.rs,
// color/tf.rs, stages/convert.rs:549-607), fused so the three planes are
// read once and the interleaved u8 output written once — the numpy chain
// makes ~12 whole-plane passes. Compiled with -ffast-math/-fopenmp-simd
// (separately from the exact-semantics kernels) so powf vectorizes
// through libmvec; the ~4-ulp powf error is far below the u8 dither
// quantum. Each pass is a branch-free simd loop over one row (the pow
// branch computes both sides and selects, so gcc if-converts it).
//
// Rounding: nearbyintf under the default FE_TONEAREST mode = round half
// to even, matching numpy's np.round.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// PQ (SMPTE ST 2084) constants, ref color/tf.py
constexpr float kPqM1 = 2610.0f / 16384;
constexpr float kPqM2 = (2523.0f / 4096) * 128;
constexpr float kPqC1 = 3424.0f / 4096;
constexpr float kPqC2 = (2413.0f / 4096) * 32;
constexpr float kPqC3 = (2392.0f / 4096) * 32;

// Apply the display transfer function to one row of linear values,
// scaled by 255 for the u8 stage. Each kind is its own branch-free simd
// loop (the conditional computes both sides and selects so gcc
// if-converts; powf vectorizes via libmvec under -ffast-math).
void tf_row(float* rc, int64_t w, int tf_kind, float tf_p0, float scale) {
  switch (tf_kind) {
    case 0: {  // sRGB
      const float p = 1.0f / 2.4f;
#pragma omp simd
      for (int64_t i = 0; i < w; ++i) {
        float v = rc[i];
        float a = fabsf(v);
        float pw = 1.055f * powf(a, p) - 0.055f;
        float lin = a * 12.92f;
        float t = a <= 0.0031308f ? lin : pw;
        rc[i] = copysignf(t, v) * scale;
      }
      break;
    }
    case 1: {  // PQ; tf_p0 = intensity_target / 10000
#pragma omp simd
      for (int64_t i = 0; i < w; ++i) {
        float v = rc[i];
        float a = fabsf(v) * tf_p0;
        float ym = powf(a, kPqM1);
        float t = powf((kPqC1 + kPqC2 * ym) / (1.0f + kPqC3 * ym), kPqM2);
        rc[i] = copysignf(t, v) * scale;
      }
      break;
    }
    case 2: {  // BT.709
#pragma omp simd
      for (int64_t i = 0; i < w; ++i) {
        float v = rc[i];
        float a = fabsf(v);
        float pw = 1.09929682680944f * powf(a, 0.45f) - 0.09929682680944f;
        float lin = a * 4.5f;
        float t = a < 0.018053968510807f ? lin : pw;
        rc[i] = copysignf(t, v) * scale;
      }
      break;
    }
    case 3: {  // pure gamma; tf_p0 = g
#pragma omp simd
      for (int64_t i = 0; i < w; ++i) {
        float v = rc[i];
        rc[i] = copysignf(powf(fabsf(v), tf_p0), v) * scale;
      }
      break;
    }
    default: {  // linear
#pragma omp simd
      for (int64_t i = 0; i < w; ++i) rc[i] *= scale;
      break;
    }
  }
}

// LUT transfer functions for the u8 output path only: the u8 quantum is
// 1/255 and the blue-noise dither already perturbs by up to half of it,
// so a 4096-segment lerp (max error ~0.004 of one LSB for sRGB/709,
// validated against the exact powf forms in tests) is far inside the
// +/-1 LSB output contract while replacing 1-2 vector powf calls per
// element. PQ and pure-gamma curves have unbounded curvature at 0, so
// those LUTs index by a^(1/8) (three sqrts) instead of a.
// The f32 output path keeps the exact powf forms.
constexpr int kTfLutN = 4096;

struct TfLut {
  int kind = -1;
  float p0 = 0.0f;
  std::vector<float> lut;  // kTfLutN + 2 entries, pre-scaled by 255
};

const float* tf_lut_u8(int tf_kind, float tf_p0) {
  static thread_local TfLut cache;
  if (cache.kind == tf_kind && cache.p0 == tf_p0 && !cache.lut.empty())
    return cache.lut.data();
  cache.kind = tf_kind;
  cache.p0 = tf_p0;
  cache.lut.assign(kTfLutN + 2, 0.0f);
  for (int i = 0; i <= kTfLutN; ++i) {
    double a = (double)i / kTfLutN;
    double t = a;
    switch (tf_kind) {
      case 0:  // sRGB, indexed by a
        t = a <= 0.0031308 ? a * 12.92 : 1.055 * std::pow(a, 1.0 / 2.4) - 0.055;
        break;
      case 1: {  // PQ, indexed by (a * tf_p0)^(1/8)
        double lin = std::pow(a, 8.0);
        double ym = std::pow(lin, (double)kPqM1);
        t = std::pow((kPqC1 + (double)kPqC2 * ym) / (1.0 + (double)kPqC3 * ym),
                     (double)kPqM2);
        break;
      }
      case 2:  // BT.709, indexed by a
        t = a < 0.018
                ? a * 4.5
                : 1.09929682680944 * std::pow(a, 0.45) - 0.09929682680944;
        break;
      case 3:  // pure gamma tf_p0, indexed by a^(1/8)
        t = std::pow(std::pow(a, 8.0), (double)tf_p0);
        break;
      default:
        break;
    }
    cache.lut[i] = (float)(t * 255.0);
  }
  cache.lut[kTfLutN + 1] = cache.lut[kTfLutN];
  return cache.lut.data();
}

// u8-path transfer function over one row: LUT lerp, output scaled by 255.
// Semantics match tf_row(..., scale=255) within ~0.004 LSB.
void tf_row_u8(float* rc, int64_t w, int tf_kind, float tf_p0,
               const float* lut) {
  if (tf_kind < 0 || tf_kind > 3) {  // linear (tf_row's default case)
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) rc[i] *= 255.0f;
    return;
  }
  const float n = (float)kTfLutN;
  if (tf_kind == 0 || tf_kind == 2) {
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) {
      float v = rc[i];
      // fminf/fmaxf quash NaN/Inf before indexing (memory safety)
      float a = fminf(fmaxf(fabsf(v), 0.0f), 1.0f) * n;
      int idx = (int)a;
      float fr = a - (float)idx;
      float t = lut[idx] + fr * (lut[idx + 1] - lut[idx]);
      rc[i] = copysignf(t, v);
    }
    return;
  }
  // PQ / gamma: index by the 8th root
  const float s = tf_kind == 1 ? tf_p0 : 1.0f;
#pragma omp simd
  for (int64_t i = 0; i < w; ++i) {
    float v = rc[i];
    float a = fminf(fmaxf(fabsf(v) * s, 0.0f), 1.0f);
    float u = sqrtf(sqrtf(sqrtf(a))) * n;
    int idx = (int)u;
    float fr = u - (float)idx;
    float t = lut[idx] + fr * (lut[idx + 1] - lut[idx]);
    rc[i] = copysignf(t, v);
  }
}

}  // namespace

extern "C" {

void jxl_xyb_srgb_u8(const float* xp, const float* yp, const float* bp,
                     const int64_t* strides,  // 3 row strides in elements
                     int64_t h, int64_t w,
                     const float* mat,      // 9: inverse opsin (maybe adapted)
                     const float* biases,   // 3: opsin biases (raw)
                     float intensity_scale, // 255 / intensity_target
                     const float* dither,   // 32*32 blue-noise table
                     int tf_kind, float tf_p0,
                     uint8_t* out) {        // (h, w, 3) interleaved
  const float cb0 = cbrtf(biases[0]);
  const float cb1 = cbrtf(biases[1]);
  const float cb2 = cbrtf(biases[2]);
  const float sb0 = biases[0] * intensity_scale;
  const float sb1 = biases[1] * intensity_scale;
  const float sb2 = biases[2] * intensity_scale;
  const float m00 = mat[0], m01 = mat[1], m02 = mat[2];
  const float m10 = mat[3], m11 = mat[4], m12 = mat[5];
  const float m20 = mat[6], m21 = mat[7], m22 = mat[8];
  const float* lut =
      (tf_kind >= 0 && tf_kind <= 3) ? tf_lut_u8(tf_kind, tf_p0) : nullptr;
  // pre-tiled dither rows: drows[(phase*3 + c)*w + i] replicates the
  // old per-pixel lookup d_c[( (i&31) + 23c ) & 31] for row phase yy%32
  std::vector<float> drows((size_t)32 * 3 * w);
  for (int ph = 0; ph < 32; ++ph) {
    const float* d0 = dither + (ph % 32) * 32;
    const float* d1 = dither + ((ph + 13) % 32) * 32;
    const float* d2 = dither + ((ph + 26) % 32) * 32;
    float* t0 = drows.data() + ((size_t)ph * 3 + 0) * w;
    float* t1 = drows.data() + ((size_t)ph * 3 + 1) * w;
    float* t2 = drows.data() + ((size_t)ph * 3 + 2) * w;
    for (int64_t i = 0; i < w; ++i) {
      const int i32 = (int)(i & 31);
      t0[i] = d0[i32];
      t1[i] = d1[(i32 + 23) & 31];
      t2[i] = d2[(i32 + 46) & 31];
    }
  }
  std::vector<uint8_t> brows(3 * (size_t)w);
  std::vector<float> buf(3 * (size_t)w);
  float* r0 = buf.data();
  float* r1 = r0 + w;
  float* r2 = r1 + w;
  for (int64_t yy = 0; yy < h; ++yy) {
    const float* xr = xp + yy * strides[0];
    const float* yr = yp + yy * strides[1];
    const float* br = bp + yy * strides[2];
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) {
      float l = yr[i] + xr[i] - cb0;
      float m = yr[i] - xr[i] - cb1;
      float s = br[i] - cb2;
      l = l * l * (l * intensity_scale) + sb0;
      m = m * m * (m * intensity_scale) + sb1;
      s = s * s * (s * intensity_scale) + sb2;
      r0[i] = m00 * l + m01 * m + m02 * s;
      r1[i] = m10 * l + m11 * m + m12 * s;
      r2[i] = m20 * l + m21 * m + m22 * s;
    }
    tf_row_u8(r0, w, tf_kind, tf_p0, lut);
    tf_row_u8(r1, w, tf_kind, tf_p0, lut);
    tf_row_u8(r2, w, tf_kind, tf_p0, lut);
    // dither + clamp + round per channel as vector loops over w-wide
    // pre-tiled dither rows (32 row phases x 3 channel phases, built
    // once per width), then a byte interleave. Identical per-element
    // math to the old scalar fused loop (u8 hashes are pinned by the
    // conformance report).
    const float* dt0 = drows.data() + ((yy % 32) * 3 + 0) * w;
    const float* dt1 = drows.data() + ((yy % 32) * 3 + 1) * w;
    const float* dt2 = drows.data() + ((yy % 32) * 3 + 2) * w;
    uint8_t* b0 = brows.data();
    uint8_t* b1 = b0 + w;
    uint8_t* b2 = b1 + w;
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) {
      float u0 = r0[i] + dt0[i];
      u0 = u0 < 0.0f ? 0.0f : (u0 > 255.0f ? 255.0f : u0);
      b0[i] = (uint8_t)nearbyintf(u0);
    }
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) {
      float u1 = r1[i] + dt1[i];
      u1 = u1 < 0.0f ? 0.0f : (u1 > 255.0f ? 255.0f : u1);
      b1[i] = (uint8_t)nearbyintf(u1);
    }
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) {
      float u2 = r2[i] + dt2[i];
      u2 = u2 < 0.0f ? 0.0f : (u2 > 255.0f ? 255.0f : u2);
      b2[i] = (uint8_t)nearbyintf(u2);
    }
    uint8_t* o = out + yy * w * 3;
    for (int64_t i = 0; i < w; ++i) {
      o[i * 3 + 0] = b0[i];
      o[i * 3 + 1] = b1[i];
      o[i * 3 + 2] = b2[i];
    }
  }
}

// Same fused XYB -> linear -> display TF, but writing f32 planes back in
// place (no scaling/dither) — serves the paths that need float output
// (blending, referenced frames, extra channels).
void jxl_xyb_tf_f32(float* xp, float* yp, float* bp, int64_t h, int64_t w,
                    const float* mat, const float* biases,
                    float intensity_scale, int tf_kind, float tf_p0) {
  const float cb0 = cbrtf(biases[0]);
  const float cb1 = cbrtf(biases[1]);
  const float cb2 = cbrtf(biases[2]);
  const float sb0 = biases[0] * intensity_scale;
  const float sb1 = biases[1] * intensity_scale;
  const float sb2 = biases[2] * intensity_scale;
  const float m00 = mat[0], m01 = mat[1], m02 = mat[2];
  const float m10 = mat[3], m11 = mat[4], m12 = mat[5];
  const float m20 = mat[6], m21 = mat[7], m22 = mat[8];
  std::vector<float> buf(3 * (size_t)w);
  float* r0 = buf.data();
  float* r1 = r0 + w;
  float* r2 = r1 + w;
  for (int64_t yy = 0; yy < h; ++yy) {
    float* xr = xp + yy * w;
    float* yr = yp + yy * w;
    float* br = bp + yy * w;
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) {
      float l = yr[i] + xr[i] - cb0;
      float m = yr[i] - xr[i] - cb1;
      float s = br[i] - cb2;
      l = l * l * (l * intensity_scale) + sb0;
      m = m * m * (m * intensity_scale) + sb1;
      s = s * s * (s * intensity_scale) + sb2;
      r0[i] = m00 * l + m01 * m + m02 * s;
      r1[i] = m10 * l + m11 * m + m12 * s;
      r2[i] = m20 * l + m21 * m + m22 * s;
    }
    tf_row(r0, w, tf_kind, tf_p0, 1.0f);
    tf_row(r1, w, tf_kind, tf_p0, 1.0f);
    tf_row(r2, w, tf_kind, tf_p0, 1.0f);
#pragma omp simd
    for (int64_t i = 0; i < w; ++i) {
      xr[i] = r0[i];
      yr[i] = r1[i];
      br[i] = r2[i];
    }
  }
}


// Dequant + chroma-from-luma in one pass (the hot body of
// vardct/group.py _render_group): reads quantized coefficients straight
// from the per-channel concatenated buffers (no gathered int temporary),
// applies the small-value bias adjustment
//   |q| < 2 ? q * bias[c]  :  q - bias[3]/q
// then per-block scale * dequant-matrix, then CfL (x += xcc*y,
// b += bcc*y). out: (N, 3, nc) f32 in channel order (x, y, b) matching
// the python caller's plane order. Lives in this fast-math TU so the
// guarded division if-converts and vectorizes (the guard keeps the
// untaken lane finite, which fast-math requires).
void jxl_dequant_cfl(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                     const int64_t* offs, int64_t n, int nc,
                     const float* mats,    // (3, nc)
                     const float* scales,  // (n, 3)
                     const float* xcc, const float* bcc,
                     const float* biases,  // 4
                     float* out) {         // (n, 3, nc)
  const float b0 = biases[0], b1 = biases[1], b2 = biases[2], b3 = biases[3];
  const float* m0 = mats;
  const float* m1 = mats + nc;
  const float* m2 = mats + 2 * (size_t)nc;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = offs[i];
    const float s0 = scales[i * 3 + 0];
    const float s1 = scales[i * 3 + 1];
    const float s2 = scales[i * 3 + 2];
    const float xc = xcc[i], bc = bcc[i];
    const int32_t* q0 = c0 + off;
    const int32_t* q1 = c1 + off;
    const int32_t* q2 = c2 + off;
    float* o0 = out + (size_t)i * 3 * nc;
    float* o1 = o0 + nc;
    float* o2 = o1 + nc;
#pragma omp simd
    for (int k = 0; k < nc; ++k) {
      const float qy = (float)q1[k];
      const float dy = qy != 0.0f ? qy : 1.0f;
      const float ay = (q1[k] < 2 && q1[k] > -2) ? qy * b1 : qy - b3 / dy;
      const float y = ay * m1[k] * s1;
      const float qx = (float)q0[k];
      const float dx = qx != 0.0f ? qx : 1.0f;
      const float ax = (q0[k] < 2 && q0[k] > -2) ? qx * b0 : qx - b3 / dx;
      const float qb = (float)q2[k];
      const float db = qb != 0.0f ? qb : 1.0f;
      const float ab = (q2[k] < 2 && q2[k] > -2) ? qb * b2 : qb - b3 / db;
      o1[k] = y;
      o0[k] = ax * m0[k] * s0 + xc * y;
      o2[k] = ab * m2[k] * s2 + bc * y;
    }
  }
}

}  // extern "C"
