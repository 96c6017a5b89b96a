// Host-side whole-plane ops that are memory-bound in numpy because of
// temporary allocation (each 100+ MB numpy temporary page-faults on
// first write). One fused pass each, exact semantics.
//
// Capability references:
//   RCT: jxl/src/frame/modular/transforms/rct.rs:18-50
//   interleave/convert: jxl/src/render/stages/convert.rs:345-
// The numpy oracle (modular/transforms.py apply_rct, render/simple.py
// _modular_to_f32) stays as the semantic twin; tests compare both.

#include <cstdint>
#include <cstring>

namespace {

// numpy int32 arithmetic wraps; compute in uint32 (defined) and shift
// arithmetically on the int32 reinterpretation.
static inline int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
static inline int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

}  // namespace

extern "C" {

// In-place-safe fused RCT: for each pixel, read (v0,v1,v2), apply `op`,
// permute, write (o0,o1,o2). Output pixels depend only on same-position
// inputs, so aliasing in/out buffers is fine. Strides in elements.
void jxl_rct(const int32_t* in0, int64_t s_in0, const int32_t* in1,
             int64_t s_in1, const int32_t* in2, int64_t s_in2, int32_t* out0,
             int64_t s_out0, int32_t* out1, int64_t s_out1, int32_t* out2,
             int64_t s_out2, int64_t w, int64_t h, int op, int perm) {
  // _RCT_PERM: out slot gets res[src[slot]]
  static const int kPerm[6][3] = {{0, 1, 2}, {2, 0, 1}, {1, 2, 0},
                                  {0, 2, 1}, {1, 0, 2}, {2, 1, 0}};
  const int p0 = kPerm[perm][0], p1 = kPerm[perm][1], p2 = kPerm[perm][2];
  for (int64_t y = 0; y < h; y++) {
    const int32_t* r0 = in0 + y * s_in0;
    const int32_t* r1 = in1 + y * s_in1;
    const int32_t* r2 = in2 + y * s_in2;
    int32_t* w0 = out0 + y * s_out0;
    int32_t* w1 = out1 + y * s_out1;
    int32_t* w2 = out2 + y * s_out2;
    for (int64_t x = 0; x < w; x++) {
      int32_t v0 = r0[x], v1 = r1[x], v2 = r2[x];
      switch (op) {
        case 0:
          break;
        case 1:
          v2 = wadd(v2, v0);
          break;
        case 2:
          v1 = wadd(v1, v0);
          break;
        case 3:
          v1 = wadd(v1, v0);
          v2 = wadd(v2, v0);
          break;
        case 4:
          v1 = wadd(v1, wadd(v0, v2) >> 1);
          break;
        case 5:
          v2 = wadd(v2, v0);
          v1 = wadd(v1, wadd(v0, v2) >> 1);
          break;
        case 6: {
          int32_t yv = v0, co = v1, cg = v2;
          yv = wsub(yv, cg >> 1);
          int32_t g = wadd(cg, yv);
          yv = wsub(yv, co >> 1);
          int32_t r = wadd(yv, co);
          v0 = r;
          v1 = g;
          v2 = yv;
          break;
        }
      }
      const int32_t res[3] = {v0, v1, v2};
      w0[x] = res[p0];
      w1[x] = res[p1];
      w2[x] = res[p2];
    }
  }
}

// Interleave n f32 planes into (h, w, n) f32. Strides in elements.
void jxl_interleave_f32(const float** planes, const int64_t* strides, int n,
                        int64_t w, int64_t h, float* out) {
  if (n == 3) {
    const float *a = planes[0], *b = planes[1], *c = planes[2];
    const int64_t sa = strides[0], sb = strides[1], sc = strides[2];
    for (int64_t y = 0; y < h; y++) {
      const float* ra = a + y * sa;
      const float* rb = b + y * sb;
      const float* rc = c + y * sc;
      float* o = out + y * w * 3;
      for (int64_t x = 0; x < w; x++) {
        o[3 * x] = ra[x];
        o[3 * x + 1] = rb[x];
        o[3 * x + 2] = rc[x];
      }
    }
    return;
  }
  for (int64_t y = 0; y < h; y++) {
    float* o = out + y * w * n;
    for (int c = 0; c < n; c++) {
      const float* r = planes[c] + y * strides[c];
      for (int64_t x = 0; x < w; x++) o[x * n + c] = r[x];
    }
  }
}

// Interleave n u8 planes into (h, w, n) u8.
void jxl_interleave_u8(const uint8_t** planes, const int64_t* strides, int n,
                       int64_t w, int64_t h, uint8_t* out) {
  if (n == 3) {
    const uint8_t *a = planes[0], *b = planes[1], *c = planes[2];
    const int64_t sa = strides[0], sb = strides[1], sc = strides[2];
    for (int64_t y = 0; y < h; y++) {
      const uint8_t* ra = a + y * sa;
      const uint8_t* rb = b + y * sb;
      const uint8_t* rc = c + y * sc;
      uint8_t* o = out + y * w * 3;
      for (int64_t x = 0; x < w; x++) {
        o[3 * x] = ra[x];
        o[3 * x + 1] = rb[x];
        o[3 * x + 2] = rc[x];
      }
    }
    return;
  }
  for (int64_t y = 0; y < h; y++) {
    uint8_t* o = out + y * w * n;
    for (int c = 0; c < n; c++) {
      const uint8_t* r = planes[c] + y * strides[c];
      for (int64_t x = 0; x < w; x++) o[x * n + c] = r[x];
    }
  }
}

// Interleave n u16 planes into (h, w, n) u16.
void jxl_interleave_u16(const uint16_t** planes, const int64_t* strides, int n,
                        int64_t w, int64_t h, uint16_t* out) {
  for (int64_t y = 0; y < h; y++) {
    uint16_t* o = out + y * w * n;
    for (int c = 0; c < n; c++) {
      const uint16_t* r = planes[c] + y * strides[c];
      for (int64_t x = 0; x < w; x++) o[x * n + c] = r[x];
    }
  }
}

// int32 plane -> f32 plane times scale (ConvertModularToF32 integer path,
// one pass, no temporaries). Exact: single f32 multiply per sample like
// numpy's astype(float32) * float32(scale).
void jxl_i32_to_f32_scaled(const int32_t* in, int64_t stride_in, int64_t w,
                           int64_t h, float scale, float* out,
                           int64_t stride_out) {
  for (int64_t y = 0; y < h; y++) {
    const int32_t* r = in + y * stride_in;
    float* o = out + y * stride_out;
    for (int64_t x = 0; x < w; x++) o[x] = (float)r[x] * scale;
  }
}

// Fused: n int32 planes -> interleaved (h, w, n) f32 with scale.
void jxl_i32_scaled_interleave(const int32_t** planes, const int64_t* strides,
                               int n, int64_t w, int64_t h, float scale,
                               float* out) {
  if (n == 3) {
    const int32_t *a = planes[0], *b = planes[1], *c = planes[2];
    const int64_t sa = strides[0], sb = strides[1], sc = strides[2];
    for (int64_t y = 0; y < h; y++) {
      const int32_t* ra = a + y * sa;
      const int32_t* rb = b + y * sb;
      const int32_t* rc = c + y * sc;
      float* o = out + y * w * 3;
      for (int64_t x = 0; x < w; x++) {
        o[3 * x] = (float)ra[x] * scale;
        o[3 * x + 1] = (float)rb[x] * scale;
        o[3 * x + 2] = (float)rc[x] * scale;
      }
    }
    return;
  }
  for (int64_t y = 0; y < h; y++) {
    float* o = out + y * w * n;
    for (int c = 0; c < n; c++) {
      const int32_t* r = planes[c] + y * strides[c];
      for (int64_t x = 0; x < w; x++) o[x * n + c] = (float)r[x] * scale;
    }
  }
}

}  // extern "C"
