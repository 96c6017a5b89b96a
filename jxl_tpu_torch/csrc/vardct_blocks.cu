// K5: the 4:4:4 VarDCT block render. For the n blocks of one transform
// type, each block's three channels: gather the quantized coefficients
// from the dense (G * 3 * 256 * 256,) int32 coefficient buffer, dequantize
// them (the quant bias, the type's dequant weights, the block's scale),
// add chroma from luma (X += x_cc * Y, B += b_cc * Y, on Y's dequantized
// value), put the LF in (the DC of the 8x8-footprint types; the
// reinterpreting DCT of the block's LF tile for DCT16 and larger), run the
// type's inverse transform and write the pixels into the (3, P) planes.
//
// Replaces no TPU kernel: jxl_tpu writes this stage as XLA
// (jxl_tpu/vardct/device_frame.py), and the port ran it as some 30 torch
// ops a type plus a chunked, padded chain of batched matrix products a
// channel (ops/vardct_blocks.py:vardct_blocks_reference, the plain
// version). Its work is small: a 4K frame reads 3 x 64 int32 and writes
// 3 x 64 float32 a block, about 200 MB, and runs 16 multiply-adds a pixel
// for the 8x8 types. So what bounds it is bytes, and the design keeps
// every intermediate on chip: one launch a type present in the frame
// (the kernel is a template on the type), no index tensors, no padding,
// and a block's pixels depend only on that block, so a band's, a shard's
// or a batch's render equals the whole frame's bit for bit.
//
// - The ten 8x8-footprint types (DCT8, IDENTITY, DCT2X2, DCT4X4, DCT4X8,
//   DCT8X4, AFV0-3) run one warp a block, eight blocks a CTA: the 192
//   coefficients load coalesced (six a lane), dequantize in registers, and
//   each separable pass goes through the warp's 2 x 192 floats of shared
//   memory, 192 outputs a pass, six a lane. Each type's passes repeat
//   vardct/transforms_batch.py's arithmetic.
// - DCT16 and larger run one CTA of 256 threads a (block, channel): the
//   channel's coefficients stream in chunks of 4096 through shared memory
//   for the first (horizontal) pass, whose result (a float a pixel) stays
//   in shared memory up to 32768 pixels, the second pass reading it from
//   there. DCT256X256's 65536 floats pass the 227 KB a CTA may hold, so
//   there the first pass writes into the block's own region of the planes
//   and the second pass rewrites that region in place, 16 columns at a
//   time. X and B re-read Y's coefficients for chroma from luma.
//
// Float order: the dequant and the factors round as the plain version
// rounds them (nvcc --fmad=false; IEEE division); the products of the
// transforms sum in index order with fused multiply-adds, where cuBLAS
// picks its own order, so the two differ at the ulp level there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kChannelStride = 256 * 256;  // a group's channel in the buffer
// the constants buffer (ops/vardct_blocks.py:_constants): IDCT(n) for n =
// 1, 2, ..., 256, then DCT(n) = IDCT(n)^T for the same n, then the
// reinterpreting DCT's scales(n) for n = 1, 2, ..., 32, then the AFV basis
constexpr int kIdctTotal = 87381;  // sum of n * n
constexpr int kDctOff = kIdctTotal;
constexpr int kScalesOff = 2 * kIdctTotal;
constexpr int kAfvOff = kScalesOff + 63;
constexpr int kSmallWarps = 8;  // 8x8-footprint blocks a CTA
constexpr int kLargeThreads = 256;
constexpr int kChunk = 4096;  // floats of a large type's coefficient chunk

__host__ __device__ constexpr int idct_off(int n) {
  int o = 0;
  for (int m = 1; m < n; m *= 2) o += m * m;
  return o;
}

__host__ __device__ constexpr int scales_off(int n) { return kScalesOff + n - 1; }

__host__ __device__ constexpr int cover_x(int t) {
  constexpr int v[27] = {1, 1, 1, 1, 2, 4, 1, 2, 1, 4, 2, 4, 1, 1,
                         1, 1, 1, 1, 8, 4, 8, 16, 8, 16, 32, 16, 32};
  return v[t];
}

__host__ __device__ constexpr int cover_y(int t) {
  constexpr int v[27] = {1, 1, 1, 1, 2, 4, 2, 1, 4, 1, 4, 2, 1, 1,
                         1, 1, 1, 1, 8, 8, 4, 16, 16, 8, 32, 32, 16};
  return v[t];
}

__host__ __device__ constexpr bool is_small(int t) { return cover_x(t) == 1 && cover_y(t) == 1; }

// transform type ids (vardct/transform_map.py:HfTransformType)
constexpr int kDct = 0, kIdentity = 1, kDct2x2 = 2, kDct4x4 = 3, kDct4x8 = 12, kDct8x4 = 13,
              kAfv0 = 14;

struct Args {
  const int32_t* flat;  // dense coefficients
  const longlong2* cols;  // (n, 4) int64: first coefficient, LF index, first pixel, colour tile
  const float* lf;      // (3, L) LF samples, channel stride lf_plane
  long long lf_plane;
  int lf_stride;        // LF samples a tile row
  const int32_t* rq;    // raw quant, at the LF index
  const float* ytox;    // colour tiles, at the tile index
  const float* ytob;
  const float* k;       // (6, k_row) frame factors, block stride k_block (0 or 1)
  int k_row;
  int k_block;
  const float* bias;    // quant biases (4,)
  const float* mats;    // (m, 3, nc) dequant weights, block stride mats_block (0 or 3 nc)
  long long mats_block;
  float* planes;        // (3, P) pixels, channel stride plane, rows W apart
  long long plane;
  int W;
  const float* consts;
  int n;
};

struct Factors {
  float s0, s1, s2;           // dequant scales a channel
  float xcc, bcc;             // chroma from luma
  float bias0, bias1, bias2, b3;
};

// a row of the block columns (ops/vardct_blocks.py:block_columns)
struct Col {
  long long base, lf, pix, tile;
};

__device__ __forceinline__ Col column(const Args& a, int b) {
  const longlong2 p = __ldg(a.cols + 2 * (long long)b), q = __ldg(a.cols + 2 * (long long)b + 1);
  return {p.x, p.y, q.x, q.y};
}

// block_factors (ops/vardct_blocks.py) for block b, in its float order
__device__ __forceinline__ Factors factors(const Args& a, int b, long long lf0, long long tile) {
  const float* k = a.k + (long long)b * a.k_block;
  const int r = a.k_row;
  const float x_dm = k[0], b_dm = k[r], igs = k[2 * r], cf = k[3 * r], bcx = k[4 * r],
              bcb = k[5 * r];
  Factors f;
  const float scaled_y = igs / (float)a.rq[lf0];
  f.s0 = scaled_y * x_dm;
  f.s1 = scaled_y;
  f.s2 = scaled_y * b_dm;
  f.xcc = bcx + a.ytox[tile] / cf;
  f.bcc = bcb + a.ytob[tile] / cf;
  f.bias0 = a.bias[0];
  f.bias1 = a.bias[1];
  f.bias2 = a.bias[2];
  f.b3 = a.bias[3];
  return f;
}

__device__ __forceinline__ float pick(int c, float v0, float v1, float v2) {
  return c == 0 ? v0 : (c == 1 ? v1 : v2);
}

// the plain version's dequant: the quant bias, then (adj * weight) * scale
__device__ __forceinline__ float dequant(int q, float bias, float b3, float m, float s) {
  const float qf = (float)q;
  float adj;
  if (q == 0) {
    adj = 0.f;
  } else if (q > -2 && q < 2) {
    adj = qf * bias;
  } else {
    adj = qf - b3 / qf;
  }
  return adj * m * s;
}

// coefficient i (storage order) of channel c, dequantized, with chroma
// from luma for X and B
__device__ __forceinline__ float coeff(const Args& a, const Factors& f, long long base,
                                       const float* mats, int nc, int c, int i) {
  const float y = dequant(__ldg(a.flat + base + kChannelStride + i), f.bias1, f.b3,
                          __ldg(mats + nc + i), f.s1);
  if (c == 1) return y;
  const float v = dequant(__ldg(a.flat + base + c * kChannelStride + i),
                          pick(c, f.bias0, f.bias1, f.bias2), f.b3, __ldg(mats + c * nc + i),
                          pick(c, f.s0, f.s1, f.s2));
  return v + pick(c, f.xcc, 0.f, f.bcc) * y;
}

__device__ __forceinline__ float sum4(float c00, float c01, float c10, float c11, int q) {
  // _corner_dcs4 / _idct2_top_block's four sums, left to right
  switch (q) {
    case 0: return c00 + c01 + c10 + c11;
    case 1: return c00 + c01 - c10 - c11;
    case 2: return c00 - c01 + c10 - c11;
    default: return c00 - c01 - c10 + c11;
  }
}

// ---- the 8x8-footprint types: one warp a block --------------------------
// `in` / `tmp` hold 3 x 64 floats, channel c at c * 64, row-major 8x8.

__device__ __forceinline__ float at(const float* blk, int y, int x) { return blk[y * 8 + x]; }

template <int T>
__device__ __forceinline__ void small_pass1(const float* in, float* tmp, const float* cs, int lane) {
  const float* A4 = cs + idct_off(4);
  const float* A8 = cs + idct_off(8);
#pragma unroll
  for (int m = 0; m < 6; ++m) {  // element j = 32 m + lane: channel m / 2
    const int j = 32 * m + lane, p = 32 * (m & 1) + lane;
    const float* c = in + 64 * (m >> 1);
    float acc = 0.f;
    if constexpr (T == kDct) {
      // s1[x][v] = sum_u A8[x][u] t[u][v], t = the 8x8 storage
      const int x = p >> 3, v = p & 7;
      for (int u = 0; u < 8; ++u) acc = fmaf(A8[x * 8 + u], c[u * 8 + v], acc);
    } else if constexpr (T == kDct2x2) {
      // _idct2_top_block(2): only the top 2x2 changes
      const int y = p >> 3, x = p & 7;
      acc = (y < 2 && x < 2) ? sum4(at(c, 0, 0), at(c, 0, 1), at(c, 1, 0), at(c, 1, 1),
                                    (y << 1) | x)
                             : c[p];
    } else if constexpr (T == kDct4x4) {
      // quad q = (qy, qx): m[x][k] = sum_j A4[x][j] blk[j][k], blk[j][k] =
      // c[qy + 2j][qx + 2k] with blk[0][0] the quad's corner DC
      const int q = p >> 4, x = (p >> 2) & 3, k = p & 3, qy = q >> 1, qx = q & 1;
      const float dc = sum4(at(c, 0, 0), at(c, 0, 1), at(c, 1, 0), at(c, 1, 1), q);
      for (int jj = 0; jj < 4; ++jj) {
        const float b = (jj == 0 && k == 0) ? dc : at(c, qy + 2 * jj, qx + 2 * k);
        acc = fmaf(A4[x * 4 + jj], b, acc);
      }
    } else if constexpr (T == kDct8x4 || T == kDct4x8) {
      // half kk: blk = c[kk::2, :] (4x8) with blk[0][0] = c00 +- c10
      const int kk = p >> 5, e = p & 31;
      const float dc = kk == 0 ? at(c, 0, 0) + at(c, 1, 0) : at(c, 0, 0) - at(c, 1, 0);
      if constexpr (T == kDct8x4) {
        // idct2d(blk, 8, 4): s1[x][v] = sum_u A4[x][u] blk[u][v], x < 4, v < 8
        const int x = e >> 3, v = e & 7;
        for (int u = 0; u < 4; ++u) {
          const float b = (u == 0 && v == 0) ? dc : at(c, kk + 2 * u, v);
          acc = fmaf(A4[x * 4 + u], b, acc);
        }
      } else {
        // idct2d(blk, 4, 8): s1[x][v] = sum_u A8[x][u] blk[v][u], x < 8, v < 4
        const int x = e >> 2, v = e & 3;
        for (int u = 0; u < 8; ++u) {
          const float b = (u == 0 && v == 0) ? dc : at(c, kk + 2 * v, u);
          acc = fmaf(A8[x * 8 + u], b, acc);
        }
      }
    } else {  // AFV0-3
      const float b00 = at(c, 0, 0), b01 = at(c, 0, 1), b10 = at(c, 1, 0);
      if (p < 16) {
        // the AFV 4x4: block[p] = sum_i cc[i] basis[i][p], cc = c[0::2, 0::2]
        const float dc = (b00 + b10 + b01) * 4.0f;
        const float* basis = cs + kAfvOff;
        for (int i = 0; i < 16; ++i) {
          const float v = i == 0 ? dc : at(c, 2 * (i >> 2), 2 * (i & 3));
          acc = fmaf(v, basis[i * 16 + p], acc);
        }
      } else if (p < 32) {
        // the DCT4x4 on c[0::2, 1::2]: m[x][k] = sum_j A4[x][j] cd[j][k]
        const int x = (p >> 2) & 3, k = p & 3;
        const float dc = b00 + b10 - b01;
        for (int jj = 0; jj < 4; ++jj) {
          const float b = (jj == 0 && k == 0) ? dc : at(c, 2 * jj, 2 * k + 1);
          acc = fmaf(A4[x * 4 + jj], b, acc);
        }
      } else {
        // the DCT4x8 on c[1::2, :]: s1[x][v] = sum_u A8[x][u] ce[v][u]
        const int e = p - 32, x = e >> 2, v = e & 3;
        const float dc = b00 - b10;
        for (int u = 0; u < 8; ++u) {
          const float b = (u == 0 && v == 0) ? dc : at(c, 2 * v + 1, u);
          acc = fmaf(A8[x * 8 + u], b, acc);
        }
      }
    }
    tmp[j] = acc;
  }
}

// the last pass: pixel (y, x) of channel c from `in`
template <int T>
__device__ __forceinline__ float small_pixel(const float* c, int y, int x, const float* cs) {
  const float* A4 = cs + idct_off(4);
  const float* A8 = cs + idct_off(8);
  float acc = 0.f;
  if constexpr (T == kDct) {
    for (int v = 0; v < 8; ++v) acc = fmaf(A8[y * 8 + v], c[x * 8 + v], acc);
  } else if constexpr (T == kIdentity) {
    // Hornuss: quad (qy, qx), its centre from the quad's corner DC and the
    // sum of its 15 other samples c[qy + 2iy][qx + 2ix]
    const int qy = y >> 2, qx = x >> 2, iy = y & 3, ix = x & 3;
    const float dc = sum4(at(c, 0, 0), at(c, 0, 1), at(c, 1, 0), at(c, 1, 1), qy * 2 + qx);
    float rs = at(c, qy, qx + 2);
    for (int k = 2; k < 16; ++k) rs = rs + at(c, qy + 2 * (k >> 2), qx + 2 * (k & 3));
    const float center = dc - rs * 0.0625f;
    if (iy == 1 && ix == 1) return center;
    if (iy == 0 && ix == 0) return at(c, qy + 2, qx + 2) + center;
    return at(c, qy + 2 * iy, qx + 2 * ix) + center;
  } else if constexpr (T == kDct2x2) {
    // _idct2_top_block(8) after (2) and (4)
    const int i = y >> 1, j = x >> 1;
    return sum4(at(c, i, j), at(c, i, 4 + j), at(c, 4 + i, j), at(c, 4 + i, 4 + j),
                ((y & 1) << 1) | (x & 1));
  } else if constexpr (T == kDct4x4) {
    // out[qy*4 + y'][qx*4 + x'] = sum_k A4[y'][k] m_q[x'][k]
    const int q = (y >> 2) * 2 + (x >> 2), yy = y & 3, xx = x & 3;
    for (int k = 0; k < 4; ++k) acc = fmaf(A4[yy * 4 + k], c[q * 16 + xx * 4 + k], acc);
  } else if constexpr (T == kDct8x4) {
    // columns kk*4..: out[y][x'] = sum_v A8[y][v] s1[x'][v]
    const int kk = x >> 2, xx = x & 3;
    for (int v = 0; v < 8; ++v) acc = fmaf(A8[y * 8 + v], c[kk * 32 + xx * 8 + v], acc);
  } else if constexpr (T == kDct4x8) {
    // rows kk*4..: out[y'][x] = sum_v A4[y'][v] s1[x][v]
    const int kk = y >> 2, yy = y & 3;
    for (int v = 0; v < 4; ++v) acc = fmaf(A4[yy * 4 + v], c[kk * 32 + x * 4 + v], acc);
  } else {  // AFV0-3
    constexpr int afv_x = (T - kAfv0) & 1, afv_y = (T - kAfv0) >> 1;
    const int yy = y & 3, xx = x & 3;
    if ((y >> 2) != afv_y) {
      // the DCT4x8's rows
      for (int v = 0; v < 4; ++v) acc = fmaf(A4[yy * 4 + v], c[32 + x * 4 + v], acc);
    } else if ((x >> 2) == afv_x) {
      // the AFV 4x4, flipped toward the block's corner
      return c[(afv_y ? 3 - yy : yy) * 4 + (afv_x ? 3 - xx : xx)];
    } else {
      for (int k = 0; k < 4; ++k) acc = fmaf(A4[yy * 4 + k], c[16 + xx * 4 + k], acc);
    }
  }
  return acc;
}

template <int T>
__device__ void small_block(const Args& a, int b, int lane, float* in, float* tmp) {
  const Col col = column(a, b);
  const Factors f = factors(a, b, col.lf, col.tile);
  const float* mats = a.mats + b * a.mats_block;
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int c = m >> 1, i = 32 * (m & 1) + lane;
    const int j = 64 * c + i;
    // the DC is the LF sample
    in[j] = i == 0 ? a.lf[c * a.lf_plane + col.lf] : coeff(a, f, col.base, mats, 64, c, i);
  }
  __syncwarp();
  const float* cs = a.consts;
  const float* last = in;
  if constexpr (T == kDct2x2) {
    small_pass1<T>(in, tmp, cs, lane);  // _idct2_top_block(2)
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 6; ++m) {  // _idct2_top_block(4)
      const float* c = tmp + 64 * (m >> 1);
      const int j = 32 * m + lane, p = 32 * (m & 1) + lane, y = p >> 3, x = p & 7;
      in[j] = (y < 4 && x < 4) ? sum4(at(c, y >> 1, x >> 1), at(c, y >> 1, 2 + (x >> 1)),
                                      at(c, 2 + (y >> 1), x >> 1),
                                      at(c, 2 + (y >> 1), 2 + (x >> 1)),
                                      ((y & 1) << 1) | (x & 1))
                               : c[p];
    }
    __syncwarp();
  } else if constexpr (T != kIdentity) {
    small_pass1<T>(in, tmp, cs, lane);
    __syncwarp();
    last = tmp;
  }
  float* out = a.planes + col.pix;
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int c = m >> 1, p = 32 * (m & 1) + lane, y = p >> 3, x = p & 7;
    out[c * a.plane + (long long)y * a.W + x] = small_pixel<T>(last + c * 64, y, x, cs);
  }
}

// ---- DCT16 and larger: one CTA a (block, channel) -----------------------

template <int T>
struct Large {
  static constexpr int CX = cover_x(T), CY = cover_y(T);
  static constexpr int ROWS = 8 * CY, COLS = 8 * CX, NC = ROWS * COLS;
  static constexpr bool WIDE = ROWS < COLS;  // storage (ROWS, COLS), else transposed
  static constexpr int LR = CY < CX ? CY : CX, LC = CY < CX ? CX : CY;  // LF block in storage
  static constexpr int V = ROWS < kChunk / COLS ? ROWS : kChunk / COLS;  // rows a chunk
  static constexpr bool S_SHARED = NC <= 32768;
  static constexpr int SMEM_FLOATS = 3 * CX * CY + COLS * V + (S_SHARED ? NC : 0);
};

template <int T>
__device__ void large_block(const Args& a, int b, int c) {
  using L = Large<T>;
  constexpr int ROWS = L::ROWS, COLS = L::COLS, NC = L::NC, CX = L::CX, CY = L::CY;
  constexpr int V = L::V, LC = L::LC, LR = L::LR;
  extern __shared__ float sm[];
  float* lft = sm;           // the LF tile (CY, CX)
  float* d1 = lft + CX * CY;  // D(CY) @ tile
  float* lfc = d1 + CX * CY;  // the reinterpreting DCT (LR, LC)
  float* tc = lfc + CX * CY;  // a chunk of coefficients, (COLS, V)
  float* S = tc + COLS * V;   // the first pass, (ROWS, COLS), when it fits
  const int tid = threadIdx.x;
  const Col col = column(a, b);
  const Factors f = factors(a, b, col.lf, col.tile);
  const float* mats = a.mats + b * a.mats_block;
  const float* cs = a.consts;

  // reinterpreting DCT of the LF tile (transforms_batch.py:
  // reinterpreting_dct_batch): e[i][j] = sum_x (sum_y D_a[i][y] lf[y][x]) D_b[j][x]
  for (int e = tid; e < CY * CX; e += kLargeThreads)
    lft[e] = a.lf[c * a.lf_plane + col.lf + (e / CX) * a.lf_stride + e % CX];
  __syncthreads();
  const float* Da = cs + kDctOff + idct_off(CY);
  const float* Db = cs + kDctOff + idct_off(CX);
  for (int e = tid; e < CY * CX; e += kLargeThreads) {
    const int i = e / CX, x = e % CX;
    float acc = 0.f;
    for (int y = 0; y < CY; ++y) acc = fmaf(Da[i * CY + y], lft[y * CX + x], acc);
    d1[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < CY * CX; e += kLargeThreads) {
    const int i = e / CX, j = e % CX;
    float acc = 0.f;
    for (int x = 0; x < CX; ++x) acc = fmaf(d1[i * CX + x], Db[j * CX + x], acc);
    const float v = acc / (cs[scales_off(CY) + i] * cs[scales_off(CX) + j]);
    if (CY < CX) {
      lfc[i * LC + j] = v;
    } else {
      lfc[j * LC + i] = v;
    }
  }
  __syncthreads();

  // first pass, a chunk of V frequency rows at a time: s1[x][v] = sum_u
  // A_cols[x][u] t[u][v] (idct2d_batch), kept as S[v][x]; A_cols[x][u] is
  // DCT(COLS)[u][x]
  const float* Dc = cs + kDctOff + idct_off(COLS);
  float* out = a.planes + c * a.plane + col.pix;
  for (int v0 = 0; v0 < ROWS; v0 += V) {
    for (int e = tid; e < COLS * V; e += kLargeThreads) {
      int u, vv;
      if (L::WIDE) {
        vv = e / COLS;
        u = e % COLS;
      } else {
        u = e / V;
        vv = e % V;
      }
      const int v = v0 + vv;
      const int r = L::WIDE ? v : u, q = L::WIDE ? u : v;  // storage row, column
      tc[u * V + vv] = (r < LR && q < LC) ? lfc[r * LC + q]
                                          : coeff(a, f, col.base, mats, NC, c,
                                                  r * (L::WIDE ? COLS : ROWS) + q);
    }
    __syncthreads();
    for (int e = tid; e < COLS * V; e += kLargeThreads) {
      const int vv = e / COLS, x = e % COLS;
      float acc = 0.f;
      for (int u = 0; u < COLS; ++u) acc = fmaf(Dc[u * COLS + x], tc[u * V + vv], acc);
      if constexpr (L::S_SHARED) {
        S[(v0 + vv) * COLS + x] = acc;
      } else {
        out[(long long)(v0 + vv) * a.W + x] = acc;
      }
    }
    __syncthreads();
  }

  // second pass: out[y][x] = sum_v A_rows[y][v] s1[x][v]
  const float* Ar = cs + idct_off(ROWS);
  if constexpr (L::S_SHARED) {
    for (int e = tid; e < NC; e += kLargeThreads) {
      const int y = e / COLS, x = e % COLS;
      float acc = 0.f;
      for (int v = 0; v < ROWS; ++v) acc = fmaf(Ar[y * ROWS + v], S[v * COLS + x], acc);
      out[(long long)y * a.W + x] = acc;
    }
  } else {
    // s1 is in the block's region: a chunk of X columns into shared
    // memory, then the same columns rewritten
    constexpr int X = kChunk / ROWS;
    for (int x0 = 0; x0 < COLS; x0 += X) {
      for (int e = tid; e < ROWS * X; e += kLargeThreads)
        tc[e] = out[(long long)(e / X) * a.W + x0 + e % X];
      __syncthreads();
      for (int e = tid; e < ROWS * X; e += kLargeThreads) {
        const int y = e / X, xx = e % X;
        float acc = 0.f;
        for (int v = 0; v < ROWS; ++v) acc = fmaf(Ar[y * ROWS + v], tc[v * X + xx], acc);
        out[(long long)y * a.W + x0 + xx] = acc;
      }
      __syncthreads();
    }
  }
}

template <int T>
__global__ void __launch_bounds__(256) vardct_blocks_kernel(Args a) {
  if constexpr (is_small(T)) {
    __shared__ float sh[kSmallWarps][2][192];
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * kSmallWarps + warp;
    if (b >= a.n) return;  // a whole warp; the warps share no barrier
    small_block<T>(a, b, threadIdx.x & 31, sh[warp][0], sh[warp][1]);
  } else {
    large_block<T>(a, blockIdx.x, blockIdx.y);
  }
}

template <int T>
int launch(const Args& a, cudaStream_t stream) {
  if constexpr (is_small(T)) {
    const unsigned grid = (unsigned)((a.n + kSmallWarps - 1) / kSmallWarps);
    vardct_blocks_kernel<T><<<grid, 32 * kSmallWarps, 0, stream>>>(a);
  } else {
    constexpr int smem = Large<T>::SMEM_FLOATS * 4;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          vardct_blocks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    vardct_blocks_kernel<T><<<dim3((unsigned)a.n, 3), kLargeThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vardct_blocks_launch(int t, int n, const void* flat, const void* cols,
                                    const void* lf, long long lf_plane, int lf_stride,
                                    const void* rq, const void* ytox, const void* ytob,
                                    const void* k, int k_row, int k_block, const void* bias,
                                    const void* mats, long long mats_block, void* planes,
                                    long long plane, int W, const void* consts, void* stream) {
  if (n <= 0) return 0;
  const Args a{static_cast<const int32_t*>(flat), static_cast<const longlong2*>(cols),
               static_cast<const float*>(lf), lf_plane, lf_stride,
               static_cast<const int32_t*>(rq), static_cast<const float*>(ytox),
               static_cast<const float*>(ytob), static_cast<const float*>(k), k_row, k_block,
               static_cast<const float*>(bias), static_cast<const float*>(mats), mats_block,
               static_cast<float*>(planes), plane, W, static_cast<const float*>(consts), n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t) {
#define K5_CASE(T) \
  case T:          \
    return launch<T>(a, s);
    K5_CASE(0) K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4) K5_CASE(5) K5_CASE(6) K5_CASE(7)
    K5_CASE(8) K5_CASE(9) K5_CASE(10) K5_CASE(11) K5_CASE(12) K5_CASE(13) K5_CASE(14)
    K5_CASE(15) K5_CASE(16) K5_CASE(17) K5_CASE(18) K5_CASE(19) K5_CASE(20) K5_CASE(21)
    K5_CASE(22) K5_CASE(23) K5_CASE(24) K5_CASE(25) K5_CASE(26)
#undef K5_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vardct_blocks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
