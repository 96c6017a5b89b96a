// Restoration-filter chain (gaborish + EPF steps 0/1/2) on (3, H, W) float32
// planes with a per-pixel 1/sigma map, as one kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel jxl_tpu/ops/pallas_epf.py:epf_gab_pallas (its
// pl.pallas_call at :191). Computes what that kernel and the stage math of
// jxl_tpu/render/stages/core.py compute, in the same floating-point
// operation order (build with --fmad=false so no a*b+c is contracted).
//
// Bound on an H100: memory. Each pixel must be read once (3 planes +
// 1/sigma = 16 B) and written once (12 B): 28 B/px, about 69 us for a
// 3840x2160 frame at 3.35 TB/s. Gaborish + EPF1 + EPF2 are a few hundred
// fp32 operations a pixel, below that time at 67 TFLOP/s; with EPF0 too
// (epf_iters 3) the operations bound instead.
//
// Design: one block per TH x TW output tile. The block loads its tile and
// a 7-pixel halo (gaborish 1 + EPF0 3 + EPF1 2 + EPF2 1) of all three
// planes and of 1/sigma into shared memory once, then runs every stage
// there, ping-ponging between two plane buffers; each stage shrinks the
// valid ring around the tile by its border. The stage math mirrors the
// image at its edge before every stage (numpy mode="symmetric"), so in a
// tile whose halo crosses the image edge the out-of-image cells are
// refilled from their mirror sources after each stage instead of being
// computed. The 8x8-block border test of EPF's sigma multiplier uses
// absolute image coordinates; H and W need not be multiples of 8 or of the
// tile.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;             // output tile rows
constexpr int TW = 64;             // output tile columns
constexpr int R = 7;               // halo
constexpr int SH = TH + 2 * R;     // shared tile rows
constexpr int SW = TW + 2 * R;     // shared tile columns
constexpr int PLANE = SH * SW;     // floats per shared plane
constexpr int NT = 256;            // threads per block
constexpr size_t SMEM_BYTES = 7 * PLANE * sizeof(float);  // 2 x 3 planes + 1/sigma
constexpr float MIN_SIGMA = -3.90524291751269967465540850526868f;

struct Params {
  float gab[3][3];  // per channel: center, side, corner weight
  float sm[3];      // per EPF step: sigma multiplier inside an 8x8 block
  float bsm[3];     // per EPF step: sigma multiplier on a block border
  float cs[3];      // per channel SAD scale
  int use_gab;
  int epf_iters;
};

// numpy mode="symmetric": the edge sample repeats, period 2n
__device__ __forceinline__ int mirror(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m >= n ? p - 1 - m : m;
}

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// neighbor offsets, in the order of core.py's _EPF0_NEIGHBORS/_EPF1_NEIGHBORS
__constant__ int kEpf0Y[12] = {-2, -1, -1, -1, 0, 0, 0, 0, 1, 1, 1, 2};
__constant__ int kEpf0X[12] = {0, -1, 0, 1, -2, -1, 1, 2, -1, 0, 1, 0};
__constant__ int kEpf1Y[4] = {-1, 0, 0, 1};
__constant__ int kEpf1X[4] = {0, -1, 1, 0};
// SAD pattern: plus-5 for steps 0 and 1, the center alone for step 2
__constant__ int kPlusY[5] = {0, -1, 1, 0, 0};
__constant__ int kPlusX[5] = {0, 0, 0, -1, 1};

// offset in a shared plane of neighbor k of EPF step STEP
template <int STEP>
__device__ __forceinline__ int neighbor_offset(int k) {
  if constexpr (STEP == 0) {
    return kEpf0Y[k] * SW + kEpf0X[k];
  } else {
    return kEpf1Y[k] * SW + kEpf1X[k];
  }
}

// Gaborish on the ring of width r_out around the tile (in-image cells).
__device__ __forceinline__ void gaborish_step(const float* __restrict__ src, float* __restrict__ dst,
                              int r_out, int oy, int ox, int H, int W,
                              const Params& prm) {
  const int r0 = R - r_out;
  const int cols = TW + 2 * r_out;
  const int n = (TH + 2 * r_out) * cols;
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const int i = r0 + idx / cols;
    const int j = r0 + idx % cols;
    if (!inside(oy + i, ox + j, H, W)) continue;
    const int cell = i * SW + j;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* p = src + c * PLANE;
      const float side = p[cell - SW] + p[cell + SW] + p[cell - 1] + p[cell + 1];
      const float corner =
          p[cell - SW - 1] + p[cell - SW + 1] + p[cell + SW - 1] + p[cell + SW + 1];
      dst[c * PLANE + cell] =
          p[cell] * prm.gab[c][0] + side * prm.gab[c][1] + corner * prm.gab[c][2];
    }
  }
}

// EPF iteration STEP on the ring of width r_out around the tile.
template <int STEP>
__device__ __forceinline__ void epf_step(const float* __restrict__ src, float* __restrict__ dst,
                         const float* __restrict__ sig, int r_out, int oy, int ox,
                         int H, int W, const Params& prm) {
  constexpr int NN = STEP == 0 ? 12 : 4;
  constexpr int NP = STEP == 2 ? 1 : 5;
  int noffs[NN];
#pragma unroll
  for (int k = 0; k < NN; ++k) noffs[k] = neighbor_offset<STEP>(k);
  const float sm = prm.sm[STEP];
  const float bsm = prm.bsm[STEP];
  const int r0 = R - r_out;
  const int cols = TW + 2 * r_out;
  const int n = (TH + 2 * r_out) * cols;
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const int i = r0 + idx / cols;
    const int j = r0 + idx % cols;
    const int gy = oy + i, gx = ox + j;
    if (!inside(gy, gx, H, W)) continue;
    const int cell = i * SW + j;
    const float sp = sig[cell];
    const int by = gy & 7, bx = gx & 7;
    const bool on_border = by == 0 || by == 7 || bx == 0 || bx == 7;
    const float inv_sigma = sp * (on_border ? bsm : sm);
    float wts[NN];
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < NN; ++k) {
      const int noff = noffs[k];
      float sad = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* p = src + c * PLANE;
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const int a = cell + kPlusY[q] * SW + kPlusX[q];
          const float d = fabsf(p[a] - p[a + noff]);
          s = q == 0 ? d : s + d;
        }
        const float term = s * prm.cs[c];
        sad = c == 0 ? term : sad + term;
      }
      const float wv = fmaxf(sad * inv_sigma + 1.0f, 0.0f);
      wts[k] = wv;
      total = k == 0 ? wv : total + wv;
    }
    const float wsum = total + 1.0f;
    const bool passthrough = sp < MIN_SIGMA;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* p = src + c * PLANE;
      const float center = p[cell];
      float acc = center;
#pragma unroll
      for (int k = 0; k < NN; ++k) acc = acc + wts[k] * p[cell + noffs[k]];
      dst[c * PLANE + cell] = passthrough ? center : acc / wsum;
    }
  }
}

// Refill the out-of-image cells of the ring of width r with their mirror
// sources. A cell at most r pixels from the image, the farthest any later
// stage reads, has its source inside the image and inside the same ring. A
// cell farther out (the image ends inside the tile) may have its source
// outside the shared tile; no later stage reads it, so it is left as it is.
__device__ __forceinline__ void remirror(float* buf, int r, int oy, int ox, int H, int W) {
  const int r0 = R - r;
  const int rows = TH + 2 * r;
  const int cols = TW + 2 * r;
  const int n = rows * cols;
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const int i = r0 + idx / cols;
    const int j = r0 + idx % cols;
    const int gy = oy + i, gx = ox + j;
    if (inside(gy, gx, H, W)) continue;
    const int si = mirror(gy, H) - oy;
    const int sj = mirror(gx, W) - ox;
    if (si < r0 || si >= r0 + rows || sj < r0 || sj >= r0 + cols) continue;
    const int src = si * SW + sj;
    const int cell = i * SW + j;
#pragma unroll
    for (int c = 0; c < 3; ++c) buf[c * PLANE + cell] = buf[c * PLANE + src];
  }
}

__global__ void __launch_bounds__(NT)
epf_gab_kernel(const float* __restrict__ in, const float* __restrict__ sigma,
               float* __restrict__ out, int H, int W, Params prm) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + 3 * PLANE;
  float* sig = smem + 6 * PLANE;
  const int oy = blockIdx.y * TH - R;  // image row of shared row 0
  const int ox = blockIdx.x * TW - R;  // image column of shared column 0
  const size_t plane = (size_t)H * W;
  const bool edge = oy < 0 || ox < 0 || oy + SH > H || ox + SW > W;

  // one read of every input pixel the tile needs, halo pre-mirrored
  for (int idx = threadIdx.x; idx < PLANE; idx += NT) {
    const int i = idx / SW;
    const int j = idx - i * SW;
    const size_t g = (size_t)mirror(oy + i, H) * W + mirror(ox + j, W);
    cur[idx] = in[g];
    cur[PLANE + idx] = in[plane + g];
    cur[2 * PLANE + idx] = in[2 * plane + g];
    sig[idx] = sigma[g];
  }
  __syncthreads();

  int ring = R;
  auto advance = [&](int border) {
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    ring -= border;
    if (edge) {
      remirror(cur, ring, oy, ox, H, W);
      __syncthreads();
    }
  };
  if (prm.use_gab) {
    gaborish_step(cur, nxt, ring - 1, oy, ox, H, W, prm);
    advance(1);
  }
  if (prm.epf_iters >= 3) {
    epf_step<0>(cur, nxt, sig, ring - 3, oy, ox, H, W, prm);
    advance(3);
  }
  if (prm.epf_iters >= 1) {
    epf_step<1>(cur, nxt, sig, ring - 2, oy, ox, H, W, prm);
    advance(2);
  }
  if (prm.epf_iters >= 2) {
    epf_step<2>(cur, nxt, sig, ring - 1, oy, ox, H, W, prm);
    advance(1);
  }

  // one write of every output pixel of the tile
  for (int idx = threadIdx.x; idx < TH * TW; idx += NT) {
    const int i = R + idx / TW;
    const int j = R + idx % TW;
    const int gy = oy + i, gx = ox + j;
    if (!inside(gy, gx, H, W)) continue;
    const size_t g = (size_t)gy * W + gx;
    const int cell = i * SW + j;
    out[g] = cur[cell];
    out[plane + g] = cur[PLANE + cell];
    out[2 * plane + g] = cur[2 * PLANE + cell];
  }
}

}  // namespace

// params: gab[3][3], sm[3], bsm[3], cs[3] as 18 floats (host memory).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int epf_gab_launch(const float* in, const float* sigma, float* out,
                              int H, int W, const float* params, int use_gab,
                              int epf_iters, void* stream) {
  Params prm;
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < 3; ++k) prm.gab[c][k] = params[3 * c + k];
  for (int s = 0; s < 3; ++s) {
    prm.sm[s] = params[9 + s];
    prm.bsm[s] = params[12 + s];
    prm.cs[s] = params[15 + s];
  }
  prm.use_gab = use_gab;
  prm.epf_iters = epf_iters;
  cudaError_t e = cudaFuncSetAttribute(
      epf_gab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  epf_gab_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(in, sigma, out, H, W, prm);
  return (int)cudaGetLastError();
}

extern "C" const char* epf_gab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
