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
// (epf_iters 3) the operations bound instead. In practice the kernel is
// bound by its shared-memory traffic and instruction issue, so the design
// cuts both:
//
// - Stage set at compile time. (use_gab, epf_iters) are template
//   parameters, one instantiation per combination, whose tile geometry is
//   csrc/kernel_geometry.h's (k1::geometry). The halo is the sum of
//   the borders of the stages that run (gaborish 1, EPF0 3, EPF1 2, EPF2 1:
//   4 on the main path, gaborish + EPF 2 steps), and each stage computes
//   exactly the ring around the tile that later stages read; the last
//   stage writes the tile straight to device memory.
// - Loads. One block per 32x64 output tile loads its tile and halo of the
//   three planes and 1/sigma into shared memory once. The horizontal halo
//   is rounded up to 4 so the tile origin is 16-byte aligned: a tile inside
//   the image's columns, of a 4-aligned width, loads rows (mirrored at the
//   top and bottom edge) with float4; only tiles across the left or right
//   edge take the per-cell mirror path. Main path: 40x72 cells for 32x64
//   pixels, 1.41x.
// - In-place stages. A stage keeps its results in registers, waits for the
//   block, and writes them over its input, so the block needs the three
//   planes, 1/sigma and two difference planes: 69 KB at halo 4, three
//   blocks (24 warps) an SM.
// - Shared differences. EPF1 and EPF2 weigh four neighbours (up, left,
//   right, down). The SAD of pixel a towards its right neighbour equals
//   that of a+1 towards its left one (|x-y| and |y-x| are the same float,
//   summed in the same order), and likewise down and up. So each step
//   first computes two planes, the channel-weighted SADs to the right and
//   downwards, and each pixel reads its four SADs from them. EPF0's twelve
//   neighbours are computed directly.
// - Runs down columns. A thread takes 4 vertically adjacent cells of a
//   column and keeps the rows they share in registers: gaborish loads one
//   new row of three a cell, the SAD planes one row of four and reuse the
//   differences above (an EPF1 pixel takes 18 differences where the direct
//   sum takes 60; EPF2 6 where it takes 12), the averages three cells.
// - No runtime division: every loop has compile-time bounds.
//
// The stage math mirrors the image at its edge before every stage (numpy
// mode="symmetric"), so in a tile whose halo crosses the image edge the
// out-of-image cells are refilled from their mirror sources after each
// stage instead of being computed. The 8x8-block border test of EPF's
// sigma multiplier uses absolute image coordinates; H and W need not be
// multiples of 8 or of the tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_geometry.h"

namespace {

constexpr int TH = k1::kTileRows;  // output tile rows
constexpr int TW = k1::kTileCols;  // output tile columns
constexpr int NT = 256;  // threads per block
constexpr int kRun = 4;   // cells a thread walks down a column in one run
constexpr float MIN_SIGMA = -3.90524291751269967465540850526868f;

struct Params {
  float gab[3][3];  // per channel: center, side, corner weight
  float sm[3];      // per EPF step: sigma multiplier inside an 8x8 block
  float bsm[3];     // per EPF step: sigma multiplier on a block border
  float cs[3];      // per channel SAD scale
};

// Tile geometry of one stage set (k1::geometry)
template <bool GAB, int ITERS>
struct Geo {
  static constexpr k1::Geometry kGeo = k1::geometry(GAB, ITERS);
  static constexpr int R = kGeo.halo;
  static constexpr int RX = kGeo.halo_x;  // horizontal halo, 16-byte aligned
  static constexpr int SH = kGeo.rows;
  static constexpr int SW = kGeo.cols;
  static constexpr int PLANE = SH * SW;
  // 3 planes; with EPF also 1/sigma and the right/down SAD planes
  static constexpr int NPLANES = kGeo.planes;
  static constexpr size_t SMEM = static_cast<size_t>(kGeo.smem);
  static_assert(SMEM == static_cast<size_t>(NPLANES) * PLANE * sizeof(float), "plane layout");
  // blocks an SM (228 KB of shared memory, 1 KB reserved a block), at most 3
  static constexpr int BLOCKS =
      SMEM == 0 ? 3 : (233472 / (SMEM + 1024) >= 3 ? 3 : (233472 / (SMEM + 1024) >= 2 ? 2 : 1));
  // the ring each stage leaves valid around the tile
  static constexpr int RG = R - (GAB ? 1 : 0);
  static constexpr int R0 = RG - (ITERS >= 3 ? 3 : 0);
  static constexpr int R1 = R0 - (ITERS >= 1 ? 2 : 0);
  static constexpr int R2 = R1 - (ITERS >= 2 ? 1 : 0);
  static_assert(R2 == 0, "the last stage ends on the tile");
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

// f(u, i, j) for the cells (i, j) of the shared-tile rectangle [I0, I1) x
// [J0, J1), dealt to the block's threads; u is the thread's own index of
// the cell, a compile-time constant once the loop is unrolled
template <int I0, int I1, int J0, int J1, class F>
__device__ __forceinline__ void for_rect(F&& f) {
  constexpr int cols = J1 - J0;
  constexpr int n = (I1 - I0) * cols;
#pragma unroll
  for (int u = 0; u < (n + NT - 1) / NT; ++u) {
    const int idx = static_cast<int>(threadIdx.x) + u * NT;
    if (idx < n) f(u, I0 + idx / cols, J0 + idx % cols);
  }
}

// f(u, i0, j) for the runs of V vertically adjacent cells (i0 .. i0+V-1,
// clipped to I1) in each column j of the rectangle [I0, I1) x [J0, J1),
// dealt to the block's threads (neighbouring threads take neighbouring
// columns); u is the thread's own index of the run. A run walks down its
// column keeping the rows it shares with the next cell in registers.
template <int I0, int I1, int J0, int J1, int V, class F>
__device__ __forceinline__ void for_runs(F&& f) {
  constexpr int cols = J1 - J0;
  constexpr int n = (I1 - I0 + V - 1) / V * cols;
#pragma unroll
  for (int u = 0; u < (n + NT - 1) / NT; ++u) {
    const int idx = static_cast<int>(threadIdx.x) + u * NT;
    if (idx < n) f(u, I0 + idx / cols * V, J0 + idx % cols);
  }
}

// One stage on the ring of width r around the tile, in runs of V cells:
// run(i0, j, emit) computes the run's cells and calls emit(v, res) with
// the three channels of cell (i0 + v, j). The last stage (r == 0) writes
// its in-image cells to `out`; any other keeps them in registers until
// every thread has read its inputs, writes them over the planes, and
// refills the out-of-image cells from their mirror sources. A cell at
// most r pixels from the image, the farthest any later stage reads, has
// its source inside the image and inside the same ring. A cell farther out
// (the image ends inside the tile) may have its source outside the shared
// tile; no later stage reads it, so it is left. Cells outside the image
// are computed from whatever their ring holds and never stored.
template <class G, int r, int V, class Run>
__device__ __forceinline__ void run_stage(float* P, float* __restrict__ out, int oy, int ox,
                                          int H, int W, bool edge, Run&& run) {
  constexpr int I0 = G::R - r, I1 = G::R + TH + r, J0 = G::RX - r, J1 = G::RX + TW + r;
  constexpr int NU = ((I1 - I0 + V - 1) / V * (J1 - J0) + NT - 1) / NT;
  constexpr int SW = G::SW, PLANE = G::PLANE;
  if constexpr (r == 0) {
    const size_t plane = static_cast<size_t>(H) * W;
    for_runs<I0, I1, J0, J1, V>([&](int, int i0, int j) {
      run(i0, j, [&](int v, const float* res) {
        const int gy = oy + i0 + v, gx = ox + j;
        if (!inside(gy, gx, H, W)) return;
        const size_t g = static_cast<size_t>(gy) * W + gx;
        out[g] = res[0];
        out[plane + g] = res[1];
        out[2 * plane + g] = res[2];
      });
    });
  } else {
    float keep[NU][V][3];
    for_runs<I0, I1, J0, J1, V>([&](int u, int i0, int j) {
      run(i0, j, [&](int v, const float* res) {
#pragma unroll
        for (int c = 0; c < 3; ++c) keep[u][v][c] = res[c];
      });
    });
    __syncthreads();
    for_runs<I0, I1, J0, J1, V>([&](int u, int i0, int j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = i0 + v;
        if (i < I1 && inside(oy + i, ox + j, H, W)) {
          const int cell = i * SW + j;
          P[cell] = keep[u][v][0];
          P[PLANE + cell] = keep[u][v][1];
          P[2 * PLANE + cell] = keep[u][v][2];
        }
      }
    });
    __syncthreads();
    if (edge) {
      for_rect<I0, I1, J0, J1>([&](int, int i, int j) {
        const int gy = oy + i, gx = ox + j;
        if (inside(gy, gx, H, W)) return;
        const int si = mirror(gy, H) - oy;
        const int sj = mirror(gx, W) - ox;
        if (si < I0 || si >= I1 || sj < J0 || sj >= J1) return;
        const int src = si * SW + sj, cell = i * SW + j;
#pragma unroll
        for (int c = 0; c < 3; ++c) P[c * PLANE + cell] = P[c * PLANE + src];
      });
      __syncthreads();
    }
  }
}

// EPF's per-pixel sigma multiplier: 1/sigma times the step's multiplier
// inside an 8x8 block or on its border (absolute coordinates)
__device__ __forceinline__ float epf_inv_sigma(float sp, int gy, int gx, float sm, float bsm) {
  const int by = gy & 7, bx = gx & 7;
  const bool on_border = by == 0 || by == 7 || bx == 0 || bx == 7;
  return sp * (on_border ? bsm : sm);
}

// Gaborish on the ring r, in runs: rows i-1, i and i+1 of columns
// j-1..j+1 slide down the run, so a cell loads one new row of three
template <class G, int r>
__device__ __forceinline__ void gaborish(float* P, float* __restrict__ out, int oy, int ox, int H,
                                         int W, bool edge, const Params& prm) {
  constexpr int SW = G::SW, PLANE = G::PLANE, V = kRun, I1 = G::R + TH + r;
  run_stage<G, r, V>(P, out, oy, ox, H, W, edge, [&](int i0, int j, auto&& emit) {
    float up[3][3], mid[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        up[c][t] = P[c * PLANE + (i0 - 1) * SW + j - 1 + t];
        mid[c][t] = P[c * PLANE + i0 * SW + j - 1 + t];
      }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (i0 + v >= I1) break;
      const int below = (i0 + v + 1) * SW + j - 1;
      float res[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float dn[3];
#pragma unroll
        for (int t = 0; t < 3; ++t) dn[t] = P[c * PLANE + below + t];
        const float side = up[c][1] + dn[1] + mid[c][0] + mid[c][2];
        const float corner = up[c][0] + up[c][2] + dn[0] + dn[2];
        res[c] = mid[c][1] * prm.gab[c][0] + side * prm.gab[c][1] + corner * prm.gab[c][2];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          up[c][t] = mid[c][t];
          mid[c][t] = dn[t];
        }
      }
      emit(v, res);
    }
  });
}

// The SAD planes of EPF step 1 (NP = 5, the plus pattern) or 2 (NP = 1,
// the centre) on the ring r of the step's output, one row above and one
// column left included: SR[b] towards b's right neighbour, SD[b] towards
// b's lower one. Each is the sum over c of (the sum over the pattern q, in
// the order centre, up, down, left, right, of |p[b+q] - p[b+q+n]|) *
// cs[c]. In runs down a column: each cell loads one new row (columns
// j-1..j+2 for NP = 5) and reuses the differences of the rows above.
template <class G, int r, int NP>
__device__ __forceinline__ void sad_planes(const float* P, float* SR, float* SD,
                                           const Params& prm) {
  constexpr int SW = G::SW, PLANE = G::PLANE, V = kRun;
  constexpr int I0 = G::R - r - 1, I1 = G::R + TH + r;
  for_runs<I0, I1, G::RX - r - 1, G::RX + TW + r, V>([&](int, int i0, int j) {
    if constexpr (NP == 5) {
      // per channel: rows i and i+1 at columns j-1..j+2; the right
      // differences Dr and down differences Dd at (i-1, j) and (i, j)
      float wa[3][4], wb[3][4], dr_u[3], dr_c[3], dd_u[3], dd_c[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* p = P + c * PLANE;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          wa[c][t] = p[i0 * SW + j - 1 + t];
          wb[c][t] = p[(i0 + 1) * SW + j - 1 + t];
        }
        const float a0 = p[(i0 - 1) * SW + j], a1 = p[(i0 - 1) * SW + j + 1];
        dr_u[c] = fabsf(a0 - a1);
        dr_c[c] = fabsf(wa[c][1] - wa[c][2]);
        dd_u[c] = fabsf(a0 - wa[c][1]);
        dd_c[c] = fabsf(wa[c][1] - wb[c][1]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = i0 + v;
        if (i >= I1) break;
        float sr = 0.0f, sd = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float wc[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) wc[t] = P[c * PLANE + (i + 2) * SW + j - 1 + t];
          const float dr_n = fabsf(wb[c][1] - wb[c][2]);
          const float dd_n = fabsf(wb[c][1] - wc[1]);
          float s_r = dr_c[c];
          s_r = s_r + dr_u[c];
          s_r = s_r + dr_n;
          s_r = s_r + fabsf(wa[c][0] - wa[c][1]);
          s_r = s_r + fabsf(wa[c][2] - wa[c][3]);
          float s_d = dd_c[c];
          s_d = s_d + dd_u[c];
          s_d = s_d + dd_n;
          s_d = s_d + fabsf(wa[c][0] - wb[c][0]);
          s_d = s_d + fabsf(wa[c][2] - wb[c][2]);
          const float tr = s_r * prm.cs[c];
          const float td = s_d * prm.cs[c];
          sr = c == 0 ? tr : sr + tr;
          sd = c == 0 ? td : sd + td;
          dr_u[c] = dr_c[c];
          dr_c[c] = dr_n;
          dd_u[c] = dd_c[c];
          dd_c[c] = dd_n;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            wa[c][t] = wb[c][t];
            wb[c][t] = wc[t];
          }
        }
        SR[i * SW + j] = sr;
        SD[i * SW + j] = sd;
      }
    } else {
      float pc[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) pc[c] = P[c * PLANE + i0 * SW + j];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = i0 + v;
        if (i >= I1) break;
        float sr = 0.0f, sd = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float pr = P[c * PLANE + i * SW + j + 1];
          const float pd = P[c * PLANE + (i + 1) * SW + j];
          const float tr = fabsf(pc[c] - pr) * prm.cs[c];
          const float td = fabsf(pc[c] - pd) * prm.cs[c];
          sr = c == 0 ? tr : sr + tr;
          sd = c == 0 ? td : sd + td;
          pc[c] = pd;
        }
        SR[i * SW + j] = sr;
        SD[i * SW + j] = sd;
      }
    }
  });
}

// EPF step 1 or 2 on the ring r: the SAD planes, then each pixel's
// weighted average of itself and its four neighbours (up, left, right,
// down: core.py's _EPF1_NEIGHBORS order), in runs down a column
template <class G, int r, int STEP>
__device__ __forceinline__ void epf_shared_sad(float* P, const float* SIG, float* SR, float* SD,
                                               float* __restrict__ out, int oy, int ox, int H,
                                               int W, bool edge, const Params& prm) {
  constexpr int SW = G::SW, PLANE = G::PLANE, V = kRun, I1 = G::R + TH + r;
  sad_planes<G, r, STEP == 1 ? 5 : 1>(P, SR, SD, prm);
  __syncthreads();
  const float sm = prm.sm[STEP], bsm = prm.bsm[STEP];
  run_stage<G, r, V>(P, out, oy, ox, H, W, edge, [&](int i0, int j, auto&& emit) {
    float pu[3], pc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pu[c] = P[c * PLANE + (i0 - 1) * SW + j];
      pc[c] = P[c * PLANE + i0 * SW + j];
    }
    float sd_u = SD[(i0 - 1) * SW + j];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = i0 + v;
      if (i >= I1) break;
      const int cell = i * SW + j;
      const float sp = SIG[cell];
      const float inv_sigma = epf_inv_sigma(sp, oy + i, ox + j, sm, bsm);
      const float sd_c = SD[cell];
      const float w0 = fmaxf(sd_u * inv_sigma + 1.0f, 0.0f);
      const float w1 = fmaxf(SR[cell - 1] * inv_sigma + 1.0f, 0.0f);
      const float w2 = fmaxf(SR[cell] * inv_sigma + 1.0f, 0.0f);
      const float w3 = fmaxf(sd_c * inv_sigma + 1.0f, 0.0f);
      const float wsum = (((w0 + w1) + w2) + w3) + 1.0f;
      const bool passthrough = sp < MIN_SIGMA;
      float res[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* p = P + c * PLANE;
        const float pd = p[cell + SW];
        float acc = pc[c];
        acc = acc + w0 * pu[c];
        acc = acc + w1 * p[cell - 1];
        acc = acc + w2 * p[cell + 1];
        acc = acc + w3 * pd;
        res[c] = passthrough ? pc[c] : acc / wsum;
        pu[c] = pc[c];
        pc[c] = pd;
      }
      sd_u = sd_c;
      emit(v, res);
    }
  });
}

template <class G, int r>
__device__ __forceinline__ void epf0_direct(float* P, const float* SIG, float* __restrict__ out,
                                            int oy, int ox, int H, int W, bool edge,
                                            const Params& prm) {
  constexpr int SW = G::SW, PLANE = G::PLANE, V = kRun, I1 = G::R + TH + r;
  const float sm = prm.sm[0], bsm = prm.bsm[0];
  run_stage<G, r, V>(P, out, oy, ox, H, W, edge, [&](int i0, int j, auto&& emit) {
    // neighbour offsets, in the order of core.py's _EPF0_NEIGHBORS
    const int kEpf0Y[12] = {-2, -1, -1, -1, 0, 0, 0, 0, 1, 1, 1, 2};
    const int kEpf0X[12] = {0, -1, 0, 1, -2, -1, 1, 2, -1, 0, 1, 0};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = i0 + v;
      if (i >= I1) break;
      const int cell = i * SW + j;
      const float sp = SIG[cell];
      const float inv_sigma = epf_inv_sigma(sp, oy + i, ox + j, sm, bsm);
      float wts[12];
      float total = 0.0f;
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        const int noff = kEpf0Y[k] * SW + kEpf0X[k];
        float sad = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float* p = P + c * PLANE;
          float s = fabsf(p[cell] - p[cell + noff]);
          s = s + fabsf(p[cell - SW] - p[cell - SW + noff]);
          s = s + fabsf(p[cell + SW] - p[cell + SW + noff]);
          s = s + fabsf(p[cell - 1] - p[cell - 1 + noff]);
          s = s + fabsf(p[cell + 1] - p[cell + 1 + noff]);
          const float term = s * prm.cs[c];
          sad = c == 0 ? term : sad + term;
        }
        const float wv = fmaxf(sad * inv_sigma + 1.0f, 0.0f);
        wts[k] = wv;
        total = k == 0 ? wv : total + wv;
      }
      const float wsum = total + 1.0f;
      const bool passthrough = sp < MIN_SIGMA;
      float res[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* p = P + c * PLANE;
        const float center = p[cell];
        float acc = center;
#pragma unroll
        for (int k = 0; k < 12; ++k) acc = acc + wts[k] * p[cell + kEpf0Y[k] * SW + kEpf0X[k]];
        res[c] = passthrough ? center : acc / wsum;
      }
      emit(v, res);
    }
  });
}

template <bool GAB, int ITERS>
__global__ void __launch_bounds__(NT, Geo<GAB, ITERS>::BLOCKS)
epf_gab_kernel(const float* __restrict__ in, const float* __restrict__ sigma,
               float* __restrict__ out, int H, int W, Params prm) {
  using G = Geo<GAB, ITERS>;
  constexpr int R = G::R, RX = G::RX, SH = G::SH, SW = G::SW, PLANE = G::PLANE;
  const size_t plane = static_cast<size_t>(H) * W;
  const int oy = static_cast<int>(blockIdx.y) * TH - R;   // image row of shared row 0
  const int ox = static_cast<int>(blockIdx.x) * TW - RX;  // image column of shared column 0

  if constexpr (R == 0) {  // no stage: a copy
    for_rect<0, TH, 0, TW>([&](int, int i, int j) {
      if (!inside(oy + i, ox + j, H, W)) return;
      const size_t g = static_cast<size_t>(oy + i) * W + (ox + j);
      out[g] = in[g];
      out[plane + g] = in[plane + g];
      out[2 * plane + g] = in[2 * plane + g];
    });
  } else {
    extern __shared__ __align__(16) float smem[];
    float* P = smem;               // 3 planes, updated in place stage by stage
    float* SIG = smem + 3 * PLANE;  // 1/sigma (EPF only)
    float* SR = SIG + PLANE;        // SAD towards the right neighbour
    float* SD = SR + PLANE;         // SAD towards the lower neighbour
    constexpr bool kSigma = ITERS > 0;
    const bool edge = oy < 0 || ox < 0 || oy + SH > H || ox + SW > W;

    // one read of every input pixel the tile needs, halo pre-mirrored: a
    // tile inside the image's columns loads rows (mirrored at the top and
    // bottom edge) with 16-byte loads when the width allows
    const bool vec = ox >= 0 && ox + SW <= W && (W & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(in) & 15) == 0 &&
                     (!kSigma || (reinterpret_cast<uintptr_t>(sigma) & 15) == 0);
    if (vec) {
      constexpr int VW = SW / 4;
      for (int v = threadIdx.x; v < SH * VW; v += NT) {
        const int i = v / VW, j = (v % VW) * 4;
        const int gy = oy + i;
        const size_t g = static_cast<size_t>(gy >= 0 && gy < H ? gy : mirror(gy, H)) * W + (ox + j);
        const int cell = i * SW + j;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<float4*>(P + c * PLANE + cell) =
              __ldg(reinterpret_cast<const float4*>(in + c * plane + g));
        if (kSigma)
          *reinterpret_cast<float4*>(SIG + cell) =
              __ldg(reinterpret_cast<const float4*>(sigma + g));
      }
    } else {
      for (int idx = threadIdx.x; idx < PLANE; idx += NT) {
        const int i = idx / SW, j = idx % SW;
        const size_t g = static_cast<size_t>(mirror(oy + i, H)) * W + mirror(ox + j, W);
#pragma unroll
        for (int c = 0; c < 3; ++c) P[c * PLANE + idx] = in[c * plane + g];
        if (kSigma) SIG[idx] = sigma[g];
      }
    }
    __syncthreads();

    if constexpr (GAB) gaborish<G, G::RG>(P, out, oy, ox, H, W, edge, prm);
    if constexpr (ITERS >= 3) epf0_direct<G, G::R0>(P, SIG, out, oy, ox, H, W, edge, prm);
    if constexpr (ITERS >= 1)
      epf_shared_sad<G, G::R1, 1>(P, SIG, SR, SD, out, oy, ox, H, W, edge, prm);
    if constexpr (ITERS >= 2)
      epf_shared_sad<G, G::R2, 2>(P, SIG, SR, SD, out, oy, ox, H, W, edge, prm);
  }
}

template <bool GAB, int ITERS>
cudaError_t launch(const float* in, const float* sigma, float* out, int H, int W,
                   const Params& prm, cudaStream_t stream) {
  using G = Geo<GAB, ITERS>;
  auto kern = epf_gab_kernel<GAB, ITERS>;
  if (G::SMEM > 0) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::SMEM));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  kern<<<grid, NT, G::SMEM, stream>>>(in, sigma, out, H, W, prm);
  return cudaGetLastError();
}

}  // namespace

// params: gab[3][3], sm[3], bsm[3], cs[3] as 18 floats (host memory).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int epf_gab_launch(const float* in, const float* sigma, float* out, int H, int W,
                              const float* params, int use_gab, int epf_iters, void* stream) {
  Params prm;
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < 3; ++k) prm.gab[c][k] = params[3 * c + k];
  for (int s = 0; s < 3; ++s) {
    prm.sm[s] = params[9 + s];
    prm.bsm[s] = params[12 + s];
    prm.cs[s] = params[15 + s];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch ((use_gab ? 4 : 0) + epf_iters) {
    case 0: e = launch<false, 0>(in, sigma, out, H, W, prm, st); break;
    case 1: e = launch<false, 1>(in, sigma, out, H, W, prm, st); break;
    case 2: e = launch<false, 2>(in, sigma, out, H, W, prm, st); break;
    case 3: e = launch<false, 3>(in, sigma, out, H, W, prm, st); break;
    case 4: e = launch<true, 0>(in, sigma, out, H, W, prm, st); break;
    case 5: e = launch<true, 1>(in, sigma, out, H, W, prm, st); break;
    case 6: e = launch<true, 2>(in, sigma, out, H, W, prm, st); break;
    case 7: e = launch<true, 3>(in, sigma, out, H, W, prm, st); break;
    default: break;
  }
  return static_cast<int>(e);
}

extern "C" const char* epf_gab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
