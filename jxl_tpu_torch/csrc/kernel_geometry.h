// Tile geometry of K1 (csrc/epf_gab.cu) and shared-memory layout of K3
// (csrc/ans_lanes.cu): the one definition of both. The kernels compile it
// in; the host library compiles it too (native/kernel_geometry.cc) and
// exports it to Python, where ops/epf_gab.py:epf_gab_plan and
// ops/device_ac.py:ac_smem_plan read it. Plain C++17, no CUDA headers.

#pragma once

#ifdef __CUDACC__
#define JXL_HD __host__ __device__
#else
#define JXL_HD
#endif

namespace k1 {

constexpr int kTileRows = 32;  // output rows of one block
constexpr int kTileCols = 64;  // output columns of one block

struct Geometry {
  int halo;         // rows of halo: the sum of the borders of the stages that run
  int halo_x;       // columns of halo: halo rounded up to 4, so tiles start 16-byte aligned
  int rows, cols;   // the shared tile: the output tile and its halo
  int planes;       // shared planes: 3 image planes; with EPF also 1/sigma and two SAD planes
  long long smem;   // bytes of shared memory a block
};

// the stages' borders: gaborish 1, EPF step 0 3, step 1 2, step 2 1
JXL_HD constexpr Geometry geometry(bool gab, int epf_iters) {
  const int r = (gab ? 1 : 0) + (epf_iters >= 3 ? 3 : 0) + (epf_iters >= 1 ? 2 : 0) +
                (epf_iters >= 2 ? 1 : 0);
  const int rx = (r + 3) / 4 * 4;
  const int rows = kTileRows + 2 * r, cols = kTileCols + 2 * rx;
  const int planes = r == 0 ? 0 : (epf_iters > 0 ? 6 : 3);
  return Geometry{r, rx, rows, cols, planes, static_cast<long long>(planes) * rows * cols * 4};
}

}  // namespace k1

namespace k3 {

constexpr int kGroupDimBlocks = 32;
constexpr int kNzArea = kGroupDimBlocks * kGroupDimBlocks;
constexpr int kRingHalf = 1024;  // stream ring half, 32-bit words (4 KB)
constexpr int kItemHalf = 64;    // item ring half, items
constexpr int kItemSlot = 16;    // ints an item takes in the ring (64 bytes)
constexpr int kCtxEntryBytes = 2;  // a cluster id in the staged context slice

// The fixed regions, at constant offsets: the 3x32x32 nonzeros map, the
// two 64-entry zero-density LUTs, the item ring, the stream ring; then the
// lane's context slice.
constexpr int kOffNz = 0;
constexpr int kOffLut = kOffNz + 3 * kNzArea * 4;
constexpr int kOffItems = kOffLut + 128 * 4;
constexpr int kOffRing = kOffItems + 2 * kItemHalf * kItemSlot * 4;
constexpr int kOffCtx = kOffRing + 2 * kRingHalf * 4;

JXL_HD constexpr long long align16(long long x) { return (x + 15) / 16 * 16; }

// After the context slice: the HybridUint configs, then (when shared) the
// packed tables; total is the block's dynamic shared memory.
struct Layout {
  long long cfg, tab, total;
};

JXL_HD constexpr Layout layout(bool tab_shared, int C, int NB, int ctx_slice) {
  const long long cfg = align16(kOffCtx + static_cast<long long>(ctx_slice) * kCtxEntryBytes);
  const long long tab = align16(cfg + static_cast<long long>(C) * 4);
  return Layout{cfg, tab, tab + (tab_shared ? static_cast<long long>(C) * NB * 8 : 0)};
}

}  // namespace k3
