// Tile geometry of K1 (csrc/epf_gab.cu) and shared-memory layouts of K2
// and K3 (csrc/ans_lanes.cu): the one definition of each. The kernels
// compile it in; the host library compiles it too
// (native/kernel_geometry.cc) and exports it to Python, where
// ops/epf_gab.py:epf_gab_plan, ops/ans_lanes.py:k2_plan and
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

namespace k2 {

// The table expanded to one 16-byte slot a 12-bit state: (16 offset,
// 16 dist, offset, dist), uint32 each, so that one load and two
// multiply-adds give the next state and the byte offset of its slot; the
// symbols beside them; then one stream ring a warp.
constexpr int kSlots = 4096;
constexpr int kSlotBytes = 16;
constexpr unsigned kSlotMask = (kSlots - 1) * kSlotBytes;  // a slot's byte offset
constexpr int kOffSym = kSlots * kSlotBytes;
constexpr int kOffRings = kOffSym + kSlots * 4;
constexpr int kChunk = 32;  // steps between a warp's token stores, one a lane
// A ring holds a power of two of 32-bit words and is restaged only
// between chunks, so its half must exceed the kChunk / 2 + 1 words a
// chunk's steps read past the cursor's word (they take at most kChunk
// halfwords and load two ahead).
constexpr int kMinRingWords = 64;
constexpr int kMaxRingWords = 1024;  // 4 KB a stream
constexpr int kMaxWarps = 32;        // streams a block
// threads a block, whatever its streams: all of them build the table and
// stage the rings, then the warps without a stream exit
constexpr int kThreads = 32 * kMaxWarps;

struct Plan {
  int warps, ring_words;
  long long smem;
};

JXL_HD constexpr Plan plan_of(int warps, int ring_words) {
  return Plan{warps, ring_words, kOffRings + 4LL * static_cast<long long>(warps) * ring_words};
}

// The 32-bit words of a stream of L >= 1 bytes whose bits T steps can
// take: bytes [0, 4 + 2T), and a cursor past the row reads word
// ceil(L / 4), every byte of which is the row's last, so no later word.
JXL_HD constexpr long long words_read(long long T, long long L) {
  const long long by_steps = (2 * T + 7) / 4, by_row = (L + 3) / 4 + 1;
  return by_steps < by_row ? by_steps : by_row;
}

// S streams of L bytes, T steps each, on a card of `sms` SMs: the streams
// spread over every SM before a block takes a second one, and a ring holds
// every word the steps read, up to its cap (past it, it is restaged).
JXL_HD constexpr Plan plan(long long S, long long T, long long L, int sms) {
  const long long per_sm = sms > 0 ? (S + sms - 1) / sms : 1;
  const int warps = per_sm < 1 ? 1 : (per_sm > kMaxWarps ? kMaxWarps : static_cast<int>(per_sm));
  const long long words = words_read(T, L);
  int ring = kMinRingWords;
  while (ring < kMaxRingWords && ring < words) ring *= 2;
  return plan_of(warps, ring);
}

}  // namespace k2
