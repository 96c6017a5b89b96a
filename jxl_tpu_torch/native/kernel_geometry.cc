// The kernels' geometry (csrc/kernel_geometry.h) for Python: K1's tile per
// stage set, K2's launch plan and K3's shared-memory layout, from the same
// definitions the kernels compile in.

#include "../csrc/kernel_geometry.h"

extern "C" {

// out: halo, halo_x, rows, cols, planes, smem bytes
void jxl_k1_geometry(int use_gab, int epf_iters, long long* out) {
  const k1::Geometry g = k1::geometry(use_gab != 0, epf_iters);
  out[0] = g.halo;
  out[1] = g.halo_x;
  out[2] = g.rows;
  out[3] = g.cols;
  out[4] = g.planes;
  out[5] = g.smem;
}

// out: offsets of the nonzeros map, LUTs, item ring, stream ring, context
// slice, HybridUint configs, tables and the end (the total); then the
// stream ring half in words, the item ring half in items, the bytes of an
// item slot and of a context entry
void jxl_k3_layout(int tab_shared, int C, int NB, int ctx_slice, long long* out) {
  const k3::Layout l = k3::layout(tab_shared != 0, C, NB, ctx_slice);
  const long long v[12] = {k3::kOffNz, k3::kOffLut,   k3::kOffItems,     k3::kOffRing,
                           k3::kOffCtx, l.cfg,        l.tab,             l.total,
                           k3::kRingHalf, k3::kItemHalf, k3::kItemSlot * 4, k3::kCtxEntryBytes};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
}

// out: warps (streams) a block, threads a block, ring words a stream,
// shared bytes a block, the table's bytes (the rings' offset) and the
// steps between token stores
void jxl_k2_plan(long long S, long long T, long long L, int sms, long long* out) {
  const k2::Plan p = k2::plan(S, T, L, sms);
  const long long v[6] = {p.warps, k2::kThreads, p.ring_words, p.smem, k2::kOffRings, k2::kChunk};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // extern "C"
