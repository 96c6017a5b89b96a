// rANS lane decoders for Hopper (sm_90a): K2 and K3 of jxl_tpu_torch.
//
// K2 ans_decode_lanes replaces the TPU kernel
//   jxl_tpu/ops/pallas_ans.py:ans_decode_batch_pallas
// (T lockstep symbols from each of S rANS streams through one 12-bit alias
// table, 16-bit renormalisation). K3 ac_sections replaces the XLA lane
// decoder jxl_tpu/ops/device_ac.py:decode_ac_sections: the whole VarDCT AC
// token walk of every (group, pass) section (nonzeros prediction, context
// selection, rANS symbol, HybridUint tail bits, coefficient order and pass
// shift), storing each coefficient into the frame's dense buffer.
//
// Both do exact integer arithmetic: the state is a uint32 and every table
// value an integer (the TPU reference once lost renorm bits to bf16 matrix
// rounding, pallas_ans.py:19-23).
//
// What bounds them on an H100. Each lane is a serial chain: a symbol's
// table row depends on the state the previous symbol left, and in K3 the
// context of a token depends on the tokens before it (nonzeros left, the
// previous coefficient, the nonzeros map). So a launch takes the longest
// lane's token count times the latency of one step; bytes and operations
// are far below that, and at 135 lanes the card is almost idle. The step's
// dependent latency is the whole cost.
//
// K2's chain is one step's dependent instructions. A step needs the
// table slot of state & 0xFFF (alias bucket, cutoff compare, then the
// symbol, offset and dist), the multiply-add (state >> 12) * dist + offset,
// the renorm compare and, on a renorm, the 16 bits at the stream's cursor.
// As first ported it ran five dependent shared loads and a global byte
// read on that chain, one thread a stream on 3 SMs (127 ns a step on an
// H100). The model this design was cut to: one shared load (about 30
// cycles) and a few integer instructions (4-6 each), 55-70 cycles, 28-35
// ns at 1.98 GHz. What the design takes off the chain:
//   - Alias selection: the block expands the (5, NB) alias table into one
//     16-byte slot a 12-bit state in its prologue, with the JAX twin's
//     arithmetic (signed pos >= cutoff, wrapping alias offset + pos), so
//     every int32 table is held exactly and the host checks and packs
//     nothing: (16 offset, 16 dist, offset, dist), the symbol beside it
//     (80 KB, csrc/kernel_geometry.h's k2). The cutoff load and the loads
//     behind it become one load, and the second multiply-add, beside the
//     first, gives 16 times the next state, whose low 16 bits masked are
//     the next slot's byte offset: no shift after the state's multiply-add.
//     What stays on the chain: the load, the multiply-add, the renorm
//     compare and the masked select of the next slot.
//   - Renorm bits: a stream's cursor starts at bit 32 and moves 16 bits a
//     renorm, so the bits a step may take are the 16-bit halfword at the
//     cursor. A ring of the stream's bytes in shared memory (K3's
//     stage_words and two halves) holds them, and each step loads the
//     halfword two past the cursor, so the bits a renorm takes, and the
//     slot they give, are in registers before the step needs them: no load
//     of stream bytes is on the chain. The ring is restaged only between
//     chunks of 32 steps.
//   - Spread: one warp a stream, all 32 threads on the same uniform chain;
//     the streams spread over every SM before a block takes a second one
//     (k2::plan), so 135 streams run on 68 SMs, not 3. A block has 1024
//     threads to build the table and stage the rings, and the warps
//     without a stream then exit.
//   - Stores: lane t % 32 keeps step t's symbol, and every 32 steps the warp
//     writes 128 contiguous bytes, off the chain.
// On an H100 80GB HBM3 the step runs about 57 cycles (chip_smoke.py's K2
// time less its launch with T = 0, over T): the shared load takes most of
// it, and a variant that kept the renorm slot's entry loaded ahead, off
// the chain on a renorm, ran slower.
//
// K3 keeps the whole dependent chain of a step in registers and shared
// memory, so no global load is on it:
//   - Stream bits: a ring of the lane's bytes in shared memory, read a
//     64-bit window (three words, two funnel shifts) a token; the window
//     loads depend only on the previous token's bit count, so they are in
//     flight while the token's table row is looked up. The ring has two
//     halves; when the reader enters one half, the warp stages the half
//     after it into the other (any section length, one code path). A renorm
//     or tail read is then a shift and a mask.
//   - Context -> cluster: the lane's slice of the context map in shared
//     memory, every context a block context in range can reach, each
//     entry clamped to the map as the whole map is; 16-bit cluster ids (a
//     stack of passes offsets each pass's clusters past 255; the wrapper
//     refuses more than 65536). A context outside the slice, which only a
//     wild block context reaches, reads the global map out of line.
//   - Table: each bucket's five fields packed into one 64-bit word (the
//     wrapper packs them and checks their ranges), so a symbol is one
//     shared load; each cluster's HybridUint config sits beside the tables.
//   - Items: a ring of the group's items in shared memory, staged like the
//     stream, one 64-byte slot an item (four vector loads) holding its
//     fields and the values derived from them when it is staged (the map
//     cells its context reads, log2 of its block count, its histogram and
//     order bases, which checks it can skip); the next item is loaded one
//     item ahead.
//   - Coefficient tokens: the next token's context depends on this one
//     only through whether its coefficient is zero, so both candidate
//     clusters and the next order entry are looked up while the token
//     decodes; the zero-density LUTs and the 3x32x32 nonzeros map live in
//     shared memory, and the store is a fire-and-forget reduction.
//   - Code size: the stagings and the wild-context lookup are out of line,
//     the HybridUint tail is branch-free, and the coefficient loop has a
//     variant without slice checks for items whose contexts all lie in the
//     slice, so the hot loop stays small for the instruction cache.
// One warp walks each lane (one lane a block, 128 threads to stage, then
// warp 0 alone): all 32 threads run the same uniform chain, which costs
// nothing over one thread, and share the stagings and the nonzeros-map
// fills; thread 0 alone stores. What remains is one warp issuing a chain of
// mostly dependent instructions, a few cycles each. The shared-memory
// layout is csrc/kernel_geometry.h's (k3); the wrapper chooses the two
// sizes it leaves open, the context slice and whether the tables are
// shared (ops/device_ac.py:ac_smem_plan).
//
// Built with -DK3_PROBE, K3 also counts each lane's cycles, tokens and
// cycles in the coefficient loop (read by k3_probe_read), and K2 each
// stream's cycles in its token loop and before it and the loop's
// nanoseconds (k2_probe_read); the tool tools/k3_probe.py reads both. The
// normal build has none of it.
//
// Semantics follow the JAX twins exactly, including their clipping: byte
// indices clip to the row (a cursor past the end re-reads the row's last
// byte, never the next row), table and order indices clip to their
// arrays, and int32 arithmetic wraps as XLA's does.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "kernel_geometry.h"

#ifdef K3_PROBE
constexpr int kProbeLanes = 4096;
__device__ long long g_k3_probe[3 * kProbeLanes];  // cycles, tokens, loop cycles
// K2: cycles of a stream's token loop, cycles before it, its nanoseconds
__device__ long long g_k2_probe[3 * kProbeLanes];
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K3_PROBE_ONLY(...) __VA_ARGS__
#else
#define K3_PROBE_ONLY(...)
#endif

namespace {

using k3::kGroupDimBlocks;
using k3::kItemHalf;
using k3::kItemSlot;
using k3::kNzArea;
using k3::kRingHalf;

constexpr int kLogSumProbs = 12;
constexpr int kItemFields = 10;
constexpr int kStageThreads = 128;

__constant__ int kFreqCtx[64] = {
    0,  0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};
__constant__ int kNumNzCtx[64] = {
    0,   0,   31,  62,  62,  93,  93,  93,  93,  123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

// int32 arithmetic that wraps (XLA's semantics) without signed overflow
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// words [w0, w0 + n) of the lane's virtual byte sequence, whose word 0
// starts at byte `base` and whose byte b is row[clip(b, 0, L-1)], into dst.
// Out of line, as stage_items: the token loops stay small enough for the
// instruction cache.
__device__ __noinline__ void stage_words(uint32_t* dst, const uint8_t* row, int L,
                                            long long base, int w0, int n, int tid,
                                            int nthreads, bool aligned) {
  for (int w = tid; w < n; w += nthreads) {
    const long long b = base + 4LL * (w0 + w);
    uint32_t v;
    if (aligned && b >= 0 && b + 3 < L) {
      v = *reinterpret_cast<const uint32_t*>(row + b);
    } else {
      v = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        long long bb = b + t;
        bb = bb < 0 ? 0 : (bb > L - 1 ? L - 1 : bb);
        v |= static_cast<uint32_t>(row[bb]) << (8 * t);
      }
    }
    dst[w] = v;
  }
}

// ---- K2 ------------------------------------------------------------------

// One warp a stream, k2::plan's `warps` streams a block (see the note at
// the top). The table's slots and the rings: csrc/kernel_geometry.h's k2.
__global__ void __launch_bounds__(k2::kThreads)
    ans_decode_lanes_kernel(const uint8_t* __restrict__ streams, int S, int L,
                            const int* __restrict__ table, int NB, int log_bucket, int T,
                            int warps, int ring_words, int* __restrict__ tokens,
                            unsigned* __restrict__ final_states) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_rings = reinterpret_cast<uint32_t*>(smem + k2::kOffRings);
  constexpr int nthreads = k2::kThreads;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * warps;
  K3_PROBE_ONLY(const long long probe_entry = clock64();)

  // ---- prologue: every thread builds the slots; each stream's ring is
  // staged by its share of the threads
  {
    const int* dist = table;
    const int* asym = table + static_cast<size_t>(NB);
    const int* aoff = table + 2 * static_cast<size_t>(NB);
    const int* acut = table + 3 * static_cast<size_t>(NB);
    const int* adist = table + 4 * static_cast<size_t>(NB);
    const unsigned bmask = (1u << log_bucket) - 1u;
    uint4* s_slot = reinterpret_cast<uint4*>(smem);
    int* s_sym = reinterpret_cast<int*>(smem + k2::kOffSym);
#pragma unroll 4
    for (int j = tid; j < k2::kSlots; j += nthreads) {
      const int i = j >> log_bucket;
      const int pos = static_cast<int>(static_cast<unsigned>(j) & bmask);
      const int cut = __ldg(acut + i), sym = __ldg(asym + i), off = __ldg(aoff + i);
      const int d0 = __ldg(dist + i), d1 = __ldg(adist + i);
      const bool alias = pos >= cut;
      const unsigned o = static_cast<unsigned>(alias ? wadd(off, pos) : pos);
      const unsigned d = static_cast<unsigned>(alias ? d1 : d0);
      s_slot[j] = make_uint4(o * k2::kSlotBytes, d * k2::kSlotBytes, o, d);
      s_sym[j] = alias ? sym : i;
    }
    const int group = nthreads / warps;  // threads a ring
    const int w = tid / group;
    if (w < warps && first + w < S) {
      const uint8_t* row = streams + static_cast<size_t>(first + w) * L;
      stage_words(s_rings + w * ring_words, row, L, 0, 0, ring_words, tid - w * group, group,
                  (reinterpret_cast<uintptr_t>(row) & 3) == 0);
    }
  }
  __syncthreads();

  const int wid = tid >> 5, lane = tid & 31;
  const int s = first + wid;
  if (wid >= warps || s >= S) return;
  const uint8_t* row = streams + static_cast<size_t>(s) * L;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 3) == 0;
  uint32_t* ring = s_rings + wid * ring_words;
  const uint16_t* ring16 = reinterpret_cast<const uint16_t*>(ring);
  const int half = ring_words >> 1;
  const unsigned hw_mask = 2u * ring_words - 1u;
  const long long n_words = k2::words_read(T, L);
  // a cursor past the row reads the halfword of word ceil(L / 4), whose
  // bytes are all the row's last
  const long long k_row = 2 * ((static_cast<long long>(L) + 3) / 4);
  const int k_max = k_row < 0x7FFFFFFF ? static_cast<int>(k_row) : 0x7FFFFFFF;
  int stage_at = half;
  // the ring word of the cursor enters half h = stage_at / half: stage the
  // half after it over the one before, unless no step takes bits that far
  auto restage = [&](int k) {
    if ((min(k, k_max) >> 1) >= stage_at && stage_at + half < n_words) {
      const int h = stage_at / half;
      __syncwarp();
      stage_words(ring + ((h + 1) & 1) * half, row, L, 0, (h + 1) * half, half, lane, 32,
                  aligned);
      __syncwarp();
      stage_at += half;
    }
  };
  // halfword j of the stream: bits [16j, 16j + 16)
  auto halfword = [&](int j) -> unsigned {
    return ring16[static_cast<unsigned>(min(j, k_max)) & hw_mask];
  };

  // the chain runs through `slot`, the byte offset of the state's slot;
  // cur and nxt are the halfwords at the cursor and after it
  unsigned state = ring[0];  // bytes 0-3, clipped to the row
  unsigned slot = (state & 0xFFFu) * k2::kSlotBytes;
  int k = 2;                 // the cursor, in halfwords: bit 16k
  unsigned cur = halfword(2), nxt = halfword(3);
  // one step; every value is uniform in the warp
  auto step = [&]() -> int {
    const uint4 e = *reinterpret_cast<const uint4*>(smem + slot);
    const int sym = *reinterpret_cast<const int*>(smem + k2::kOffSym + slot / 4);
    const unsigned ahead = halfword(k + 2);
    const unsigned renorm_slot = (cur * k2::kSlotBytes) & k2::kSlotMask;
    const unsigned hi = state >> kLogSumProbs;
    const unsigned ns = hi * e.w + e.z;  // (state >> 12) * dist + offset
    // 16 times that, masked, is its slot; computed whether or not the step
    // renormalises (the empty asm keeps the compiler from computing it only
    // after the compare, one instruction deeper on the chain)
    unsigned next_slot = (hi * e.y + e.x) & k2::kSlotMask;
    asm volatile("" : "+r"(next_slot));
    const bool renorm = ns < (1u << 16);
    slot = renorm ? renorm_slot : next_slot;
    state = renorm ? ((ns << 16) | cur) : ns;
    k += renorm ? 1 : 0;
    cur = renorm ? nxt : cur;
    nxt = renorm ? ahead : nxt;
    return sym;
  };

  int* out = tokens + static_cast<size_t>(s) * T;
  int keep = 0;  // this lane's symbol of the chunk
  K3_PROBE_ONLY(const long long probe_t0 = clock64(); const long long probe_ns0 = globaltimer();)
  int t0 = 0;
  for (; T - t0 >= k2::kChunk; t0 += k2::kChunk) {
    restage(k);
#pragma unroll
    for (int j = 0; j < k2::kChunk; ++j) {
      const int sym = step();
      keep = j == lane ? sym : keep;
    }
    out[t0 + lane] = keep;
  }
  if (t0 < T) {
    restage(k);
    const int n = T - t0;
    for (int j = 0; j < n; ++j) {
      const int sym = step();
      keep = j == lane ? sym : keep;
    }
    if (lane < n) out[t0 + lane] = keep;
  }
  if (lane == 0) {
    final_states[s] = state;
    K3_PROBE_ONLY(if (s < kProbeLanes) {
      g_k2_probe[3 * s] = clock64() - probe_t0;
      g_k2_probe[3 * s + 1] = probe_t0 - probe_entry;
      g_k2_probe[3 * s + 2] = globaltimer() - probe_ns0;
    })
  }
}

// ---- K3 ------------------------------------------------------------------

struct AcArgs {
  const uint8_t* streams;
  int S, L;
  const int* start_bits;
  const int* lane_group;
  const int* lane_ctx_off;
  const int* lane_shift;
  const int* lane_order_base;
  const int* lane_coeff_base;
  const int* lane_n_items;
  const int* lane_end_bits;
  const int* items;  // (G, I, 10)
  int I;
  const int* orders;
  int O;
  // (C, NB) packed buckets: bits 0-12 alias cutoff, 13-25 dist, 26-38 alias
  // dist, 39-50 alias symbol, 51-63 alias offset (signed)
  const unsigned long long* packed;
  // (C,) HybridUint configs: split exponent | msb << 8 | lsb << 16
  const int* cfgs;
  int C, NB;
  const int* context_map;
  int NC;
  int log_bucket, num_bctx, total;
  int* coeffs;  // (total,)
  uint8_t* ok;  // (S,)
  int ctx_slice;  // context-map entries staged per lane
  int off_cfg;    // byte offsets in shared memory (k3::layout)
  int off_tab;
};

static_assert(k3::kCtxEntryBytes == sizeof(uint16_t), "the slice holds 16-bit cluster ids");

// An item's slot in the ring: its ten fields, then values derived from them
// once, when the item is staged, so the walk does not compute them.
struct Item {
  int c, sbx, sby, nb, nc, bctx, order_off, coeffs_off, cx, cy;
  int cells;       // the nonzeros-map cells its context reads: above | left << 16
  int flags;       // kItem* bits | log2(block count) << 8
  int histo_base;  // the coefficient contexts' base
  int nz_base;     // the nonzeros context less nzctx * num_bctx
  int ob;          // order base, held in [-2^30, 2^30]
  int fill_cell;   // the map cell of a one-block item
};
constexpr int kItemSbx0 = 1, kItemSby0 = 2, kItemFill1 = 4, kItemChannel = 8;
constexpr int kItemNzInSlice = 16, kItemCoefFast = 32;

// what the derived values depend on besides the item
struct ItemCtx {
  int ctx_off, num_bctx, n_slice, order_base, O;
};

// items [first, first + n) of a group (indices clipped to I-1) into dst,
// one slot each, with their derived values
__device__ __noinline__ void stage_items(int* dst, const int* gitems, int I, int first,
                                         int n, int tid, int nthreads, ItemCtx x) {
  for (int v = tid; v < n; v += nthreads) {
    const int* f = gitems + min(first + v, I - 1) * kItemFields;
    Item t{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
    const int ch_base = t.c * kNzArea;
    const int iu = clampi(ch_base + (t.sby - 1) * kGroupDimBlocks + t.sbx, 0, 3 * kNzArea - 1);
    const int il = clampi(ch_base + t.sby * kGroupDimBlocks + (t.sbx - 1 > 0 ? t.sbx - 1 : 0),
                          0, 3 * kNzArea - 1);
    t.cells = iu | (il << 16);
    const bool channel = t.c >= 0 && t.c < 3;
    const bool fill1 = channel && t.cx == 1 && t.cy == 1 &&
                       static_cast<unsigned>(t.sbx) < kGroupDimBlocks &&
                       static_cast<unsigned>(t.sby) < kGroupDimBlocks;
    t.histo_base = x.num_bctx * 37 + 458 * t.bctx + x.ctx_off;
    t.nz_base = wadd(t.bctx, x.ctx_off);
    constexpr long long kHold = 1LL << 30;
    const long long ob64 = static_cast<long long>(x.order_base) + t.order_off;
    t.ob = static_cast<int>(ob64 < -kHold ? -kHold : (ob64 > kHold ? kHold : ob64));
    t.fill_cell = fill1 ? ch_base + t.sby * kGroupDimBlocks + t.sbx : 0;
    // nonzeros contexts reach 36 * num_bctx + the block context; the
    // coefficient contexts [histo_base, histo_base + 473]; the orders
    // [ob + nb, ob + nc]
    const bool nz_in_slice = 37LL * x.num_bctx <= x.n_slice && t.bctx >= 0 &&
                             t.bctx < x.num_bctx;
    const long long rel0 = static_cast<long long>(t.histo_base) - x.ctx_off;
    const bool coef_fast = rel0 >= 0 && rel0 + 2 * (206 + 30) + 1 < x.n_slice && t.nb >= 0 &&
                           ob64 >= 0 && ob64 <= kHold && ob64 + t.nc <= x.O - 1;
    const int lnb = 31 - __clz(t.nb > 1 ? t.nb : 1);
    t.flags = (t.sbx == 0 ? kItemSbx0 : 0) | (t.sby == 0 ? kItemSby0 : 0) |
              (fill1 ? kItemFill1 : 0) | (channel ? kItemChannel : 0) |
              (nz_in_slice ? kItemNzInSlice : 0) | (coef_fast ? kItemCoefFast : 0) | (lnb << 8);
    int4* d = reinterpret_cast<int4*>(dst + v * kItemSlot);
    d[0] = make_int4(t.c, t.sbx, t.sby, t.nb);
    d[1] = make_int4(t.nc, t.bctx, t.order_off, t.coeffs_off);
    d[2] = make_int4(t.cx, t.cy, t.cells, t.flags);
    d[3] = make_int4(t.histo_base, t.nz_base, t.ob, t.fill_cell);
  }
}

__device__ __forceinline__ Item load_item(const int* s) {  // a 16-byte aligned slot
  const int4* q = reinterpret_cast<const int4*>(s);
  const int4 a = q[0], b = q[1], c = q[2], d = q[3];
  return Item{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
}

__device__ __noinline__ int cluster_of_wild_context(const int* context_map, int ctx, int NC1) {
  return __ldg(context_map + clampi(ctx, 0, NC1));
}

// coeffs[dest] += v, fire and forget
__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <bool kTabShared>
__global__ void __launch_bounds__(kStageThreads, 1) ac_sections_kernel(AcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_nz = reinterpret_cast<int*>(smem + k3::kOffNz);
  int* s_numnz = reinterpret_cast<int*>(smem + k3::kOffLut);
  int* s_freq = s_numnz + 64;
  int* s_items = reinterpret_cast<int*>(smem + k3::kOffItems);
  uint32_t* s_ring = reinterpret_cast<uint32_t*>(smem + k3::kOffRing);
  uint16_t* s_ctx = reinterpret_cast<uint16_t*>(smem + k3::kOffCtx);
  int* s_cfg = reinterpret_cast<int*>(smem + a.off_cfg);
  unsigned long long* s_tab = reinterpret_cast<unsigned long long*>(smem + a.off_tab);

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* row = a.streams + static_cast<size_t>(lane) * a.L;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 3) == 0;
  const int g = a.lane_group[lane];
  const int* gitems = a.items + static_cast<size_t>(g) * a.I * kItemFields;
  const int ctx_off = a.lane_ctx_off[lane];
  const int start = a.start_bits[lane];
  // word 0 of the ring holds the aligned word around the first bit
  const long long base = static_cast<long long>(start >> 5) * 4;
  // the staged slice: contexts [ctx_off, ctx_off + ctx_slice), each entry
  // the cluster of the context clamped to the map, as the whole map gives
  const int n_slice = a.ctx_slice;

  // ---- prologue: every thread stages
  if (kTabShared)
    for (int j = tid; j < a.C * a.NB; j += kStageThreads) s_tab[j] = a.packed[j];
  for (int j = tid; j < 3 * kNzArea; j += kStageThreads) s_nz[j] = 0;
  for (int j = tid; j < 64; j += kStageThreads) {
    s_numnz[j] = kNumNzCtx[j];
    s_freq[j] = kFreqCtx[j];
  }
  for (int j = tid; j < a.C; j += kStageThreads) s_cfg[j] = a.cfgs[j];
  for (int j = tid; j < n_slice; j += kStageThreads) {
    const long long ctx = static_cast<long long>(ctx_off) + j;
    const long long at = ctx < 0 ? 0 : (ctx > a.NC - 1 ? a.NC - 1 : ctx);
    s_ctx[j] = static_cast<uint16_t>(a.context_map[at]);
  }
  const ItemCtx ictx{ctx_off, a.num_bctx, n_slice, a.lane_order_base[lane], a.O};
  stage_items(s_items, gitems, a.I, 0, 2 * kItemHalf, tid, kStageThreads, ictx);
  stage_words(s_ring, row, a.L, base, 0, 2 * kRingHalf, tid, kStageThreads, aligned);
  __syncthreads();
  if (tid >= 32) return;

  // ---- warp 0 walks the lane; every value below is uniform in the warp
  const int lid = tid;
  K3_PROBE_ONLY(const long long probe_t0 = clock64(); long long probe_tokens = 0, probe_loop = 0;)
  // values the token loop reads every token, pinned in registers (the
  // empty asm keeps the compiler from rematerializing them there, e.g.
  // the lane id from a special-register read)
  int leader = lid == 0 ? 1 : 0;
  asm volatile("" : "+r"(leader));
  const int shift = a.lane_shift[lane];
  const int n_items = a.lane_n_items[lane];
  const int NB = a.NB, lb = a.log_bucket;
  const int NC1 = a.NC - 1;
  const unsigned bmask = (1u << lb) - 1u;

  // bit reader: the cursor bp indexes the lane's virtual bytes; a token
  // reads a 64-bit window at bp from three ring words at once and moves bp
  // past its renorm and tail bits. The ring word of bp is wrel; when it
  // enters half h, half h+1 is staged over half h-1
  const int q0 = start >> 5;
  int bp = start;
  int stage_at = kRingHalf;
  auto window = [&](unsigned& lo, unsigned& hi) {
    const int wrel = (bp >> 5) - q0;
    if (wrel >= stage_at) {
      const int h = stage_at / kRingHalf;
      __syncwarp();
      stage_words(s_ring + ((h + 1) & 1) * kRingHalf, row, a.L, base, (h + 1) * kRingHalf,
                  kRingHalf, lid, 32, aligned);
      __syncwarp();
      stage_at += kRingHalf;
    }
    constexpr int M = 2 * kRingHalf - 1;
    const uint32_t w0 = s_ring[wrel & M], w1 = s_ring[(wrel + 1) & M], w2 = s_ring[(wrel + 2) & M];
    lo = __funnelshift_r(w0, w1, static_cast<unsigned>(bp));
    hi = __funnelshift_r(w1, w2, static_cast<unsigned>(bp));
  };

  // context -> cluster: the staged slice, else (a wild block context) the
  // whole map, clamped
  auto lookup = [&](int ctx) -> int {
    const unsigned rel = static_cast<unsigned>(ctx) - static_cast<unsigned>(ctx_off);
    if (rel < static_cast<unsigned>(n_slice)) return s_ctx[rel];
    return cluster_of_wild_context(a.context_map, ctx, NC1);
  };

  // one rANS symbol of `cluster` and its HybridUint value: its renorm and
  // tail bits come from one window (16 + 31 bits at most)
  unsigned state;
  {
    unsigned lo, hi;
    window(lo, hi);
    state = lo;
    bp += 32;
  }
  auto decode = [&](int cluster) -> unsigned {
    K3_PROBE_ONLY(++probe_tokens;)
    unsigned lo, hi;
    window(lo, hi);
    const unsigned idx = state & 0xFFFu;
    const int bucket = cluster * NB + static_cast<int>(idx >> lb);
    const unsigned long long w = kTabShared ? s_tab[bucket] : __ldg(a.packed + bucket);
    const unsigned cfg = static_cast<unsigned>(s_cfg[cluster]);
    const unsigned pos = idx & bmask;
    const unsigned wlo = static_cast<unsigned>(w), whi = static_cast<unsigned>(w >> 32);
    const bool use_alias = pos >= (wlo & 0x1FFFu);
    const unsigned token = use_alias ? ((whi >> 7) & 0xFFFu) : (idx >> lb);
    const unsigned off = use_alias ? static_cast<unsigned>(static_cast<int>(whi) >> 19) + pos : pos;
    const unsigned d = use_alias ? (((wlo >> 26) | (whi << 6)) & 0x1FFFu) : ((wlo >> 13) & 0x1FFFu);
    const unsigned ns = (state >> kLogSumProbs) * d + off;
    const bool renorm = ns < (1u << 16);
    state = renorm ? ((ns << 16) | (lo & 0xFFFFu)) : ns;
    const unsigned rest = renorm ? __funnelshift_r(lo, hi, 16) : lo;
    // HybridUint, without a branch: a token below the split reads no bits
    const unsigned se = cfg & 0xFFu, msb = (cfg >> 8) & 0xFFu, lsb = cfg >> 16;
    const unsigned split = 1u << se;
    const bool tail = token >= split;
    const unsigned bit = msb + lsb;
    const unsigned nbits = tail ? ((se - bit + ((token - split) >> bit)) & 31u) : 0u;
    const unsigned raw = rest & ((1u << nbits) - 1u);
    const unsigned low = token & ((1u << lsb) - 1u);
    const unsigned hib = ((token >> lsb) & ((1u << msb) - 1u)) | (1u << msb);
    bp += (renorm ? 16 : 0) + static_cast<int>(nbits);
    return tail ? ((((hib << nbits) | raw) << lsb) | low) : token;
  };

  // the current item; the next one is loaded one item ahead
  int item = 0;
  bool err = false;
  Item it = load_item(s_items);
  Item nx = load_item(s_items + kItemSlot);
  auto advance = [&]() {
    ++item;
    if ((item & (kItemHalf - 1)) == 0) {
      const int h = item / kItemHalf;
      __syncwarp();
      stage_items(s_items + ((h + 1) & 1) * kItemHalf * kItemSlot, gitems, a.I,
                  (h + 1) * kItemHalf, kItemHalf, lid, 32, ictx);
      __syncwarp();
    }
    it = nx;
    nx = load_item(s_items + ((item + 1) & (2 * kItemHalf - 1)) * kItemSlot);
  };

  while (item < n_items) {
    const int nb = it.nb, nc = it.nc, flags = it.flags;
    const int lnb = flags >> 8;
    const unsigned nround = (1u << lnb) - 1u;

    // the nonzeros token: context from the nonzeros map
    const int up = s_nz[it.cells & 0xFFFF], left = s_nz[it.cells >> 16];
    const int avg = wadd(wadd(up, left), 1) >> 1;  // both loads issue at once
    const int predicted = (flags & kItemSby0) ? ((flags & kItemSbx0) ? 32 : left)
                                              : ((flags & kItemSbx0) ? up : avg);
    const int nzctx = predicted < 8 ? predicted : (predicted < 64 ? 4 + (predicted >> 1) : 36);
    const int nz_ctx = wadd(wmul(nzctx, a.num_bctx), it.nz_base);
    const int nz_val = static_cast<int>(decode(
        (flags & kItemNzInSlice)
            ? s_ctx[static_cast<unsigned>(nz_ctx) - static_cast<unsigned>(ctx_off)]
            : lookup(nz_ctx)));
    if (wadd(nz_val, nb) > nc) {
      err = true;
      break;
    }
    if (flags & kItemChannel) {
      const int num = wadd(wadd(nz_val, nb), -1);
      const int fill = nb > 1 ? ((nb & (nb - 1)) == 0 ? (num >> lnb) : floordiv(num, nb)) : num;
      if (flags & kItemFill1) {
        // one block: every thread stores the same word and reads its own
        // store later, so no warp barrier is needed
        s_nz[it.fill_cell] = fill;
      } else {
        // a column a thread, between barriers: every earlier store is seen
        // before, and these after
        __syncwarp();
        const int ch_base = it.c * kNzArea;
        const int y0 = it.sby > 0 ? it.sby : 0, y1 = min(it.sby + it.cy, kGroupDimBlocks);
        const int x = (it.sbx > 0 ? it.sbx : 0) + lid, x1 = min(it.sbx + it.cx, kGroupDimBlocks);
        if (x < x1)
          for (int y = y0; y < y1; ++y) s_nz[ch_base + y * kGroupDimBlocks + x] = fill;
        __syncwarp();
      }
    }
    // a negative count neither starts nor skips the item, and a start with a
    // negative block count leaves the next token a nonzeros token: either
    // way the same item's nonzeros token comes again
    if (nz_val < 0 || (nz_val > 0 && nb < 0)) continue;

    if (nz_val > 0) {
      // the coefficient tokens. The next token's context depends on this
      // token only through whether its coefficient is zero, so both of
      // its candidate clusters and its order entry are looked up ahead
      int histo_base = it.histo_base;
      asm volatile("" : "+r"(histo_base));
      const int ob = it.ob;
      const int O1 = a.O - 1;
      int* const cdst = a.coeffs;
      const long long cbase = static_cast<long long>(a.lane_coeff_base[lane]) + it.coeffs_off;
      const unsigned long long total = static_cast<unsigned long long>(a.total);
      auto nzl = [&](int n) {  // n >= 0: the unsigned sum cannot wrap
        const unsigned v = (static_cast<unsigned>(n) + nround) >> lnb;
        return v < 63u ? static_cast<int>(v) : 63;
      };
      auto kn = [&](int k) { return ((k > (1 << 20) ? (1 << 20) : k) >> lnb) & 63; };
      // an item whose contexts all lie in the slice and whose orders all
      // lie in the array (kItemCoefFast) looks them up unchecked
      auto walk = [&](auto checked) {
        constexpr bool kChecked = decltype(checked)::value;
        auto lk = [&](int ctx) -> int {
          if (kChecked) return lookup(ctx);
          return s_ctx[static_cast<unsigned>(ctx) - static_cast<unsigned>(ctx_off)];
        };
        auto order_at = [&](int k) {
          return __ldg(a.orders + (kChecked ? clampi(ob + k, 0, O1) : ob + k));
        };
        int k = nb, nonzeros = nz_val;
        const int prev0 = nz_val > (nc >> 4) ? 0 : 1;
        int cluster = lk(histo_base + (s_numnz[nzl(nonzeros)] + s_freq[kn(k)]) * 2 + prev0);
        int ord = order_at(k);
        for (;;) {
          const int f1 = s_freq[kn(k + 1)];
          const int cl_zero = lk(histo_base + (s_numnz[nzl(nonzeros)] + f1) * 2);
          const int cl_nz = lk(histo_base + (s_numnz[nzl(nonzeros - 1)] + f1) * 2 + 1);
          const int ord_next = order_at(k + 1);

          const unsigned value = decode(cluster);
          const int mag = static_cast<int>((value + 1u) >> 1);
          int coeff = (value & 1u) ? static_cast<int>(0u - static_cast<unsigned>(mag))
                                   : static_cast<int>(value >> 1);
          coeff = static_cast<int>(static_cast<unsigned>(coeff) << shift);
          const long long dest = cbase + ord;
          if (leader && coeff != 0 && static_cast<unsigned long long>(dest) < total)
            red_add(cdst + dest, coeff);
          const int is_nz = coeff != 0 ? 1 : 0;
          nonzeros -= is_nz;
          if (nonzeros == 0 || k + 1 >= nc) return nonzeros > 0;
          ++k;
          cluster = is_nz ? cl_nz : cl_zero;
          ord = ord_next;
        }
      };
      K3_PROBE_ONLY(const long long probe_w0 = clock64();)
      err = (flags & kItemCoefFast) ? walk(std::false_type{}) : walk(std::true_type{});
      K3_PROBE_ONLY(probe_loop += clock64() - probe_w0;)
      if (err) break;
    }
    advance();
  }
  if (lid == 0) {
    a.ok[lane] = (!err && item >= n_items && state == 0x130000u &&
                  bp <= a.lane_end_bits[lane]) ? 1 : 0;
    K3_PROBE_ONLY(if (lane < kProbeLanes) {
      g_k3_probe[3 * lane] = clock64() - probe_t0;
      g_k3_probe[3 * lane + 1] = probe_tokens;
      g_k3_probe[3 * lane + 2] = probe_loop;
    })
  }
}

template <bool kTabShared>
cudaError_t launch_ac(const AcArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = ac_sections_kernel<kTabShared>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<a.S, kStageThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ans_decode_lanes_launch(const void* streams, int S, int L, const void* table, int NB,
                            int log_bucket, int T, void* tokens, void* final_states, int warps,
                            int ring_words, void* stream) {
  // warps and ring_words: the wrapper's plan (ops/ans_lanes.py:k2_plan)
  if (S <= 0) return 0;
  if (L <= 0 || T < 0 || log_bucket < 0 || log_bucket > 12 ||
      (static_cast<long long>(NB) << log_bucket) < k2::kSlots || warps < 1 ||
      warps > k2::kMaxWarps || ring_words < k2::kMinRingWords ||
      ring_words > k2::kMaxRingWords || (ring_words & (ring_words - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const k2::Plan p = k2::plan_of(warps, ring_words);
  cudaError_t e = cudaFuncSetAttribute(ans_decode_lanes_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ans_decode_lanes_kernel<<<(S + warps - 1) / warps, k2::kThreads, p.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), S, L, static_cast<const int*>(table), NB,
      log_bucket, T, warps, ring_words, static_cast<int*>(tokens),
      static_cast<unsigned*>(final_states));
  return static_cast<int>(cudaGetLastError());
}

int ac_sections_launch(const void* streams, int S, int L, const void* start_bits,
                       const void* lane_group, const void* lane_ctx_off,
                       const void* lane_shift, const void* lane_order_base,
                       const void* lane_coeff_base, const void* lane_n_items,
                       const void* lane_end_bits, const void* items, int I,
                       const void* orders, int O, const void* packed, const void* cfgs, int C,
                       int NB, const void* context_map, int NC, int log_bucket, int num_bctx,
                       int total, void* coeffs, void* ok, int tab_shared, int ctx_slice,
                       void* stream) {
  // tab_shared and ctx_slice: the wrapper's plan (ops/device_ac.py:ac_smem_plan)
  if (S <= 0) return 0;
  if (ctx_slice < 0 || C > 65536) return static_cast<int>(cudaErrorInvalidValue);
  const k3::Layout lay = k3::layout(tab_shared != 0, C, NB, ctx_slice);
  AcArgs a;
  a.streams = static_cast<const uint8_t*>(streams);
  a.S = S;
  a.L = L;
  a.start_bits = static_cast<const int*>(start_bits);
  a.lane_group = static_cast<const int*>(lane_group);
  a.lane_ctx_off = static_cast<const int*>(lane_ctx_off);
  a.lane_shift = static_cast<const int*>(lane_shift);
  a.lane_order_base = static_cast<const int*>(lane_order_base);
  a.lane_coeff_base = static_cast<const int*>(lane_coeff_base);
  a.lane_n_items = static_cast<const int*>(lane_n_items);
  a.lane_end_bits = static_cast<const int*>(lane_end_bits);
  a.items = static_cast<const int*>(items);
  a.I = I;
  a.orders = static_cast<const int*>(orders);
  a.O = O;
  a.packed = static_cast<const unsigned long long*>(packed);
  a.cfgs = static_cast<const int*>(cfgs);
  a.C = C;
  a.NB = NB;
  a.context_map = static_cast<const int*>(context_map);
  a.NC = NC;
  a.log_bucket = log_bucket;
  a.num_bctx = num_bctx;
  a.total = total;
  a.coeffs = static_cast<int*>(coeffs);
  a.ok = static_cast<uint8_t*>(ok);
  a.ctx_slice = ctx_slice;
  a.off_cfg = static_cast<int>(lay.cfg);
  a.off_tab = static_cast<int>(lay.tab);
  const size_t smem = static_cast<size_t>(lay.total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tab_shared ? launch_ac<true>(a, smem, st)
                                    : launch_ac<false>(a, smem, st));
}

const char* ans_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef K3_PROBE
// the counters of the last launch: 3 per lane (cycles of its walk, tokens,
// cycles in its coefficient loops) for the first n lanes, into host memory
int k3_probe_read(void* host, int n) {
  if (n < 0 || n > kProbeLanes) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_k3_probe, sizeof(long long) * 3 * static_cast<size_t>(n)));
}

// K2's counters of the last launch: 3 per stream (cycles of its token
// loop, cycles from the kernel's entry to the loop, nanoseconds of the
// loop) for the first n streams, into host memory
int k2_probe_read(void* host, int n) {
  if (n < 0 || n > kProbeLanes) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_k2_probe, sizeof(long long) * 3 * static_cast<size_t>(n)));
}
#endif

}  // extern "C"
