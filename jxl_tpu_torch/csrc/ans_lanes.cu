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
// Both call one __device__ rANS step, ans_step(), in exact integer
// arithmetic: the state is a uint32 and every table value an int32 (the
// TPU reference once lost renorm bits to bf16 matrix rounding,
// pallas_ans.py:19-23).
//
// What bounds them. Each lane is a serial chain: a symbol's table row
// depends on the state the previous symbol left, and in K3 the context of
// a token depends on the tokens before it (nonzeros left, the previous
// coefficient, the nonzeros map). So the time of a launch is the longest
// lane's token count times the latency of one step (a few dependent loads
// from L1/shared memory), not bytes or operations: at 135 lanes the card
// is almost idle. The design keeps each step's loads close: K2 holds the
// (5, NB) table in shared memory; K3 holds its lane's 3x32x32 nonzeros map
// in shared memory and the packed alias tables too when they fit, and
// otherwise reads them from global memory (L1/L2 cached). K3 runs one lane
// per block (one active thread), so lanes never diverge inside a warp and
// spread over the SMs. Making the lanes shorter (more, smaller lanes) is a
// redesign for a later change.
//
// Semantics follow the JAX twins exactly, including their clipping: byte
// indices clip to the row (a cursor past the end re-reads the row's last
// byte, never the next row), table and order indices clip to their
// arrays, and int32 arithmetic wraps as XLA's does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogSumProbs = 12;
constexpr int kGroupDimBlocks = 32;
constexpr int kNzArea = kGroupDimBlocks * kGroupDimBlocks;

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

// 16 bits LSB-first at bit cursor bp of a row of L bytes, byte indices
// clipped to [0, L-1]
__device__ __forceinline__ unsigned window16(const uint8_t* row, int L, int bp) {
  int byte0 = bp >> 3;
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int idx = byte0 + j;
    idx = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
    w |= static_cast<unsigned>(row[idx]) << (8 * j);
  }
  return (w >> (bp & 7)) & 0xFFFFu;
}

__device__ __forceinline__ unsigned read_bits(const uint8_t* row, int L, int bp, int nbits) {
  unsigned v = window16(row, L, bp) | (window16(row, L, bp + 16) << 16);
  unsigned mask = nbits >= 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1u);
  return v & mask;
}

// The shared rANS step: (state, cursor, table row) -> (symbol, state',
// cursor'). tab(r, i) returns row r (dist, alias symbol, alias offset,
// alias cutoff, alias dist) at bucket i.
template <class Tab>
__device__ __forceinline__ int ans_step(unsigned& state, int& bitpos, const uint8_t* row,
                                        int L, int log_bucket, const Tab& tab) {
  unsigned idx = state & 0xFFFu;
  int i = static_cast<int>(idx >> log_bucket);
  int pos = static_cast<int>(idx & ((1u << log_bucket) - 1u));
  bool use_alias = pos >= tab(3, i);
  int sym = use_alias ? tab(1, i) : i;
  int off = use_alias ? tab(2, i) + pos : pos;
  int d = use_alias ? tab(4, i) : tab(0, i);
  unsigned ns = (state >> kLogSumProbs) * static_cast<unsigned>(d) + static_cast<unsigned>(off);
  if (ns < (1u << 16)) {
    ns = (ns << 16) | read_bits(row, L, bitpos, 16);
    bitpos += 16;
  }
  state = ns;
  return sym;
}

// ---- K2 ------------------------------------------------------------------

__global__ void ans_decode_lanes_kernel(const uint8_t* __restrict__ streams, int S, int L,
                                        const int* __restrict__ table, int NB, int log_bucket,
                                        int T, int* __restrict__ tokens,
                                        unsigned* __restrict__ final_states) {
  extern __shared__ int s_table[];  // (5, NB)
  for (int j = threadIdx.x; j < 5 * NB; j += blockDim.x) s_table[j] = table[j];
  __syncthreads();
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint8_t* row = streams + static_cast<size_t>(s) * L;
  auto tab = [&](int r, int i) { return s_table[r * NB + i]; };
  unsigned state = read_bits(row, L, 0, 32);
  int bitpos = 32;
  int* out = tokens + static_cast<size_t>(s) * T;
  for (int t = 0; t < T; ++t) out[t] = ans_step(state, bitpos, row, L, log_bucket, tab);
  final_states[s] = state;
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
  const int* tables;  // (C, 5, NB)
  int C, NB;
  const int* uint_cfgs;  // (C, 3)
  const int* context_map;
  int NC;
  int log_bucket, num_bctx, total;
  int* coeffs;  // (total,)
  uint8_t* ok;  // (S,)
  int tables_in_shared;
};

__global__ void ac_sections_kernel(AcArgs a) {
  __shared__ int s_nz[3 * kNzArea];
  extern __shared__ int s_tables[];
  const int lane = blockIdx.x;
  for (int j = threadIdx.x; j < 3 * kNzArea; j += blockDim.x) s_nz[j] = 0;
  if (a.tables_in_shared)
    for (int j = threadIdx.x; j < a.C * 5 * a.NB; j += blockDim.x) s_tables[j] = a.tables[j];
  __syncthreads();
  if (threadIdx.x != 0 || lane >= a.S) return;

  const int* tflat = a.tables_in_shared ? s_tables : a.tables;
  const int tlast = a.C * 5 * a.NB - 1;
  const uint8_t* row = a.streams + static_cast<size_t>(lane) * a.L;
  const int g = a.lane_group[lane];
  const int ctx_off = a.lane_ctx_off[lane];
  const int shift = a.lane_shift[lane];
  const int order_base = a.lane_order_base[lane];
  const int coeff_base = a.lane_coeff_base[lane];
  const int n_items = a.lane_n_items[lane];

  int bitpos = a.start_bits[lane];
  unsigned state = read_bits(row, a.L, bitpos, 32);
  bitpos += 32;
  int item = 0, k = -1, nonzeros = 0, prev = 0;
  bool err = false;

  while (item < n_items && !err) {
    const int it = item < 0 ? 0 : (item > a.I - 1 ? a.I - 1 : item);
    const int* f = a.items + (static_cast<size_t>(g) * a.I + it) * 10;
    const int c = f[0], sbx = f[1], sby = f[2], nb = f[3], nc = f[4], bctx = f[5];
    const int order_off = f[6], coeffs_off = f[7], cx = f[8], cy = f[9];
    const int lnb = 31 - __clz(nb > 1 ? nb : 1);
    const bool need_nz = k < 0;

    // context selection
    int ctx;
    if (need_nz) {
      const int ch_base = c * kNzArea;
      int iu = ch_base + (sby - 1) * kGroupDimBlocks + sbx;
      int il = ch_base + sby * kGroupDimBlocks + (sbx - 1 > 0 ? sbx - 1 : 0);
      iu = iu < 0 ? 0 : (iu > 3 * kNzArea - 1 ? 3 * kNzArea - 1 : iu);
      il = il < 0 ? 0 : (il > 3 * kNzArea - 1 ? 3 * kNzArea - 1 : il);
      const int up = s_nz[iu], left = s_nz[il];
      const int predicted = sbx == 0 ? (sby == 0 ? 32 : up)
                                     : (sby == 0 ? left : (wadd(wadd(up, left), 1) >> 1));
      const int nzctx = predicted < 8 ? predicted : (predicted < 64 ? 4 + predicted / 2 : 36);
      ctx = wadd(wadd(wmul(nzctx, a.num_bctx), bctx), ctx_off);
    } else {
      const int nzl = min((nonzeros + (1 << lnb) - 1) >> lnb, 63);
      const int kn = (k < 0 ? 0 : (k > (1 << 20) ? (1 << 20) : k)) >> lnb;
      const int histo_base = a.num_bctx * 37 + 458 * bctx + ctx_off;
      ctx = histo_base + (kNumNzCtx[nzl & 63] + kFreqCtx[kn & 63]) * 2 + prev;
    }
    const int cluster = a.context_map[ctx < 0 ? 0 : (ctx > a.NC - 1 ? a.NC - 1 : ctx)];

    // rANS symbol + HybridUint
    auto tab = [&](int r, int i) {
      int fi = (cluster * 5 + r) * a.NB + i;
      return tflat[fi < 0 ? 0 : (fi > tlast ? tlast : fi)];
    };
    const unsigned token =
        static_cast<unsigned>(ans_step(state, bitpos, row, a.L, a.log_bucket, tab));
    const unsigned se = static_cast<unsigned>(a.uint_cfgs[cluster * 3 + 0]);
    const unsigned msb = static_cast<unsigned>(a.uint_cfgs[cluster * 3 + 1]);
    const unsigned lsb = static_cast<unsigned>(a.uint_cfgs[cluster * 3 + 2]);
    const unsigned split = 1u << se;
    unsigned value = token;
    if (token >= split) {
      const unsigned bit = msb + lsb;
      const int nbits = static_cast<int>((se - bit + ((token - split) >> bit)) & 31u);
      const unsigned raw = read_bits(row, a.L, bitpos, nbits);
      bitpos += nbits;
      const unsigned low = token & ((1u << lsb) - 1u);
      const unsigned hi = ((token >> lsb) & ((1u << msb) - 1u)) | (1u << msb);
      value = (((hi << nbits) | raw) << lsb) | low;
    }

    if (need_nz) {
      const int nz_val = static_cast<int>(value);
      const bool bad = wadd(nz_val, nb) > nc;
      if (!bad && c >= 0 && c < 3) {
        const int fill = floordiv(wadd(wadd(nz_val, nb), -1), nb > 1 ? nb : 1);
        const int y0 = sby > 0 ? sby : 0, y1 = min(sby + cy, kGroupDimBlocks);
        const int x0 = sbx > 0 ? sbx : 0, x1 = min(sbx + cx, kGroupDimBlocks);
        for (int y = y0; y < y1; ++y)
          for (int x = x0; x < x1; ++x) s_nz[c * kNzArea + y * kGroupDimBlocks + x] = fill;
      }
      prev = nz_val > (nc >> 4) ? 0 : 1;
      if (bad) {
        err = true;
      } else if (nz_val > 0) {
        k = nb;
        nonzeros = nz_val;
      } else if (nz_val == 0) {
        ++item;
      }
    } else {
      const int mag = static_cast<int>((value + 1u) >> 1);
      int coeff = (value & 1u) ? static_cast<int>(0u - static_cast<unsigned>(mag))
                               : static_cast<int>(value >> 1);
      coeff = static_cast<int>(static_cast<unsigned>(coeff) << shift);
      int oi = order_base + order_off + (k > 0 ? k : 0);
      oi = oi < 0 ? 0 : (oi > a.O - 1 ? a.O - 1 : oi);
      const int dest = coeff_base + coeffs_off + a.orders[oi];
      if (dest >= 0 && dest < a.total && coeff != 0) atomicAdd(a.coeffs + dest, coeff);
      const int is_nz = coeff != 0 ? 1 : 0;
      const int nz_after = nonzeros - is_nz;
      if (nz_after > 0 && k + 1 >= nc) err = true;
      if (nz_after == 0 || k + 1 >= nc) {
        ++item;
        k = -1;
      } else {
        ++k;
      }
      nonzeros = nz_after;
      prev = is_nz;
    }
  }
  a.ok[lane] = (!err && item >= n_items && state == 0x130000u &&
                bitpos <= a.lane_end_bits[lane]) ? 1 : 0;
}

}  // namespace

extern "C" {

int ans_decode_lanes_launch(const void* streams, int S, int L, const void* table, int NB,
                            int log_bucket, int T, void* tokens, void* final_states,
                            void* stream) {
  if (S <= 0) return 0;
  const int threads = 64;
  const size_t smem = static_cast<size_t>(5) * NB * sizeof(int);
  ans_decode_lanes_kernel<<<(S + threads - 1) / threads, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), S, L, static_cast<const int*>(table), NB,
      log_bucket, T, static_cast<int*>(tokens), static_cast<unsigned*>(final_states));
  return static_cast<int>(cudaGetLastError());
}

// Shared memory K3 may take for the packed tables (the nonzeros map takes
// another 12 KB); larger tables are read from global memory.
constexpr size_t kMaxSharedTables = 160 * 1024;

int ac_sections_launch(const void* streams, int S, int L, const void* start_bits,
                       const void* lane_group, const void* lane_ctx_off,
                       const void* lane_shift, const void* lane_order_base,
                       const void* lane_coeff_base, const void* lane_n_items,
                       const void* lane_end_bits, const void* items, int I,
                       const void* orders, int O, const void* tables, int C, int NB,
                       const void* uint_cfgs, const void* context_map, int NC,
                       int log_bucket, int num_bctx, int total, void* coeffs, void* ok,
                       void* stream) {
  if (S <= 0) return 0;
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
  a.tables = static_cast<const int*>(tables);
  a.C = C;
  a.NB = NB;
  a.uint_cfgs = static_cast<const int*>(uint_cfgs);
  a.context_map = static_cast<const int*>(context_map);
  a.NC = NC;
  a.log_bucket = log_bucket;
  a.num_bctx = num_bctx;
  a.total = total;
  a.coeffs = static_cast<int*>(coeffs);
  a.ok = static_cast<uint8_t*>(ok);
  const size_t tbytes = static_cast<size_t>(C) * 5 * NB * sizeof(int);
  a.tables_in_shared = tbytes <= kMaxSharedTables ? 1 : 0;
  const size_t smem = a.tables_in_shared ? tbytes : 0;
  cudaError_t e = cudaFuncSetAttribute(ac_sections_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kMaxSharedTables));
  if (e != cudaSuccess) return static_cast<int>(e);
  ac_sections_kernel<<<S, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* ans_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
