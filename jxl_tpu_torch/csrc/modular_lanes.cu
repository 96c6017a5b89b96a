// K6: the group streams of a Modular frame, one lane a stream, on Hopper
// (sm_90a).
//
// A lane decodes one group section's sub-bitstream after its GroupHeader,
// as native/modular_decode.cc:jxl_decode_modular's general tree loop does:
// its channels in order, each through its subtree of the frame's MA tree
// (pruned on properties 0 and 1 by the host, as PruneTreeForChannel does),
// properties 2-15 of every sample, the weighted predictor (WP) with the
// group's own WP header, the leaf's predictor (any of 0-13), offset and
// multiplier, one rANS symbol of the leaf's cluster and its HybridUint
// tail bits; then the final-state check (0x130000) and, when the
// GroupHeader has one, the group's inverse RCT in place over its first
// three channels. It writes the samples into the frame's int32 planes.
//
// Replaces no TPU kernel: jxl_tpu decodes these streams on the host (the
// native loop, jxl_tpu/native), and so did the port, 8 streams at a time
// on the host's threads at about 145 ns a sample.
//
// What bounds it on an H100. Each lane is one serial chain: a sample's
// tree walk needs the WP's error of the sample before it, the walk picks
// the cluster, the cluster's table row gives the rANS state the next
// symbol starts from, and the value feeds the next sample's predictions.
// The channels of a group share one rANS state, so a lane cannot be cut.
// A launch therefore takes the longest lane's samples (3 x 256 x 256 for a
// full RGB group) times the latency of one step; its bytes (the sections,
// about 10 MB at 4K, and the int32 planes) and operations are far below
// that, and 135 lanes leave the card's width almost unused.
//
// What the design does about the step's latency. A lane is one block of
// one warp, the blocks spread over the SMs, so nothing hides a stall: the
// step's time is its instructions and their dependent latencies.
//   - Nothing of the chain is a generic or device-memory load. Shared
//     memory holds the stream's bytes (a ring of two halves sized so that
//     a row's symbols fit one half: restaged by the warp between rows,
//     read as a 64-bit window a symbol, loaded one symbol ahead), the
//     three rows a sample reads (each goes to the plane by the warp when
//     it is complete), WP's error rows, each channel's pruned subtree with
//     each leaf's cluster and HybridUint configuration folded in (no
//     context map on the chain) and the packed alias tables, one 64-bit
//     word a bucket; when a subtree or the tables do not fit, a second
//     instantiation reads them from device memory through the read-only
//     cache.
//   - The warp's threads split what a sample needs of its neighbours:
//     thread t computes property t and prediction t, and the walk and the
//     leaf take theirs by a shuffle, so one thread's stream holds none of
//     the 14 properties' and 14 predictions' instructions but its own.
//   - The tree walk needs only WP's max error, so its levels are written
//     between WP's stages and the schedule overlaps the two chains; each
//     level loads both children of the chosen node beside the property
//     test (a leaf is its own child, so three levels run without a branch)
//     and deeper levels loop to the subtree's depth, known before the row.
//   - Register forwarding: what one sample leaves for the next (the sample,
//     WP's true error and the four predictor errors it adds to the row
//     above) passes in registers.
//   - Integer widths as the host loop: int64 only in WP's sums and
//     products, where int32 would wrap differently (the max error, from
//     int32 errors, compares in 32 bits).
// On an H100 80GB HBM3 the longest lane (a full RGB group, 196,608 steps)
// takes about 130 ms, some 660 ns a step: K3's token, 222 ns, has no WP
// and no walk (PERF.md section 6 gives the measured steps).
// The host (ops/modular_lanes.py, modular/group_lanes.py) reads each
// GroupHeader, packs one lane table, uploads the sections' bytes once and
// reads each lane's status word after the launch.
//
// Status a lane: 0, or the host loop's codes: 2 when the stream ran past
// its section's end, 1 when its final rANS state is not 0x130000.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;        // one warp a lane
constexpr unsigned kFinalState = 0x130000u;
// the lane table, int64 fields a lane and a channel (ops/modular_lanes.py)
constexpr int kLaneFields = 18;     // byte_off, byte_len, start_bit, stream_id, rct,
                                    // first_chan, num_chans, then the 11 WP numbers
constexpr int kChanFields = 10;     // plane, x0, y0, w, h, stride, node_off, n_nodes,
                                    // uses_wp, depth
constexpr int kMaxSymbolBits = 47;  // a renorm (16) and a HybridUint tail (31)
constexpr int kWalkUnrolled = 3;    // tree levels walked without a branch

struct Args {
  const uint8_t* bytes;
  long long nbytes;
  const long long* lanes;
  int L;
  const long long* chans;
  const int4* nodes;        // two int4 a node: the node, then a leaf's payload
  const unsigned long long* tab;
  int tab_words;
  int log_bucket;
  int table_size;
  const long long* planes;  // int32* of each plane
  int* status;
  int wmax;                 // widest channel of the launch
  int node_cap;             // nodes of a subtree in shared memory (kShared)
};

// words of a half of the stream's ring: a row's symbols (at most
// kMaxSymbolBits a sample) and the window past them fit in one half, so
// the ring is restaged only between rows
__host__ __device__ inline int ring_half_of(int wmax) {
  const int need = (wmax * kMaxSymbolBits + 31) / 32 + 4;
  int h = 512;
  while (h < need) h *= 2;
  return h;
}

// the shared-memory layout of a lane, in bytes from the block's base
struct Layout {
  int ring_half, ring, rows, row_pitch, err, pe, div, nodes, tab, total;
};

// kShared: each channel's subtree and the alias tables in shared memory
__host__ __device__ inline Layout layout_of(int wmax, int node_cap, int tab_words, bool shared) {
  Layout l;
  l.ring_half = ring_half_of(wmax);
  l.row_pitch = wmax + 8;                    // a row and its margins, int32
  l.ring = 0;                                // 2 halves of uint32
  l.rows = l.ring + 2 * l.ring_half * 4;     // 3 rows
  l.err = l.rows + 3 * l.row_pitch * 4;      // WP's true errors: 2 rows of wmax + 1
  l.pe = l.err + 2 * (wmax + 1) * 4;         // WP's predictor errors: 4 x 2 rows
  l.div = l.pe + 8 * (wmax + 1) * 4;         // (1 << 24) / (i + 1), 64 entries
  l.nodes = (l.div + 64 * 4 + 15) & ~15;     // the channel's subtree, 32 bytes a node
  l.tab = l.nodes + (shared ? node_cap * 32 : 0);  // packed alias tables, 8 bytes a bucket
  l.total = l.tab + (shared ? tab_words * 8 : 0);
  return l;
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wrap_abs(int32_t a) {
  return a < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(a)) : a;
}
__device__ __forceinline__ long long abs64(long long v) { return v < 0 ? -v : v; }

// Thread t of a lane's warp computes property t and prediction t of each
// sample; the walk and the leaf take theirs from it by a shuffle.
//
// Property p (2-15, the native general loop's): a wrapping sum of the
// neighbours W, N, NW, NE, NN, WW and the sample before's property 9 with
// coefficients -1, 0 or 1 (kind 0), its absolute value (1), or y (2), x
// (3), WP's max error (4).
struct PropCoef {
  int l, t, tl, tr, tt, ll, o9, kind;
};

__host__ __device__ inline PropCoef prop_coef(int p) {
  PropCoef c{0, 0, 0, 0, 0, 0, 0, 0};
  switch (p) {
    case 2: c.kind = 2; break;
    case 3: c.kind = 3; break;
    case 4: c.t = 1; c.kind = 1; break;
    case 5: c.l = 1; c.kind = 1; break;
    case 6: c.t = 1; break;
    case 7: c.l = 1; break;
    case 8: c.l = 1; c.o9 = -1; break;
    case 9: c.l = 1; c.t = 1; c.tl = -1; break;
    case 10: c.l = 1; c.tl = -1; break;
    case 11: c.tl = 1; c.t = -1; break;
    case 12: c.t = 1; c.tr = -1; break;
    case 13: c.t = 1; c.tt = -1; break;
    case 14: c.l = 1; c.ll = -1; break;
    case 15: c.kind = 4; break;
    default: break;
  }
  return c;
}

__device__ __forceinline__ int32_t prop_value(const PropCoef& c, int32_t y, int32_t x, int32_t l,
                                              int32_t t, int32_t tl, int32_t tr, int32_t tt,
                                              int32_t ll, int32_t o9, int32_t wp_prop) {
  auto u = [](int v) { return static_cast<uint32_t>(v); };
  const int32_t s = static_cast<int32_t>(u(c.l) * u(l) + u(c.t) * u(t) + u(c.tl) * u(tl) +
                                         u(c.tr) * u(tr) + u(c.tt) * u(tt) + u(c.ll) * u(ll) +
                                         u(c.o9) * u(o9));
  const int32_t v = c.kind == 1 ? wrap_abs(s) : s;
  return c.kind == 2 ? y : (c.kind == 3 ? x : (c.kind == 4 ? wp_prop : v));
}

// Prediction p (0-13, native PredictOne): a sum of the neighbours W, N,
// NW, NE, NN, WW, NEE with small coefficients and a bias, divided by
// 2^shift toward zero (kind 0), or Select (1), the clamped gradient (2),
// WP (3).
struct PredCoef {
  int l, t, tl, tr, tt, ll, trr, bias, shift, kind;
};

__host__ __device__ inline PredCoef pred_coef(int p) {
  PredCoef c{0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  switch (p) {
    case 0: break;
    case 1: c.l = 1; break;
    case 2: c.t = 1; break;
    case 3: c.t = 1; c.l = 1; c.shift = 1; break;
    case 4: c.kind = 1; break;
    case 5: c.kind = 2; break;
    case 6: c.kind = 3; break;
    case 7: c.tr = 1; break;
    case 8: c.tl = 1; break;
    case 9: c.ll = 1; break;
    case 10: c.l = 1; c.tl = 1; c.shift = 1; break;
    case 11: c.t = 1; c.tl = 1; c.shift = 1; break;
    case 12: c.t = 1; c.tr = 1; c.shift = 1; break;
    default:
      c.t = 6; c.tt = -2; c.l = 7; c.ll = 1; c.trr = 1; c.tr = 3; c.bias = 8; c.shift = 4;
      break;
  }
  return c;
}

__device__ __forceinline__ long long pred_value(const PredCoef& c, long long l, long long t,
                                                long long tl, long long tr, long long tt,
                                                long long ll, long long trr, long long wp) {
  long long s = c.l * l + c.t * t + c.tl * tl + c.tr * tr + c.tt * tt + c.ll * ll + c.trr * trr +
                c.bias;
  s = (s < 0 ? s + ((1LL << c.shift) - 1) : s) >> c.shift;
  const long long q = l + t - tl;
  const long long sel = abs64(q - l) < abs64(q - t) ? l : t;
  const long long mn = l < t ? l : t, mx = l > t ? l : t;
  const long long grad = tl < mn ? mx : (tl > mx ? mn : q);
  return c.kind == 1 ? sel : (c.kind == 2 ? grad : (c.kind == 3 ? wp : s));
}

// floor(log2(v + 1)) of a uint32 v, v + 1 taken without wrapping
__device__ __forceinline__ int log2_plus1(uint32_t v) {
  const uint32_t v1 = v + 1u;
  return v1 != 0u ? 31 - __clz(static_cast<int>(v1)) : 32;
}

// word wi of a lane's stream (its section's bytes from the aligned byte
// wb), zero past the section's end
__device__ __forceinline__ uint32_t stream_word(const uint8_t* bytes, long long wb, long long end,
                                                long long wi) {
  const long long a = wb + 4 * wi;
  if (a + 4 <= end) return *reinterpret_cast<const uint32_t*>(bytes + a);
  uint32_t w = 0;
  for (int b = 0; b < 4; ++b)
    if (a + b < end) w |= static_cast<uint32_t>(bytes[a + b]) << (8 * b);
  return w;
}

__device__ __noinline__ void stage_half(uint32_t* ring, int half_words, const uint8_t* bytes,
                                        long long wb, long long end, long long half, int tid,
                                        int nthr) {
  const long long first = half * half_words;
  uint32_t* dst = ring + (half & 1) * half_words;
  for (int j = tid; j < half_words; j += nthr) dst[j] = stream_word(bytes, wb, end, first + j);
}

// One lane, run by each of the block's nthr threads alike (tid is the
// thread's index): every value of the chain is uniform over them. With
// kShared the subtrees and tables are read from shared memory, else from
// device memory through the read-only cache; the pointers are known to
// the compiler either way, so no load of the chain is a generic one.
template <bool kShared>
__device__ void decode_lane(const Args& a, int lane, int tid, int nthr, unsigned char* smem) {
  const Layout lay = layout_of(a.wmax, a.node_cap, a.tab_words, kShared);
  const int H = lay.ring_half;
  const long long ring_mask = 2 * H - 1;
  uint32_t* s_ring = reinterpret_cast<uint32_t*>(smem + lay.ring);
  int32_t* s_rows = reinterpret_cast<int32_t*>(smem + lay.rows) + 4;
  int32_t* s_err = reinterpret_cast<int32_t*>(smem + lay.err);
  uint32_t* s_pe = reinterpret_cast<uint32_t*>(smem + lay.pe);
  uint32_t* s_div = reinterpret_cast<uint32_t*>(smem + lay.div);
  int4* s_nodes = reinterpret_cast<int4*>(smem + lay.nodes);
  unsigned long long* s_tab = reinterpret_cast<unsigned long long*>(smem + lay.tab);
  auto tab_at = [&](int i) { return kShared ? s_tab[i] : __ldg(a.tab + i); };

  const long long* ln = a.lanes + static_cast<long long>(lane) * kLaneFields;
  const long long byte_off = ln[0], byte_len = ln[1];
  const long long wb = byte_off & ~3LL;
  const long long end = byte_off + byte_len < a.nbytes ? byte_off + byte_len : a.nbytes;
  const long long bit0 = (byte_off - wb) * 8;
  const long long end_bits = bit0 + byte_len * 8;  // past it the stream has overrun
  const int rct = static_cast<int>(ln[4]);
  const long long first_chan = ln[5];
  const int num_chans = static_cast<int>(ln[6]);
  const int p1c = static_cast<int>(ln[7]), p2c = static_cast<int>(ln[8]);
  const int p3c0 = static_cast<int>(ln[9]), p3c1 = static_cast<int>(ln[10]),
            p3c2 = static_cast<int>(ln[11]), p3c3 = static_cast<int>(ln[12]),
            p3c4 = static_cast<int>(ln[13]);
  const uint32_t wk[4] = {static_cast<uint32_t>(ln[14]), static_cast<uint32_t>(ln[15]),
                          static_cast<uint32_t>(ln[16]), static_cast<uint32_t>(ln[17])};

  const PropCoef my_pc = prop_coef(tid & 15);
  const PredCoef my_dc = pred_coef(tid < 14 ? tid : 13);

  // ---- prologue: the warp stages the tables and the ring's two halves
  for (int j = tid; j < 64; j += nthr) s_div[j] = (1u << 24) / static_cast<unsigned>(j + 1);
  if (kShared)
    for (int j = tid; j < a.tab_words; j += nthr) s_tab[j] = a.tab[j];
  long long bp = bit0 + ln[2];
  {
    const long long half = (bp >> 5) / H;
    stage_half(s_ring, H, a.bytes, wb, end, half, tid, nthr);
    stage_half(s_ring, H, a.bytes, wb, end, half + 1, tid, nthr);
  }
  long long stage_at = ((bp >> 5) / H + 1) * H;  // the word that stages the next half
  __syncwarp();

  // 64 bits of the stream at the cursor, from the ring
  uint32_t lo, hi;
  auto window = [&]() {
    const long long wi = bp >> 5;
    const uint32_t w0 = s_ring[wi & ring_mask], w1 = s_ring[(wi + 1) & ring_mask],
                   w2 = s_ring[(wi + 2) & ring_mask];
    const unsigned sh = static_cast<unsigned>(bp & 31);
    lo = __funnelshift_r(w0, w1, sh);
    hi = __funnelshift_r(w1, w2, sh);
  };
  // between rows: restage until the ring holds the next row's symbols
  auto restage = [&]() {
    while ((bp >> 5) >= stage_at) {
      __syncwarp();
      stage_half(s_ring, H, a.bytes, wb, end, stage_at / H + 1, tid, nthr);
      __syncwarp();
      stage_at += H;
    }
    window();
  };

  window();
  uint32_t state = lo;
  bp += 32;
  window();
  const int lb = a.log_bucket;
  const uint32_t bmask = (1u << lb) - 1u;
  const int ts = a.table_size;

  // one rANS symbol of the cluster and its HybridUint value (native
  // ReadToken, ReadUintCfg) from the window at the cursor; cfg = cluster |
  // split_exponent << 8 | msb << 16 | lsb << 24. Loads the next window.
  auto decode = [&](int cfg) -> uint32_t {
    const int cluster = cfg & 0xFF;
    const uint32_t idx = state & 0xFFFu;
    const uint32_t i = idx >> lb, pos = idx & bmask;
    const unsigned long long e = tab_at(cluster * ts + static_cast<int>(i));
    const uint32_t cutoff = static_cast<uint32_t>(e >> 21) & 0x1FFFu;
    const bool alias = pos >= cutoff;
    const uint32_t sym = alias ? static_cast<uint32_t>(e) & 0xFFu : i;
    const uint32_t off = alias ? (static_cast<uint32_t>(e >> 8) & 0x1FFFu) + pos : pos;
    const uint32_t d = alias ? static_cast<uint32_t>(e >> 47) & 0x1FFFu
                             : static_cast<uint32_t>(e >> 34) & 0x1FFFu;
    const uint32_t ns = (state >> 12) * d + off;
    const bool renorm = ns < (1u << 16);
    state = renorm ? ((ns << 16) | (lo & 0xFFFFu)) : ns;
    const uint32_t rest = renorm ? __funnelshift_r(lo, hi, 16) : lo;
    const uint32_t se = static_cast<uint32_t>(cfg >> 8) & 0xFFu;
    const uint32_t msb = static_cast<uint32_t>(cfg >> 16) & 0xFFu;
    const uint32_t lsb = static_cast<uint32_t>(cfg >> 24) & 0xFFu;
    const uint32_t split = 1u << se;
    const bool tail = sym >= split;
    const uint32_t bit = msb + lsb;
    const uint32_t nbits = tail ? ((se - bit + ((sym - split) >> bit)) & 31u) : 0u;
    const uint32_t raw = rest & ((1u << nbits) - 1u);
    const uint32_t low = sym & ((1u << lsb) - 1u);
    const uint32_t hib = ((sym >> lsb) & ((1u << msb) - 1u)) | (1u << msb);
    bp += (renorm ? 16 : 0) + static_cast<long long>(nbits);
    window();
    return tail ? ((((hib << nbits) | raw) << lsb) | low) : sym;
  };

  int status = 0;
  for (int ci = 0; ci < num_chans; ++ci) {
    const long long* ch = a.chans + (first_chan + ci) * kChanFields;
    const int w = static_cast<int>(ch[3]), h = static_cast<int>(ch[4]);
    if (w == 0 || h == 0) continue;
    int32_t* plane = reinterpret_cast<int32_t*>(static_cast<intptr_t>(a.planes[ch[0]]));
    int32_t* out = plane + ch[2] * ch[5] + ch[1];
    const long long stride = ch[5];
    const int n_nodes = static_cast<int>(ch[7]);
    const int4* g_nodes = a.nodes + 2 * ch[6];
    __syncwarp();
    if (kShared)
      for (int j = tid; j < 2 * n_nodes; j += nthr) s_nodes[j] = g_nodes[j];
    auto node = [&](int i) { return kShared ? s_nodes[i] : __ldg(g_nodes + i); };
    const int W1 = w + 1;
    for (int j = tid; j < 2 * W1; j += nthr) s_err[j] = 0;
    for (int j = tid; j < 8 * W1; j += nthr) s_pe[j] = 0;
    __syncwarp();
    const int depth = static_cast<int>(ch[9]);  // splits on the subtree's longest path
    const int4 root = node(0);
    const int4 root_gt = node(2 * root.z), root_le = node(2 * root.w);
    const int row_pitch = lay.row_pitch;

    // the rows of the channel; kWP: its subtree reads WP
    auto rows = [&](auto wp_tag) {
      constexpr bool kWP = decltype(wp_tag)::value;
      for (int y = 0; y < h; ++y) {
        restage();
        int32_t* row = s_rows + (y % 3) * row_pitch;
        const int32_t* prev = s_rows + ((y + 2) % 3) * row_pitch;
        const int32_t* pp = s_rows + ((y + 1) % 3) * row_pitch;
        const bool has_top = y > 0, has_toptop = y > 1;
        // WP's rows: cur_row and prev_row as the host loop alternates them
        const int cur_row = (y & 1) ? 0 : W1, prev_row = (y & 1) ? W1 : 0;
        int32_t* err_cur = s_err + cur_row;
        const int32_t* err_prev = s_err + prev_row + 1;
        int32_t left = has_top ? prev[0] : 0;
        int32_t old9 = 0;
        // forwarded from the sample before: WP's true error (0 at x = 0, the
        // error row's unwritten first entry) and, for each predictor, its
        // error of the row above at x with what the sample before added
        int32_t te_w = 0;
        uint32_t pe_x[4] = {0, 0, 0, 0};
        if (kWP)
          for (int k = 0; k < 4; ++k) pe_x[k] = s_pe[k * 2 * W1 + prev_row];
        for (int x = 0; x < w; ++x) {
          const bool has_left = x > 0, has_ne = x + 1 < w;
          const int32_t top = has_top ? prev[x] : left;
          const int32_t topleft = has_top && has_left ? prev[x - 1] : left;
          const int32_t topright = has_top ? (has_ne ? prev[x + 1] : top) : left;
          const int32_t trr = has_top ? (x + 2 < w ? prev[x + 2] : topright) : left;
          const int32_t leftleft = x > 1 ? row[x - 2] : left;
          const int32_t toptop = has_toptop ? pp[x] : top;

          // The WP chain and the tree walk are independent until the guess:
          // the walk needs only WP's max error. Their stages are written in
          // turns so that the schedule overlaps the two chains.
          // -- WP 1: the max error (property 15) and the error sums
          long long te_n = 0, te_nw = 0, te_ne = 0;
          int32_t wp_prop = 0;
          uint32_t pe_ne[4] = {0, 0, 0, 0}, esum[4] = {0, 0, 0, 0};
          if (kWP) {
            const int pos_ne = has_ne ? x + 1 : x, pos_nw = has_left ? x - 1 : 0;
            te_n = err_prev[x];
            te_nw = err_prev[pos_nw];
            te_ne = err_prev[pos_ne];
            int32_t p = te_w;
            uint32_t pa = static_cast<uint32_t>(wrap_abs(te_w));
            const int32_t tn = static_cast<int32_t>(te_n), tnw = static_cast<int32_t>(te_nw),
                          tne = static_cast<int32_t>(te_ne);
            const uint32_t an = static_cast<uint32_t>(wrap_abs(tn)),
                           anw = static_cast<uint32_t>(wrap_abs(tnw)),
                           ane = static_cast<uint32_t>(wrap_abs(tne));
            if (an > pa) { p = tn; pa = an; }
            if (anw > pa) { p = tnw; pa = anw; }
            if (ane > pa) p = tne;
            wp_prop = p;
            for (int k = 0; k < 4; ++k) {
              const uint32_t* pe = s_pe + k * 2 * W1 + prev_row;
              pe_ne[k] = has_ne ? pe[x + 1] : pe_x[k];
              esum[k] = pe_x[k] + pe_ne[k] + (has_left ? pe[x - 1] : pe_x[k]);
            }
          }

          // -- walk 1: the properties (thread t computes property t; a node
          // takes the one it reads by a shuffle) and the root's test; the
          // chosen child's children load at once (a leaf is its own child)
          const int32_t o9 = old9;
          old9 = wrap_sub(wrap_add(left, top), topleft);
          const int32_t my_prop = prop_value(my_pc, y, x, left, top, topleft, topright, toptop,
                                             leftleft, o9, wp_prop);
          auto prop = [&](int p) { return __shfl_sync(0xFFFFFFFFu, my_prop, p & 15); };
          const bool g0 = prop(root.x) > root.y;
          int at = g0 ? root.z : root.w;
          int4 n = g0 ? root_gt : root_le;
          int4 cg = node(2 * n.z), cl = node(2 * n.w);

          // -- WP 2: the four weights
          uint32_t ws[4] = {0, 0, 0, 0};
          if (kWP)
            for (int k = 0; k < 4; ++k) {
              const int lg = log2_plus1(esum[k]);
              const int sh = lg > 5 ? lg - 5 : 0;
              ws[k] = 4u + ((wk[k] * s_div[esum[k] >> sh]) >> sh);
            }

          // -- walk 2
          {
            const bool gt = prop(n.x) > n.y;
            at = gt ? n.z : n.w;
            n = gt ? cg : cl;
            cg = node(2 * n.z);
            cl = node(2 * n.w);
          }

          // -- WP 3: the four predictions and their weighted sum
          long long pr0 = 0, pr1 = 0, pr2 = 0, pr3 = 0, ssum = 0;
          int weight_sum = 1;
          const long long n8 = static_cast<long long>(top) * 8;
          const long long w8 = static_cast<long long>(left) * 8;
          const long long ne8 = static_cast<long long>(topright) * 8;
          if (kWP) {
            const long long nw8 = static_cast<long long>(topleft) * 8;
            const long long nn8 = static_cast<long long>(toptop) * 8;
            const long long sum_wn = te_n + te_w;
            pr0 = w8 + ne8 - n8;
            pr1 = n8 - (((sum_wn + te_ne) * p1c) >> 5);
            pr2 = w8 - (((sum_wn + te_nw) * p2c) >> 5);
            pr3 = n8 - ((te_nw * p3c0 + te_n * p3c1 + te_ne * p3c2 + (nn8 - n8) * p3c3 +
                         (nw8 - w8) * p3c4) >> 5);
            const uint32_t wsum = ws[0] + ws[1] + ws[2] + ws[3];  // below 2^30
            const int sh = 27 - __clz(static_cast<int>(wsum));      // log2(wsum) - 4
            const int w0s = ws[0] >> sh, w1s = ws[1] >> sh, w2s = ws[2] >> sh,
                      w3s = ws[3] >> sh;
            weight_sum = w0s + w1s + w2s + w3s;
            ssum = (weight_sum >> 1) - 1 + w0s * pr0 + w1s * pr1 + w2s * pr2 + w3s * pr3;
          }

          // -- walk 3, then the levels past the unrolled ones (depth: the
          // subtree's longest path, so the loop's bound is known ahead)
          {
            const bool gt = prop(n.x) > n.y;
            at = gt ? n.z : n.w;
            n = gt ? cg : cl;
          }
          for (int lvl = kWalkUnrolled; lvl < depth; ++lvl) {
            const bool gt = prop(n.x) > n.y;
            at = gt ? n.z : n.w;
            n = node(2 * at);
          }
          // the leaf's payload: predictor, offset, multiplier, cluster and
          // HybridUint config
          const int4 leaf = node(2 * at + 1);

          // -- WP 4: the prediction
          long long prd = 0, wp_pred = 0;
          if (kWP) {
            prd = (ssum * static_cast<long long>(s_div[weight_sum - 1])) >> 24;
            if (((te_n ^ te_w) | (te_n ^ te_nw)) <= 0) {
              const long long mx = max(max(w8, ne8), n8), mn = min(min(w8, ne8), n8);
              prd = prd > mx ? mx : (prd < mn ? mn : prd);
            }
            wp_pred = (prd + 3) >> 3;
          }
          const long long my_pred = pred_value(my_dc, left, top, topleft, topright, toptop,
                                               leftleft, trr, wp_pred);
          const long long guess = __shfl_sync(0xFFFFFFFFu, my_pred, leaf.x) + leaf.y;
          const uint32_t u = decode(leaf.w);
          const int32_t decd = (u & 1u) ? -static_cast<int32_t>((u + 1u) >> 1)
                                        : static_cast<int32_t>(u >> 1);
          const int32_t val = static_cast<int32_t>(guess + static_cast<long long>(leaf.z) * decd);
          row[x] = val;
          if (kWP) {
            // native WPState::UpdateErrors; what the next sample reads of it
            // stays in registers (at the row's last sample, the entry x + 1
            // = w that gains e is never read)
            const long long v8 = static_cast<long long>(val) * 8;
            te_w = static_cast<int32_t>(prd - v8);
            err_cur[x + 1] = te_w;
            const long long prk[4] = {pr0, pr1, pr2, pr3};
            for (int k = 0; k < 4; ++k) {
              const uint32_t e = static_cast<uint32_t>((abs64(prk[k] - v8) + 3) >> 3);
              uint32_t* pe = s_pe + k * 2 * W1;
              pe[cur_row + x] = e;
              pe_x[k] = pe_ne[k] + e;
              pe[prev_row + x + 1] = pe_x[k];
            }
          }
          left = val;
        }
        // the row into the plane
        __syncwarp();
        for (int j = tid; j < w; j += nthr) out[y * stride + j] = row[j];
      }
    };
    if (ch[8] != 0)
      rows(std::true_type{});
    else
      rows(std::false_type{});
    if (bp > end_bits) {
      status = 2;
      break;
    }
  }
  if (status == 0 && bp > end_bits) status = 2;
  if (status == 0 && state != kFinalState) status = 1;
  if (status == 0 && rct >= 0) {
    // the group's inverse RCT over its first three channels (native
    // jxl_rct): type rct % 7, permutation rct / 7
    __syncwarp();
    const long long* c0 = a.chans + first_chan * kChanFields;
    int32_t* base[3];
    long long stride[3];
    for (int c = 0; c < 3; ++c) {
      const long long* ch = c0 + c * kChanFields;
      stride[c] = ch[5];
      base[c] = reinterpret_cast<int32_t*>(static_cast<intptr_t>(a.planes[ch[0]])) +
                ch[2] * ch[5] + ch[1];
    }
    const int op = rct % 7, perm = rct / 7;
    const int w = static_cast<int>(c0[3]), h = static_cast<int>(c0[4]);
    const int n = w * h;
    for (int j = tid; j < n; j += nthr) {
      const int yy = j / w, xx = j - yy * w;
      int32_t* p0 = base[0] + yy * stride[0] + xx;
      int32_t* p1 = base[1] + yy * stride[1] + xx;
      int32_t* p2 = base[2] + yy * stride[2] + xx;
      int32_t v0 = *p0, v1 = *p1, v2 = *p2;
      switch (op) {
        case 1: v2 = wrap_add(v2, v0); break;
        case 2: v1 = wrap_add(v1, v0); break;
        case 3: v1 = wrap_add(v1, v0); v2 = wrap_add(v2, v0); break;
        case 4: v1 = wrap_add(v1, wrap_add(v0, v2) >> 1); break;
        case 5: v2 = wrap_add(v2, v0); v1 = wrap_add(v1, wrap_add(v0, v2) >> 1); break;
        case 6: {
          int32_t yv = wrap_sub(v0, v2 >> 1);
          const int32_t g = wrap_add(v2, yv);
          yv = wrap_sub(yv, v1 >> 1);
          v0 = wrap_add(yv, v1);
          v1 = g;
          v2 = yv;
          break;
        }
        default: break;
      }
      // out slot s gets res[src[s]] (modular/transforms.py:_RCT_PERM)
      const int32_t res[3] = {v0, v1, v2};
      constexpr int kPerm[6][3] = {{0, 1, 2}, {2, 0, 1}, {1, 2, 0}, {0, 2, 1}, {1, 0, 2}, {2, 1, 0}};
      *p0 = res[kPerm[perm][0]];
      *p1 = res[kPerm[perm][1]];
      *p2 = res[kPerm[perm][2]];
    }
  }
  if (tid == 0) a.status[lane] = status;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1) modular_lanes_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  decode_lane<kShared>(a, blockIdx.x, threadIdx.x, kThreads, smem);
}

template <bool kShared>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  const int smem = layout_of(a.wmax, a.node_cap, a.tab_words, kShared).total;
  auto kern = modular_lanes_kernel<kShared>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<a.L, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int modular_lanes_launch(const void* bytes, long long nbytes, const void* lanes, int L,
                         const void* chans, const void* nodes, const void* tab, int tab_words,
                         int log_bucket, int table_size, const void* planes, void* status,
                         int wmax, int node_cap, int shared, void* stream) {
  if (L <= 0) return 0;
  if (wmax < 1 || node_cap < 1 || log_bucket < 0 || log_bucket > 12 || table_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.bytes = static_cast<const uint8_t*>(bytes);
  a.nbytes = nbytes;
  a.lanes = static_cast<const long long*>(lanes);
  a.L = L;
  a.chans = static_cast<const long long*>(chans);
  a.nodes = static_cast<const int4*>(nodes);
  a.tab = static_cast<const unsigned long long*>(tab);
  a.tab_words = tab_words;
  a.log_bucket = log_bucket;
  a.table_size = table_size;
  a.planes = static_cast<const long long*>(planes);
  a.status = static_cast<int*>(status);
  a.wmax = wmax;
  a.node_cap = node_cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(shared ? launch_lanes<true>(a, st) : launch_lanes<false>(a, st));
}

const char* modular_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
