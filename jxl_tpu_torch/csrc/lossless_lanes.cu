// K4: the clamped-gradient wavefront of lossless Modular, for Hopper (sm_90a).
//
// Replaces jxl_tpu/modular/device_lossless.py:wavefront (:122), the
// lax.scan over anti-diagonals that reconstructs a batch of channels coded
// with the static Gradient predictor from their raw residuals. Each lane
// is one channel of one stream: residuals r (int16 on the wire when they
// fit, else int32) in, int32 samples v out,
//
//   v[0][x] = v[0][x-1] + r[0][x]           (row 0: a West chain)
//   v[y][0] = v[y-1][0] + r[y][0]           (column 0: a North chain)
//   v[y][x] = ClampedGradient(v[y][x-1], v[y-1][x], v[y-1][x-1]) + r[y][x]
//
// as native/modular_decode.cc's jxl_gradient_reconstruct and
// ops/lossless_lanes.py's wavefront_plain compute it: the clamp in its
// select form (top-left below both neighbours gives the larger, above
// both the smaller, else l + t - tl, which then lies between them and
// cannot overflow), the adds in uint32 so that a wrap is defined.
//
// Bound on an H100: the bytes (6 or 8 a sample, each residual read once
// and each sample written once) against the latency of one lane's chain:
// cell (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1). A 4K frame's 270
// lanes of 256x256 fill the card's SMs two deep (a few three), so the time
// is a lane's chain of steps at the cost of a step, stretched by what the
// lanes of an SM share: its issue slots, shared memory and the device
// memory traffic of all SMs. The design makes a step a shuffle and four
// dependent integer operations, keeps every access of the chain in
// shared memory, and moves device memory in coalesced rows:
//
// - One block a lane, kWarps warps. A warp owns a strip of kRows = 32
//   rows: lane k walks row y0 + k left to right, one column behind lane
//   k - 1. At step s it computes column x = s - k: l is its own previous
//   value, t = v[y-1][x] is lane k - 1's previous value (__shfl_up_sync),
//   tl is the t it received the step before. No barrier inside a strip;
//   no branch in a step (gradient_step), no test for row 0 or column 0
//   (zeros stand in for what lies above and to the left).
// - Strips are pipelined over the block's warps: strip q runs on warp
//   q % kWarps, so a lane taller than kWarps * 32 rows loops. Lane 0 of a
//   strip reads the row above from the edge ring of the strip above: a
//   full row of shared memory a warp, filled kHalf = 16 columns at a time
//   from the producer's bottom row and signalled by a flag in shared
//   memory (release: fence, then the flag; acquire: spin on the flag,
//   then fence). A strip waits once every 16 steps, 48 steps behind the
//   strip above, never at a block-wide barrier. A ring is rewritten only
//   by its producer's next strip, which transitively waits on the
//   consumer having read each column, so the ring needs no back-pressure.
// - Residuals arrive as tiles of 32 rows x 32 columns in shared memory:
//   a half's 16 rows are loaded coalesced into registers before its steps
//   and stored into the tile after them. The step reads its residual from
//   the tile and writes its sample in place; rows finished in an earlier
//   half go back to device memory as coalesced row segments. When every
//   row of a lane starts on 16 bytes (the decoder's lanes) the loads and
//   stores are 16 bytes a lane, four or eight rows an instruction, and
//   the loads ask L2 for the 256 bytes around them; otherwise they are
//   2- or 4-byte words, a row an instruction. Device memory instructions
//   cost a warp far more than shared ones, and interleaved with the steps
//   they slowed the chain, so each half runs them apart from the steps.
// - The tile is skewed: row k holds column x at word (x + k) mod 64, with
//   a row pitch of 66 words. A half's 16 steps use words s0 .. s0 + 15 of
//   each lane's row, read and written as 8-byte pairs (half a warp a pass,
//   banks 2k .. 2k + 1); a row segment of 32 columns lies on 32
//   consecutive words mod 64 of one row: no conflict either. Two chunks
//   (64 columns) are live a row: the one being finished and the next.
//
// Lanes are packed back to back in one flat buffer, each with its own
// (h, w); the (h, w) of up to kMaxLanes lanes travel as kernel parameters
// and each block sums the sizes before its own for its offset, so a launch
// uploads nothing.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;    // rows a strip: one a lane of the warp
constexpr int kChunk = 32;   // columns a staged tile
constexpr int kHalf = 16;    // steps between two hand-offs to the strip below
constexpr int kSpan = 64;    // columns a tile row holds: two chunks
// a row's words: 8-byte aligned, so that a half's residuals move as int2;
// rows 3 banks apart, so that the row segments of the write-back and the
// staging (4 or 8 rows an instruction) fall on 32 distinct banks
constexpr int kPitch = kSpan + 2;
constexpr int kMaxW = 4096;
// lanes a launch: 8 * kMaxLanes bytes of parameters, under the 4 KB that
// every CUDA version takes
constexpr int kMaxLanes = 480;

struct LaneDims {
  int hw[2 * kMaxLanes];  // (h, w) of each lane
};

// ClampedGradient(l, t, tl) + r in its select form, without a branch:
// tl clamped to [min(l, t), max(l, t)] is the median m of (l, tl, t), and
// l + t - m is max(l, t) when tl is below both, min(l, t) when above both
// and l + t - tl between; it lies in [min(l, t), max(l, t)], so its uint32
// sum is exact whatever wraps inside it. min(l, tl), max(l, tl) and
// l + r do not wait for t: after the shuffle, a step's chain is a min, a
// max and an add. (Written as selects, the compiler branched on them: a
// divergent branch and a reconvergence a step.)
__device__ __forceinline__ int32_t gradient_step(int32_t l, int32_t t, int32_t tl, int32_t r) {
  const int32_t m = max(min(l, tl), min(max(l, tl), t));
  return static_cast<int32_t>(static_cast<uint32_t>(l) + static_cast<uint32_t>(r) +
                              static_cast<uint32_t>(t) - static_cast<uint32_t>(m));
}

// words of an edge ring: a row of max_w columns, rounded up to a chunk
__host__ __device__ __forceinline__ int ring_words(int max_w) {
  return (max_w + kChunk - 1) / kChunk * kChunk;
}

size_t smem_bytes(int max_w) {
  return (static_cast<size_t>(kWarps) * kRows * kPitch +
          static_cast<size_t>(kWarps) * ring_words(max_w) + kWarps) * sizeof(int32_t);
}

// 16 bytes of a residual row, on the read-only path, asking L2 for the
// 256 bytes around them: the row's next chunks then come from L2, and
// DRAM sees fewer, longer reads than the 64-byte pieces of 16 rows
__device__ __forceinline__ uint4 ld_row(const void* p) {
  uint4 v;
  asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One strip: rows y0 .. y0 + rows - 1 of the lane, on one warp. Lane k's
// word s mod 64 of its tile row holds, at step s, column x = s - k: the
// residual until the step, the sample after it.
//
// Each half of 16 steps (iteration c, half 0 or 1, from step s0) moves one
// group of 16 rows: half 0 writes back rows 16..31 of chunk c - 2 and
// stages rows 16..31 of chunk c; half 1 writes back rows 0..15 of chunk
// c - 1 and stages rows 0..15 of chunk c + 1. The rows written back were
// finished before the half; the staged ones take their words, at
// steps s0 + 16 .. s0 + 62 mod 64, never the half's own s0 .. s0 + 15. A
// half: the wait for the row above, the loads of the staged rows, the 16
// steps, the hand-off of the bottom row, the write-back and the staging
// stores. The tests' _k4_model replays this schedule on the CPU.
template <typename In, bool kVec>
__device__ __forceinline__ void strip(const In* __restrict__ r, int32_t* __restrict__ v, int h,
                                      int w, int q, int32_t* tile, int32_t* rings,
                                      volatile int* ready, int rw, int lane) {
  const int nstrips = (h + kRows - 1) / kRows;
  const int nch = (w + kChunk - 1) / kChunk;
  const int y0 = q * kRows;
  const int rows = min(kRows, h - y0);
  const In* const rs = r + static_cast<long long>(y0) * w;
  int32_t* const vs = v + static_cast<long long>(y0) * w;
  // the ring this strip reads (the strip above's) and the one it fills;
  // a ring's flag counts the columns published, w a strip of its producer
  const int up_i = (q + kWarps - 1) % kWarps, dn_i = q % kWarps;
  const int32_t* const up = rings + up_i * rw;
  int32_t* const dn = rings + dn_i * rw;
  const int up_base = (q - 1) / kWarps * w;
  const int dn_base = q / kWarps * w;
  const bool feeds = q + 1 < nstrips;
  int32_t* const mine = tile + lane * kPitch;

  // Words 0..31 of each row start at 0: a lane's steps before its column
  // 0 then read r = 0 and, from the lane above, t = 0, so l and tl are
  // still 0 at column 0 and the step gives t + r (the North rule) with no
  // test. Strip 0 reads a row above of 0s, t = tl, and gets l + r (West).
#pragma unroll 8
  for (int i = 0; i < kChunk; ++i) mine[i] = 0;
  __syncwarp();
  // chunk 0's rows 0..15
#pragma unroll 4
  for (int i = 0; i < kHalf; ++i)
    tile[i * kPitch + ((lane + i) & (kSpan - 1))] =
        i < rows && lane < w ? static_cast<int32_t>(__ldg(rs + i * w + lane)) : 0;
  __syncwarp();

  int32_t l = 0, tp = 0, val = 0;
  int seen = 0;
  for (int c = 0; c <= nch; ++c) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int s0 = c * kChunk + half * kHalf;
      const int g0 = half == 0 ? kHalf : 0;        // the half's row group
      const int dcol = (half == 0 ? c - 2 : c - 1) * kChunk + lane;  // written back
      const int scol = (half == 0 ? c : c + 1) * kChunk + lane;      // staged
      const bool drain = dcol >= 0 && dcol < w;
      const bool stage = scol < nch * kChunk;
      const int n = rows - g0;  // rows of the group in the lane
      // the row above at columns s0 .. s0 + 15
      int32_t e[kHalf];
      if (q == 0 || s0 >= w) {
#pragma unroll
        for (int u = 0; u < kHalf; ++u) e[u] = 0;
      } else {
        const int need = up_base + min(s0 + kHalf, w);
        if (seen < need) {
          while ((seen = ready[up_i]) < need) {
          }
          __threadfence_block();
        }
        const int4* e4 = reinterpret_cast<const int4*>(up + s0);
#pragma unroll
        for (int j = 0; j < kHalf / 4; ++j) {
          const int4 q4 = e4[j];
          e[4 * j] = q4.x;
          e[4 * j + 1] = q4.y;
          e[4 * j + 2] = q4.z;
          e[4 * j + 3] = q4.w;
        }
      }
      // the staged rows, loaded now and stored after the steps (after the
      // wait: its fence waits for this thread's loads in flight). The
      // vector path: kV samples a lane in 16 bytes, 32 / kV lanes a row.
      constexpr int kV = 16 / sizeof(In);
      constexpr int kVRows = 32 / (kChunk / kV);  // rows a vector load
      const int scol0 = scol - lane;
      int32_t pf[kHalf];
      uint4 pv[kVec ? kHalf / kVRows : 1];
      if constexpr (kVec) {
        const int vc = scol0 + kV * (lane % (kChunk / kV));
#pragma unroll
        for (int m = 0; m < kHalf / kVRows; ++m) {
          const int y = g0 + m * kVRows + lane / (kChunk / kV);
          pv[m] = stage && vc < w && y < rows
                      ? ld_row(rs + static_cast<long long>(y) * w + vc)
                      : make_uint4(0, 0, 0, 0);
        }
      } else {
        const In* ps = rs + static_cast<long long>(g0) * w + scol;
        const bool ld = stage && scol < w;
#pragma unroll
        for (int i = 0; i < kHalf; ++i)
          pf[i] = ld && i < n ? static_cast<int32_t>(__ldg(ps + i * w)) : 0;
      }
      // the steps, on this lane's tile row at word s mod 64
      int2* const at = reinterpret_cast<int2*>(mine + (s0 & (kSpan - 1)));
      int32_t rr[kHalf];
#pragma unroll
      for (int u = 0; u < kHalf / 2; ++u) {
        const int2 p = at[u];
        rr[2 * u] = p.x;
        rr[2 * u + 1] = p.y;
      }
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {
        int32_t t = __shfl_up_sync(kFull, val, 1);
        t = lane == 0 ? e[u] : t;
        val = gradient_step(l, t, tp, rr[u]);
        rr[u] = val;
        tp = t;
        l = val;
      }
#pragma unroll
      for (int u = 0; u < kHalf / 2; ++u) at[u] = make_int2(rr[2 * u], rr[2 * u + 1]);
      __syncwarp();
      // the bottom row's columns of these steps (x = s - 31) to the strip below
      if (feeds) {
        const int x = s0 - (kRows - 1) + lane;
        if (lane < kHalf && x >= 0 && x < w)
          dn[x] = tile[(kRows - 1) * kPitch + (s0 & (kSpan - 1)) + lane];
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          ready[dn_i] = dn_base + min(max(s0 + kHalf - (kRows - 1), 0), w);
        }
      }
      // the rows written back, finished before this half, and the staged
      // rows into their words
      const int dcol0 = dcol - lane;
      if constexpr (kVec) {
        const int vc = dcol0 + 4 * (lane % 8);
        if (dcol0 >= 0) {
          // all four rows' words first: a store holds its source registers
          // until the memory pipe has read them
          int4 o[kHalf / 4];
#pragma unroll
          for (int m = 0; m < kHalf / 4; ++m) {
            const int y = g0 + 4 * m + lane / 8;
            o[m].x = tile[y * kPitch + ((vc + y) & (kSpan - 1))];
            o[m].y = tile[y * kPitch + ((vc + y + 1) & (kSpan - 1))];
            o[m].z = tile[y * kPitch + ((vc + y + 2) & (kSpan - 1))];
            o[m].w = tile[y * kPitch + ((vc + y + 3) & (kSpan - 1))];
          }
#pragma unroll
          for (int m = 0; m < kHalf / 4; ++m) {
            const int y = g0 + 4 * m + lane / 8;
            if (vc < w && y < rows)
              *reinterpret_cast<int4*>(vs + static_cast<long long>(y) * w + vc) = o[m];
          }
        }
        if (stage) {
          const int vc = scol0 + kV * (lane % (kChunk / kV));
#pragma unroll
          for (int m = 0; m < kHalf / kVRows; ++m) {
            const int y = g0 + m * kVRows + lane / (kChunk / kV);
            const uint32_t wd[4] = {pv[m].x, pv[m].y, pv[m].z, pv[m].w};
#pragma unroll
            for (int k = 0; k < kV; ++k) {
              int32_t x;
              if constexpr (sizeof(In) == 2)
                x = static_cast<int16_t>(wd[k / 2] >> (16 * (k % 2)));
              else
                x = static_cast<int32_t>(wd[k]);
              tile[y * kPitch + ((vc + k + y) & (kSpan - 1))] = x;
            }
          }
        }
      } else {
        if (drain) {
          int32_t* pw = vs + static_cast<long long>(g0) * w + dcol;
#pragma unroll 4
          for (int i = 0; i < kHalf; ++i, pw += w) {
            const int32_t o = tile[(g0 + i) * kPitch + ((dcol + g0 + i) & (kSpan - 1))];
            if (i < n) *pw = o;
          }
        }
        if (stage) {
#pragma unroll
          for (int i = 0; i < kHalf; ++i)
            tile[(g0 + i) * kPitch + ((scol + g0 + i) & (kSpan - 1))] = pf[i];
        }
      }
      __syncwarp();
    }
  }
  // rows 16..31 of the last chunk
  const int dcol = (nch - 1) * kChunk + lane;
  if (dcol < w) {
    int32_t* pw = vs + static_cast<long long>(kHalf) * w + dcol;
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      if (kHalf + i < rows)
        pw[i * w] = tile[(kHalf + i) * kPitch + ((dcol + kHalf + i) & (kSpan - 1))];
  }
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 3)
gradient_wavefront_kernel(const In* __restrict__ res, int32_t* __restrict__ out,
                          const __grid_constant__ LaneDims lanes, int rw) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ long long warp_sums[kWarps];
  int32_t* const tiles = smem;
  int32_t* const rings = smem + kWarps * kRows * kPitch;
  volatile int* const ready = reinterpret_cast<volatile int*>(rings + kWarps * rw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  // this lane's offset: the sizes of the lanes before it
  long long part = 0;
  for (int i = threadIdx.x; i < b; i += kThreads)
    part += static_cast<long long>(lanes.hw[2 * i]) * lanes.hw[2 * i + 1];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) part += __shfl_down_sync(kFull, part, d);
  if (lane == 0) warp_sums[warp] = part;
  if (threadIdx.x < kWarps) ready[threadIdx.x] = 0;
  __syncthreads();
  long long off = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) off += warp_sums[i];
  const int h = lanes.hw[2 * b], w = lanes.hw[2 * b + 1];
  const In* const r = res + off;
  int32_t* const v = out + off;
  int32_t* const tile = tiles + warp * kRows * kPitch;
  const int nstrips = (h + kRows - 1) / kRows;
  // 16-byte loads and stores when every row of the lane starts on 16 bytes
  // (the decoder's lanes: widths of groups, offsets sums of their sizes)
  const bool vec = reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 && w % (16 / sizeof(In)) == 0;
  for (int q = warp; q < nstrips; q += kWarps) {
    if (vec)
      strip<In, true>(r, v, h, w, q, tile, rings, ready, rw, lane);
    else
      strip<In, false>(r, v, h, w, q, tile, rings, ready, rw, lane);
  }
}

// Lets a block take the largest shared memory a lane may need and asks for
// the SM's largest shared-memory carveout (three blocks of 256x256 lanes
// an SM). Once a type; a race sets the same values.
template <typename In>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(gradient_wavefront_kernel<In>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes(kMaxW)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gradient_wavefront_kernel<In>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return e;
}

template <typename In>
int launch(const void* res, const int* hw, int L, int max_w, int32_t* out, cudaStream_t st) {
  cudaError_t e = configure<In>();
  if (e != cudaSuccess) return static_cast<int>(e);
  LaneDims d;
  std::memcpy(d.hw, hw, 2 * sizeof(int) * static_cast<size_t>(L));
  gradient_wavefront_kernel<In><<<L, kThreads, smem_bytes(max_w), st>>>(
      static_cast<const In*>(res), out, d, ring_words(max_w));
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int occupancy(int max_w, int* blocks) {
  cudaError_t e = configure<In>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gradient_wavefront_kernel<In>,
                                                      kThreads, smem_bytes(max_w));
  return static_cast<int>(e);
}

}  // namespace

// res: the flat residuals of L lanes packed back to back from its first
// sample (res_bytes 2: int16, 4: int32; any alignment of its element);
// hw: (L, 2) int32 (h, w) in host memory, L at most kMaxLanes; max_w: the
// widest lane (at most kMaxW); out: int32 like res. Returns the launch's
// cudaError_t.
extern "C" int gradient_wavefront_launch(const void* res, int res_bytes, const int* hw, int L,
                                         int max_w, int32_t* out, void* stream) {
  if (L <= 0 || L > kMaxLanes || max_w <= 0 || max_w > kMaxW ||
      (res_bytes != 2 && res_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return res_bytes == 2 ? launch<int16_t>(res, hw, L, max_w, out, st)
                        : launch<int32_t>(res, hw, L, max_w, out, st);
}

// The launch's geometry for lanes at most max_w wide, into out[0..7):
// warps a block, rows a strip, columns a staged tile, columns between
// hand-offs, a tile row's words, shared bytes a block (dynamic and
// static), and the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int gradient_wavefront_plan(int res_bytes, int max_w, int* out) {
  if (max_w <= 0 || max_w > kMaxW || (res_bytes != 2 && res_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kWarps;
  out[1] = kRows;
  out[2] = kChunk;
  out[3] = kHalf;
  out[4] = kPitch;
  out[5] = static_cast<int>(smem_bytes(max_w) + kWarps * sizeof(long long));
  return res_bytes == 2 ? occupancy<int16_t>(max_w, &out[6]) : occupancy<int32_t>(max_w, &out[6]);
}

extern "C" int gradient_wavefront_max_lanes() { return kMaxLanes; }

extern "C" const char* gradient_wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

