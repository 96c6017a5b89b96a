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
// Bound on an H100: neither bytes nor operations. A lane of h x w samples
// moves 6 or 8 bytes a sample and does about ten integer operations a
// sample, microseconds for a whole 4K frame; but cell (y, x) needs
// (y, x-1), (y-1, x) and (y-1, x-1), so a lane is a chain of h + w - 1
// dependent anti-diagonals. The design takes the parallelism the chain
// leaves: one block a lane (lanes are independent, a 4K frame has
// hundreds), every cell of a diagonal in parallel across the block's
// threads, the two previous diagonals in shared memory (three rotating
// rows of w int32: the one being written and the two it reads), and one
// barrier a diagonal. Lanes are packed back to back in one flat buffer,
// each with its own (h, w), by a table of (offset, h, w): no padding.
// A diagonal's cells lie a row apart in device memory, so each load and
// store touches its own sector; the next diagonals reuse those sectors
// from L1 and L2. Kept simple: no prefetch of the next diagonal's
// residuals, whose load latency each step waits for.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// l + t - tl in uint32
__device__ __forceinline__ int32_t grad_wrap(int32_t l, int32_t t, int32_t tl) {
  return static_cast<int32_t>(static_cast<uint32_t>(l) + static_cast<uint32_t>(t) -
                              static_cast<uint32_t>(tl));
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
gradient_wavefront_kernel(const In* __restrict__ res, const long long* __restrict__ lanes,
                          int32_t* __restrict__ out, int row_words) {
  extern __shared__ int32_t rows[];  // 3 x row_words: diagonals d, d-1, d-2 by x
  const long long off = lanes[3 * blockIdx.x];
  const int h = static_cast<int>(lanes[3 * blockIdx.x + 1]);
  const int w = static_cast<int>(lanes[3 * blockIdx.x + 2]);
  const In* r = res + off;
  int32_t* v = out + off;
  int32_t* cur = rows;
  int32_t* p1 = rows + row_words;
  int32_t* p2 = rows + 2 * row_words;
  for (int d = 0; d < h + w - 1; ++d) {
    const int x_lo = d - (h - 1) > 0 ? d - (h - 1) : 0;
    const int x_hi = d < w - 1 ? d : w - 1;
    for (int x = x_lo + threadIdx.x; x <= x_hi; x += kThreads) {
      const int y = d - x;
      const long long i = static_cast<long long>(y) * w + x;
      const int32_t ri = static_cast<int32_t>(__ldg(r + i));
      int32_t pred;
      if (y == 0) {
        pred = x == 0 ? 0 : p1[x - 1];
      } else if (x == 0) {
        pred = p1[0];
      } else {
        const int32_t l = p1[x - 1], t = p1[x], tl = p2[x - 1];
        const int32_t mn = l < t ? l : t, mx = l < t ? t : l;
        pred = tl < mn ? mx : (tl > mx ? mn : grad_wrap(l, t, tl));
      }
      const int32_t val = add_wrap(pred, ri);
      cur[x] = val;
      v[i] = val;
    }
    __syncthreads();
    int32_t* spare = p2;
    p2 = p1;
    p1 = cur;
    cur = spare;
  }
}

}  // namespace

// res: the flat residuals (res_bytes 2: int16, 4: int32); lanes: (L, 3)
// int64 (offset, h, w) on the card; max_w: the widest lane (at most
// 4096, 48 KB of shared memory); out: int32 like res. Returns the launch's
// cudaError_t.
extern "C" int gradient_wavefront_launch(const void* res, int res_bytes, const long long* lanes,
                                         int L, int max_w, int32_t* out, void* stream) {
  if (L <= 0 || max_w <= 0 || max_w > 4096 || (res_bytes != 2 && res_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * static_cast<size_t>(max_w) * sizeof(int32_t);
  if (res_bytes == 2)
    gradient_wavefront_kernel<int16_t><<<L, kThreads, smem, st>>>(
        static_cast<const int16_t*>(res), lanes, out, max_w);
  else
    gradient_wavefront_kernel<int32_t><<<L, kThreads, smem, st>>>(
        static_cast<const int32_t*>(res), lanes, out, max_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gradient_wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
