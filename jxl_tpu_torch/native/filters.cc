// Native host restoration filters: gaborish + EPF steps 0/1/2.
//
// Same math as the numpy/jax implementation in render/stages/core.py
// (the array-module-generic oracle, capability ref jxl/src/render/stages/
// {gaborish,epf/*}.rs) formulated as single-pass row loops: the numpy
// version materializes dozens of whole-plane temporaries per EPF step
// (one |I - shift(I)| plane per (neighbor, channel) plus shifted-view
// sums), which is memory-bandwidth-bound; here each output row touches
// only the padded input rows it needs and g++ vectorizes the fused
// abs-diff accumulation.
//
// Whole-frame semantics (pos = (0,0)):
//   sad_mul(y,x)  = border_sad_mul*sm on 8x8-block borders else sm
//   SAD_n(y,x)    = sum_c cs[c] * sum_p |P_c(y+p) - P_c(y+n+p)|
//   w_n           = max(SAD_n * inv_sigma_px*sad_mul + 1, 0)
//   out_c         = (P_c + sum w_n P_c(+n)) / (1 + sum w_n)
//   passthrough where inv_sigma_px < MIN_SIGMA.
// Borders mirror at the visible frame edge with edge duplication
// (numpy pad mode "symmetric", ref util/mirror.rs).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

namespace {

constexpr float kMinSigma = -3.90524291751269967465540850526868f;

struct Off { int dy, dx; };

constexpr Off kPlus5[5] = {{0, 0}, {-1, 0}, {1, 0}, {0, -1}, {0, 1}};
constexpr Off kEpf0Neigh[12] = {{-2, 0}, {-1, -1}, {-1, 0}, {-1, 1}, {0, -2},
                                {0, -1}, {0, 1},  {0, 2},  {1, -1}, {1, 0},
                                {1, 1},  {2, 0}};
constexpr Off kEpf1Neigh[4] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};

inline int mirror_idx(int i, int n) {
  // symmetric (edge-duplicating) mirror for |i| excursions < n
  if (i < 0) return -i - 1;
  if (i >= n) return 2 * n - 1 - i;
  return i;
}

// Copy plane into a (h+2B)x(w+2B) padded buffer with mirrored borders.
void pad_mirror(const float* src, float* dst, int h, int w, int64_t stride,
                int B) {
  const int W = w + 2 * B;
  for (int y = -B; y < h + B; ++y) {
    const float* srow = src + (size_t)mirror_idx(y, h) * stride;
    float* drow = dst + (size_t)(y + B) * W + B;
    std::memcpy(drow, srow, sizeof(float) * w);
    for (int x = 1; x <= B; ++x) {
      drow[-x] = srow[mirror_idx(-x, w)];
      drow[w - 1 + x] = srow[mirror_idx(w - 1 + x, w)];
    }
  }
}

void refresh_borders(float* buf, int h, int w, int B) {
  const int W = w + 2 * B;
  // rows first (copy from interior rows), then columns over full width
  for (int x = 1; x <= B; ++x) {
    for (int y = 0; y < h; ++y) {
      float* row = buf + (size_t)(y + B) * W + B;
      row[-x] = row[mirror_idx(-x, w)];
      row[w - 1 + x] = row[mirror_idx(w - 1 + x, w)];
    }
  }
  for (int y = 1; y <= B; ++y) {
    std::memcpy(buf + (size_t)(B - y) * W,
                buf + (size_t)(B + mirror_idx(-y, h)) * W, sizeof(float) * W);
    std::memcpy(buf + (size_t)(B + h - 1 + y) * W,
                buf + (size_t)(B + mirror_idx(h - 1 + y, h)) * W,
                sizeof(float) * W);
  }
}

// in/out are B-padded buffers; writes the h*w interior of out.
void gaborish_plane(const float* in, float* out, int h, int w, int B,
                    float w1, float w2) {
  const int W = w + 2 * B;
  const float total = 1.0f + w1 * 4.0f + w2 * 4.0f;
  const float g0 = 1.0f / total, g1 = w1 / total, g2 = w2 / total;
  for (int y = 0; y < h; ++y) {
    const float* r0 = in + (size_t)(y + B) * W + B;
    const float* rm = r0 - W;
    const float* rp = r0 + W;
    float* o = out + (size_t)(y + B) * W + B;
    for (int x = 0; x < w; ++x) {
      const float c = r0[x];
      const float side = rm[x] + rp[x] + r0[x - 1] + r0[x + 1];
      const float corner = rm[x - 1] + rm[x + 1] + rp[x - 1] + rp[x + 1];
      o[x] = c * g0 + side * g1 + corner * g2;
    }
  }
}

// Shared-difference-plane EPF step: every neighbor SAD is a sum of NP
// shifted rows of D_v(b) = sum_c cs[c]*|I_c(b) - I_c(b+v)| where v runs
// over the NB unique +/- neighbor-pair vectors (|I(a+p)-I(a-v+p)| =
// D_v(a-v+p)), so the abs-diff work drops from NN*3*NP plane passes to
// NB fused passes plus NN*NP row adds — the same restructuring libjxl's
// SIMD EPF uses.
template <int NB, int NN, int NP>
void epf_step_t(const float* const in[3], float* const out[3], int h, int w,
                int B, const float* inv_sigma, int sigma_is_block,
                const Off (&base_v)[NB], const Off (&neigh)[NN],
                const int (&nmap)[NN], const int (&nsign)[NN],
                const Off (&pat)[NP], const float cs[3],
                float sm, float bsm) {
  const int W = w + 2 * B;
  const int H = h + 2 * B;
  const size_t psz = (size_t)H * W;
  const int sbw = sigma_is_block ? (w + 7) / 8 : w;
  std::vector<float> sigrow(sigma_is_block ? w : 0);
  std::vector<float> sadbuf((size_t)NN * w);
  std::vector<float> mulrow;        // [0,w): interior row, [w,2w): border row
  std::vector<float> rowbuf;        // isx | wsum | invw scratch rows
  static thread_local std::vector<float> dbuf;
  if (dbuf.size() < (size_t)NB * psz) dbuf.resize((size_t)NB * psz);
  // D planes over the padded grid (rows/cols where b and b+v both exist)
  for (int v = 0; v < NB; ++v) {
    const int vy = base_v[v].dy, vx = base_v[v].dx;
    float* D = dbuf.data() + (size_t)v * psz;
    const int ylim = H - vy;   // vy, vx >= 0 by construction
    const int xlim = W - vx;
    for (int y = 0; y < ylim; ++y) {
      float* drow = D + (size_t)y * W;
      const float* a0 = in[0] + (size_t)y * W;
      const float* b0 = a0 + (std::ptrdiff_t)vy * W + vx;
      const float* a1 = in[1] + (size_t)y * W;
      const float* b1 = a1 + (std::ptrdiff_t)vy * W + vx;
      const float* a2 = in[2] + (size_t)y * W;
      const float* b2 = a2 + (std::ptrdiff_t)vy * W + vx;
      const float s0 = cs[0], s1 = cs[1], s2 = cs[2];
      for (int x = 0; x < xlim; ++x)
        drow[x] = s0 * std::fabs(a0[x] - b0[x]) +
                  s1 * std::fabs(a1[x] - b1[x]) +
                  s2 * std::fabs(a2[x] - b2[x]);
    }
  }
  for (int y = 0; y < h; ++y) {
    float* sad = sadbuf.data();
    for (int n = 0; n < NN; ++n) {
      float* srow = sad + (size_t)n * w;
      const int v = nmap[n];
      const float* D = dbuf.data() + (size_t)v * psz;
      // b = a + p (positive sign) or a - v + p (negative sign)
      const int oy = (nsign[n] > 0 ? 0 : -base_v[v].dy);
      const int ox = (nsign[n] > 0 ? 0 : -base_v[v].dx);
      {
        const float* r = D + (size_t)(y + B + oy + pat[0].dy) * W + B + ox +
                         pat[0].dx;
        for (int x = 0; x < w; ++x) srow[x] = r[x];
      }
      for (int p = 1; p < NP; ++p) {
        const float* r = D + (size_t)(y + B + oy + pat[p].dy) * W + B + ox +
                         pat[p].dx;
        for (int x = 0; x < w; ++x) srow[x] += r[x];
      }
    }
    const float* isg;
    if (sigma_is_block) {
      const float* sb = inv_sigma + (size_t)(y >> 3) * sbw;
      for (int x = 0; x < w; ++x) sigrow[x] = sb[x >> 3];
      isg = sigrow.data();
    } else {
      isg = inv_sigma + (size_t)y * w;
    }
    const int ybord = ((y & 7) == 0 || (y & 7) == 7) ? 1 : 0;
    // Row-vectorized weight/accumulate pass: the per-pixel formulation
    // (wn[NN] in registers, data-dependent mul) defeats autovec; these
    // straight-line row loops vectorize on AVX-512. Same op order per
    // pixel, so results are bit-identical to the scalar loop.
    if (mulrow.empty()) {
      mulrow.resize(2 * (size_t)w);
      for (int x = 0; x < w; ++x) {
        const int xbord = ((x & 7) == 0 || (x & 7) == 7) ? 1 : 0;
        mulrow[x] = xbord ? bsm : sm;  // interior row
        mulrow[w + x] = bsm;           // border row: bsm everywhere
      }
    }
    const float* mrow = mulrow.data() + (ybord ? w : 0);
    if (rowbuf.size() < 3 * (size_t)w) rowbuf.resize(3 * (size_t)w);
    float* isx = rowbuf.data();
    float* wsum = rowbuf.data() + w;
    float* invw = rowbuf.data() + 2 * (size_t)w;
    for (int x = 0; x < w; ++x) isx[x] = isg[x] * mrow[x];
    for (int x = 0; x < w; ++x) wsum[x] = 1.0f;
    // weights overwrite sadbuf in place (each entry read exactly once)
    for (int n = 0; n < NN; ++n) {
      float* srow = sad + (size_t)n * w;
      for (int x = 0; x < w; ++x) {
        float v = srow[x] * isx[x] + 1.0f;
        srow[x] = v > 0.0f ? v : 0.0f;
        wsum[x] += srow[x];
      }
    }
    for (int x = 0; x < w; ++x) invw[x] = 1.0f / wsum[x];
    for (int c = 0; c < 3; ++c) {
      const float* base = in[c] + (size_t)(y + B) * W + B;
      float* orow = out[c] + (size_t)(y + B) * W + B;
      for (int x = 0; x < w; ++x) orow[x] = base[x];
      for (int n = 0; n < NN; ++n) {
        const float* srow = sad + (size_t)n * w;
        const float* nrow = base + (std::ptrdiff_t)neigh[n].dy * W + neigh[n].dx;
        for (int x = 0; x < w; ++x) orow[x] += srow[x] * nrow[x];
      }
      for (int x = 0; x < w; ++x)
        orow[x] = isg[x] < kMinSigma ? base[x] : orow[x] * invw[x];
    }
  }
}

}  // namespace

extern "C" {

// planes: 3 pointers to h*w f32 (row stride `io_stride` floats, or w
// when io_stride <= 0), filtered in place.
// inv_sigma_px: h*w stored 1/sigma (negative), or nullptr when epf_iters==0.
// gab_weights: 6 floats (w1,w2 per channel), or nullptr to skip gaborish.
// Applies: gaborish, then EPF steps in the reference order
// (step0 iff iters>=3, step1 iff iters>=1, step2 iff iters>=2).
// sigma_is_block: inv_sigma_px is (ceil(h/8), ceil(w/8)) per-BLOCK values
// (stages/core.py _expand_sigma semantics at pos (0,0)) expanded on the
// fly — saves the caller two whole-image np.repeat passes.
void jxl_filter_chain_strided(float* plane0, float* plane1, float* plane2,
                              int h, int w, int64_t io_stride,
                              const float* inv_sigma_px, int sigma_is_block,
                              const float* gab_weights, int epf_iters,
                              const float* channel_scale,
                              float pass0_sigma_scale, float pass2_sigma_scale,
                              float border_sad_mul) {
  const int B = 3;  // max border of any step; shared padded layout
  const int W = w + 2 * B;
  const size_t psz = (size_t)(h + 2 * B) * W;
  // reused across calls, never zero-filled: every region read is written
  // first (pad_mirror fills bufa fully; steps write interiors and then
  // refresh_borders rebuilds the borders)
  static thread_local std::vector<float> bufa_tl, bufb_tl;
  if (bufa_tl.size() < 3 * psz) bufa_tl.resize(3 * psz);
  if (bufb_tl.size() < 3 * psz) bufb_tl.resize(3 * psz);
  std::vector<float>& bufa = bufa_tl;
  std::vector<float>& bufb = bufb_tl;
  float* pa[3] = {bufa.data(), bufa.data() + psz, bufa.data() + 2 * psz};
  float* pb[3] = {bufb.data(), bufb.data() + psz, bufb.data() + 2 * psz};
  float* planes[3] = {plane0, plane1, plane2};
  const int64_t iost = io_stride > 0 ? io_stride : w;
  for (int c = 0; c < 3; ++c) pad_mirror(planes[c], pa[c], h, w, iost, B);

  if (gab_weights) {
    for (int c = 0; c < 3; ++c) {
      gaborish_plane(pa[c], pb[c], h, w, B, gab_weights[2 * c],
                     gab_weights[2 * c + 1]);
      std::swap(pa[c], pb[c]);
      refresh_borders(pa[c], h, w, B);
    }
  }

  float cs[3] = {1.0f, 1.0f, 1.0f};
  if (channel_scale)
    for (int c = 0; c < 3; ++c) cs[c] = channel_scale[c];
  const float* cpa[3];
  float* cpb[3];
  auto run_step = [&](int step) {
    for (int c = 0; c < 3; ++c) {
      cpa[c] = pa[c];
      cpb[c] = pb[c];
    }
    // unique +/- pair base vectors and the neighbor->base maps
    static constexpr Off kEpf0Base[6] = {{2, 0}, {1, 1}, {1, 0},
                                         {1, -1}, {0, 2}, {0, 1}};
    static constexpr int kEpf0Map[12] = {0, 1, 2, 3, 4, 5, 5, 4, 3, 2, 1, 0};
    static constexpr int kEpf0Sign[12] = {-1, -1, -1, -1, -1, -1,
                                          1, 1, 1, 1, 1, 1};
    static constexpr Off kEpf1Base[2] = {{1, 0}, {0, 1}};
    static constexpr int kEpf1Map[4] = {0, 1, 1, 0};
    static constexpr int kEpf1Sign[4] = {-1, -1, 1, 1};
    if (step == 0) {
      epf_step_t<6, 12, 5>(cpa, cpb, h, w, B, inv_sigma_px, sigma_is_block,
                           kEpf0Base, kEpf0Neigh, kEpf0Map, kEpf0Sign, kPlus5,
                           cs, pass0_sigma_scale * 1.65f,
                           pass0_sigma_scale * 1.65f * border_sad_mul);
    } else if (step == 1) {
      epf_step_t<2, 4, 5>(cpa, cpb, h, w, B, inv_sigma_px, sigma_is_block,
                          kEpf1Base, kEpf1Neigh, kEpf1Map, kEpf1Sign, kPlus5,
                          cs, 1.65f, 1.65f * border_sad_mul);
    } else {
      constexpr Off kSelf[1] = {{0, 0}};
      epf_step_t<2, 4, 1>(cpa, cpb, h, w, B, inv_sigma_px, sigma_is_block,
                          kEpf1Base, kEpf1Neigh, kEpf1Map, kEpf1Sign, kSelf,
                          cs, pass2_sigma_scale * 1.65f,
                          pass2_sigma_scale * 1.65f * border_sad_mul);
    }
    for (int c = 0; c < 3; ++c) std::swap(pa[c], pb[c]);
    for (int c = 0; c < 3; ++c) refresh_borders(pa[c], h, w, B);
  };
  if (inv_sigma_px && epf_iters >= 3) run_step(0);
  if (inv_sigma_px && epf_iters >= 1) run_step(1);
  if (inv_sigma_px && epf_iters >= 2) run_step(2);

  for (int c = 0; c < 3; ++c) {
    for (int y = 0; y < h; ++y)
      std::memcpy(planes[c] + (size_t)y * iost,
                  pa[c] + (size_t)(y + B) * W + B, sizeof(float) * w);
  }
}

void jxl_filter_chain(float* plane0, float* plane1, float* plane2, int h,
                      int w, const float* inv_sigma_px, int sigma_is_block,
                      const float* gab_weights, int epf_iters,
                      const float* channel_scale, float pass0_sigma_scale,
                      float pass2_sigma_scale, float border_sad_mul) {
  jxl_filter_chain_strided(plane0, plane1, plane2, h, w, 0, inv_sigma_px,
                           sigma_is_block, gab_weights, epf_iters,
                           channel_scale, pass0_sigma_scale, pass2_sigma_scale,
                           border_sad_mul);
}

// Batched per-frame filter chain over a stacked animation canvas: frame
// i's three planes start at plane{0,1,2} + offsets[i], sized hs[i] x
// ws[i] on the shared io_stride, with its block-resolution 1/sigma at
// sigmas + sigma_offs[i] (null sigmas = gaborish only). One call
// replaces `count` ctypes round trips; filter semantics are exactly the
// per-frame jxl_filter_chain_strided (visible-edge mirror per frame).
void jxl_filter_chain_multi(float* plane0, float* plane1, float* plane2,
                            int count, const int64_t* offsets,
                            const int32_t* hs, const int32_t* ws,
                            int64_t io_stride, const float* sigmas,
                            const int64_t* sigma_offs,
                            const float* gab_weights, int epf_iters,
                            const float* channel_scale,
                            float pass0_sigma_scale, float pass2_sigma_scale,
                            float border_sad_mul) {
  for (int i = 0; i < count; ++i) {
    jxl_filter_chain_strided(
        plane0 + offsets[i], plane1 + offsets[i], plane2 + offsets[i], hs[i],
        ws[i], io_stride, sigmas ? sigmas + sigma_offs[i] : nullptr, 1,
        gab_weights, epf_iters, channel_scale, pass0_sigma_scale,
        pass2_sigma_scale, border_sad_mul);
  }
}

}  // extern "C"

namespace {

// xorshift128+ with 8 interleaved lanes (ref util/xorshift128plus.rs;
// python twin features/noise.py Xorshift128Plus — golden-tested there).
struct Xor128 {
  uint64_t s0[8], s1[8];
  static uint64_t split_mix(uint64_t z) {
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  Xor128(uint64_t seed1, uint64_t seed2, uint64_t seed3, uint64_t seed4) {
    s0[0] = split_mix(((seed1 << 32) + seed2) + 0x9E3779B97F4A7C15ULL);
    s1[0] = split_mix(((seed3 << 32) + seed4) + 0x9E3779B97F4A7C15ULL);
    for (int i = 1; i < 8; ++i) {
      s0[i] = split_mix(s0[i - 1]);
      s1[i] = split_mix(s1[i - 1]);
    }
  }
  // 8 u64 of bits, advancing the state
  void fill(uint64_t out[8]) {
    for (int i = 0; i < 8; ++i) {
      uint64_t ns1 = s0[i];
      uint64_t ns0 = s1[i];
      out[i] = ns1 + ns0;
      ns1 ^= ns1 << 23;
      ns1 = ns1 ^ ns0 ^ (ns1 >> 18) ^ (ns0 >> 5);
      s0[i] = ns0;
      s1[i] = ns1;
    }
  }
};

inline float bits_to_float(uint32_t b) {
  uint32_t u = (b >> 9) | 0x3F800000u;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

}  // namespace

extern "C" {

// Whole-image 3-channel noise field: the native twin of
// features/noise.py generate_noise_field (ref frame/decode.rs:585-695
// with libjxl's ceil((sub_xsize+2)/16) row stride — see the python
// docstring for why). bufs: 3 pointers to (hu, wu) f32.
// Row-ranged variant: fills only absolute rows [y_lo, y_hi) of the
// upsampled field into (y_hi - y_lo, wu) planes. The RNG is seeded per
// SUBREGION, so untouched subregions cost nothing; within a touched
// subregion the draws for rows before y_lo are consumed and discarded
// (rows are sequential per channel), keeping the stream bit-identical
// to the whole-image generation. Used by the banded low-memory decoder
// (api/banded.py), which needs the field for one band plus the 2-row
// convolve margin.
void jxl_noise_field_rows(float* buf0, float* buf1, float* buf2, int64_t hu,
                          int64_t wu, int up, int group_dim, int gx_count,
                          int gy_count, uint32_t vfi, uint32_t nfi,
                          int64_t y_lo, int64_t y_hi) {
  float* bufs[3] = {buf0, buf1, buf2};
  for (int gy = 0; gy < gy_count; ++gy) {
    const int64_t gby0 = (int64_t)gy * up * group_dim;
    const int64_t gby1 =
        std::min<int64_t>((int64_t)(gy + 1) * up * group_dim, hu);
    if (gby1 <= y_lo || gby0 >= y_hi) continue;
    for (int gx = 0; gx < gx_count; ++gx) {
      const int64_t bx0 = (int64_t)gx * up * group_dim;
      const int64_t buf_xs =
          std::min<int64_t>((int64_t)(gx + 1) * up * group_dim, wu) - bx0;
      const int64_t buf_ys = gby1 - gby0;
      for (int iy = 0; iy < up; ++iy) {
        for (int ix = 0; ix < up; ++ix) {
          const int64_t x0 = ((int64_t)gx * up + ix) * group_dim;
          const int64_t y0 = ((int64_t)gy * up + iy) * group_dim;
          const int64_t sx0 = (int64_t)ix * group_dim;
          const int64_t sy0 = (int64_t)iy * group_dim;
          const int64_t sub_xs =
              std::min<int64_t>((int64_t)(ix + 1) * group_dim, buf_xs) - sx0;
          const int64_t sub_ys =
              std::min<int64_t>((int64_t)(iy + 1) * group_dim, buf_ys) - sy0;
          if (sub_xs <= 0 || sub_ys <= 0) continue;
          const int64_t abs0 = gby0 + sy0;
          if (abs0 >= y_hi || abs0 + sub_ys <= y_lo) continue;
          Xor128 rng(vfi, nfi, (uint64_t)x0, (uint64_t)y0);
          const int64_t nbatch = (sub_xs + 2 + 15) / 16;
          uint64_t bits[8];
          for (int c = 0; c < 3; ++c) {
            for (int64_t y = 0; y < sub_ys; ++y) {
              const int64_t abs_y = abs0 + y;
              if (abs_y >= y_hi && c == 2) break;  // nothing left to draw
              const bool want = abs_y >= y_lo && abs_y < y_hi;
              float* row = want ? bufs[c] + (abs_y - y_lo) * wu + bx0 + sx0
                                : nullptr;
              for (int64_t b = 0; b < nbatch; ++b) {
                rng.fill(bits);
                if (!want) continue;
                const int64_t xoff = b * 16;
                const int64_t take = std::min<int64_t>(16, sub_xs - xoff);
                for (int64_t k = 0; k < take; ++k) {
                  const uint32_t u32 =
                      (k & 1) ? (uint32_t)(bits[k >> 1] >> 32)
                              : (uint32_t)(bits[k >> 1] & 0xFFFFFFFFULL);
                  row[xoff + k] = bits_to_float(u32);
                }
              }
            }
          }
        }
      }
    }
  }
}

void jxl_noise_field(float* buf0, float* buf1, float* buf2, int64_t hu,
                     int64_t wu, int up, int group_dim, int gx_count,
                     int gy_count, uint32_t vfi, uint32_t nfi) {
  float* bufs[3] = {buf0, buf1, buf2};
  for (int gy = 0; gy < gy_count; ++gy) {
    for (int gx = 0; gx < gx_count; ++gx) {
      const int64_t bx0 = (int64_t)gx * up * group_dim;
      const int64_t by0 = (int64_t)gy * up * group_dim;
      const int64_t buf_xs =
          std::min<int64_t>((int64_t)(gx + 1) * up * group_dim, wu) - bx0;
      const int64_t buf_ys =
          std::min<int64_t>((int64_t)(gy + 1) * up * group_dim, hu) - by0;
      for (int iy = 0; iy < up; ++iy) {
        for (int ix = 0; ix < up; ++ix) {
          const int64_t x0 = ((int64_t)gx * up + ix) * group_dim;
          const int64_t y0 = ((int64_t)gy * up + iy) * group_dim;
          Xor128 rng(vfi, nfi, (uint64_t)x0, (uint64_t)y0);
          const int64_t sx0 = (int64_t)ix * group_dim;
          const int64_t sy0 = (int64_t)iy * group_dim;
          const int64_t sub_xs =
              std::min<int64_t>((int64_t)(ix + 1) * group_dim, buf_xs) - sx0;
          const int64_t sub_ys =
              std::min<int64_t>((int64_t)(iy + 1) * group_dim, buf_ys) - sy0;
          if (sub_xs <= 0 || sub_ys <= 0) continue;
          const int64_t nbatch = (sub_xs + 2 + 15) / 16;
          uint64_t bits[8];
          for (int c = 0; c < 3; ++c) {
            for (int64_t y = 0; y < sub_ys; ++y) {
              float* row = bufs[c] + (by0 + sy0 + y) * wu + bx0 + sx0;
              for (int64_t b = 0; b < nbatch; ++b) {
                rng.fill(bits);
                const int64_t xoff = b * 16;
                const int64_t take = std::min<int64_t>(16, sub_xs - xoff);
                for (int64_t k = 0; k < take; ++k) {
                  const uint32_t u32 =
                      (k & 1) ? (uint32_t)(bits[k >> 1] >> 32)
                              : (uint32_t)(bits[k >> 1] & 0xFFFFFFFFULL);
                  row[xoff + k] = bits_to_float(u32);
                }
              }
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
