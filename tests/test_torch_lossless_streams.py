"""Lossless RGB Modular test streams, as `cjxl -d 0 -e 7` writes a photo,
and checks that the port, the JAX package and the benchmark's plain
reference read them back bit for bit.

`encode_rgb_lossless(width, height, seed)` writes a bare codestream: 8-bit
RGB (xyb_encoded off, sRGB), one REGULAR Modular frame in 256x256 groups,
gaborish off and no EPF. Its content is seeded and photo-like: noise
octaves with a 1/f amplitude, a few hard edges, channels correlated as a
photo's are, and about 2 LSB of sensor noise.

Each group's GroupHeader carries the RCT (the format's reversible colour
transforms, permutation 0, types 0-6) with the least sum of |Gradient
residual| over its rows 8k + 1; the identity writes no transform. One global
MA tree splits on the channel (property 0), then on the weighted
predictor's max error (property 15) at thresholds taken from its
quantiles, and on neighbour differences (12: N - NE, 14: W - WW; the
"mixed" tree also 10, 11 and 13), with Weighted (6) and Gradient (5)
leaves, offset 0 and multiplier 1, and the default WP header. So every
channel's subtree mixes both predictors and reads pixel properties, and
the decoder's general tree loop is the one that runs.

The residuals are computed as the decoder predicts: the weighted
predictor's state runs along the wavefronts x + 2y, vectorized over every
group and channel at once (a sample reads only W, N, NW, NE, NN, WW and
their errors, all on earlier wavefronts). They are ANS-coded with one
histogram a cluster (a channel's leaves of one predictor), fitted to its
tokens and coded in the format's complex distribution coding, each
group's stream rANS-encoded from the final state 0x130000, vectorized
across the groups. The bits are packed with numpy.

Beside the bytes the writer returns `coded`: the source pixels, each
group's RCT, its residuals, the tree and the WP parameters, from which
portbench/reference/rgb_lossless.py rebuilds the pixels.

This module imports neither jax nor either package at the top: the
benchmark's frozen copy (portbench/writers/rgb_lossless.py) is held to it
byte for byte. The tests import the packages inside each test.
"""

from __future__ import annotations

import numpy as np
import pytest

from mini_encoder import BW, u32, u64

GROUP_DIM = 256
FINAL_STATE = 0x130000
WEIGHTED, GRADIENT = 6, 5
RCT_TYPES = tuple(range(7))  # permutation 0: identity, five subtractions, YCoCg
PRED_EXTRA_BITS = 3
PRED_ROUND = ((1 << PRED_EXTRA_BITS) >> 1) - 1
# the default WP header: p1c, p2c, p3ca..p3ce, w0..w3
WP_DEFAULT = (16, 10, 7, 7, 7, 0, 0, 13, 12, 12, 12)
DIV_LUT = np.array([(1 << 24) // (i + 1) for i in range(64)], np.int64)
RESIDUAL_UINT = (4, 2, 0)  # split_exponent, msb_in_token, lsb_in_token
TREE_UINT = (4, 0, 0)
TREES = ("photo", "mixed")
# the static prefix code of the complex distribution's log counts: symbol
# -> (code, length), LSB first
LOG_COUNT_CODES = {0: (0b10001, 5), 1: (0b1011, 4), 2: (0b1111, 4), 3: (0b0011, 4),
                   4: (0b1001, 4), 5: (0b0111, 4), 6: (0b100, 3), 7: (0b010, 3),
                   8: (0b101, 3), 9: (0b110, 3), 10: (0b000, 3), 11: (0b100001, 6),
                   12: (0b0000001, 7)}


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _log2_f64(v):
    """floor(log2 v) of positive integers below 2^53, from their float64
    exponent."""
    return ((v.astype(np.float64).view(np.int64) >> 52) - 1023).astype(np.int32)


# -- bits ---------------------------------------------------------------------------


class Bits:
    """LSB-first bit list of (value, nbits) pieces of at most 32 bits,
    packed at once (pack_bits); a BW in what it accepts."""

    def __init__(self):
        self.vals, self.nbits = [], []

    def write(self, value: int, nbits: int):
        if nbits > 32:
            raise ValueError("a piece of more than 32 bits")
        self.vals.append(np.array([value & ((1 << nbits) - 1)], np.uint64))
        self.nbits.append(np.array([nbits], np.int64))

    def extend(self, vals, nbits):
        self.vals.append(np.asarray(vals, np.uint64).reshape(-1))
        self.nbits.append(np.asarray(nbits, np.int64).reshape(-1))

    def arrays(self):
        if not self.vals:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        return np.concatenate(self.vals), np.concatenate(self.nbits)

    def finish(self) -> bytes:
        return pack_bits(*self.arrays())[0]


def pack_bits(vals, nbits) -> list:
    """The bytes of runs of (value, nbits) pieces written LSB first, each
    run from a byte boundary: vals and nbits (R, P), a run a row (a 1-D
    pair is one run). Returns the runs' bytes."""
    nbits = np.atleast_2d(nbits)
    keep = np.flatnonzero(nbits > 0)
    nb = nbits.reshape(-1)[keep].astype(np.int64)
    v = np.atleast_2d(vals).reshape(-1)[keep].astype(np.uint64)
    v &= (np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1)
    n_runs, run_len = nbits.shape
    run = keep // run_len
    run_bits = np.bincount(run, weights=nb, minlength=n_runs).astype(np.int64)
    run_bytes = (run_bits + 7) // 8
    off = np.cumsum(nb) - nb
    off += (8 * (np.cumsum(run_bytes) - run_bytes) - (np.cumsum(run_bits) - run_bits))[run]
    total = int(8 * run_bytes.sum())
    words = np.zeros(total // 64 + 2, np.uint64)
    if len(nb):
        idx = off >> 6
        sh = (off & 63).astype(np.uint64)
        spill = (off & 63) + nb > 64
        hi = np.where(spill, v >> (np.uint64(64) - np.maximum(sh, np.uint64(1))), np.uint64(0))
        first = np.flatnonzero(np.diff(idx, prepend=-1))
        words[idx[first]] = np.add.reduceat(v << sh, first)
        words[idx[first] + 1] |= np.add.reduceat(hi, first)
    data = words.view(np.uint8)[:total // 8].tobytes()
    ends = np.cumsum(run_bytes)
    return [data[a:b] for a, b in zip((ends - run_bytes).tolist(), ends.tolist())]


# -- entropy coding ---------------------------------------------------------------


def signed_pack(v):
    v = np.asarray(v, np.int64)
    return np.where(v >= 0, 2 * v, -2 * v - 1)


def hybrid_encode(v, cfg):
    """HybridUint (split_exponent, msb, lsb): values -> (tokens, raw bits,
    raw bit counts)."""
    se, msb, lsb = cfg
    v = np.asarray(v, np.int64)
    small = v < (1 << se)
    n = _log2_f64(np.maximum(v, 1))
    nb = np.maximum(n - msb - lsb, 0)
    low = v & ((1 << lsb) - 1)
    top = (v >> (lsb + nb)) & ((1 << msb) - 1)
    raw = (v >> lsb) & ((np.int64(1) << nb) - 1)
    tok = (1 << se) + (((n - se) << (msb + lsb)) | (top << lsb) | low)
    return np.where(small, v, tok), np.where(small, 0, raw), np.where(small, 0, nb)


def normalize_counts(counts) -> np.ndarray:
    """A distribution over the counts' symbols summing to 4096, every
    symbol that occurs at least 1."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        counts = np.eye(1, len(counts), dtype=np.int64)[0]
        total = 1
    d = np.where(counts > 0, np.maximum(1, (counts * 4096 + total // 2) // total), 0)
    j = int(np.argmax(d))
    d[j] += 4096 - int(d.sum())
    if d[j] < 1:
        raise ValueError("too many symbols for a 12-bit distribution")
    return d


def _write_u8(w, v: int):
    if v == 0:
        w.write(0, 1)
        return
    n = v.bit_length() - 1
    w.write(1, 1)
    w.write(n, 3)
    w.write(v - (1 << n), n)


def write_distribution(w, dist):
    """One distribution summing to 4096: a single symbol, or the complex
    coding at shift 13 (every count exact), without the RLE marker. The
    first symbol of the largest log count is left out; the decoder gives
    it what the others leave of 4096."""
    dist = np.asarray(dist, np.int64)
    nz = np.flatnonzero(dist)
    if len(nz) == 1:
        w.write(1, 1)
        w.write(0, 1)  # one symbol
        _write_u8(w, int(nz[0]))
        return
    alphabet = max(int(nz[-1]) + 1, 3)
    w.write(0, 1)
    w.write(0, 1)  # not evenly distributed: the complex coding
    w.write(0b111, 3)  # unary length 3
    w.write(6, 3)  # shift = 6 + 2^3 - 1 = 13
    _write_u8(w, alphabet - 3)
    logc = [int(c).bit_length() for c in dist[:alphabet].tolist()]
    omit = logc.index(max(logc))
    for c in logc:
        w.write(*LOG_COUNT_CODES[c])
    for i, c in enumerate(dist[:alphabet].tolist()):
        if i != omit and c > 1:
            z = c.bit_length() - 1
            w.write(c - (1 << z), z)  # shift 13 reads all z bits


def alias_inverse(dist, log_alpha: int) -> np.ndarray:
    """inv[sym, off]: the 12-bit slot that the decoder's alias table maps
    to (sym, off), the table built as the format's decoder builds it
    (Vose's method); a single symbol maps every slot to itself."""
    table = 1 << log_alpha
    dist = np.concatenate([np.asarray(dist, np.int64), np.zeros(table, np.int64)])[:table]
    inv = np.zeros((table, 4096), np.int64)
    idx = np.arange(4096)
    nz = np.flatnonzero(dist)
    if len(nz) == 1:
        inv[nz[0]] = idx
        return inv
    log_bucket = 12 - log_alpha
    bucket = 1 << log_bucket
    cutoff = dist.tolist()
    symbol = list(range(table))
    offset = [0] * table
    under = [i for i in range(table) if cutoff[i] < bucket]
    over = [i for i in range(table) if cutoff[i] > bucket]
    while over and under:
        o, u = over.pop(), under.pop()
        cutoff[o] -= bucket - cutoff[u]
        symbol[u] = o
        offset[u] = cutoff[o]
        if cutoff[o] < bucket:
            under.append(o)
        elif cutoff[o] > bucket:
            over.append(o)
    full = [cutoff[i] == bucket for i in range(table)]
    a_sym = np.array([i if full[i] else symbol[i] for i in range(table)])
    a_cut = np.array([bucket if full[i] else cutoff[i] for i in range(table)])
    a_off = np.array([0 if full[i] else offset[i] - cutoff[i] for i in range(table)])
    i = idx >> log_bucket
    pos = idx & (bucket - 1)
    alias = pos >= a_cut[i]
    inv[np.where(alias, a_sym[i], i), np.where(alias, a_off[i] + pos, pos)] = idx
    return inv




class Coding:
    """One histogram bundle: contexts mapped to clusters (`cmap`), one
    HybridUint config for every cluster, and each cluster's distribution
    fitted to its token counts (C, A)."""

    def __init__(self, cmap, uint_cfg, counts):
        self.cmap, self.cfg = list(cmap), uint_cfg
        counts = np.asarray(counts, np.int64)
        used = np.flatnonzero(counts.sum(0))
        self.log_alpha = max(5, _ceil_log2(int(used[-1]) + 1 if len(used) else 1))
        if self.log_alpha > 8:
            raise ValueError("a token past the largest alphabet")
        table = 1 << self.log_alpha
        counts = np.pad(counts, ((0, 0), (0, max(0, table - counts.shape[1]))))[:, :table]
        self.freq = np.stack([normalize_counts(c) for c in counts])
        # the alias tables' inverses, flat, then an identity table that
        # leaves a lane's state as it is past the lane's last token
        inv = np.stack([alias_inverse(f, self.log_alpha) for f in self.freq])
        self.inv = np.concatenate([inv.reshape(-1), np.arange(4096)])

    def write(self, w):
        w.write(0, 1)  # no LZ77
        if len(self.cmap) > 1:
            bits = _ceil_log2(max(self.cmap) + 1)
            if bits > 3:
                raise ValueError("the writer writes only simple context maps")
            w.write(1, 1)  # simple context map
            w.write(bits, 2)
            for c in self.cmap:
                w.write(c, bits)
        w.write(0, 1)  # ANS
        w.write(self.log_alpha - 5, 2)
        se, msb, lsb = self.cfg
        for _ in self.freq:
            w.write(se, _ceil_log2(self.log_alpha + 1))
            if se != self.log_alpha:
                w.write(msb, _ceil_log2(se + 1))
                w.write(lsb, _ceil_log2(se - msb + 1))
        for f in self.freq:
            write_distribution(w, f)


def rans_encode_lanes(coding, tok, cl, lengths):
    """rANS-encode each lane's tokens (S, T) in clusters (S, T) backward
    from FINAL_STATE. Returns (initial states (S,), words (S, T) uint16,
    has_word (S, T)): the decoder reads word t right after token t."""
    S, T = tok.shape
    # each step's distribution entry, a lane's steps past its end the
    # identity table after the distributions' (frequency 4096)
    code = np.asarray(cl, np.int32) * coding.freq.shape[1] + np.asarray(tok, np.int32)
    code[np.arange(T)[None, :] >= np.asarray(lengths)[:, None]] = coding.freq.size
    code = np.ascontiguousarray(code.T)
    freq = np.append(coding.freq.reshape(-1), 4096).take(code)
    limit = freq << 20
    base = code.astype(np.int64) << 12
    inv = coding.inv
    state = np.full(S, FINAL_STATE, np.int64)
    words = np.empty((T, S), np.uint16)
    has = np.empty((T, S), bool)
    q, r, slot = (np.empty(S, np.int64) for _ in range(3))
    ge, shr, dm, add, shl, take = (np.greater_equal, np.right_shift, np.divmod, np.add,
                                   np.left_shift, inv.take)
    # a step a token, last first: the rows as views, the ufuncs' outputs
    # positional (a step is a few microseconds of calls on S numbers)
    for lim, f, b, need, word in zip(limit[::-1], freq[::-1], base[::-1], has[::-1],
                                     words[::-1]):
        ge(state, lim, need)
        word[...] = state
        shr(state, 16, out=state, where=need)
        dm(state, f, q, r)
        add(r, b, r)
        take(r, out=slot)
        shl(q, 12, q)
        add(q, slot, state)
    return state, words.T, has.T


def stream_pieces(state, words, has, raw, nraw):
    """(values, nbits) (S, 2T + 2) of one rANS stream a lane: the initial
    state in two halves, then each token's renormalization word and raw
    bits."""
    S, T = words.shape
    vals = np.zeros((S, T + 1, 2), np.uint32)
    nb = np.zeros((S, T + 1, 2), np.int8)
    vals[:, 0, 0], vals[:, 0, 1] = state & 0xFFFF, state >> 16
    nb[:, 0] = 16
    vals[:, 1:, 0], nb[:, 1:, 0] = words, np.where(has, 16, 0)
    vals[:, 1:, 1], nb[:, 1:, 1] = raw, nraw
    return vals.reshape(S, -1), nb.reshape(S, -1)


def bfs(tree) -> list:
    """The tree's nodes in the decoder's reading order: breadth first, the
    property > splitval child first."""
    order, queue = [], [tree]
    while queue:
        node = queue.pop(0)
        order.append(node)
        if node[0] == "split":
            queue += [node[3], node[4]]
    return order


def write_tree(w, tree):
    """The MA tree's tokens (six contexts, one ANS cluster fitted to them,
    HybridUint TREE_UINT) in the decoder's reading order."""
    toks = []
    for node in bfs(tree):
        if node[0] == "split":
            toks += [node[1] + 1, int(signed_pack(node[2]))]
        else:  # property 0, predictor, offset 0, mul_log 0, mul_bits 0
            toks += [0, node[1], 0, 0, 0]
    tk, raw, nraw = hybrid_encode(toks, TREE_UINT)
    coding = Coding([0] * 6, TREE_UINT, np.bincount(tk)[None])
    coding.write(w)
    state, words, has = rans_encode_lanes(coding, tk[None], np.zeros((1, len(tk)), np.int64),
                                          [len(tk)])
    w.extend(*stream_pieces(state, words, has, raw[None], nraw[None]))


# the residuals' tokens, raw bits and raw bit counts, by residual +
# RESIDUAL_LIMIT (8-bit samples after an RCT, less a prediction within
# their neighbours' range, stay well inside)
RESIDUAL_LIMIT = 1 << 12
_TOKENS = tuple(a.astype(np.int32) for a in hybrid_encode(
    signed_pack(np.arange(-RESIDUAL_LIMIT, RESIDUAL_LIMIT)), RESIDUAL_UINT))


# -- content ------------------------------------------------------------------------


def _upsample(a, f: int, h: int, w: int):
    """a (gh, gw) upsampled f times bilinearly, sample (y, x) at a's (y /
    f, x / f), cropped to (h, w); float32."""
    ys = np.arange(h, dtype=np.float32) / np.float32(f)
    xs = np.arange(w, dtype=np.float32) / np.float32(f)
    y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
    fy, fx = (ys - y0)[:, None], xs - x0
    rows = a[:, x0] * (1 - fx) + a[:, x0 + 1] * fx
    return rows[y0] * (1 - fy) + rows[y0 + 1] * fy


def _pyramid(rng, h: int, w: int, cells) -> np.ndarray:
    """Noise octaves of equal amplitude (a 1/f amplitude spectrum), one a
    cell size from the coarsest: each octave a grid of seeded normal
    values, the sum so far upsampled onto the next grid, the last one onto
    the (h, w) pixels."""
    acc = None
    for cell in cells:
        grid = rng.standard_normal((h // cell + 3, w // cell + 3), dtype=np.float32)
        if acc is not None:
            acc = _upsample(acc, 2, *grid.shape)
            grid += acc
        acc = grid
    return _upsample(acc, cells[-1], h, w)


def photo_pixels(width: int, height: int, rng) -> np.ndarray:
    """(3, height, width) uint8, planes R, G, B: a luminance of noise octaves from 512 to
    4 pixels and five hard edges, two smoother chroma fields (512 to 32
    pixels) that shift at the edges too, mixed into RGB as YCbCr is, and
    sensor noise of about 2 LSB, mostly common to the channels as after
    demosaicing."""
    lum = _pyramid(rng, height, width, (512, 256, 128, 64, 32, 16, 8, 4))
    lum *= np.float32(40.0 / max(float(lum.std()), 1e-6))
    cb = _pyramid(rng, height, width, (512, 256, 128, 64, 32))
    cr = _pyramid(rng, height, width, (512, 256, 128, 64, 32))
    cb *= np.float32(14.0 / max(float(cb.std()), 1e-6))
    cr *= np.float32(14.0 / max(float(cr.std()), 1e-6))
    # five half-planes; each pixel's region picks its steps
    region = np.zeros((height, width), np.uint8)
    yy = np.arange(height, dtype=np.float32)[:, None]
    xx = np.arange(width, dtype=np.float32)[None, :]
    for k in range(5):
        a = float(rng.uniform(0, 2 * np.pi))
        ca, sa = np.cos(a) * width, np.sin(a) * height
        lo, hi = min(0.0, ca) + min(0.0, sa), max(0.0, ca) + max(0.0, sa)
        c = lo + float(rng.uniform(0.2, 0.8)) * (hi - lo)
        region |= (((xx * np.float32(np.cos(a)) + yy * np.float32(np.sin(a))) > np.float32(c))
                   .astype(np.uint8) << k)
    steps = rng.uniform(-1, 1, size=(3, 5)) * np.array([[45.0], [10.0], [10.0]])
    bits = (np.arange(32)[:, None] >> np.arange(5)[None, :]) & 1
    table = (bits @ steps.T).astype(np.float32)  # (32, 3): lum, cb, cr
    lum += table[region, 0] + np.float32(118.0)
    cb += table[region, 1]
    cr += table[region, 2]
    lum += np.float32(2.0) * rng.standard_normal((height, width), dtype=np.float32)
    out = np.empty((3, height, width), np.uint8)
    for k, (fb, fr) in enumerate(((0.0, 1.402), (-0.344, -0.714), (1.772, 0.0))):
        c = lum + np.float32(0.6) * rng.standard_normal((height, width), dtype=np.float32)
        if fb:
            c += np.float32(fb) * cb
        if fr:
            c += np.float32(fr) * cr
        np.clip(np.rint(c, out=c), 0, 255, out=c)
        out[k] = c
    return out


# -- the colour transforms ------------------------------------------------------------


def rct_forward(r, g, b, op: int):
    """The coded channels of RCT type `op` (permutation 0) from R, G, B
    (int32 arrays); the decoder's inverse gives R, G, B back."""
    if op == 0:
        return r, g, b
    if op == 1:
        return r, g, b - r
    if op == 2:
        return r, g - r, b
    if op == 3:
        return r, g - r, b - r
    if op == 4:
        return r, g - ((r + b) >> 1), b
    if op == 5:
        return r, g - ((r + b) >> 1), b - r
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    return t + (cg >> 1), co, cg


def rct_costs(lanes, valid) -> np.ndarray:
    """(7, G): each RCT type's sum of |v - clamped gradient| over each
    group's rows 8k + 1 (from the rows 8k above them) past its first
    column."""
    G, _, D, _ = lanes.shape
    two = lanes.reshape(G, 3, D // 8, 8, D)[:, :, :, :2]
    ok = valid.reshape(G, D // 8, 8, D)[:, None, :, 1, 1:]
    out = []
    for op in RCT_TYPES:
        ch = np.stack(rct_forward(two[:, 0], two[:, 1], two[:, 2], op), 1)
        v, top = ch[..., 1, 1:], ch[..., 0, 1:]
        left, tl = ch[..., 1, :-1], ch[..., 0, :-1]
        grad = np.minimum(np.maximum(left + top - tl, np.minimum(left, top)),
                          np.maximum(left, top))
        out.append((np.abs(v - grad) * ok).sum(axis=(1, 2, 3), dtype=np.int64))
    return np.stack(out)


# -- the group lanes ---------------------------------------------------------------------


def group_rects(width: int, height: int) -> list:
    """(x0, y0, w, h) of each group in raster order."""
    gx, gy = -(-width // GROUP_DIM), -(-height // GROUP_DIM)
    return [(i * GROUP_DIM, j * GROUP_DIM, min(GROUP_DIM, width - i * GROUP_DIM),
             min(GROUP_DIM, height - j * GROUP_DIM)) for j in range(gy) for i in range(gx)]


def to_lanes(planes) -> np.ndarray:
    """(3, H, W) -> (G, 3, D, D) int32, each group's tile at its top-left,
    zeros past the image."""
    _, h, w = planes.shape
    gx, gy = -(-w // GROUP_DIM), -(-h // GROUP_DIM)
    pad = np.zeros((3, gy * GROUP_DIM, gx * GROUP_DIM), np.uint8)
    pad[:, :h, :w] = planes
    return pad.reshape(3, gy, GROUP_DIM, gx, GROUP_DIM).transpose(1, 3, 0, 2, 4).reshape(
        gx * gy, 3, GROUP_DIM, GROUP_DIM).astype(np.int32)


# the error sums the weight table holds (a photo's stay far below)
WS_TABLE = 1 << 17


def weight_table(wp=WP_DEFAULT) -> np.ndarray:
    """(4 * WS_TABLE,) int32: each sub-predictor's weight for each error
    sum e, 4 + (w * (2^24 // ((e >> s) + 1)) >> s) with s = max(floor(log2
    (e + 1)) - 5, 0), the sub-predictors one after another."""
    e = np.arange(WS_TABLE, dtype=np.int64)
    sh = np.maximum(_log2_f64(e + 1) - 5, 0)
    w = np.array(wp[7:], np.int64)[:, None]
    return (4 + ((w * DIV_LUT[e >> sh]) >> sh)).astype(np.int32).reshape(-1)


def _wp_block(st, d, a, b, up, up2, lf, lf2, ne):
    """The weighted predictor at the samples y = a..b of wavefront d, whose
    edge rules are the same (up: y > 0, up2: y > 1, lf: x > 0, lf2: x > 1;
    ne: some lane's last column, where NE is N, is among them): a rule no
    sample falls under costs nothing. Data-dependent choices are
    arithmetic, not np.where (whose mispredicted branches cost more)."""
    R = 5
    val, err, perr = st["val"], st["err"], st["perr"]
    s0, s1, s2 = slice(a + 2, b + 3), slice(a + 1, b + 2), slice(a, b + 1)
    r0, r1, r2, r3, r4 = d % R, (d - 1) % R, (d - 2) % R, (d - 3) % R, (d - 4) % R
    ys = np.arange(a, b + 1)
    xs = d - 2 * ys
    shape = (b + 1 - a, val.shape[-1])
    if not (up and lf and lf2):
        zero, zero4 = np.zeros(shape, np.int32), np.zeros((4,) + shape, np.int32)
    # the neighbourhood with the decoder's edge rules, << 3
    vw = val[r1, s0] if lf else (val[r2, s1] if up else zero)
    vn = val[r2, s1] if up else vw
    vnw = val[r3, s1] if up and lf else vw
    vne = val[r1, s1] if up else vw
    vnn = val[r4, s2] if up2 else vn
    e_n = err[r2, s1] if up else zero
    e_w = err[r1, s0] if lf else zero
    e_nw = (err[r3, s1] if up else zero) if lf else e_n
    e_ne = err[r1, s1] if up else zero
    # the sub-predictors' error sums: N, W, NW, WW and NE at the decoder's
    # clamped positions (the last column reads N and W twice)
    a_n = perr[:, r2, s1] if up else zero4
    here = a_n + perr[:, r1, s0] if lf else a_n
    nw_side = ((perr[:, r3, s1] if up else zero4) + (perr[:, r2, s0] if lf2 else zero4)
               if lf else a_n)
    ne_side = perr[:, r1, s1] if up else zero4
    if ne:
        last = xs[:, None] + 1 >= st["widths"][None, :]
        if up:
            vne = np.where(last, vn, vne)
        e_ne = np.where(last, e_n, e_ne)
        ne_side = np.where(last, here, ne_side)
    e_sum = here + nw_side
    e_sum += ne_side
    if int(e_sum.max()) >= WS_TABLE:
        raise ValueError("an error sum past the weighted predictor's table")
    e_sum += st["koff"]
    ws = st["ws"].take(e_sum)
    p1c, p2c, p3a, p3b, p3c, p3d, p3e = st["wp"][:7]
    p0 = vw + vne - vn
    p1 = vn - (((e_w + e_n + e_ne) * p1c) >> 5)
    p2 = vw - (((e_w + e_n + e_nw) * p2c) >> 5)
    t3 = e_nw * p3a + e_n * p3b + e_ne * p3c
    if p3d:
        t3 += (vnn - vn) * p3d
    if p3e:
        t3 += (vnw - vw) * p3e
    p3 = vn - (t3 >> 5)
    wsum = ws[0] + ws[1]
    wsum += ws[2]
    wsum += ws[3]
    ws >>= _log2_f64(wsum) - 4
    wsum = ws[0] + ws[1]
    wsum += ws[2]
    wsum += ws[3]
    acc = (wsum >> 1) - 1 + ws[0] * p0 + ws[1] * p1 + ws[2] * p2 + ws[3] * p3
    prd = ((acc.astype(np.int64) * DIV_LUT.take(wsum - 1)) >> 24).astype(np.int32)
    clamp = ((e_n ^ e_w) | (e_n ^ e_nw)) <= 0
    c = np.minimum(np.maximum(prd, np.minimum(np.minimum(vw, vne), vn)),
                   np.maximum(np.maximum(vw, vne), vn))
    prd += (c - prd) * clamp
    st["pred"][ys, xs] = (prd + PRED_ROUND) >> PRED_EXTRA_BITS
    mx, amx = e_w, np.abs(e_w)
    for e in (e_n, e_nw, e_ne):  # the first of the largest magnitude
        ae = np.abs(e)
        mx = mx + (e - mx) * (ae > amx)
        amx = np.maximum(amx, ae)
    st["prop"][ys, xs] = mx
    v8 = st["v8"][ys, xs]
    val[r0, s0] = v8
    err[r0, s0] = prd - v8
    for k, p in enumerate((p0, p1, p2, p3)):
        p -= v8
        np.abs(p, out=p)
        p += PRED_ROUND
        p >>= PRED_EXTRA_BITS
        perr[k, r0, s0] = p


def weighted_pass(lanes, widths, rows: int = GROUP_DIM, wp=WP_DEFAULT):
    """The weighted predictor over every lane (L, D, D) of known int32
    samples, as the decoder runs it channel by channel: its rounded
    prediction and its max-error property (property 15) at each sample,
    (L, D, D) int32 each. The state runs along the wavefronts x + 2y, all
    lanes and all samples of a wavefront in one step (lanes innermost),
    each lane's last five wavefronts kept (a sample reads back to NN, four
    wavefronts before it); `widths` (L,) are the lanes' widths, whose last
    column takes N for NE, and `rows` the most rows a lane has. Samples
    past a lane's width or height are computed from zeros and read by
    none."""
    L, D, R = lanes.shape[0], GROUP_DIM, 5
    widths = np.asarray(widths, np.int64)
    st = {"v8": np.ascontiguousarray(lanes.transpose(1, 2, 0)) << PRED_EXTRA_BITS,
          "val": np.zeros((R, D + 2, L), np.int32),  # by wavefront mod R, y + 2
          "err": np.zeros((R, D + 2, L), np.int32),  # the true errors
          "perr": np.zeros((4, R, D + 2, L), np.int32),  # the sub-predictors' errors
          "pred": np.zeros((D, D, L), np.int32), "prop": np.zeros((D, D, L), np.int32),
          "widths": widths, "wp": wp,
          "ws": weight_table(wp),
          "koff": (WS_TABLE * np.arange(4, dtype=np.int32))[:, None, None]}
    w_min = int(widths.min())
    for d in range(D + 2 * rows - 2):
        lo, hi = max(0, (d - D + 2) // 2), min(rows - 1, d // 2)
        y = np.arange(lo, hi + 1)
        x = d - 2 * y
        flags = np.stack([y > 0, y > 1, x > 0, x > 1, x + 1 >= w_min], 1)
        # runs of samples under the same edge rules (most of a wavefront
        # is one run under none)
        cut = np.flatnonzero((flags[1:] != flags[:-1]).any(1)) + 1
        for s, e in zip(np.concatenate([[0], cut]), np.concatenate([cut, [len(y)]])):
            _wp_block(st, d, lo + int(s), lo + int(e) - 1, *map(bool, flags[s]))
    return (np.ascontiguousarray(st["pred"].transpose(2, 0, 1)),
            np.ascontiguousarray(st["prop"].transpose(2, 0, 1)))


def neighbours(v, widths):
    """The decoder's neighbourhood of every sample of lanes (L, D, D):
    left, top, topleft, topright, toptop, leftleft, with its edge rules
    (the first column's left is the sample above; the first row's
    neighbours are its left; topright past a lane's width is top)."""
    D = v.shape[-1]
    left = np.zeros_like(v)
    left[:, :, 1:] = v[:, :, :-1]
    left[:, 1:, 0] = v[:, :-1, 0]
    top = left.copy()
    top[:, 1:] = v[:, :-1]
    topleft = left.copy()
    topleft[:, 1:, 1:] = v[:, :-1, :-1]
    topright = left.copy()
    topright[:, 1:, :-1] = v[:, :-1, 1:]
    edge = np.arange(D)[None, None, :] + 1 >= np.asarray(widths)[:, None, None]
    topright[:, 1:] = np.where(edge, top[:, 1:], topright[:, 1:])
    toptop = top.copy()
    toptop[:, 2:] = v[:, :-2]
    leftleft = left.copy()
    leftleft[:, :, 2:] = v[:, :, :-2]
    return {"left": left, "top": top, "topleft": topleft, "topright": topright,
            "toptop": toptop, "leftleft": leftleft}


def clamped_gradient(left, top, topleft):
    mn, mx = np.minimum(left, top), np.maximum(left, top)
    return np.where(topleft < mn, mx, np.where(topleft > mx, mn, left + top - topleft))


# -- the tree -------------------------------------------------------------------------------

# the neighbour differences among the properties
DIFFS = {10: ("left", "topleft"), 11: ("topleft", "top"), 12: ("top", "topright"),
         13: ("top", "toptop"), 14: ("left", "leftleft")}


def _split(prop, val, left, right):
    """A node: property `prop` > `val` takes `left`, else `right`."""
    return ("split", prop, int(val), left, right)


def _leaf(predictor, channel):
    return ("leaf", predictor, channel)


def channel_subtree(kind: str, c: int, q):
    """The subtree of channel c; q(p) is the quantile p of the channel's
    property 15."""
    G, W = GRADIENT, WEIGHTED
    if kind == "photo":
        return _split(15, q(0.5),
                      _split(15, q(0.85), _leaf(G, c),
                             _split(12, 0, _leaf(G, c), _leaf(W, c))),
                      _split(14, 0, _split(15, q(0.25), _leaf(W, c), _leaf(G, c)),
                             _leaf(W, c)))
    return _split(13, 0,
                  _split(15, q(0.6), _split(10, 0, _leaf(G, c), _leaf(W, c)), _leaf(W, c)),
                  _split(11, 0, _leaf(G, c),
                         _split(15, q(0.3), _leaf(G, c), _leaf(W, c))))


def build_tree(kind: str, prop15) -> tuple:
    """Split on the channel (property 0), then each channel's subtree;
    prop15[c] holds channel c's property 15 at its samples."""
    def q(c):
        return lambda p: int(np.quantile(prop15[c], p, method="lower"))

    subs = [channel_subtree(kind, c, q(c)) for c in range(3)]
    return _split(0, 1, subs[2], _split(0, 0, subs[1], subs[0]))


def _props_of(tree) -> set:
    """The properties the tree's splits read."""
    return {n[1] for n in bfs(tree) if n[0] == "split"}


def leaf_planes(tree, c: int, props, leaves):
    """The index in `leaves` of the leaf every sample of channel c reaches:
    the splits on the channel resolved, each other split's test a bit of
    a code over the planes of `props` ({property: array}), the code's
    leaf from a table that walks the subtree for each code."""
    while tree[0] == "split" and tree[1] == 0:
        tree = tree[3] if c > tree[2] else tree[4]
    splits = [n for n in bfs(tree) if n[0] == "split"]
    if len(splits) > 8:
        raise ValueError("a channel subtree of more than 8 splits")
    ids = {id(n): k for k, n in enumerate(leaves)}
    bit = {id(n): k for k, n in enumerate(splits)}
    table = np.zeros(1 << len(splits), np.int32)
    for code in range(len(table)):
        n = tree
        while n[0] == "split":
            n = n[3] if code >> bit[id(n)] & 1 else n[4]
        table[code] = ids[id(n)]
    code = np.zeros(next(iter(props.values())).shape, np.uint8)
    for n in splits:
        code |= (props[n[1]] > n[2]).view(np.uint8) << bit[id(n)]
    return table[code]


# -- the codestream ----------------------------------------------------------------------


def _headers(width: int, height: int, sections: list) -> bytes:
    """The codestream's headers (8-bit RGB, not XYB, sRGB) and the frame
    header of one REGULAR Modular frame, 256x256 groups, gaborish off and
    no EPF, then the TOC."""
    w = BW()
    w.write(0xFF, 8)
    w.write(0x0A, 8)
    sizes = (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30))
    w.write(0, 1)  # SizeHeader: not small
    u32(w, sizes, height - 1)
    w.write(0, 3)  # ratio
    u32(w, sizes, width - 1)
    w.write(0, 1)  # ImageMetadata all_default = 0
    w.write(0, 1)  # extra_fields = 0
    w.write(0, 1)  # bit_depth: integer samples
    w.write(0, 2)  # bits_per_sample Val(8)
    w.write(1, 1)  # modular_16bit_sufficient
    w.write(0, 2)  # no extra channels
    w.write(0, 1)  # xyb_encoded = 0
    w.write(1, 1)  # colour_encoding all_default (sRGB)
    w.write(0, 2)  # extensions
    w.write(1, 1)  # CustomTransformData all_default
    w.pad_to_byte()
    w.write(0, 1)  # FrameHeader all_default = 0
    w.write(0, 2)  # REGULAR
    w.write(1, 1)  # MODULAR
    u64(w, 0)  # flags
    w.write(0, 1)  # do_ycbcr = 0
    u32(w, (("val", 1), ("val", 2), ("val", 4), ("val", 8)), 1)  # upsampling
    w.write(1, 2)  # group_size_shift = 1 -> 256
    u32(w, (("val", 1), ("val", 2), ("val", 3), ("bitsoff", 3, 4)), 1)  # passes
    w.write(0, 1)  # have_crop = 0
    u32(w, (("val", 0), ("val", 1), ("val", 2), ("bitsoff", 2, 3)), 0)  # REPLACE
    w.write(1, 1)  # is_last
    u32(w, (("val", 0), ("bits", 4), ("bitsoff", 5, 16), ("bitsoff", 10, 48)), 0)  # name
    w.write(0, 1)  # RestorationFilter: not all_default
    w.write(0, 1)  # gaborish off
    w.write(0, 2)  # epf_iters 0
    w.write(0, 2)  # extensions
    w.write(0, 2)  # extensions
    w.write(0, 1)  # TOC not permuted
    w.pad_to_byte()
    for s in sections:
        u32(w, (("bits", 10), ("bitsoff", 14, 1024), ("bitsoff", 22, 17408),
                ("bitsoff", 30, 4211712)), len(s))
    w.pad_to_byte()
    return w.finish()


def _group_header(w, rct: int):
    """GroupHeader: the global tree, the default WP header, and the RCT
    unless it is the identity."""
    w.write(1, 1)  # use_global_tree
    w.write(1, 1)  # wp_header all_default
    if rct == 0:
        w.write(0, 2)  # no transforms
        return
    w.write(1, 2)  # one transform
    w.write(0, 2)  # RCT
    w.write(0, 2)  # begin_c: Bits(3) = 0
    w.write(0, 3)
    u32(w, (("val", 6), ("bits", 2), ("bitsoff", 4, 2), ("bitsoff", 6, 10)), rct)


def encode_rgb_lossless(width: int, height: int, seed: int = 0, rct=None, tree: str = "photo"):
    """(codestream, coded) of a seeded photo-like 8-bit RGB image coded
    losslessly as cjxl -d 0 -e 7 codes one (module docstring). rct: None
    (each group its cheapest of RCT_TYPES) or one type for every group.
    tree: "photo" (property 15 at three quantiles, 12 and 14) or "mixed"
    (13, 15 at two quantiles, 10 and 11). coded: "pixels" (H, W, 3) uint8,
    "rects" [(x0, y0, w, h)] of the groups, "rct" (G,), "residuals" (G,
    3, 256, 256) int16 (each group's coded channels at its top-left),
    "tree" (nested tuples: ("split", property, value, >, <=) and ("leaf",
    predictor, channel)), "wp" (the WP header's eleven numbers) and
    "weighted_share" (each channel's share of samples on Weighted
    leaves)."""
    if tree not in TREES:
        raise ValueError(f"tree: one of {TREES}")
    rng = np.random.default_rng(seed)
    planes = photo_pixels(width, height, rng)
    rects = group_rects(width, height)
    G, D = len(rects), GROUP_DIM
    lanes = to_lanes(planes)
    gw, gh = np.array([r[2] for r in rects]), np.array([r[3] for r in rects])
    valid = ((np.arange(D)[None, :, None] < gh[:, None, None])
             & (np.arange(D)[None, None, :] < gw[:, None, None]))  # (G, D, D)

    # each group's RCT, then its coded channels
    rcts = (np.argmin(rct_costs(lanes, valid), axis=0) if rct is None
            else np.full(G, int(rct)))
    coded_lanes = np.empty_like(lanes)
    for op in np.unique(rcts).tolist():
        m = rcts == op
        coded_lanes[m] = np.stack(rct_forward(lanes[m, 0], lanes[m, 1], lanes[m, 2], op), 1)
    coded_lanes *= valid[:, None]

    # the weighted predictor, the tree, each sample's leaf and residual
    wp_pred, prop15 = weighted_pass(coded_lanes.reshape(G * 3, D, D), np.repeat(gw, 3),
                                    int(gh.max()))
    wp_pred, prop15 = wp_pred.reshape(G, 3, D, D), prop15.reshape(G, 3, D, D)
    the_tree = build_tree(tree, [prop15[:, c][valid] for c in range(3)])
    leaves = [n for n in bfs(the_tree) if n[0] == "leaf"]
    # a cluster a channel and predictor; samples past the image take
    # cluster C and are coded by no stream
    clusters = sorted({(n[2], n[1]) for n in leaves})
    cmap = [clusters.index((n[2], n[1])) for n in leaves]
    C = len(clusters)
    is_w = np.array([n[1] == WEIGHTED for n in leaves])
    residuals = np.zeros((G, 3, D, D), np.int32)
    cl = np.zeros((G, 3, D, D), np.uint8)
    shares = []
    for c in range(3):
        v = coded_lanes[:, c]
        nb = neighbours(v, gw)
        props = {15: prop15[:, c]}
        props.update({p: nb[a] - nb[b] for p, (a, b) in DIFFS.items()
                      if p in _props_of(the_tree)})
        leaf = leaf_planes(the_tree, c, props, leaves)
        weighted = is_w[leaf]
        guess = clamped_gradient(nb["left"], nb["top"], nb["topleft"])
        np.copyto(guess, wp_pred[:, c], where=weighted)
        residuals[:, c] = (v - guess) * valid
        cl[:, c] = np.where(valid, np.array(cmap, np.uint8)[leaf], C)
        shares.append(float(weighted[valid].mean()))

    # the tokens and the histograms fitted to them
    if residuals.min() < -RESIDUAL_LIMIT or residuals.max() >= RESIDUAL_LIMIT:
        raise ValueError("a residual past the writer's token table")
    r = residuals + RESIDUAL_LIMIT
    tk, raw, nraw = _TOKENS[0].take(r), _TOKENS[1].take(r), _TOKENS[2].take(r)
    counts = np.bincount((cl.astype(np.int32) * 64 + tk).reshape(-1), minlength=(C + 1) * 64)
    coding = Coding(cmap, RESIDUAL_UINT, counts.reshape(C + 1, 64)[:C])
    lengths = 3 * gw * gh
    T = int(lengths.max())

    def lanes_of(a, dtype):
        out = np.zeros((G, T), dtype)
        for k in range(G):
            out[k, : lengths[k]] = a[k, :, : gh[k], : gw[k]].reshape(-1)
        return out

    state, words, has = rans_encode_lanes(coding, lanes_of(tk, np.int32), lanes_of(cl, np.int32),
                                          lengths)
    svals, snb = stream_pieces(state, words, has, lanes_of(raw, np.uint32),
                               lanes_of(nraw, np.int8))

    lg = Bits()
    lg.write(1, 1)  # LfChannelDequantization all_default
    lg.write(1, 1)  # a global tree
    write_tree(lg, the_tree)
    coding.write(lg)
    if G == 1:  # the global image's header, its RCT and its channels
        _group_header(lg, int(rcts[0]))
        lg.extend(svals[0], snb[0])
        sections = [lg.finish()]
    else:
        _group_header(lg, 0)  # the global image: no channel fits in it
        heads = []
        for op in rcts.tolist():
            h = Bits()
            _group_header(h, op)
            heads.append(h.arrays())
        n = max(len(v) for v, _ in heads)  # each group's header, padded with empty pieces
        hv = np.array([np.pad(v, (0, n - len(v))) for v, _ in heads], np.uint32)
        hn = np.array([np.pad(b, (0, n - len(b))) for _, b in heads], np.int8)
        groups = pack_bits(np.concatenate([hv, svals], 1), np.concatenate([hn, snb], 1))
        num_lf = -(-width // (8 * GROUP_DIM)) * -(-height // (8 * GROUP_DIM))
        sections = [lg.finish()] + [b""] * num_lf + [b""] + groups
    coded = {"pixels": np.ascontiguousarray(planes.transpose(1, 2, 0)), "rects": rects, "rct": rcts,
             "residuals": residuals.astype(np.int16), "tree": the_tree, "wp": WP_DEFAULT,
             "weighted_share": shares}
    return _headers(width, height, sections) + b"".join(sections), coded


# -- the port, the JAX package and the plain reference read the streams back -

# id: (width, height, seed, options); each RCT type forced on every group
CASES = {
    "one_group": (256, 256, 11, {}),
    "groups": (600, 520, 2**40 + 12, {}),
    "edge_groups": (1000, 700, 3_000_000_013, {}),
    "mixed_tree": (600, 520, 14, {"tree": "mixed"}),
    "one_group_mixed_tree": (256, 256, 15, {"tree": "mixed"}),
    **{f"rct{op}": (264, 72, 20 + op, {"rct": op}) for op in RCT_TYPES},
}


def _reference():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.reference import rgb_lossless

    return rgb_lossless


@pytest.mark.parametrize("case", list(CASES))
def test_every_decoder_gives_the_source_pixels(case):
    """jxl_tpu_torch.decode_image, the benchmark's plain reference and the
    JAX package all give the writer's source pixels, bit for bit."""
    import torch

    import jxl_tpu_torch
    from jxl_tpu.api.simple import decode_first_frame

    w, h, seed, kw = CASES[case]
    data, coded = encode_rgb_lossless(w, h, seed, **kw)
    want = coded["pixels"]
    got = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(_reference().render(coded, w, h, "cpu").numpy(), want)
    jax_planes = decode_first_frame(data).channels[:3]
    assert np.array_equal(np.stack([np.asarray(p) for p in jax_planes], -1), want)
    # each channel's samples split between both predictors
    assert all(0.25 <= s <= 0.75 for s in coded["weighted_share"]), coded["weighted_share"]
    if "rct" in kw:
        assert (coded["rct"] == kw["rct"]).all()
    elif len(coded["rects"]) > 1:
        assert (coded["rct"] != 0).any()  # correlated channels: an RCT pays off


@pytest.mark.parametrize("case", ["one_group", "edge_groups"])
def test_counters_and_spans_of_a_lossless_decode(case):
    """Under tracing, the native decoder counts each group's sub-bitstream
    (the global one of a one-group frame) and every sample in its general
    tree loop; the group decode and the planes' conversion have spans."""
    import jxl_tpu_torch
    from jxl_tpu_torch.utils import trace

    w, h, seed, kw = CASES[case]
    data, coded = encode_rgb_lossless(w, h, seed, **kw)
    was = trace.enabled()
    trace.enable()
    trace.reset()
    try:
        jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu")
        counts = dict(trace.metrics.counters)
        spans = set(trace.host_seconds())
    finally:
        trace.enable(was)
        trace.reset()
    assert counts["modular_group_streams"] == len(coded["rects"])
    assert counts["modular_tree_samples"] == 3 * w * h
    assert {"frame.modular_groups", "render.modular_planes"} <= spans


@pytest.mark.parametrize("tree", TREES)
def test_tree_mixes_both_predictors_in_every_channel(tree):
    """Each channel's subtree reads property 15 and a neighbour difference
    and ends in Weighted and Gradient leaves, at most 4 splits deep under
    the channel split, so no channel is channel-static or WP-only."""
    _, coded = encode_rgb_lossless(264, 72, 31, tree=tree)

    def depth(n):
        return 0 if n[0] == "leaf" else 1 + max(depth(n[3]), depth(n[4]))

    root = coded["tree"]
    for c in range(3):
        sub = root
        while sub[0] == "split" and sub[1] == 0:
            sub = sub[3] if c > sub[2] else sub[4]
        nodes = bfs(sub)
        props = {n[1] for n in nodes if n[0] == "split"}
        assert 15 in props and props & set(DIFFS), props
        assert {n[1] for n in nodes if n[0] == "leaf"} == {WEIGHTED, GRADIENT}
        assert depth(sub) <= 4


def _packed(*nodes):
    """A packed tree (native.pack_tree's rows) from ("split", property)
    and ("leaf", predictor, offset) nodes in breadth-first order."""
    rows, nxt = [], 1
    for n in nodes:
        if n[0] == "split":
            rows.append((n[1], 0, nxt, nxt + 1, 0, 0, 1, 0))
            nxt += 2
        else:
            rows.append((-1, 0, 0, 0, n[1], n[2], 1, 0))
    return np.array(rows, dtype=np.int32)


@pytest.mark.parametrize("nodes, num_props, residuals, general", [
    ((("leaf", GRADIENT, 0),), 16, False, False),  # gradient-only
    ((("split", 0), ("leaf", GRADIENT, 0), ("leaf", GRADIENT, 0)), 16, False, False),
    ((("split", 0), ("leaf", 1, 0), ("leaf", 2, 0)), 16, True, False),  # residual mode
    ((("split", 0), ("leaf", 1, 0), ("leaf", 2, 0)), 16, False, True),
    ((("split", 15), ("leaf", WEIGHTED, 0), ("leaf", 0, 0)), 16, False, False),  # WP-only
    ((("split", 15), ("leaf", WEIGHTED, 0), ("leaf", 0, 0)), 20, False, True),
    ((("split", 15), ("leaf", WEIGHTED, 0), ("leaf", GRADIENT, 0)), 16, False, True),
    ((("split", 0), ("leaf", GRADIENT, 1), ("leaf", GRADIENT, 0)), 16, False, True),
    ((("leaf", WEIGHTED, 0),), 16, False, True),
])
def test_general_loop_counter_follows_the_native_loop_choice(nodes, num_props, residuals, general):
    """`modular_tree_samples` counts a sub-bitstream's samples only for the
    trees that jxl_decode_modular sends through its general loop."""
    from jxl_tpu_torch.native import _runs_general_loop

    assert _runs_general_loop(_packed(*nodes), num_props, residuals) == general
