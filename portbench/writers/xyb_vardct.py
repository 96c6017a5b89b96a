"""The benchmark's VarDCT writer: a single-frame 4:4:4 XYB VarDCT
codestream of seeded random content, with a real encoder's coding tables.

A frozen copy, as of the first benchmark, of the repository's test writer
(tests/test_torch_vardct_streams.py::encode_xyb_vardct), cut to the
options a configuration of the benchmark uses and writing the same bytes
for them. It imports nothing of the decoder: the format's tables come
from spec.py. Beside the bytes it returns what it put in, for the plain
reference (reference/xyb_vardct.py) and the roofline counts
(metrics/k3_roofline_share.py): the quantized LF, the HF metadata (the
transform map, raw quant, EPF sharpness, chroma from luma), the dequant
tables as coded, and the dense quantized AC coefficients.

The frame: gaborish and EPF (2 steps) unless filters=False, one pass, the
quantizer's global scale 4096 (TABLES_GLOBAL_SCALE with custom LF
quantization) and quant_lf 16, default CfL and opsin. LfGlobal carries a
global MA tree whose tokens are rANS-coded; its Zero-predictor leaves
code the LF (4 values a channel), a CfL map of small values, transform
types by band of each LF group's coefficient list (DCT8 and DCT16x16 in
every band beside two other 1x1 types: all ten 1x1 types), raw quant 9,
11, 13 or 15 and EPF sharpness 0-7. HfGlobal codes the dequant matrices
(`dequant`), the coefficient orders (`orders`), and AC histogram sets
over flat rANS clusters; every token's context is computed as the
decoder computes it, and each group's tokens are rANS-encoded from the
final state 0x130000, vectorized across groups.
"""

from __future__ import annotations

import numpy as np

from . import spec
from .mini_encoder import BW, token_bits, u32, u64

GROUP_DIM = 256
GD_BLOCKS = GROUP_DIM // 8
LF_GROUP_BLOCKS = 256  # 2048 px
GROUP_STRIDE = 3 * GROUP_DIM * GROUP_DIM
FINAL_STATE = 0x130000
NUM_BCTX = 15  # default block context map
NUM_AC_CONTEXTS = NUM_BCTX * (37 + 458)
CTX_PAD = 16  # ZERO_DENSITY_CONTEXT_LIMIT - ZERO_DENSITY_CONTEXT_COUNT
LOG_ALPHA = 6
AC_ALPHABETS = (64, 48, 40)
AC_UINT = ((6, 0, 0), (6, 0, 0), (4, 1, 0))  # split_exponent, msb, lsb
TREE_UINT = (4, 0, 0)
DCT16 = spec.DCT16X16
# 1x1 types beside DCT8 (0), two per band of the coefficient list
BAND_TYPES = ((2, 3), (1, 12), (13, 14), (15, 16), (17, 2))
MAX_COEFF = 20

_FREQ_CTX = np.array(
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 15, 16, 16, 17, 17, 18, 18,
     19, 19, 20, 20, 21, 21, 22, 22, 23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26,
     26, 26, 27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30])
_NUM_NZ_CTX = np.array(
    [0, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123, 152, 152, 152, 152, 152, 152,
     152, 152, 180, 180, 180, 180, 180, 180, 180, 180, 180, 180, 180, 180]
    + [206] * 31)
_CBX = np.array(spec.CBX)
_CBY = np.array(spec.CBY)
_SHAPES = np.array(spec.SHAPE_ID)

_ceil_log2 = spec._ceil_log2


def _signed_token(v):
    v = np.asarray(v, dtype=np.int64)
    return np.where(v >= 0, 2 * v, -2 * v - 1)


def _residual(tok):
    tok = np.asarray(tok, dtype=np.int64)
    return np.where(tok & 1, -((tok + 1) >> 1), tok >> 1)


class BitList:
    """LSB-first bit writer that takes single values and numpy arrays of
    (value, nbits) and packs everything at once."""

    def __init__(self):
        self.vals = []
        self.nbits = []

    def write(self, value: int, nbits: int):
        self.vals.append(np.array([value & ((1 << nbits) - 1) if nbits else 0], np.uint64))
        self.nbits.append(np.array([nbits], np.int64))

    def extend(self, vals, nbits):
        self.vals.append(np.asarray(vals, dtype=np.uint64).reshape(-1))
        self.nbits.append(np.asarray(nbits, dtype=np.int64).reshape(-1))

    def finish(self) -> bytes:
        vals = np.concatenate(self.vals) if self.vals else np.zeros(0, np.uint64)
        nb = np.concatenate(self.nbits) if self.nbits else np.zeros(0, np.int64)
        keep = nb > 0
        vals, nb = vals[keep], nb[keep]
        if not len(nb):
            return b""
        width = int(nb.max())
        bits = (vals[:, None] >> np.arange(width, dtype=np.uint64)[None, :]) & np.uint64(1)
        flat = bits.astype(np.uint8)[np.arange(width)[None, :] < nb[:, None]]
        return np.packbits(flat, bitorder="little").tobytes()


# -- entropy coding ------------------------------------------------------------


def hybrid_encode(v, cfg):
    """HybridUint (split_exponent, msb, lsb): values -> (tokens, raw bits,
    raw bit counts)."""
    se, msb, lsb = cfg
    v = np.asarray(v, dtype=np.int64)
    small = v < (1 << se)
    n = np.zeros_like(v)
    big = np.maximum(v, 1)
    while True:  # n = floor(log2 v), exactly
        more = (big >> (n + 1)) > 0
        if not more.any():
            break
        n += more
    nbits = n - msb - lsb
    low = v & ((1 << lsb) - 1)
    msb_bits = (v >> (lsb + np.maximum(nbits, 0))) & ((1 << msb) - 1)
    raw = (v >> lsb) & ((np.int64(1) << np.maximum(nbits, 0)) - 1)
    tok = (1 << se) + (((n - se) << (msb + lsb)) | (msb_bits << lsb) | low)
    return (np.where(small, v, tok), np.where(small, 0, raw),
            np.where(small, 0, nbits))


def inverse_tables(hists):
    """(freq (C, T), inv (C, T, max_freq)) over tables of T symbols:
    inv[c, sym, off] is the 12-bit slot the alias table maps to (sym,
    off)."""
    freq = np.array([h.dist for h in hists], dtype=np.int64)
    inv = np.zeros((len(hists), freq.shape[1], int(freq.max())), dtype=np.int64)
    idx = np.arange(1 << 12)
    for c, h in enumerate(hists):
        i = idx >> h.log_bucket_size
        pos = idx & h.bucket_mask
        cut = np.asarray(h.alias_cutoff)[i]
        alias = pos >= cut
        sym = np.where(alias, np.asarray(h.alias_symbol)[i], i)
        off = np.where(alias, np.asarray(h.alias_offset)[i] + pos, pos)
        inv[c, sym, off] = idx
    return freq, inv


def rans_encode_lanes(tok, cl, lengths, freq, inv):
    """rANS-encode each lane's tokens (S, T) with clusters (S, T) backward
    from FINAL_STATE. Returns (initial states (S,), words (S, T), has_word
    (S, T)): the decoder reads word t right after decoding token t."""
    S, T = tok.shape
    state = np.full(S, FINAL_STATE, dtype=np.int64)
    words = np.zeros((S, T), dtype=np.int64)
    has = np.zeros((S, T), dtype=bool)
    for t in range(T - 1, -1, -1):
        act = t < lengths
        f = np.where(act, freq[cl[:, t], tok[:, t]], 1)
        need = act & (state >= (f << 20))
        words[:, t] = state & 0xFFFF
        has[:, t] = need
        state = np.where(need, state >> 16, state)
        q, r = np.divmod(state, f)
        state = np.where(act, q * 4096 + inv[cl[:, t], tok[:, t], np.where(act, r, 0)], state)
    return state, words, has


def hybrid_tokens(vals, clusters, uint_cfgs, alphabets):
    """(tokens, raw bits, raw bit counts) of `vals`, each value coded with
    its cluster's HybridUint config."""
    vals = np.asarray(vals, np.int64)
    clusters = np.asarray(clusters, np.int64)
    tk, raw, nraw = (np.zeros(len(vals), np.int64) for _ in range(3))
    for ci, cfg in enumerate(uint_cfgs):
        m = clusters == ci
        tk[m], raw[m], nraw[m] = hybrid_encode(vals[m], cfg)
        if not (tk[m] < alphabets[ci]).all():
            raise ValueError("a token outside its cluster's alphabet")
    return tk, raw, nraw


def write_rans_stream(w, tk, cl, raw, nraw, alphabets, log_alpha=LOG_ALPHA):
    """One rANS stream of tokens `tk` in clusters `cl` (flat histograms
    over `alphabets`) into the BitList w: the initial state, then each
    token's renormalization word and its raw bits."""
    freq, inv = inverse_tables([spec.FlatHistogram(a, log_alpha) for a in alphabets])
    tk, cl = np.asarray(tk, np.int64), np.asarray(cl, np.int64)
    state, words, has = rans_encode_lanes(tk[None], cl[None], np.array([len(tk)]), freq, inv)
    w.write(int(state[0]), 32)
    w.extend(np.stack([words[0], raw], 1), np.stack([np.where(has[0], 16, 0), nraw], 1))


def write_context_map(w, cmap) -> None:
    """A context map: the simple form (at most 3 bits an entry) when its
    clusters fit, else entropy-coded without move-to-front, its entries
    coded with HybridUint (4, 1, 0) in one flat 64-symbol rANS cluster."""
    bits = _ceil_log2(max(cmap) + 1)
    if bits <= 3:
        w.write(1, 1)  # simple context map
        w.write(bits, 2)
        if bits:
            w.extend(np.asarray(cmap), np.full(len(cmap), bits))
        return
    w.write(0, 1)  # not simple
    w.write(0, 1)  # no move-to-front
    cfg = (4, 1, 0)
    write_ans_flat_histograms(w, [0], [64], [cfg])
    tk, raw, nraw = hybrid_encode(np.asarray(cmap), cfg)
    write_rans_stream(w, tk, np.zeros(len(tk), np.int64), raw, nraw, [64])


def write_ans_flat_histograms(w, cmap, alphabets, uint_cfgs, log_alpha=LOG_ALPHA):
    """Histograms bundle without LZ77: context map `cmap`, ANS at
    `log_alpha` (5 to 8), per-cluster HybridUint configs and flat
    distributions."""
    w.write(0, 1)
    if len(cmap) > 1:
        write_context_map(w, cmap)
    w.write(0, 1)  # ANS
    w.write(log_alpha - 5, 2)
    for se, msb, lsb in uint_cfgs:
        w.write(se, _ceil_log2(log_alpha + 1))
        if se != log_alpha:
            w.write(msb, _ceil_log2(se + 1))
            w.write(lsb, _ceil_log2(se - msb + 1))
    for a in alphabets:
        w.write(0, 1)
        w.write(1, 1)  # evenly distributed
        v = a - 1  # read_u8
        if v == 0:
            w.write(0, 1)
        else:
            n = v.bit_length() - 1
            w.write(1, 1)
            w.write(n, 3)
            w.write(v - (1 << n), n)


def write_prefix_clusters(w, cmap, token_sets):
    """Histograms bundle: simple context map `cmap` over clusters that are
    Brotli-simple prefix codes of 1-4 tokens each (token == value)."""
    w.write(0, 1)  # no lz77
    if len(cmap) > 1:
        bits = _ceil_log2(max(cmap) + 1)
        w.write(1, 1)
        w.write(bits, 2)
        for c in cmap:
            w.write(c, bits)
    w.write(1, 1)  # prefix codes
    for _ in token_sets:
        w.write(15, 4)  # split_exponent 15: token == value
    sizes = [max(t) + 1 for t in token_sets]
    for s in sizes:
        _varint16(w, s - 1)
    for toks, s in zip(token_sets, sizes):
        if s == 1:
            continue
        toks = sorted(toks)
        w.write(1, 2)
        w.write(len(toks) - 1, 2)
        for t in toks:
            w.write(t, _ceil_log2(s))
        if len(toks) == 4:
            w.write(0, 1)


def _varint16(w, v: int):
    if v == 0:
        w.write(0, 1)
        return
    w.write(1, 1)
    if v == 1:
        w.write(0, 4)
        return
    nbits = v.bit_length() - 1
    w.write(nbits, 4)
    w.write(v - (1 << nbits), nbits)


def _code_lut(tokens):
    """(code, nbits) arrays indexed by token for one simple prefix code."""
    size = max(tokens) + 1
    code = np.zeros(size, np.int64)
    nb = np.zeros(size, np.int64)
    for t in tokens:
        code[t], nb[t] = token_bits(set(tokens), t)
    return code, nb


# -- the MA tree -----------------------------------------------------------------


def _split(prop, val, left, right):
    return ("split", prop, val, left, right)


def _leaf(key, offset, mul_log):
    return ("leaf", key, offset, mul_log)


S0 = (0, 1, 2, 3)  # residuals 0, -1, 1, -2
# RAW dequant table leaves: (offset, log2 multiplier), and the last row of
# qt_lo (a JPEG table's coarser steps are its higher frequencies)
QT_LEAVES = {"qt_lo": (12, 1), "qt_hi": (40, 3)}
QT_SPLIT_ROW = 3


def _leaf_sets():
    sets = {k: S0 for k in ("lf_y", "lf_x", "lf_b", "cfl", "quant", "epf_lo", "epf_hi",
                            "qt_lo", "qt_hi")}
    for b, extra in enumerate(BAND_TYPES):
        sets[f"band{b}"] = tuple(sorted(_signed_token((0, DCT16) + extra).tolist()))
    return sets


def build_tree(num_lf_groups: int, band_step: int, qtables: bool = False):
    """The global tree: transform types by band of the list index
    (BAND_TYPES); qtables: the streams of RAW dequant tables (ids past 3 *
    num_lf_groups) take two leaves by row (QT_LEAVES)."""
    types = _leaf("band0", 0, 0)
    for b in range(1, len(BAND_TYPES)):
        types = _split(3, b * band_step - 1, _leaf(f"band{b}", 0, 0), types)
    meta = _split(0, 1,
                  _split(0, 2,
                         _split(3, 31, _leaf("epf_hi", 6, 0), _leaf("epf_lo", 2, 0)),
                         _split(2, 0, _leaf("quant", 8, 1), types)),
                  _leaf("cfl", 0, 0))
    lf = _split(0, 0, _split(0, 1, _leaf("lf_b", 0, 2), _leaf("lf_x", 0, 3)),
                _leaf("lf_y", 256, 4))
    tree = _split(1, num_lf_groups, meta, lf)
    if qtables:
        qt = _split(2, QT_SPLIT_ROW, _leaf("qt_hi", *QT_LEAVES["qt_hi"]),
                    _leaf("qt_lo", *QT_LEAVES["qt_lo"]))
        tree = _split(1, 3 * num_lf_groups, qt, tree)
    return tree


def write_tree(w, tree):
    """Tree tokens (rANS, one flat cluster, HybridUint TREE_UINT) and the
    leaf histograms. Returns {leaf key: (code LUT, nbits LUT, offset,
    multiplier)}."""
    order, queue = [], [tree]
    while queue:  # breadth first, the property > splitval child first
        node = queue.pop(0)
        order.append(node)
        if node[0] == "split":
            queue += [node[3], node[4]]
    toks = []  # (context, value)
    leaves = []
    for node in order:
        if node[0] == "split":
            toks += [(1, node[1] + 1), (0, int(_signed_token(node[2])))]
        else:
            toks += [(1, 0), (2, 0), (3, int(_signed_token(node[2]))), (4, node[3]), (5, 0)]
            leaves.append(node)
    write_ans_flat_histograms(w, [0] * 6, [64], [TREE_UINT])
    vals = np.array([v for _, v in toks])
    tk, raw, nraw = hybrid_encode(vals, TREE_UINT)
    freq, inv = inverse_tables([spec.FlatHistogram(64, LOG_ALPHA)])
    state, words, has = rans_encode_lanes(tk[None], np.zeros((1, len(tk)), np.int64),
                                          np.array([len(tk)]), freq, inv)
    w.write(int(state[0]), 32)
    w.extend(np.stack([words[0], raw], 1), np.stack([np.where(has[0], 16, 0), nraw], 1))

    sets = _leaf_sets()
    clusters = sorted({sets[leaf[1]] for leaf in leaves})
    write_prefix_clusters(w, [clusters.index(sets[leaf[1]]) for leaf in leaves], clusters)
    out = {}
    for leaf in leaves:
        code, nb = _code_lut(sets[leaf[1]])
        out[leaf[1]] = (code, nb, leaf[2], 1 << leaf[3])
    return out


def _modular_bits(w, leaves, key, values):
    """Append the prefix codes of `values` (any shape) under leaf `key`."""
    code, nb, offset, mul = leaves[key]
    r = (np.asarray(values, np.int64).reshape(-1) - offset)
    tok = _signed_token(r // mul)
    if not ((r % mul == 0).all() and (tok < len(code)).all() and (nb[tok] > 0).all()):
        raise ValueError(f"a value the leaf {key} cannot code")
    w.extend(code[tok], nb[tok])


# -- the frame's content ------------------------------------------------------------


def _frame_layout(width, height):
    bw, bh = -(-width // 8), -(-height // 8)
    gx, gy = -(-width // GROUP_DIM), -(-height // GROUP_DIM)
    lgx, lgy = -(-bw // LF_GROUP_BLOCKS), -(-bh // LF_GROUP_BLOCKS)
    return bw, bh, gx, gy, lgx, lgy


def _lf_rects(bw, bh, lgx, lgy):
    return [(x * LF_GROUP_BLOCKS, y * LF_GROUP_BLOCKS,
             min(LF_GROUP_BLOCKS, bw - x * LF_GROUP_BLOCKS),
             min(LF_GROUP_BLOCKS, bh - y * LF_GROUP_BLOCKS))
            for y in range(lgy) for x in range(lgx)]


def _place_transforms(rng, bw, bh, rects, mixed: bool):
    """Transform map (origin cells carry | 128) and, per LF group, the
    types of its coefficient list in raster order."""
    tmap = np.full((bh, bw), 128, dtype=np.uint8)
    if mixed:
        ys, xs = np.meshgrid(np.arange(0, bh - 1, 2), np.arange(0, bw - 1, 2), indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        # a DCT16 stays inside its LF group (which holds whole groups)
        fits = np.ones(len(ys), bool)
        for (ox, oy, w, h) in rects:
            inside = (xs >= ox) & (xs < ox + w) & (ys >= oy) & (ys < oy + h)
            fits &= ~inside | ((xs + 2 <= ox + w) & (ys + 2 <= oy + h))
        pick = fits & (rng.random(len(ys)) < 0.15)
        for dy in (0, 1):
            for dx in (0, 1):
                tmap[ys[pick] + dy, xs[pick] + dx] = DCT16
        tmap[ys[pick], xs[pick]] = DCT16 | 128
    counts = []
    for (ox, oy, w, h) in rects:
        counts.append(int((tmap[oy : oy + h, ox : ox + w] >= 128).sum()))
    band_step = max(1, min(counts) // len(BAND_TYPES))
    lists = []
    for (ox, oy, w, h) in rects:
        sub = tmap[oy : oy + h, ox : ox + w]
        oys, oxs = np.nonzero(sub >= 128)
        types = (sub[oys, oxs] & 127).astype(np.int64)
        if mixed:
            band = np.minimum(np.arange(len(types)) // band_step, len(BAND_TYPES) - 1)
            choice = rng.integers(0, 3, len(types))  # DCT8 or one of the band's two
            extra = np.array(BAND_TYPES)[band, np.maximum(choice - 1, 0)]
            one = types != DCT16
            types[one] = np.where(choice[one] == 0, 0, extra[one])
            sub[oys[one], oxs[one]] = (types[one] | 128).astype(np.uint8)
        lists.append(types)
    return tmap, lists, band_step


def _lf_group_section(rng, leaves, rect, types, record):
    """One LF group's section: its LF coefficients, then its HF metadata.
    record: a dict that receives the quantized LF planes by channel (0 X,
    1 Y, 2 B) and the CfL maps ("ytox", "ytob")."""
    ox, oy, w, h = rect
    sec = BitList()
    sec.write(0, 2)  # extra_precision
    sec.write(1, 1)  # GroupHeader: use_global_tree
    sec.write(1, 1)  # default weighted-predictor header
    sec.write(0, 2)  # no transforms
    # modular order [Y, X, B]
    for key, c in (("lf_y", 1), ("lf_x", 0), ("lf_b", 2)):
        _, _, base, mul = leaves[key]
        vals = base + mul * _residual(rng.integers(0, 4, (h, w)))
        _modular_bits(sec, leaves, key, vals)
        record[c] = vals
    count = len(types)
    sec.write(count - 1, _ceil_log2(w * h))
    sec.write(1, 1)
    sec.write(1, 1)
    sec.write(0, 2)
    cw, ch = -(-w // 8), -(-h // 8)
    for key in ("ytox", "ytob"):
        vals = _residual(rng.integers(0, 4, (ch, cw)))
        _modular_bits(sec, leaves, "cfl", vals)
        record[key] = vals
    # transform image row 0: types, by band of the list index
    for b in range(len(BAND_TYPES)):
        step = leaves["_band_step"]
        lo = b * step
        hi = count if b == len(BAND_TYPES) - 1 else min(count, (b + 1) * step)
        if lo < hi:
            _modular_bits(sec, leaves, f"band{b}", types[lo:hi])
    quants = 8 + 2 * _residual(rng.integers(0, 4, count))
    _modular_bits(sec, leaves, "quant", quants)
    epf = rng.integers(0, 4, (h, w)) + np.where(np.arange(w) > 31, 4, 0)[None, :]
    # the EPF channel is coded row by row, each sample under its x's leaf
    code_lo, nb_lo, off_lo, _ = leaves["epf_lo"]
    code_hi, nb_hi, off_hi, _ = leaves["epf_hi"]
    hi_px = np.broadcast_to(np.arange(w) > 31, (h, w)).reshape(-1)
    e = epf.reshape(-1)
    tok = _signed_token(e - np.where(hi_px, off_hi, off_lo))
    sec.extend(np.where(hi_px, code_hi[tok], code_lo[tok]),
               np.where(hi_px, nb_hi[tok], nb_lo[tok]))
    return sec.finish(), quants + 1, epf


def _ac_tokens(rng, tmap, g, gxn, density, max_run=12, orders=None, bctx=None):
    """One group's AC content: (token values, contexts, and the
    (coefficient index, value) pairs it encodes). orders: {(shape,
    channel): coded order}, natural elsewhere. bctx: a custom
    block-context map (BlockContextSpec), else the default."""
    gx0, gy0 = (g % gxn) * GD_BLOCKS, (g // gxn) * GD_BLOCKS
    sub = tmap[gy0 : gy0 + GD_BLOCKS, gx0 : gx0 + GD_BLOCKS]
    bys, bxs = np.nonzero(sub >= 128)
    tids = (sub[bys, bxs] & 127).astype(np.int64)
    cxs, cys, shapes = _CBX[tids], _CBY[tids], _SHAPES[tids]
    nbs = cxs * cys
    ncs = nbs * 64
    offs = np.concatenate([[0], np.cumsum(ncs)[:-1]])
    num_bctx = NUM_BCTX if bctx is None else bctx.num_contexts
    # items: per block, channels 1, 0, 2
    chan = np.tile(np.array([1, 0, 2]), len(tids))
    rep = lambda a: np.repeat(a, 3)  # noqa: E731
    bx, by, cx, cy, nb, nc, off, shape = map(rep, (bxs, bys, cxs, cys, nbs, ncs, offs, shapes))
    cidx = np.where(chan < 2, chan ^ 1, 2)
    if bctx is None:
        bctx = spec.DEFAULT_BLOCK_CONTEXTS[cidx * 13 + shape]
    else:
        bctx = bctx.block_context(cidx, shape, gy0 + by, gx0 + bx)
    M = len(chan)
    L = np.where(rng.random(M) < density, rng.integers(1, max_run + 1, M), 0)
    L = np.minimum(L, nc - nb)
    # coefficient values: nonzero with probability 0.6, the last one always
    cstart = np.cumsum(L) - L
    item_of_c = np.repeat(np.arange(M), L)
    j = np.arange(L.sum()) - cstart[item_of_c]
    mag = np.minimum(rng.geometric(0.45, len(j)), MAX_COEFF)
    val = mag * np.where(rng.random(len(j)) < 0.5, -1, 1)
    val = np.where((rng.random(len(j)) < 0.6) | (j == L[item_of_c] - 1), val, 0)
    isnz = (val != 0).astype(np.int64)
    nz = np.bincount(item_of_c, weights=isnz, minlength=M).astype(np.int64)
    # nonzeros map after the whole group (what every top/left read sees)
    nzmap = np.zeros((3, GD_BLOCKS, GD_BLOCKS), np.int64)
    fill = -(-nz // nb)
    for dy in (0, 1):
        for dx in (0, 1):
            m = (dy < cy) & (dx < cx)
            nzmap[chan[m], by[m] + dy, bx[m] + dx] = fill[m]
    up = nzmap[chan, np.maximum(by - 1, 0), bx]
    left = nzmap[chan, by, np.maximum(bx - 1, 0)]
    pred = np.where(bx == 0, np.where(by == 0, 32, up),
                    np.where(by == 0, left, (up + left + 1) // 2))
    nzctx = np.where(pred < 8, pred, np.where(pred < 64, 4 + pred // 2, 36))
    ctx_nz = nzctx * num_bctx + bctx
    # coefficient-token contexts
    lnb = np.log2(nb).astype(np.int64)[item_of_c]
    before = np.concatenate([[0], np.cumsum(isnz)])  # nonzeros before token t
    left_nz = nz[item_of_c] - (before[:-1] - before[cstart][item_of_c])
    k = nb[item_of_c] + j
    nzl = np.minimum((left_nz + (1 << lnb) - 1) >> lnb, 63)
    kn = k >> lnb
    prev_init = np.where(nz > (nc >> 4), 0, 1)
    prev_tok = np.concatenate([[0], isnz[:-1]]) if len(j) else isnz
    prev = np.where(j == 0, prev_init[item_of_c], prev_tok)
    ctx_c = num_bctx * 37 + 458 * bctx[item_of_c] + (_NUM_NZ_CTX[nzl] + _FREQ_CTX[kn]) * 2 + prev
    # token stream: per item the nonzeros count, then its coefficients
    ntok = 1 + L
    tstart = np.cumsum(ntok) - ntok
    tok_val = np.empty(ntok.sum(), np.int64)
    tok_ctx = np.empty(ntok.sum(), np.int64)
    tok_val[tstart] = nz
    tok_ctx[tstart] = ctx_nz
    cpos = tstart[item_of_c] + 1 + j
    tok_val[cpos] = _signed_token(val)
    tok_ctx[cpos] = ctx_c
    # dense coefficients
    shape_c = shape[item_of_c]
    chan_c = chan[item_of_c]
    slot = np.zeros(len(k), np.int64)
    for s in np.unique(shape).tolist():
        natural = spec.natural_order_array(spec.TRANSFORM_TYPE_LUT[s]).astype(np.int64)
        m = shape_c == s
        if orders is None:
            slot[m] = natural[k[m]]
            continue
        for c in range(3):
            mc = m & (chan_c == c)
            slot[mc] = orders.get((s, c), natural)[k[mc]]
    dest = g * GROUP_STRIDE + chan[item_of_c] * GROUP_DIM * GROUP_DIM + off[item_of_c] + slot
    return tok_val, tok_ctx, dest, val


def ac_context_map(pass_idx: int = 0, num_contexts: int = NUM_AC_CONTEXTS, clusters: int = 3):
    """cluster of each AC context of pass `pass_idx` (the padded tail maps
    to cluster 0)."""
    ctx = np.arange(num_contexts)
    return np.concatenate([(ctx * 7 + ctx // 5 + pass_idx) % clusters,
                           np.zeros(CTX_PAD, np.int64)])


class AcCoding:
    """How the writer codes AC tokens: `sets` histogram sets (HF group g
    takes set g % sets), each over num_bctx * 495 contexts, mapped onto
    `clusters` flat rANS clusters at log alphabet size `log_alpha`,
    cluster i with alphabet AC_ALPHABETS[i % 3] and HybridUint config
    AC_UINT[i % 3]."""

    def __init__(self, num_bctx=NUM_BCTX, sets=1, clusters=3, log_alpha=LOG_ALPHA):
        self.num_ac = num_bctx * (37 + 458)
        self.sets, self.clusters, self.log_alpha = sets, clusters, log_alpha
        self.alphabets = [AC_ALPHABETS[i % 3] for i in range(clusters)]
        self.uint_cfgs = [AC_UINT[i % 3] for i in range(clusters)]

    def context_map(self, pass_idx: int):
        """The padded cluster map of pass `pass_idx` over every set."""
        cmap = ac_context_map(pass_idx, self.sets * self.num_ac, self.clusters)
        if len(np.unique(cmap)) != self.clusters:
            raise ValueError(f"{self.clusters} clusters leave holes in the context map")
        return cmap

    def write_histograms(self, w, pass_idx: int) -> None:
        write_ans_flat_histograms(w, self.context_map(pass_idx)[: self.sets * self.num_ac].tolist(),
                                  self.alphabets, self.uint_cfgs, log_alpha=self.log_alpha)


def _ac_sections(tok_vals, tok_ctxs, coding, pass_idx=0):
    """rANS-encode every group's token list at once (one lane a group),
    with the histograms of pass `pass_idx` (group g codes its histogram
    set, g % sets, first). Returns each group's bytes."""
    cmap = coding.context_map(pass_idx)
    hists = [spec.FlatHistogram(a, coding.log_alpha) for a in coding.alphabets]
    freq, inv = inverse_tables(hists)
    G = len(tok_vals)
    hist_bits = _ceil_log2(coding.sets)
    lengths = np.array([len(t) for t in tok_vals])
    T = max(int(lengths.max()), 1)
    tok = np.zeros((G, T), np.int64)
    cl = np.zeros((G, T), np.int64)
    raw = np.zeros((G, T), np.int64)
    nraw = np.zeros((G, T), np.int64)
    for g, (v, c) in enumerate(zip(tok_vals, tok_ctxs)):
        clus = cmap[c + (g % coding.sets) * coding.num_ac]
        cl[g, : len(v)] = clus
        for ci, cfg in enumerate(coding.uint_cfgs):
            m = clus == ci
            t, r, n = hybrid_encode(v[m], cfg)
            if not (t < coding.alphabets[ci]).all():
                raise ValueError("an AC token outside its cluster's alphabet")
            idx = np.nonzero(m)[0]
            tok[g, idx], raw[g, idx], nraw[g, idx] = t, r, n
    state, words, has = rans_encode_lanes(tok, cl, lengths, freq, inv)
    out = []
    for g in range(G):
        n = lengths[g]
        w = BitList()
        if hist_bits:
            w.write(g % coding.sets, hist_bits)
        w.write(int(state[g]), 32)
        w.extend(np.stack([words[g, :n], raw[g, :n]], 1),
                 np.stack([np.where(has[g, :n], 16, 0), nraw[g, :n]], 1))
        out.append(w.finish())
    return out


# -- a real encoder's coding tables -----------------------------------------------


def write_f16(w, v: float) -> float:
    """An F16 header field: `v` as an IEEE half, which must hold it finite
    and, unless v is 0, nonzero. Returns the value the decoder reads."""
    h = np.float16(v)
    if not np.isfinite(h) or (h == 0) != (v == 0):
        raise ValueError(f"{v} is no finite nonzero half")
    w.write(int(h.view(np.uint16)), 16)
    return float(h)


def _write_signed_thresholds(w, thr) -> None:
    w.write(len(thr), 4)
    for t in thr:
        u = int(_signed_token(t))
        for sel, (nbits, off) in enumerate(((4, 0), (8, 16), (16, 272), (32, 65808))):
            if u - off < (1 << nbits):
                w.write(sel, 2)
                w.write(u - off, nbits)
                break


class BlockContextSpec:
    """A custom block-context map as an encoder writes one: LF thresholds
    on each channel (X, Y, B: 2, 2 and 3 LF buckets of the quantized LF
    values, num_lf_contexts 12), QF thresholds 6 and 9 on the raw quant
    field (3 buckets) and a seeded context map over 16 block contexts,
    every one of them used. qf_idx and lf_idx are the frame's (bh, bw)
    bucket maps, filled from the LF groups as the decoder computes them."""

    num_contexts = 16

    def __init__(self, rng, lf_y_offset: int):
        self.lf_thresholds = ([-1], [lf_y_offset - 1], [-5, 1])
        self.qf_thresholds = [6, 9]
        self.nq1 = len(self.qf_thresholds) + 1
        self.nlf = int(np.prod([len(t) + 1 for t in self.lf_thresholds]))
        size = 3 * 13 * self.nlf * self.nq1
        cmap = rng.integers(0, self.num_contexts, size)
        cmap[rng.permutation(size)[: self.num_contexts]] = np.arange(self.num_contexts)
        self.context_map = cmap
        self.qf_idx = self.lf_idx = None

    def write(self, w) -> None:
        w.write(0, 1)  # not the default map
        for thr in self.lf_thresholds:
            _write_signed_thresholds(w, thr)
        w.write(len(self.qf_thresholds), 4)
        for t in self.qf_thresholds:
            v = t - 1
            for sel, (nbits, off) in enumerate(((2, 0), (3, 4), (5, 12), (8, 44))):
                if v - off < (1 << nbits):
                    w.write(sel, 2)
                    w.write(v - off, nbits)
                    break
        write_context_map(w, self.context_map.tolist())

    def fill_maps(self, bw, bh, rects, lf_planes, raw_quants, tmap):
        """qf_idx and lf_idx from each LF group's quantized LF planes
        (lf_planes[i][c]) and raw quant values in list order."""
        self.qf_idx = np.zeros((bh, bw), np.int64)
        self.lf_idx = np.zeros((bh, bw), np.int64)
        for (ox, oy, w, h), planes, rq in zip(rects, lf_planes, raw_quants):
            sub = tmap[oy : oy + h, ox : ox + w]
            oys, oxs = np.nonzero(sub >= 128)
            self.qf_idx[oy + oys, ox + oxs] = (
                np.asarray(rq)[:, None] > np.array(self.qf_thresholds)[None, :]).sum(1)

            def bucket(c):
                return sum((planes[c] > t).astype(np.int64) for t in self.lf_thresholds[c])

            idx = bucket(0) * (len(self.lf_thresholds[2]) + 1) + bucket(2)
            idx = idx * (len(self.lf_thresholds[1]) + 1) + bucket(1)
            self.lf_idx[oy : oy + h, ox : ox + w] = idx

    def block_context(self, cidx, shape, by, bx):
        """The block context of items (channel index, shape, block)."""
        midx = ((cidx * 13 + shape) * self.nq1 + self.qf_idx[by, bx]) * self.nlf
        return self.context_map[midx + self.lf_idx[by, bx]]


# the dequant encodings each option writes: {table kind: mode}; kinds
# absent keep the library table (mode 0). Modes 1-5 are parametric forms
# of one kind each (identity, DCT2, DCT4, DCT4x8, AFV), 6 the distance
# bands of any DCT kind, 7 a RAW table (as a recompressed JPEG codes its
# quant tables) coded in a Modular stream of the global tree
DEQUANT_MODES = {
    "raw": {0: 7},
    "params": {0: 6, 1: 1, 2: 2, 3: 3, 4: 6, 9: 4, 10: 5},
    "mixed": {0: 7, 1: 1, 2: 2, 3: 3, 4: 6, 5: 7, 6: 6, 9: 4, 10: 5, 11: 6},
}
RAW_DENOMINATOR = 2.0 ** -12
# the quantizer's global scale beside custom LfQuantFactors
TABLES_GLOBAL_SCALE = 3072


def _write_dct_params(w, rng, rows) -> list:
    """DctParams: the band count, then each channel's bands, the first
    scaled by 1/64; the library's bands, each channel's first times a
    seeded 0.8-1.25 and the others moved by up to 0.1. Returns the bands
    as the decoder reads them (the first times 64)."""
    w.write(len(rows[0]) - 1, 4)
    out = []
    for row in rows:
        got = [write_f16(w, row[0] * rng.uniform(0.8, 1.25) / 64.0) * 64.0]
        for v in row[1:]:
            got.append(write_f16(w, v + rng.uniform(-0.1, 0.1) if v else 0.0))
        out.append(got)
    return out


def write_dequant_matrices(w, option: str, rng, leaves) -> list:
    """HfGlobal's DequantMatrices, not all default: each table kind's mode
    (DEQUANT_MODES[option]) and its seeded parameters, the library's
    scaled by 0.8-1.25; a RAW table's entries from the tree's qt leaves
    over a denominator of 2^-12. Returns, per table kind, (mode name,
    parameters as the decoder reads them), or ("library", None)."""
    w.write(0, 1)  # not all default
    modes = DEQUANT_MODES[option]
    tables = []
    for kind in range(spec.NUM_QUANT_TABLES):
        mode = modes.get(kind, 0)
        w.write(mode, 3)

        def scaled(rows, by=64.0):
            out = []
            for row in rows:
                f = rng.uniform(0.8, 1.25)
                out.append([write_f16(w, v * f / by) * by for v in row])
            return out

        if mode == 0:
            tables.append(("library", None))
        elif mode == 1:
            tables.append(("identity", scaled(spec.IDENTITY_W)))
        elif mode == 2:
            tables.append(("dct2", scaled(spec.DCT2_W)))
        elif mode == 3:
            mul = scaled([[1.0, 1.0]] * 3, 1.0)
            tables.append(("dct4", (_write_dct_params(w, rng, spec.DCT_BANDS["dct4x4"]), mul)))
        elif mode == 4:
            mul = [row[0] for row in scaled([[1.0]] * 3, 1.0)]
            tables.append(("dct4x8", (_write_dct_params(w, rng, spec.DCT_BANDS["dct4x8"]), mul)))
        elif mode == 5:
            afv = []
            for row in spec.AFV_W:
                f = rng.uniform(0.8, 1.25)
                got = [write_f16(w, v * f / 64.0) * 64.0 for v in row[:6]]
                afv.append(got + [write_f16(w, v) for v in row[6:]])
            p48 = _write_dct_params(w, rng, spec.DCT_BANDS["dct4x8"])
            p44 = _write_dct_params(w, rng, spec.DCT_BANDS["dct4x4"])
            tables.append(("afv", (p48, p44, afv)))
        elif mode == 6:
            tables.append(("dct", _write_dct_params(w, rng, spec.library_dct_bands(kind))))
        elif mode == 7:
            den = write_f16(w, RAW_DENOMINATOR)
            w.write(1, 1)  # GroupHeader: use_global_tree
            w.write(1, 1)  # default weighted-predictor header
            w.write(0, 2)  # no transforms
            width, height = 8 * spec.REQUIRED_SIZE_X[kind], 8 * spec.REQUIRED_SIZE_Y[kind]
            qtable = []
            for _ in range(3):
                for y in range(height):
                    key = "qt_hi" if y > QT_SPLIT_ROW else "qt_lo"
                    _, _, off, mul = leaves[key]
                    vals = off + mul * _residual(rng.integers(0, 4, width))
                    _modular_bits(w, leaves, key, vals)
                    qtable += vals.tolist()
            tables.append(("raw", (qtable, den)))
    return tables


def _ctx_of(x: int) -> int:
    """A permutation token's context: ceil(log2(x + 1)), at most 7."""
    return min(_ceil_log2(x + 1), 7)


def apply_lehmer_tail(code, n: int) -> np.ndarray:
    """The permutation of range(n) a Lehmer code gives (the decoder's
    i-th smallest unused index; 0 past the code's end)."""
    rest = list(range(n))
    head = [rest.pop(int(v)) for v in code]
    return np.asarray(head + rest, np.int64)


def write_coeff_orders(w, rng, shapes) -> dict:
    """One pass's coded coefficient orders: selector 3 and the used-orders
    mask (the frame's shapes `shapes` and one larger order no block uses),
    the permutation histograms over 8 contexts (two flat rANS clusters,
    HybridUint (4, 1, 0)), then each used order's three seeded
    Lehmer-coded permutations: an end (0 keeps the natural order) and up
    to 40 values, each at most 20. Returns {(shape, channel): the dense
    order the decoder builds}."""
    shapes = sorted(set(int(x) for x in shapes))
    extra = [o for o in range(3, 13) if o not in shapes]
    mask = sum(1 << o for o in shapes) | (1 << int(rng.choice(extra)) if extra else 0)
    w.write(3, 2)
    w.write(mask, 13)
    toks, orders = [], {}  # toks: (context, value)
    for o in range(13):
        if not (mask >> o) & 1:
            continue
        t = spec.TRANSFORM_TYPE_LUT[o]
        nb = spec.CBX[t] * spec.CBY[t]
        size = nb * 64
        n = size - nb
        for c in range(3):
            end = 0 if rng.random() < 0.15 else int(rng.integers(1, 41))
            code = rng.integers(0, 21, end)
            code = np.minimum(code, n - 1 - np.arange(end))
            toks.append((_ctx_of(size), end))
            prev = 0
            for v in code.tolist():
                toks.append((_ctx_of(prev), v))
                prev = v
            tail = apply_lehmer_tail(code, n)
            orders[o, c] = spec.natural_order_array(t).astype(np.int64)[
                np.concatenate([np.arange(nb), tail + nb])]
    cmap = [0] * 7 + [1]  # the ends' context, 7, apart
    ctx = np.array([c for c, _ in toks], np.int64)
    vals = np.array([v for _, v in toks], np.int64)
    cl = np.asarray(cmap)[ctx]
    cfgs = [(4, 1, 0), (4, 1, 0)]
    write_ans_flat_histograms(w, cmap, [64, 64], cfgs)
    tk, raw, nraw = hybrid_tokens(vals, cl, cfgs, [64, 64])
    write_rans_stream(w, tk, cl, raw, nraw, [64, 64])
    return orders


def _headers(width, height, sections, filters=True):
    w = BW()
    w.write(0xFF, 8)
    w.write(0x0A, 8)
    w.write(0, 1)  # SizeHeader: not small
    u32(w, (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30)), height - 1)
    w.write(0, 3)
    u32(w, (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30)), width - 1)
    w.write(0, 1)  # ImageMetadata all_default = 0
    w.write(0, 1)  # extra_fields = 0
    w.write(0, 1)  # integer samples
    w.write(0, 2)  # 8 bits
    w.write(1, 1)  # modular_16bit_sufficient
    w.write(0, 2)  # no extra channels
    w.write(1, 1)  # xyb_encoded
    w.write(1, 1)  # colour encoding all_default (sRGB)
    w.write(0, 2)  # extensions
    w.write(1, 1)  # CustomTransformData all_default
    w.pad_to_byte()
    w.write(0, 1)  # FrameHeader all_default = 0
    w.write(0, 2)  # REGULAR
    w.write(0, 1)  # VarDCT
    u64(w, 0)  # flags
    u32(w, (("val", 1), ("val", 2), ("val", 4), ("val", 8)), 1)  # upsampling
    w.write(3, 3)  # x_qm_scale
    w.write(2, 3)  # b_qm_scale
    u32(w, (("val", 1), ("val", 2), ("val", 3), ("bitsoff", 3, 4)), 1)  # passes
    w.write(0, 1)  # no crop
    u32(w, (("val", 0), ("val", 1), ("val", 2), ("bitsoff", 2, 3)), 0)  # REPLACE
    w.write(1, 1)  # is_last
    u32(w, (("val", 0), ("bits", 4), ("bitsoff", 5, 16), ("bitsoff", 10, 48)), 0)  # name
    if filters:
        w.write(1, 1)  # RestorationFilter all_default (gaborish, EPF 2 steps)
    else:
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


def encode_xyb_vardct(width: int, height: int, seed: int = 0, transforms: str = "mixed",
                      density: float = 0.35, max_run: int = 12, filters: bool = True,
                      dequant=None, orders: bool = False, bctx=None, histograms: int = 1,
                      clusters: int = 3, log_alpha: int = LOG_ALPHA, lf_quant=None,
                      tables_seed=None):
    """(codestream, what it codes): an XYB VarDCT frame of more than one
    group at width x height. transforms: "mixed" (DCT16x16 on aligned 2x2
    positions and every 1x1 type) or "dct8"; density: the share of (block,
    channel) items that carry coefficients, each 1 to max_run coefficient
    positions; filters=False writes gaborish off and no EPF. The tables,
    each seeded by `tables_seed` (the frame's seed by default): dequant
    None (the library's matrices), "raw", "params" or "mixed"
    (DEQUANT_MODES); orders: code the coefficient orders, rANS-coded;
    bctx="custom": a BlockContextSpec over 16 block contexts; histograms:
    the AC histogram sets, HF group g coding set g % histograms; clusters:
    the AC clusters; log_alpha: their log alphabet size, 5 to 8; lf_quant:
    None, or the three LfQuantFactors (each a multiple of 2^-7 that a half
    holds after the factor 128), with a global scale of
    TABLES_GLOBAL_SCALE in place of 4096.

    What it codes is a dict: "lf" (3, bh, bw) int64 quantized LF (X, Y,
    B), "transform" (bh, bw) uint8 (origins | 128), "raw_quant" and "epf"
    (bh, bw) int64 at every covered block, "ytox" and "ytob" (ceil(bh /
    8), ceil(bw / 8)) int64, "dequant" (write_dequant_matrices or None),
    "lf_quant", "global_scale", "quant_lf", "filters", "coeffs" (the
    dense (G * 3 * 256 * 256,) int32 quantized AC coefficients, group
    after group, channel after channel, each block's coefficients at its
    raster-order offset and natural-order slot), and the AC sections'
    shape for the roofline: "ac_section_bytes", "ac_tokens",
    "ac_clusters", "ac_log_alpha", "ac_contexts", "groups"."""
    if width <= GROUP_DIM and height <= GROUP_DIM:
        raise ValueError("the writer writes frames of more than one group")
    if transforms not in ("mixed", "dct8"):
        raise ValueError(f"unknown transforms {transforms!r}")
    if dequant not in (None, *DEQUANT_MODES) or bctx not in (None, "custom"):
        raise ValueError(f"unknown dequant {dequant!r} or bctx {bctx!r}")
    if not 5 <= log_alpha <= 8:
        raise ValueError(f"log_alpha {log_alpha}")
    rng = np.random.default_rng(seed)
    ts = seed if tables_seed is None else tables_seed
    bspec = BlockContextSpec(np.random.default_rng([ts, 3]), 256) if bctx else None
    coding = AcCoding(NUM_BCTX if bspec is None else bspec.num_contexts, histograms, clusters,
                      log_alpha)
    bw, bh, gxn, gyn, lgx, lgy = _frame_layout(width, height)
    rects = _lf_rects(bw, bh, lgx, lgy)
    tmap, type_lists, band_step = _place_transforms(rng, bw, bh, rects, transforms == "mixed")

    lg = BitList()
    if lf_quant is None:
        lg.write(1, 1)  # LfQuantFactors all_default
        lf_read = None
    else:
        lg.write(0, 1)
        lf_read = tuple(write_f16(lg, v * 128.0) / 128.0 for v in lf_quant)
    global_scale = 4096 if lf_quant is None else TABLES_GLOBAL_SCALE
    lg.write(1, 2)  # global_scale: 2049 + 11 bits
    lg.write(global_scale - 2049, 11)
    lg.write(0, 2)  # quant_lf = 16
    if bspec is None:
        lg.write(1, 1)  # default block context map
    else:
        bspec.write(lg)
    lg.write(1, 1)  # default CfL
    lg.write(1, 1)  # global tree
    leaves = write_tree(lg, build_tree(len(rects), band_step,
                                       qtables=dequant in ("raw", "mixed")))
    leaves["_band_step"] = band_step
    records = [{} for _ in rects]
    lf_parts = [_lf_group_section(rng, leaves, rect, types, records[i])
                for i, (rect, types) in enumerate(zip(rects, type_lists))]
    lf_sections = [part[0] for part in lf_parts]
    if bspec is not None:
        bspec.fill_maps(bw, bh, rects, records, [part[1] for part in lf_parts], tmap)
    hg = BitList()
    if dequant is None:
        hg.write(1, 1)  # default dequant matrices
        dq_tables = None
    else:
        dq_tables = write_dequant_matrices(hg, dequant, np.random.default_rng([ts, 1]), leaves)
    hg.write(histograms - 1, _ceil_log2(gxn * gyn))
    if histograms > gxn * gyn:
        raise ValueError(f"{histograms} histogram sets in {gxn * gyn} groups")
    shapes = np.unique(_SHAPES[np.unique(tmap[tmap >= 128] & 127)])
    if orders:
        pass_orders = write_coeff_orders(hg, np.random.default_rng([ts, 2]), shapes)
    else:
        hg.write(2, 2)  # natural coefficient orders
        pass_orders = None
    coding.write_histograms(hg, 0)
    coeffs = np.zeros(gxn * gyn * GROUP_STRIDE, np.int32)
    tok_vals, tok_ctxs = [], []
    for g in range(gxn * gyn):
        v, c, dest, val = _ac_tokens(rng, tmap, g, gxn, density, max_run, pass_orders, bspec)
        tok_vals.append(v)
        tok_ctxs.append(c)
        coeffs[dest] += val.astype(np.int32)
    hf_sections = _ac_sections(tok_vals, tok_ctxs, coding)
    sections = [lg.finish()] + lf_sections + [hg.finish()] + hf_sections
    head = _headers(width, height, sections, filters)

    # what the frame codes, at the block resolution of the whole frame
    lf = np.zeros((3, bh, bw), np.int64)
    raw_quant = np.zeros((bh, bw), np.int64)
    epf = np.zeros((bh, bw), np.int64)
    ytox = np.zeros((-(-bh // 8), -(-bw // 8)), np.int64)
    ytob = np.zeros_like(ytox)
    for (ox, oy, w, h), rec, (_, rq, ep) in zip(rects, records, lf_parts):
        for c in range(3):
            lf[c, oy : oy + h, ox : ox + w] = rec[c]
        epf[oy : oy + h, ox : ox + w] = ep
        ytox[oy // 8 : oy // 8 + rec["ytox"].shape[0],
             ox // 8 : ox // 8 + rec["ytox"].shape[1]] = rec["ytox"]
        ytob[oy // 8 : oy // 8 + rec["ytob"].shape[0],
             ox // 8 : ox // 8 + rec["ytob"].shape[1]] = rec["ytob"]
        sub = tmap[oy : oy + h, ox : ox + w]
        oys, oxs = np.nonzero(sub >= 128)
        tids = sub[oys, oxs] & 127
        for y, x, t, q in zip(oys.tolist(), oxs.tolist(), tids.tolist(), rq.tolist()):
            raw_quant[oy + y : oy + y + spec.CBY[t], ox + x : ox + x + spec.CBX[t]] = q
    coded = {
        "lf": lf, "transform": tmap, "raw_quant": raw_quant, "epf": epf, "ytox": ytox,
        "ytob": ytob, "dequant": dq_tables, "lf_quant": lf_read, "global_scale": global_scale,
        "quant_lf": 16, "filters": filters, "coeffs": coeffs,
        "ac_section_bytes": sum(len(s) for s in hf_sections),
        "ac_tokens": int(sum(len(v) for v in tok_vals)),
        "ac_clusters": clusters, "ac_log_alpha": log_alpha,
        "ac_contexts": histograms * coding.num_ac + CTX_PAD, "groups": gxn * gyn,
    }
    return head + b"".join(sections), coded


def write(width: int, height: int, seed: int, **options):
    """The configuration's entry point: encode_xyb_vardct."""
    return encode_xyb_vardct(width, height, seed, **options)
