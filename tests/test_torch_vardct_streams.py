"""XYB VarDCT test streams, and checks that the JAX package reads them back.

`encode_xyb_vardct(width, height, seed, transforms=...)` writes a
single-frame 4:4:4 XYB VarDCT codestream and returns the quantized AC
coefficients it encoded, as the dense (G * 3 * 256 * 256,) int32 buffer
the AC decoders fill (group after group, channel after channel, each
block's coefficients at its raster-order offset and natural-order slot).

The frame: default RestorationFilter (gaborish on, EPF 2 steps), one
pass, default block context map, CfL and dequant matrices, a quantizer
with global_scale 4096 and quant_lf 16. LfGlobal carries a global MA tree
whose own tokens are rANS-coded; it splits on stream, channel, y and x
into Zero-predictor leaves (each with an offset and a multiplier), whose
residuals use Brotli-simple prefix codes of at most 4 symbols. So per LF
group the LF coefficients take 4 values a channel, and the HF metadata
varies: a CfL map of small values, transform types from bands of the
coefficient list (DCT8 and DCT16x16 in each, and two of the other 1x1
types: all ten 1x1 types appear in a frame with enough blocks), raw quant
values 5, 7, 9 or 11, and EPF sharpness 0-7. HfGlobal uses the natural
coefficient orders and three ANS clusters over 7425 AC contexts, with
flat distributions of 64, 48 and 40 symbols; the third cluster's
HybridUint config (4, 1, 0) gives larger values tail bits. The writer
computes every token's context as the decoder does, so the clusters test
the context model. Each group's tokens are rANS-encoded from the final
state 0x130000, vectorized across groups with numpy; alias tables come
from jxl_tpu_torch.entropy.ans.AnsHistogram.

Those are the defaults. The options of encode_xyb_vardct code a real
encoder's tables in their place: custom and RAW dequant matrices, coded
coefficient orders, a custom block-context map over 16 block contexts,
several AC histogram sets over more clusters at another log alphabet
size, and custom LF quantization (write_dequant_matrices,
write_coeff_orders, BlockContextSpec, AcCoding).

This module imports neither jax nor jxl_tpu at the top: chip_smoke.py
imports the writer. The tests below import the JAX package inside each
test.
"""

from __future__ import annotations

import numpy as np
import pytest

from mini_encoder import BW, token_bits, u32, u64, varint16

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
DCT16 = 4
# 1x1 types beside DCT8 (0), two per band of the coefficient list
BAND_TYPES = ((2, 3), (1, 12), (13, 14), (15, 16), (17, 2))
# transforms="large": each strip of one group row of an LF group takes one
# family, at most four types (a leaf's simple prefix code): the DCT16 fill
# with two 1x1 types, then the 32, 64, 128 and 256 px transforms, each as
# (square, half as wide, half as tall), beside DCT8 for the cells where no
# larger block fits
LARGE_FAMILIES = ((0, 4, 2, 3), (0, 5, 10, 11), (0, 18, 19, 20), (0, 21, 22, 23),
                  (0, 24, 25, 26))
MAX_COEFF = 20

_FREQ_CTX = np.array(
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 15, 16, 16, 17, 17, 18, 18,
     19, 19, 20, 20, 21, 21, 22, 22, 23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26,
     26, 26, 27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30])
_NUM_NZ_CTX = np.array(
    [0, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123, 152, 152, 152, 152, 152, 152,
     152, 152, 180, 180, 180, 180, 180, 180, 180, 180, 180, 180, 180, 180]
    + [206] * 31)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


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
    raw bit counts), inverting ref hybrid_uint.rs:28-71."""
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


def flat_histogram(alphabet: int, log_alpha: int = LOG_ALPHA):
    """The port's AnsHistogram of a flat distribution over `alphabet`
    symbols at log_alpha_size `log_alpha` (5 to 8), as the decoder builds
    it."""
    from jxl_tpu_torch.entropy.ans import SUM_PROBS, AnsHistogram

    table = 1 << log_alpha
    base, rem = divmod(SUM_PROBS, alphabet)
    h = AnsHistogram.__new__(AnsHistogram)
    h.dist = [base + (1 if i < rem else 0) for i in range(alphabet)] + [0] * (table - alphabet)
    h.log_bucket_size = 12 - log_alpha
    h.bucket_mask = (1 << h.log_bucket_size) - 1
    h.single_symbol = None
    h._build_alias_map(table, 1 << h.log_bucket_size)
    return h


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
    its cluster's HybridUint config; every token stays inside its
    cluster's alphabet."""
    vals = np.asarray(vals, np.int64)
    clusters = np.asarray(clusters, np.int64)
    tk, raw, nraw = (np.zeros(len(vals), np.int64) for _ in range(3))
    for ci, cfg in enumerate(uint_cfgs):
        m = clusters == ci
        tk[m], raw[m], nraw[m] = hybrid_encode(vals[m], cfg)
        assert (tk[m] < alphabets[ci]).all()
    return tk, raw, nraw


def write_rans_stream(w, tk, cl, raw, nraw, alphabets, log_alpha=LOG_ALPHA):
    """One rANS stream of tokens `tk` in clusters `cl` (flat histograms
    over `alphabets`, as write_ans_flat_histograms writes them) into the
    BitList w: the initial state, then each token's renormalization word
    and its raw bits."""
    freq, inv = inverse_tables([flat_histogram(a, log_alpha) for a in alphabets])
    tk, cl = np.asarray(tk, np.int64), np.asarray(cl, np.int64)
    state, words, has = rans_encode_lanes(tk[None], cl[None], np.array([len(tk)]), freq, inv)
    w.write(int(state[0]), 32)
    w.extend(np.stack([words[0], raw], 1), np.stack([np.where(has[0], 16, 0), nraw], 1))


def bitlist_bits(w) -> np.ndarray:
    """The bits of a BitList, a uint8 array of 0/1, LSB first."""
    nbits = int(sum(int(n.sum()) for n in w.nbits))
    return np.unpackbits(np.frombuffer(w.finish(), np.uint8), bitorder="little")[:nbits]


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


def write_ans_flat_histograms(w, cmap, alphabets, uint_cfgs, lz77=False, log_alpha=LOG_ALPHA):
    """Histograms bundle: context map `cmap` (write_context_map), ANS at
    `log_alpha` (5 to 8), per-cluster HybridUint configs and flat
    distributions. With lz77=True
    the bundle enables LZ77 with min_symbol 224, which no token reaches:
    the stream decodes the same, but the lane decoder does not take it.
    lz77 may instead be (min_symbol, min_length, length HybridUint config)
    for an LZ77 that the tokens use; `cmap` then ends with the distance
    context's cluster."""
    w.write(1 if lz77 else 0, 1)
    if lz77 is True:
        w.write(0, 2)  # min_symbol 224
        w.write(0, 2)  # min_length 3
        w.write(8, 4)  # length HybridUint at log_alpha 8: split_exponent 8
        cmap = list(cmap) + [0]  # the distance context
    elif lz77:
        min_symbol, min_length, (se, msb, lsb) = lz77
        assert 8 <= min_symbol < 8 + (1 << 15) and 3 <= min_length <= 4
        w.write(3, 2)
        w.write(min_symbol - 8, 15)
        w.write(min_length - 3, 2)
        w.write(se, 4)  # the length config, at log_alpha 8
        if se != 8:
            w.write(msb, _ceil_log2(se + 1))
            w.write(lsb, _ceil_log2(se - msb + 1))
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
        varint16(w, s - 1)
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
    sets = {k: S0 for k in ("lf_y", "lf_x", "lf_b", "cfl", "quant", "epf_lo", "epf_hi", "alpha",
                            "qt_lo", "qt_hi")}
    for b, extra in enumerate(BAND_TYPES):
        sets[f"band{b}"] = tuple(sorted(_signed_token((0, DCT16) + extra).tolist()))
    for f, fam in enumerate(LARGE_FAMILIES):
        sets[f"family{f}"] = tuple(sorted(_signed_token(fam).tolist()))
    return sets


def _strip_types(num_lf_groups: int, strips: list):
    """The transform types' subtree of transforms="large": a split on the
    stream id a LF group (the HF metadata of LF group l is stream 1 + 2 *
    num_lf_groups + l), then on the list index (property 3) a strip, each
    strip's leaf its family's. strips: per LF group, [(first list index,
    family)] in order."""
    def chain(bands, k):
        leaf = _leaf(f"family{bands[k][1]}", 0, 0)
        if k == len(bands) - 1:
            return leaf
        return _split(3, bands[k + 1][0] - 1, chain(bands, k + 1), leaf)

    node = chain(strips[-1], 0)
    for lf in range(num_lf_groups - 2, -1, -1):
        node = _split(1, 1 + 2 * num_lf_groups + lf, node, chain(strips[lf], 0))
    return node


def build_tree(num_lf_groups: int, band_step: int, lf_y_offset: int = 256,
               first_hf_stream: int | None = None, strips=None, global_alpha: bool = False,
               qtables: bool = False):
    """The global tree. With first_hf_stream (the modular stream id of
    group 0's HF section), every HF group stream, where the alpha channel
    is coded, takes one more leaf: 0, 64, 128 or 192; with global_alpha
    the global stream (id 0) takes it, where a single-group frame codes
    its alpha. strips: the strips of transforms="large" (_strip_types),
    else the types are coded by band of the list index (BAND_TYPES).
    qtables: the streams of RAW dequant tables (ids past 3 *
    num_lf_groups) take two leaves by row, 8-14 in rows 0-3 and 24-48
    below (QT_LEAVES)."""
    if strips is not None:
        types = _strip_types(num_lf_groups, strips)
    else:
        types = _leaf("band0", 0, 0)
        for b in range(1, len(BAND_TYPES)):
            types = _split(3, b * band_step - 1, _leaf(f"band{b}", 0, 0), types)
    meta = _split(0, 1,
                  _split(0, 2,
                         _split(3, 31, _leaf("epf_hi", 6, 0), _leaf("epf_lo", 2, 0)),
                         _split(2, 0, _leaf("quant", 8, 1), types)),
                  _leaf("cfl", 0, 0))
    lf = _split(0, 0, _split(0, 1, _leaf("lf_b", 0, 2), _leaf("lf_x", 0, 3)),
                _leaf("lf_y", lf_y_offset, 4))
    tree = _split(1, num_lf_groups, meta, lf)
    if qtables:
        qt = _split(2, QT_SPLIT_ROW, _leaf("qt_hi", *QT_LEAVES["qt_hi"]),
                    _leaf("qt_lo", *QT_LEAVES["qt_lo"]))
        tree = _split(1, 3 * num_lf_groups, qt, tree)
    if first_hf_stream is not None:
        tree = _split(1, first_hf_stream - 1, _leaf("alpha", 128, 6), tree)
    if global_alpha:
        tree = _split(1, 0, tree, _leaf("alpha", 128, 6))
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
    hist = flat_histogram(64)
    freq, inv = inverse_tables([hist])
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
    assert (r % mul == 0).all(), key
    tok = _signed_token(r // mul)
    assert (tok < len(code)).all() and (nb[tok] > 0).all(), key
    w.extend(code[tok], nb[tok])


# -- the frame's content ------------------------------------------------------------


def _frame_layout(width, height, maxhs=0, maxvs=0):
    bw = -(-width // (8 << maxhs)) << maxhs
    bh = -(-height // (8 << maxvs)) << maxvs
    gx, gy = -(-width // GROUP_DIM), -(-height // GROUP_DIM)
    lgx, lgy = -(-bw // LF_GROUP_BLOCKS), -(-bh // LF_GROUP_BLOCKS)
    return bw, bh, gx, gy, lgx, lgy


def _lf_rects(bw, bh, lgx, lgy):
    return [(x * LF_GROUP_BLOCKS, y * LF_GROUP_BLOCKS,
             min(LF_GROUP_BLOCKS, bw - x * LF_GROUP_BLOCKS),
             min(LF_GROUP_BLOCKS, bh - y * LF_GROUP_BLOCKS))
            for y in range(lgy) for x in range(lgx)]


def _place_large(rng, bw, bh, rects):
    """transforms="large": (transform map, per LF group the types of its
    coefficient list in raster order, per LF group its strips [(first
    list index, family)]). Strip k of LF group l, its block rows [32k, 32k
    + 32), takes family (4 - k - l) % 5 of LARGE_FAMILIES, so its origins
    are consecutive in the list and each strip is one leaf of the tree.
    Family 0 is the DCT16 fill with DCT8, DCT2X2 and DCT4X4; family f > 0
    tiles the strip with cells of s = 2 << f blocks, each a square, two
    halves side by side or two halves one above the other, in turn from a
    random start, and DCT8 blocks where a cell would leave its LF group or
    the frame."""
    tmap = np.full((bh, bw), 128, dtype=np.uint8)
    lists, strips = [], []
    for li, (ox, oy, w, h) in enumerate(rects):
        sub = tmap[oy : oy + h, ox : ox + w]
        fams = []
        for k, y0 in enumerate(range(0, h, GD_BLOCKS)):
            f = (4 - k - li) % len(LARGE_FAMILIES)
            fams.append(f)
            rows = min(GD_BLOCKS, h - y0)
            if f == 0:
                cells = [(y, x, 2) for y in range(y0, y0 + rows - 1, 2) for x in range(0, w - 1, 2)]
                pick = rng.random(len(cells)) < 0.15
            else:
                s = 2 << f
                cells = [(y, x, s) for y in range(y0, y0 + rows - s + 1, s)
                         for x in range(0, w - s + 1, s)]
                pick = (np.arange(len(cells)) + rng.integers(0, 3)) % 3 + 1
            for (y, x, s), r in zip(cells, pick):
                if f == 0:
                    if r:
                        sub[y : y + 2, x : x + 2] = 4
                        sub[y, x] = 4 | 128
                    continue
                sq, tall, wide = LARGE_FAMILIES[f][1:]
                parts = {1: [(sq, 0, 0, s, s)], 2: [(tall, 0, 0, s, s // 2),
                                                    (tall, 0, s // 2, s, s // 2)],
                         3: [(wide, 0, 0, s // 2, s), (wide, s // 2, 0, s // 2, s)]}[int(r)]
                for t, dy, dx, ch, cw in parts:
                    sub[y + dy : y + dy + ch, x + dx : x + dx + cw] = t
                    sub[y + dy, x + dx] = t | 128
            if f == 0:  # the fill's 1x1 blocks: DCT8, DCT2X2 or DCT4X4
                band = sub[y0 : y0 + rows]
                one = band == 128
                band[one] = np.array([128, 2 | 128, 3 | 128], np.uint8)[
                    rng.integers(0, 3, int(one.sum()))]
        oys, oxs = np.nonzero(sub >= 128)
        types = (sub[oys, oxs] & 127).astype(np.int64)
        lists.append(types)
        strips.append([(int(np.searchsorted(oys, k * GD_BLOCKS)), f) for k, f in enumerate(fams)])
    return tmap, lists, strips


def _place_transforms(rng, bw, bh, rects, mixed: bool, lone=None):
    """Transform map (origin cells carry | 128) and, per LF group, the
    types of its coefficient list in raster order. lone: a 1x1 type of
    BAND_TYPES that the first group row holding it keeps one block of (its
    other blocks there become DCT8), while later group rows keep theirs."""
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
    if lone is not None:
        _keep_one(tmap, lists, rects, lone)
    return tmap, lists, band_step


def _keep_one(tmap, lists, rects, t):
    """Leave one block of type `t` in the first group row that holds one,
    the others there DCT8 (which every band's leaf codes)."""
    rows = []
    for li, (ox, oy, w, h) in enumerate(rects):
        sub = tmap[oy : oy + h, ox : ox + w]
        oys, oxs = np.nonzero(sub >= 128)
        hit = np.nonzero(lists[li] == t)[0]
        rows += [((oy + oys[i]) // GD_BLOCKS, li, i, oys[i], oxs[i]) for i in hit]
    if not rows:
        raise ValueError(f"no block of type {t} to keep one of")
    first = min(r[0] for r in rows)
    row = sorted(r for r in rows if r[0] == first)
    for _, li, i, y, x in row[1:]:
        ox, oy = rects[li][:2]
        lists[li][i] = 0
        tmap[oy + y, ox + x] = 128


def _lf_group_section(rng, leaves, rect, types, cfl_zero, hs=(0, 0, 0), vs=(0, 0, 0),
                      lf_coefficients=True, strips=None, bits=False, record=None):
    """One LF group's section: its LF coefficients (not in a frame that
    reads an LF frame: lf_coefficients=False), then its HF metadata.
    strips: the LF group's strips of transforms="large". bits=True returns
    the section's BitList, not its bytes (a single-section frame). record:
    a dict that receives the quantized LF planes by channel (0 X, 1 Y,
    2 B), each at its own size."""
    ox, oy, w, h = rect
    sec = BitList()
    if lf_coefficients:
        sec.write(0, 2)  # extra_precision
        sec.write(1, 1)  # GroupHeader: use_global_tree
        sec.write(1, 1)  # default weighted-predictor header
        sec.write(0, 2)  # no transforms
        # modular order [Y, X, B], each channel at its own (subsampled) size
        for key, c in (("lf_y", 1), ("lf_x", 0), ("lf_b", 2)):
            _, _, base, mul = leaves[key]
            vals = base + mul * _residual(rng.integers(0, 4, (h >> vs[c], w >> hs[c])))
            _modular_bits(sec, leaves, key, vals)
            if record is not None:
                record[c] = vals
    count = len(types)
    sec.write(count - 1, _ceil_log2(w * h))
    sec.write(1, 1)
    sec.write(1, 1)
    sec.write(0, 2)
    cw, ch = -(-w // 8), -(-h // 8)
    for _ in range(2):  # ytox, ytob
        vals = np.zeros((ch, cw), np.int64) if cfl_zero else _residual(rng.integers(0, 4, (ch, cw)))
        _modular_bits(sec, leaves, "cfl", vals)
    # transform image row 0: types, by band of the list index (or by
    # strip, `strips`, for transforms="large")
    if strips is not None:
        ends = [lo for lo, _ in strips[1:]] + [count]
        for (lo, f), hi in zip(strips, ends):
            if lo < hi:
                _modular_bits(sec, leaves, f"family{f}", types[lo:hi])
    for b in range(len(BAND_TYPES) if strips is None else 0):
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
    return sec if bits else sec.finish(), quants + 1, epf


def _ac_tokens(rng, tmap, g, gxn, density, max_run=12, hs=(0, 0, 0), vs=(0, 0, 0),
               orders=None, bctx=None):
    """One group's AC content: (item arrays, token values, contexts, and
    the (coefficient index, value) pairs it encodes). With chroma shifts
    hs/vs a channel has items only at the blocks aligned to its grid, and
    its nonzeros are predicted on that grid. orders: {(shape, channel):
    coded order} of the pass (write_coeff_orders), natural elsewhere.
    bctx: a custom block-context map (BlockContextSpec), else the
    default."""
    from jxl_tpu_torch.vardct.block_context import BlockContextMap
    from jxl_tpu_torch.vardct.coeff_order import TRANSFORM_TYPE_LUT, natural_order_array
    from jxl_tpu_torch.vardct.transform_map import block_shape_id, covered_blocks_x, covered_blocks_y

    bh, bw = tmap.shape
    gx0, gy0 = (g % gxn) * GD_BLOCKS, (g // gxn) * GD_BLOCKS
    sub = tmap[gy0 : gy0 + GD_BLOCKS, gx0 : gx0 + GD_BLOCKS]
    bys, bxs = np.nonzero(sub >= 128)
    tids = (sub[bys, bxs] & 127).astype(np.int64)
    cxs = np.array([covered_blocks_x(t) for t in range(27)])[tids]
    cys = np.array([covered_blocks_y(t) for t in range(27)])[tids]
    shapes = np.array([block_shape_id(t) for t in range(27)])[tids]
    nbs = cxs * cys
    ncs = nbs * 64
    offs = np.concatenate([[0], np.cumsum(ncs)[:-1]])
    bmap = np.asarray(BlockContextMap.default().context_map)
    num_bctx = NUM_BCTX if bctx is None else bctx.num_contexts
    # items: per block, channels 1, 0, 2
    chan = np.tile(np.array([1, 0, 2]), len(tids))
    rep = lambda a: np.repeat(a, 3)  # noqa: E731
    bx, by, tid, cx, cy, nb, nc, off, shape = map(rep, (bxs, bys, tids, cxs, cys, nbs, ncs,
                                                        offs, shapes))
    hs_c, vs_c = np.asarray(hs)[chan], np.asarray(vs)[chan]
    sbx, sby = bx >> hs_c, by >> vs_c
    aligned = ((sbx << hs_c) == bx) & ((sby << vs_c) == by)
    chan, bx, by, tid, cx, cy, nb, nc, off, shape, sbx, sby = (
        a[aligned] for a in (chan, bx, by, tid, cx, cy, nb, nc, off, shape, sbx, sby))
    cidx = np.where(chan < 2, chan ^ 1, 2)
    if bctx is None:
        bctx = bmap[cidx * 13 + shape]
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
            nzmap[chan[m], sby[m] + dy, sbx[m] + dx] = fill[m]
    up = nzmap[chan, np.maximum(sby - 1, 0), sbx]
    left = nzmap[chan, sby, np.maximum(sbx - 1, 0)]
    pred = np.where(sbx == 0, np.where(sby == 0, 32, up),
                    np.where(sby == 0, left, (up + left + 1) // 2))
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
        natural = natural_order_array(TRANSFORM_TYPE_LUT[s]).astype(np.int64)
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
    to cluster 0): each pass has histograms of its own. num_contexts: the
    AC contexts of every histogram set together."""
    ctx = np.arange(num_contexts)
    return np.concatenate([(ctx * 7 + ctx // 5 + pass_idx) % clusters,
                           np.zeros(CTX_PAD, np.int64)])


class AcCoding:
    """How the writer codes AC tokens: `sets` histogram sets (HF group g
    takes set g % sets), each over num_bctx * 495 contexts, mapped onto
    `clusters` flat rANS clusters at log alphabet size `log_alpha`,
    cluster i with alphabet AC_ALPHABETS[i % 3] and HybridUint config
    AC_UINT[i % 3]. The defaults are the frame's one set over the default
    block-context map and three clusters at log_alpha 6."""

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

    def write_histograms(self, w, pass_idx: int, lz77=False) -> None:
        write_ans_flat_histograms(w, self.context_map(pass_idx)[: self.sets * self.num_ac].tolist(),
                                  self.alphabets, self.uint_cfgs, lz77=lz77,
                                  log_alpha=self.log_alpha)


def _ac_sections(tok_vals, tok_ctxs, tails=None, pass_idx=0, bits=False, coding=None):
    """rANS-encode every group's token list at once (one lane a group),
    with the histograms of pass `pass_idx` (AcCoding `coding`; group g
    codes its histogram set, g % sets, first). tails: None, or a BitList
    a group whose bits follow its AC tokens (its modular HF stream).
    bits=True returns each group's BitList, not its bytes."""
    coding = AcCoding() if coding is None else coding
    cmap = coding.context_map(pass_idx)
    hists = [flat_histogram(a, coding.log_alpha) for a in coding.alphabets]
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
            assert (t < coding.alphabets[ci]).all()
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
        if tails is not None:
            w.vals += tails[g].vals
            w.nbits += tails[g].nbits
        out.append(w if bits else w.finish())
    return out


# jpeg_upsampling of each subsampling (YCbCr; the sampling factor is Y's)
JPEG_UPSAMPLING = {"444": (0, 0, 0), "420": (0, 1, 0), "422": (0, 2, 0), "440": (0, 3, 0)}
_H_SHIFT = (0, 1, 1, 0)
_V_SHIFT = (0, 1, 0, 1)
SKIP_ADAPTIVE_LF_SMOOTHING = 0x80


def chroma_shifts(subsampling):
    """(hshift, vshift) of channels (Cb, Y, Cr) as the decoder derives
    them from jpeg_upsampling; all zero for XYB (subsampling None)."""
    ju = JPEG_UPSAMPLING[subsampling] if subsampling else (0, 0, 0)
    mh = max(_H_SHIFT[u] for u in ju)
    mv = max(_V_SHIFT[u] for u in ju)
    return (tuple(mh - _H_SHIFT[u] for u in ju), tuple(mv - _V_SHIFT[u] for u in ju))


USE_LF_FRAME = 0x20
ENABLE_SPLINES = 0x10


def pass_shift(num_passes: int, pass_idx: int) -> int:
    """The coefficient shift the writer gives pass `pass_idx`: the earlier
    passes code coarser coefficients (num_passes - 1 - pass_idx), the last
    none."""
    return num_passes - 1 - pass_idx


def write_passes(w, num_passes: int):
    """The frame header's passes field (ref frame_header.rs Passes): for
    more than one pass, one downsampling step (2x, ending with pass 0)
    and each earlier pass's shift (pass_shift)."""
    u32(w, (("val", 1), ("val", 2), ("val", 3), ("bitsoff", 3, 4)), num_passes)
    if num_passes == 1:
        return
    u32(w, (("val", 0), ("val", 1), ("val", 2), ("bitsoff", 1, 3)), 1)  # num_ds
    for p in range(num_passes - 1):
        w.write(pass_shift(num_passes, p), 2)
    u32(w, (("val", 1), ("val", 2), ("val", 4), ("val", 8)), 2)  # downsample
    u32(w, (("val", 0), ("val", 1), ("val", 2), ("bits", 3)), 0)  # last_pass


def write_colour_encoding(w, icc) -> None:
    """ImageMetadata's colour encoding: all_default (sRGB), or, with an
    ICC profile (`icc`, from test_torch_icc_streams.encode_icc), want_icc
    on an RGB colour space; the profile's bits follow the metadata."""
    if icc is None:
        w.write(1, 1)  # colour encoding all_default (sRGB)
        return
    w.write(0, 1)  # not all_default
    w.write(1, 1)  # want_icc
    w.write(0, 2)  # colour space RGB


def write_bits(w, bits) -> None:
    """Append a 0/1 bit array to the BW writer w."""
    bits = np.asarray(bits, np.int64)
    for i in range(0, len(bits), 24):
        chunk = bits[i : i + 24]
        w.write(int((chunk << np.arange(len(chunk))).sum()), len(chunk))


# -- a real encoder's coding tables (dequant matrices, coefficient orders,
# block-context map, LF quantization) -----------------------------------------


def write_f16(w, v: float) -> None:
    """An F16 header field: `v` as an IEEE half, which must hold it
    finite and, unless v is 0, nonzero."""
    h = np.float16(v)
    if not np.isfinite(h) or (h == 0) != (v == 0):
        raise ValueError(f"{v} is no finite nonzero half")
    w.write(int(h.view(np.uint16)), 16)


class BlockContextSpec:
    """A custom block-context map as an encoder writes one: LF thresholds
    on each channel (X, Y, B: 2, 2 and 3 LF buckets of the quantized LF
    values, num_lf_contexts 12), QF thresholds 6 and 9 on the raw quant
    field (3 buckets) and a seeded context map over 16 block contexts,
    every one of them used. qf_idx and lf_idx are the frame's (bh, bw)
    bucket maps, filled by encode_xyb_vardct from the LF groups as the
    decoder computes them (vardct/lf.py)."""

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
            w.write(len(thr), 4)
            for t in thr:
                u = int(_signed_token(t))
                for sel, (nbits, off) in enumerate(((4, 0), (8, 16), (16, 272), (32, 65808))):
                    if u - off < (1 << nbits):
                        w.write(sel, 2)
                        w.write(u - off, nbits)
                        break
        w.write(len(self.qf_thresholds), 4)
        for t in self.qf_thresholds:
            v = t - 1
            for sel, (nbits, off) in enumerate(((2, 0), (3, 4), (5, 12), (8, 44))):
                if v - off < (1 << nbits):
                    w.write(sel, 2)
                    w.write(v - off, nbits)
                    break
        write_context_map(w, self.context_map.tolist())

    def fill_maps(self, bw, bh, rects, lf_planes, raw_quants, tmap, hs, vs):
        """qf_idx and lf_idx from each LF group's quantized LF planes
        (lf_planes[i][c]) and raw quant values in list order."""
        self.qf_idx = np.zeros((bh, bw), np.int64)
        self.lf_idx = np.zeros((bh, bw), np.int64)
        for (ox, oy, w, h), planes, rq in zip(rects, lf_planes, raw_quants):
            sub = tmap[oy : oy + h, ox : ox + w]
            oys, oxs = np.nonzero(sub >= 128)
            self.qf_idx[oy + oys, ox + oxs] = (
                np.asarray(rq)[:, None] > np.array(self.qf_thresholds)[None, :]).sum(1)
            ys, xs = np.arange(h), np.arange(w)

            def bucket(c):
                up = planes[c][np.ix_(ys >> vs[c], xs >> hs[c])]
                return sum((up > t).astype(np.int64) for t in self.lf_thresholds[c])

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


def _dct_params_for(kind: int):
    """The library's distance bands of DCT table kind `kind`."""
    from jxl_tpu_torch.vardct import quant_weights as qw

    return {0: qw._D["dct"], 4: qw._D["dct16x16"], 5: qw._D["dct32x32"],
            6: qw._D["dct8x16"], 7: qw._D["dct8x32"], 8: qw._D["dct16x32"],
            11: qw._scaled(qw._BIG, 0.9), 12: qw._scaled(qw._BIG_RECT, 0.65),
            13: qw._scaled(qw._BIG, 1.8), 14: qw._scaled(qw._BIG_RECT, 1.3),
            15: qw._scaled(qw._BIG, 3.6), 16: qw._scaled(qw._BIG_RECT, 2.6)}[kind]


def _write_dct_params(w, rng, rows) -> None:
    """DctParams: the band count, then each channel's bands, the first
    scaled by 1/64; the library's bands, each channel's first times a
    seeded 0.8-1.25 and the others moved by up to 0.1."""
    w.write(len(rows[0]) - 1, 4)
    for row in rows:
        write_f16(w, row[0] * rng.uniform(0.8, 1.25) / 64.0)
        for v in row[1:]:
            write_f16(w, v + rng.uniform(-0.1, 0.1) if v else 0.0)


def write_dequant_matrices(w, option: str, rng, leaves) -> None:
    """HfGlobal's DequantMatrices, not all default: each table kind's mode
    (DEQUANT_MODES[option]) and its seeded parameters, the library's
    scaled by 0.8-1.25; a RAW table's entries from the tree's qt leaves
    (`leaves`, write_tree's) over a denominator of 2^-12."""
    from jxl_tpu_torch.vardct import quant_weights as qw

    w.write(0, 1)  # not all default
    modes = DEQUANT_MODES[option]
    for kind in range(qw.NUM_QUANT_TABLES):
        mode = modes.get(kind, 0)
        w.write(mode, 3)

        def scaled(rows, by=64.0):
            for row in rows:
                f = rng.uniform(0.8, 1.25)
                for v in row:
                    write_f16(w, v * f / by)

        if mode == 1:
            scaled(qw._IDENTITY_W)
        elif mode == 2:
            scaled(qw._DCT2_W)
        elif mode == 3:
            scaled([[1.0, 1.0]] * 3, 1.0)
            _write_dct_params(w, rng, qw._D["dct4x4"])
        elif mode == 4:
            scaled([[1.0]] * 3, 1.0)
            _write_dct_params(w, rng, qw._D["dct4x8"])
        elif mode == 5:
            for row in qw._AFV_W:
                f = rng.uniform(0.8, 1.25)
                for v in row[:6]:
                    write_f16(w, v * f / 64.0)
                for v in row[6:]:
                    write_f16(w, v)
            _write_dct_params(w, rng, qw._D["dct4x8"])
            _write_dct_params(w, rng, qw._D["dct4x4"])
        elif mode == 6:
            _write_dct_params(w, rng, _dct_params_for(kind))
        elif mode == 7:
            write_f16(w, RAW_DENOMINATOR)
            w.write(1, 1)  # GroupHeader: use_global_tree
            w.write(1, 1)  # default weighted-predictor header
            w.write(0, 2)  # no transforms
            width, height = 8 * qw.REQUIRED_SIZE_X[kind], 8 * qw.REQUIRED_SIZE_Y[kind]
            for _ in range(3):
                for y in range(height):
                    key = "qt_hi" if y > QT_SPLIT_ROW else "qt_lo"
                    _, _, off, mul = leaves[key]
                    _modular_bits(w, leaves, key,
                                  off + mul * _residual(rng.integers(0, 4, width)))


def _ctx_of(x: int) -> int:
    """A permutation token's context: ceil(log2(x + 1)), at most 7."""
    return min(_ceil_log2(x + 1), 7)


def apply_lehmer_tail(code, n: int) -> np.ndarray:
    """The permutation of range(n) a Lehmer code gives (the decoder's
    i-th smallest unused index; 0 past the code's end)."""
    rest = list(range(n))
    head = [rest.pop(int(v)) for v in code]
    return np.asarray(head + rest, np.int64)


# prefix-coded permutations: the Lehmer values' and the ends' tokens
# (== values, Brotli-simple codes of four symbols)
PREFIX_LEHMER = (0, 1, 2, 3)
PREFIX_ENDS = (0, 3, 5, 12)


def write_coeff_orders(w, rng, shapes, prefix: bool = False) -> dict:
    """One pass's coded coefficient orders: selector 3 and the used-orders
    mask (the frame's shapes `shapes` and one larger order no block uses),
    the permutation histograms over 8 contexts (two flat rANS clusters,
    HybridUint (4, 1, 0); with prefix=True two Brotli-simple prefix codes
    over PREFIX_ENDS and PREFIX_LEHMER, which the native HfGlobal read
    leaves to the Python path), then each used order's three seeded
    Lehmer-coded permutations: an end (0 keeps the natural order) and up
    to 40 values, each at most 20. Returns {(shape, channel): the dense
    order the decoder builds}."""
    from jxl_tpu_torch.vardct.coeff_order import TRANSFORM_TYPE_LUT, natural_order_array
    from jxl_tpu_torch.vardct.transform_map import covered_blocks_x, covered_blocks_y

    shapes = sorted(set(int(x) for x in shapes))
    extra = [o for o in range(3, 13) if o not in shapes]
    mask = sum(1 << o for o in shapes) | (1 << int(rng.choice(extra)) if extra else 0)
    w.write(3, 2)
    w.write(mask, 13)
    toks, orders = [], {}  # toks: (context, value)
    for o in range(13):
        if not (mask >> o) & 1:
            continue
        t = TRANSFORM_TYPE_LUT[o]
        nb = covered_blocks_x(t) * covered_blocks_y(t)
        size = nb * 64
        n = size - nb
        for c in range(3):
            if prefix:
                end = int(rng.choice(PREFIX_ENDS))
                code = rng.choice(PREFIX_LEHMER, end)
            else:
                end = 0 if rng.random() < 0.15 else int(rng.integers(1, 41))
                code = rng.integers(0, 21, end)
            code = np.minimum(code, n - 1 - np.arange(end))
            toks.append((_ctx_of(size), end))
            prev = 0
            for v in code.tolist():
                toks.append((_ctx_of(prev), v))
                prev = v
            tail = apply_lehmer_tail(code, n)
            orders[o, c] = natural_order_array(t).astype(np.int64)[
                np.concatenate([np.arange(nb), tail + nb])]
    cmap = [0] * 7 + [1]  # the ends' context, 7, apart
    ctx = np.array([c for c, _ in toks], np.int64)
    vals = np.array([v for _, v in toks], np.int64)
    cl = np.asarray(cmap)[ctx]
    if prefix:
        sets = [PREFIX_LEHMER, PREFIX_ENDS]
        write_prefix_clusters(w, cmap, sets)
        luts = [_code_lut(st) for st in sets]
        for v, k in zip(vals.tolist(), cl.tolist()):
            code, nbits = luts[k]
            assert nbits[v] > 0 or len(sets[k]) == 1, (v, k)
            w.write(int(code[v]), int(nbits[v]))
    else:
        cfgs = [(4, 1, 0), (4, 1, 0)]
        write_ans_flat_histograms(w, cmap, [64, 64], cfgs)
        tk, raw, nraw = hybrid_tokens(vals, cl, cfgs, [64, 64])
        write_rans_stream(w, tk, cl, raw, nraw, [64, 64])
    return orders


def write_squeezed_alpha(w, leaves, rng, width: int, height: int) -> None:
    """A single-group frame's alpha coded after two in-place squeezes,
    horizontal then vertical (the global stream's GroupHeader, then the
    channels the squeezes leave: the average, the vertical residual and
    the horizontal residual, each from the alpha leaf)."""
    w.write(1, 1)  # use_global_tree
    w.write(1, 1)  # default weighted-predictor header
    u32(w, (("val", 0), ("val", 1), ("bitsoff", 4, 2), ("bitsoff", 8, 18)), 1)
    w.write(2, 2)  # SQUEEZE
    u32(w, (("val", 0), ("bitsoff", 4, 1), ("bitsoff", 6, 9), ("bitsoff", 8, 41)), 2)
    for horizontal in (1, 0):
        w.write(horizontal, 1)
        w.write(1, 1)  # in place
        u32(w, (("bits", 3), ("bitsoff", 6, 8), ("bitsoff", 10, 72), ("bitsoff", 13, 1096)), 0)
        u32(w, (("val", 1), ("val", 2), ("val", 3), ("bitsoff", 4, 4)), 1)
    hw = -(-width // 2)
    for ch, cw in ((-(-height // 2), hw), (height // 2, hw), (height, width // 2)):
        _, _, off, mul = leaves["alpha"]
        _modular_bits(w, leaves, "alpha", off + mul * _residual(rng.integers(0, 4, (ch, cw))))


def _headers(width, height, sections, upsampling=1, noise=False, subsampling=None, num_ec=0,
             filters=True, num_passes=1, lf_frame=False, splines=False, icc=None):
    ycbcr = subsampling is not None
    w = BW()
    w.write(0xFF, 8)
    w.write(0x0A, 8)
    w.write(0, 1)  # SizeHeader: not small
    u32(w, (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30)), height * upsampling - 1)
    w.write(0, 3)
    u32(w, (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30)), width * upsampling - 1)
    w.write(0, 1)  # ImageMetadata all_default = 0
    w.write(0, 1)  # extra_fields = 0
    w.write(0, 1)  # integer samples
    w.write(0, 2)  # 8 bits
    w.write(1, 1)  # modular_16bit_sufficient
    w.write(num_ec, 2)  # extra channels: Val(0) or Val(1)
    for _ in range(num_ec):
        w.write(1, 1)  # ExtraChannelInfo all_default: 8-bit straight alpha
    w.write(0 if ycbcr else 1, 1)  # xyb_encoded
    write_colour_encoding(w, icc)
    w.write(0, 2)  # extensions
    w.write(1, 1)  # CustomTransformData all_default
    if icc is not None:
        write_bits(w, icc)
    w.pad_to_byte()
    w.write(0, 1)  # FrameHeader all_default = 0
    w.write(0, 2)  # REGULAR
    w.write(0, 1)  # VarDCT
    # flags: noise, splines, an LF frame; a YCbCr frame (a recompressed
    # JPEG) skips the adaptive LF smoothing, which a subsampled frame must
    u64(w, (1 if noise else 0) | (ENABLE_SPLINES if splines else 0)
        | (USE_LF_FRAME if lf_frame else 0) | (SKIP_ADAPTIVE_LF_SMOOTHING if ycbcr else 0))
    if ycbcr:
        w.write(1, 1)  # do_ycbcr
        if not lf_frame:
            for u in JPEG_UPSAMPLING[subsampling]:
                w.write(u, 2)
    if not lf_frame:  # a frame that reads an LF frame codes no upsampling
        ups = (("val", 1), ("val", 2), ("val", 4), ("val", 8))
        u32(w, ups, upsampling)
        for _ in range(num_ec):
            u32(w, ups, upsampling)  # ec_upsampling
    if not ycbcr:
        w.write(3, 3)  # x_qm_scale
        w.write(2, 3)  # b_qm_scale
    write_passes(w, num_passes)
    w.write(0, 1)  # no crop
    for _ in range(1 + num_ec):  # colour, then each extra channel
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
                      density: float = 0.35, cfl_zero: bool = False, lz77: bool = False,
                      max_run: int = 12, upsampling: int = 1, noise=None, subsampling=None,
                      filters: bool = True, num_ec: int = 0, passes: int = 1,
                      lf_frame: bool = False, splines=None, icc=None, lone=None,
                      dequant=None, orders: bool = False, order_codes: str = "ans",
                      bctx=None, histograms: int = 1, clusters: int = 3,
                      log_alpha: int = LOG_ALPHA, lf_quant=None, squeeze: bool = False,
                      tables_seed=None):
    """(codestream, coeffs): an XYB VarDCT frame coded at width x height,
    and the dense (G * 3 * 256 * 256,) int32
    quantized AC coefficients it encodes. transforms: "mixed" (DCT16x16 on
    aligned 2x2 positions and every 1x1 type), "dct8", or "large" (strips
    of one group row, each of DCT16 and two 1x1 types, or of the DCT32,
    DCT64, DCT128 or DCT256 transforms in all three of their shapes:
    _place_large); density: the share
    of (block, channel) items that carry coefficients, each 1 to max_run
    coefficient positions (a higher max_run writes longer sections); lz77:
    enable (unused) LZ77 in the AC histograms, which makes the frame one for
    the host AC decoder; upsampling: 1, 2, 4 or 8, the image is that many
    times the coded size; noise: None, or the 8 integers 0-1023 of the
    photon-noise LUT (entry / 1024), which turns the frame's noise on.

    subsampling: None (XYB), or "444", "420", "422" or "440": a YCbCr frame
    as a JPEG recompression writes it (do_ycbcr, jpeg_upsampling, adaptive
    LF smoothing skipped, zero CfL), whose Cb and Cr channels have their LF
    and AC items at their own resolution; subsampled frames take DCT8
    only. filters=False writes gaborish off and no EPF. num_ec=1 adds an
    8-bit straight alpha channel (0, 64, 128 or 192), coded in each group's
    modular HF stream right after its AC tokens; the result is then
    (codestream, coeffs, alpha) with alpha the (height, width) int32 plane.

    passes: 1, 2 or 3 AC passes (write_passes): each group codes one HF
    section a pass, in TOC order pass by pass, each pass with its own
    histograms (ac_context_map(pass)) and content; coeffs is the sum of
    each pass's coefficients shifted left by pass_shift, what the decoder
    adds up. With alpha the alpha is coded in the last pass's sections,
    the pass whose downsampling bracket holds full-resolution channels.
    lf_frame=True writes a frame that takes its LF from an LF frame
    (USE_LF_FRAME): its LF group sections carry the HF metadata alone.
    splines: None, or a list of test_torch_spline_streams.SplineSpec,
    coded in LfGlobal (ENABLE_SPLINES). icc: None, or the bytes of an ICC
    profile, embedded after the image header
    (test_torch_icc_streams.encode_icc). lone: a 1x1 type of BAND_TYPES
    (transforms="mixed") that the first group row holding it keeps a single
    block of, as _place_transforms says.

    A frame of one group (at most 256x256) is written in one section, as
    its TOC of one entry says (one pass, its own LF): LfGlobal, the LF
    group, HfGlobal and the HF group back to back, with an alpha channel
    coded in LfGlobal's global Modular stream; squeeze=True codes that
    alpha after two squeezes (write_squeezed_alpha), and the third value
    returned is then None.

    A real encoder's coding tables, each seeded by `tables_seed` (the
    frame's seed by default); with every default the writer writes the
    bytes it wrote before them. dequant: None (the library's matrices), or
    "raw", "params" or "mixed" (DEQUANT_MODES, write_dequant_matrices).
    orders: code each pass's coefficient orders (write_coeff_orders), the
    permutation histograms rANS-coded, or prefix-coded with
    order_codes="prefix". bctx="custom": a BlockContextSpec over 16 block
    contexts, every token's context computed from it as the decoder does.
    histograms: the AC histogram sets, HF group g coding set g % histograms;
    clusters: the AC clusters (AcCoding); log_alpha: their log alphabet
    size, 5 to 8. lf_quant: None, or the three LfQuantFactors (each a
    multiple of 2^-7 that a half holds after the factor 128), with a
    global scale of TABLES_GLOBAL_SCALE in place of 4096."""
    single = width <= GROUP_DIM and height <= GROUP_DIM
    if single and (passes != 1 or lf_frame):
        raise ValueError("the writer lays out a single-group frame in one section: one pass, "
                         "its own LF")
    if transforms not in ("mixed", "dct8", "large"):
        raise ValueError(f"unknown transforms {transforms!r}")
    if noise is not None and (len(noise) != 8 or not all(0 <= v < 1024 for v in noise)):
        raise ValueError("noise is 8 integers 0-1023")
    if subsampling is not None and subsampling not in JPEG_UPSAMPLING:
        raise ValueError(f"unknown subsampling {subsampling!r}")
    if subsampling not in (None, "444") and transforms != "dct8":
        raise ValueError("chroma-subsampled frames take DCT8 only")
    if num_ec not in (0, 1) or (num_ec and upsampling != 1):
        raise ValueError("the writer writes at most one extra channel, not upsampled")
    if passes not in (1, 2, 3):
        raise ValueError("the writer writes 1, 2 or 3 passes")
    if lf_frame and (upsampling != 1 or subsampling not in (None, "444")):
        raise ValueError("a frame that reads an LF frame codes no upsampling or subsampling")
    if dequant not in (None, *DEQUANT_MODES) or bctx not in (None, "custom"):
        raise ValueError(f"unknown dequant {dequant!r} or bctx {bctx!r}")
    if order_codes not in ("ans", "prefix") or not 5 <= log_alpha <= 8:
        raise ValueError(f"order_codes {order_codes!r}, log_alpha {log_alpha}")
    if squeeze and not (num_ec and single):
        raise ValueError("squeeze codes a single-group frame's alpha")
    ycbcr = subsampling is not None
    hs, vs = chroma_shifts(subsampling)
    rng = np.random.default_rng(seed)
    ts = seed if tables_seed is None else tables_seed
    bspec = (BlockContextSpec(np.random.default_rng([ts, 3]), 0 if ycbcr else 256)
             if bctx else None)
    coding = AcCoding(NUM_BCTX if bspec is None else bspec.num_contexts, histograms, clusters,
                      log_alpha)
    bw, bh, gxn, gyn, lgx, lgy = _frame_layout(width, height, max(hs), max(vs))
    rects = _lf_rects(bw, bh, lgx, lgy)
    if transforms == "large":
        tmap, type_lists, strips = _place_large(rng, bw, bh, rects)
        band_step = 1
    else:
        tmap, type_lists, band_step = _place_transforms(rng, bw, bh, rects, transforms == "mixed",
                                                        lone)
        strips = None

    lg = BitList()
    if splines is not None:  # after the patches, before the noise
        from test_torch_spline_streams import encode_splines

        bits = encode_splines(splines)
        lg.extend(bits, np.ones(len(bits), np.int64))
    for v in noise or ():
        lg.write(int(v), 10)  # the noise LUT comes first in LfGlobal
    if lf_quant is None:
        lg.write(1, 1)  # LfQuantFactors all_default
    else:
        lg.write(0, 1)
        for v in lf_quant:
            write_f16(lg, v * 128.0)
    lg.write(1, 2)  # global_scale: 2049 + 11 bits
    lg.write((4096 if lf_quant is None else TABLES_GLOBAL_SCALE) - 2049, 11)
    lg.write(0, 2)  # quant_lf = 16
    if bspec is None:
        lg.write(1, 1)  # default block context map
    else:
        bspec.write(lg)
    if ycbcr:
        lg.write(0, 1)  # CfL: not default
        lg.write(0, 2)  # colour factor 84
        lg.write(0, 16)  # base_correlation_x = 0.0 (f16)
        lg.write(0, 16)  # base_correlation_b = 0.0
        lg.write(128, 8)  # ytox_lf = 0
        lg.write(128, 8)  # ytob_lf = 0
    else:
        lg.write(1, 1)  # default CfL
    lg.write(1, 1)  # global tree
    # the modular stream id of group 0's HF section (pass 0); a
    # single-group frame codes its alpha in the global stream instead
    first_hf = 1 + 3 * len(rects) + 17 if num_ec and not single else None
    # YCbCr: Y's LF about 0, as the zero-centred Y of a JPEG
    leaves = write_tree(lg, build_tree(len(rects), band_step, 0 if ycbcr else 256, first_hf,
                                       strips, global_alpha=bool(num_ec) and single,
                                       qtables=dequant in ("raw", "mixed")))
    leaves["_band_step"] = band_step
    if num_ec and not squeeze:
        # the global modular image (the alpha channel alone): its
        # GroupHeader; a channel larger than a group leaves section 0
        # empty and each group codes its part, a single group's alpha is
        # coded here (below, once drawn)
        lg.write(1, 1)  # use_global_tree
        lg.write(1, 1)  # default weighted-predictor header
        lg.write(0, 2)  # no transforms
    elif squeeze:
        write_squeezed_alpha(lg, leaves, np.random.default_rng([seed, 4]), width, height)
    records = [{} for _ in rects]
    lf_parts = [
        _lf_group_section(rng, leaves, rect, types, cfl_zero or ycbcr, hs, vs, not lf_frame,
                          None if strips is None else strips[i], bits=single,
                          record=records[i])
        for i, (rect, types) in enumerate(zip(rects, type_lists))
    ]
    lf_sections = [part[0] for part in lf_parts]
    if bspec is not None:
        if lf_frame:
            raise ValueError("a custom block-context map needs the frame's own LF")
        bspec.fill_maps(bw, bh, rects, records, [part[1] for part in lf_parts], tmap, hs, vs)
    hg = BitList()
    if dequant is None:
        hg.write(1, 1)  # default dequant matrices
    else:
        write_dequant_matrices(hg, dequant, np.random.default_rng([ts, 1]), leaves)
    hg.write(histograms - 1, _ceil_log2(gxn * gyn))
    if histograms > gxn * gyn:
        raise ValueError(f"{histograms} histogram sets in {gxn * gyn} groups")
    from jxl_tpu_torch.vardct.transform_map import block_shape_id

    shapes = np.unique([block_shape_id(int(t)) for t in np.unique(tmap[tmap >= 128] & 127)])
    order_rng = np.random.default_rng([ts, 2])
    pass_orders = []
    for p in range(passes):
        if orders:
            pass_orders.append(write_coeff_orders(hg, order_rng, shapes,
                                                  prefix=order_codes == "prefix"))
        else:
            hg.write(2, 2)  # natural coefficient orders
            pass_orders.append(None)
        coding.write_histograms(hg, p, lz77=lz77)
    coeffs = np.zeros(gxn * gyn * GROUP_STRIDE, np.int32)
    tok_vals = [[] for _ in range(passes)]
    tok_ctxs = [[] for _ in range(passes)]
    for p in range(passes):
        for g in range(gxn * gyn):
            v, c, dest, val = _ac_tokens(rng, tmap, g, gxn, density, max_run, hs, vs,
                                         pass_orders[p], bspec)
            tok_vals[p].append(v)
            tok_ctxs[p].append(c)
            coeffs[dest] += (val << pass_shift(passes, p)).astype(np.int32)
    tails = alpha = None
    if num_ec:
        alpha = (128 + 64 * _residual(rng.integers(0, 4, (height, width)))).astype(np.int32)
    if squeeze:
        alpha = None
    elif num_ec and single:
        _modular_bits(lg, leaves, "alpha", alpha)
    elif num_ec:
        tails = []
        for g in range(gxn * gyn):
            x0, y0 = (g % gxn) * GROUP_DIM, (g // gxn) * GROUP_DIM
            t = BitList()
            t.write(1, 1)  # GroupHeader: use_global_tree
            t.write(1, 1)  # default weighted-predictor header
            t.write(0, 2)  # no transforms
            _modular_bits(t, leaves, "alpha", alpha[y0 : y0 + GROUP_DIM, x0 : x0 + GROUP_DIM])
            tails.append(t)
    hf_sections = []
    for p in range(passes):
        hf_sections += _ac_sections(tok_vals[p], tok_ctxs[p],
                                    tails if p == passes - 1 else None, p, bits=single,
                                    coding=coding)
    if single:
        # one TOC entry: LfGlobal, the LF group, HfGlobal and the HF group
        # read in turn from one bit reader, with no padding between them
        one = BitList()
        for part in [lg] + lf_sections + [hg] + hf_sections:
            one.vals += part.vals
            one.nbits += part.nbits
        sections = [one.finish()]
    else:
        sections = [lg.finish()] + lf_sections + [hg.finish()] + hf_sections
    if icc is not None:
        from test_torch_icc_streams import encode_icc

        icc = encode_icc(icc)
    head = _headers(width, height, sections, upsampling, noise is not None, subsampling, num_ec,
                    filters, passes, lf_frame, splines is not None, icc)
    if num_ec:
        return head + b"".join(sections), coeffs, alpha
    return head + b"".join(sections), coeffs


def encode_ycbcr_vardct(width: int, height: int, seed: int = 0, subsampling: str = "420",
                        **kw):
    """(codestream, coeffs): the YCbCr VarDCT frame of a recompressed JPEG,
    DCT8 only (encode_xyb_vardct with `subsampling`)."""
    return encode_xyb_vardct(width, height, seed, transforms="dct8", subsampling=subsampling,
                             **kw)


def long_section_stream():
    """(codestream, coeffs) of two full 256x256 groups, every item of
    them carrying coefficients: sections of about 20 KB."""
    return encode_xyb_vardct(512, 256, seed=9, transforms="dct8", density=1.0, max_run=16)


def random_int32_table(rng, log_bucket, extra=3):
    """(5, NB) table of arbitrary int32 fields for the batch rANS decode
    (K2), NB past 4096 >> log_bucket: negative offsets and dists, cutoffs
    both far out of range and inside a bucket, so that both sides of the
    signed cutoff compare and the wrapping alias offset + pos run."""
    nb = (4096 >> log_bucket) + extra
    t = rng.integers(-(1 << 31), 1 << 31, (5, nb), dtype=np.int64)
    near = rng.random(nb) < 0.5
    t[3, near] = rng.integers(-2, (1 << log_bucket) + 2, int(near.sum()))
    return t.astype(np.int32)


def random_lanes(seed, S=6, G=3, I=48, log_alpha=5, clusters=3):
    """Inputs of decode_ac_sections for S random lanes over G groups of I
    random items (wild positions, block contexts and coefficient offsets),
    valid packed alias tables of 2**log_alpha symbols in `clusters`
    clusters and random stream bytes: corrupt lanes that exercise every
    clip and error path."""
    from jxl_tpu_torch.entropy.ans import AnsHistogram
    from jxl_tpu_torch.ops.device_ans import pack_table

    rng = np.random.default_rng(seed)
    nb_t = 1 << log_alpha
    lb = 12 - log_alpha
    hists = []
    for _ in range(clusters):
        h = AnsHistogram.__new__(AnsHistogram)
        w = rng.integers(1, 100, nb_t).astype(np.float64)
        d = np.floor(w / w.sum() * 4096).astype(int)
        d[0] += 4096 - d.sum()
        h.dist = d.tolist()
        h.log_bucket_size, h.bucket_mask = lb, (1 << lb) - 1
        h.single_symbol = None
        h._build_alias_map(nb_t, 1 << lb)
        hists.append(h)
    tables = np.stack([pack_table(h) for h in hists]).astype(np.int32)
    uint_cfgs = np.array([[log_alpha, 0, 0], [4, 1, 0], [3, 1, 1]], np.int32)[
        np.arange(clusters) % 3]
    cx = rng.integers(1, 3, (G, I))
    cy = rng.integers(1, 3, (G, I))
    nb = cx * cy
    items = np.stack([
        rng.integers(0, 3, (G, I)),  # c
        rng.integers(0, 31, (G, I)),  # sbx
        rng.integers(0, 31, (G, I)),  # sby
        nb, nb * 64,
        rng.integers(0, 15, (G, I)),  # block context
        np.zeros((G, I), np.int64),  # order offset
        rng.integers(0, 3 * 65536 - 256, (G, I)),  # coefficient offset
        cx, cy,
    ], axis=2).astype(np.int32)
    orders = np.concatenate([rng.permutation(256) for _ in range(2)]).astype(np.int32)
    n_ctx = 2 * 15 * 495 + 16
    S_len = 96
    return dict(
        streams=rng.integers(0, 256, (S, S_len), dtype=np.uint8),
        start_bits=rng.integers(0, 40, S).astype(np.int32),
        lane_group=(np.arange(S) % G).astype(np.int32),
        lane_ctx_off=rng.integers(0, 2, S).astype(np.int32) * 15 * 495,
        lane_shift=rng.integers(0, 3, S).astype(np.int32),
        lane_order_base=rng.integers(0, 256, S).astype(np.int32),
        lane_coeff_base=((np.arange(S) % G) * 3 * 65536).astype(np.int32),
        lane_n_items=rng.integers(1, I + 1, S).astype(np.int32),
        lane_end_bits=np.full(S, S_len * 8 - 64, np.int32),
        items=items, orders=orders, tables=tables, uint_cfgs=uint_cfgs,
        context_map=rng.integers(0, clusters, n_ctx).astype(np.int32),
        log_bucket=lb, num_bctx=15, total=G * 3 * 65536, n_buckets=nb_t,
    )


# -- the JAX package reads the streams back --------------------------------------


@pytest.mark.parametrize("size,transforms", [((520, 300), "mixed"), ((600, 520), "dct8"),
                                              ((300, 1030), "mixed"), ((776, 1290), "large")])
def test_jxl_tpu_decodes_writer_coefficients(size, transforms):
    from test_device_ac import _decode_frame_coeffs

    data, coeffs = encode_xyb_vardct(*size, seed=5, transforms=transforms)
    got = _decode_frame_coeffs(data, force_device=False)
    np.testing.assert_array_equal(got, coeffs)
    assert np.count_nonzero(coeffs) > 100


def test_writer_covers_every_1x1_type_and_dct16():
    from jxl_tpu.api.simple import decode_first_frame

    data, _ = encode_xyb_vardct(1100, 700, seed=6)
    frame = decode_first_frame(data).frame
    tmap = np.asarray(frame.hf_meta["transform"])
    types = set(np.unique(tmap[tmap >= 128] & 127).tolist())
    assert types == {0, 1, 2, 3, 4, 12, 13, 14, 15, 16, 17}
    assert len(np.unique(frame.hf_meta["epf"])) == 8
    assert len(np.unique(frame.hf_meta["raw_quant"])) == 4
    rf = frame.header.restoration_filter
    assert rf.gab and rf.epf_iters == 2


def test_large_writer_covers_every_transform_from_dct32_up():
    """transforms="large" codes every square and rectangular transform of
    32 to 256 pixels, DCT16 and its fill, each strip's origins in one run
    of the list."""
    from jxl_tpu.api.simple import decode_first_frame

    data, _ = encode_xyb_vardct(776, 1290, seed=5, transforms="large")
    tmap = np.asarray(decode_first_frame(data).frame.hf_meta["transform"])
    types = set(np.unique(tmap[tmap >= 128] & 127).tolist())
    assert types == {0, 2, 3, 4, 5, 10, 11} | set(range(18, 27))


# sha256 of the writer's bytes before it had the upsampling and noise
# options: the defaults still write them
_DEFAULT_BYTES = {
    "520x300_seed5": "26b2147f482e6e5786018758691b8aa99343e6f948106298a7a9a6d60f7dc58b",
    "300x200_dct8_seed42": "8ad817bba2419613d3ed40365581ddce0fe1b351ff056a64f9782a9457637ed6",
}


@pytest.mark.parametrize("name", list(_DEFAULT_BYTES))
def test_defaults_write_the_earlier_bytes(name):
    import hashlib

    if name == "520x300_seed5":
        data, _ = encode_xyb_vardct(520, 300, seed=5)
    else:
        data, _ = encode_xyb_vardct(300, 200, seed=42, transforms="dct8", density=0.15)
    assert hashlib.sha256(data).hexdigest() == _DEFAULT_BYTES[name]


@pytest.mark.parametrize("upsampling,noise", [(2, None), (1, (5, 0, 1023, 7, 512, 3, 9, 100)),
                                              (2, (40, 90, 130, 200, 260, 330, 400, 470)),
                                              (4, None), (8, (1,) * 8)])
def test_jxl_tpu_decodes_writer_options(upsampling, noise):
    from jxl_tpu.api.simple import decode_first_frame
    from test_device_ac import _decode_frame_coeffs

    data, coeffs = encode_xyb_vardct(300, 264, seed=12, density=0.1, upsampling=upsampling,
                                     noise=noise)
    np.testing.assert_array_equal(_decode_frame_coeffs(data, force_device=False), coeffs)
    frame = decode_first_frame(data).frame
    assert frame.header.upsampling == upsampling
    assert (frame.file_header.xsize, frame.file_header.ysize) == (300 * upsampling,
                                                                   264 * upsampling)
    assert frame.header.has_noise == (noise is not None)
    if noise is not None:
        assert frame.lf_global.noise.lut == [v / 1024.0 for v in noise]


@pytest.mark.parametrize("subsampling", ["420", "422", "440"])
def test_jxl_tpu_decodes_ycbcr_writer_streams(subsampling):
    """A recompressed-JPEG layout: YCbCr, the chroma shifts, adaptive LF
    smoothing skipped, zero CfL; jxl_tpu returns the writer's coefficients,
    Cb and Cr only at the blocks aligned to their grid."""
    from jxl_tpu.api.simple import decode_first_frame
    from test_device_ac import _decode_frame_coeffs

    data, coeffs = encode_ycbcr_vardct(520, 300, seed=51, subsampling=subsampling, density=0.2,
                                       filters=subsampling != "422")
    np.testing.assert_array_equal(_decode_frame_coeffs(data, force_device=False), coeffs)
    frame = decode_first_frame(data).frame
    header = frame.header
    assert header.do_ycbcr and not frame.file_header.image_metadata.xyb_encoded
    assert list(header.jpeg_upsampling) == list(JPEG_UPSAMPLING[subsampling])
    hs, vs = chroma_shifts(subsampling)
    assert [header.hshift(c) for c in range(3)] == list(hs)
    assert [header.vshift(c) for c in range(3)] == list(vs)
    assert not header.should_do_adaptive_lf_smoothing
    ccp = frame.lf_global.color_correlation_params
    assert (ccp.base_correlation_x, ccp.base_correlation_b, ccp.ytox_lf, ccp.ytob_lf) == (0, 0, 0, 0)
    assert not np.asarray(frame.hf_meta["ytox"]).any() and not np.asarray(frame.hf_meta["ytob"]).any()
    rf = header.restoration_filter
    assert (rf.gab, rf.epf_iters) == ((True, 2) if subsampling != "422" else (False, 0))
    # every channel carries coefficients, Y the most
    per = [np.count_nonzero(coeffs.reshape(-1, 3, GROUP_DIM * GROUP_DIM)[:, c]) for c in range(3)]
    assert min(per) > 100 and per[1] == max(per)


def test_jxl_tpu_decodes_writer_alpha():
    """num_ec=1: the alpha in each group's modular HF stream after its AC;
    jxl_tpu returns the writer's coefficients and alpha plane."""
    from jxl_tpu.api.simple import decode_first_frame
    from test_device_ac import _decode_frame_coeffs

    data, coeffs, alpha = encode_xyb_vardct(520, 300, seed=52, density=0.2, num_ec=1)
    np.testing.assert_array_equal(_decode_frame_coeffs(data, force_device=False), coeffs)
    dec = decode_first_frame(data)
    infos = dec.frame.file_header.image_metadata.extra_channel_info
    assert len(infos) == 1 and infos[0].bit_depth.bits_per_sample == 8
    assert not infos[0].alpha_associated
    # a VarDCT frame's modular image holds the extra channel alone
    assert len(dec.channels) == 1
    np.testing.assert_array_equal(np.asarray(dec.channels[0]), alpha)
    assert alpha.shape == (300, 520) and set(np.unique(alpha).tolist()) == {0, 64, 128, 192}


def test_ycbcr_writer_refuses_big_blocks_when_subsampled():
    with pytest.raises(ValueError, match="DCT8 only"):
        encode_xyb_vardct(520, 300, subsampling="420")


@pytest.mark.parametrize("num_ec", [0, 1])
def test_jxl_tpu_decodes_single_section_writer(num_ec):
    """A frame of one group is one section (one TOC entry): jxl_tpu's
    Frame.split_sections gives that one reader, and its section decode
    (LfGlobal, the LF group, HfGlobal, the HF group, read in turn from it)
    returns the writer's coefficients and alpha plane."""
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader
    from jxl_tpu.io.headers.frame import FrameHeader, Toc
    from jxl_tpu.render.anim_fold import _decode_one_frame_deferred

    out = encode_xyb_vardct(200, 136, seed=53, density=0.2, num_ec=num_ec)
    data, coeffs = out[0], out[1]
    br = BitReader(data)
    fh = FileHeader.read(br)
    header = FrameHeader.read(br, fh)
    toc = Toc.read(br, header.num_toc_entries)
    br.jump_to_byte_boundary()
    assert header.num_toc_entries == 1 and toc.entries[0] == len(data) - br.pos // 8
    frame = _decode_one_frame_deferred(fh, data, (header, toc, br.pos), None)
    assert len(frame.split_sections(BitReader(data[br.pos // 8 :]))) == 1
    np.testing.assert_array_equal(frame.hf_global.hf_coefficients[0].reshape(-1), coeffs)
    assert np.count_nonzero(coeffs) > 100
    if num_ec:
        np.testing.assert_array_equal(frame.lf_global.modular_global.output_channel(3), out[2])
