"""The benchmark's recompressed-JPEG writer: a single-frame YCbCr VarDCT
codestream, chroma-subsampled as a JPEG is, of seeded random content, in
the ISOBMFF container beside a `jbrd` box, as libjxl's cjxl writes a
`.jpg` input by default (lossless JPEG transcode).

A frozen copy, as of the cell vardct_jpeg.photo_4k, of the subsampled
path of the repository's test writer
(tests/test_torch_vardct_streams.py::encode_ycbcr_vardct, which is
encode_xyb_vardct with `subsampling`), cut to DCT8, one pass and no
extra channels, and writing the same codestream bytes for the options a
configuration uses. It imports nothing of the decoder: the shared
entropy coding, MA tree, dequant tables and coefficient orders come from
xyb_vardct.py, the format's tables from spec.py.

The frame: do_ycbcr with jpeg_upsampling (Cb, Y, Cr), adaptive LF
smoothing skipped, DCT8 everywhere, chroma from luma coded as zero (both
base correlations and every tile), one pass, the quantizer's global
scale 4096 and quant_lf 16, gaborish off and no EPF.
Each channel codes its LF and its AC items at its own resolution: Cb and
Cr only at the blocks aligned to their grid, their nonzeros predicted on
that grid. The options (`dequant`, `orders`, `histograms`, `clusters`,
`log_alpha`) are xyb_vardct's, coded the same way.

The container: the JPEG XL signature box, `ftyp`, a `jbrd` box of
JBRD_BYTES seeded opaque bytes (a real one holds what rebuilds the JPEG
file; no pixel decode reads it), then the codestream in `jxlc`.
"""

from __future__ import annotations

import numpy as np

from . import spec
from . import xyb_vardct as xv
from .mini_encoder import BW, u32, u64

GD_BLOCKS = xv.GD_BLOCKS
LF_GROUP_BLOCKS = xv.LF_GROUP_BLOCKS
# jpeg_upsampling of each subsampling, channels (Cb, Y, Cr)
JPEG_UPSAMPLING = {"444": (0, 0, 0), "420": (0, 1, 0), "422": (0, 2, 0), "440": (0, 3, 0)}
_H_SHIFT = (0, 1, 1, 0)
_V_SHIFT = (0, 1, 0, 1)
SKIP_ADAPTIVE_LF_SMOOTHING = 0x80
JBRD_BYTES = 2048
MAX_RUN = 12  # coefficient positions of an item that carries any


def chroma_shifts(subsampling: str) -> tuple:
    """(hshift, vshift) of channels (Cb, Y, Cr) as the decoder derives
    them from jpeg_upsampling."""
    ju = JPEG_UPSAMPLING[subsampling]
    mh = max(_H_SHIFT[u] for u in ju)
    mv = max(_V_SHIFT[u] for u in ju)
    return (tuple(mh - _H_SHIFT[u] for u in ju), tuple(mv - _V_SHIFT[u] for u in ju))


def _frame_layout(width, height, maxhs, maxvs):
    """(bw, bh, gx, gy, lgx, lgy): the block grid, padded to whole
    chroma blocks, and the group and LF group counts."""
    bw = -(-width // (8 << maxhs)) << maxhs
    bh = -(-height // (8 << maxvs)) << maxvs
    gx, gy = -(-width // xv.GROUP_DIM), -(-height // xv.GROUP_DIM)
    lgx, lgy = -(-bw // LF_GROUP_BLOCKS), -(-bh // LF_GROUP_BLOCKS)
    return bw, bh, gx, gy, lgx, lgy


def build_tree(num_lf_groups: int, band_step: int, qtables: bool):
    """xyb_vardct.build_tree with Y's LF leaf about 0, as the zero-centred
    Y of a JPEG."""
    types = xv._leaf("band0", 0, 0)
    for b in range(1, len(xv.BAND_TYPES)):
        types = xv._split(3, b * band_step - 1, xv._leaf(f"band{b}", 0, 0), types)
    meta = xv._split(0, 1,
                     xv._split(0, 2,
                               xv._split(3, 31, xv._leaf("epf_hi", 6, 0),
                                         xv._leaf("epf_lo", 2, 0)),
                               xv._split(2, 0, xv._leaf("quant", 8, 1), types)),
                     xv._leaf("cfl", 0, 0))
    lf = xv._split(0, 0, xv._split(0, 1, xv._leaf("lf_b", 0, 2), xv._leaf("lf_x", 0, 3)),
                   xv._leaf("lf_y", 0, 4))
    tree = xv._split(1, num_lf_groups, meta, lf)
    if qtables:
        qt = xv._split(2, xv.QT_SPLIT_ROW, xv._leaf("qt_hi", *xv.QT_LEAVES["qt_hi"]),
                       xv._leaf("qt_lo", *xv.QT_LEAVES["qt_lo"]))
        tree = xv._split(1, 3 * num_lf_groups, qt, tree)
    return tree


def _lf_group_section(rng, leaves, rect, types, hs, vs, record):
    """One LF group's section: its LF coefficients, each channel at its
    own (subsampled) size, then its HF metadata with a zero CfL map.
    record: a dict that receives the quantized LF planes by channel (0
    Cb, 1 Y, 2 Cr)."""
    ox, oy, w, h = rect
    sec = xv.BitList()
    sec.write(0, 2)  # extra_precision
    sec.write(1, 1)  # GroupHeader: use_global_tree
    sec.write(1, 1)  # default weighted-predictor header
    sec.write(0, 2)  # no transforms
    # modular order [Y, Cb, Cr]
    for key, c in (("lf_y", 1), ("lf_x", 0), ("lf_b", 2)):
        _, _, base, mul = leaves[key]
        vals = base + mul * xv._residual(rng.integers(0, 4, (h >> vs[c], w >> hs[c])))
        xv._modular_bits(sec, leaves, key, vals)
        record[c] = vals
    count = len(types)
    sec.write(count - 1, xv._ceil_log2(w * h))
    sec.write(1, 1)
    sec.write(1, 1)
    sec.write(0, 2)
    cw, ch = -(-w // 8), -(-h // 8)
    for _ in range(2):  # ytox, ytob
        xv._modular_bits(sec, leaves, "cfl", np.zeros((ch, cw), np.int64))
    for b in range(len(xv.BAND_TYPES)):
        step = leaves["_band_step"]
        lo = b * step
        hi = count if b == len(xv.BAND_TYPES) - 1 else min(count, (b + 1) * step)
        if lo < hi:
            xv._modular_bits(sec, leaves, f"band{b}", types[lo:hi])
    quants = 8 + 2 * xv._residual(rng.integers(0, 4, count))
    xv._modular_bits(sec, leaves, "quant", quants)
    epf = rng.integers(0, 4, (h, w)) + np.where(np.arange(w) > 31, 4, 0)[None, :]
    code_lo, nb_lo, off_lo, _ = leaves["epf_lo"]
    code_hi, nb_hi, off_hi, _ = leaves["epf_hi"]
    hi_px = np.broadcast_to(np.arange(w) > 31, (h, w)).reshape(-1)
    tok = xv._signed_token(epf.reshape(-1) - np.where(hi_px, off_hi, off_lo))
    sec.extend(np.where(hi_px, code_hi[tok], code_lo[tok]),
               np.where(hi_px, nb_hi[tok], nb_lo[tok]))
    return sec.finish(), quants + 1


def _ac_tokens(rng, tmap, g, gxn, density, hs, vs, orders):
    """One group's AC content with the default block-context map: (token
    values, contexts, dense destinations, values). A channel has items
    only at the blocks aligned to its grid, and its nonzeros are
    predicted on that grid."""
    gx0, gy0 = (g % gxn) * GD_BLOCKS, (g // gxn) * GD_BLOCKS
    sub = tmap[gy0 : gy0 + GD_BLOCKS, gx0 : gx0 + GD_BLOCKS]
    bys, bxs = np.nonzero(sub >= 128)
    tids = (sub[bys, bxs] & 127).astype(np.int64)
    cxs, cys, shapes = xv._CBX[tids], xv._CBY[tids], xv._SHAPES[tids]
    nbs = cxs * cys
    ncs = nbs * 64
    offs = np.concatenate([[0], np.cumsum(ncs)[:-1]])
    num_bctx = xv.NUM_BCTX
    # items: per block, channels 1, 0, 2
    chan = np.tile(np.array([1, 0, 2]), len(tids))
    rep = lambda a: np.repeat(a, 3)  # noqa: E731
    bx, by, cx, cy, nb, nc, off, shape = map(rep, (bxs, bys, cxs, cys, nbs, ncs, offs, shapes))
    hs_c, vs_c = np.asarray(hs)[chan], np.asarray(vs)[chan]
    sbx, sby = bx >> hs_c, by >> vs_c
    aligned = ((sbx << hs_c) == bx) & ((sby << vs_c) == by)
    chan, bx, by, cx, cy, nb, nc, off, shape, sbx, sby = (
        a[aligned] for a in (chan, bx, by, cx, cy, nb, nc, off, shape, sbx, sby))
    cidx = np.where(chan < 2, chan ^ 1, 2)
    bctx = spec.DEFAULT_BLOCK_CONTEXTS[cidx * 13 + shape]
    M = len(chan)
    L = np.where(rng.random(M) < density, rng.integers(1, MAX_RUN + 1, M), 0)
    L = np.minimum(L, nc - nb)
    # coefficient values: nonzero with probability 0.6, the last one always
    cstart = np.cumsum(L) - L
    item_of_c = np.repeat(np.arange(M), L)
    j = np.arange(L.sum()) - cstart[item_of_c]
    mag = np.minimum(rng.geometric(0.45, len(j)), xv.MAX_COEFF)
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
    ctx_c = (num_bctx * 37 + 458 * bctx[item_of_c]
             + (xv._NUM_NZ_CTX[nzl] + xv._FREQ_CTX[kn]) * 2 + prev)
    # token stream: per item the nonzeros count, then its coefficients
    ntok = 1 + L
    tstart = np.cumsum(ntok) - ntok
    tok_val = np.empty(ntok.sum(), np.int64)
    tok_ctx = np.empty(ntok.sum(), np.int64)
    tok_val[tstart] = nz
    tok_ctx[tstart] = ctx_nz
    cpos = tstart[item_of_c] + 1 + j
    tok_val[cpos] = xv._signed_token(val)
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
    dest = (g * xv.GROUP_STRIDE + chan[item_of_c] * xv.GROUP_DIM * xv.GROUP_DIM
            + off[item_of_c] + slot)
    return tok_val, tok_ctx, dest, val


def _headers(width, height, sections, subsampling):
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
    w.write(0, 1)  # not xyb_encoded
    w.write(1, 1)  # colour encoding all_default (sRGB)
    w.write(0, 2)  # extensions
    w.write(1, 1)  # CustomTransformData all_default
    w.pad_to_byte()
    w.write(0, 1)  # FrameHeader all_default = 0
    w.write(0, 2)  # REGULAR
    w.write(0, 1)  # VarDCT
    u64(w, SKIP_ADAPTIVE_LF_SMOOTHING)  # flags
    w.write(1, 1)  # do_ycbcr
    for u in JPEG_UPSAMPLING[subsampling]:
        w.write(u, 2)
    u32(w, (("val", 1), ("val", 2), ("val", 4), ("val", 8)), 1)  # upsampling
    u32(w, (("val", 1), ("val", 2), ("val", 3), ("bitsoff", 3, 4)), 1)  # passes
    w.write(0, 1)  # no crop
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


def _box(kind: bytes, payload: bytes) -> bytes:
    return (8 + len(payload)).to_bytes(4, "big") + kind + payload


def container(codestream: bytes, jbrd: bytes) -> bytes:
    """The file: the signature box, `ftyp` (brand "jxl ", minor version
    0, compatible "jxl "), `jbrd`, then the codestream in `jxlc`."""
    return (_box(b"JXL ", b"\r\n\x87\n") + _box(b"ftyp", b"jxl \0\0\0\0jxl ")
            + _box(b"jbrd", jbrd) + _box(b"jxlc", codestream))


def encode_ycbcr_vardct(width: int, height: int, seed: int = 0, subsampling: str = "420",
                        density: float = 0.35, dequant=None, orders: bool = False,
                        histograms: int = 1, clusters: int = 3, log_alpha: int = xv.LOG_ALPHA):
    """(codestream, what it codes): a YCbCr VarDCT frame of more than one
    group at width x height, DCT8 only, no restoration filters, chroma
    subsampled by `subsampling` ("444", "420", "422" or "440"). density,
    dequant, orders, histograms, clusters and log_alpha as in
    xyb_vardct.encode_xyb_vardct; the tables are seeded by `seed`.

    What it codes is a dict: "lf" [Cb, Y, Cr] int64 quantized LF, channel
    c (bh >> vshift, bw >> hshift); "hshift", "vshift" the channels'
    shifts; "transform" (bh, bw) uint8 (origins | 128); "raw_quant" (bh,
    bw) int64; the chroma from luma as coded, all zero: "ytox" and "ytob"
    (ceil(bh / 8), ceil(bw / 8)) int64 and "base_correlation" (x, b);
    "dequant" (xyb_vardct.write_dequant_matrices or None),
    "global_scale", "quant_lf", "subsampling"; "coeffs" the
    dense (G * 3 * 256 * 256,) int32 quantized AC coefficients, group
    after group, channel after channel, each block's coefficients at its
    raster-order offset among every block of its group and its
    natural-order slot, chroma only at the blocks aligned to its grid;
    and the AC sections' shape, as xyb_vardct returns it:
    "ac_section_bytes", "ac_tokens", "ac_clusters", "ac_log_alpha",
    "ac_contexts", "groups"."""
    if width <= xv.GROUP_DIM and height <= xv.GROUP_DIM:
        raise ValueError("the writer writes frames of more than one group")
    if subsampling not in JPEG_UPSAMPLING:
        raise ValueError(f"unknown subsampling {subsampling!r}")
    if dequant not in (None, *xv.DEQUANT_MODES) or not 5 <= log_alpha <= 8:
        raise ValueError(f"dequant {dequant!r}, log_alpha {log_alpha}")
    hs, vs = chroma_shifts(subsampling)
    rng = np.random.default_rng(seed)
    coding = xv.AcCoding(xv.NUM_BCTX, histograms, clusters, log_alpha)
    bw, bh, gxn, gyn, lgx, lgy = _frame_layout(width, height, max(hs), max(vs))
    rects = xv._lf_rects(bw, bh, lgx, lgy)
    tmap, type_lists, band_step = xv._place_transforms(rng, bw, bh, rects, False)

    lg = xv.BitList()
    lg.write(1, 1)  # LfQuantFactors all_default
    lg.write(1, 2)  # global_scale: 2049 + 11 bits
    lg.write(4096 - 2049, 11)
    lg.write(0, 2)  # quant_lf = 16
    lg.write(1, 1)  # default block context map
    lg.write(0, 1)  # CfL: not default
    lg.write(0, 2)  # colour factor 84
    lg.write(0, 16)  # base_correlation_x = 0.0 (f16)
    lg.write(0, 16)  # base_correlation_b = 0.0
    lg.write(128, 8)  # ytox_lf = 0
    lg.write(128, 8)  # ytob_lf = 0
    lg.write(1, 1)  # global tree
    leaves = xv.write_tree(lg, build_tree(len(rects), band_step, dequant in ("raw", "mixed")))
    leaves["_band_step"] = band_step
    records = [{} for _ in rects]
    lf_parts = [_lf_group_section(rng, leaves, rect, types, hs, vs, records[i])
                for i, (rect, types) in enumerate(zip(rects, type_lists))]
    hg = xv.BitList()
    if dequant is None:
        hg.write(1, 1)  # default dequant matrices
        dq_tables = None
    else:
        dq_tables = xv.write_dequant_matrices(hg, dequant, np.random.default_rng([seed, 1]), leaves)
    if histograms > gxn * gyn:
        raise ValueError(f"{histograms} histogram sets in {gxn * gyn} groups")
    hg.write(histograms - 1, xv._ceil_log2(gxn * gyn))
    if orders:
        pass_orders = xv.write_coeff_orders(hg, np.random.default_rng([seed, 2]), [0])
    else:
        hg.write(2, 2)  # natural coefficient orders
        pass_orders = None
    coding.write_histograms(hg, 0)
    coeffs = np.zeros(gxn * gyn * xv.GROUP_STRIDE, np.int32)
    tok_vals, tok_ctxs = [], []
    for g in range(gxn * gyn):
        v, c, dest, val = _ac_tokens(rng, tmap, g, gxn, density, hs, vs, pass_orders)
        tok_vals.append(v)
        tok_ctxs.append(c)
        coeffs[dest] += val.astype(np.int32)
    hf_sections = xv._ac_sections(tok_vals, tok_ctxs, coding)
    sections = [lg.finish()] + [part[0] for part in lf_parts] + [hg.finish()] + hf_sections
    head = _headers(width, height, sections, subsampling)

    lf = [np.zeros((bh >> vs[c], bw >> hs[c]), np.int64) for c in range(3)]
    raw_quant = np.zeros((bh, bw), np.int64)
    for (ox, oy, w, h), rec, (_, rq) in zip(rects, records, lf_parts):
        for c in range(3):
            lf[c][oy >> vs[c] : (oy >> vs[c]) + rec[c].shape[0],
                  ox >> hs[c] : (ox >> hs[c]) + rec[c].shape[1]] = rec[c]
        # DCT8 everywhere: the coefficient list is the LF group's blocks in
        # raster order
        raw_quant[oy : oy + h, ox : ox + w] = rq.reshape(h, w)
    coded = {
        "lf": lf, "hshift": hs, "vshift": vs, "transform": tmap, "raw_quant": raw_quant,
        "ytox": np.zeros((-(-bh // 8), -(-bw // 8)), np.int64),
        "ytob": np.zeros((-(-bh // 8), -(-bw // 8)), np.int64), "base_correlation": (0.0, 0.0),
        "dequant": dq_tables, "global_scale": 4096, "quant_lf": 16,
        "subsampling": subsampling, "coeffs": coeffs,
        "ac_section_bytes": sum(len(s) for s in hf_sections),
        "ac_tokens": int(sum(len(v) for v in tok_vals)),
        "ac_clusters": clusters, "ac_log_alpha": log_alpha,
        "ac_contexts": histograms * coding.num_ac + xv.CTX_PAD, "groups": gxn * gyn,
    }
    return head + b"".join(sections), coded


def write(width: int, height: int, seed: int, **options):
    """The configuration's entry point: (the container's bytes, what the
    codestream codes) of encode_ycbcr_vardct, the jbrd box seeded from
    `seed`."""
    codestream, coded = encode_ycbcr_vardct(width, height, seed, **options)
    jbrd = np.random.default_rng([seed, 5]).integers(0, 256, JBRD_BYTES, dtype=np.uint8)
    return container(codestream, jbrd.tobytes()), coded
