"""XYB Modular test streams, and checks that both decoders read them back.

`encode_xyb_modular(width, height, seed)` writes a single-frame XYB
Modular codestream (default RestorationFilter: gaborish on, EPF 2 steps)
whose three channels hold seeded random samples, and returns the exact
integer planes it encoded. The global MA tree splits on property 0 (the
channel index) into one Zero-predictor leaf per channel, each with its own
offset and multiplier, so the colours stay in gamut; the residuals use a
4-symbol alphabet (2 bits a sample), so every 8x8 block and every group
border carries content that EPF changes. Bits are packed with numpy, so a
3840x2160 frame writes in seconds.

Two more modes. `predictors=` writes lossless lane streams: one leaf a
channel with a static Zero, West, North or Gradient predictor (offset 0,
multiplier 1: modular/tree.py:is_channel_static), each group's channel
tile its own prediction, and the planes from a scalar oracle
(`predict_scalar`); `big=(channel, k)` gives that channel residuals of
2^k under a hybrid-uint configuration with extra bits (over the gradient
lane's overflow gate at k = 21). `subsampling=` ("444", "420", "422",
"440") writes a YCbCr frame, xyb_encoded off, with the jpeg_upsampling of
a JPEG recompression (encode_ycbcr_vardct's header bits), its channels
(Cb, Y, Cr) each at its own size.

This module imports neither jax nor jxl_tpu at the top: chip_smoke.py
imports the writer. The tests below import the JAX package inside each
test.
"""

from __future__ import annotations

import numpy as np
import pytest

from mini_encoder import BW, token_bits, u32, u64, write_prefix_histograms

GROUP_DIM = 256
# per channel, in modular order [Y, X, B]: (offset, multiplier log2). With
# the default LF quant factors Y = iy/512, X = ix/4096, B = (ib + iy)/256,
# so these give Y ~ 0.5 +- 0.06, X ~ 0 +- 0.004, B ~ 0.5 +- 0.07: in gamut.
XYB_LEAVES = ((256, 4), (0, 3), (-128, 2))
# the alpha channel's leaf: 0, 64, 128 or 192
ALPHA_LEAF = (128, 6)
# YCbCr, modular order [Cb, Y, Cr] (zero-centred; Y gets 128/255 in the
# colour transform): Y 0 +- 32/255, Cb and Cr 0 +- 16/255
YCBCR_LEAVES = ((0, 3), (0, 4), (0, 3))
_RESIDUAL_TOKENS = (0, 1, 2, 3)  # unsigned tokens of residuals 0, -1, 1, -2
# the static predictors of the lane streams (modular/predict.py numbering)
ZERO, WEST, NORTH, GRADIENT = 0, 1, 2, 5
# jpeg_upsampling of each subsampling of channels (Cb, Y, Cr), and the
# shifts the decoder derives (test_torch_vardct_streams.py's tables)
JPEG_UPSAMPLING = {"444": (0, 0, 0), "420": (0, 1, 0), "422": (0, 2, 0), "440": (0, 3, 0)}
_H_SHIFT = (0, 1, 1, 0)
_V_SHIFT = (0, 1, 0, 1)


def _signed_token(v: int) -> int:
    return 2 * v if v >= 0 else -2 * v - 1


def _residual(tok):
    tok = np.asarray(tok, dtype=np.int32)
    return np.where(tok & 1, -((tok + 1) >> 1), tok >> 1)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _varint16(w: BW, v: int):
    if v == 0:
        w.write(0, 1)
        return
    w.write(1, 1)
    nbits = v.bit_length() - 1
    w.write(nbits, 4)
    w.write(v - (1 << nbits), nbits)


def write_per_context_histograms(w: BW, token_sets: list, configs=None):
    """Histograms bundle with one prefix-coded cluster per context, each
    over its own 1-4 tokens (simple context map, Brotli simple tables).
    configs: per cluster None (split_exponent 15: token == value) or a
    hybrid-uint (split_exponent, msb_in_token, lsb_in_token)."""
    n = len(token_sets)
    w.write(0, 1)  # lz77_enabled = 0
    if n > 1:
        bits = max(1, _ceil_log2(n))
        w.write(1, 1)  # context map: simple
        w.write(bits, 2)
        for c in range(n):
            w.write(c, bits)
    w.write(1, 1)  # use_prefix_code
    for cfg in configs or [None] * n:
        if cfg is None:
            w.write(15, 4)  # hybrid-uint split_exponent 15: token == value
            continue
        split, msb, lsb = cfg
        w.write(split, 4)
        w.write(msb, _ceil_log2(split + 1))
        w.write(lsb, _ceil_log2(split - msb + 1))
    sizes = [max(t) + 1 for t in token_sets]
    for s in sizes:
        _varint16(w, s - 1)
    for toks, s in zip(token_sets, sizes):
        if s == 1:
            continue
        toks = sorted(toks)
        w.write(1, 2)  # simple
        w.write(len(toks) - 1, 2)
        for t in toks:
            w.write(t, _ceil_log2(s))
        if len(toks) == 4:
            w.write(0, 1)  # tree_select = 0


def write_channel_split_tree(w: BW, leaves, predictors=None, leaf_tokens=None):
    """MA tree: a chain of splits on property 0 (the channel index), one
    leaf per channel with its (offset, mul_log) and predictor (Zero unless
    `predictors` gives one a channel). leaf_tokens: None (the leaves share
    one cluster over _RESIDUAL_TOKENS), or per channel (token set, hybrid-
    uint config or None), one cluster a leaf. Returns the leaves' context
    ids in channel order."""
    # node k asks "c > k ?"; its left child (property > splitval) is node
    # k + 1, or the last channel's leaf, and its right child channel k's
    # leaf. The decoder reads nodes breadth first.
    n = len(leaves)
    order, queue = [], [("split", 0)]
    while queue:
        kind, k = queue.pop(0)
        order.append((kind, k))
        if kind == "split":
            queue += [("split", k + 1) if k + 1 < n - 1 else ("leaf", n - 1), ("leaf", k)]
    # contexts: splitval, property, predictor, offset, mul_log, mul_bits
    preds = list(predictors or (ZERO,) * n)
    splits = [_signed_token(k) for k in range(n - 1)]
    offsets = [_signed_token(o) for o, _ in leaves]
    token_sets = [set(splits), {0, 1}, set(preds), set(offsets), {lg for _, lg in leaves}, {0}]
    write_per_context_histograms(w, token_sets)

    def put(ctx, value):
        bits, nb = token_bits(token_sets[ctx], value)
        w.write(bits, nb)

    for kind, k in order:
        if kind == "split":
            put(1, 1)
            put(0, splits[k])
        else:
            put(1, 0)
            put(2, preds[k])
            put(3, offsets[k])
            put(4, leaves[k][1])
            put(5, 0)
    # a leaf's context is its place among the leaves in the order read
    ctx = [k for kind, k in order if kind == "leaf"]
    leaf_ctx = [ctx.index(c) for c in range(n)]
    if leaf_tokens is None:
        # the leaves' contexts share one cluster over the residual tokens
        write_prefix_histograms(w, n, set(_RESIDUAL_TOKENS))
    else:
        by_ctx = sorted(range(n), key=lambda c: leaf_ctx[c])
        write_per_context_histograms(w, [leaf_tokens[c][0] for c in by_ctx],
                                     [leaf_tokens[c][1] for c in by_ctx])
    return leaf_ctx


def _group_section(tokens) -> bytes:
    """GroupHeader(use_global_tree, default WP, no transforms) + every
    sample's 2-bit residual code, channel after channel, LSB first."""
    code = np.zeros(4, dtype=np.uint8)
    for t in _RESIDUAL_TOKENS:
        code[t] = token_bits(set(_RESIDUAL_TOKENS), t)[0]
    # the 4 header bits 1,1,0,0 read as two 2-bit codes: 3, 0
    codes = np.concatenate([np.array([3, 0], np.uint8), code[tokens.reshape(-1)]])
    codes = np.concatenate([codes, np.zeros(-len(codes) % 4, np.uint8)]).reshape(-1, 4)
    packed = codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4) | (codes[:, 3] << 6)
    return packed.astype(np.uint8).tobytes()


def _group_section_extra(tokens, extra) -> bytes:
    """_group_section with `extra[i]` zero bits after sample i's code (the
    extra bits of a big residual, whose value is a power of two)."""
    code = np.array([token_bits(set(_RESIDUAL_TOKENS), t)[0] for t in _RESIDUAL_TOKENS])
    vals = np.stack([code[tokens.reshape(-1)], np.zeros(tokens.size, np.int64)], 1).reshape(-1)
    nbits = np.stack([np.full(tokens.size, 2), extra.reshape(-1)], 1).reshape(-1)
    vals = np.concatenate([[3, 0], vals])
    nbits = np.concatenate([[2, 2], nbits])
    width = int(nbits.max())
    bits = (vals[:, None] >> np.arange(width)) & 1
    bits = bits[np.arange(width)[None, :] < nbits[:, None]].astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def chroma_shifts(subsampling):
    """(hshift, vshift) of channels (Cb, Y, Cr) as the decoder derives them
    from jpeg_upsampling; all zero without subsampling."""
    ju = JPEG_UPSAMPLING[subsampling] if subsampling else (0, 0, 0)
    mh = max(_H_SHIFT[u] for u in ju)
    mv = max(_V_SHIFT[u] for u in ju)
    return (tuple(mh - _H_SHIFT[u] for u in ju), tuple(mv - _V_SHIFT[u] for u in ju))


def predict_scalar(res, pred: int) -> np.ndarray:
    """The int32 samples of one stream's channel from its residuals under a
    static predictor, one sample at a time in Python: the left of x = 0 is
    the sample above, the top of y = 0 the sample to the left, the
    top-left of either the left (modular/decode.py), the Gradient's clamp
    as libjxl's ClampedGradient; sums wrap as int32."""
    h, w = res.shape
    rows = np.asarray(res, np.int64).tolist()
    out, up = [], None
    for y in range(h):
        rr, row = rows[y], [0] * w
        for x in range(w):
            left = row[x - 1] if x else (up[0] if y else 0)
            if pred == ZERO:
                p = 0
            elif pred == WEST:
                p = left
            else:
                top = up[x] if y else left
                if pred == NORTH:
                    p = top
                else:
                    tl = up[x - 1] if x and y else left
                    mn, mx = min(left, top), max(left, top)
                    p = mx if tl < mn else (mn if tl > mx else left + top - tl)
            row[x] = (p + rr[x] + (1 << 31)) % (1 << 32) - (1 << 31)
        out.append(row)
        up = row
    return np.array(out, dtype=np.int32).reshape(h, w)


def _extra_channel_info(w: BW, associated: bool):
    """ExtraChannelInfo of an 8-bit alpha channel (dim_shift 0, no name)."""
    if not associated:
        w.write(1, 1)  # all_default: alpha, 8-bit, not associated
        return
    w.write(0, 1)  # all_default = 0
    w.write(0, 2)  # type: alpha
    w.write(0, 1)  # integer samples
    w.write(0, 2)  # bits_per_sample Val(8)
    w.write(0, 2)  # dim_shift 0
    w.write(0, 2)  # no name
    w.write(1, 1)  # alpha_associated


def _headers(width: int, height: int, sections: list, upsampling: int = 1,
             ec_upsampling: tuple = (), alpha_associated: bool = False,
             subsampling=None, filters: bool = True) -> bytes:
    """Codestream headers (8-bit, XYB, sRGB colour encoding, one 8-bit
    alpha channel a value of ec_upsampling) and the frame header of one
    REGULAR Modular frame with the default RestorationFilter, coded at
    width x height and upsampled `upsampling` times, then the TOC. With
    `subsampling` the image is not XYB and the frame is YCbCr with that
    subsampling's jpeg_upsampling. filters=False turns gaborish and EPF
    off, as a lossless encoder does."""
    ups = (("val", 1), ("val", 2), ("val", 4), ("val", 8))
    w = BW()
    w.write(0xFF, 8)
    w.write(0x0A, 8)
    w.write(0, 1)  # SizeHeader: not small
    u32(w, (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30)), height * upsampling - 1)
    w.write(0, 3)  # ratio
    u32(w, (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30)), width * upsampling - 1)
    w.write(0, 1)  # ImageMetadata all_default = 0
    w.write(0, 1)  # extra_fields = 0
    w.write(0, 1)  # bit_depth: integer samples
    w.write(0, 2)  # bits_per_sample Val(8)
    w.write(1, 1)  # modular_16bit_sufficient
    w.write(len(ec_upsampling), 2)  # extra channels: Val(0) or Val(1)
    for _ in ec_upsampling:
        _extra_channel_info(w, alpha_associated)
    w.write(0 if subsampling else 1, 1)  # xyb_encoded
    w.write(1, 1)  # color_encoding all_default (sRGB)
    w.write(0, 2)  # extensions
    w.write(1, 1)  # CustomTransformData all_default
    w.pad_to_byte()
    w.write(0, 1)  # FrameHeader all_default = 0
    w.write(0, 2)  # REGULAR
    w.write(1, 1)  # MODULAR
    u64(w, 0)  # flags
    if subsampling:  # not xyb_encoded: do_ycbcr, then jpeg_upsampling
        w.write(1, 1)
        for u in JPEG_UPSAMPLING[subsampling]:
            w.write(u, 2)
    u32(w, ups, upsampling)
    for e in ec_upsampling:
        u32(w, ups, e)
    w.write(1, 2)  # group_size_shift = 1 -> 256
    u32(w, (("val", 1), ("val", 2), ("val", 3), ("bitsoff", 3, 4)), 1)  # passes
    w.write(0, 1)  # have_crop = 0
    for _ in range(1 + len(ec_upsampling)):  # colour, then each extra channel
        u32(w, (("val", 0), ("val", 1), ("val", 2), ("bitsoff", 2, 3)), 0)  # REPLACE
    w.write(1, 1)  # is_last
    u32(w, (("val", 0), ("bits", 4), ("bitsoff", 5, 16), ("bitsoff", 10, 48)), 0)  # name
    if filters:
        w.write(1, 1)  # RestorationFilter all_default (gaborish on, EPF 2 steps)
    else:
        w.write(0, 1)  # RestorationFilter: not all_default
        w.write(0, 1)  # gaborish off
        w.write(0, 2)  # epf_iters 0
        w.write(0, 2)  # extensions
    w.write(0, 2)  # extensions
    w.write(0, 1)  # TOC not permuted
    w.pad_to_byte()
    for s in sections:
        u32(
            w,
            (("bits", 10), ("bitsoff", 14, 1024), ("bitsoff", 22, 17408),
             ("bitsoff", 30, 4211712)),
            len(s),
        )
    w.pad_to_byte()
    return w.finish()


def encode_xyb_modular(width: int, height: int, seed: int = 0, leaves=None,
                       upsampling: int = 1, num_ec: int = 0, ec_upsampling: int | None = None,
                       alpha_associated: bool = False, predictors=None, big=None,
                       subsampling=None, oracle: bool = True, filters: bool = True):
    """(codestream, planes): an XYB Modular frame coded at width x height
    and upsampled `upsampling` (1, 2, 4 or 8) times, so the image is
    upsampling * width x upsampling * height. A frame of one group (at
    most 256 x 256, without extra channels) codes its channels in its one
    section, right after the global modular header. planes
    are the int32 (3, height, width) planes it encodes in modular channel
    order [Y, X, B]. With num_ec=1 the image also has an 8-bit alpha
    channel (associated with alpha_associated), coded at 1/ec_upsampling
    (default: 1/upsampling) of the image's size; planes is then the list of
    the four channel planes.

    predictors: None (Zero leaves with the offsets and multipliers of
    `leaves`: XYB_LEAVES, or YCBCR_LEAVES when subsampled), or one of ZERO,
    WEST, NORTH, GRADIENT a channel (alpha last), each leaf with offset 0
    and multiplier 1; planes then come from predict_scalar over each
    group's tile of each channel, or are None with oracle=False (a 4K
    frame's Python loop takes minutes). big=(channel, k): that channel's
    fourth residual is 2^k instead of -2 (predictors only). subsampling:
    "444", "420", "422" or "440" writes a YCbCr frame, channels (Cb, Y,
    Cr) at their subsampled sizes; planes is then a list. filters=False
    writes gaborish off and no EPF, as a lossless encoder does."""
    single = width <= GROUP_DIM and height <= GROUP_DIM
    if single and num_ec:
        raise ValueError("the writer codes extra channels in frames of more than one group")
    if num_ec not in (0, 1):
        raise ValueError("the writer writes at most one extra channel")
    if subsampling is not None and subsampling not in JPEG_UPSAMPLING:
        raise ValueError(f"unknown subsampling {subsampling!r}")
    if subsampling is not None and upsampling != 1:
        raise ValueError("the writer upsamples XYB frames only")
    n_chan = 3 + num_ec
    if predictors is not None:
        predictors = tuple(predictors)
        if len(predictors) != n_chan or set(predictors) - {ZERO, WEST, NORTH, GRADIENT}:
            raise ValueError(f"predictors: one of 0, 1, 2, 5 for each of {n_chan} channels")
        leaves = ((0, 0),) * 3
    elif big is not None:
        raise ValueError("big residuals need predictors")
    if leaves is None:
        leaves = XYB_LEAVES if subsampling is None else YCBCR_LEAVES
    ec_up = (ec_upsampling or upsampling,) * num_ec
    rng = np.random.default_rng(seed)
    hs, vs = chroma_shifts(subsampling)
    if subsampling is None:
        tokens = list(rng.integers(0, 4, size=(3, height, width), dtype=np.uint8))
    else:
        tokens = [rng.integers(0, 4, size=(-(-height >> vs[c]), -(-width >> hs[c])),
                               dtype=np.uint8) for c in range(3)]
    # each channel's tokens and the sides of its tile in a group
    channels = [(tokens[c], GROUP_DIM >> hs[c], GROUP_DIM >> vs[c]) for c in range(3)]
    if num_ec:
        leaves = tuple(leaves) + ((0, 0) if predictors else ALPHA_LEAF,)
        ew, eh = -(-width * upsampling // ec_up[0]), -(-height * upsampling // ec_up[0])
        shift = ec_up[0].bit_length() - upsampling.bit_length()
        ec_tokens = rng.integers(0, 4, size=(eh, ew), dtype=np.uint8)
        channels.append((ec_tokens, GROUP_DIM >> shift, GROUP_DIM >> shift))

    # residuals and planes; a big channel's extra bits per sample
    extra = [np.zeros(t.shape, np.int64) for t, _, _ in channels]
    leaf_tokens = None
    if big is not None:
        bc, k = big
        big_token = 13 + k  # hybrid uint (4, 0, 0): 2^(k+1) is token 16 + (k + 1 - 4)
        leaf_tokens = [({0, 1, 2, 3}, None)] * n_chan
        leaf_tokens[bc] = ({0, 1, 2, big_token}, (4, 0, 0))
        extra[bc] = np.where(channels[bc][0] == 3, k + 1, 0)
    planes = []
    for c, (tok, tw, th) in enumerate(channels):
        res = _residual(tok).astype(np.int64)
        if big is not None and c == big[0]:
            res = np.where(tok == 3, 1 << big[1], res)
        if predictors is None:
            off, lg = leaves[c]
            planes.append((off + (res << lg)).astype(np.int32))
        elif oracle:
            h, w = res.shape
            tile = (w, h) if single else (tw, th)
            p = np.empty((h, w), np.int32)
            for y0 in range(0, h, tile[1]):
                for x0 in range(0, w, tile[0]):
                    cell = np.s_[y0 : y0 + tile[1], x0 : x0 + tile[0]]
                    p[cell] = predict_scalar(res[cell], predictors[c])
            planes.append(p)
    if predictors is not None and not oracle:
        planes = None
    elif subsampling is None and not num_ec:
        planes = np.stack(planes)

    lg = BW()
    lg.write(1, 1)  # LfQuantFactors all_default
    lg.write(1, 1)  # global tree present
    write_channel_split_tree(lg, leaves, predictors, leaf_tokens)
    lg.write(1, 1)  # GlobalModular GroupHeader: use_global_tree
    lg.write(1, 1)  # wp_header all_default
    lg.write(0, 2)  # no transforms
    if single:  # the channels, in the global section
        code = [token_bits(set(_RESIDUAL_TOKENS), t)[0] for t in range(4)]
        for (tok, _, _), ext in zip(channels, extra):
            for t, e in zip(tok.reshape(-1).tolist(), ext.reshape(-1).tolist()):
                lg.write(code[t], 2)
                lg.write(0, e)
        sections = [lg.finish()]
        head = _headers(width, height, sections, upsampling, ec_up, False, subsampling, filters)
        return head + sections[0], planes
    # no channel may fit in the global section of a multi-group frame (a
    # tree leaf is picked by the channel's index within its stream)
    if max(channels[0][0].shape) <= GROUP_DIM:
        raise ValueError("the first channel of a multi-group frame must be larger than a group")
    gx, gy = -(-width // GROUP_DIM), -(-height // GROUP_DIM)
    lf_groups = -(-width // (8 * GROUP_DIM)) * -(-height // (8 * GROUP_DIM))
    groups = []
    for j in range(gy):
        for i in range(gx):
            cells = [np.s_[j * th : (j + 1) * th, i * tw : (i + 1) * tw]
                     for _, tw, th in channels]
            toks = np.concatenate([t[cell].reshape(-1) for (t, _, _), cell in zip(channels, cells)])
            if big is None:
                groups.append(_group_section(toks))
            else:
                groups.append(_group_section_extra(toks, np.concatenate(
                    [e[cell].reshape(-1) for e, cell in zip(extra, cells)])))
    sections = [lg.finish()] + [b""] * lf_groups + [b""] + groups
    head = _headers(width, height, sections, upsampling, ec_up, alpha_associated, subsampling,
                    filters)
    return head + b"".join(sections), planes


def encode_ycbcr_modular(width: int, height: int, seed: int = 0, subsampling: str = "420",
                         **kw):
    """(codestream, [Cb, Y, Cr] planes): a YCbCr Modular frame with the
    given chroma subsampling (encode_xyb_modular with `subsampling`)."""
    return encode_xyb_modular(width, height, seed, subsampling=subsampling, **kw)


# -- both decoders read the streams back ------------------------------------


@pytest.mark.parametrize("size", [(600, 700), (1024, 1024), (517, 300)])
def test_jxl_tpu_decodes_writer_planes(size):
    from jxl_tpu.api.simple import decode_first_frame

    data, planes = encode_xyb_modular(*size, seed=3)
    dec = decode_first_frame(data)
    assert dec.frame.file_header.image_metadata.xyb_encoded
    rf = dec.frame.header.restoration_filter
    assert rf.gab and rf.epf_iters == 2
    for c in range(3):
        np.testing.assert_array_equal(np.asarray(dec.channels[c]), planes[c])


@pytest.mark.parametrize("size", [(600, 700), (300, 517)])
def test_port_host_layer_decodes_writer_planes(size):
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    data, planes = encode_xyb_modular(*size, seed=4)
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    frame.decode_all_sections(br, "cpu")
    for c in range(3):
        np.testing.assert_array_equal(frame.modular_channel(c), planes[c])


def test_writer_content_varies_in_every_block():
    _, planes = encode_xyb_modular(300, 260, seed=5)
    blocks = planes[:, :256, :296].reshape(3, 32, 8, 37, 8)
    assert (blocks.max(axis=(2, 4)) > blocks.min(axis=(2, 4))).all()


# sha256 of the writer's bytes before it had options: the defaults still
# write them
_DEFAULT_BYTES = {
    (600, 700, 3): "8d1e728e1e334bfe92632c062aa05cf53d3fdc32c01b3ecf0d093978c1baa89e",
    (517, 300, 4): "2094dbb125d7733ef9c4c50e89e6d87b432989855871296f6946aef815b570b4",
}


@pytest.mark.parametrize("args", list(_DEFAULT_BYTES))
def test_defaults_write_the_earlier_bytes(args):
    import hashlib

    w, h, seed = args
    data, _ = encode_xyb_modular(w, h, seed=seed)
    assert hashlib.sha256(data).hexdigest() == _DEFAULT_BYTES[args]


@pytest.mark.parametrize("kw", [
    dict(upsampling=2), dict(upsampling=4), dict(upsampling=8), dict(num_ec=1),
    dict(num_ec=1, upsampling=2), dict(num_ec=1, ec_upsampling=2),
    dict(num_ec=1, upsampling=2, ec_upsampling=4), dict(num_ec=1, alpha_associated=True),
])
def test_jxl_tpu_decodes_writer_options(kw):
    from jxl_tpu.api.simple import decode_first_frame

    data, planes = encode_xyb_modular(300, 264, seed=6, **kw)
    dec = decode_first_frame(data)
    up = kw.get("upsampling", 1)
    header = dec.frame.header
    assert header.upsampling == up
    fh = dec.frame.file_header
    assert (fh.xsize, fh.ysize) == (300 * up, 264 * up)
    infos = fh.image_metadata.extra_channel_info
    assert len(infos) == len(planes) - 3 == kw.get("num_ec", 0)
    if infos:
        assert header.ec_upsampling == [kw.get("ec_upsampling", up)]
        assert infos[0].alpha_associated == kw.get("alpha_associated", False)
        assert infos[0].bit_depth.bits_per_sample == 8
        assert planes[3].min() >= 0 and planes[3].max() <= 255
    for c in range(len(planes)):
        np.testing.assert_array_equal(np.asarray(dec.channels[c]), planes[c])
