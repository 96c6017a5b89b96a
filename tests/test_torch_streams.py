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
_RESIDUAL_TOKENS = (0, 1, 2, 3)  # unsigned tokens of residuals 0, -1, 1, -2


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


def write_per_context_histograms(w: BW, token_sets: list):
    """Histograms bundle with one prefix-coded cluster per context, each
    over its own 1-4 tokens (simple context map, Brotli simple tables)."""
    n = len(token_sets)
    w.write(0, 1)  # lz77_enabled = 0
    if n > 1:
        bits = max(1, _ceil_log2(n))
        w.write(1, 1)  # context map: simple
        w.write(bits, 2)
        for c in range(n):
            w.write(c, bits)
    w.write(1, 1)  # use_prefix_code
    for _ in range(n):
        w.write(15, 4)  # hybrid-uint split_exponent 15: token == value
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


def write_channel_split_tree(w: BW, leaves):
    """MA tree: a chain of splits on property 0 (the channel index), one
    Zero-predictor leaf per channel with its (offset, mul_log)."""
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
    splits = [_signed_token(k) for k in range(n - 1)]
    offsets = [_signed_token(o) for o, _ in leaves]
    token_sets = [set(splits), {0, 1}, {0}, set(offsets), {lg for _, lg in leaves}, {0}]
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
            put(2, 0)  # Zero predictor
            put(3, offsets[k])
            put(4, leaves[k][1])
            put(5, 0)
    # leaf histograms: the leaves' contexts share one cluster over the
    # residual tokens
    write_prefix_histograms(w, n, set(_RESIDUAL_TOKENS))


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
             ec_upsampling: tuple = (), alpha_associated: bool = False) -> bytes:
    """Codestream headers (8-bit, XYB, sRGB colour encoding, one 8-bit
    alpha channel a value of ec_upsampling) and the frame header of one
    REGULAR Modular frame with the default RestorationFilter, coded at
    width x height and upsampled `upsampling` times, then the TOC."""
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
    w.write(1, 1)  # xyb_encoded = 1
    w.write(1, 1)  # color_encoding all_default (sRGB)
    w.write(0, 2)  # extensions
    w.write(1, 1)  # CustomTransformData all_default
    w.pad_to_byte()
    w.write(0, 1)  # FrameHeader all_default = 0
    w.write(0, 2)  # REGULAR
    w.write(1, 1)  # MODULAR
    u64(w, 0)  # flags
    # xyb_encoded: no do_ycbcr bit
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
    w.write(1, 1)  # RestorationFilter all_default (gaborish on, EPF 2 steps)
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


def encode_xyb_modular(width: int, height: int, seed: int = 0, leaves=XYB_LEAVES,
                       upsampling: int = 1, num_ec: int = 0, ec_upsampling: int | None = None,
                       alpha_associated: bool = False):
    """(codestream, planes): an XYB Modular frame coded at width x height
    and upsampled `upsampling` (1, 2, 4 or 8) times, so the image is
    upsampling * width x upsampling * height. A frame of one group (at
    most 256 x 256, without extra channels) codes its channels in its one
    section, right after the global modular header. planes
    are the int32 (3, height, width) planes it encodes in modular channel
    order [Y, X, B]. With num_ec=1 the image also has an 8-bit alpha
    channel (associated with alpha_associated), coded at 1/ec_upsampling
    (default: 1/upsampling) of the image's size; planes is then the list of
    the four channel planes."""
    single = width <= GROUP_DIM and height <= GROUP_DIM
    if single and num_ec:
        raise ValueError("the writer codes extra channels in frames of more than one group")
    if num_ec not in (0, 1):
        raise ValueError("the writer writes at most one extra channel")
    ec_up = (ec_upsampling or upsampling,) * num_ec
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 4, size=(3, height, width), dtype=np.uint8)
    planes = np.stack([
        off + (_residual(tokens[c]) << lg) for c, (off, lg) in enumerate(leaves)
    ]).astype(np.int32)
    # each channel's tokens and the side of its tile in a group
    channels = [(tokens[c], GROUP_DIM) for c in range(3)]
    if num_ec:
        leaves = tuple(leaves) + (ALPHA_LEAF,)
        ew, eh = -(-width * upsampling // ec_up[0]), -(-height * upsampling // ec_up[0])
        shift = ec_up[0].bit_length() - upsampling.bit_length()
        ec_tokens = rng.integers(0, 4, size=(eh, ew), dtype=np.uint8)
        channels.append((ec_tokens, GROUP_DIM >> shift))
        off, lg = ALPHA_LEAF
        planes = list(planes) + [(off + (_residual(ec_tokens) << lg)).astype(np.int32)]

    lg = BW()
    lg.write(1, 1)  # LfQuantFactors all_default
    lg.write(1, 1)  # global tree present
    write_channel_split_tree(lg, leaves)
    lg.write(1, 1)  # GlobalModular GroupHeader: use_global_tree
    lg.write(1, 1)  # wp_header all_default
    lg.write(0, 2)  # no transforms
    if single:  # the channels, in the global section
        code = [token_bits(set(_RESIDUAL_TOKENS), t)[0] for t in range(4)]
        for t in tokens.reshape(-1).tolist():
            lg.write(code[t], 2)
        sections = [lg.finish()]
        return _headers(width, height, sections, upsampling, ec_up, False) + sections[0], planes
    # no channel fits in the global section of a multi-group frame
    gx, gy = -(-width // GROUP_DIM), -(-height // GROUP_DIM)
    lf_groups = -(-width // (8 * GROUP_DIM)) * -(-height // (8 * GROUP_DIM))
    groups = []
    for j in range(gy):
        for i in range(gx):
            groups.append(_group_section(np.concatenate([
                t[j * d : (j + 1) * d, i * d : (i + 1) * d].reshape(-1) for t, d in channels
            ])))
    sections = [lg.finish()] + [b""] * lf_groups + [b""] + groups
    head = _headers(width, height, sections, upsampling, ec_up, alpha_associated)
    return head + b"".join(sections), planes


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
