"""K6, the card route of a Modular frame's group streams
(modular/group_lanes.py, ops/modular_lanes.py, csrc/modular_lanes.cu).

On the CPU: the route is decided from the stream (one case a property
that sends a frame to the host), and the plain version's decode of the
lane table equals the host route's planes bit for bit, on the benchmark
writer's lossless streams (portbench/writers/rgb_lossless.py: edge groups,
each RCT, both trees) and on streams of this module's own encoder,
`encode_lane_stream`, whose trees the frozen writer cannot write: a chain
at least 12 levels deep over properties 1-15 and all 14 predictors with
offsets and multipliers, a tree too large for K6's shared memory, and a
WP header and an RCT permutation of its own. Its residuals are seeded
noise and the leaves of a channel share a cluster, so it writes any tree
without predicting a sample: the decoders' planes are whatever the tree
makes of the noise, and each decoder is held to the others.

On the card (`cuda` marker; this module imports no JAX, so it runs there
as it is: `python3 -m pytest --noconftest tests/test_torch_modular_lanes.py
-m cuda -q`): K6 against its plain version on the same streams, a cut
section raising NativeDecodeError on both routes, one launch a frame and
the `modular_card_streams` counter.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from mini_encoder import u32
from test_torch_lossless_streams import (
    GRADIENT,
    GROUP_DIM,
    RESIDUAL_UINT,
    WEIGHTED,
    Bits,
    Coding,
    _ceil_log2,
    _group_header,
    _headers,
    bfs,
    hybrid_encode,
    pack_bits,
    rans_encode_lanes,
    signed_pack,
    stream_pieces,
    write_distribution,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.writers.rgb_lossless import encode_rgb_lossless  # noqa: E402

import jxl_tpu_torch  # noqa: E402
from jxl_tpu_torch.api.simple import decode_first_frame, parse_frame  # noqa: E402
from jxl_tpu_torch.api.state import DecoderState  # noqa: E402
from jxl_tpu_torch.errors import NativeDecodeError  # noqa: E402
from jxl_tpu_torch.io.bit_reader import BitReader  # noqa: E402
from jxl_tpu_torch.io.headers import FileHeader  # noqa: E402
from jxl_tpu_torch.modular import group_lanes  # noqa: E402
from jxl_tpu_torch.ops import modular_lanes  # noqa: E402
from jxl_tpu_torch.utils import trace  # noqa: E402

# p1c, p2c, p3ca..p3ce, w0..w3: none of the default's
WP_OWN = (21, 4, 3, 9, 1, 2, 30, 15, 1, 7, 3)


# -- the module's encoder -----------------------------------------------------------------


def _split(prop, val, greater, other):
    return ("split", prop, int(val), greater, other)


def _leaf(predictor, channel, offset=0, mul_log=0, mul_bits=0):
    return ("leaf", predictor, channel, offset, mul_log, mul_bits)


# (property, value, whether the chain goes on where the property is
# greater): most samples go deep; property 1 (the stream id) splits the
# groups into two chains
DEEP_LEVELS = ((2, 0, True), (3, 1, True), (1, 22, None), (15, 30, False), (4, 1, True),
               (10, 6, False), (5, 1, True), (11, 6, False), (6, -50, True), (12, 6, False),
               (7, -50, True), (13, 6, False), (8, 6, False), (14, 6, False), (9, 60, False))


def _deep_chain(c: int, k: int = 0):
    if k == len(DEEP_LEVELS):
        return _leaf(WEIGHTED, c, 1)
    p, v, greater = DEEP_LEVELS[k]
    if p == 1:
        return _split(1, v, _deep_chain(c, k + 1), _deep_chain(c, k + 1))
    # a leaf a level: every predictor, offsets -2..2, multipliers 1-4
    out = _leaf((3 * k + c) % 14, c, k % 5 - 2, 1 if k % 4 == 0 else 0, 1 if k % 3 == 0 else 0)
    deeper = _deep_chain(c, k + 1)
    return _split(p, v, deeper, out) if greater else _split(p, v, out, deeper)


def _full_tree(c: int, depth: int, k: int = 0):
    """A full binary tree of `depth` (at most 14) splits, a property of
    2-15 a level."""
    if depth == 0:
        return _leaf((k + c) % 14, c, k % 3 - 1)
    return _split(16 - depth, 0, _full_tree(c, depth - 1, 2 * k + 1),
                  _full_tree(c, depth - 1, 2 * k + 2))


def build_tree(kind: str):
    """Split on the channel (property 0), then each channel's subtree:
    "deep" (DEEP_LEVELS), "wide" (a full tree of 2047 nodes a channel,
    past K6's shared-memory subtree), "refs" (channel 1 splits on
    property 16, a previous channel's) or "weighted" (one WP leaf)."""
    if kind == "deep":
        subs = [_deep_chain(c) for c in range(3)]
    elif kind == "wide":
        subs = [_full_tree(c, 10) for c in range(3)]
    elif kind == "refs":
        subs = [_leaf(GRADIENT, 0), _split(16, 0, _leaf(GRADIENT, 1), _leaf(WEIGHTED, 1)),
                _leaf(GRADIENT, 2)]
    elif kind == "weighted":
        subs = [_leaf(WEIGHTED, c) for c in range(3)]
    else:
        raise ValueError(kind)
    return _split(0, 1, subs[2], _split(0, 0, subs[1], subs[0]))


def tree_depth(node) -> int:
    return 0 if node[0] == "leaf" else 1 + max(tree_depth(node[3]), tree_depth(node[4]))


def write_full_tree(w, tree):
    """The MA tree with each leaf's offset and multiplier (mul_log,
    mul_bits), as test_torch_lossless_streams.write_tree writes the rest."""
    toks = []
    for node in bfs(tree):
        if node[0] == "split":
            toks += [node[1] + 1, int(signed_pack(node[2]))]
        else:
            toks += [0, node[1], int(signed_pack(node[3])), node[4], node[5]]
    tree_uint = (4, 0, 0)
    tk, raw, nraw = hybrid_encode(toks, tree_uint)
    coding = Coding([0] * 6, tree_uint, np.bincount(tk)[None])
    coding.write(w)
    state, words, has = rans_encode_lanes(coding, tk[None], np.zeros((1, len(tk)), np.int64),
                                          [len(tk)])
    w.extend(*stream_pieces(state, words, has, raw[None], nraw[None]))


def write_coding(w, coding, lz77: bool):
    """Coding.write, with LZ77 on (minimum symbol 224, which no residual
    token reaches, so nothing is copied) when asked."""
    if not lz77:
        coding.write(w)
        return
    w.write(1, 1)
    w.write(0, 2)  # min_symbol 224
    w.write(0, 2)  # min_length 3
    w.write(8, 4)  # the length's HybridUint: split_exponent 8
    cmap = coding.cmap + [0]  # the distance context
    w.write(1, 1)  # simple context map
    bits = _ceil_log2(max(cmap) + 1)
    w.write(bits, 2)
    for c in cmap:
        w.write(c, bits)
    w.write(0, 1)  # ANS
    w.write(coding.log_alpha - 5, 2)
    se, msb, lsb = coding.cfg
    for _ in coding.freq:
        w.write(se, _ceil_log2(coding.log_alpha + 1))
        w.write(msb, _ceil_log2(se + 1))
        w.write(lsb, _ceil_log2(se - msb + 1))
    for f in coding.freq:
        write_distribution(w, f)


def _wp_header(w, wp):
    if wp is None:
        w.write(1, 1)
        return
    w.write(0, 1)
    for v in wp[:7]:
        w.write(v, 5)
    for v in wp[7:]:
        w.write(v, 4)


def group_header(w, rct, wp=None, use_global_tree=True, transform=None):
    """A group's GroupHeader: the tree, the WP header (None: the default),
    then one transform: "rct" of type rct (0-41) over channels 0-2 unless
    rct is None, or "palette", "squeeze" or "rct_c1" (an RCT from
    channel 1)."""
    w.write(1 if use_global_tree else 0, 1)
    _wp_header(w, wp)
    if transform is None and rct is None:
        w.write(0, 2)
        return
    w.write(1, 2)  # one transform
    begin_c = (("bits", 3), ("bitsoff", 6, 8), ("bitsoff", 10, 72), ("bitsoff", 13, 1096))
    if transform == "palette":
        w.write(1, 2)
        u32(w, begin_c, 0)
        u32(w, (("val", 1), ("val", 3), ("val", 4), ("bitsoff", 13, 1)), 3)
        u32(w, (("bits", 8), ("bitsoff", 10, 256), ("bitsoff", 12, 1280),
                ("bitsoff", 16, 5376)), 10)
        u32(w, (("val", 0), ("bitsoff", 8, 1), ("bitsoff", 10, 257), ("bitsoff", 16, 1281)), 0)
        w.write(0, 4)
        return
    if transform == "squeeze":
        w.write(2, 2)
        u32(w, (("val", 0), ("bitsoff", 4, 1), ("bitsoff", 6, 9), ("bitsoff", 8, 41)), 0)
        return
    w.write(0, 2)  # RCT
    u32(w, begin_c, 1 if transform == "rct_c1" else 0)
    u32(w, (("val", 6), ("bits", 2), ("bitsoff", 4, 2), ("bitsoff", 6, 10)), rct or 0)


def encode_lane_stream(width: int, height: int, seed: int = 0, tree: str = "deep", rct=26,
                       wp=WP_OWN, lz77: bool = False, local_group=None, transform=None,
                       cut=None) -> bytes:
    """An 8-bit RGB Modular codestream (test_torch_lossless_streams's
    headers, 256x256 groups) of more than one group whose residuals are
    seeded noise, under build_tree(tree), every leaf of a channel in that
    channel's cluster. rct: each group's RCT type (0-41; None writes no
    transform), wp: each group's WP header (None: the default), lz77: the
    residual coding with LZ77 on (unused), local_group: a group whose
    header asks for a local tree (the same tree and coding, written in its
    section), transform: group 0's transform instead of the RCT
    (group_header), cut: (group, n) drops the last n bytes of that group's
    section."""
    rng = np.random.default_rng(seed)
    gx, gy = -(-width // GROUP_DIM), -(-height // GROUP_DIM)
    G, D = gx * gy, GROUP_DIM
    if G < 2:
        raise ValueError("encode_lane_stream writes frames of more than one group")
    rects = [(x * D, y * D, min(D, width - x * D), min(D, height - y * D))
             for y in range(gy) for x in range(gx)]
    gw, gh = np.array([r[2] for r in rects]), np.array([r[3] for r in rects])
    the_tree = build_tree(tree)
    leaves = [n for n in bfs(the_tree) if n[0] == "leaf"]
    cmap = [n[2] for n in leaves]
    # mostly small residuals, now and then a large one for the HybridUint tails
    res = rng.integers(-3, 4, (G, 3, D, D))
    big = rng.random((G, 3, D, D)) < 0.02
    res[big] = rng.integers(-5000, 5001, int(big.sum()))
    tk, raw, nraw = hybrid_encode(signed_pack(res), RESIDUAL_UINT)
    cl = np.broadcast_to(np.arange(3)[None, :, None, None], res.shape)
    lengths = 3 * gw * gh
    T = int(lengths.max())

    def lanes_of(a, dtype):
        out = np.zeros((G, T), dtype)
        for k in range(G):
            out[k, : lengths[k]] = a[k, :, : gh[k], : gw[k]].reshape(-1)
        return out

    tok, clu = lanes_of(tk, np.int32), lanes_of(cl, np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    counts = np.bincount((clu * 64 + tok)[valid], minlength=3 * 64).reshape(3, 64)
    coding = Coding(cmap, RESIDUAL_UINT, counts)
    state, words, has = rans_encode_lanes(coding, tok, clu, lengths)
    svals, snb = stream_pieces(state, words, has, lanes_of(raw, np.uint32),
                               lanes_of(nraw, np.int8))

    lg = Bits()
    lg.write(1, 1)  # LfChannelDequantization all_default
    lg.write(1, 1)  # a global tree
    write_full_tree(lg, the_tree)
    write_coding(lg, coding, lz77)
    _group_header(lg, 0)  # the global image: no channel fits in it
    groups = []
    for g in range(G):
        h = Bits()
        group_header(h, rct, wp, use_global_tree=g != local_group,
                     transform=transform if g == 0 else None)
        if g == local_group:
            write_full_tree(h, the_tree)
            write_coding(h, coding, lz77)
        hv, hn = h.arrays()
        groups.append(pack_bits(np.concatenate([hv, svals[g]]),
                                np.concatenate([hn, snb[g].astype(np.int64)]))[0])
    if cut is not None:
        g, n = cut
        groups[g] = groups[g][:-n]
    num_lf = -(-width // (8 * GROUP_DIM)) * -(-height // (8 * GROUP_DIM))
    sections = [lg.finish()] + [b""] * num_lf + [b""] + groups
    return _headers(width, height, sections) + b"".join(sections)


# -- helpers ----------------------------------------------------------------------------


def frame_and_sections(data: bytes):
    """The frame of `data` with LfGlobal and the LF groups decoded, and its
    section readers, as Frame.decode_all_sections has them before the
    group sections."""
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh, DecoderState(fh))
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(frame.header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    return frame, sections


def decode_table(table, shapes, device) -> list:
    planes = [torch.empty(s, dtype=torch.int32, device=device) for s in shapes.values()]
    modular_lanes.decode_lanes(table, planes)
    return planes


def host_planes(data: bytes) -> list:
    """The host route's int32 colour planes (decode_first_frame on the CPU:
    the native loop over the thread pool, each group's RCT)."""
    return [c.numpy() for c in decode_first_frame(data, device="cpu").channels[:3]]


# id: (writer, width, height, seed, options)
STREAMS = {
    "photo_600x520": ("bench", 600, 520, 3_000_000_101, {}),
    "photo_1024x1024": ("bench", 1024, 1024, 2**33 + 5, {}),
    "mixed_600x520": ("bench", 600, 520, 17, {"tree": "mixed"}),
    **{f"rct{op}": ("bench", 264, 72, 40 + op, {"rct": op}) for op in range(7)},
    "deep_tree": ("lanes", 600, 520, 23, {}),
    "wide_tree": ("lanes", 520, 300, 29, {"tree": "wide", "rct": 13, "wp": None}),
}


def stream(case: str) -> bytes:
    writer, w, h, seed, kw = STREAMS[case]
    if writer == "bench":
        return encode_rgb_lossless(w, h, seed, **kw)[0]
    return encode_lane_stream(w, h, seed, **kw)


# -- on the CPU: routing ---------------------------------------------------------------


def _prefix_stream():
    from test_torch_streams import encode_xyb_modular

    return encode_xyb_modular(520, 300, seed=3)[0]


# id: a frame that decodes on the host, and why
HOST_STREAMS = {
    "local_tree": lambda: encode_lane_stream(520, 300, 31, local_group=1),
    "lz77": lambda: encode_lane_stream(520, 300, 32, lz77=True),
    "prefix_codes": _prefix_stream,
    "reference_properties": lambda: encode_lane_stream(520, 300, 33, tree="refs"),
    "palette": lambda: encode_lane_stream(520, 300, 34, transform="palette"),
    "squeeze": lambda: encode_lane_stream(520, 300, 35, transform="squeeze"),
    "rct_from_channel_1": lambda: encode_lane_stream(520, 300, 36, transform="rct_c1"),
    "single_section": lambda: encode_rgb_lossless(256, 256, 37)[0],
}


@pytest.mark.parametrize("case", list(HOST_STREAMS))
def test_streams_the_route_leaves_to_the_host(case):
    """plan() refuses each stream with a property K6 does not take."""
    frame, sections = frame_and_sections(HOST_STREAMS[case]())
    assert group_lanes.plan(frame, sections) is None


@pytest.mark.parametrize("case", ["local_tree", "lz77", "reference_properties"])
def test_host_streams_of_the_encoder_decode_alike(case):
    """The encoder's valid host-routed streams decode on the host as the
    same stream without the property does through the plain lanes."""
    data = HOST_STREAMS[case]()
    seed = {"local_tree": 31, "lz77": 32, "reference_properties": 33}[case]
    tree = "refs" if case == "reference_properties" else "deep"
    if tree == "deep":
        twin = encode_lane_stream(520, 300, seed)
        frame, sections = frame_and_sections(twin)
        want = [p.numpy() for p in decode_table(*group_lanes.plan(frame, sections), "cpu")]
        assert all(np.array_equal(a, b) for a, b in zip(host_planes(data), want))
    else:
        assert all(p.shape == (300, 520) for p in host_planes(data))


def test_eligible_streams_take_the_route():
    """plan() takes the writer's stream and the encoder's: one lane a
    group, its channels, subtrees and WP numbers."""
    for data, groups in ((encode_rgb_lossless(600, 520, 41)[0], 9),
                         (encode_lane_stream(600, 520, 42, tree="weighted", rct=None), 9)):
        frame, sections = frame_and_sections(data)
        table, shapes = group_lanes.plan(frame, sections)
        assert len(table.lanes) == groups and len(table.chans) == 3 * groups
        assert list(shapes.values()) == [(520, 600)] * 3
        assert table.data.size == sum(len(sections[frame.section_index("hf", group=g)].data)
                                      for g in range(groups))


def test_a_cpu_decode_never_takes_the_route(monkeypatch):
    """decode_image on the CPU leaves the group streams to the host loop."""
    def refuse(*args):
        raise AssertionError("the CPU decode took the card route")

    monkeypatch.setattr(group_lanes, "decode_on_card", refuse)
    data, coded = encode_rgb_lossless(600, 520, 43)
    out = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]
    assert np.array_equal(out.numpy(), coded["pixels"])


def test_pruned_subtrees_walk_as_the_tree():
    """Each packed subtree leads every property vector to the leaf the
    whole tree does for its channel and stream id, with the leaf's
    predictor, offset, multiplier, cluster and HybridUint config."""
    from jxl_tpu_torch import native

    frame, _ = frame_and_sections(encode_lane_stream(600, 520, 44))
    tree = frame.lf_global.tree
    arr = native.pack_tree(tree)
    ent = native.pack_entropy(tree.histograms)
    rng = np.random.default_rng(45)
    for ch, sid in ((0, 21), (1, 22), (2, 25)):
        nodes, uses_wp, depth = group_lanes.pack_nodes(group_lanes.prune(arr, ch, sid), ent)
        assert uses_wp and depth == len(DEEP_LEVELS) - 1  # the stream-id split is resolved
        for props in rng.integers(-80, 80, (200, 16)).tolist():
            props[0], props[1] = ch, sid
            i = 0
            while arr[i, 0] >= 0:
                i = arr[i, 2] if props[arr[i, 0]] > arr[i, 1] else arr[i, 3]
            j = 0
            for _ in range(depth + 3):  # a walk past a leaf stays on it
                j = nodes[j, 2] if props[nodes[j, 0] & 15] > nodes[j, 1] else nodes[j, 3]
            pred, off, mul, ctx = arr[i, 4:8]
            c = int(ent["context_map"][ctx])
            se, msb, lsb = ent["uint_configs"][c]
            assert tuple(nodes[j]) == (-1, 0, j, j, pred, off, mul,
                                       c | se << 8 | msb << 16 | lsb << 24)


def test_alias_tables_pack_as_the_native_loop():
    """Each bucket's word holds the five fields at the native packing's
    bits."""
    from jxl_tpu_torch import native

    frame, _ = frame_and_sections(encode_rgb_lossless(600, 520, 46)[0])
    ent = native.pack_entropy(frame.lf_global.tree.histograms)
    t = ent["ans_tables"]
    words = group_lanes.pack_tables(ent).reshape(t.shape[0], t.shape[2])
    for field, (shift, mask) in zip((1, 2, 3, 0, 4),
                                    ((0, 0xFF), (8, 0x1FFF), (21, 0x1FFF), (34, 0x1FFF),
                                     (47, 0x1FFF))):
        assert np.array_equal((words >> np.uint64(shift)) & np.uint64(mask),
                              t[:, field].astype(np.uint64) & np.uint64(mask))


def test_deep_tree_is_deep():
    """The deep tree's channel subtrees run 15 splits deep under the
    channel split, over properties 1-15, with all 14 predictors."""
    root = build_tree("deep")
    sub = root[4][4]
    assert tree_depth(sub) >= 12
    nodes = bfs(root)
    assert {n[1] for n in nodes if n[0] == "split"} == set(range(16))
    assert {n[1] for n in nodes if n[0] == "leaf"} == set(range(14))
    assert {(n[4], n[5]) for n in nodes if n[0] == "leaf"} == {(0, 0), (0, 1), (1, 0), (1, 1)}


# -- on the CPU: the plain version against the host route ------------------------------------


@pytest.mark.parametrize("case", list(STREAMS))
def test_plain_lanes_equal_the_host_route(case):
    """The plain version's decode of the lane table gives the host route's
    planes bit for bit."""
    data = stream(case)
    frame, sections = frame_and_sections(data)
    table, shapes = group_lanes.plan(frame, sections)
    got = decode_table(table, shapes, "cpu")
    want = host_planes(data)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", list(STREAMS))
def test_host_route_equals_the_jax_package(case):
    """The host route's planes, which the plain version and K6 are held to,
    equal the JAX package's decode of the same stream bit for bit."""
    from jxl_tpu.api.simple import decode_first_frame as jax_decode_first_frame

    data = stream(case)
    want = [np.asarray(p) for p in jax_decode_first_frame(data).channels[:3]]
    got = host_planes(data)
    assert all(a.shape == b.shape and np.array_equal(a, b) for a, b in zip(got, want))


def test_routed_planes_render_as_the_host_planes():
    """Planes the route leaves in the global image, in place of the host
    planes, render as the host's: the render takes them as they are and
    frees them once converted, and a later read of them raises."""
    from jxl_tpu_torch.render.simple import render_frame_channels

    data = stream("deep_tree")
    frame, sections = frame_and_sections(data)
    assert group_lanes.decode_on_card(frame, sections, torch.device("cpu"))
    mg = frame.lf_global.modular_global
    assert len(mg.device_planes) == 3
    assert all(mg.storage[b] is None for b in mg.device_planes)
    got, _, _ = render_frame_channels(frame, torch.device("cpu"))
    assert not mg.device_planes
    for c in range(3):
        with pytest.raises(RuntimeError, match="handed over"):
            mg.output_channel(c)
    frame2, sections2 = frame_and_sections(data)
    frame2._decode_hf_groups_parallel(
        [(g, [(0, sections2[frame2.section_index("hf", group=g)])])
         for g in range(frame2.header.num_groups)])
    want, _, _ = render_frame_channels(frame2, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_cut_lane_raises_as_the_host_loop():
    """A lane whose section is cut short raises the host loop's
    NativeDecodeError and code, from the plain version and the host route."""
    data = encode_lane_stream(520, 300, 47, cut=(1, 200))
    with pytest.raises(NativeDecodeError) as host:
        host_planes(data)
    frame, sections = frame_and_sections(data)
    with pytest.raises(NativeDecodeError) as plain:
        decode_table(*group_lanes.plan(frame, sections), "cpu")
    assert str(plain.value) == str(host.value)


# -- on the card -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K6 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STREAMS))
def test_k6_equals_the_plain_version_on_card(case, cuda_device):
    frame, sections = frame_and_sections(stream(case))
    table, shapes = group_lanes.plan(frame, sections)
    before = modular_lanes.decode_lanes.launches
    got = decode_table(table, shapes, cuda_device)
    assert modular_lanes.decode_lanes.launches == before + 1
    want = decode_table(table, shapes, "cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_a_cut_section_raises_on_both_routes_on_card(cuda_device, monkeypatch):
    """decode_image raises the same NativeDecodeError on the card route as
    the host route does."""
    monkeypatch.setenv("JXL_TPU_DEVICE", "on")
    data = encode_lane_stream(520, 300, 47, cut=(1, 200))
    with pytest.raises(NativeDecodeError) as host:
        jxl_tpu_torch.decode_image(data, device="cpu")
    before = modular_lanes.decode_lanes.launches
    with pytest.raises(NativeDecodeError) as card:
        jxl_tpu_torch.decode_image(data, device=cuda_device)
    assert modular_lanes.decode_lanes.launches == before + 1
    assert str(card.value) == str(host.value)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["photo_600x520", "deep_tree"])
def test_one_launch_a_frame_and_its_counters_on_card(case, cuda_device, monkeypatch):
    """decode_image on the card launches K6 once, counts every group stream
    in modular_card_streams and none in modular_tree_samples, and gives
    the CPU decode's pixels."""
    monkeypatch.setenv("JXL_TPU_DEVICE", "on")
    data = stream(case)
    groups = len(group_lanes.plan(*frame_and_sections(data))[0].lanes)
    was = trace.enabled()
    trace.enable()
    trace.reset()
    try:
        before = modular_lanes.decode_lanes.launches
        got = jxl_tpu_torch.decode_image(data, pixel_format="f32", device=cuda_device).frames[0]
        launches = modular_lanes.decode_lanes.launches - before
        counts = dict(trace.metrics.counters)
    finally:
        trace.enable(was)
        trace.reset()
    want = jxl_tpu_torch.decode_image(data, pixel_format="f32", device="cpu").frames[0]
    assert launches == 1
    assert counts["modular_card_streams"] == groups
    assert counts.get("modular_tree_samples", 0) == 0
    assert torch.equal(got.cpu(), want)
