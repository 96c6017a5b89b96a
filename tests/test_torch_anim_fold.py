"""The whole-animation fold (render/anim_fold.py, its native binding
native/__init__.py:anim_decode_frames_native and modular_decode.cc's
jxl_anim_decode_frames) against the per-frame section decode.

The streams are animations of single-section 192x128 frames
(test_torch_frame_streams.py:anim_replace_stream), without and with an
alpha channel (coded in each frame's global Modular stream). Each frame's
fold outputs (LF planes, HF metadata, CfL tiles, block table,
coefficients, quantizer and colour correlation) must equal the same frame
decoded through the port's per-frame section path, bit for bit; a forced
disagreement on frame 0 (its oracle) raises; the C++ bit-span caches
change nothing (span_cache=False decodes every frame in full); the
HfGlobal cache keys on the block-context count as well as the bits (a
hand-built pair of spans through the binding: no writer stream holds two
frames with equal HfGlobal bits and unequal counts); _pack_group_header
packs a header as
jxl_tpu's does. On the stream whose alpha is coded after two squeezes,
the fold runs every frame's inverse squeezes in one native call
(anim_fold.squeeze_arena, native.squeeze_chain_raw): the frames' alpha
equals the per-frame squeezes and jxl_tpu's fold bit for bit, with the
records tiled from frame 0 or laid out frame by frame.
"""

import numpy as np
import pytest

from jxl_tpu_torch import native
from jxl_tpu_torch.errors import NativeDecodeError
from jxl_tpu_torch.render import anim_fold
from jxl_tpu_torch.utils import trace
from test_torch_frame_streams import anim_replace_stream

FOLD_STREAMS = {
    "single_192x128": lambda: anim_replace_stream(192, 128, 4, seed=3),
    "alpha_192x128": lambda: anim_replace_stream(192, 128, 4, seed=5, num_ec=1),
    "squeezed_alpha_192x128": lambda: anim_replace_stream(192, 128, 4, seed=7, num_ec=1,
                                                          squeeze=True),
}


def _scan(data):
    from jxl_tpu_torch.api.simple import scan_frames
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    return fh, scan_frames(data, br.pos, fh)


@pytest.fixture(scope="module")
def folded():
    """{stream: (data, fh, recs, fold shims, per-frame frames)}."""
    out = {}
    for name, make in FOLD_STREAMS.items():
        data = make()
        fh, recs = _scan(data)
        shims = anim_fold.try_anim_fold(fh, data, recs, None, "cpu")
        frames = [anim_fold._decode_one_frame_deferred(fh, data, rec, None, "cpu")
                  for rec in recs]
        out[name] = (data, fh, recs, shims, frames)
    return out


def _lf(shim, frame):
    return all(np.array_equal(a, b) for a, b in zip(shim.lf_image, frame.lf_image))


def _hf_meta(shim, frame):
    return all(np.array_equal(shim.hf_meta[k], frame.hf_meta[k])
               for k in ("transform", "raw_quant", "quant_lf", "epf"))


def _cfl(shim, frame):
    return all(np.array_equal(shim.hf_meta[k], frame.hf_meta[k]) for k in ("ytox", "ytob"))


def _blocks(shim, frame):
    from jxl_tpu_torch.vardct.group import _BlockList

    bl = _BlockList(frame, 0)
    gx0, gy0 = bl.origin
    want = np.stack([bl.bxs + gx0, bl.bys + gy0, bl.tids, bl.offs], 1)
    return np.array_equal(shim.blocks, want)


def _coefficients(shim, frame):
    return np.array_equal(shim.coeffs, np.asarray(frame.host_ac_flat))


def _quantizer(shim, frame):
    a, b = shim.lf_global, frame.lf_global
    return (a.quant_params == b.quant_params
            and a.color_correlation_params == b.color_correlation_params)


PARTS = {"lf": _lf, "hf_meta": _hf_meta, "cfl": _cfl, "blocks": _blocks,
         "coefficients": _coefficients, "quantizer": _quantizer}


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("name", list(FOLD_STREAMS))
def test_fold_equals_per_frame_sections(name, part, folded):
    _, _, recs, shims, frames = folded[name]
    assert shims is not None and len(shims) == len(recs) == 4
    for shim, frame in zip(shims, frames):
        assert PARTS[part](shim, frame)


def test_fold_extra_channel_equals_per_frame_sections(folded):
    *_, shims, frames = folded["alpha_192x128"]
    for shim, frame in zip(shims, frames):
        assert np.array_equal(shim.lf_global.modular_global.output_channel(3),
                              frame.lf_global.modular_global.output_channel(3))


def test_fold_matches_jxl_tpu_fold(folded):
    """jxl_tpu folds the alpha stream too (its fold parses a group header,
    which a frame without channels does not code): the same LF planes and
    coefficients, in the part of each channel's slot that the frame's
    blocks use (jxl_tpu's pool comes from a reused np.empty arena, and its
    fold zeroes only that part)."""
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader
    from jxl_tpu.io.headers.frame import FrameHeader, Toc
    from jxl_tpu.render.anim_fold import try_anim_fold as ref_fold

    data, *_, shims, _ = folded["alpha_192x128"]
    br = BitReader(data)
    fh = FileHeader.read(br)
    recs = []
    while True:
        br.jump_to_byte_boundary()
        header = FrameHeader.read(br, fh)
        toc = Toc.read(br, header.num_toc_entries)
        br.jump_to_byte_boundary()
        recs.append((header, toc, br.pos))
        br.skip_bits(toc.total_size * 8)
        if header.is_last:
            break
    ref = ref_fold(fh, data, recs, None)
    assert ref is not None
    for shim, r, (header, *_) in zip(shims, ref, recs):
        assert all(np.array_equal(a, b) for a, b in zip(shim.lf_image, r.lf_image))
        bw, bh = header.size_blocks()
        used = bw * bh * 64
        assert np.array_equal(shim.coeffs.reshape(3, -1)[:, :used],
                              r.hf_global.hf_coefficients[0].reshape(3, -1)[:, :used])


def test_fold_squeeze_chain_equals_per_frame_squeezes(folded):
    """Every frame's squeezes ran in the arena before the shims were made
    (two steps a frame, one native call): each shim's alpha is a view of
    the arena equal to the per-frame decode's and to jxl_tpu's fold."""
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader
    from jxl_tpu.render.anim_fold import try_anim_fold as ref_fold

    data, fh, recs, _, frames = folded["squeezed_alpha_192x128"]
    trace.enable()
    trace.reset()
    try:
        shims = anim_fold.try_anim_fold(fh, data, recs, None, "cpu")
        assert trace.metrics.get("anim_fold_squeeze_steps") == 2 * len(recs)
    finally:
        trace.enable(False)
    ref_fh = FileHeader.read(BitReader(data))
    ref = ref_fold(ref_fh, data, _ref_recs(data, ref_fh), None)
    assert ref is not None
    for shim, frame, r in zip(shims, frames, ref):
        mg = shim.lf_global.modular_global
        assert mg.transforms_applied and mg.storage is None and len(mg.transform_steps) == 2
        got = mg.output_channel(3)
        assert mg.storage is None  # no per-frame rerun
        np.testing.assert_array_equal(got, frame.lf_global.modular_global.output_channel(3))
        np.testing.assert_array_equal(got, r.lf_global.modular_global.output_channel(3))


def _ref_recs(data, fh):
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers.frame import FrameHeader, Toc

    br = BitReader(data)
    type(fh).read(br)
    recs = []
    while True:
        br.jump_to_byte_boundary()
        header = FrameHeader.read(br, fh)
        toc = Toc.read(br, header.num_toc_entries)
        br.jump_to_byte_boundary()
        recs.append((header, toc, br.pos))
        br.skip_bits(toc.total_size * 8)
        if header.is_last:
            return recs


def test_squeeze_arena_lays_out_records_frame_by_frame(folded):
    """Frames whose buffers sit at different arena offsets take the
    concatenated records: each frame's squeezes then equal
    inverse_apply_steps on copies of its channels."""
    from jxl_tpu_torch.modular.channel import ModularChannel
    from jxl_tpu_torch.modular.transforms import inverse_apply_steps

    *_, frames = folded["squeezed_alpha_192x128"]
    plans = [f.lf_global.modular_global for f in frames[:2]]
    rng = np.random.default_rng(11)
    sizes = [info.size[0] * info.size[1] for info in plans[0].buffer_infos]
    offsets = [np.concatenate([[0], np.cumsum(sizes)[:-1]]) + shift for shift in (0, 37)]
    chan = np.zeros((2, sum(sizes) + 37), np.int32)
    want = []
    for f, mg in enumerate(plans):
        storage = []
        for buf, info in enumerate(mg.buffer_infos):
            w, h = info.size
            vals = rng.integers(-300, 300, (h, w)).astype(np.int32)
            chan[f, offsets[f][buf] : offsets[f][buf] + w * h] = vals.reshape(-1)
            storage.append(ModularChannel(info.size, info.shift, info.bit_depth_bits,
                                          data=vals.copy()))
        inverse_apply_steps(mg.transform_steps, storage)
        want.append(storage)
    assert anim_fold.squeeze_arena(plans, offsets, chan)
    for f, mg in enumerate(plans):
        for buf, info in enumerate(mg.buffer_infos):
            if info.output_channel_idx is None:
                continue
            w, h = info.size
            got = chan[f, offsets[f][buf] : offsets[f][buf] + w * h].reshape(h, w)
            np.testing.assert_array_equal(got, want[f][buf].data)


def _perturb(part):
    def wrap(real):
        def call(*a, **kw):
            out = real(*a, **kw)
            if part == "lf":
                out["lf"][1, 0, 0, 0] += 1.0
            elif part == "blocks":
                out["blocks"][0, 0, 3] += 64
            elif part == "coefficients":
                out["pool"][0, 1, 5] += 1
            else:
                out[part][0].reshape(-1)[0] += 1
            return out
        return call
    return wrap


@pytest.mark.parametrize("part", ["lf", "rq", "tmap", "ytox", "blocks", "coefficients"])
def test_oracle_mismatch_raises(part, folded, monkeypatch):
    data, fh, recs, *_ = folded["single_192x128"]
    monkeypatch.setattr(native, "anim_decode_frames_native",
                        _perturb(part)(native.anim_decode_frames_native))
    trace.enable()
    trace.reset()
    try:
        with pytest.raises(NativeDecodeError, match="frame 0"):
            anim_fold.try_anim_fold(fh, data, recs, None, "cpu")
        assert trace.metrics.get("anim_fold_oracle_mismatch") == 1
    finally:
        trace.enable(False)


@pytest.mark.parametrize("name", list(FOLD_STREAMS))
def test_span_cache_off_decodes_the_same(name, folded, monkeypatch):
    data, fh, recs, *_ = folded[name]
    outs = []
    real = native.anim_decode_frames_native

    def keep(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]

    monkeypatch.setattr(native, "anim_decode_frames_native", keep)
    trace.enable()
    trace.reset()
    try:
        anim_fold.try_anim_fold(fh, data, recs, None, "cpu")
        hits = trace.metrics.get("anim_fold_span_hits")
        anim_fold.try_anim_fold(fh, data, recs, None, "cpu", span_cache=False)
        assert trace.metrics.get("anim_fold_span_hits") == hits  # none with the cache off
    finally:
        trace.enable(False)
    assert hits > 0
    on, off = outs
    assert on.keys() == off.keys()
    for k in on:
        assert np.array_equal(on[k], off[k]), k


SPAN = bytes(range(7, 7 + 40))


@pytest.mark.parametrize("cur, prev_key, cur_key, hit", [
    (SPAN, 15, 15, True),  # the same bits decoded under the same count
    (SPAN, 15, 7, False),  # the same bits under another block-context count
    (SPAN[:-1] + b"\x00", 15, 15, False),  # other bits
])
def test_hfglobal_span_hit_keys_on_block_context_count(cur, prev_key, cur_key, hit):
    assert native.fold_span_hit(SPAN, prev_key, cur, cur_key) is hit


def test_fold_declines_other_streams():
    data = anim_replace_stream(320, 200, 4, seed=8)
    fh, recs = _scan(data)
    trace.enable()
    trace.reset()
    try:
        assert anim_fold.try_anim_fold(fh, data, recs, None, "cpu") is None
        assert trace.metrics.get("anim_fold_fallback") == 1
    finally:
        trace.enable(False)


def _group_headers(mod):
    """GroupHeaders of `mod` (jxl_tpu's or the port's io.headers.modular):
    an RCT then a squeeze, a palette, and none."""
    return [
        mod.GroupHeader(True, mod.WeightedHeader(), [
            mod.Transform(mod.TransformId.RCT, begin_channel=2, rct_type=7),
            mod.Transform(mod.TransformId.SQUEEZE,
                          squeezes=[mod.SqueezeParams(True, False, 1, 2)])]),
        mod.GroupHeader(True, mod.WeightedHeader(), [
            mod.Transform(mod.TransformId.PALETTE, begin_channel=1, num_channels=2,
                          num_colors=12, num_deltas=3, predictor_id=5)]),
        mod.GroupHeader(False, mod.WeightedHeader(), []),
    ]


@pytest.mark.parametrize("case", range(3))
def test_pack_group_header_equals_jxl_tpu(case):
    from jxl_tpu.io.headers import modular as ref_mod
    from jxl_tpu.render.anim_fold import _pack_group_header as ref_pack

    from jxl_tpu_torch.io.headers import modular as mod

    got = anim_fold._pack_group_header(_group_headers(mod)[case])
    want = ref_pack(_group_headers(ref_mod)[case])
    assert got is not None and np.array_equal(got, want)
    if case == 0:  # the layout tests/test_anim_fold.py holds jxl_tpu's packer to
        assert got[0] == 1 and got[1] == 2 and got[3] == 16 and got[14] == 0
        assert list(got[15:22]) == [0, 2, 7, 0, 0, 0, 0]
        assert list(got[22:29]) == [2, 0, 0, 0, 0, 0, 1]
        assert list(got[29:33]) == [1, 0, 1, 2]
