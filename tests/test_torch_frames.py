"""The port's multi-frame decode against jxl_tpu: blending, the patches
dictionary and stage, blend_and_extend on a decoder state carried across
(api/state.py:state_from_numpy), and decode_image of the multi-frame
writer streams (test_torch_frame_streams.py) and of the mini encoder's
patches stream.

Tolerances: blending and the patch stage within float32 rounding (1e-6);
decode_image f32 max abs 1e-4, u8 at most 1, u16 at most 1 plus 65535
times the f32 difference of the same frame (the two packages' XYB renders
already differ by up to 1e-5 in f32, and a MUL frame multiplies two such
values: 1.7e-5 and a u16 difference of 2 on the small VarDCT animation),
f16 at most one ulp of jxl_tpu's value, or the f32 limit where that is
larger (near zero an f16 ulp is finer than that same 1e-5); durations
exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.api.simple import decode_image as ref_decode
from mini_encoder import encode_patches_modular
from test_torch_frame_streams import (PATCH_ADD, PATCH_MUL, PATCH_REPLACE, TICKS,
                                      anim_replace_stream, anim_rgba_stream, anim_vardct_stream,
                                      lf_frame_stream, patches_dictionary, patches_stream,
                                      text_layout)

STREAMS = {
    "anim_vardct_preview": lambda: anim_vardct_stream(320, 200, (288, 96), num_frames=5, seed=3,
                                                      preview=True),
    "anim_rgba": lambda: anim_rgba_stream(320, 200, (288, 96), num_frames=5, seed=4),
    "patches_overlap": lambda: patches_stream(512, 384, (320, 64), 120, 30, seed=6,
                                              overlap=10),
    "anim_replace": lambda: anim_replace_stream(320, 200, 5, seed=8),
    "mini_patches_modular": lambda: encode_patches_modular(300, 300),
}
FRAMES = {"anim_vardct_preview": 5, "anim_rgba": 5, "patches_overlap": 1, "anim_replace": 5,
          "mini_patches_modular": 1}
XYB = {"anim_vardct_preview", "patches_overlap", "anim_replace"}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


def _diff(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))


def _check_format(got, want, fmt, xyb, f32_diff=0.0):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = _diff(got, want)
    if fmt == "f32":
        assert d.max() <= 1e-4
    elif fmt == "u16":
        assert d.max() <= 1.0 + 65535.0 * f32_diff
    elif fmt == "f16":
        ulp = np.spacing(np.abs(want.astype(np.float16))).astype(np.float64)
        assert (d <= (np.maximum(ulp, 1e-4) if xyb else ulp)).all()
    else:
        assert d.max() <= 1.0


# -- blending ------------------------------------------------------------------------------


def _eci(kind):
    """Extra channel infos: none, or an alpha (straight or associated)
    and a second, non-alpha channel."""
    if kind == "none":
        return []
    return [SimpleNamespace(ec_type=0, alpha_associated=kind == "associated"),
            SimpleNamespace(ec_type=1, alpha_associated=False)]


@pytest.mark.parametrize("kind", ["none", "straight", "associated"])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("mode", range(8))
def test_perform_blending_matches_jxl_tpu(mode, clamp, kind):
    from jxl_tpu.features import blending as ref_blending
    from jxl_tpu.features.patches import PatchBlending as RefBlending

    from jxl_tpu_torch.features import blending
    from jxl_tpu_torch.features.patches import PatchBlending

    eci = _eci(kind)
    rng = np.random.default_rng(100 * mode + 10 * clamp + len(kind))
    n = 3 + len(eci)
    # alphas outside [0, 1] too, so that every clamp acts
    bg = [rng.uniform(-0.2, 1.2, (17, 23)).astype(np.float32) for _ in range(n)]
    fg = [rng.uniform(-0.2, 1.2, (17, 23)).astype(np.float32) for _ in range(n)]
    if eci:
        bg[3][0, :4] = fg[3][1, :4] = 0.0  # both alphas zero: the 1 / new_alpha guard
        fg[3][0, :4] = 0.0
    want = ref_blending.perform_blending(bg, fg, RefBlending(mode, 0, clamp),
                                         [RefBlending(mode, 0, clamp)] * len(eci), eci)
    got = blending.perform_blending([torch.from_numpy(p) for p in bg],
                                    [torch.from_numpy(p) for p in fg],
                                    PatchBlending(mode, 0, clamp),
                                    [PatchBlending(mode, 0, clamp)] * len(eci), eci)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


# -- the patches dictionary and stage -------------------------------------------------------


def _slots(rng, shape=(3, 64, 320), before_ct=True):
    """A jxl_tpu DecoderState whose slot 0 holds seeded planes."""
    from jxl_tpu.api.state import DecoderState
    from jxl_tpu.io.headers import FileHeader
    from jxl_tpu.io.bit_reader import BitReader

    fh = FileHeader.read(BitReader(_stream("anim_replace")))
    state = DecoderState(fh)
    planes = [rng.uniform(0.0, 1.0, shape[1:]).astype(np.float32) for _ in range(shape[0])]
    state.reference_frames[0] = {"frame": planes, "saved_before_color_transform": before_ct}
    return state


def _read_both(bits, size, num_ec, ref_state):
    from jxl_tpu.features.patches import PatchesDictionary as RefDict
    from jxl_tpu.io.bit_reader import BitReader as RefReader

    from jxl_tpu_torch.api.state import state_from_numpy
    from jxl_tpu_torch.features.patches import PatchesDictionary
    from jxl_tpu_torch.io.bit_reader import BitReader

    data = np.packbits(bits, bitorder="little").tobytes() + bytes(8)
    port_state = state_from_numpy(ref_state, "cpu")
    want = RefDict.read(RefReader(data), *size, num_ec, ref_state.reference_frames)
    got = PatchesDictionary.read(BitReader(data), *size, num_ec, port_state.reference_frames)
    return got, want, port_state


@pytest.mark.parametrize("mode", [PATCH_REPLACE, PATCH_ADD, PATCH_MUL])
def test_dictionary_read_matches_jxl_tpu(mode):
    refs, places = text_layout(1024, 768, (320, 64), 400, 40, seed=21, overlap=20)
    bits, _ = patches_dictionary(refs, places, mode)
    got, want, _ = _read_both(bits, (1024, 768), 0, _slots(np.random.default_rng(1)))
    assert got.blendings_stride == want.blendings_stride == 1
    assert [(p.x, p.y, p.ref_pos_idx) for p in got.positions] == [
        (p.x, p.y, p.ref_pos_idx) for p in want.positions]
    assert [(b.mode, b.alpha_channel, b.clamp) for b in got.blendings] == [
        (b.mode, b.alpha_channel, b.clamp) for b in want.blendings]
    assert [(r.reference, r.x0, r.y0, r.xsize, r.ysize) for r in got.ref_positions] == [
        (r.reference, r.x0, r.y0, r.xsize, r.ysize) for r in want.ref_positions]
    assert len(got.positions) > 400


@pytest.mark.parametrize("case", ["ref_out_of_bounds", "missing_reference", "after_ct",
                                  "patch_out_of_bounds"])
def test_dictionary_errors_match_jxl_tpu(case):
    refs, places = text_layout(512, 384, (320, 64), 50, 20, seed=22)
    size = (512, 384)
    rng = np.random.default_rng(2)
    if case == "ref_out_of_bounds":
        state = _slots(rng, shape=(3, 31, 320))  # shorter than a glyph
    elif case == "missing_reference":
        state = _slots(rng)
        state.reference_frames[0] = None
    elif case == "after_ct":
        state = _slots(rng, before_ct=False)
    else:
        state = _slots(rng)
        size = (256, 384)  # places reach past x = 256
    bits, _ = patches_dictionary(refs, places, PATCH_ADD)
    with pytest.raises(Exception) as want:
        _read_both(bits, size, 0, state)
    from jxl_tpu_torch.api.state import state_from_numpy
    from jxl_tpu_torch.features.patches import PatchesDictionary
    from jxl_tpu_torch.io.bit_reader import BitReader

    data = np.packbits(bits, bitorder="little").tobytes() + bytes(8)
    with pytest.raises(Exception) as got:
        PatchesDictionary.read(BitReader(data), *size, 0,
                               state_from_numpy(state, "cpu").reference_frames)
    assert type(got.value).__name__ == type(want.value).__name__
    assert type(got.value).__name__.startswith("Patches")
    assert isinstance(got.value, jxl_tpu_torch.errors.JxlError)


def test_patch_layers_follow_the_dictionary_order():
    """A chain A, B over A, C over B but not A: C must come after B (the
    first-fit layers would put C beside A, before B)."""
    from jxl_tpu_torch.render.pipeline import patch_layers

    rects = np.array([[0, 0, 10, 10], [0, 8, 10, 10], [0, 16, 10, 10], [40, 40, 4, 4]])
    assert patch_layers(rects, 64, 64).tolist() == [0, 1, 2, 0]
    apart = np.array([[0, 0, 10, 10], [0, 10, 10, 10], [10, 0, 10, 10]])
    assert patch_layers(apart, 64, 64).tolist() == [0, 0, 0]


def _port_patch_frame(pd, size, state, num_ec):
    eci = [SimpleNamespace(ec_type=0, alpha_associated=False)] * num_ec
    header = SimpleNamespace(size=lambda: size)
    return SimpleNamespace(
        lf_global=SimpleNamespace(patches=pd), header=header, decoder_state=state,
        file_header=SimpleNamespace(image_metadata=SimpleNamespace(extra_channel_info=eci)))


@pytest.mark.parametrize("mode,num_ec", [(PATCH_REPLACE, 0), (PATCH_ADD, 0), (PATCH_MUL, 0),
                                         (4, 1), (7, 1)])
def test_patch_stage_matches_sequential_apply(mode, num_ec):
    """The port's stage (layers of gathers and scatters) on a state carried
    across gives jxl_tpu's sequential PatchesDictionary.apply, overlapping
    patches included."""
    from jxl_tpu_torch.render.pipeline import patches_stage

    rng = np.random.default_rng(30 + mode)
    w, h = 512, 384
    refs, places = text_layout(w, h, (320, 64), 150, 30, seed=23 + mode, overlap=30)
    bits, _ = patches_dictionary(refs, places, mode, num_ec=num_ec)
    ref_state = _slots(rng, shape=(3 + num_ec, 64, 320))
    got_pd, want_pd, port_state = _read_both(bits, (w, h), num_ec, ref_state)
    planes = [rng.uniform(0.0, 1.0, (h, w)).astype(np.float32) for _ in range(3 + num_ec)]
    eci = [SimpleNamespace(ec_type=0, alpha_associated=False)] * num_ec
    want = [p.copy() for p in planes]
    want_pd.apply(want, eci, ref_state.reference_frames)
    stage = patches_stage(_port_patch_frame(got_pd, (w, h), port_state, num_ec))
    src = [torch.from_numpy(p.copy()) for p in planes]
    got = stage.fn(src, {})
    for s, p in zip(src, planes):  # the stage writes its own copy
        np.testing.assert_array_equal(s.numpy(), p)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-6, atol=1e-6)
    assert max(_diff(g.numpy(), p).max() for g, p in zip(got, planes)) > 0.05


# -- blend_and_extend ------------------------------------------------------------------------


def _headers(data, package):
    """[(file header, frame header)] of every frame, read by `package`."""
    import importlib

    BitReader = importlib.import_module(f"{package}.io.bit_reader").BitReader
    FileHeader = importlib.import_module(f"{package}.io.headers").FileHeader
    parse_frame = importlib.import_module(f"{package}.api.simple").parse_frame
    br = BitReader(data)
    fh = FileHeader.read(br)
    if fh.image_metadata.preview is not None:
        preview = parse_frame(br, fh, None, preview=True)
        br.jump_to_byte_boundary()
        br.skip_bits(preview.toc.total_size * 8)
    out = []
    while True:
        br.jump_to_byte_boundary()
        frame = parse_frame(br, fh)
        out.append((fh, frame.header))
        br.jump_to_byte_boundary()
        br.skip_bits(frame.toc.total_size * 8)
        if frame.header.is_last:
            return out


@pytest.mark.parametrize("index", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["anim_vardct_preview", "anim_rgba"])
def test_blend_and_extend_matches_jxl_tpu(name, index):
    """Cropped frames (negative x0, past the right edge) blending by
    REPLACE, ADD, MUL (sources 0 and 1) and BLEND with alpha, on slots
    carried across from a jxl_tpu state."""
    from jxl_tpu.render.simple import blend_and_extend as ref_blend

    from jxl_tpu_torch.api.state import state_from_numpy
    from jxl_tpu_torch.render.simple import blend_and_extend

    data = _stream(name)
    (rfh, rh), (pfh, ph) = _headers(data, "jxl_tpu")[index], _headers(data, "jxl_tpu_torch")[index]
    num_c = 3 + len(rfh.image_metadata.extra_channel_info)
    rng = np.random.default_rng(40 + index)
    ref_state = _slots(rng, shape=(num_c, rfh.ysize, rfh.xsize))
    ref_state.reference_frames[1] = {
        "frame": [rng.uniform(0, 1, (rfh.ysize, rfh.xsize)).astype(np.float32)
                  for _ in range(num_c)], "saved_before_color_transform": False}
    port_state = state_from_numpy(ref_state, "cpu")
    planes = [rng.uniform(0, 1, (rh.height, rh.width)).astype(np.float32) for _ in range(num_c)]
    want = ref_blend(SimpleNamespace(header=rh, file_header=rfh, decoder_state=ref_state), planes)
    slot = port_state.reference_frames[rh.blending_info.source]["frame"].clone()
    got = blend_and_extend(SimpleNamespace(header=ph, file_header=pfh, decoder_state=port_state),
                           [torch.from_numpy(p) for p in planes])
    assert ph.needs_blending() and (ph.x0 < 0 or ph.x0 + ph.width > pfh.xsize or index > 2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (pfh.ysize, pfh.xsize)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(port_state.reference_frames[rh.blending_info.source]["frame"],
                               slot, rtol=0, atol=0)


# -- decode_image ------------------------------------------------------------------------------

_DECODES = {}


def _port(name, fmt, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    if (name, fmt) not in _DECODES:
        _DECODES[(name, fmt)] = jxl_tpu_torch.decode_image(_stream(name), pixel_format=fmt,
                                                           device="cpu")
    return _DECODES[(name, fmt)]


@pytest.mark.parametrize("route", ["per_frame", "default"])
@pytest.mark.parametrize("fmt", ["f32", "u8", "u16", "f16"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jxl_tpu(name, fmt, route, monkeypatch):
    """Every visible frame, its shape and duration, against jxl_tpu's
    per-frame loop (JXL_TPU_BATCH_ANIM=off) and its default route (the
    batched host route for the small REPLACE animation)."""
    if route == "per_frame":
        monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "off")
    else:
        monkeypatch.delenv("JXL_TPU_BATCH_ANIM", raising=False)
    want = ref_decode(_stream(name), pixel_format=fmt)
    img = _port(name, fmt, monkeypatch)
    assert len(img.frames) == len(want.frames) == FRAMES[name]
    assert img.durations == want.durations
    f32_diffs = [0.0] * len(want.frames)
    if fmt == "u16":
        f32_diffs = [float(_diff(a.numpy(), b).max()) for a, b in zip(
            _port(name, "f32", monkeypatch).frames, ref_decode(_stream(name)).frames)]
        assert max(f32_diffs) <= 1e-4
    for got, w, e in zip(img.frames, want.frames, f32_diffs):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        _check_format(got.numpy(), np.asarray(w), fmt, name in XYB, e)


def test_durations_as_written(monkeypatch):
    assert _port("anim_vardct_preview", "f32", monkeypatch).durations == [10.0 * TICKS] * 5
    assert _port("anim_replace", "f32", monkeypatch).durations == [
        10.0 * (TICKS + k) for k in range(5)]
    assert _port("patches_overlap", "f32", monkeypatch).durations == [0.0]


@pytest.mark.parametrize("name", list(STREAMS))
def test_keep_all_frames_false_matches_jxl_tpu(name, monkeypatch):
    monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "off")
    monkeypatch.setenv("JXL_TPU_AC", "host")
    want = ref_decode(_stream(name), keep_all_frames=False)
    img = jxl_tpu_torch.decode_image(_stream(name), keep_all_frames=False, device="cpu")
    assert len(img.frames) == len(want.frames) and img.durations == want.durations
    ref = _port(name, "f32", monkeypatch)
    for a, b in zip(img.frames, ref.frames):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_preview_is_skipped_and_leaves_the_counters(monkeypatch):
    """The preview frame is not returned, and the frames after it decode
    as without it."""
    with_preview = _port("anim_vardct_preview", "f32", monkeypatch)
    plain = jxl_tpu_torch.decode_image(
        anim_vardct_stream(320, 200, (288, 96), num_frames=5, seed=3), device="cpu")
    assert len(with_preview.frames) == len(plain.frames) == 5
    for a, b in zip(with_preview.frames, plain.frames):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lane_route_matches_host_route(monkeypatch):
    """The VarDCT animation through the lane decoder's plain version (a
    fresh lane plan and coefficient buffer a frame) equals the host AC
    route."""
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    data = anim_vardct_stream(320, 200, (288, 96), num_frames=3, seed=9)
    lanes = jxl_tpu_torch.decode_image(data, device="cpu")
    monkeypatch.setenv("JXL_TPU_AC", "host")
    host = jxl_tpu_torch.decode_image(data, device="cpu")
    assert len(lanes.frames) == 3
    for a, b in zip(lanes.frames, host.frames):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["anim_vardct_preview", "anim_rgba", "patches_overlap"])
def test_saved_slots_are_left_unchanged(name, monkeypatch):
    """Every slot a frame saves keeps its pixels to the end of the decode:
    no later stage, blend or frame writes into it."""
    from jxl_tpu_torch.api.state import DecoderState

    saved = []
    real = DecoderState.save_reference

    def spy(self, slot, planes, before_ct):
        real(self, slot, planes, before_ct)
        t = self.reference_frames[slot]["frame"]
        saved.append((t, t.clone()))

    monkeypatch.setattr(DecoderState, "save_reference", spy)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    jxl_tpu_torch.decode_image(_stream(name), device="cpu")
    assert len(saved) >= 1
    for t, snapshot in saved:
        torch.testing.assert_close(t, snapshot, rtol=0, atol=0)


@pytest.mark.parametrize("what,reason", [("lf_frame", "LF frames"), ("splines", "splines"),
                                         ("icc", "ICC")])
def test_what_stays_outside_the_slice_raises(what, reason, monkeypatch):
    """LF frames, splines and ICC profiles, which earlier slices refused,
    decode now: each case's multi-frame stream (an LF frame ahead of a
    VarDCT frame that reads it; the REPLACE animation with splines in its
    second frame; the REPLACE animation with an embedded profile) decodes
    as jxl_tpu decodes it (f32 within 1e-4, the same durations and
    profile)."""
    from test_torch_frame_streams import FrameSpec, encode_frames, frame_sections
    from test_torch_icc_streams import display_p3_profile
    from test_torch_spline_streams import splines_stream
    from test_torch_vardct_streams import ENABLE_SPLINES, encode_xyb_vardct

    if what == "lf_frame":
        data = lf_frame_stream()
    elif what == "splines":
        frames = [FrameSpec(frame_sections(splines_stream(320, 200, 4, seed=20 + k)[0]),
                            "vardct", duration=TICKS, is_last=k == 1, flags=ENABLE_SPLINES)
                  for k in range(2)]
        data = encode_frames(320, 200, frames, animation=(100, 1))
    else:
        frames = [FrameSpec(frame_sections(encode_xyb_vardct(320, 200, seed=22 + k,
                                                             density=0.1)[0]),
                            "vardct", duration=TICKS, is_last=k == 1) for k in range(2)]
        data = encode_frames(320, 200, frames, animation=(100, 1), icc=display_p3_profile())
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got = jxl_tpu_torch.decode_image(data, device="cpu")
    want = ref_decode(data)
    assert len(got.frames) == len(want.frames) and got.durations == want.durations, reason
    for g, w in zip(got.frames, want.frames):
        assert _diff(g.numpy(), w).max() <= 1e-4
    assert got.icc_profile == want.icc_profile
    assert (got.icc_profile is not None) == (what == "icc")


# -- on the card ----------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
def test_blend_and_patch_steps_on_card_match_cpu(cuda_device):
    from jxl_tpu_torch.api.state import state_from_numpy
    from jxl_tpu_torch.render.pipeline import patches_stage
    from jxl_tpu_torch.render.simple import blend_and_extend

    rng = np.random.default_rng(5)
    refs, places = text_layout(512, 384, (320, 64), 150, 30, seed=5, overlap=30)
    bits, _ = patches_dictionary(refs, places, PATCH_REPLACE)
    ref_state = _slots(rng)
    pd, _, cpu_state = _read_both(bits, (512, 384), 0, ref_state)
    card_state = state_from_numpy(ref_state, cuda_device)
    planes = [torch.from_numpy(rng.uniform(0, 1, (384, 512)).astype(np.float32))
              for _ in range(3)]
    want = patches_stage(_port_patch_frame(pd, (512, 384), cpu_state, 0)).fn(planes, {})
    got = patches_stage(_port_patch_frame(pd, (512, 384), card_state, 0)).fn(
        [p.to(cuda_device) for p in planes], {})
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)
    fh, header = _headers(_stream("anim_vardct_preview"), "jxl_tpu_torch")[3]
    slot = _slots(rng, shape=(3, fh.ysize, fh.xsize))
    frame_planes = [torch.from_numpy(rng.uniform(0, 1, (header.height, header.width))
                                     .astype(np.float32)) for _ in range(3)]
    outs = []
    for dev in ("cpu", cuda_device):
        frame = SimpleNamespace(header=header, file_header=fh,
                                decoder_state=state_from_numpy(slot, dev))
        outs.append(blend_and_extend(frame, [p.to(dev) for p in frame_planes]))
    for a, b in zip(*outs):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-6)
