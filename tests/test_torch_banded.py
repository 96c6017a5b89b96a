"""The banded decode of jxl_tpu_torch on the CPU: decode_banded (the card's
working set O(band), rows to a sink), against jxl_tpu's decode_banded and
against the port's own whole-frame decode, on the seeded writers' streams
at about 520x520 (three group rows).

Tolerances: against jxl_tpu, u8 at most 1 LSB and f32 at most 5e-5 (the
JAX package's own banded-against-one-shot bound, tests/test_banded.py:55;
its host render and the port's torch render round differently). Against
the port's whole-frame decode, bit for bit: a band runs the frame's own
per-pixel math. These comparisons run torch with one CPU thread: torch's
CPU pow (the transfer function) takes its vector or its scalar path by an
element's place in a thread's chunk, so two tensors of different sizes
can round one sample 1 ulp apart; one thread, on widths and band heights
that are multiples of 32, keeps every sample on the vector path. (On the
card every element runs the same code; chip_smoke.py holds decode_banded
to decode_image there.) The VarDCT AC goes through the native host decoder
(JXL_TPU_AC=host) but in the lane-route cases: the lane decoder's plain
version steps one token at a time in Python.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.api.banded import decode_banded as ref_banded
from jxl_tpu_torch.api import banded
from jxl_tpu_torch.errors import NotSupported
from test_torch_frame_streams import anim_vardct_stream, patches_stream
from test_torch_render_stages import NOISE_LUT
from test_torch_spline_streams import splines_stream
from test_torch_streams import encode_xyb_modular, encode_ycbcr_modular
from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

STREAMS = {
    "modular": lambda: encode_xyb_modular(520, 520, seed=1)[0],
    "modular_alpha": lambda: encode_xyb_modular(520, 520, seed=2, num_ec=1)[0],
    "vardct": lambda: encode_xyb_vardct(520, 520, seed=3, density=0.1)[0],
    "vardct_noise": lambda: encode_xyb_vardct(520, 520, seed=4, density=0.1,
                                              noise=NOISE_LUT)[0],
    "vardct_alpha": lambda: encode_xyb_vardct(520, 520, seed=5, density=0.1, num_ec=1)[0],
    "vardct_two_pass": lambda: encode_xyb_vardct(520, 520, seed=6, density=0.1, passes=2)[0],
    # a group row each of DCT256, DCT128, DCT64, DCT32 and the DCT16 fill
    "vardct_large": lambda: encode_xyb_vardct(520, 1040, seed=10, density=0.1,
                                              transforms="large")[0],
    # group row 0 holds one AFV0 block, row 1 holds 131: a band's
    # transform call of one block against the frame's of 132
    "vardct_lone_afv": lambda: encode_xyb_vardct(520, 520, seed=11, density=0.5, max_run=30,
                                                 lone=14)[0],
    "splines": lambda: splines_stream(520, 520, 8, seed=8, density=0.1)[0],
    "patches": lambda: patches_stream(520, 520, (320, 64), 120, 30, seed=7),
}
CHANNELS = {"modular_alpha": 4, "vardct_alpha": 4}
HEIGHTS = {"vardct_large": 1040}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bands(fn, data, fmt, **kw):
    """The rows fn(data, emit, ...) emits, in order, as one numpy array;
    checks that they come in order and cover the image."""
    got = []
    info = fn(data, lambda y0, band: got.append((y0, band)), pixel_format=fmt, **kw)
    assert [y0 for y0, _ in got] == [256 * k for k in range(len(got))]
    assert info["bands"] == len(got)
    return np.concatenate([np.asarray(b) for _, b in got]), info


def _max_diff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def _ref_frame_header(data):
    """jxl_tpu's Frame of a one-frame stream, its header and TOC read (the
    frame counters of its decoder state advanced), no section decoded."""
    from jxl_tpu.api.simple import parse_frame
    from jxl_tpu.api.state import DecoderState
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.container import extract_codestream_ex
    from jxl_tpu.io.headers import FileHeader

    br = BitReader(extract_codestream_ex(data)[0])
    fh = FileHeader.read(br)
    return parse_frame(br, fh, DecoderState(fh))


@pytest.mark.parametrize("fmt", ["f32", "u8"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_banded_matches_jxl_tpu(name, fmt, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = _stream(name)
    want, ref_info = _bands(ref_banded, data, fmt)
    got, info = _bands(jxl_tpu_torch.decode_banded, data, fmt, device="cpu")
    height = HEIGHTS.get(name, 520)
    assert got.shape == want.shape == (height, 520, CHANNELS.get(name, 3))
    assert got.dtype == want.dtype
    assert info["bands"] == ref_info["bands"] == -(-height // 256)
    assert _max_diff(got, want) <= (1.0 if fmt == "u8" else 5e-5)


@pytest.mark.parametrize("fmt", ["f32", "u8"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_banded_matches_decode_image(name, fmt, monkeypatch, one_thread):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = _stream(name)
    got, _ = _bands(jxl_tpu_torch.decode_banded, data, fmt, device="cpu")
    want = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("value", ["1", "yes"])
def test_decode_image_has_one_route(value, monkeypatch):
    """decode_image has no band route and reads no switch for one:
    JXL_TPU_OVERLAP set changes nothing, raises nothing and records
    neither the band route's counter nor its span."""
    from jxl_tpu_torch.utils import trace

    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = _stream("vardct")
    monkeypatch.delenv("JXL_TPU_OVERLAP", raising=False)
    want = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]
    monkeypatch.setenv("JXL_TPU_OVERLAP", value)
    trace.reset()
    trace.enable(True)
    try:
        got = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]
        spans, counters = trace.host_seconds(), dict(trace.metrics.counters)
    finally:
        trace.enable(False)
        trace.reset()
    assert torch.equal(got, want)
    assert "decode_image.sections" in spans and "decode_image.band_route" not in spans
    assert "overlap_bands" not in counters


def test_both_routes_on_the_lane_decoder(monkeypatch, one_thread):
    """K3's plain version over each band's lanes, into band-sized buffers:
    decode_banded against the whole-frame route's single launch over
    every lane, bit for bit."""
    from jxl_tpu_torch.ops import device_ac

    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    data, _ = encode_xyb_vardct(64, 264, seed=9, density=0.05)
    whole = jxl_tpu_torch.decode_image(data, device="cpu").frames[0].numpy()
    calls = []
    real = device_ac.decode_ac_sections

    def counted(*a, **kw):
        calls.append(kw["total"])
        return real(*a, **kw)

    monkeypatch.setattr(device_ac, "decode_ac_sections", counted)
    got, info = _bands(jxl_tpu_torch.decode_banded, data, "f32", device="cpu")
    np.testing.assert_array_equal(got, whole)
    # one launch a band, each over one group row's buffer (one group here)
    assert info["k3_launches"] == 2 and calls == [3 * 256 * 256] * 2


NOISE_ROWS = [(0, 5), (250, 262), (100, 300), (254, 258), (600, 606)]


@pytest.fixture(scope="module")
def noise_frames():
    data, _ = encode_xyb_vardct(500, 606, seed=10, density=0.05, noise=NOISE_LUT)
    return banded._leading_frames(data, "cpu")[2], _ref_frame_header(data)


@pytest.mark.parametrize("lo,hi", NOISE_ROWS)
def test_noise_field_rows_match_jxl_tpu(noise_frames, lo, hi):
    from jxl_tpu.features.noise import generate_noise_field_rows as ref_rows
    from jxl_tpu_torch.features.noise import generate_noise_field, generate_noise_field_rows

    frame, ref_frame = noise_frames
    want = np.stack(ref_rows(ref_frame, lo, hi))
    got = generate_noise_field_rows(frame, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, generate_noise_field(frame).numpy()[:, lo:hi])


@pytest.mark.parametrize("lo,hi", [(0, 3), (254, 258), (604, 606)])
def test_noise_field_rows_plain_version(noise_frames, lo, hi):
    from jxl_tpu_torch.features.noise import (generate_noise_field_rows,
                                              generate_noise_field_rows_reference)

    frame = noise_frames[0]
    np.testing.assert_array_equal(generate_noise_field_rows_reference(frame, lo, hi),
                                  generate_noise_field_rows(frame, lo, hi).numpy())


def _last_frame_decoded(name):
    """The port's last frame of stream `name` with its sections decoded on
    the CPU (the AC by the host decoder), the leading frames in its
    decoder state's slots."""
    key = ("frame", name)
    if key not in _CACHE:
        import os

        _, br, frame = banded._leading_frames(_stream(name), torch.device("cpu"))
        old = os.environ.get("JXL_TPU_AC")
        os.environ["JXL_TPU_AC"] = "host"
        try:
            frame.decode_all_sections(br, "cpu")
        finally:
            os.environ.pop("JXL_TPU_AC") if old is None else os.environ.update(JXL_TPU_AC=old)
        _CACHE[key] = frame
    return _CACHE[key]


@pytest.mark.parametrize("row0,rows", [(0, 256), (240, 40), (256, 256), (512, 8)])
def test_patch_stage_row_window_matches_apply_rows(row0, rows):
    from jxl_tpu_torch.render.pipeline import patches_stage

    frame = _last_frame_decoded("patches")
    rng = np.random.default_rng(row0)
    planes = [torch.from_numpy(rng.random((rows, 520), dtype=np.float32)) for _ in range(3)]
    got = patches_stage(frame, row0, rows).fn([p.clone() for p in planes], None)
    frame.lf_global.patches.apply_rows(planes, row0, [], frame.decoder_state.reference_frames)
    for g, w in zip(got, planes):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert any((g != 0).any() for g in got)


@pytest.mark.parametrize("row0,rows", [(0, 256), (200, 100), (512, 8)])
def test_spline_stage_row_window_matches_draw_rows(row0, rows):
    from jxl_tpu_torch.render.pipeline import splines_stage

    frame = _last_frame_decoded("splines")
    zeros = [np.zeros((rows, 520), np.float32) for _ in range(3)]
    got = splines_stage(frame, row0, rows).fn([torch.from_numpy(z.copy()) for z in zeros], None)
    want = frame.lf_global.splines.draw_rows(zeros, row0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


def _with_palette_step(monkeypatch):
    """Give the last frame's global Modular image a palette step after its
    LfGlobal is read: a VarDCT frame with a transform step and no extra
    channel, where jxl_tpu's decode_banded indexes an empty dict."""
    from jxl_tpu_torch.api.frame import Frame
    from jxl_tpu_torch.modular.predict import Predictor
    from jxl_tpu_torch.modular.transforms import PaletteStep

    real = Frame.decode_lf_global

    def with_step(self, br, *a, **kw):
        real(self, br, *a, **kw)
        if self.header.is_last:
            self.lf_global.modular_global.transform_steps = [
                PaletteStep(0, 1, [2], 4, 0, Predictor.ZERO, None)]

    monkeypatch.setattr(Frame, "decode_lf_global", with_step)


NOT_BANDED = {
    "modular_upsampled": lambda mp: encode_xyb_modular(264, 264, seed=11, upsampling=2)[0],
    "vardct_upsampled": lambda mp: encode_xyb_vardct(264, 264, seed=12, density=0.05,
                                                     upsampling=2)[0],
    "vardct_420": lambda mp: encode_ycbcr_vardct(264, 264, seed=13, density=0.05)[0],
    # decode_image takes it (test_torch_modular_subsampled.py); the band
    # source holds 4:4:4 Modular channels only
    "modular_420": lambda mp: encode_ycbcr_modular(520, 264, seed=16, filters=False)[0],
    "animation": lambda mp: anim_vardct_stream(320, 200, (288, 96), num_frames=3, seed=14),
    "vardct_palette_no_ec": lambda mp: (_with_palette_step(mp),
                                        encode_xyb_vardct(264, 264, seed=15, density=0.05)[0])[1],
}


@pytest.mark.parametrize("name", list(NOT_BANDED))
def test_not_banded_raises_not_supported(name, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = NOT_BANDED[name](monkeypatch)
    emitted = []
    with pytest.raises(NotSupported):
        jxl_tpu_torch.decode_banded(data, lambda y0, b: emitted.append(y0), device="cpu")
    assert emitted == []


def test_corrupt_band_raises_before_its_rows_leave(monkeypatch):
    from jxl_tpu_torch.errors import JxlError

    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = bytearray(_stream("vardct"))
    # overwrite group 6's AC section, the first of the last group row
    _, br, frame = banded._leading_frames(bytes(data), "cpu")
    at = br.pos // 8 + sum(frame.toc.entries[: frame.section_index("hf", group=6)])
    assert not frame.toc.permuted and frame.toc.entries[frame.section_index("hf", group=6)] > 8
    data[at + 2 : at + 8] = b"\xff" * 6
    emitted = []
    with pytest.raises(JxlError):
        jxl_tpu_torch.decode_banded(bytes(data), lambda y0, b: emitted.append(y0), device="cpu")
    assert emitted == [0]


@pytest.mark.parametrize("route", ["decode_banded"])
def test_corrupt_lane_raises_on_the_lane_route(route, monkeypatch):
    """K3's plain version over each band's lanes, one section corrupted:
    the lane flags, read before each band leaves, raise; decode_banded has
    emitted only the band whose flags and whose next band's flags it
    read."""
    from jxl_tpu_torch.errors import JxlError

    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    data = bytearray(encode_xyb_vardct(64, 520, seed=9, density=0.05)[0])
    # overwrite group 2's AC section, the third band's
    _, br, frame = banded._leading_frames(bytes(data), "cpu")
    sec = frame.section_index("hf", group=2)
    at = br.pos // 8 + sum(frame.toc.entries[:sec])
    assert not frame.toc.permuted and frame.toc.entries[sec] > 8
    data[at + 2 : at + 8] = bytes(b ^ 0x5A for b in data[at + 2 : at + 8])
    emitted = []
    with pytest.raises(JxlError, match="lane AC decode failed"):
        jxl_tpu_torch.decode_banded(bytes(data), lambda y0, b: emitted.append(y0), device="cpu")
    assert emitted == [0]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jxl_tpu_torch.decode_banded(_stream("modular"), lambda y0, b: None)
