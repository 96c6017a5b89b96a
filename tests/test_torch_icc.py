"""The port's embedded ICC profile read (icc/decode.py,
native.decode_icc_native) against jxl_tpu on the same writer bytes
(test_torch_icc_streams.py): the context model, the profile bytes and
the reader's position after them, decode_image of a recompressed-JPEG
frame (YCbCr 4:2:0) and of an XYB frame that embed a profile, a stream
with both a profile and a preview, and the error of a truncated profile
stream. Pixel tolerances: test_torch_progressive.check_format.
"""

import numpy as np
import pytest

import jxl_tpu_torch
from jxl_tpu.api.simple import decode_image as ref_decode
from test_torch_frame_streams import FrameSpec, encode_frames, frame_sections
from test_torch_icc_streams import PROFILES, encode_icc
from test_torch_layouts import as_jxl_tpu_edges
from test_torch_progressive import check_format
from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _jpeg(name):
    return _cached(("jpeg", name), lambda: encode_ycbcr_vardct(
        520, 136, seed=91, density=0.1, filters=False, icc=PROFILES[name]())[0])


def test_context_model_matches_jxl_tpu():
    from jxl_tpu.icc.decode import _icc_context as ref_context
    from jxl_tpu_torch.icc.decode import _icc_context

    for size in (0, 128, 129, 5000):
        for b1 in range(256):
            got = [_icc_context(size, b1, b2) for b2 in range(256)]
            assert got == [ref_context(size, b1, b2) for b2 in range(256)]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_read_icc_matches_jxl_tpu(name):
    from jxl_tpu.icc.decode import read_icc as ref_read
    from jxl_tpu.io.bit_reader import BitReader as RefReader
    from jxl_tpu_torch.icc.decode import read_icc
    from jxl_tpu_torch.io.bit_reader import BitReader

    profile = PROFILES[name]()
    bits = encode_icc(profile)
    data = np.packbits(np.concatenate([bits, np.zeros(64, np.uint8)]),
                       bitorder="little").tobytes()
    br, rbr = BitReader(data), RefReader(data)
    assert read_icc(br) == ref_read(rbr) == profile
    assert br.pos == rbr.pos == len(bits)


@pytest.mark.parametrize("name,fmt", [("pq", f) for f in ("f32", "u8", "u16", "f16")]
                         + [("display_p3", "f32")])
def test_jpeg_frame_with_a_profile_matches_jxl_tpu(name, fmt, monkeypatch):
    """A recompressed JPEG's frame that keeps its camera profile: the
    pixels are in the profile's space, and output_icc is the profile."""
    data = _jpeg(name)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu")
    want = ref_decode(data, pixel_format=fmt)
    profile = PROFILES[name]()
    assert got.icc_profile == want.icc_profile == profile
    assert got.output_icc() == want.output_icc() == profile
    # jxl_tpu's chroma edges (test_torch_layouts.as_jxl_tpu_edges)
    pixels = as_jxl_tpu_edges(lambda: jxl_tpu_torch.decode_image(
        data, pixel_format=fmt, device="cpu").frames[0].numpy(), monkeypatch)
    check_format(pixels, want.frames[0], fmt)


def test_lane_route_reads_past_the_profile(monkeypatch):
    """The profile moves every later bit: the lane decoder's sections,
    found from the TOC after it, give the host route's pixels."""
    data = _cached("small", lambda: encode_ycbcr_vardct(
        264, 64, seed=94, density=0.05, filters=False, icc=PROFILES["display_p3"]())[0])
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    lanes = jxl_tpu_torch.decode_image(data, device="cpu").frames[0]
    monkeypatch.setenv("JXL_TPU_AC", "host")
    host = jxl_tpu_torch.decode_image(data, device="cpu").frames[0]
    assert bool((lanes == host).all())


def test_profile_and_preview_both_decode(monkeypatch):
    """The profile comes before the preview: a stream with both skips the
    preview at the right bit and decodes its frame as jxl_tpu does."""
    from test_torch_frame_streams import _preview_spec

    data = _cached("preview", lambda: encode_frames(
        520, 136, [FrameSpec(frame_sections(encode_xyb_vardct(520, 136, seed=92,
                                                               density=0.1)[0]),
                             "vardct", is_last=True)],
        preview=_preview_spec(True, 0), icc=PROFILES["display_p3"]()))
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got = jxl_tpu_torch.decode_image(data, device="cpu")
    want = ref_decode(data)
    assert got.icc_profile == want.icc_profile == PROFILES["display_p3"]()
    assert len(got.frames) == len(want.frames) == 1
    check_format(got.frames[0].numpy(), want.frames[0], "f32")


def test_xyb_frame_with_a_profile_renders_to_srgb(monkeypatch):
    """An XYB frame renders to sRGB whatever profile it embeds, in both
    packages; the port's output_icc then describes sRGB, where jxl_tpu
    returns the embedded profile (ROADMAP section 3)."""
    from jxl_tpu_torch.color.icc_synth import synthesize_icc
    from jxl_tpu_torch.io.headers.image import default_color_encoding

    data = _cached("xyb", lambda: encode_xyb_vardct(520, 136, seed=93, density=0.1,
                                                    icc=PROFILES["pq"]())[0])
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got = jxl_tpu_torch.decode_image(data, device="cpu")
    want = ref_decode(data)
    assert got.icc_profile == want.icc_profile == PROFILES["pq"]()
    check_format(got.frames[0].numpy(), want.frames[0], "f32")
    assert got.output_icc() == synthesize_icc(default_color_encoding())
    assert want.output_icc() == PROFILES["pq"]()


def test_truncated_profile_raises_as_jxl_tpu():
    """A file cut inside its ICC stream raises jxl_tpu's error class."""
    data = _jpeg("pq")
    cut = data[: 16 + len(encode_icc(PROFILES["pq"]())) // 16]
    with pytest.raises(Exception) as port_err:
        jxl_tpu_torch.decode_image(cut, device="cpu")
    with pytest.raises(Exception) as ref_err:
        ref_decode(cut)
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert type(port_err.value).__module__ == "jxl_tpu_torch.errors"
