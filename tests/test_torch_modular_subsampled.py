"""Chroma-subsampled YCbCr Modular frames in jxl_tpu_torch, the last frame
type earlier slices refused (NotSupported), against jxl_tpu on the
writer's streams (tests/test_torch_streams.py:encode_ycbcr_modular).

Each channel (Cb, Y, Cr) is coded at its own size; the render pipeline's
chroma upsampling stages bring Cb and Cr to the frame's size before the
visible crop and the filters. Tolerance: the decoded channels bit for
bit (integer path); the pixels f32 within 1e-4 and u8 within 1 LSB, the
bound of the port's other colour-path twin tests (torch's float32 colour
transform against jxl_tpu's numpy one).
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.api.simple import decode_first_frame
from jxl_tpu.api.simple import decode_image as ref_decode
from test_torch_streams import GRADIENT, NORTH, WEST, encode_ycbcr_modular

STREAMS = {
    # 520 wide: Cb and Cr wider than a group, every channel in the groups
    "420": lambda: encode_ycbcr_modular(520, 300, seed=41, subsampling="420", filters=False),
    "422": lambda: encode_ycbcr_modular(520, 300, seed=42, subsampling="422", filters=False),
    "440": lambda: encode_ycbcr_modular(520, 300, seed=43, subsampling="440", filters=False),
    # gaborish + EPF after the chroma upsampling
    "420_filtered": lambda: encode_ycbcr_modular(520, 264, seed=44, subsampling="420"),
    # a lossless lane stream, subsampled
    "420_lanes": lambda: encode_ycbcr_modular(520, 300, seed=45, subsampling="420",
                                              predictors=(GRADIENT, WEST, NORTH),
                                              filters=False),
}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("fmt", ["f32", "u8"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_subsampled_modular_matches_jxl_tpu(name, fmt, monkeypatch):
    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", "0")
    data, _ = _stream(name)
    want = ref_decode(data, pixel_format=fmt).frames[0]
    got = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _max_diff(got, want) <= (1.0 if fmt == "u8" else 1e-4)


@pytest.mark.parametrize("name", list(STREAMS))
def test_subsampled_channels_are_the_writers(name):
    """Both packages read each channel at its subsampled size, as written."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    data, planes = _stream(name)
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    sub = name[:3]
    assert frame.header.do_ycbcr and not fh.image_metadata.xyb_encoded
    assert not frame.header.is444
    frame.decode_all_sections(br, "cpu")
    ref = decode_first_frame(data)
    for c in range(3):
        np.testing.assert_array_equal(frame.modular_channel(c), planes[c])
        np.testing.assert_array_equal(np.asarray(ref.channels[c]), planes[c])
    ys, xs = {"420": (1, 1), "422": (0, 1), "440": (1, 0)}[sub]
    h, w = planes[1].shape
    assert planes[0].shape == planes[2].shape == (-(-h >> ys), -(-w >> xs))


def test_subsampled_lane_stream_takes_the_lanes(monkeypatch):
    """A subsampled lossless stream decodes the same with the lanes as
    without, each lane at its channel's own size."""
    from jxl_tpu_torch.utils import trace

    data, _ = _stream("420_lanes")
    out = {}
    trace.enable()
    try:
        for mode in "10":
            monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", mode)
            trace.reset()
            out[mode] = jxl_tpu_torch.decode_image(data, device="cpu").frames[0]
            if mode == "1":
                # 6 groups of 3 channels; the last group (8x44 of Y, 4x22
                # of Cb and Cr) is under MIN_STREAM_PX and decodes on the host
                assert trace.metrics.get("lossless_device_lanes") == 5 * 3
    finally:
        trace.enable(False)
    assert torch.equal(out["1"], out["0"])
