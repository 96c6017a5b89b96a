"""The port's progressive decode against jxl_tpu on the same writer bytes:
VarDCT frames of two and three AC passes (test_torch_vardct_streams.py
`passes=`) and LF frames (test_torch_frame_streams.py:lf_frame_stream,
one and two levels), as cjxl -p --progressive_dc writes them.

- Coefficients bit for bit: the lane decoder's plain version (K3 on the
  card) over two lanes a group against the writer's coefficients and
  jxl_tpu's XLA decode_ac_sections on the same inputs, and the host
  decoder (api/frame.py:decode_vardct_ac_on_host, group by group, pass by
  pass) against both, with and without an alpha channel in the last pass.
- decode_image in all four pixel formats: u8 and u16 within 1, f16 within
  one ulp (of the larger of the two values) or the f32 limit where that
  is larger (the two packages' XYB renders differ by up to about 1e-5 in
  f32, and near zero an f16 ulp is finer than that), f32 within 1e-4.
- The adopted LF equals the LF frame's planes; a frame whose LF frame is
  missing raises jxl_tpu's error class.

The lane decoder's plain version steps in Python, one token a lane a
step: the lane cases stay at a few groups, and the decodes take the host
AC route (JXL_TPU_AC=host) unless they test the lanes.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.api.simple import decode_image as ref_decode
from test_torch_device_ac import _both, _port_frame_and_readers
from test_torch_frame_streams import FrameSpec, encode_frames, frame_sections, lf_frame_stream
from test_torch_vardct_streams import USE_LF_FRAME, encode_xyb_vardct

GROUP_STRIDE = 3 * 256 * 256
_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def check_format(got, want, fmt):
    """The tolerance of each pixel format between the two packages."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if fmt == "f32":
        assert d.max() <= 1e-4
    elif fmt == "f16":
        top = np.maximum(np.abs(got), np.abs(want)).astype(np.float16)
        assert (d <= np.maximum(np.spacing(top).astype(np.float64), 1e-4)).all()
    else:
        assert d.max() <= 1.0


def _decode_both(data, fmt, monkeypatch, route="host"):
    if route == "host":
        monkeypatch.setenv("JXL_TPU_AC", "host")
    else:
        monkeypatch.delenv("JXL_TPU_AC", raising=False)
    got = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu")
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    want = ref_decode(data, pixel_format=fmt)
    assert len(got.frames) == len(want.frames) == 1
    return got.frames[0].numpy(), want.frames[0]


# -- coefficients -------------------------------------------------------------------------


def test_two_pass_lanes_match_the_writer_and_jxl_tpu():
    """Two lanes a group, each pass's coefficients shifted and added into
    the same buffer: the plain lanes against jxl_tpu's XLA decoder, the
    writer and the port's host decoder."""
    data, coeffs = encode_xyb_vardct(520, 136, seed=61, density=0.05, passes=2)
    frame, readers = _port_frame_and_readers(data)
    assert frame.header.passes.num_passes == 2 and frame.header.passes.shift == [1]
    from jxl_tpu_torch.vardct import device_group

    inputs = device_group.lane_inputs(frame, readers)
    G = frame.header.num_groups
    assert len(inputs["lane_group"]) == 2 * G
    assert inputs["lane_shift"].tolist() == [1, 0] * G
    assert inputs["lane_group"].tolist() == [g for g in range(G) for _ in range(2)]
    # each pass reads its own slice of the context map and its own orders
    assert len(set(inputs["lane_ctx_off"].tolist())) == 2
    (ref_c, ref_ok), (got_c, got_ok) = _both(inputs)
    assert got_ok.all() and ref_ok.all()
    np.testing.assert_array_equal(got_c, ref_c)
    np.testing.assert_array_equal(got_c, coeffs)
    # a shifted coefficient of pass 0 landed under one of pass 1
    assert np.count_nonzero(coeffs & 1) and np.count_nonzero(coeffs % 2 == 0)
    # and the port's host decoder, pass by pass, on the same sections
    host, readers = _port_frame_and_readers(data)
    host.decode_vardct_ac_on_host([(g, [(p, readers[(g, p)]) for p in range(2)])
                                   for g in range(G)], "cpu")
    np.testing.assert_array_equal(host.host_ac_flat, got_c)


@pytest.mark.parametrize("passes,num_ec,lz77", [(2, 0, True), (3, 0, True), (2, 1, False)])
def test_host_route_decodes_every_pass(passes, num_ec, lz77):
    """The host decoder, group by group and pass by pass, against the
    writer's coefficients (and alpha, coded in the last pass)."""
    out = encode_xyb_vardct(520, 136, seed=62 + passes, density=0.1, passes=passes,
                            num_ec=num_ec, lz77=lz77)
    data, coeffs = out[:2]
    frame, readers = _port_frame_and_readers(data)
    from jxl_tpu_torch.vardct.device_group import eligible_for_device_ac

    assert not eligible_for_device_ac(frame)
    jobs = [(g, [(p, readers[(g, p)]) for p in range(passes)])
            for g in range(frame.header.num_groups)]
    frame.decode_vardct_ac_on_host(jobs, "cpu")
    np.testing.assert_array_equal(frame.host_ac_flat, coeffs)
    if num_ec:
        frame.lf_global.modular_global.run_transforms()
        np.testing.assert_array_equal(frame.modular_channel(3), out[2])


def test_jxl_tpu_host_coefficients_match_on_two_passes():
    """jxl_tpu's own host decode of a two-pass frame accumulates the same
    coefficients (its per-group accumulators)."""
    from test_device_ac import _decode_frame_coeffs

    data, coeffs = encode_xyb_vardct(300, 200, seed=66, transforms="dct8", density=0.1,
                                     passes=2)
    np.testing.assert_array_equal(_decode_frame_coeffs(data, force_device=False), coeffs)


# -- decode_image ---------------------------------------------------------------------------


STREAMS = {
    "two_pass": lambda: encode_xyb_vardct(520, 136, seed=71, density=0.1, passes=2)[0],
    "two_pass_rgba": lambda: encode_xyb_vardct(520, 136, seed=72, density=0.1, passes=2,
                                               num_ec=1)[0],
    "lf_frame": lambda: lf_frame_stream(320, 200, seed=73, density=0.1),
    "lf_frame_two_pass": lambda: lf_frame_stream(320, 200, passes=2, seed=74, density=0.1),
    "lf_two_levels": lambda: lf_frame_stream(2064, 16, levels=2, seed=75, density=0.1),
}


# every format of the RGBA two-pass frame and of the two-pass LF stream;
# f32 of the others (their u8, u16 and f16 run the same output stages)
FORMAT_CASES = ([(n, f) for n in ("two_pass_rgba", "lf_frame_two_pass")
                 for f in ("f32", "u8", "u16", "f16")]
                + [("two_pass", "f32"), ("lf_two_levels", "f32")])


@pytest.mark.parametrize("name,fmt", FORMAT_CASES)
def test_decode_image_matches_jxl_tpu(name, fmt, monkeypatch):
    data = _cached(name, STREAMS[name])
    got, want = _decode_both(data, fmt, monkeypatch)
    check_format(got, want, fmt)


def test_lane_route_decodes_a_progressive_lf_stream(monkeypatch):
    """The lane decoder (two lanes a group) behind an LF frame, against
    the host route and jxl_tpu, on a small sparse stream: the plain lanes
    step in Python."""
    data = _cached("lf_small", lambda: lf_frame_stream(264, 64, passes=2, seed=77,
                                                        density=0.05))
    lanes, want = _decode_both(data, "f32", monkeypatch, route="lanes")
    host, _ = _decode_both(data, "f32", monkeypatch)
    np.testing.assert_array_equal(lanes, host)
    check_format(lanes, want, "f32")


def _frames(data):
    """The port's frames of `data`, each decoded and rendered in turn on
    the CPU as decode_image does, the LF frames saved: (frame, planes
    before the colour transform) a frame."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.api.state import DecoderState
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.render.simple import render_frame_channels

    br = BitReader(data)
    fh = FileHeader.read(br)
    state = DecoderState(fh)
    out = []
    while True:
        br.jump_to_byte_boundary()
        frame = parse_frame(br, fh, state)
        frame.decode_all_sections(br, "cpu")
        planes, _, _ = render_frame_channels(frame, torch.device("cpu"))
        if frame.header.lf_level:
            state.save_lf_frame(frame.header.lf_level, planes)
        out.append((frame, planes))
        if frame.header.is_last:
            return out


@pytest.mark.parametrize("name", ["lf_frame", "lf_two_levels"])
def test_adopted_lf_is_the_lf_frames_planes(name, monkeypatch):
    """Each USE_LF_FRAME frame renders from the planes of the LF frame
    one level up, kept as they were before the colour transform."""
    monkeypatch.setenv("JXL_TPU_AC", "host")
    frames = _frames(_cached(name, STREAMS[name]))
    for (up, planes), (frame, _) in zip(frames, frames[1:]):
        assert frame.header.has_lf_frame and up.header.lf_level == frame.header.lf_level + 1
        bw, bh = frame.header.size_blocks()
        lf = torch.stack(planes[:3])
        h, w = min(bh, lf.shape[1]), min(bw, lf.shape[2])
        assert frame.lf_device.shape == (3, bh, bw)
        torch.testing.assert_close(frame.lf_device[:, :h, :w], lf[:, :h, :w], rtol=0, atol=0)
        assert float(lf.abs().max()) > 0


def test_missing_lf_frame_raises_as_jxl_tpu(monkeypatch):
    """A frame that reads an LF frame the file never had: NoLfFrame in
    both packages."""
    from jxl_tpu.errors import NoLfFrame as RefNoLfFrame
    from jxl_tpu_torch.errors import NoLfFrame

    data, _ = encode_xyb_vardct(320, 200, seed=76, density=0.1, lf_frame=True)
    stream = encode_frames(320, 200, [FrameSpec(frame_sections(data), "vardct", is_last=True,
                                                flags=USE_LF_FRAME)])
    monkeypatch.setenv("JXL_TPU_AC", "host")
    with pytest.raises(NoLfFrame):
        jxl_tpu_torch.decode_image(stream, device="cpu")
    with pytest.raises(RefNoLfFrame):
        ref_decode(stream)


def test_lf_frames_stay_on_the_decode_device(monkeypatch):
    """The LF slots hold (3, H, W) float32 tensors on the decode's
    device; the LF frame itself is neither shown nor kept as a frame."""
    from jxl_tpu_torch.api import simple

    monkeypatch.setenv("JXL_TPU_AC", "host")
    saved = []
    orig = simple.DecoderState.save_lf_frame

    def spy(self, level, planes):
        orig(self, level, planes)
        saved.append((level, self.lf_frames[level - 1]))

    monkeypatch.setattr(simple.DecoderState, "save_lf_frame", spy)
    out = jxl_tpu_torch.decode_image(_cached("lf_two_levels", STREAMS["lf_two_levels"]),
                                     device="cpu")
    assert len(out.frames) == 1 and [lv for lv, _ in saved] == [2, 1]
    assert [tuple(t.shape) for _, t in saved] == [(3, 1, 33), (3, 2, 258)]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for _, t in saved)
