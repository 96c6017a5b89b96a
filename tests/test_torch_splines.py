"""The port's splines (features/splines.py, render/pipeline.py:
splines_stage) against jxl_tpu on the same writer bytes
(test_torch_spline_streams.py).

- The bundle reads back the same in both packages; the draw cache, the
  (S, 8) float32 segment table, is bit-equal to jxl_tpu's segments
  rounded to float32 as its native splat reads them.
- Splats on the same planes: the plain host draw and the native
  jxl_spline_splat bit for bit; the torch stage (what runs on the card)
  within 1e-5 of them, since index_add_ adds a pixel's segments in its own
  order (each segment's term is bit-equal).
- decode_image in all four pixel formats, with the tolerances of
  test_torch_progressive.check_format.
- Errors: too many splines, coinciding control points and an area past
  the limit raise jxl_tpu's error class.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.api.simple import decode_image as ref_decode
from test_torch_progressive import check_format
from test_torch_spline_streams import (SplineSpec, encode_splines, random_splines,
                                       splines_stream)
from test_torch_vardct_streams import encode_xyb_vardct

_CACHE = {}


def _stream():
    if "s" not in _CACHE:
        _CACHE["s"] = splines_stream(520, 136, 8, seed=81, density=0.1)
    return _CACHE["s"]


def _lf_global(data, package):
    """`package`'s frame of `data` with its LfGlobal section read."""
    import importlib

    BitReader = importlib.import_module(f"{package}.io.bit_reader").BitReader
    FileHeader = importlib.import_module(f"{package}.io.headers").FileHeader
    parse_frame = importlib.import_module(f"{package}.api.simple").parse_frame
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    frame.decode_lf_global(frame.split_sections(br)[0])
    return frame


def _bits_reader(bits, package):
    import importlib

    BitReader = importlib.import_module(f"{package}.io.bit_reader").BitReader
    data = np.packbits(np.concatenate([bits, np.zeros(64, np.uint8)]),
                       bitorder="little").tobytes()
    return BitReader(data)


def test_bundle_reads_the_same():
    from jxl_tpu.features.splines import Splines as RefSplines
    from jxl_tpu_torch.features.splines import Splines

    rng = np.random.default_rng(82)
    bits = encode_splines(random_splines(rng, 800, 600, 7), quant_adjust=-3)
    got = Splines.read(_bits_reader(bits, "jxl_tpu_torch"), 800 * 600)
    want = RefSplines.read(_bits_reader(bits, "jxl_tpu"), 800 * 600)
    assert got.quantization_adjustment == want.quantization_adjustment == -3
    assert got.starting_points == want.starting_points
    for g, w in zip(got.splines, want.splines):
        assert (g.control_points, g.color_dct, g.sigma_dct) == (
            w.control_points, w.color_dct, w.sigma_dct)


def test_segment_table_is_bit_equal_to_jxl_tpus_segments():
    data, _ = _stream()
    table = _lf_global(data, "jxl_tpu_torch").lf_global.splines.table
    segs = _lf_global(data, "jxl_tpu").lf_global.splines.segments
    want = np.array([(s.center_x, s.center_y, s.maximum_distance, s.inv_sigma,
                      s.sigma_over_4_times_intensity, *s.color) for s in segs], np.float32)
    assert table.dtype == np.float32 and table.shape == want.shape and len(table) > 500
    np.testing.assert_array_equal(table, want)


def test_splats_agree():
    from jxl_tpu_torch import native
    from jxl_tpu_torch.render.pipeline import splines_stage

    data, _ = _stream()
    frame = _lf_global(data, "jxl_tpu_torch")
    splines = frame.lf_global.splines
    h, w = 136, 520
    base = np.random.default_rng(83).random((3, h, w)).astype(np.float32)
    drawn = splines.draw([p.copy() for p in base])
    nat = [p.copy() for p in base]
    native.spline_splat_native(nat, splines.table)
    stage = splines_stage(frame)
    got = stage.fn([torch.from_numpy(p.copy()) for p in base], {})
    for c in range(3):
        np.testing.assert_array_equal(drawn[c], nat[c])
        assert np.abs(got[c].numpy() - nat[c]).max() <= 1e-5
    assert max(np.abs(nat[c] - base[c]).max() for c in range(3)) > 0.1  # the splines show


def test_spline_plan_chunks_the_boxes(monkeypatch):
    """Boxes clipped to the planes, and chunks of whole segments within
    the pixel budget, on a frame whose splines cross its edges."""
    from jxl_tpu_torch.render import pipeline

    data, _ = _stream()
    table = _lf_global(data, "jxl_tpu_torch").lf_global.splines.table
    monkeypatch.setattr(pipeline, "SPLAT_CHUNK_PIXELS", 5000)
    rows, boxes, chunks = pipeline.spline_plan(table, 40, 300)
    assert 0 < len(rows) < len(table)
    x0, y0, bw, px = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    assert (x0 >= 0).all() and (y0 >= 0).all() and (x0 + bw <= 300).all()
    assert (y0 + px // bw <= 40).all()
    assert chunks[0][0] == 0 and chunks[-1][1] == len(rows)
    for (a, b, pixels), nxt in zip(chunks, chunks[1:] + [(len(rows), None, None)]):
        assert b == nxt[0] and pixels == px[a:b].sum()
        assert pixels <= 5000 or b == a + 1
        np.testing.assert_array_equal(boxes[a:b, 4], np.cumsum(px[a:b]) - px[a:b])


@pytest.mark.parametrize("fmt", ["f32", "u8", "u16", "f16"])
def test_decode_image_matches_jxl_tpu(fmt, monkeypatch):
    data, _ = _stream()
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0].numpy()
    check_format(got, ref_decode(data, pixel_format=fmt).frames[0], fmt)


def _raises_as_jxl_tpu(call_port, call_ref):
    """Both calls raise, with the same error class name."""
    with pytest.raises(Exception) as port_err:
        call_port()
    with pytest.raises(Exception) as ref_err:
        call_ref()
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert type(port_err.value).__module__ == "jxl_tpu_torch.errors"
    return type(port_err.value).__name__


def test_too_many_splines_raise_as_jxl_tpu():
    from jxl_tpu.features.splines import Splines as RefSplines
    from jxl_tpu_torch.features.splines import Splines

    rng = np.random.default_rng(84)
    bits = encode_splines(random_splines(rng, 100, 100, 3))
    # at most num_pixels // 2 control points: two pixels take one spline
    name = _raises_as_jxl_tpu(lambda: Splines.read(_bits_reader(bits, "jxl_tpu_torch"), 2),
                              lambda: RefSplines.read(_bits_reader(bits, "jxl_tpu"), 2))
    assert name == "SplinesTooMany"


def _spline_frame(splines):
    data, _ = encode_xyb_vardct(520, 136, seed=85, density=0.05, splines=splines)
    return data


def test_coinciding_control_points_raise_as_jxl_tpu(monkeypatch):
    rng = np.random.default_rng(86)
    splines = random_splines(rng, 520, 136, 2)
    splines[1].points.insert(3, splines[1].points[2])
    data = _spline_frame(splines)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    name = _raises_as_jxl_tpu(lambda: jxl_tpu_torch.decode_image(data, device="cpu"),
                              lambda: ref_decode(data))
    assert name == "SplineAdjacentCoincidingControlPoints"


def test_area_past_the_limit_raises_as_jxl_tpu(monkeypatch):
    """A long spline whose 32 sigma coefficients are all large: its
    estimated area passes the frame's limit."""
    sigma = [3000] * 32
    color = [[0] * 32, [1] + [0] * 31, [0] * 32]
    points = [(10, 10), (500, 10), (500, 120), (10, 120)]
    data = _spline_frame([SplineSpec(points, color, sigma)])
    monkeypatch.setenv("JXL_TPU_AC", "host")
    name = _raises_as_jxl_tpu(lambda: jxl_tpu_torch.decode_image(data, device="cpu"),
                              lambda: ref_decode(data))
    assert name == "SplinesAreaTooLarge"
