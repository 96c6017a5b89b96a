"""jxl_tpu_torch.decode_image (device="cpu") against
jxl_tpu.api.simple.decode_image on the same bytes, the parsed state that
carries across, streams earlier slices rejected, and the package's import
hygiene.

Tolerances: f32 max abs 1e-4 (the sRGB pow and the JAX package's native
and XLA colour paths round differently), u8 at most 1 LSB (dither on a
rounding edge).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.api.simple import decode_first_frame as ref_first_frame
from jxl_tpu.api.simple import decode_image as ref_decode
from mini_encoder import encode_constant_modular
from test_torch_frame_streams import lf_frame_stream
from test_torch_streams import encode_xyb_modular

ROOT = pathlib.Path(__file__).resolve().parents[1]

STREAMS = {
    "xyb_1024": lambda: encode_xyb_modular(1024, 1024, seed=11)[0],
    "xyb_600x700": lambda: encode_xyb_modular(600, 700, seed=12)[0],
    "srgb_600x700": lambda: encode_constant_modular(600, 700),
}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


@pytest.mark.parametrize("fmt", ["f32", "u8"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jxl_tpu(name, fmt):
    data = _stream(name)
    want = ref_decode(data, pixel_format=fmt).frames[0]
    img = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu")
    got = img.frames[0]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert d <= (1.0 if fmt == "u8" else 1e-4)
    assert img.timings["host_s"] > 0


def test_decode_filters_really_change_pixels():
    """EPF and gaborish move the writer's content: the decode differs from
    a render with the restoration filters switched off."""
    from jxl_tpu_torch.render import simple as rs

    data = _stream("xyb_600x700")
    img = jxl_tpu_torch.decode_image(data, device="cpu").frames[0]
    dec = _port_frame(data)
    dec.header.restoration_filter.gab = False
    dec.header.restoration_filter.epf_iters = 0
    chans, color_done, _ = rs.render_frame_channels(dec, torch.device("cpu"))
    assert color_done
    plain = torch.stack(chans, dim=-1)
    assert (img - plain).abs().max().item() > 1e-3


def _port_frame(data):
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    frame.decode_all_sections(br, "cpu")
    return frame


@pytest.mark.parametrize("name", list(STREAMS))
def test_parsed_state_matches_jxl_tpu(name):
    data = _stream(name)
    ref = ref_first_frame(data).frame
    got = _port_frame(data)
    assert dataclasses.asdict(got.header.restoration_filter) == dataclasses.asdict(
        ref.header.restoration_filter
    )
    ro = ref.file_header.transform_data.opsin_inverse_matrix
    go = got.file_header.transform_data.opsin_inverse_matrix
    assert list(go.inverse_matrix) == list(ro.inverse_matrix)
    assert list(go.opsin_biases) == list(ro.opsin_biases)
    assert got.lf_global.lf_quant.quant_factors == ref.lf_global.lf_quant.quant_factors
    assert list(got.toc.entries) == list(ref.toc.entries)
    assert got.toc.permuted == ref.toc.permuted
    meta_g, meta_r = got.file_header.image_metadata, ref.file_header.image_metadata
    assert meta_g.xyb_encoded == meta_r.xyb_encoded
    assert (got.file_header.xsize, got.file_header.ysize) == (
        ref.file_header.xsize, ref.file_header.ysize)
    for c in range(3):
        np.testing.assert_array_equal(got.modular_channel(c), ref.modular_channel(c))


@pytest.mark.parametrize(
    "make,reason",
    [
        # the patches stream this case held decodes now (test_torch_frames.py);
        # so does this one, the LF frame ahead of a VarDCT frame that reads it
        (lambda: lf_frame_stream(), "frame"),
    ],
)
def test_streams_outside_the_slice_raise(make, reason, monkeypatch):
    """The streams that earlier slices refused decode now, as jxl_tpu
    decodes them (f32 within 1e-4); none is left outside on this list
    (the last one refused, a chroma-subsampled Modular frame:
    test_torch_modular_subsampled.py)."""
    data = make()
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got = jxl_tpu_torch.decode_image(data, device="cpu").frames
    want = ref_decode(data).frames
    assert len(got) == len(want) == 1, reason
    assert np.abs(got[0].numpy() - want[0]).max() <= 1e-4


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device decodes there")
    with pytest.raises(RuntimeError, match="CUDA"):
        jxl_tpu_torch.decode_image(encode_constant_modular(300, 300))


def test_import_and_decode_leave_jax_out():
    """A fresh process that imports the port and decodes on the CPU loads
    neither jax nor any module of the JAX package."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from mini_encoder import encode_constant_modular\n"
        "import jxl_tpu_torch\n"
        "img = jxl_tpu_torch.decode_image(encode_constant_modular(300, 300), device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m.startswith('jaxlib')\n"
        "       or (m.startswith('jxl_tpu') and not m.startswith('jxl_tpu_torch'))]\n"
        "print('BAD', bad)\n"
    ) % (str(ROOT), str(ROOT / "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def _port_sources():
    files = [p for p in (ROOT / "jxl_tpu_torch").rglob("*")
             if p.suffix in (".py", ".cu", ".cc") and "_build" not in p.parts]
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_name_no_jax():
    assert len(_port_sources()) > 30
    for path in _port_sources():
        text = path.read_text()
        assert "import jax" not in text, path
        assert "jxl_tpu." not in text.replace("jxl_tpu_torch.", ""), path
