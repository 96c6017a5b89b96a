"""The port's VarDCT path against jxl_tpu on the same inputs: the batched
inverse transforms (all 27 types, max abs 1e-5), the whole-frame dequant +
CfL + IDCT render from parsed state carried across, the parsed state
itself, and decode_image(device="cpu") of writer streams through both AC
routes (f32 max abs 1e-4, u8 at most 1 LSB; the sRGB pow and the JAX
package's native and XLA colour paths round differently).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jxl_tpu_torch
from jxl_tpu.api.simple import decode_image as ref_decode
from jxl_tpu.vardct.transforms_batch import transform_to_pixels_batch as ref_transform

from jxl_tpu_torch.vardct.transform_map import covered_blocks_x, covered_blocks_y
from jxl_tpu_torch.vardct.transforms_batch import transform_to_pixels_batch
from test_torch_vardct_streams import encode_xyb_vardct

STREAMS = {
    "mixed_520x136": lambda: encode_xyb_vardct(520, 136, seed=41, density=0.15),
    "dct8_300x200": lambda: encode_xyb_vardct(300, 200, seed=42, transforms="dct8",
                                              density=0.15),
    "large_520x1040": lambda: encode_xyb_vardct(520, 1040, seed=43, transforms="large",
                                                density=0.15),
}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


@pytest.mark.parametrize("t", range(27))
def test_transform_to_pixels_batch_matches_jxl_tpu(t):
    rng = np.random.default_rng(100 + t)
    cx, cy = covered_blocks_x(t), covered_blocks_y(t)
    nc = cx * cy * 64
    n = 6
    lf = rng.normal(0.0, 1.0, (n, cy, cx)).astype(np.float32)
    # dequantized coefficients of pixels of order 1
    coeffs = (rng.normal(0.0, 1.0, (n, nc)) / np.sqrt(nc)).astype(np.float32)
    want = np.asarray(ref_transform(np, t, lf, coeffs))
    got = transform_to_pixels_batch(t, torch.from_numpy(lf), torch.from_numpy(coeffs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


def _ref_frame(data):
    """jxl_tpu's parse of a writer stream with the host-decoded AC
    coefficients as one dense buffer."""
    from jxl_tpu.api.frame import Frame
    from jxl_tpu.api.state import DecoderState
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader
    from jxl_tpu.io.headers.frame import FrameHeader, Toc

    br = BitReader(data)
    fh = FileHeader.read(br)
    header = FrameHeader.read(br, fh)
    toc = Toc.read(br, header.num_toc_entries)
    br.jump_to_byte_boundary()
    frame = Frame(header, toc, fh, DecoderState(fh))
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    frame.decode_hf_global(sections[frame.section_index("hf_global")])
    frame.finalize_lf()
    frame.render_after_decode = False
    for g in range(header.num_groups):
        frame.decode_hf_group(g, [(0, sections[frame.section_index("hf", group=g)])],
                              render=False)
    stride = 3 * 256 * 256
    flat = np.zeros(header.num_groups * stride, np.int32)
    for g, c in frame.hf_global.hf_coefficients.items():
        flat[g * stride : (g + 1) * stride] = c.reshape(-1)
    return frame, flat


def _port_frame(data, through_ac: bool = False):
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    if through_ac:
        frame.decode_all_sections(br, "cpu")
        return frame
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(frame.header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    frame.decode_hf_global(sections[frame.section_index("hf_global")])
    frame.finalize_lf()
    return frame


def carry_vardct_state(ref_frame, data, flat=None):
    """The port's render inputs from jxl_tpu's parsed VarDCT state, as
    numpy: the frame's own headers (parsed by the port from the same
    bytes, chroma shifts included), and copies of the HF metadata maps, the
    LF image, the quantizer, the CfL parameters and the dequant tables. A
    decoder has no weights; this is what carries across. With `flat`, the
    dense coefficient buffer, the state also stands in for a decoded
    frame whose AC the host decoder gave (render/simple.py:vardct_planes
    takes it)."""
    from jxl_tpu_torch.api.frame import QuantizerParams
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.vardct.cfl import ColorCorrelationParams
    from jxl_tpu_torch.vardct.quant_weights import DequantMatrices

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    shell = parse_frame(br, fh)
    rg = ref_frame.lf_global
    ccp = rg.color_correlation_params
    return SimpleNamespace(
        header=shell.header,
        file_header=fh,
        hf_meta={k: np.array(v) for k, v in ref_frame.hf_meta.items()},
        lf_image=[np.array(p, dtype=np.float32) for p in ref_frame.lf_image],
        lf_device=None,  # the frame codes its own LF
        lf_global=SimpleNamespace(
            quant_params=QuantizerParams(rg.quant_params.global_scale, rg.quant_params.quant_lf),
            color_correlation_params=ColorCorrelationParams(
                ccp.color_factor, ccp.base_correlation_x, ccp.base_correlation_b,
                ccp.ytox_lf, ccp.ytob_lf),
            block_context_map=rg.block_context_map,
        ),
        hf_global=SimpleNamespace(dequant_matrices=DequantMatrices(
            [np.array(t) for t in ref_frame.hf_global.dequant_matrices.tables])),
        restoration_filter=ref_frame.header.restoration_filter,
        host_ac_flat=None if flat is None else np.array(flat, dtype=np.int32),
        device_ac_flat=None,
        device_ac_ok=None,
    )


@pytest.mark.parametrize("name", list(STREAMS))
def test_device_render_matches_jxl_tpu(name):
    from jxl_tpu.vardct.device_frame import render_vardct_frame_device as ref_render

    from jxl_tpu_torch.render.stages.core import compute_sigma_image
    from jxl_tpu_torch.vardct.device_frame import render_vardct_frame_device

    data, _ = _stream(name)
    ref_frame, flat = _ref_frame(data)
    want = np.asarray(ref_render(ref_frame, device_flat=jnp.asarray(flat)))
    state = carry_vardct_state(ref_frame, data)
    got = render_vardct_frame_device(state, torch.from_numpy(flat)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(want).max() > 0.1  # real content
    from jxl_tpu.render.stages.core import compute_sigma_image as ref_sigma

    np.testing.assert_array_equal(compute_sigma_image(state), ref_sigma(ref_frame))


@pytest.mark.parametrize("name", list(STREAMS))
def test_parsed_state_matches_jxl_tpu(name):
    from jxl_tpu_torch import native

    data, coeffs = _stream(name)
    ref, flat = _ref_frame(data)
    got = _port_frame(data)
    np.testing.assert_array_equal(flat, coeffs)
    for k in ("ytox", "ytob", "raw_quant", "transform", "epf", "quant_lf"):
        np.testing.assert_array_equal(got.hf_meta[k], np.asarray(ref.hf_meta[k]))
    for c in range(3):
        np.testing.assert_array_equal(got.lf_image[c], np.asarray(ref.lf_image[c]))
    qg, qr = got.lf_global.quant_params, ref.lf_global.quant_params
    assert (qg.global_scale, qg.quant_lf) == (qr.global_scale, qr.quant_lf)
    assert qg.inv_global_scale == qr.inv_global_scale
    cg, cr = got.lf_global.color_correlation_params, ref.lf_global.color_correlation_params
    assert (cg.color_factor, cg.base_correlation_x, cg.base_correlation_b, cg.ytox_lf,
            cg.ytob_lf) == (cr.color_factor, cr.base_correlation_x, cr.base_correlation_b,
                            cr.ytox_lf, cr.ytob_lf)
    assert got.lf_global.block_context_map.context_map == ref.lf_global.block_context_map.context_map
    assert got.hf_global.num_histograms == ref.hf_global.num_histograms
    pg = native.pack_entropy(got.hf_global.passes[0].histograms)
    from jxl_tpu import native as ref_native

    pr = ref_native.pack_entropy(ref.hf_global.passes[0].histograms)
    for k in ("ans_tables", "context_map", "uint_configs"):
        np.testing.assert_array_equal(pg[k], pr[k])
    assert (pg["log_bucket"], pg["table_size"], pg["use_prefix"], pg["lz77"]) == (
        pr["log_bucket"], pr["table_size"], pr["use_prefix"], pr["lz77"])
    for t in range(17):
        np.testing.assert_array_equal(got.hf_global.dequant_matrices.tables[t],
                                      ref.hf_global.dequant_matrices.tables[t])


@pytest.mark.parametrize("fmt", ["f32", "u8"])
@pytest.mark.parametrize("route", ["lanes", "host"])
def test_decode_matches_jxl_tpu(route, fmt, monkeypatch):
    data, _ = _stream("mixed_520x136")
    want = ref_decode(data, pixel_format=fmt).frames[0]
    if route == "host":
        monkeypatch.setenv("JXL_TPU_AC", "host")
    else:
        monkeypatch.delenv("JXL_TPU_AC", raising=False)
    img = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu")
    got = img.frames[0]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (136, 520, 3) and got.dtype == want.dtype
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert d <= (1.0 if fmt == "u8" else 1e-4)


def test_both_ac_routes_give_the_writer_coefficients(monkeypatch):
    data, coeffs = _stream("dct8_300x200")
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    lanes = _port_frame(data, through_ac=True)
    assert lanes.host_ac_flat is None and bool(lanes.device_ac_ok.all())
    np.testing.assert_array_equal(lanes.device_ac_flat.numpy(), coeffs)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    host = _port_frame(data, through_ac=True)
    assert host.device_ac_flat is None
    np.testing.assert_array_equal(host.host_ac_flat, coeffs)


def test_lz77_ac_histograms_take_the_host_decoder(monkeypatch):
    """LZ77 in the AC histograms is a property of the stream the lane
    decoder does not take: the frame decodes through the host decoder,
    on either device."""
    from jxl_tpu_torch.vardct.device_group import eligible_for_device_ac

    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    data, coeffs = encode_xyb_vardct(300, 200, seed=43, density=0.15, lz77=True)
    frame = _port_frame(data, through_ac=True)
    assert not eligible_for_device_ac(frame)
    assert frame.device_ac_flat is None
    np.testing.assert_array_equal(frame.host_ac_flat, coeffs)
    want = ref_decode(data, pixel_format="f32").frames[0]
    got = jxl_tpu_torch.decode_image(data, device="cpu").frames[0].numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_chroma_subsampled_vardct_passes_the_frame_check():
    """A chroma-subsampled VarDCT header is in the slice now (its decodes
    are held against jxl_tpu in test_torch_layouts.py): its render
    pipeline cuts each shifted channel to its visible samples and
    upsamples it first, and no frame check is left to refuse anything."""
    from jxl_tpu_torch.api import simple
    from jxl_tpu_torch.render.pipeline import build_render_pipeline

    assert not hasattr(simple, "_check_frame")
    data, _ = _stream("dct8_300x200")
    frame = _port_frame(data)
    frame.header.jpeg_upsampling = [1, 0, 0]  # 4:2:0-style chroma shifts
    frame.header.maxhs = frame.header.maxvs = 1
    assert not frame.header.is444
    names = [s.name for s in build_render_pipeline(frame)]
    assert names[:6] == ["chroma_crop[1]", "chroma_upsample_h[1]", "chroma_upsample_v[1]",
                         "chroma_crop[2]", "chroma_upsample_h[2]", "chroma_upsample_v[2]"]


def test_lf_frame_vardct_raises(monkeypatch):
    """A VarDCT frame that reads an LF frame, which earlier slices refused:
    it passes the frame check and, behind its LF frame, decodes as
    jxl_tpu decodes it (f32 within 1e-4)."""
    from jxl_tpu_torch.io.headers.frame import Flags
    from test_torch_frame_streams import lf_frame_stream

    data, _ = _stream("dct8_300x200")
    header = _port_frame(data).header
    header.flags |= Flags.USE_LF_FRAME
    assert header.flags & Flags.USE_LF_FRAME
    stream = lf_frame_stream(300, 200, seed=43, density=0.1)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got = jxl_tpu_torch.decode_image(stream, device="cpu").frames[0].numpy()
    assert np.abs(got - ref_decode(stream).frames[0]).max() <= 1e-4


def test_corrupt_ac_section_raises_on_both_routes(monkeypatch):
    from jxl_tpu_torch.errors import JxlError

    data, _ = _stream("dct8_300x200")
    bad = bytearray(data)
    bad[-30] ^= 0xFF  # inside the last HF section
    for route in ("lanes", "host"):
        if route == "host":
            monkeypatch.setenv("JXL_TPU_AC", "host")
        else:
            monkeypatch.delenv("JXL_TPU_AC", raising=False)
        with pytest.raises(JxlError):
            jxl_tpu_torch.decode_image(bytes(bad), device="cpu")
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    assert os.environ.get("JXL_TPU_AC") is None
