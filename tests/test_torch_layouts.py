"""The port against jxl_tpu on the two VarDCT frame layouts of the
recompressed-JPEG and lossy-alpha files: chroma-subsampled YCbCr (4:2:0,
4:2:2, 4:4:0; DCT8 only, zero CfL, with or without filters) and XYB with an
8-bit alpha coded in each group's modular HF stream after its AC.

The same seeded writer bytes go through both packages: the chroma
upsampling stencils (bit for bit), the AC coefficients on both of the
port's routes (bit for bit), the subsampled render on carried-over state
(max abs 1e-5), and decode_image in every pixel format (f32 max abs 1e-4,
u8 and u16 at most 1, f16 at most one ulp of jxl_tpu's value). For the XYB
frame with alpha the f16 limit is one ulp or the f32 limit, whichever is
larger: near zero an f16 ulp is finer than the 1e-5 by which the two
packages' XYB colour paths already differ in f32.

jxl_tpu upsamples a subsampled channel over the VarDCT blocks' padding,
where ISO/IEC 18181-1 replicates the channel's visible edge, as the port
does (portbench/tests/test_portbench_ycbcr.py holds the port to a plain
reference of the format). So a subsampled decode is compared with
jxl_tpu under jxl_tpu's rule (jxl_tpu_chroma_edges), after the port's
own output is found equal to that away from the right and bottom
EDGE_BAND pixels (as_jxl_tpu_edges); the other test files that compare a
subsampled decode with jxl_tpu take these two from here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jxl_tpu_torch
from jxl_tpu.api.simple import decode_image as ref_decode

from test_torch_vardct import _port_frame, _ref_frame, carry_vardct_state
from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

STREAMS = {
    "ycbcr420": lambda: encode_ycbcr_vardct(520, 300, seed=61, density=0.1),
    "ycbcr422_no_filters": lambda: encode_ycbcr_vardct(520, 300, seed=62, subsampling="422",
                                                       density=0.1, filters=False),
    "ycbcr440": lambda: encode_ycbcr_vardct(300, 520, seed=63, subsampling="440", density=0.1),
    "ycbcr444": lambda: encode_ycbcr_vardct(300, 264, seed=64, subsampling="444", density=0.1),
    "vardct_alpha": lambda: encode_xyb_vardct(520, 300, seed=65, density=0.1, num_ec=1),
}
SUBSAMPLED = ["ycbcr420", "ycbcr422_no_filters", "ycbcr440"]
_CACHE = {}
# where the two chroma edge rules part: the last upsampled sample and what
# gaborish (1) and the EPF steps (3, 2, 1) spread it over
EDGE_BAND = 8


def jxl_tpu_chroma_edges(monkeypatch):
    """Give the port jxl_tpu's chroma edges until `monkeypatch` undoes it:
    its pipeline without the cut of each subsampled channel to its
    visible samples (the chroma_crop stages)."""
    from jxl_tpu_torch.render import pipeline

    real = pipeline.build_render_pipeline
    monkeypatch.setattr(pipeline, "build_render_pipeline", lambda frame: [
        s for s in real(frame) if not s.name.startswith("chroma_crop")])


def as_jxl_tpu_edges(decode, monkeypatch) -> np.ndarray:
    """decode()'s (H, W, C) image under jxl_tpu's chroma edges, once the
    port's own is found equal to it but in the right and bottom
    EDGE_BAND pixels, and apart there (the rule is in force)."""
    own = np.asarray(decode())
    with monkeypatch.context() as m:
        jxl_tpu_chroma_edges(m)
        theirs = np.asarray(decode())
    assert own.shape == theirs.shape
    np.testing.assert_array_equal(own[:-EDGE_BAND, :-EDGE_BAND],
                                  theirs[:-EDGE_BAND, :-EDGE_BAND])
    assert not np.array_equal(own, theirs)
    return theirs


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


def _diff(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))


@pytest.mark.parametrize("horizontal", [True, False])
def test_chroma_upsample_matches_jxl_tpu(horizontal):
    from jxl_tpu.render.stages import core as ref_core

    from jxl_tpu_torch.render.stages import core as port_core

    for shape in ((1, 1), (2, 3), (37, 65), (68, 130)):
        plane = np.random.default_rng(sum(shape)).normal(0.0, 0.3, shape).astype(np.float32)
        ref = ref_core.chroma_upsample_h if horizontal else ref_core.chroma_upsample_v
        port = port_core.chroma_upsample_h if horizontal else port_core.chroma_upsample_v
        want = ref(np, plane)
        got = port(torch.from_numpy(plane)).numpy()
        assert got.shape == want.shape == ((shape[0], 2 * shape[1]) if horizontal
                                           else (2 * shape[0], shape[1]))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["lanes", "host"])
@pytest.mark.parametrize("name", SUBSAMPLED)
def test_coefficients_match_jxl_tpu_on_both_routes(name, route, monkeypatch):
    data, coeffs = _stream(name)
    _, ref_flat = _ref_frame(data)
    np.testing.assert_array_equal(ref_flat, coeffs)
    if route == "host":
        monkeypatch.setenv("JXL_TPU_AC", "host")
    else:
        monkeypatch.delenv("JXL_TPU_AC", raising=False)
    frame = _port_frame(data, through_ac=True)
    if route == "host":
        assert frame.device_ac_flat is None
        got = frame.host_ac_flat
    else:
        assert frame.host_ac_flat is None and bool(frame.device_ac_ok.all())
        got = frame.device_ac_flat.numpy()
    np.testing.assert_array_equal(got, ref_flat)


def test_alpha_frame_decodes_group_by_group(monkeypatch):
    """The lane decoder refuses a frame whose groups carry modular HF
    channels; the host decodes each group's AC, then its alpha at the bit
    where the AC ended. The extra channel is the modular image's only
    buffer, at output index 3 + 0."""
    from jxl_tpu_torch.vardct.device_group import eligible_for_device_ac

    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    data, coeffs, alpha = _stream("vardct_alpha")
    _, ref_flat = _ref_frame(data)
    np.testing.assert_array_equal(ref_flat, coeffs)
    frame = _port_frame(data, through_ac=True)
    assert not eligible_for_device_ac(frame)
    assert frame.device_ac_flat is None
    np.testing.assert_array_equal(frame.host_ac_flat, ref_flat)
    mg = frame.lf_global.modular_global
    assert [info.output_channel_idx for info in mg.buffer_infos] == [3]
    np.testing.assert_array_equal(mg.storage[0].data, alpha)
    np.testing.assert_array_equal(mg.output_channel(3), alpha)


@pytest.mark.parametrize("name", SUBSAMPLED)
def test_subsampled_render_matches_jxl_tpu(name):
    """The port's subsampled render returns each channel at its own size;
    the pipeline's chroma stages bring it to the frame's, which must be
    jxl_tpu's in-program upsampled render."""
    from jxl_tpu.vardct.device_frame import render_vardct_frame_device_subsampled as ref_render

    from jxl_tpu_torch.render.pipeline import build_render_pipeline
    from jxl_tpu_torch.render.simple import vardct_planes
    from jxl_tpu_torch.vardct.device_frame import render_vardct_frame_device_subsampled

    data, _ = _stream(name)
    ref_frame, flat = _ref_frame(data)
    want = np.asarray(ref_render(ref_frame, device_flat=jnp.asarray(flat)))
    state = carry_vardct_state(ref_frame, data, flat)
    header = state.header
    assert not header.is444
    chans = render_vardct_frame_device_subsampled(state, torch.from_numpy(flat))
    H, W = want.shape[1:]
    assert [tuple(c.shape) for c in chans] == [
        (H >> header.vshift(c), W >> header.hshift(c)) for c in range(3)]
    # the entry the decode takes gives the same planes
    for a, b in zip(vardct_planes(state, torch.device("cpu")), chans):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    stages = [s for s in build_render_pipeline(state) if s.name.startswith("chroma_upsample")]
    assert len(stages) == sum(header.hshift(c) + header.vshift(c) for c in range(3))
    for s in stages:
        chans = s.fn(chans, {})
    got = torch.stack(chans).numpy()
    assert got.shape == want.shape
    assert _diff(got, want).max() <= 1e-5
    assert np.abs(want).max() > 0.05  # real content


def _check_format(got, want, fmt, xyb=False):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = _diff(got, want)
    if fmt == "f32":
        assert d.max() <= 1e-4
    elif fmt == "f16":
        ulp = np.spacing(np.abs(want.astype(np.float16))).astype(np.float64)
        assert (d <= (np.maximum(ulp, 1e-4) if xyb else ulp)).all()
    else:
        assert d.max() <= 1.0


@pytest.mark.parametrize("fmt", ["f32", "u8", "u16", "f16"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jxl_tpu(name, fmt, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")  # the lane route: the next test
    data = _stream(name)[0]
    want = np.asarray(ref_decode(data, pixel_format=fmt).frames[0])

    def decode():
        got = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        return got.numpy()

    got = as_jxl_tpu_edges(decode, monkeypatch) if name in SUBSAMPLED else decode()
    channels = 4 if name == "vardct_alpha" else 3
    assert want.shape[2] == channels
    _check_format(got, want, fmt, xyb=name == "vardct_alpha")


def test_subsampled_decode_through_the_lane_decoder(monkeypatch):
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    data = _stream("ycbcr420")[0]
    want = np.asarray(ref_decode(data, pixel_format="f32").frames[0])
    got = as_jxl_tpu_edges(
        lambda: jxl_tpu_torch.decode_image(data, device="cpu").frames[0].numpy(), monkeypatch)
    _check_format(got, want, "f32")


def test_alpha_is_the_coded_alpha():
    data, _, alpha = _stream("vardct_alpha")
    got = jxl_tpu_torch.decode_image(data, device="cpu").frames[0][..., 3].numpy()
    np.testing.assert_array_equal(got, alpha.astype(np.float32) * np.float32(1 / 255))
    u8 = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]
    np.testing.assert_array_equal(u8[..., 3].numpy(), alpha)


def test_ycbcr_channel_order_is_cb_y_cr(monkeypatch):
    """The colour transform reads the planes as (Cb, Y, Cr): a frame whose
    chroma is zero at LF and AC decodes to grey R = G = B."""
    from jxl_tpu_torch.render.simple import color_transform

    monkeypatch.setenv("JXL_TPU_AC", "host")
    frame = _port_frame(_stream("ycbcr420")[0], through_ac=True)
    y = torch.linspace(-0.4, 0.4, 12).reshape(3, 4)
    r, g, b = color_transform(frame, [torch.zeros(3, 4), y, torch.zeros(3, 4)])
    np.testing.assert_array_equal(r.numpy(), g.numpy())
    np.testing.assert_array_equal(g.numpy(), b.numpy())
    cb = torch.full((3, 4), 0.1)
    r, g, b = color_transform(frame, [cb, y, torch.zeros(3, 4)])
    assert (b - g).min().item() > 0.1 and np.allclose(r.numpy(), g.numpy() + 0.0344136, atol=1e-6)


@pytest.mark.parametrize("fault", ["items_dtype", "items_shape", "past_the_buffer"])
def test_native_vardct_ac_checks_its_buffers(fault):
    """The binding refuses buffers the C++ would read or write out of
    bounds, before any call."""
    from jxl_tpu_torch import native
    from jxl_tpu_torch.io.bit_reader import BitReader

    items = np.zeros((2, 11), np.int32)
    items[:, 4] = 64
    coeffs = np.zeros(3 * 64, np.int32)
    if fault == "items_dtype":
        items = items.astype(np.int64)
    elif fault == "items_shape":
        items = np.ascontiguousarray(items[:, :10])
    else:
        items[1, 8] = 3 * 64 - 32
    with pytest.raises(ValueError):
        native.decode_vardct_ac_native(BitReader(b"\0" * 8), {}, items, np.zeros(64, np.int32),
                                       coeffs, 0, 1, np.zeros(1, np.int32),
                                       np.zeros((3, 3), np.int32))


def test_multi_pass_frames_on_the_host_route_raise(monkeypatch):
    """More than one pass, AC the lane decoder does not take (here: an
    alpha in the groups' modular HF streams), which earlier slices refused
    on this route: each group's passes decode in turn into the writer's
    coefficients (the sum of each pass's shifted coefficients), and the
    alpha, coded in the last pass, comes back as written."""
    from test_torch_progressive import _port_frame_and_readers

    data, coeffs, alpha = encode_xyb_vardct(520, 300, seed=66, density=0.1, num_ec=1,
                                            passes=2)
    frame, readers = _port_frame_and_readers(data)
    assert frame.header.passes.num_passes == 2
    frame.decode_vardct_ac_on_host([(g, [(p, readers[(g, p)]) for p in range(2)])
                                    for g in range(frame.header.num_groups)], "cpu")
    np.testing.assert_array_equal(frame.host_ac_flat, coeffs)
    frame.lf_global.modular_global.run_transforms()
    np.testing.assert_array_equal(frame.modular_channel(3), alpha)