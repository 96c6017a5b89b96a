"""jxl_tpu_torch.decode_image (device="cpu") against jxl_tpu's decode_image
on writer streams with the single-frame feature stages: a 2x-upsampled
VarDCT frame with photon noise, Modular frames upsampled 4x and 8x, and
Modular frames with an alpha channel (upsampled early, late or not at all;
associated or not). f32 max abs 1e-4, u8 at most 1 LSB, the limits of the
frames without these stages. And what still raises NotSupported, and the
VarDCT headers (chroma-subsampled, extra channels) that no longer do.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.api.simple import decode_image as ref_decode
from mini_encoder import encode_constant_modular
from test_torch_render_stages import NOISE_LUT
from test_torch_streams import encode_xyb_modular
from test_torch_vardct_streams import encode_xyb_vardct

STREAMS = {
    "vardct_up2_noise": lambda: encode_xyb_vardct(264, 200, seed=31, density=0.05,
                                                  upsampling=2, noise=NOISE_LUT)[0],
    "modular_up4": lambda: encode_xyb_modular(300, 264, seed=32, upsampling=4)[0],
    "modular_up8": lambda: encode_xyb_modular(264, 260, seed=33, upsampling=8)[0],
    "modular_alpha": lambda: encode_xyb_modular(300, 264, seed=34, num_ec=1)[0],
    "modular_alpha_late_up2": lambda: encode_xyb_modular(300, 264, seed=35, num_ec=1,
                                                         upsampling=2)[0],
    "modular_alpha_early_ec2": lambda: encode_xyb_modular(300, 264, seed=36, num_ec=1,
                                                          ec_upsampling=2)[0],
    "modular_alpha_associated": lambda: encode_xyb_modular(300, 264, seed=37, num_ec=1,
                                                           alpha_associated=True)[0],
}
SHAPES = {
    "vardct_up2_noise": (400, 528, 3),
    "modular_up4": (1056, 1200, 3),
    "modular_up8": (2080, 2112, 3),
    "modular_alpha": (264, 300, 4),
    "modular_alpha_late_up2": (528, 600, 4),
    "modular_alpha_early_ec2": (264, 300, 4),
    "modular_alpha_associated": (264, 300, 4),
}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


def _max_diff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.mark.parametrize("fmt", ["f32", "u8"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jxl_tpu(name, fmt, monkeypatch):
    # the VarDCT AC through the native host decoder: the lane decoder's
    # plain version steps in Python (its route is the next test)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = _stream(name)
    want = ref_decode(data, pixel_format=fmt).frames[0]
    img = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu")
    got = img.frames[0]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == SHAPES[name] and got.dtype == want.dtype
    assert _max_diff(got, want) <= (1.0 if fmt == "u8" else 1e-4)
    assert ("noise_field_s" in img.timings) == name.endswith("noise")


def test_upsampled_noisy_vardct_through_the_lane_decoder(monkeypatch):
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    data = _stream("vardct_up2_noise")
    want = ref_decode(data, pixel_format="f32").frames[0]
    got = jxl_tpu_torch.decode_image(data, device="cpu").frames[0].numpy()
    assert _max_diff(got, want) <= 1e-4


def test_noise_and_upsampling_change_the_pixels(monkeypatch):
    """The noise stage and the upsampling weights act: the same coded
    frame without noise differs, and the upsampled frame is not a
    nearest-neighbour copy."""
    monkeypatch.setenv("JXL_TPU_AC", "host")
    noisy = jxl_tpu_torch.decode_image(_stream("vardct_up2_noise"), device="cpu").frames[0]
    quiet_data = encode_xyb_vardct(264, 200, seed=31, density=0.05, upsampling=2)[0]
    quiet = jxl_tpu_torch.decode_image(quiet_data, device="cpu").frames[0]
    assert (noisy - quiet).abs().max().item() > 1e-2
    up = jxl_tpu_torch.decode_image(_stream("modular_up4"), device="cpu").frames[0]
    assert (up[0::4, 0::4] - up[1::4, 1::4]).abs().max().item() > 1e-3


def test_alpha_is_the_coded_alpha():
    """Without upsampling the alpha channel is the writer's 8-bit samples
    over 255, associated or not."""
    for name in ("modular_alpha", "modular_alpha_associated"):
        data, planes = encode_xyb_modular(300, 264, seed=34 if name == "modular_alpha" else 37,
                                          num_ec=1, alpha_associated=name.endswith("associated"))
        got = jxl_tpu_torch.decode_image(data, device="cpu").frames[0][..., 3].numpy()
        np.testing.assert_array_equal(got, planes[3].astype(np.float32) * np.float32(1 / 255))
        u8 = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]
        np.testing.assert_array_equal(u8[..., 3].numpy(), planes[3])


@pytest.mark.parametrize("fmt", ["f32", "u8"])
def test_srgb_modular_with_alpha_matches_jxl_tpu(fmt):
    """A non-XYB 8-bit sRGB frame with an all-default alpha channel (the
    mini encoder's constant image), which earlier slices refused."""
    data = encode_constant_modular(300, 300, value=90, num_ec=1)
    want = ref_decode(data, pixel_format=fmt).frames[0]
    got = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0].numpy()
    assert got.shape == want.shape == (300, 300, 4) and got.dtype == want.dtype
    assert _max_diff(got, want) <= (1.0 if fmt == "u8" else 1e-4)


def _header(data):
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    return parse_frame(br, fh).header


@pytest.mark.parametrize("what,reason", [
    ("lf_frame", "LF frames"),
    ("splines", "splines"),
])
def test_frames_outside_the_slice_raise(what, reason, monkeypatch):
    """Frames that read an LF frame and frames with splines, which earlier
    slices refused, decode now (test_torch_progressive.py,
    test_torch_splines.py), and so does a chroma-subsampled Modular frame,
    the last one the frame check refused (test_torch_modular_subsampled.py):
    the check is gone, and such a frame's render pipeline, with either
    flag, cuts each subsampled channel to its visible samples and
    upsamples it before anything else."""
    from jxl_tpu_torch.api import simple
    from jxl_tpu_torch.features.splines import Splines
    from jxl_tpu_torch.io.headers.frame import Flags
    from jxl_tpu_torch.render import pipeline
    from test_torch_render_stages import port_frame

    assert not hasattr(simple, "_check_frame") and not hasattr(pipeline, "check_frame")
    frame = port_frame(_stream("modular_alpha_late_up2"), monkeypatch)
    frame.header.jpeg_upsampling = [1, 0, 0]  # channels 1 and 2 at half size
    frame.header.maxhs = frame.header.maxvs = 1
    frame.header.flags |= Flags.USE_LF_FRAME if what == "lf_frame" else Flags.ENABLE_SPLINES
    frame.lf_global.splines = Splines()
    names = [s.name for s in pipeline.build_render_pipeline(frame)]
    assert names[:6] == ["chroma_crop[1]", "chroma_upsample_h[1]", "chroma_upsample_v[1]",
                         "chroma_crop[2]", "chroma_upsample_h[2]", "chroma_upsample_v[2]"], reason
    assert ("splines" in names) == (what == "splines")


def test_patches_pass_the_frame_check():
    """Frames with patches, which earlier slices refused, decode (their
    decodes: test_torch_frames.py); no frame check is left to pass, and
    the header reads the flag."""
    from jxl_tpu_torch.api import simple
    from jxl_tpu_torch.io.headers.frame import Flags

    assert not hasattr(simple, "_check_frame")
    header = _header(_stream("vardct_up2_noise"))
    header.flags |= Flags.ENABLE_PATCHES
    assert header.has_patches


@pytest.mark.parametrize("what", ["chroma", "vardct_ec"])
def test_vardct_layouts_pass_the_frame_check(what):
    """Chroma-subsampled VarDCT frames and VarDCT frames with extra
    channels, which earlier slices refused, decode (test_torch_layouts.py);
    no frame check is left, and decode_banded's header rule takes such a
    VarDCT frame with extra channels but no chroma-subsampled one."""
    from jxl_tpu_torch.api import banded, simple
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    assert not hasattr(simple, "_check_frame")
    br = BitReader(_stream("vardct_up2_noise"))
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    frame.header.upsampling = 1
    assert banded.eligible_header(frame)
    if what == "chroma":
        frame.header.jpeg_upsampling = [1, 0, 0]
        assert not frame.header.is444
        assert not banded.eligible_header(frame)
    else:
        frame.header.num_extra_channels = 1
        assert banded.eligible_header(frame)


@pytest.mark.parametrize("what,reason", [
    ("splines", "splines"), ("chroma", "chroma-subsampled Modular frames")])
def test_render_pipeline_refuses_what_it_lacks(what, reason, monkeypatch):
    """A chroma-subsampled Modular frame, which earlier slices refused here,
    gets jxl_tpu's stage list, its chroma upsampling first, beside the
    port's cut of each subsampled channel to its visible samples; a frame with
    splines gets the spline stage after the filters and before the
    upsampling, as in jxl_tpu."""
    from jxl_tpu.api.simple import decode_first_frame
    from jxl_tpu.render.pipeline import build_render_pipeline as ref_pipeline
    from jxl_tpu_torch.features.splines import Splines
    from jxl_tpu_torch.io.headers.frame import Flags
    from jxl_tpu_torch.render.pipeline import build_render_pipeline
    from test_torch_render_stages import port_frame

    frame = port_frame(_stream("modular_alpha_late_up2"), monkeypatch)
    if what == "chroma":
        ref = decode_first_frame(_stream("modular_alpha_late_up2")).frame
        for h in (frame.header, ref.header):
            h.jpeg_upsampling = [1, 0, 0]  # channels 1 and 2 at half size
            h.maxhs = h.maxvs = 1
        got = [s.name for s in build_render_pipeline(frame)]
        want = [s.name for s in ref_pipeline(ref)[0]]
        # the port cuts each subsampled channel to its visible samples
        # first, which jxl_tpu does not (test_torch_layouts.py)
        assert got[:6] == ["chroma_crop[1]", "chroma_upsample_h[1]", "chroma_upsample_v[1]",
                           "chroma_crop[2]", "chroma_upsample_h[2]", "chroma_upsample_v[2]"]
        got = [n for n in got if not n.startswith("chroma_crop")]
        assert got[:4] == want[:4] == ["chroma_upsample_h[1]", "chroma_upsample_v[1]",
                                       "chroma_upsample_h[2]", "chroma_upsample_v[2]"], reason
        return
    frame.header.flags |= Flags.ENABLE_SPLINES
    frame.lf_global.splines = Splines()
    names = [s.name for s in build_render_pipeline(frame)]
    assert names.index(reason) == names.index("epf2") + 1
    assert names[names.index(reason) + 1].startswith("upsample2x")


def test_render_pipeline_places_the_patch_stage(monkeypatch):
    """A frame with patches, which earlier slices refused here, gets the
    patch stage after the filters and before the upsampling, as in
    jxl_tpu (its decodes: test_torch_frames.py)."""
    from jxl_tpu_torch.features.patches import PatchesDictionary
    from jxl_tpu_torch.io.headers.frame import Flags
    from jxl_tpu_torch.render.pipeline import build_render_pipeline
    from test_torch_render_stages import port_frame

    frame = port_frame(_stream("modular_alpha_late_up2"), monkeypatch)
    frame.header.flags |= Flags.ENABLE_PATCHES
    frame.lf_global.patches = PatchesDictionary([], [], [], 2)
    names = [s.name for s in build_render_pipeline(frame)]
    assert names.index("patches") == names.index("epf2") + 1
    assert names[names.index("patches") + 1].startswith("upsample2x")

