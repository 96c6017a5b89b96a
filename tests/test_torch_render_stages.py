"""The port's feature stage bodies against jxl_tpu's on the same seeded
inputs: N-x upsampling (max abs 1e-5), the noise field (bit-equal to
jxl_tpu's and to a plain xorshift128+ walk), the noise convolution and add
(max abs 1e-6), and the stage lists (names, borders, shifts, channels,
total border) the two packages assemble for the writers' frames, chroma
upsampling of the subsampled YCbCr frames included.
"""

import numpy as np
import pytest
import torch

from jxl_tpu.api.simple import decode_first_frame
from jxl_tpu.features import noise as ref_noise
from jxl_tpu.render import pipeline as ref_pipeline
from jxl_tpu.render.stages import core as ref_core

from jxl_tpu_torch.features import noise as port_noise
from jxl_tpu_torch.render import pipeline as port_pipeline
from jxl_tpu_torch.render.stages import core as port_core
from test_torch_streams import encode_xyb_modular
from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

NOISE_LUT = (40, 90, 130, 200, 260, 330, 400, 470)

STREAMS = {
    "vardct_up2_noise": lambda: encode_xyb_vardct(264, 200, seed=21, density=0.05, upsampling=2,
                                                  noise=NOISE_LUT)[0],
    "vardct_noise": lambda: encode_xyb_vardct(300, 200, seed=22, density=0.05,
                                              noise=NOISE_LUT)[0],
    "vardct_plain": lambda: encode_xyb_vardct(300, 200, seed=23, density=0.05)[0],
    "modular_up4": lambda: encode_xyb_modular(300, 264, seed=5, upsampling=4)[0],
    "modular_up8": lambda: encode_xyb_modular(264, 260, seed=6, upsampling=8)[0],
    "modular_alpha": lambda: encode_xyb_modular(300, 264, seed=7, num_ec=1)[0],
    "modular_alpha_late": lambda: encode_xyb_modular(300, 264, seed=8, num_ec=1,
                                                     upsampling=2)[0],
    "modular_alpha_early": lambda: encode_xyb_modular(300, 264, seed=9, num_ec=1,
                                                      ec_upsampling=2)[0],
    "modular_alpha_up2_ec4": lambda: encode_xyb_modular(300, 264, seed=10, num_ec=1,
                                                        upsampling=2, ec_upsampling=4)[0],
    "ycbcr420": lambda: encode_ycbcr_vardct(300, 200, seed=11, density=0.05)[0],
    "ycbcr422_no_filters": lambda: encode_ycbcr_vardct(300, 200, seed=12, subsampling="422",
                                                       density=0.05, filters=False)[0],
    "ycbcr440": lambda: encode_ycbcr_vardct(300, 200, seed=13, subsampling="440",
                                            density=0.05)[0],
    "vardct_alpha": lambda: encode_xyb_vardct(300, 200, seed=14, density=0.05, num_ec=1)[0],
}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


def port_frame(data, monkeypatch):
    """The port's frame of a writer stream, parsed and decoded as
    decode_image does (frame counters included; host AC decoder)."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.api.state import DecoderState
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    monkeypatch.setenv("JXL_TPU_AC", "host")
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh, DecoderState(fh))
    frame.decode_all_sections(br, "cpu")
    return frame


def _weights(n, rng=None):
    """The default upsampling weights of CustomTransformData, or seeded
    random ones of the same count."""
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    w = getattr(FileHeader.read(BitReader(_stream("modular_alpha"))).transform_data,
                f"weights{n}")
    if rng is None:
        return list(w)
    return rng.normal(0.0, 0.3, len(w)).astype(np.float32).tolist()


@pytest.mark.parametrize("weights", ["default", "seeded"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_upsample_matches_jxl_tpu(n, weights):
    rng = np.random.default_rng(50 + n)
    w = _weights(n, rng if weights == "seeded" else None)
    kern = port_core.build_upsample_kernels(w, n)
    np.testing.assert_array_equal(kern, ref_core.build_upsample_kernels(w, n))
    for shape in ((37, 53), (1, 1), (2, 9)):
        plane = rng.normal(0.5, 0.2, shape).astype(np.float32)
        want = np.asarray(ref_core.upsample(np, plane, kern, n))
        got = port_core.upsample(torch.from_numpy(plane), kern, n)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5


def _plain_noise_field(wu, hu, up, group_dim, gx_count, gy_count, vfi, nfi):
    """The noise field from the port's Python xorshift128+, walking the
    groups, their upsampling subregions and rows as the reference does
    (ceil((width + 2) / 16) batches a row)."""
    out = np.zeros((3, hu, wu), np.float32)
    for gy in range(gy_count):
        for gx in range(gx_count):
            bx0, by0 = gx * up * group_dim, gy * up * group_dim
            bxs = min((gx + 1) * up * group_dim, wu) - bx0
            bys = min((gy + 1) * up * group_dim, hu) - by0
            for iy in range(up):
                for ix in range(up):
                    rng = port_noise.Xorshift128Plus(vfi, nfi, (gx * up + ix) * group_dim,
                                                     (gy * up + iy) * group_dim)
                    sx0, sy0 = ix * group_dim, iy * group_dim
                    sxs = min((ix + 1) * group_dim, bxs) - sx0
                    sys_ = min((iy + 1) * group_dim, bys) - sy0
                    if sxs <= 0 or sys_ <= 0:
                        continue
                    nbatch = -(-(sxs + 2) // 16)
                    for c in range(3):
                        for y in range(sys_):
                            bits = np.stack([rng.fill() for _ in range(nbatch)])
                            u32 = np.stack([bits & np.uint64(0xFFFFFFFF), bits >> np.uint64(32)],
                                           -1).astype(np.uint32).reshape(-1)
                            out[c, by0 + sy0 + y, bx0 + sx0 : bx0 + sx0 + sxs] = (
                                port_noise.bits_to_float(u32[:sxs]))
    return out


@pytest.mark.parametrize("name", ["vardct_up2_noise", "vardct_noise"])
def test_noise_field_bit_equal(name, monkeypatch):
    data = _stream(name)
    ref_frame = decode_first_frame(data).frame
    frame = port_frame(data, monkeypatch)
    assert frame.decoder_state.visible_frame_index == ref_frame.decoder_state.visible_frame_index
    assert frame.decoder_state.nonvisible_frame_index == 0
    got = port_noise.generate_noise_field(frame)
    want = np.stack(ref_noise.generate_noise_field(ref_frame))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    h = frame.header
    wu, hu = h.size_upsampled()
    plain = _plain_noise_field(wu, hu, h.upsampling, h.group_dim, *h.size_groups(),
                               frame.decoder_state.visible_frame_index, 0)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), plain.view(np.uint32))
    assert 1.0 <= float(got.min()) and float(got.max()) < 2.0


def test_xorshift_matches_jxl_tpu():
    a = port_noise.Xorshift128Plus(1, 0, 256, 512)
    b = ref_noise.Xorshift128Plus(1, 0, 256, 512)
    for _ in range(40):
        np.testing.assert_array_equal(a.fill(), b.fill())


def test_noise_lut_read_matches_jxl_tpu(monkeypatch):
    data = _stream("vardct_up2_noise")
    got = port_frame(data, monkeypatch).lf_global.noise.lut
    assert got == decode_first_frame(data).frame.lf_global.noise.lut
    assert got == [v / 1024.0 for v in NOISE_LUT]


@pytest.mark.parametrize("with_ccp", [True, False])
def test_convolve_and_add_noise_match_jxl_tpu(with_ccp):
    from jxl_tpu.vardct.cfl import ColorCorrelationParams as RefCcp

    from jxl_tpu_torch.vardct.cfl import ColorCorrelationParams

    rng = np.random.default_rng(61)
    h, w = 45, 67
    planes = [rng.normal(m, s, (h, w)).astype(np.float32)
              for m, s in ((0.0, 0.02), (0.5, 0.3), (0.4, 0.3))]
    field = rng.uniform(1.0, 2.0, (3, h, w)).astype(np.float32)
    lut = [v / 1024.0 for v in rng.integers(0, 1024, 8)]
    args = (84, 0.0, 1.0, 7, -5)
    ccp, ref_ccp = (ColorCorrelationParams(*args), RefCcp(*args)) if with_ccp else (None, None)
    conv = [port_noise.convolve_noise(torch.from_numpy(p)) for p in field]
    ref_conv = [ref_noise.convolve_noise(np, p) for p in field]
    for a, b in zip(conv, ref_conv):
        assert np.abs(a.numpy() - b).max() <= 1e-6
    got = port_noise.add_noise([torch.from_numpy(p) for p in planes], conv,
                               port_noise.Noise(lut), ccp)
    want = ref_noise.add_noise(np, planes, ref_conv, ref_noise.Noise(lut), ref_ccp)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - b).max() <= 1e-6
    assert max(float((a - torch.from_numpy(p)).abs().max()) for a, p in zip(got, planes)) > 1e-3
    vx = torch.from_numpy(rng.uniform(-0.5, 1.5, (h, w)).astype(np.float32))
    np.testing.assert_array_equal(port_noise.Noise(lut).strength(vx).numpy(),
                                  ref_noise.Noise(lut).strength(vx.numpy()))


def test_zero_noise_lut_leaves_planes():
    planes = [torch.full((4, 5), 0.5) for _ in range(3)]
    field = [torch.ones(4, 5)] * 3
    assert port_noise.add_noise(planes, field, port_noise.Noise(), None) is planes


@pytest.mark.parametrize("name", list(STREAMS))
def test_stage_lists_match_jxl_tpu(name, monkeypatch):
    data = _stream(name)
    ref_stages, ref_ctx = ref_pipeline.build_render_pipeline(decode_first_frame(data).frame)
    frame = port_frame(data, monkeypatch)
    stages = port_pipeline.build_render_pipeline(frame)

    def shape(ss):
        return [(s.name, tuple(s.border), tuple(s.shift), tuple(s.channels)) for s in ss]

    # jxl_tpu does not cut a subsampled channel to its visible samples
    # before upsampling it (test_torch_layouts.jxl_tpu_chroma_edges): the
    # port cuts each one once, first
    cuts = [s for s in stages if s.name.startswith("chroma_crop")]
    header = frame.header
    assert [s.channels for s in cuts] == [
        (c,) for c in range(3) if header.hshift(c) or header.vshift(c)]
    for s in cuts:
        (c,) = s.channels
        assert stages.index(s) < min(i for i, t in enumerate(stages)
                                     if t.name.startswith("chroma_upsample") and c in t.channels)
    assert shape([s for s in stages if s not in cuts]) == shape(ref_stages)
    assert port_pipeline.total_border(stages) == ref_pipeline.total_border(ref_stages)
    assert frame.header.has_noise == ref_ctx.get("needs_noise_field", False)
    assert [s.name for s in stages if s.is_filter] == [
        s.name for s in ref_stages if s.name in ("gaborish", "epf0", "epf1", "epf2")]


def test_total_border_walks_through_shifts():
    S = port_pipeline.Stage
    stages = [S("a", None, border=(3, 3)), S("up", None, border=(2, 2), shift=(1, 1)),
              S("b", None, border=(5, 2))]
    # b's 5 and 2 halve (rounded up) through the 2x stage: 3 + 2 + 3, 1 + 2 + 3
    assert port_pipeline.total_border(stages) == (8, 6)


def test_span_segments_join_each_run_of_filters():
    """run_span's pieces: a run of filter stages is one piece (one K1
    launch), every stage with a body a piece of its own."""
    from jxl_tpu_torch.render.span_exec import segments

    S = port_pipeline.Stage

    def body(chans, ctx):
        return chans

    span = [S("crop", body), S("gaborish", None), S("epf1", None), S("epf2", None),
            S("up", body), S("crop", body), S("epf0", None)]
    assert [[s.name for s in seg] for seg in segments(span)] == [
        ["crop"], ["gaborish", "epf1", "epf2"], ["up"], ["crop"], ["epf0"]]
    assert segments([]) == []


@pytest.mark.parametrize("premultiply", [False, True])
def test_spot_and_premultiply_match_jxl_tpu(premultiply):
    """Spot colours mix into the colour planes; premultiplication (asked
    for through the options) multiplies by the first straight alpha and
    leaves an associated one alone."""
    from types import SimpleNamespace

    from jxl_tpu.render.simple import apply_spot_and_premultiply as ref_apply

    from jxl_tpu_torch.io.headers import ExtraChannel
    from jxl_tpu_torch.render.simple import apply_spot_and_premultiply

    infos = [
        SimpleNamespace(ec_type=ExtraChannel.ALPHA, alpha_associated=True),
        SimpleNamespace(ec_type=ExtraChannel.SPOT_COLOR, spot_color=(0.9, 0.2, 0.4, 0.7)),
        SimpleNamespace(ec_type=ExtraChannel.ALPHA, alpha_associated=False),
    ]
    frame = SimpleNamespace(file_header=SimpleNamespace(
        image_metadata=SimpleNamespace(extra_channel_info=infos)))
    rng = np.random.default_rng(71)
    planes = [rng.uniform(0.0, 1.0, (9, 11)).astype(np.float32) for _ in range(6)]
    options = SimpleNamespace(premultiply_output=True) if premultiply else None
    want = ref_apply(frame, [p.copy() for p in planes], options)
    got = apply_spot_and_premultiply(frame, [torch.from_numpy(p) for p in planes], options)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - b).max() <= 1e-6
    assert np.abs(got[0].numpy() - planes[0]).max() > 1e-2
