"""The batched animation route (render/batch_anim.py and
api/simple.py:_try_batched_animation) against the port's per-frame loop
and against jxl_tpu.

The same seeded writer bytes (test_torch_frame_streams.py) go through:
- the port's batched route (JXL_TPU_BATCH_ANIM "1", and "0", which tries
  the whole-animation fold first) and its per-frame loop ("off"): bit for
  bit, u8 and f32, durations too. Torch runs one CPU thread here: its CPU
  pow can round a sample apart by the sample's place in a thread's chunk.
  The AC decodes on the host (JXL_TPU_AC=host) in these comparisons, whose
  subject is the render; the lane cases run the plain K3 over every
  frame's merged lanes against the loop's host decode, at a low density
  (the plain version steps in Python);
- jxl_tpu.decode_image under its three JXL_TPU_BATCH_ANIM routes: u8 at
  most 1 LSB, f32 at most 1e-4 (PERF.md section 2's gate). On the stream
  with crops at negative offsets only jxl_tpu's per-frame loop is the
  reference: its batched routes clamp such a frame to the canvas edge and
  keep its first columns, and the test pins only that they differ there;
- render/batch_anim.py:batchable against jxl_tpu's, on every stream of
  the two writer files, those it declines too.

The comparison of K3 over several frames' lanes on the card carries the
`cuda` marker and skips here; chip_smoke.py's batched_anim phase runs it
on the H100.
"""

import os

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu_torch.render import batch_anim
from jxl_tpu_torch.utils import trace
from test_torch_frame_streams import (BLEND, REPLACE, TICKS, FrameSpec, _modular,
                                      anim_crop_replace_stream, anim_replace_stream,
                                      anim_rgba_stream, anim_vardct_stream, encode_frames,
                                      frame_sections, lf_frame_stream, patches_stream)
from test_torch_vardct_streams import encode_xyb_vardct

STREAMS = {
    "replace_320x200": lambda: anim_replace_stream(320, 200, 5, seed=8),
    "single_192x128": lambda: anim_replace_stream(192, 128, 4, seed=3),
    "crop_320x200": lambda: anim_crop_replace_stream(320, 200, (288, 96), 6, seed=2),
    "alpha_320x200": lambda: anim_replace_stream(320, 200, 4, seed=6, num_ec=1),
}
CHANNELS = {"alpha_320x200": 4}
_LOOP = {}


@pytest.fixture(scope="module")
def streams():
    return {name: make() for name, make in STREAMS.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode(data, mode, fmt):
    """decode_image on the CPU under JXL_TPU_BATCH_ANIM=mode, with the
    trace counters of the call."""
    old = os.environ.get("JXL_TPU_BATCH_ANIM")
    os.environ["JXL_TPU_BATCH_ANIM"] = mode
    trace.enable()
    trace.reset()
    try:
        img = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu")
        return img, dict(trace.metrics.counters)
    finally:
        trace.enable(False)
        if old is None:
            os.environ.pop("JXL_TPU_BATCH_ANIM")
        else:
            os.environ["JXL_TPU_BATCH_ANIM"] = old


def _loop(name, data, fmt):
    """The port's per-frame loop (host AC), decoded once a stream and format."""
    if (name, fmt) not in _LOOP:
        _LOOP[(name, fmt)] = _decode(data, "off", fmt)[0]
    return _LOOP[(name, fmt)]


def _same(got, want):
    assert got.durations == want.durations
    assert len(got.frames) == len(want.frames)
    for a, b in zip(got.frames, want.frames):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("fmt", ["u8", "f32"])
@pytest.mark.parametrize("mode", ["1", "0"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_batched_route_equals_per_frame_loop(name, mode, fmt, streams, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    want = _loop(name, streams[name], fmt)
    got, counters = _decode(streams[name], mode, fmt)
    assert counters["batch_anim_frames"] == len(want.frames)
    h, w = want.frames[0].shape[:2]
    assert all(f.shape == (h, w, CHANNELS.get(name, 3)) for f in got.frames)
    _same(got, want)


@pytest.mark.parametrize("name, groups, route, batches", [
    ("replace_320x200", 4, "sections", 3),  # 2 groups a frame: frames 2, 2 and 1
    ("single_192x128", 2, "fold", 2),  # the fold a batch: its own frame-0 oracle
])
def test_long_animation_goes_in_batches(name, groups, route, batches, streams, monkeypatch):
    from jxl_tpu_torch.api import simple

    monkeypatch.setenv("JXL_TPU_AC", "host")
    monkeypatch.setattr(simple, "BATCH_ANIM_GROUPS", groups)
    want = _loop(name, streams[name], "u8")
    got, counters = _decode(streams[name], "0", "u8")
    assert counters[f"batch_anim_route.{route}"] == batches
    assert counters["batch_anim_frames"] == len(want.frames)
    _same(got, want)


@pytest.mark.parametrize("size", [(264, 64), (128, 64)])
def test_batched_lanes_equal_per_frame_loop(size, monkeypatch):
    """K3's plain version over every frame's lanes in one call (2 groups
    a frame, or one single-section frame's one lane) against the loop's
    host AC decode."""
    data = anim_replace_stream(*size, 4, seed=11, density=0.05)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    want = _decode(data, "off", "f32")[0]
    monkeypatch.delenv("JXL_TPU_AC")
    got, counters = _decode(data, "1", "f32")
    assert counters["batch_anim_lane_frames"] == 4 and counters["batch_anim_route.sections"] == 1
    _same(got, want)


def _ref(data, mode, fmt):
    from jxl_tpu.api.simple import decode_image

    old = os.environ.get("JXL_TPU_BATCH_ANIM")
    os.environ["JXL_TPU_BATCH_ANIM"] = mode
    try:
        return decode_image(data, pixel_format=fmt)
    finally:
        if old is None:
            os.environ.pop("JXL_TPU_BATCH_ANIM")
        else:
            os.environ["JXL_TPU_BATCH_ANIM"] = old


def _close(got, want, fmt) -> float:
    assert got.durations == want.durations
    assert len(got.frames) == len(want.frames)
    diff = 0.0
    for a, b in zip(got.frames, want.frames):
        assert a.shape == b.shape
        diff = max(diff, float(np.abs(a.numpy().astype(np.float64) - b.astype(np.float64)).max()))
    return diff


# jxl_tpu's device route ("1") compiles a program a stream and format on
# the CPU (5-8 s each), so one stream takes it
REF_CASES = [(name, ref_mode, fmt)
             for name in ("replace_320x200", "single_192x128", "alpha_320x200")
             for ref_mode in ("off", "0") for fmt in ("u8", "f32")]
REF_CASES.append(("single_192x128", "1", "f32"))


@pytest.mark.parametrize("name, ref_mode, fmt", REF_CASES)
def test_batched_route_matches_jxl_tpu(name, ref_mode, fmt, streams, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    got, _ = _decode(streams[name], "0", fmt)
    want = _ref(streams[name], ref_mode, fmt)
    assert _close(got, want, fmt) <= (1.0 if fmt == "u8" else 1e-4)


@pytest.mark.parametrize("fmt", ["u8", "f32"])
def test_negative_offsets_match_jxl_tpu_per_frame_loop(fmt, streams, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = streams["crop_320x200"]
    got, counters = _decode(data, "0", fmt)
    assert counters["batch_anim_frames"] == 6
    assert _close(got, _ref(data, "off", fmt), fmt) <= (1.0 if fmt == "u8" else 1e-4)


def test_jxl_tpu_batched_routes_misplace_negative_offsets(streams, monkeypatch):
    """jxl_tpu's batched routes share one composition
    (jxl_tpu/api/simple.py:352-355), which places a frame at a negative x0
    at the canvas edge with its first columns (frame 1 of the stream, x0 =
    -36): its host route ("0") differs from its per-frame loop there, on
    that frame and not on the full frame 0. Nothing pins their pixels."""
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = streams["crop_320x200"]
    loop = _ref(data, "off", "f32")
    batched = _ref(data, "0", "f32")
    assert float(np.abs(batched.frames[1] - loop.frames[1]).max()) > 1e-2
    assert float(np.abs(batched.frames[0] - loop.frames[0]).max()) <= 1e-4


# -- eligibility ---------------------------------------------------------------------------


def _blend_animation():
    """Four 192x128 VarDCT frames with an alpha, the later three cropped
    and BLENDing with it."""
    def sections(s):
        return frame_sections(encode_xyb_vardct(192, 128, seed=s, density=0.05, num_ec=1)[0])

    frames = [FrameSpec(sections(0), "vardct", duration=TICKS,
                        ec_blend=((REPLACE, 0, False, 0),))]
    for k in range(1, 4):
        frames.append(FrameSpec(sections(k), "vardct", crop=(8 * k, 4 * k, 192, 128),
                                blend=(BLEND, 0, False, 0), ec_blend=((BLEND, 0, False, 0),),
                                duration=TICKS, is_last=k == 3))
    return encode_frames(192, 128, frames, num_ec=1, animation=(100, 1))


def _modular_animation():
    return encode_frames(320, 200, [FrameSpec(_modular(320, 200, k), "modular", duration=TICKS,
                                              is_last=k == 3) for k in range(4)],
                         animation=(100, 1))


BATCHABLE = {
    "replace_320x200": (lambda: anim_replace_stream(320, 200, 5, seed=8), True),
    "single_192x128": (lambda: anim_replace_stream(192, 128, 4, seed=3), True),
    "crop_320x200": (lambda: anim_crop_replace_stream(320, 200, (288, 96), 6, seed=2), True),
    "alpha_single_192x128": (lambda: anim_replace_stream(192, 128, 4, seed=5, num_ec=1), True),
    "three_frames": (lambda: anim_replace_stream(192, 128, 3, seed=4), False),
    "canvas_640x480": (lambda: anim_replace_stream(640, 480, 4, seed=4, density=0.02), False),
    "referenced_vardct": (lambda: anim_vardct_stream(320, 200, (288, 96), num_frames=5,
                                                     seed=3), False),
    "blend_alpha": (_blend_animation, False),
    "modular_replace": (_modular_animation, False),
    "rgba_modular_blend": (lambda: anim_rgba_stream(320, 200, (288, 96), num_frames=5, seed=4),
                           False),
    "patches_still": (lambda: patches_stream(512, 384, (320, 64), 40, 10, seed=6), False),
    "lf_frame_still": (lambda: lf_frame_stream(), False),
}


def _jxl_tpu_scan(data):
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader
    from jxl_tpu.io.headers.frame import FrameHeader, Toc

    br = BitReader(data)
    fh = FileHeader.read(br)
    recs = []
    while True:
        br.jump_to_byte_boundary()
        header = FrameHeader.read(br, fh)
        toc = Toc.read(br, header.num_toc_entries)
        br.jump_to_byte_boundary()
        recs.append((header, toc, br.pos))
        br.skip_bits(toc.total_size * 8)
        if header.is_last:
            return fh, recs


def _port_scan(data):
    from jxl_tpu_torch.api.simple import scan_frames
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    return fh, scan_frames(data, br.pos, fh)


@pytest.mark.parametrize("name", list(BATCHABLE))
def test_batchable_equals_jxl_tpu(name):
    from jxl_tpu.render.batch_anim import batchable as ref_batchable

    make, expect = BATCHABLE[name]
    data = make()
    fh, recs = _port_scan(data)
    ref_fh, ref_recs = _jxl_tpu_scan(data)
    assert [pos for *_, pos in recs] == [pos for *_, pos in ref_recs]
    assert batch_anim.batchable(fh, recs) == ref_batchable(ref_fh, ref_recs) == expect


# -- routing ---------------------------------------------------------------------------------


@pytest.mark.parametrize("batch, env, route", [
    ("0", {}, "fold"),
    # JXL_TPU_BATCH_ANIM is the one switch: the fold reads none of its own
    ("0", {"JXL_TPU_ANIM_FOLD": "0"}, "fold"),
    ("1", {}, "sections"),
    ("off", {}, None),
], ids=["0-fold", "0-fold-anim_fold_0", "1-sections", "off-loop"])
def test_environment_selects_the_route(batch, env, route, streams, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    img, counters = _decode(streams["single_192x128"], batch, "u8")
    assert len(img.frames) == 4
    routes = {k.split(".")[1] for k in counters if k.startswith("batch_anim_route.")}
    assert routes == ({route} if route else set())
    assert counters.get("anim_fold_frames", 0) == (4 if route == "fold" else 0)
    assert counters.get("batch_anim_frames", 0) == (0 if route is None else 4)


def test_unknown_batch_mode_raises(streams):
    with pytest.raises(ValueError, match="JXL_TPU_BATCH_ANIM"):
        _decode(streams["single_192x128"], "host", "u8")


def test_cuda_without_a_card_raises(streams):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the route runs there (chip_smoke.py)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jxl_tpu_torch.decode_image(streams["single_192x128"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    return torch.device("cuda")


def _merged_lanes(data):
    """K3's inputs over every frame's lanes of an animation in one launch,
    as render/batch_anim.py:decode_sections merges them."""
    from jxl_tpu_torch.api.frame import Frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.vardct import device_group

    fh, recs = _port_scan(data)
    br = BitReader(data)
    parts, slot = [], 0
    for header, toc, pos in recs:
        frame = Frame(header, toc, fh, None)
        br.pos = pos
        parts.append((device_group.lane_inputs(frame, frame.decode_vardct_head(br)), slot))
        slot += header.num_groups
    return device_group.merge_lane_inputs(parts, slot)


@pytest.mark.cuda
def test_k3_over_several_frames_matches_plain_version_on_card(cuda_device):
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS, run_lanes

    inp = _merged_lanes(anim_replace_stream(264, 64, 4, seed=11, density=0.05))
    before = device_ac.decode_ac_sections.launches
    got, ok = run_lanes(inp, cuda_device)
    assert device_ac.decode_ac_sections.launches == before + 1
    want, want_ok = device_ac.decode_ac_sections_reference(
        *(torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()
          if k not in LANE_KEYWORDS), **{k: inp[k] for k in LANE_KEYWORDS})
    assert torch.equal(got.cpu(), want) and torch.equal(ok.cpu(), want_ok) and bool(ok.all())
