"""The phase spans of jxl_tpu_torch's decode (utils/trace.py), on the CPU:

- under a collecting torch.profiler, a multi-group VarDCT decode on the
  lane route records each phase span once a frame, inside the root
  `decode_image` span, as host events at function scope (no user
  annotation, which the profiler would mirror onto the card's timeline);
  a Modular decode records its LfGlobal and LF group spans and none of
  the lane route's;
- with tracing off and no profiler, a decode opens no profiler range and
  leaves the registry empty; without the fast range class a profiler
  sees no span and the decode still runs;
- under JXL_TPU_DEVICE=off a frame records one `render.host_route` and
  no block tables of the card's render;
- the parse, lane-plan and K3-launch spans account for
  timings["host_s"] within 10%;
- under JXL_TPU_TRACE=1 the counter `lane_tables_built` counts each
  frame whose lane tables were built: 1 on the lane route, 0 on the host
  route, and still 1 when a streaming decode plans its lanes twice;
- a 4:2:0 YCbCr decode (a recompressed JPEG) records `render.blocks` and
  `render.transforms` once and `render.chroma_upsample` four times (Cb and
  Cr, each across and down) inside `frame.render`, and the counter
  `chroma_upsample_passes` reads 4; a 4:4:4 decode records no
  `render.chroma_upsample`; with tracing off the 4:2:0 decode opens no
  profiler range.
"""

from collections import Counter

import pytest
from torch.profiler import ProfilerActivity, profile

import jxl_tpu_torch
from jxl_tpu_torch.utils import trace
from test_torch_streams import encode_xyb_modular
from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

# each phase span of a single-frame decode on the lane route, and its
# count (the file's headers and the frame's header each take one
# `decode_image.headers`)
VARDCT_SPANS = {
    "decode_image": 1, "decode_image.headers": 2, "decode_image.sections": 1,
    "frame.lf_global": 1, "frame.lf_groups": 1, "frame.hf_global": 1,
    "frame.lane_plan": 1, "frame.k3_launch": 1, "frame.render": 1,
    "render.blocks": 1, "render.transforms": 1, "render.ac_wait": 1, "render.stages": 1,
}
MODULAR_SPANS = {
    "decode_image": 1, "decode_image.headers": 2, "decode_image.sections": 1,
    "frame.lf_global": 1, "frame.lf_groups": 1, "frame.render": 1, "render.stages": 1,
}
PARSE_SPANS = ("decode_image.headers", "frame.lf_global", "frame.lf_groups", "frame.hf_global")
PROGRAM_SPANS = set(VARDCT_SPANS) | {"render.host_route", "render.chroma_upsample"}


@pytest.fixture(scope="module")
def vardct():
    # two groups across, AC almost empty: the lane decoder's plain
    # version steps in Python on the CPU
    return encode_xyb_vardct(264, 16, seed=11, density=0.002)[0]


def _profiled(data):
    """(the decode, [(name, start ns, end ns, is a user annotation)] of
    the profiler's host events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu")
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return img, events


@pytest.fixture(scope="module")
def vardct_profiled(vardct):
    assert not trace.enabled()
    return _profiled(vardct)


def _spans(events):
    return [e for e in events if e[0] in PROGRAM_SPANS]


@pytest.mark.parametrize("kind", ["vardct", "modular"])
def test_phase_spans_nest_in_decode_image(kind, vardct_profiled):
    if kind == "vardct":
        img, events = vardct_profiled
        want = VARDCT_SPANS
    else:
        img, events = _profiled(encode_xyb_modular(264, 64, seed=12)[0])
        want = MODULAR_SPANS
    assert img.frames[0].shape[:2] == ((16, 264) if kind == "vardct" else (64, 264))
    spans = _spans(events)
    assert Counter(n for n, *_ in spans) == Counter(want)
    (root,) = [e for e in spans if e[0] == "decode_image"]
    assert all(root[1] <= s and e <= root[2] for _, s, e, _ in spans)
    assert not any(ua for *_, ua in events)
    render = next(e for e in spans if e[0] == "frame.render")
    for n, s, e, _ in spans:
        if n.startswith("render."):
            assert render[1] <= s and e <= render[2], n


def test_spans_cost_nothing_when_off(vardct, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} opened with tracing off")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    trace.enable(False)
    trace.reset()
    jxl_tpu_torch.decode_image(vardct, pixel_format="u8", device="cpu")
    assert trace.host_seconds() == {} and trace.metrics.counters == {}


def test_no_range_class_gives_the_profiler_nothing(vardct, monkeypatch):
    monkeypatch.setattr(trace, "_RecordFunctionFast", None)
    img, events = _profiled(vardct)
    assert img.frames[0].shape == (16, 264, 3) and _spans(events) == []


def test_host_route_records_its_span(vardct, monkeypatch):
    monkeypatch.setenv("JXL_TPU_DEVICE", "off")
    trace.enable(True)
    trace.reset()
    try:
        jxl_tpu_torch.decode_image(vardct, pixel_format="u8", device="cpu")
        rows = trace.report().splitlines()[1:]
    finally:
        trace.enable(False)
        trace.reset()
    spans = {r.split()[0]: int(r.split()[1]) for r in rows
             if not r.startswith(("counter ", "decode throughput"))}
    assert spans["render.host_route"] == 1 and spans["frame.render"] == 1
    assert not {"render.blocks", "render.transforms", "frame.lane_plan"} & set(spans)


def test_host_phases_account_for_host_s(vardct_profiled):
    img, events = vardct_profiled
    total = sum(e - s for n, s, e, _ in _spans(events)
                if n in PARSE_SPANS + ("frame.lane_plan", "frame.k3_launch")) / 1e9
    assert abs(total - img.timings["host_s"]) <= 0.1 * img.timings["host_s"]


def _stream_with_a_flush(data):
    """A streaming decode of `data`, 300 bytes at a time, with a flush at
    each frame progression: the flush launches the lanes of the sections
    queued so far, the frame's end those of the rest."""
    from jxl_tpu_torch.api import decoder as P

    d = P.JxlDecoder(P.JxlDecoderOptions(progressive_mode=P.ProgressiveMode.EAGER),
                     device="cpu")
    pos = 0
    for _ in range(10_000):
        ev = d.process()
        if ev is P.Event.COMPLETE:
            return d
        if ev is P.Event.NEED_MORE_INPUT:
            if pos >= len(data):
                d.end_input()
                continue
            d.feed(data[pos : pos + 300])
            pos += 300
        elif ev is P.Event.FRAME_PROGRESSION:
            d.flush_pixels()
    raise AssertionError("the streaming decode did not complete")


@pytest.mark.parametrize("route,built,plans", [("lanes", 1, 1), ("host", 0, 0),
                                                ("streaming", 1, 2)])
def test_lane_tables_built_counts_each_frame_once(route, built, plans, vardct, monkeypatch):
    data = vardct
    if route == "host":  # the route `auto` gives a still this small on the card
        monkeypatch.setenv("JXL_TPU_DEVICE", "off")
    elif route == "streaming":
        data = encode_xyb_vardct(264, 64, seed=91, density=0.03, passes=2)[0]
    trace.enable(True)
    trace.reset()
    try:
        if route == "streaming":
            _stream_with_a_flush(data)
        else:
            jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu")
        calls = {r.split()[0]: int(r.split()[1]) for r in trace.report().splitlines()[1:]
                 if not r.startswith(("counter ", "decode throughput"))}
        counted = trace.metrics.get("lane_tables_built")
    finally:
        trace.enable(False)
        trace.reset()
    assert counted == built
    assert calls.get("frame.lane_plan", 0) == plans


@pytest.fixture(scope="module")
def jpeg420():
    # a recompressed JPEG's frame: YCbCr 4:2:0, DCT8, two groups across
    return encode_ycbcr_vardct(264, 16, seed=13, density=0.002, filters=False)[0]


def test_subsampled_render_records_its_spans(jpeg420, vardct_profiled):
    img, events = _profiled(jpeg420)
    assert img.frames[0].shape == (16, 264, 3)
    spans = _spans(events)
    counts = Counter(n for n, *_ in spans)
    assert (counts["render.blocks"], counts["render.transforms"],
            counts["render.chroma_upsample"]) == (1, 1, 4)
    (render,) = [e for e in spans if e[0] == "frame.render"]
    for n, s, e, _ in spans:
        if n.startswith("render."):
            assert render[1] <= s and e <= render[2], n
    assert "render.chroma_upsample" not in {n for n, *_ in _spans(vardct_profiled[1])}


def test_chroma_upsample_passes_counts_each_pass(jpeg420):
    trace.enable(True)
    trace.reset()
    try:
        jxl_tpu_torch.decode_image(jpeg420, pixel_format="u8", device="cpu")
        counted = trace.metrics.get("chroma_upsample_passes")
    finally:
        trace.enable(False)
        trace.reset()
    assert counted == 4


def test_subsampled_spans_cost_nothing_when_off(jpeg420, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} opened with tracing off")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    trace.enable(False)
    trace.reset()
    img = jxl_tpu_torch.decode_image(jpeg420, pixel_format="u8", device="cpu")
    assert img.frames[0].shape == (16, 264, 3)
    assert trace.host_seconds() == {} and trace.metrics.counters == {}
