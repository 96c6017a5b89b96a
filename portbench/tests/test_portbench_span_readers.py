"""The readers of the program's spans (metrics/parse_ms_per_image.py,
lane_plan_ms_per_image.py, render_queue_ms_per_image.py,
card_wait_ms_per_image.py) on a hand-built trace: only spans inside a
decode count, over the window's decodes; the render's wait on the card
comes off the render, a host-routed decode's render stays out; a trace
without the spans (a program that records none) reads None.

    python3 -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.trace import DECODE_SPAN, Trace  # noqa: E402

MS = 1_000_000  # ns


def _run(host: list, n_decodes: int = 2):
    r = run.Run(pool=[], decodes=[run.Decode(0, 0.1, 0.05) for _ in range(n_decodes)])
    r.trace = Trace((0, 1000 * MS), [], host)
    return r


def _decode(t0: int, *, host_route: bool = False) -> list:
    """One decode's spans from t0 (ms): headers 1, LfGlobal 1, LF groups
    3, HfGlobal 4, the lane plan 10, the render 20 with a wait of 5 in it
    (a host-routed decode: its render and nothing inside)."""
    def at(name, a, b):
        return (name, (t0 + a) * MS, (t0 + b) * MS)

    spans = [at(DECODE_SPAN, 0, 100), at("decode_image", 0, 90),
             at("decode_image.headers", 1, 2), at("frame.lf_global", 2, 3),
             at("frame.lf_groups", 3, 6), at("frame.hf_global", 6, 10),
             at("aten::add", 10, 11)]
    if host_route:
        return spans + [at("frame.render", 40, 60), at("render.host_route", 40, 60)]
    return spans + [at("frame.lane_plan", 10, 20), at("frame.k3_launch", 20, 25),
                    at("frame.render", 40, 60), at("render.blocks", 41, 43),
                    at("render.ac_wait", 50, 55)]


def _outside() -> list:
    """Program spans between decodes, which no reader counts."""
    return [(n, 700 * MS, 800 * MS) for n in (
        "decode_image.headers", "frame.lane_plan", "frame.render", "render.ac_wait")]


@pytest.mark.parametrize("name, want", [
    ("parse_ms_per_image", 1 + 1 + 3 + 4),
    ("lane_plan_ms_per_image", 10),
    ("render_queue_ms_per_image", 20 - 5),
    ("card_wait_ms_per_image", 5),
])
def test_span_readers_count_inside_decodes(name, want):
    reader = run.load_reader(name)
    assert reader.UNIT == "ms"
    r = _run(_decode(0) + _decode(200) + _outside())
    assert reader.read(r) == pytest.approx(want)


def test_render_queue_leaves_out_host_routed_decodes():
    reader = run.load_reader("render_queue_ms_per_image")
    r = _run(_decode(0) + _decode(200, host_route=True))
    assert reader.read(r) == pytest.approx((20 - 5) / 2)
    assert reader.read(_run(_decode(0, host_route=True))) is None


@pytest.mark.parametrize("name", ["parse_ms_per_image", "lane_plan_ms_per_image",
                                  "render_queue_ms_per_image", "card_wait_ms_per_image"])
def test_span_readers_read_none_without_spans(name):
    reader = run.load_reader(name)
    bare = [(DECODE_SPAN, 0, 100 * MS), ("aten::add", 10 * MS, 11 * MS),
            (DECODE_SPAN, 200 * MS, 300 * MS)]
    assert reader.read(_run(bare)) is None
    assert reader.read(_run(_outside())) is None
    r = _run(_decode(0))
    r.trace = None
    assert reader.read(r) is None
