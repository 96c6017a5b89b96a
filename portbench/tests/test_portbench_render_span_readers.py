"""The readers of the chroma-subsampled render's spans
(metrics/block_render_ms_per_image.py, chroma_upsample_ms_per_image.py)
on a hand-built trace: only spans inside a decode count, over the
window's decodes; a trace without the spans (a program that records
none) reads None.

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
READERS = ("block_render_ms_per_image", "chroma_upsample_ms_per_image")


def _run(host: list, n_decodes: int = 2):
    r = run.Run(pool=[], decodes=[run.Decode(0, 0.1, 0.05) for _ in range(n_decodes)])
    r.trace = Trace((0, 1000 * MS), [], host)
    return r


def _decode(t0: int) -> list:
    """One 4:2:0 decode's spans from t0 (ms): the block tables 6 and the
    transforms 9 inside the render, then four chroma upsampling passes of
    1, 2, 1 and 2 inside the stages."""
    def at(name, a, b):
        return (name, (t0 + a) * MS, (t0 + b) * MS)

    return [at(DECODE_SPAN, 0, 100), at("decode_image", 0, 90), at("frame.lf_groups", 3, 6),
            at("frame.render", 40, 80), at("render.blocks", 41, 47),
            at("render.transforms", 47, 56), at("render.ac_wait", 56, 57),
            at("render.stages", 57, 79), at("render.chroma_upsample", 58, 59),
            at("render.chroma_upsample", 59, 61), at("render.chroma_upsample", 61, 62),
            at("render.chroma_upsample", 62, 64), at("aten::add", 64, 65)]


def _outside() -> list:
    """Program spans between decodes, which no reader counts."""
    return [(n, 700 * MS, 800 * MS) for n in (
        "render.blocks", "render.transforms", "render.chroma_upsample")]


@pytest.mark.parametrize("name, want", [("block_render_ms_per_image", 6 + 9),
                                        ("chroma_upsample_ms_per_image", 1 + 2 + 1 + 2)])
def test_render_readers_count_inside_decodes(name, want):
    reader = run.load_reader(name)
    assert reader.UNIT == "ms"
    r = _run(_decode(0) + _decode(200) + _outside())
    assert reader.read(r) == pytest.approx(want)
    # three decodes in the window, the spans of two: over the three
    r = _run(_decode(0) + _decode(200) + [(DECODE_SPAN, 400 * MS, 500 * MS)], n_decodes=3)
    assert reader.read(r) == pytest.approx(2 * want / 3)


@pytest.mark.parametrize("name", READERS)
def test_render_readers_read_none_without_spans(name):
    reader = run.load_reader(name)
    bare = [(DECODE_SPAN, 0, 100 * MS), ("aten::add", 10 * MS, 11 * MS),
            (DECODE_SPAN, 200 * MS, 300 * MS)]
    assert reader.read(_run(bare)) is None
    assert reader.read(_run(_outside())) is None
    r = _run(_decode(0))
    r.trace = None
    assert reader.read(r) is None
