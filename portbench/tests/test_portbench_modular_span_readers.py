"""The readers of a lossless Modular decode's spans
(metrics/modular_groups_ms_per_image.py, modular_planes_ms_per_image.py)
on a hand-built trace: only spans inside a decode count, over the
window's decodes; a trace without the spans (a VarDCT decode, or a
program that records none) reads None.

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
READERS = ("modular_groups_ms_per_image", "modular_planes_ms_per_image")


def _run(host: list, n_decodes: int = 2):
    r = run.Run(pool=[], decodes=[run.Decode(0, 0.1, 0.05) for _ in range(n_decodes)])
    r.trace = Trace((0, 1000 * MS), [], host)
    return r


def _decode(t0: int) -> list:
    """One lossless decode's spans from t0 (ms): the group sections 70
    after the global section, then the planes 4 inside the render."""
    def at(name, a, b):
        return (name, (t0 + a) * MS, (t0 + b) * MS)

    return [at(DECODE_SPAN, 0, 100), at("decode_image", 0, 95), at("frame.lf_global", 1, 3),
            at("frame.lf_groups", 3, 4), at("frame.modular_groups", 4, 74),
            at("frame.render", 75, 92), at("render.modular_planes", 75, 79),
            at("render.stages", 79, 91), at("aten::mul", 76, 77)]


def _vardct_decode(t0: int) -> list:
    """A VarDCT decode's spans from t0 (ms), none of them Modular's."""
    def at(name, a, b):
        return (name, (t0 + a) * MS, (t0 + b) * MS)

    return [at(DECODE_SPAN, 0, 100), at("decode_image", 0, 90), at("frame.lf_groups", 3, 6),
            at("frame.render", 40, 80), at("render.blocks", 41, 47),
            at("render.stages", 57, 79), at("aten::add", 64, 65)]


@pytest.mark.parametrize("name, want", [("modular_groups_ms_per_image", 70),
                                        ("modular_planes_ms_per_image", 4)])
def test_modular_readers_count_inside_decodes(name, want):
    reader = run.load_reader(name)
    assert reader.UNIT == "ms"
    outside = [(n, 700 * MS, 800 * MS) for n in ("frame.modular_groups", "render.modular_planes")]
    r = _run(_decode(0) + _decode(200) + outside)
    assert reader.read(r) == pytest.approx(want)
    # two decodes in the window, the spans of one: over the two
    r = _run(_decode(0) + [(DECODE_SPAN, 400 * MS, 500 * MS)], n_decodes=2)
    assert reader.read(r) == pytest.approx(want / 2)


@pytest.mark.parametrize("name", READERS)
def test_modular_readers_read_none_without_spans(name):
    reader = run.load_reader(name)
    assert reader.read(_run(_vardct_decode(0) + _vardct_decode(200))) is None
    r = _run(_decode(0))
    r.trace = None
    assert reader.read(r) is None
