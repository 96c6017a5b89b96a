"""The program's own spans in a traced window, for the per-layer readers
that take them (metrics/*_ms_per_image.py): the host ranges that
jxl_tpu_torch/utils/trace.py puts on the profiler's timeline while it
collects, each counted only where it lies inside one decode's
DECODE_SPAN. A program that records no such span gives the readers
nothing to read, and they return None."""

from __future__ import annotations

import bisect

from portbench.trace import DECODE_SPAN


def in_decodes(run, names) -> list:
    """[(decode index, name, start, end)] of the host spans named in
    `names` that lie inside one decode of the window, the decodes indexed
    in time order."""
    if run.trace is None:
        return []
    decodes = sorted((s, e) for n, s, e in run.trace.host if n == DECODE_SPAN)
    out = []
    for n, s, e in run.trace.host:
        if n in names:
            i = bisect.bisect_right(decodes, (s, float("inf"))) - 1
            if i >= 0 and decodes[i][0] <= s and e <= decodes[i][1]:
                out.append((i, n, s, e))
    return out


def ms_per_decode(run, total_ns: float) -> float | None:
    """total_ns over the window's decodes, in ms."""
    return total_ns / 1e6 / len(run.decodes) if run.decodes else None


def span_ms_per_decode(run, names) -> float | None:
    """The summed length of the spans named in `names` inside the
    window's decodes, a decode, in ms; None where there are none."""
    spans = in_decodes(run, names)
    return ms_per_decode(run, sum(e - s for _, _, s, e in spans)) if spans else None
