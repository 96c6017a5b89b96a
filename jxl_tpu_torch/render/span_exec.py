"""Execution of a stage list over channel planes on their own device.

Counterpart of jxl_tpu/render/span_exec.py:run_span_device, which traces a
span of stages into one jit program and reads the result back to the
host. Here the stages run one after another as torch ops on the device
the planes lie on, and the planes stay there. A run of filter stages
(gaborish, EPF) is one call of render/device_filters.py:run_filters: the
hand-written kernel K1 on the card, its plain torch version on the CPU.
"""

from __future__ import annotations

import torch


def segments(span) -> list:
    """`span` cut into the pieces run_span runs one at a time: a run of
    filter stages together (one call of run_filters), every other stage
    alone."""
    out, i = [], 0
    while i < len(span):
        j = i + 1
        if span[i].is_filter:
            while j < len(span) and span[j].is_filter:
                j += 1
        out.append(span[i:j])
        i = j
    return out


def run_span(span, chans, ctx):
    """Run `span` (list of pipeline.Stage) over `chans` (list of 2-D
    float32 tensors on one device) and return the new list. ctx holds the
    per-frame data: "frame", and "noise_field", (3, h, w) on the planes'
    device, when a noise stage is in the span."""
    from .device_filters import run_filters

    chans = list(chans)
    for seg in segments(span):
        if seg[0].is_filter:
            chans[:3] = run_filters(ctx["frame"], torch.stack(chans[:3])).unbind(0)
        else:
            chans = seg[0].fn(chans, ctx)
    return chans
