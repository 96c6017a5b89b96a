"""Execution of a stage list over channel planes on their own device.

Counterpart of jxl_tpu/render/span_exec.py:run_span_device, which traces a
span of stages into one jit program and reads the result back to the
host. Here the stages run one after another as torch ops on the device
the planes lie on, and the planes stay there. A run of filter stages
(gaborish, EPF) is one call of render/device_filters.py:run_filters: the
hand-written kernel K1 on the card, its plain torch version on the CPU.

run_stages_host is the host render route's executor (ref
jxl_tpu/render/pipeline.py:run_stages and _run_filters_native, :53-130):
the same stages on CPU tensors, a run of filter stages one call of the
native filter chain (native/filters.cc) in place.
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


class _GabOnlyRf:
    """The EPF parameters the native chain reads when only gaborish runs
    (ref jxl_tpu/render/pipeline.py:_GabOnlyRf, :133): unused values."""

    epf_channel_scale = (40.0, 5.0, 3.5)
    epf_pass0_sigma_scale = 0.9
    epf_pass2_sigma_scale = 6.5
    epf_border_sad_mul = 2.0 / 3.0


# the native chain's epf_iters for each run of EPF steps a frame can have
_EPF_ITERS = {(): 0, (1,): 1, (1, 2): 2, (0, 1, 2): 3}


def run_filters_host(frame, chans, seg) -> list:
    """A run of filter stages `seg` over CPU tensors `chans`, the frame's
    planes cropped to its coded size: one call of the native gaborish +
    EPF chain (native.filter_chain_native), in place on the planes, which
    the host render owns; the copying call where the planes are not rows
    on one stride; the plain torch version (render/device_filters.py:
    run_filters on the CPU) where the chain declines the planes (under
    8x8)."""
    import numpy as np

    from .. import native
    from .device_filters import _gab_key, run_filters
    from .pipeline import sigma_source
    from .stages import core as st

    names = [s.name for s in seg]
    rf = frame.header.restoration_filter
    gab = _gab_key(rf) if "gaborish" in names else None
    steps = tuple(int(n[3]) for n in names if n.startswith("epf"))
    planes = [p.numpy() for p in chans[:3]]
    h, w = planes[0].shape
    inv_sigma = None
    if steps:
        sigma_block, constant = sigma_source(frame)
        inv_sigma = (sigma_block if sigma_block is not None else
                     np.full((-(-h // st.BLOCK_DIM), -(-w // st.BLOCK_DIM)), st.f32(constant),
                             np.float32))
    gw = None if gab is None else [v for pair in gab for v in pair]
    args = (inv_sigma, gw, _EPF_ITERS[steps], rf if steps else _GabOnlyRf(), True)
    out = native.filter_chain_native(planes, *args, in_place=True)
    if out is None:
        out = native.filter_chain_native(planes, *args)
    if out is None:
        return list(run_filters(frame, torch.stack(chans[:3])).unbind(0)) + list(chans[3:])
    return [torch.from_numpy(p) for p in out] + list(chans[3:])


def run_stages_host(stages, chans, ctx) -> list:
    """Run `stages` (list of pipeline.Stage) over CPU tensors `chans` by
    the host render route: each run of filter stages through
    run_filters_host, every other stage's own body (plain torch on the
    CPU). ctx as run_span's."""
    chans = list(chans)
    for seg in segments(stages):
        if seg[0].is_filter:
            chans = run_filters_host(ctx["frame"], chans, seg)
        else:
            chans = seg[0].fn(chans, ctx)
    return chans
