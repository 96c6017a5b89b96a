"""A band's filters, colour transform and output conversion on its device.

Counterpart of jxl_tpu/render/device_band_filters.py:dispatch_band_filters
(:55), for the banded decode (api/banded.py). A band is one group row of
the visible frame. Its gaborish + EPF run as one launch of kernel K1
(render/device_filters.py:run_filters) on the slab [the 8-row tail of band
k-1 | band k | the head of band k+1, up to 8 rows]: HALO = 8 covers the
7-pixel support of gaborish (1) and EPF (3 + 2 + 1), the slab starts on a
block row, and the filters mirror at the slab's edges exactly where they
mirror at the frame's, so the band's rows come out as the whole frame's.
The slab takes the band's rows of the block-resolution 1/sigma. The
colour transform is per pixel, and the u8 conversion's 32x32 dither tile
starts at the band's row in the image (pos), whatever the band height.
"""

from __future__ import annotations

import torch

from .device_filters import run_filters
from .stages import core as st

HALO = 8  # rows of real neighbour data each side (gaborish 1 + EPF 3+2+1)


def filter_band(frame, tail, cur, head, y0: int, sigma):
    """Gaborish + EPF of band `cur`, (3, rows, W) float32, the frame's
    rows [y0, y0 + rows), with `tail` the previous band's last HALO rows
    and `head` the next band's first rows (each (3, n, W), or None at the
    frame's top or bottom edge). sigma: render/pipeline.py:sigma_source of
    the frame, made once. Returns the band's filtered (3, rows, W) planes;
    `cur` itself when the frame has no filter."""
    rf = frame.header.restoration_filter
    if not rf.gab and rf.epf_iters == 0:
        return cur
    parts = [p for p in (tail, cur, head) if p is not None]
    top = 0 if tail is None else tail.shape[1]
    slab = torch.cat(parts, dim=1) if len(parts) > 1 else cur
    out = run_filters(frame, slab, y0 - top, sigma)
    return out[:, top : top + cur.shape[1]]


def color_and_convert(frame, chans, y0: int, pixel_format: str, x0: int = 0) -> list:
    """The colour transform of the first three of `chans` (float32 band
    planes, then the extra channels), the spot colours mixed in, then each
    channel in `pixel_format`, its dither tile placed at the planes' first
    pixel (x0, y0) in the image: a band's row, or a sharded tile's corner
    (render/simple.py:color_transform, apply_spot_and_premultiply;
    render/stages/core.py:convert_output)."""
    from .simple import apply_spot_and_premultiply, color_transform

    chans = color_transform(frame, list(chans))
    chans = apply_spot_and_premultiply(frame, chans)
    return [st.convert_output(p, pixel_format, channel=i, pos=(x0, y0))
            for i, p in enumerate(chans)]

