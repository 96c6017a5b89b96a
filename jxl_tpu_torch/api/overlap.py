"""The band route of decode_image: the host parses band k+1 while the card
renders band k.

Counterpart of jxl_tpu/api/overlap.py (eligible :41, enabled :75,
try_decode :99). The whole-frame route queues the card's work only after
the host has parsed and entropy-decoded every section of the frame. Here
an eligible VarDCT frame decodes one GROUP ROW at a time: the band's AC
(kernel K3 over the band's lanes into a band-sized buffer, or the host
decoder), its render (vardct/device_band.py), then, once the next band's
render is queued, the previous band's filters (kernel K1 on its halo
slab), colour transform and output conversion
(render/device_band_filters.py), written into the output frame on the
card. Card work queues asynchronously, so one host thread is enough:
the host goes on to band k+1 while the card runs band k, and nothing in
the band loop waits for the card (the lane flags are read once, after
the last band). The reference's three host threads and its tunnel cost
model have no purpose here, and neither has its silent fallback: an
error in the band route reaches the caller.

The bands' rows are the whole-frame route's: the 8-row halo covers the
filters' 7-pixel support, bands start on a multiple of the 32x32 dither
tile, and a band's pixels come from the whole frame's per-block math.
"""

from __future__ import annotations

import os
import time

import torch

from ..io.headers.frame import Encoding, FrameType
from ..render.device_band_filters import dispatch_band_filters

_DTYPES = {"f32": torch.float32, "u8": torch.uint8, "u16": torch.uint16,
           "f16": torch.float16}


def eligible(frame) -> bool:
    """Header-only eligibility (ref jxl_tpu/api/overlap.py:41-72, less its
    tunnel rule on small frames): a 4:4:4 VarDCT frame, the last and
    visible REGULAR frame, at the image's size and origin, with no
    patches, splines, noise, extra channels, upsampling, blending or
    reference save, of more than one section and at least two group
    rows."""
    h = frame.header
    fh = frame.file_header
    if h.encoding != Encoding.VARDCT or not h.is444:
        return False
    if h.frame_type != FrameType.REGULAR or not h.is_last or not h.is_visible:
        return False
    if h.has_patches or h.has_splines or h.has_noise:
        return False
    if h.upsampling != 1 or any(u != 1 for u in h.ec_upsampling):
        return False
    if h.num_extra_channels != 0:
        return False
    if h.needs_blending() or h.can_be_referenced or h.lf_level != 0:
        return False
    if h.x0 != 0 or h.y0 != 0 or h.num_toc_entries == 1:
        return False
    if tuple(h.size()) != (fh.xsize, fh.ysize):
        return False
    return h.size_groups()[1] >= 2


def enabled() -> bool:
    """JXL_TPU_OVERLAP: "1" takes the band route for every eligible frame,
    "0" and "auto" (the default) never: on the H100 the band route was
    slower than the whole-frame route at every size measured (PERF.md),
    so no size rule exists yet, and the reference's TPU-tunnel cost model
    does not apply. The card probe (utils/devhealth.py) is not consulted:
    jxl_tpu routes here by device_fast and device_wins
    (jxl_tpu/api/overlap.py:75-97), which on a card on the bus would take
    this route, and the card's own measurement found it losing."""
    mode = os.environ.get("JXL_TPU_OVERLAP", "auto")
    if mode not in ("0", "1", "auto"):
        raise ValueError(f"JXL_TPU_OVERLAP must be 0, 1 or auto, not {mode!r}")
    return mode == "1"


def decode(frame, br, pixel_format: str, device):
    """Decode an eligible frame band by band on `device`, consuming `br`
    past the frame. Returns ((hv, wv, 3) tensor in `pixel_format` on the
    device, host seconds of its parse and entropy decode: LfGlobal, the LF
    groups, HfGlobal and each band's AC step). Errors raise; nothing falls
    back to the whole-frame route."""
    from ..render.pipeline import sigma_source
    from ..utils import trace
    from .banded import BandSource, band_slabs, decode_lf_sections

    t0 = time.perf_counter()
    header = frame.header
    sections = frame.split_sections(br)
    decode_lf_sections(frame, sections.__getitem__)
    source = BandSource(frame, sections.__getitem__, device)
    host_s = time.perf_counter() - t0
    wv, hv = source.wv, source.hv
    rf = header.restoration_filter
    sigma = sigma_source(frame) if rf.gab or rf.epf_iters else None
    out = torch.empty((hv, wv, 3), dtype=_DTYPES[pixel_format], device=torch.device(device))
    with trace.span("overlap.bands"):
        for gy, tail, cur, head, _ in band_slabs(source):
            y0 = gy * source.gdim
            out[y0 : y0 + cur.shape[1]] = dispatch_band_filters(frame, tail, cur, head, y0,
                                                                sigma, pixel_format)
    source.check()
    trace.metrics.add("overlap_bands", header.size_groups()[1])
    return out, host_s + source.host_s
