"""Per-frame render-stage assembly and the stages' bodies.

Counterpart of jxl_tpu/render/pipeline.py. Capability reference:
jxl/src/render/mod.rs:53-115 (stages with BORDER and SHIFT) and
frame/render.rs:506-885 (the per-frame conditional stage assembly). A
Stage is a function `fn(chans, ctx) -> list` over whole channel planes,
torch tensors on one device, with the halo it reads (`border`), the log2
upsampling it applies (`shift`) and the channels it touches. The filter
stages (gaborish, EPF) have no body of their own: render/span_exec.py runs
a run of them as one launch of the gaborish + EPF kernel
(render/device_filters.py:run_filters). The patch stage blends
rectangles of a reference slot onto the planes with gathers and scatters
built on the device from a host plan of the dictionary; the spline stage
splats the splines' segment table there, each segment's box expanded on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from ..utils import trace


@dataclass(frozen=True)
class Stage:
    """One render stage.

    border: input halo (bx, by) needed per output pixel (ref
        RenderPipelineInOutStage::BORDER, render/mod.rs:57).
    shift: log2 upsampling per axis (ref ::SHIFT): the stage consumes
        pixels at 1/2^shift of its output resolution.
    channels: indices of the channels the stage reads and writes.
    fn(chans: list, ctx) -> list: the stage body; returns a new list.
        None for the filter stages (gaborish, EPF).
    """

    name: str
    fn: Callable | None
    border: tuple = (0, 0)
    shift: tuple = (0, 0)
    channels: tuple = (0, 1, 2)

    @property
    def is_filter(self) -> bool:
        return self.fn is None


def total_border(stages) -> tuple:
    """Back-propagate BORDER through SHIFT to the pipeline's input
    resolution: the halo (in input pixels) a tiled executor needs to
    render a tile exactly (ref low_memory_pipeline/mod.rs:184-200).
    Walking from the last stage backwards, a stage with shift s divides
    the downstream border by 2^s (rounded up) and adds its own."""
    bx = by = 0
    for s in reversed(stages):
        sx, sy = s.shift
        bx = -(-bx // (1 << sx)) + s.border[0]
        by = -(-by // (1 << sy)) + s.border[1]
    return (bx, by)


# -- stage constructors ------------------------------------------------------
#
# Each mirrors one reference stage (file:line cited); constants are
# captured when the stage is built.


def gaborish_stage() -> Stage:
    """GaborishStage 3x3 (ref stages/gaborish.rs:11), BORDER (1,1)."""
    return Stage("gaborish", None, border=(1, 1))


def epf_stage(step: int) -> Stage:
    """Epf0/1/2Stage (ref stages/epf/epf{0,1,2}.rs), BORDER 3/2/1."""
    border = {0: 3, 1: 2, 2: 1}[step]
    return Stage(f"epf{step}", None, border=(border, border))


def upsample_stage(frame, n: int, channels) -> Stage:
    """Upsample2x/4x/8x (ref stages/upsample.rs:15-398): 5x5 per-phase
    kernels from CustomTransformData, BORDER (2,2), SHIFT (log2 n)."""
    from .stages import core as st

    kern = st.build_upsample_kernels(
        getattr(frame.file_header.transform_data, f"weights{n}"), n
    )
    s = {2: 1, 4: 2, 8: 3}[n]

    def fn(chans, ctx):
        out = list(chans)
        for c in channels:
            out[c] = st.upsample(out[c], kern, n)
        return out

    return Stage(f"upsample{n}x{list(channels)}", fn, border=(2, 2), shift=(s, s),
                 channels=tuple(channels))


def chroma_upsample_stage(channel: int, horizontal: bool) -> Stage:
    """HorizontalChromaUpsample / VerticalChromaUpsample (ref
    stages/chroma_upsample.rs:9,87): 2x along one axis of one channel,
    BORDER 1 and SHIFT 1 along that axis. Each call is a
    `render.chroma_upsample` span and, while tracing is on, one
    `chroma_upsample_passes`."""
    from .stages import core as st

    f = st.chroma_upsample_h if horizontal else st.chroma_upsample_v

    def fn(chans, ctx):
        with trace.span("render.chroma_upsample"):
            trace.metrics.add("chroma_upsample_passes")
            out = list(chans)
            out[channel] = f(out[channel])
        return out

    return Stage(f"chroma_upsample_{'h' if horizontal else 'v'}[{channel}]", fn,
                 border=(1, 0) if horizontal else (0, 1),
                 shift=(1, 0) if horizontal else (0, 1), channels=(channel,))


def chroma_crop_stage(channel: int, w: int, h: int) -> Stage:
    """A subsampled channel cut to its w x h visible samples, ceil(size /
    2^shift), before its upsampling: past them lie the VarDCT blocks'
    padding, which the upsampling must not read, since it replicates the
    channel's visible edge (ISO/IEC 18181-1; jxl_tpu's pipeline reads the
    padding)."""
    return replace(crop_stage(w, h, (channel,)), name=f"chroma_crop[{channel}]")


def crop_stage(w: int, h: int, channels) -> Stage:
    """Restrict channels to the visible rect (spec edge-extension point)."""

    def fn(chans, ctx):
        out = list(chans)
        for c in channels:
            out[c] = out[c][:h, :w]
        return out

    return Stage("crop", fn, channels=tuple(channels))


def noise_convolve_add_stage(frame) -> Stage:
    """ConvolveNoiseStage (BORDER 2) + AddNoiseStage (ref stages/noise.rs).
    The random field enters as ctx["noise_field"], (3, h, w) on the
    planes' device."""
    from ..features.noise import add_noise, convolve_noise

    noise = frame.lf_global.noise
    ccp = frame.lf_global.color_correlation_params

    def fn(chans, ctx):
        conv = [convolve_noise(p) for p in ctx["noise_field"]]
        out = list(chans)
        out[:3] = add_noise(out[:3], conv, noise, ccp)
        return out

    return Stage("noise", fn, border=(2, 2))


# -- patches -----------------------------------------------------------------


@dataclass(frozen=True)
class PatchGroup:
    """Patches of one layer that read one reference slot and share one
    blending descriptor: rows [first, first + count) of the plan's table,
    `pixels` pixels in all."""

    slot: int
    blending: tuple  # (colour PatchBlending, *extra-channel PatchBlendings)
    first: int
    count: int
    pixels: int


def patch_layers(rects, h: int, w: int) -> np.ndarray:
    """The layer of each patch, rects (n, 4) int64 [y, x, ph, pw] in
    dictionary order: 0 for a patch that overlaps no earlier one, else one
    more than the highest layer among the earlier patches it overlaps. So
    every patch lands in a later layer than each earlier patch it
    overlaps, and applying the layers in order, each as one scatter,
    gives the sequential result wherever patches overlap. (The first-fit
    layers of jxl_tpu/render/pipeline.py:_dense_patch_layers can place a
    patch before an earlier one it overlaps.)"""
    n = len(rects)
    layers = np.zeros(n, np.int64)
    # the highest layer + 1 that covers each pixel so far
    top = np.zeros((h, w), np.int32)
    for i, (y, x, ph, pw) in enumerate(rects.tolist()):
        region = top[y : y + ph, x : x + pw]
        layers[i] = region.max()
        region[...] = layers[i] + 1
    return layers


def patch_plan(frame, h: int, w: int, row0: int = 0, rows: int | None = None):
    """Host plan of the frame's patches on (h, w) planes, from the
    dictionary and the reference slots' shapes alone: (table, groups).
    table is (P, 5) int64, one row a patch: the flat index of its first
    pixel in the planes and in its slot's planes, its width, the index of
    its first pixel among its group's and its pixel count. groups: the
    PatchGroup list, in layer order. Each patch is clipped to the planes
    and to its slot, then to the row window [row0, row0 + rows) (the
    whole planes by default): the table then indexes (rows, w) planes
    that hold those rows, as a band of the banded decode does."""
    pd = frame.lf_global.patches
    refs = frame.decoder_state.reference_frames if frame.decoder_state else [None] * 4
    stride = pd.blendings_stride
    rows = h - row0 if rows is None else rows
    found = []  # y (in the window), x, ry, rx, ph, pw, slot, dictionary index
    for pi, pos in enumerate(pd.positions):
        rp = pd.ref_positions[pos.ref_pos_idx]
        ref_h, ref_w = refs[rp.reference]["frame"][0].shape
        y1 = pos.y + min(rp.ysize, h - pos.y, ref_h - rp.y0)
        pw = min(rp.xsize, w - pos.x, ref_w - rp.x0)
        y0, y1 = max(pos.y, row0), min(y1, row0 + rows)
        if y1 > y0 and pw > 0:
            found.append((y0 - row0, pos.x, rp.y0 + y0 - pos.y, rp.x0, y1 - y0, pw,
                          rp.reference, pi))
    if not found:
        return np.zeros((0, 5), np.int64), []
    r = np.array(found, np.int64)
    layers = patch_layers(r[:, [0, 1, 4, 5]], rows, w)
    descs = [tuple(pd.blendings[pi * stride : (pi + 1) * stride]) for pi in r[:, 7].tolist()]
    desc_ids = {d: i for i, d in enumerate(dict.fromkeys(descs))}
    key = np.array([desc_ids[d] for d in descs], np.int64)
    order = np.lexsort((key, r[:, 6], layers))
    r, layers, key = r[order], layers[order], key[order]
    by_id = list(desc_ids)
    ref_w = {s: refs[s]["frame"][0].shape[1] for s in set(r[:, 6].tolist())}
    table = np.empty((len(r), 5), np.int64)
    table[:, 0] = r[:, 0] * w + r[:, 1]
    table[:, 1] = r[:, 2] * np.array([ref_w[s] for s in r[:, 6].tolist()], np.int64) + r[:, 3]
    table[:, 2] = r[:, 5]
    px = r[:, 4] * r[:, 5]
    table[:, 4] = px
    groups = []
    cut = np.nonzero(np.diff(np.stack([layers, r[:, 6], key]), axis=1).any(axis=0))[0] + 1
    for a, b in zip(np.concatenate([[0], cut]).tolist(), np.concatenate([cut, [len(r)]]).tolist()):
        table[a:b, 3] = np.cumsum(px[a:b]) - px[a:b]
        groups.append(PatchGroup(int(r[a, 6]), by_id[int(key[a])], a, b - a, int(px[a:b].sum())))
    return table, groups


def patches_stage(frame, row0: int = 0, rows: int | None = None) -> Stage:
    """PatchesStage (ref stages/patches.rs; jxl_tpu/render/pipeline.py:551
    with its _patch_plan/_dense_patch_layers design, as gathers): the
    host plans the dictionary once (patch_plan); the plan's table goes up
    in one copy; for each group the device expands the table into each
    covered pixel's flat index in the planes and in the slot, gathers the
    foreground from the slot's tensor and the background from the planes,
    blends them with features/blending.py and scatters the result back.
    Patches of one layer cover disjoint pixels, and the layers run in
    order. Nothing goes back to the host. With a row window, the stage
    takes planes of rows [row0, row0 + rows) of the frame (a band of the
    banded decode) and applies each patch clipped to them;
    PatchesDictionary.apply_rows is the plain version. Each reference
    slot the plan reads moves to the planes' device once a stage (a frame
    on the host route reads slots that the card holds under
    JXL_TPU_DEVICE=off); a slot already there is used as it is."""
    from ..features.blending import perform_blending

    eci = frame.file_header.image_metadata.extra_channel_info
    num_c = 3 + len(eci)
    wc, hc = frame.header.size()
    rows = hc - row0 if rows is None else rows
    table, groups = patch_plan(frame, hc, wc, row0, rows)
    refs = frame.decoder_state.reference_frames if frame.decoder_state else [None] * 4
    slots = {}  # (device, slot) -> the slot's planes on that device

    def fn(chans, ctx):
        from .stages.core import to_device

        if not groups:
            return list(chans)
        dev = chans[0].device
        for g in groups:
            if (dev, g.slot) not in slots:
                slots[dev, g.slot] = refs[g.slot]["frame"].to(dev)
        tab = to_device(table, dev)
        img = torch.stack(chans[:num_c]).reshape(num_c, -1)
        for g in groups:
            t = tab[g.first : g.first + g.count]
            # the patch of each covered pixel; output_size keeps the
            # repeat off the host
            pid = torch.repeat_interleave(t[:, 4], output_size=g.pixels)
            local = torch.arange(g.pixels, device=dev) - t[pid, 3]
            w_p = t[pid, 2]
            ly = torch.div(local, w_p, rounding_mode="floor")
            lx = local - ly * w_p
            ref = slots[dev, g.slot]
            dst = t[pid, 0] + ly * wc + lx
            src = t[pid, 1] + ly * ref.shape[2] + lx
            fg = ref.reshape(ref.shape[0], -1)[:num_c, src]
            bg = img[:, dst]
            out = perform_blending(list(bg.unbind(0)), list(fg.unbind(0)), g.blending[0],
                                   g.blending[1:], eci)
            img[:, dst] = torch.stack(out)
        img = img.reshape(num_c, rows, wc)
        return list(img.unbind(0)) + list(chans[num_c:])

    return Stage("patches", fn, channels=tuple(range(num_c)))


# -- splines ---------------------------------------------------------------

# pixels of one splat step: bounds the step's index and value temporaries
# (about 80 bytes a pixel) on the device
SPLAT_CHUNK_PIXELS = 1 << 22


def spline_plan(table, h: int, w: int, row0: int = 0):
    """Host plan of the spline splat on (h, w) planes that hold rows
    [row0, row0 + h) of the frame (all of it by default; a band of the
    banded decode), from the (S, 8) float32 segment table
    (features/splines.py): (rows, boxes, chunks). rows is the table's
    segments whose box meets the planes; boxes is (n, 5) int64, a row a
    segment: x0, y0 (the frame's row), box width, pixel count and the
    index of its first pixel within its chunk; chunks is a list of (first
    segment, end segment, pixels), in segment order, each of at most
    SPLAT_CHUNK_PIXELS pixels unless one segment alone is larger. A box is
    rounded to even from the segment's float32 bounds and clipped to the
    planes, as jxl_spline_splat (native/modular_decode.cc) clips it."""
    cx, cy, md = table[:, 0], table[:, 1], table[:, 2]
    x0 = np.maximum(np.rint(cx - md).astype(np.int64), 0)
    x1 = np.minimum(np.rint(cx + md).astype(np.int64) + 1, w)
    y0 = np.maximum(np.rint(cy - md).astype(np.int64), row0)
    y1 = np.minimum(np.rint(cy + md).astype(np.int64) + 1, row0 + h)
    keep = (x1 > x0) & (y1 > y0)
    rows = table[keep]
    bw = (x1 - x0)[keep]
    px = bw * (y1 - y0)[keep]
    boxes = np.stack([x0[keep], y0[keep], bw, px, np.zeros_like(px)], 1)
    chunks = []
    a = 0
    while a < len(px):
        csum = np.cumsum(px[a:])
        b = a + max(1, int(np.searchsorted(csum, SPLAT_CHUNK_PIXELS, side="right")))
        boxes[a:b, 4] = csum[: b - a] - px[a:b]
        chunks.append((a, b, int(csum[b - a - 1])))
        a = b
    return rows, boxes, chunks


def splines_stage(frame, row0: int = 0, rows: int | None = None) -> Stage:
    """SplinesStage (ref stages/splines.rs; placed as
    jxl_tpu/render/pipeline.py:701-713 places it, after the patches): the
    host plans the segment table once (spline_plan), the table and the
    boxes go up in one copy, and for each chunk of segments the device
    expands every box into its pixels (repeat_interleave with output_size,
    as the patch stage expands patches: no wait for the card), evaluates
    the Gaussian brush with fast_erf in float32, in jxl_spline_splat's
    operation order, and index_adds the colour times it into the three
    planes. Each segment's term is bit-equal to the native splat's
    (jxl_spline_splat, the plain host version), but index_add_ does not
    add a pixel's segments in table order (on the card its atomic adds
    take any order), so a pixel may differ from the native splat by float
    rounding: the tests hold it within 1e-5. With a row window the stage
    takes planes of rows [row0, row0 + rows) of the frame, as
    patches_stage does; Splines.draw_rows is the plain version."""
    from ..features.splines import fast_erf

    wc, hc = frame.header.size()
    hc = hc - row0 if rows is None else rows
    segs, boxes, chunks = spline_plan(frame.lf_global.splines.table, hc, wc, row0)

    def fn(chans, ctx):
        from .stages.core import to_device_all

        if not chunks:
            return list(chans)
        dev = chans[0].device
        tab, box = to_device_all([segs, boxes], dev)
        planes = [p.reshape(-1) for p in chans[:3]]
        for a, b, pixels in chunks:
            t, bx = tab[a:b], box[a:b]
            sid = torch.repeat_interleave(bx[:, 3], output_size=pixels)
            local = torch.arange(pixels, device=dev) - bx[sid, 4]
            w_s = bx[sid, 2]
            ly = torch.div(local, w_s, rounding_mode="floor")
            x = bx[sid, 0] + local - ly * w_s
            y = bx[sid, 1] + ly
            s = t[sid]
            dx = x.to(torch.float32) - s[:, 0]
            dy = y.to(torch.float32) - s[:, 1]
            dist = torch.sqrt(dx * dx + dy * dy)
            inv_sigma = s[:, 3]
            f = (fast_erf((dist * 0.5 + 0.35355338) * inv_sigma)
                 - fast_erf((dist * 0.5 - 0.35355338) * inv_sigma))
            brush = s[:, 4] * f * f
            idx = (y - row0) * wc + x
            for c in range(3):
                planes[c].index_add_(0, idx, s[:, 5 + c] * brush)
        return [p.reshape(hc, wc) for p in planes] + list(chans[3:])

    return Stage("splines", fn)


def color_transform_stage(frame) -> Stage:
    """XybStage + FromLinearStage (or YCbCr) via render/simple.py."""

    def fn(chans, ctx):
        from .simple import color_transform

        return color_transform(frame, list(chans))

    return Stage("color_transform", fn)


def convert_output_stage(fmt: str, channels) -> Stage:
    """ConvertF32To{U8,U16,F16} (ref stages/convert.rs:549-790)."""
    from .stages import core as st

    def fn(chans, ctx):
        out = list(chans)
        for c in channels:
            out[c] = st.convert_output(out[c], fmt, channel=c)
        return out

    return Stage(f"convert_{fmt}", fn, channels=tuple(channels))


def build_render_pipeline(frame):
    """Per-frame stage assembly in reference order (ref
    frame/render.rs:506-885): chroma upsample (per subsampled channel,
    cut to its visible samples, its horizontal steps, then its vertical
    ones) -> visible crop -> gaborish
    -> EPF0/1/2 -> early EC upsample -> patches -> splines -> upsample ->
    upsampled crop -> noise. The colour transform and output conversion
    are appended by the caller."""
    header = frame.header
    meta = frame.file_header.image_metadata
    num_ec = len(meta.extra_channel_info)

    wc, hc = header.size()
    stages = []
    for c in range(3):
        hs, vs = header.hshift(c), header.vshift(c)
        if hs or vs:
            stages.append(chroma_crop_stage(c, -(-wc >> hs), -(-hc >> vs)))
        stages += [chroma_upsample_stage(c, True)] * hs
        stages += [chroma_upsample_stage(c, False)] * vs
    stages.append(crop_stage(wc, hc, (0, 1, 2)))
    rf = header.restoration_filter
    if rf.gab:
        stages.append(gaborish_stage())
    for step, need in ((0, 3), (1, 1), (2, 2)):
        if rf.epf_iters >= need:
            stages.append(epf_stage(step))

    late_ec_upsample = header.upsampling > 1 and all(
        u == header.upsampling for u in header.ec_upsampling
    )
    if not late_ec_upsample:
        for i, ec_up in enumerate(header.ec_upsampling):
            if ec_up > 1:
                stages.append(upsample_stage(frame, ec_up, (3 + i,)))
    if header.has_patches:
        stages.append(patches_stage(frame))
    if header.has_splines:
        stages.append(splines_stage(frame))
    if header.upsampling > 1:
        n_up = 3 + num_ec if late_ec_upsample else 3
        stages.append(upsample_stage(frame, header.upsampling, tuple(range(n_up))))

    wu, hu = header.size_upsampled()
    stages.append(crop_stage(wu, hu, tuple(range(3 + num_ec))))
    if header.has_noise:
        stages.append(noise_convolve_add_stage(frame))
    return stages


def sigma_source(frame):
    """(sigma_block, constant_sigma) of the EPF stages (ref
    render/pipeline.py:678-680): a VarDCT frame's per-block 1/sigma image
    ((bh, bw) float32 numpy), or a Modular frame's constant stored 1/sigma;
    (None, None) without EPF."""
    from ..io.headers.frame import Encoding
    from .stages import core as st

    rf = frame.header.restoration_filter
    if rf.epf_iters == 0:
        return None, None
    if frame.header.encoding == Encoding.VARDCT:
        return st.compute_sigma_image(frame), None
    return None, st.INV_SIGMA_NUM / rf.epf_sigma_for_modular
