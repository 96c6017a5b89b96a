"""Whole-buffer decode entry point (non-streaming).

Counterpart of jxl_tpu/api/simple.py:decode_image and its per-frame
loop: an embedded ICC profile, then every frame of the file in order,
Modular or VarDCT (XYB or YCbCr, a VarDCT frame 4:4:4 or
chroma-subsampled, in one pass or several), upsampled or not, with or
without photon noise, extra channels, patches or splines; reference
frames and LF frames in the decoder state's slots, VarDCT frames that
take their LF from an LF frame, cropped and blended frames composited
onto the canvas, animations with their durations, a preview skipped.
An animation that render/batch_anim.py:batchable admits (small REPLACE
VarDCT frames, as jxl_tpu's batched route takes them) decodes on the
batched route unless JXL_TPU_BATCH_ANIM=off: K3 once over every frame's
AC lanes, each transform type once over every frame's blocks, K1 once a
frame, the colour transform and output conversion once (or, for
single-section frames, the whole-animation fold of render/anim_fold.py
decodes the sections and the AC in one C++ call); its frames equal the
per-frame loop's bit for bit. Host parse and entropy decode run in numpy
and C++ (native/); a VarDCT frame's AC coefficients are decoded on the
caller's device (api/frame.py), and the render, the slots and the
canvases stay there.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from ..errors import InvalidBox, JxlError
from ..io.bit_reader import BitReader
from ..io.container import extract_codestream_ex
from ..io.headers import FileHeader
from ..io.headers.frame import FrameHeader, FrameType, Toc
from ..render.simple import apply_orientation
from ..utils import devhealth, trace
from .frame import Frame
from .state import DecoderState

PIXEL_FORMATS = ("f32", "u8", "u16", "f16")
# JXL_TPU_BATCH_ANIM: "0" the fold where it takes the stream, then the
# batched render; "1" the batched render without the fold; "off" the
# per-frame loop
BATCH_ANIM_MODES = ("0", "1", "off")
BATCH_ANIM_DEFAULT = "0"
# groups (256x256 each) the batched route holds at once: its coefficient
# buffer, plane stack and canvases grow with them (958 MB of card memory at
# the peak for 48 frames of 512x512, 192 groups, on the H100; PERF.md), so
# a longer animation goes through in consecutive batches of whole frames
BATCH_ANIM_GROUPS = 256


@dataclass
class DecodedFrame:
    """decode_first_frame's result: the decoded Frame and its raw Modular
    channel planes, int32 tensors on the decode's device (the colour
    channels of a Modular frame, then the extra channels; a VarDCT frame's
    extra channels alone)."""

    frame: Frame
    channels: list


@dataclass
class DecodedImage:
    file_header: FileHeader
    frames: list  # visible frames: (h, w, c) tensors on the decode device (oriented)
    icc_profile: bytes | None = None  # the embedded profile, as coded
    durations: list = dfield(default_factory=list)  # ms a frame; 0.0 without animation
    # seconds of host parse + entropy decode of every frame ("host_s"); the
    # device render is queued asynchronously and not included. Frames with
    # noise add "noise_field_s", the host seconds of their random fields.
    timings: dict = dfield(default_factory=dict)

    def output_icc(self) -> bytes:
        """The profile of the output pixels: the embedded ICC profile of an
        image whose pixels are coded in its space, else one synthesized
        from the color encoding (ref JxlColorProfile::as_icc,
        api/color.rs:1201 + maybe_create_profile :768; jxl_tpu/api/
        simple.py:39-56). An XYB-coded image renders to sRGB whatever
        profile it embeds (color/output.py, as in jxl_tpu, which has no
        CMS), so its output profile is sRGB's; jxl_tpu returns the
        embedded profile for those sRGB pixels."""
        from ..color.icc_synth import synthesize_icc
        from ..io.headers import ColorSpace
        from ..io.headers.image import default_color_encoding

        meta = self.file_header.image_metadata
        if self.icc_profile is not None and not meta.xyb_encoded:
            return self.icc_profile
        enc = meta.color_encoding
        if enc.color_space == ColorSpace.XYB or (enc.want_icc and meta.xyb_encoded):
            # decoded output is sRGB when the encoding is XYB-only
            enc = default_color_encoding()
        return synthesize_icc(enc, meta.tone_mapping.intensity_target)


def parse_frame(br: BitReader, file_header: FileHeader, decoder_state=None,
                preview: bool = False) -> Frame:
    """The next frame's header and TOC. A preview frame (preview=True) is
    read at the preview's size and does not advance the frame counters
    that seed the noise RNG (ref jxl_tpu/api/simple.py:58-80)."""
    if preview:
        p = file_header.image_metadata.preview
        meta = file_header.image_metadata
        frame_header = FrameHeader.read_with(
            br,
            xyb_encoded=meta.xyb_encoded,
            extra_channel_info=meta.extra_channel_info,
            have_animation=meta.animation is not None,
            have_timecode=meta.animation.have_timecodes if meta.animation else False,
            img_width=p.xsize,
            img_height=p.ysize,
        )
    else:
        frame_header = FrameHeader.read(br, file_header)
    toc = Toc.read(br, frame_header.num_toc_entries)
    if decoder_state is not None and not preview:
        if frame_header.is_visible:
            decoder_state.visible_frame_index += 1
            decoder_state.nonvisible_frame_index = 0
        else:
            decoder_state.nonvisible_frame_index += 1
    return Frame(frame_header, toc, file_header, decoder_state)


def duration_ms(header, meta) -> float:
    """A frame's duration in ms; 0.0 without an animation header."""
    if meta.animation is None:
        return 0.0
    return header.duration * 1000.0 * meta.animation.tps_denominator / meta.animation.tps_numerator


def finish_frame(frame, state, device, pixel_format: str = "f32", options=None, timings=None):
    """The per-frame work after a frame's sections are decoded, the same
    for decode_image and the streaming decoder (api/decoder.py): render
    every stage on `device` (render/simple.py:render_frame_channels), keep
    an LF frame's planes in its LF slot, keep a reference frame's planes
    in its slot before or after the colour transform as its header asks,
    run the colour transform, blend a cropped or blended frame onto the
    canvas (else crop to the image), and, for a visible frame, mix in the
    spot colours and premultiply (as `options` asks: render_spot_colors,
    premultiply_output; None keeps the defaults), convert to
    `pixel_format` and orient (unless options.apply_orientation is False)
    (ref jxl_tpu/api/simple.py:137-224, jxl_tpu/api/decoder.py:726-803).
    Returns the visible frame, an (H, W, C) tensor on `device`, or None
    for a frame that is not shown. A frame on the host render route
    (frame.render_host) that no reference slot keeps and that blends with
    nothing is finished on the host as well and goes to `device` once,
    the whole oriented frame in one copy (an LF frame's planes stay on the
    host, for the host-routed frames that adopt them); any other
    host-routed frame's planes go there in one copy after the render, for
    the slots and the canvas."""
    from ..render.simple import (apply_spot_and_premultiply, blend_and_extend,
                                 color_transform, render_frame_channels)
    from ..render.stages import core as st

    header = frame.header
    fh = frame.file_header
    on_host = (frame.render_host and not header.can_be_referenced
               and not header.needs_blending())
    with trace.span("frame.render"):
        planes, color_done, converted = render_frame_channels(
            frame, torch.device("cpu") if on_host else device, pixel_format, timings)
    if header.lf_level != 0:
        state.save_lf_frame(header.lf_level, planes)
    if header.frame_type == FrameType.LF_FRAME:
        # an LF frame is neither shown nor referenced, and never the last:
        # jxl_tpu's colour transform and crop of it go unused
        return None
    if header.can_be_referenced and header.save_before_ct:
        state.save_reference(header.save_as_reference, planes, True)
    if header.frame_type != FrameType.REFERENCE_ONLY and not color_done:
        planes = color_transform(frame, planes)
    if header.needs_blending():
        canvas = blend_and_extend(frame, planes)
    else:
        canvas = [p[: fh.ysize, : fh.xsize] for p in planes]
    if header.can_be_referenced and not header.save_before_ct:
        state.save_reference(header.save_as_reference, canvas, False)
    if not header.is_visible:
        return None
    canvas = apply_spot_and_premultiply(frame, canvas, options)
    if pixel_format != "f32" and not converted:
        canvas = [st.convert_output(p, pixel_format, channel=i, native=on_host)
                  for i, p in enumerate(canvas)]
    arr = _interleave_host(canvas) if on_host else torch.stack(canvas, dim=-1)
    if options is None or options.apply_orientation:
        arr = apply_orientation(arr, fh.image_metadata.orientation)
    return arr.contiguous().to(device) if on_host else arr


def _interleave_host(planes):
    """CPU planes into one (h, w, c) tensor: the native one-pass interleave
    where it takes the dtype, else torch.stack."""
    from .. import native

    arr = native.interleave_native(planes)
    return torch.from_numpy(arr) if arr is not None else torch.stack(planes, dim=-1)


def scan_frames(codestream, start_bits: int, fh, ooo_ranges=()) -> list:
    """[(FrameHeader, Toc, first section bit)] of every frame from
    `start_bits` to the last, headers and TOCs only, read once per decode
    (jxl_tpu keeps such scans in a process-wide cache of mutable headers;
    here each decode reads its own). A frame that starts in an
    out-of-order jxlp box (`ooo_ranges`, byte ranges) raises InvalidBox,
    as the per-frame loop does."""
    br = BitReader(codestream)
    br.pos = start_bits
    recs = []
    while True:
        br.jump_to_byte_boundary()
        if any(lo <= br.pos // 8 < hi for lo, hi in ooo_ranges):
            raise InvalidBox("frame starts in out-of-order jxlp box")
        header = FrameHeader.read(br, fh)
        toc = Toc.read(br, header.num_toc_entries)
        br.jump_to_byte_boundary()
        recs.append((header, toc, br.pos))
        br.skip_bits(toc.total_size * 8)
        if header.is_last:
            return recs


def _try_batched_animation(fh, codestream, start_bits: int, ooo_ranges, icc_profile,
                           pixel_format: str, device, timings: dict):
    """The batched route for an animation batchable admits (counterpart
    of jxl_tpu/api/simple.py:_try_batched_animation, :233-377): the frames'
    headers are scanned once, their sections decode (the fold of
    render/anim_fold.py where JXL_TPU_BATCH_ANIM is "0" and it takes the
    stream, else render/batch_anim.py:decode_sections, K3 once over every
    frame's lanes), and render_frames_batched renders and composes every
    frame on `device`, BATCH_ANIM_GROUPS groups' worth of frames at a time
    (one K3 launch and one render a batch). Returns (frames, durations),
    the frames (H, W, C) tensors, oriented; or None, for the per-frame
    loop, when
    JXL_TPU_BATCH_ANIM=off, when the headers do not read (the loop then
    raises where they fail) or when batchable declines. timings["host_s"]
    gets every frame's parse."""
    from ..render.anim_fold import try_anim_fold
    from ..render.batch_anim import (batchable, decode_sections, fold_coefficients,
                                     render_frames_batched, render_frames_batched_host)
    from ..vardct.device_group import check_lane_flags

    mode = os.environ.get("JXL_TPU_BATCH_ANIM", BATCH_ANIM_DEFAULT)
    if mode not in BATCH_ANIM_MODES:
        raise ValueError(f"JXL_TPU_BATCH_ANIM must be one of {BATCH_ANIM_MODES}, not {mode!r}")
    if mode == "off" or fh.image_metadata.animation is None:
        return None
    t0 = time.perf_counter()
    try:
        recs = scan_frames(codestream, start_bits, fh, ooo_ranges)
    except InvalidBox:
        raise
    except JxlError:
        return None
    # the batched render colours every frame as frame 0 (one pass over the
    # stack), so frames that differ in YCbCr take the loop
    if not batchable(fh, recs) or len({h.do_ycbcr for h, _, _ in recs}) > 1:
        return None
    # the host render route (JXL_TPU_DEVICE=off, utils/devhealth.py): the
    # sections' AC on the host (or the fold's host coefficients),
    # render_frames_batched_host, the frames to `device` in one copy a batch
    host = devhealth.mode() == "off"
    batches, groups = [[]], 0
    for rec in recs:
        if batches[-1] and groups + rec[0].num_groups > BATCH_ANIM_GROUPS:
            batches.append([])
            groups = 0
        batches[-1].append(rec)
        groups += rec[0].num_groups
    meta = fh.image_metadata
    out_frames, durations = [], []
    for batch in batches:
        with trace.span("batch_anim.sections"):
            frames = (try_anim_fold(fh, codestream, batch, icc_profile,
                                    "cpu" if host else device)
                      if mode == "0" else None)
            if frames is not None:
                trace.metrics.add("batch_anim_route.fold", 1)
                flat, slots = fold_coefficients(frames, "cpu" if host else device)
                oks = []
            else:
                trace.metrics.add("batch_anim_route.sections", 1)
                frames, flat, slots, oks = decode_sections(fh, codestream, batch, icc_profile,
                                                           device, host=host)
        timings["host_s"] = timings.get("host_s", 0.0) + time.perf_counter() - t0
        with trace.span("batch_anim.render"):
            if host:
                trace.metrics.add("batch_anim_route.host", 1)
                out = render_frames_batched_host(frames, flat, slots, pixel_format).to(device)
            else:
                out = render_frames_batched(frames, flat, slots, pixel_format, device)
        check_lane_flags(oks)
        t0 = time.perf_counter()
        trace.metrics.add("batch_anim_frames", len(frames))
        out_frames += [apply_orientation(out[f], meta.orientation) for f in range(len(frames))]
        durations += [duration_ms(fr.header, meta) for fr in frames]
    return out_frames, durations


def decode_image(
    data: bytes, *, keep_all_frames: bool = True, pixel_format: str = "f32", device="cuda"
) -> DecodedImage:
    """Decode a whole .jxl file, every frame in order (ref
    jxl_tpu/api/simple.py:decode_image, its per-frame loop :137-224):
    Modular or VarDCT frames (a VarDCT frame 4:4:4 XYB or YCbCr, or
    chroma-subsampled YCbCr as a recompressed JPEG codes it; with extra
    channels or not; in one pass or several, as a progressive encoder
    writes it), reference frames kept in the decoder state's four slots,
    patches from a slot, splines, LF frames kept in the state's LF slots
    for the VarDCT frames that read their LF from them, cropped frames
    blended onto the canvas, animations and a skipped preview. An embedded
    ICC profile is read after the file header and kept in
    DecodedImage.icc_profile. Returns every visible frame, shape (H, W, 3
    + extra channels) in the requested sample type, with its duration in
    ms (0 without an animation header).

    keep_all_frames: taken as jxl_tpu takes it; every visible frame is
    returned either way, and the loop ends at the last frame.
    pixel_format: "f32" (default), "u8", "u16", or "f16" — the output sample
    format (ref JxlDataFormat + ConvertF32To* stages, convert.rs:549-).
    device: where the render runs and the frames, slots and canvases stay.
    "cuda" (the default) raises where no card is present; pass "cpu"
    explicitly to render with the plain torch versions on the host. A
    VarDCT frame's AC coefficients are decoded there too (kernel K3 on the
    card); set JXL_TPU_AC=host to decode them with the native host decoder
    instead. JXL_TPU_DEV_LOSSLESS=1 reconstructs a Modular frame's
    channel-static streams on `device` (the lossless lanes,
    modular/device_lossless.py); 0 and auto (the default) on the host.
    DecodedImage.timings["host_s"] sums the host parse and entropy decode
    of every frame. JXL_TPU_BATCH_ANIM chooses the route of an animation
    render/batch_anim.py:batchable admits: "0" (the default) the
    whole-animation fold where it takes the stream, then the batched
    render; "1" the batched render without the fold; "off" the per-frame
    loop (module docstring). JXL_TPU_DEVICE chooses where a frame renders
    (utils/devhealth.py): "on" on `device`; "off" by the host render
    route, the native C++ on the host, the finished frame then moved to
    `device` in one copy; "auto" (the default) by the host route for a
    small VarDCT still on the card, else on `device`."""
    if pixel_format not in PIXEL_FORMATS:
        raise ValueError(f"unknown pixel format {pixel_format!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "decode_image: no CUDA device is available; pass device='cpu' "
            "to render on the host"
        )
    t_start = time.perf_counter()
    with trace.span("decode_image"):
        out = _decode_frames(data, keep_all_frames, pixel_format, device)
    if trace.enabled():
        # the traced rate is the card's: wait for the queued render first
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        trace.metrics.add("megapixels_decoded",
                          sum(f.shape[0] * f.shape[1] for f in out.frames) / 1e6)
        trace.metrics.add("decode_seconds", time.perf_counter() - t_start)
    return out


def _decode_frames(data: bytes, keep_all_frames: bool, pixel_format: str,
                   device: torch.device) -> DecodedImage:
    """decode_image's body: the headers, then the batched animation route
    or every frame in order."""
    t0 = time.perf_counter()
    with trace.span("decode_image.headers"):
        codestream, ooo_ranges = extract_codestream_ex(data)
        br = BitReader(codestream)
        fh = FileHeader.read(br)
        meta = fh.image_metadata
        icc_profile = None
        if meta.color_encoding.want_icc:
            # right after the file header, before the preview (ref
            # jxl_tpu/api/simple.py:106-110)
            from ..icc.decode import read_icc

            icc_profile = read_icc(br)
        if meta.preview is not None:
            # skip the preview frame by its TOC size
            pframe = parse_frame(br, fh, None, preview=True)
            br.jump_to_byte_boundary()
            br.skip_bits(pframe.toc.total_size * 8)
    state = DecoderState(fh)
    out = DecodedImage(fh, [], icc_profile, [], {})
    host_s = time.perf_counter() - t0
    batched = _try_batched_animation(fh, codestream, br.pos, ooo_ranges, icc_profile,
                                     pixel_format, device, out.timings)
    if batched is not None:
        out.frames, out.durations = batched
        out.timings["host_s"] += host_s
        return out
    frames_seen = 0
    while True:
        t0 = time.perf_counter()
        with trace.span("decode_image.headers"):
            br.jump_to_byte_boundary()
            start_byte = br.pos // 8
            for lo, hi in ooo_ranges:
                if lo <= start_byte < hi:
                    # ref tests/api.rs:36-44: a frame must start in a box
                    # that is a valid checkpoint (physically in logical order)
                    raise InvalidBox("frame starts in out-of-order jxlp box")
            frame = parse_frame(br, fh, state)
        header = frame.header
        frame.render_host = devhealth.host_route(
            header, device, still=devhealth.is_still(fh, header, first=not frames_seen))
        frames_seen += 1
        with trace.span("decode_image.sections"):
            frame.decode_all_sections(br, device)
        host_s += time.perf_counter() - t0

        arr = finish_frame(frame, state, device, pixel_format, timings=out.timings)
        if arr is not None:
            out.frames.append(arr)
            out.durations.append(duration_ms(header, meta))
            if not keep_all_frames and header.is_last:
                break
        if header.is_last:
            break
    out.timings["host_s"] = host_s
    return out


def decode_first_frame(data: bytes, device="cuda") -> DecodedFrame:
    """The headers and the first frame of a .jxl file, decoded (ref
    jxl_tpu/api/simple.py:380-409): the embedded ICC profile read (kept as
    frame.icc_profile), a preview skipped, the first frame's sections
    decoded on `device` ("cuda" by default: a VarDCT frame's AC by K3
    there; "cpu" for the plain versions), and its raw Modular channel
    planes returned as int32 tensors on `device`, for bit-exact checks and
    for render/simple.py:render_frame."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "decode_first_frame: no CUDA device is available; pass device='cpu'")
    br = BitReader(extract_codestream_ex(data)[0])
    fh = FileHeader.read(br)
    icc_profile = None
    if fh.image_metadata.color_encoding.want_icc:
        from ..icc.decode import read_icc

        icc_profile = read_icc(br)
    state = DecoderState(fh)
    if fh.image_metadata.preview is not None:
        pframe = parse_frame(br, fh, None, preview=True)
        br.jump_to_byte_boundary()
        br.skip_bits(pframe.toc.total_size * 8)
    frame = parse_frame(br, fh, state)
    frame.icc_profile = icc_profile
    frame.decode_all_sections(br, device)
    idx = list(range(frame.modular_color_channels))
    idx += [3 + i for i in range(len(fh.image_metadata.extra_channel_info))]
    chans = [frame.modular_channel(c) for c in idx]  # a K6 plane is already a tensor
    return DecodedFrame(frame, [c.to(device) if isinstance(c, torch.Tensor)
                                else torch.from_numpy(np.ascontiguousarray(c)).to(device)
                                for c in chans])
