"""Frame-parallel animation decode across processes.

Counterpart of jxl_tpu/parallel/multihost.py. An animation's frames are
expensive to decode (entropy, render, colour) and cheap to compose onto
the canvas, so rank r of N decodes frames r, r + N, r + 2N, ... on its
own device (the port's frame path: K3 for a VarDCT frame's AC on the
card, K1 for its filters), the frames' contents and their places on the
canvas go to every rank through World.all_gather as tensors, and every
rank composes the same canvases on its device, in order, as decode_image
does. Only animations whose frames stand alone are eligible: REGULAR
visible frames, none saved for later frames, no patches or LF frames,
every blend a REPLACE; anything else raises NotSupported and the caller
chooses what to run instead.

A frame placed at a negative offset shows the columns (and rows) of its
content that fall on the canvas, as decode_image's
render/simple.py:blend_and_extend shows them; jxl_tpu clamps the offset
to 0 and keeps the content's first columns (ROADMAP queue 3).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..errors import NotSupported
from ..io.bit_reader import BitReader
from ..io.container import extract_codestream
from ..io.headers import FileHeader
from ..io.headers.frame import BlendingMode, FrameType
from ..render.stages import core as st
from . import init_distributed  # noqa: F401  (jxl_tpu's name for the set-up)


def _scan_frames(data: bytes):
    """The file header, the codestream, and each frame's (header, byte
    offset, frame counters before it) in order: every rank parses the
    headers and TOCs alike (host work) and skips the sections. An ICC
    profile is read and a preview skipped, as decode_image does."""
    from ..api.simple import parse_frame
    from ..api.state import DecoderState

    codestream = extract_codestream(data)
    br = BitReader(codestream)
    fh = FileHeader.read(br)
    if fh.image_metadata.color_encoding.want_icc:
        from ..icc.decode import read_icc

        read_icc(br)
    if fh.image_metadata.preview is not None:
        pframe = parse_frame(br, fh, None, preview=True)
        br.jump_to_byte_boundary()
        br.skip_bits(pframe.toc.total_size * 8)
    state = DecoderState(fh)
    frames = []
    while True:
        br.jump_to_byte_boundary()
        start = br.pos // 8
        counters = (state.visible_frame_index, state.nonvisible_frame_index)
        frame = parse_frame(br, fh, state)
        br.jump_to_byte_boundary()
        br.skip_bits(frame.toc.total_size * 8)
        frames.append((frame.header, start, counters))
        if frame.header.is_last:
            break
    return fh, codestream, frames


def _pipeline_eligible(fh, frames) -> bool:
    """jxl_tpu's rule: an animation of visible REGULAR frames that no
    later frame reads (no reference save, patches or LF frames) and that
    blend, if at all, by REPLACE in every channel."""
    if fh.image_metadata.animation is None:
        return False
    for header, *_ in frames:
        if (header.frame_type != FrameType.REGULAR or not header.is_visible
                or header.can_be_referenced or header.has_patches or header.lf_level != 0
                or header.has_lf_frame):
            return False
        if header.needs_blending() and (
                header.blending_info.mode != BlendingMode.REPLACE
                or any(bi.mode != BlendingMode.REPLACE for bi in header.ec_blending_info)):
            return False
    return True


def _decode_one(fh, codestream: bytes, rec, device):
    """One frame's (C, h, w) float32 content on `device`, colour
    transformed, and its header: its sections decoded and every stage
    rendered as decode_image renders them (render/simple.py:
    render_frame_channels), with the frame counters it was parsed at."""
    from ..api.simple import parse_frame
    from ..api.state import DecoderState
    from ..render.simple import color_transform, render_frame_channels

    header, start, (vfi, nfi) = rec
    state = DecoderState(fh)
    state.visible_frame_index, state.nonvisible_frame_index = vfi, nfi
    br = BitReader(codestream)
    br.pos = start * 8
    frame = parse_frame(br, fh, state)
    br.jump_to_byte_boundary()
    frame.decode_all_sections(br, device)
    planes, color_done, _ = render_frame_channels(frame, device, "f32")
    if not color_done:
        planes = color_transform(frame, planes)
    return torch.stack(planes), frame


def decode_animation_multihost(data: bytes, world, pixel_format: str = "f32") -> list:
    """Decode an animation with its frames spread over the ranks of
    `world` (parallel/__init__.py:init_distributed): every rank returns
    every visible frame, (H, W, C) tensors on its device in
    `pixel_format`, decode_image's frames bit for bit. Raises
    NotSupported for a file that is not eligible (module docstring)."""
    from ..api.simple import PIXEL_FORMATS
    from ..render.simple import apply_orientation, apply_spot_and_premultiply

    if pixel_format not in PIXEL_FORMATS:
        raise ValueError(f"unknown pixel format {pixel_format!r}")
    fh, codestream, frames = _scan_frames(data)
    if not _pipeline_eligible(fh, frames):
        raise NotSupported("animation not eligible for multi-process pipelining")
    dev = world.device
    img_w, img_h = fh.xsize, fh.ysize
    n = len(frames)
    mine = list(range(world.rank, n, world.size))
    nc = 3 + len(fh.image_metadata.extra_channel_info)
    content = torch.zeros((len(mine), nc, img_h, img_w), dtype=torch.float32, device=dev)
    geo = torch.zeros((len(mine), 4), dtype=torch.int32)  # x0, y0, w, h on the canvas
    for slot, k in enumerate(mine):
        planes, frame = _decode_one(fh, codestream, frames[k], dev)
        h = frame.header
        fy, fx = planes.shape[1:]
        # the frame's rect on the canvas (render/simple.py:blend_and_extend)
        ix0, iy0 = max(h.x0, 0), max(h.y0, 0)
        ix1, iy1 = min(h.x0 + fx, img_w), min(h.y0 + fy, img_h)
        if ix1 > ix0 and iy1 > iy0:
            w_, h_ = ix1 - ix0, iy1 - iy0
            content[slot, :, :h_, :w_] = planes[:, iy0 - h.y0 : iy0 - h.y0 + h_,
                                                ix0 - h.x0 : ix0 - h.x0 + w_]
            geo[slot] = torch.tensor((ix0, iy0, w_, h_), dtype=torch.int32)
    contents = world.all_gather(content)
    geos = [g.cpu() for g in world.all_gather(geo.to(dev))]
    meta = SimpleNamespace(file_header=fh)  # what the spot-colour step reads of a frame
    out = []
    for k in range(n):
        p, slot = k % world.size, k // world.size
        x0, y0, w, h = geos[p][slot].tolist()
        canvas = torch.zeros((nc, img_h, img_w), dtype=torch.float32, device=dev)
        canvas[:, y0 : y0 + h, x0 : x0 + w] = contents[p][slot, :, :h, :w]
        chans = apply_spot_and_premultiply(meta, list(canvas.unbind(0)))
        chans = [st.convert_output(c, pixel_format, channel=i) for i, c in enumerate(chans)]
        out.append(apply_orientation(torch.stack(chans, dim=-1),
                                     fh.image_metadata.orientation))
    return out

