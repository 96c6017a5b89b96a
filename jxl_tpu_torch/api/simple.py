"""Whole-buffer decode entry point (non-streaming), single frame.

Counterpart of jxl_tpu/api/simple.py:decode_image restricted to its
single-frame path: one visible Modular or VarDCT frame (XYB or YCbCr, a
VarDCT frame 4:4:4 or chroma-subsampled), upsampled or not, with or
without photon noise, with or without extra channels; no preview,
animation, ICC profile, patches or splines. Host
parse and entropy decode run in numpy and C++ (native/); a VarDCT frame's
AC coefficients are decoded on the caller's device (api/frame.py), and
the render runs there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dfield

import torch

from ..errors import NotSupported
from ..io.bit_reader import BitReader
from ..io.container import extract_codestream
from ..io.headers import FileHeader
from ..io.headers.frame import Encoding, FrameHeader, FrameType, Toc
from .frame import Frame
from .state import DecoderState

PIXEL_FORMATS = ("f32", "u8", "u16", "f16")


@dataclass
class DecodedImage:
    file_header: FileHeader
    frames: list  # visible frames: (h, w, c) tensors on the decode device (oriented)
    icc_profile: bytes | None = None
    durations: list = dfield(default_factory=list)
    # seconds of host parse + entropy decode ("host_s"); the device render
    # is queued asynchronously and not included. A frame with noise adds
    # "noise_field_s", the host seconds of its random field.
    timings: dict = dfield(default_factory=dict)

    def output_icc(self) -> bytes:
        """The output color profile, synthesized from the color encoding
        (ref JxlColorProfile::as_icc, api/color.rs:1201 + maybe_create_profile
        :768)."""
        from ..color.icc_synth import synthesize_icc
        from ..io.headers import ColorSpace
        from ..io.headers.image import default_color_encoding

        meta = self.file_header.image_metadata
        enc = meta.color_encoding
        if enc.color_space == ColorSpace.XYB:
            # decoded output is sRGB when the encoding is XYB-only
            enc = default_color_encoding()
        return synthesize_icc(enc, meta.tone_mapping.intensity_target)


def parse_frame(br: BitReader, file_header: FileHeader, decoder_state=None) -> Frame:
    frame_header = FrameHeader.read(br, file_header)
    toc = Toc.read(br, frame_header.num_toc_entries)
    if decoder_state is not None:
        if frame_header.is_visible:
            decoder_state.visible_frame_index += 1
            decoder_state.nonvisible_frame_index = 0
        else:
            decoder_state.nonvisible_frame_index += 1
    return Frame(frame_header, toc, file_header, decoder_state)


def _check_image(fh) -> None:
    meta = fh.image_metadata
    if meta.color_encoding.want_icc:
        raise NotSupported("ICC profiles are not in this package's slice")
    if meta.preview is not None:
        raise NotSupported("preview frames are not in this package's slice")
    if meta.animation is not None:
        raise NotSupported("animation is not in this package's slice")


def _check_frame(header) -> None:
    if header.encoding == Encoding.VARDCT and header.has_lf_frame:
        raise NotSupported("LF frames are not in this package's slice")
    if header.frame_type not in (FrameType.REGULAR, FrameType.SKIP_PROGRESSIVE):
        raise NotSupported(f"{header.frame_type.name} frames are not in this package's slice")
    if not header.is_last:
        raise NotSupported("more than one frame is not in this package's slice")
    if header.lf_level != 0:
        raise NotSupported("lf_level is not in this package's slice")
    if header.needs_blending():
        raise NotSupported("cropped or blended frames are not in this package's slice")
    if header.has_patches:
        raise NotSupported("patches are not in this package's slice")
    if header.has_splines:
        raise NotSupported("splines are not in this package's slice")


def decode_image(
    data: bytes, *, pixel_format: str = "f32", device="cuda"
) -> DecodedImage:
    """Decode a single-frame Modular or VarDCT .jxl file (a VarDCT frame
    4:4:4 XYB or YCbCr, or chroma-subsampled YCbCr as a recompressed JPEG
    codes it; with extra channels or not): frames of shape (H, W, 3 +
    extra channels), in the requested sample type.

    pixel_format: "f32" (default), "u8", "u16", or "f16" — the output sample
    format (ref JxlDataFormat + ConvertF32To* stages, convert.rs:549-).
    device: where the render runs and the frames are returned. "cuda" (the
    default) raises where no card is present; pass "cpu" explicitly to
    render with the plain torch versions on the host. A VarDCT frame's AC
    coefficients are decoded there too (kernel K3 on the card); set
    JXL_TPU_AC=host to decode them with the native host decoder instead.
    Streams outside this slice raise NotSupported with the reason."""
    if pixel_format not in PIXEL_FORMATS:
        raise ValueError(f"unknown pixel format {pixel_format!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "decode_image: no CUDA device is available; pass device='cpu' "
            "to render on the host"
        )
    from ..render.simple import apply_orientation, render_frame

    t0 = time.perf_counter()
    br = BitReader(extract_codestream(data))
    fh = FileHeader.read(br)
    _check_image(fh)
    state = DecoderState(fh)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh, state)
    _check_frame(frame.header)
    frame.decode_all_sections(br, device)
    host_s = time.perf_counter() - t0

    timings = {"host_s": host_s}
    planes = render_frame(frame, device, pixel_format, timings)
    planes = planes[:, : fh.ysize, : fh.xsize]
    arr = apply_orientation(planes.permute(1, 2, 0).contiguous(), fh.image_metadata.orientation)
    return DecodedImage(fh, [arr], None, [0.0], timings)
