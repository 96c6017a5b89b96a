"""Streaming decoder: input fed in pieces, decoding resumable at any byte.

Counterpart of jxl_tpu/api/decoder.py (capability reference:
jxl/src/api/{decoder,inner/*}.rs, a typestate API driven by `process()`
returning Complete / NeedsMoreInput{size_hint}). Feed bytes with feed(),
and process() advances a stage machine and returns events. Every parsing
stage is resumable: on OutOfBounds the stage's cursor stays where it was,
and NEED_MORE_INPUT comes back with a byte hint in `bytes_needed`.

Sections decode once all their bytes (known from the TOC) have arrived
(api/frame.py:process_sections_incremental). A VarDCT frame that takes
the lane decoder queues its sections and launches K3 over the queue only
when pixels are needed: at the end of the frame, or at flush_pixels(). A
frame's finish is decode_image's (api/simple.py:finish_frame), so both
entry points give the same frames. Frames, previews and flushes are
tensors on the decoder's device: the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import copy
import enum
from dataclasses import dataclass

import torch

from ..errors import InvalidBitstream, InvalidBox, InvalidSignature, LimitExceeded, OutOfBounds
from ..io.bit_reader import BitReader
from ..io.container import CODESTREAM_SIG, CONTAINER_SIG
from ..io.headers import FileHeader
from ..io.headers.frame import Encoding, FrameType
from ..utils import trace
from .frame import Frame
from .state import DecoderState


class Event(enum.Enum):
    NEED_MORE_INPUT = "need_more_input"
    IMAGE_INFO = "image_info"
    FRAME_START = "frame_start"
    FRAME_PROGRESSION = "frame_progression"  # new flushable data (see progressive_mode)
    FRAME_DONE = "frame_done"
    COMPLETE = "complete"


class ProgressiveMode(enum.Enum):
    """When process() reports FRAME_PROGRESSION so that the caller can
    flush_pixels() (ref api/options.rs:16-44 JxlProgressiveMode)."""

    EAGER = "eager"  # whenever new sections decoded
    PASSES = "passes"  # when an AC pass completes across every group
    FULL_FRAME = "full_frame"  # never (whole frames only)


@dataclass
class JxlDecoderOptions:
    apply_orientation: bool = True
    render_spot_colors: bool = True
    coalescing: bool = True
    sample_limit: int | None = None
    high_precision: bool = False
    premultiply_output: bool = False
    scan_frames_only: bool = False
    skip_preview: bool = True
    pixel_format: str = "f32"  # "f32" | "u8" | "u16" | "f16"
    progressive_mode: ProgressiveMode = ProgressiveMode.FULL_FRAME


@dataclass(frozen=True)
class VisibleFrameSeekTarget:
    """Where to resume to reach a visible frame (ref api/decoder.rs:64-75):
    a codestream byte offset, and the visible frames to decode and drop
    before the target."""

    decode_start_offset: int
    visible_frames_to_skip: int


@dataclass(frozen=True)
class VisibleFrameInfo:
    """One visible frame found while decoding or scanning (ref
    api/decoder.rs:41-62)."""

    index: int
    duration_ms: float
    duration_ticks: int
    codestream_offset: int
    is_last: bool
    is_keyframe: bool
    seek_target: VisibleFrameSeekTarget
    name: str


class _FrameScanInfo:
    """Each frame's dependencies, for seeking (ref frame_scan_info.rs:
    18-168): per reference and LF slot, the earliest frame its content
    needs; a visible frame's seek target starts at the earliest frame any
    of its dependencies needs."""

    MAX_STORED_FRAMES = 4
    NUM_LF_FRAMES = 4

    def __init__(self):
        self.scanned: list[VisibleFrameInfo] = []
        self.visible_index = 0
        self.frame_starts: list[tuple[int, int]] = []  # (offset, visible frames before)
        self.ref_slot_start = [None] * self.MAX_STORED_FRAMES
        self.lf_slot_start = [None] * self.NUM_LF_FRAMES

    def record(self, header, animation, offset: int) -> None:
        cur = len(self.frame_starts)
        self.frame_starts.append((offset, self.visible_index))
        decode_start = cur
        used = [False] * self.MAX_STORED_FRAMES
        if header.needs_blending():
            for bi in [header.blending_info, *header.ec_blending_info]:
                used[bi.source] = True
        if header.has_patches:
            used = [True] * self.MAX_STORED_FRAMES
        for slot, u in enumerate(used):
            if u and self.ref_slot_start[slot] is not None:
                decode_start = min(decode_start, self.ref_slot_start[slot])
        if header.has_lf_frame:
            dep = self.lf_slot_start[header.lf_level]
            if dep is not None:
                decode_start = min(decode_start, dep)
        if header.is_visible:
            ticks = header.duration
            ms = 0.0
            if animation is not None and animation.tps_numerator > 0:
                ms = ticks * 1000.0 * animation.tps_denominator / animation.tps_numerator
            start_off, visible_before = self.frame_starts[decode_start]
            target = VisibleFrameSeekTarget(
                decode_start_offset=start_off,
                visible_frames_to_skip=self.visible_index - visible_before,
            )
            self.scanned.append(VisibleFrameInfo(
                index=self.visible_index, duration_ms=ms, duration_ticks=ticks,
                codestream_offset=offset, is_last=header.is_last,
                is_keyframe=target.visible_frames_to_skip == 0, seek_target=target,
                name=header.name,
            ))
            self.visible_index += 1
        if header.can_be_referenced:
            self.ref_slot_start[header.save_as_reference] = decode_start
        if header.lf_level != 0:
            self.lf_slot_start[header.lf_level - 1] = decode_start


@dataclass
class ImageInfo:
    width: int
    height: int
    num_extra_channels: int
    bits_per_sample: int
    have_animation: bool
    orientation: int
    preview_size: tuple[int, int] | None = None


class _BoxParser:
    """Streaming ISOBMFF box parser that hands on codestream bytes (ref
    api/inner/box_parser.rs): jxlc and jxlp boxes (jxlp parts received out
    of order are held and joined by their index), other boxes skipped,
    an unbounded last box running to the end of the input."""

    def __init__(self):
        self.mode = None  # None (undetected) | 'bare' | 'container'
        self.buf = bytearray()
        self.pos = 0  # bytes of buf consumed
        self.state = "signature"
        self.remaining = 0  # payload bytes left in the current box; -1 to the end
        self.current_box = None
        self.jxlp_parts = {}
        self._jxlp_complete = set()
        self._jxlp_ooo = set()  # part indices received out of physical order
        self.ooo_ranges = []  # codestream [start, end) ranges from such parts
        self.jxlp_pending_index = False
        self.codestream = bytearray()
        self.done = False
        self._jxlp_next = 0
        self._jxlp_index = 0

    def feed(self, data: bytes):
        self.buf.extend(data)
        self._advance()

    def finish(self):
        """No more input: an unbounded box ends here."""
        if self.mode == "bare":
            self.codestream.extend(self.buf[self.pos :])
            self.pos = len(self.buf)
        elif self.current_box in (b"jxlc", b"jxlp") and self.remaining == -1:
            if self.current_box == b"jxlp":
                self._jxlp_complete.add(self._jxlp_index)
                self._flush_jxlp()
            else:
                self.codestream.extend(self.buf[self.pos :])
            self.pos = len(self.buf)
        if self.jxlp_parts:
            # parts remain whose index order cannot be met: the file
            # interleaves jxlp boxes out of order (ref tests/api.rs:36-44)
            raise InvalidBox("out-of-order jxlp boxes")
        self.done = True

    def _advance(self):
        if self.mode is None:
            if len(self.buf) < 2:
                return
            if bytes(self.buf[:2]) == CODESTREAM_SIG:
                self.mode = "bare"
            elif bytes(self.buf[: min(len(self.buf), 12)]) == CONTAINER_SIG[: min(len(self.buf), 12)]:
                if len(self.buf) < 12:
                    return
                self.mode = "container"
                self.pos = 12
                self.state = "box_header"
            else:
                raise InvalidSignature("not a JPEG XL file")
        if self.mode == "bare":
            self.codestream.extend(self.buf[self.pos :])
            self.pos = len(self.buf)
            return
        while True:
            avail = len(self.buf) - self.pos
            if self.state == "box_header":
                if avail < 8:
                    return
                size = int.from_bytes(self.buf[self.pos : self.pos + 4], "big")
                btype = bytes(self.buf[self.pos + 4 : self.pos + 8])
                hdr = 8
                if size == 1:
                    if avail < 16:
                        return
                    size = int.from_bytes(self.buf[self.pos + 8 : self.pos + 16], "big")
                    hdr = 16
                self.pos += hdr
                self.current_box = btype
                self.remaining = (size - hdr) if size != 0 else -1
                self.jxlp_pending_index = btype == b"jxlp"
                self.state = "box_payload"
            elif self.state == "box_payload":
                if self.jxlp_pending_index:
                    if len(self.buf) - self.pos < 4:
                        return
                    idx = int.from_bytes(self.buf[self.pos : self.pos + 4], "big")
                    self.pos += 4
                    if self.remaining > 0:
                        self.remaining -= 4
                    self.jxlp_pending_index = False
                    self._jxlp_index = idx & 0x7FFFFFFF
                    # a box is a frame-start checkpoint only if it is in
                    # logical order with no later part pending (ref
                    # box_parser.rs:120-133 add_checkpoint)
                    if self._jxlp_index != self._jxlp_next or self.jxlp_parts:
                        self._jxlp_ooo.add(self._jxlp_index)
                avail = len(self.buf) - self.pos
                take = avail if self.remaining < 0 else min(avail, self.remaining)
                chunk = bytes(self.buf[self.pos : self.pos + take])
                streaming_part = (
                    self.current_box == b"jxlp"
                    and self._jxlp_index == self._jxlp_next
                    and self._jxlp_index not in self.jxlp_parts
                    and not any(k < self._jxlp_index for k in self.jxlp_parts)
                )
                if self.current_box == b"jxlc" or streaming_part:
                    # an in-order part streams straight into the codestream,
                    # so a partial frame can decode progressively
                    self.codestream.extend(chunk)
                elif self.current_box == b"jxlp":
                    self.jxlp_parts.setdefault(self._jxlp_index, bytearray()).extend(chunk)
                self.pos += take
                if self.remaining > 0:
                    self.remaining -= take
                if self.remaining == 0:
                    if self.current_box == b"jxlp":
                        if streaming_part:
                            self._jxlp_next += 1
                        else:
                            self._jxlp_complete.add(self._jxlp_index)
                        self._flush_jxlp()
                    self.state = "box_header"
                    continue
                return
            else:
                return

    def _flush_jxlp(self):
        # jxlp parts join the codestream in index order, each once its box
        # has been read whole
        while self._jxlp_next in self._jxlp_complete:
            part = self.jxlp_parts.pop(self._jxlp_next, b"")
            if self._jxlp_next in self._jxlp_ooo:
                self.ooo_ranges.append((len(self.codestream), len(self.codestream) + len(part)))
            self.codestream.extend(part)
            self._jxlp_complete.discard(self._jxlp_next)
            self._jxlp_next += 1


class JxlDecoder:
    """Incremental decoder: feed() bytes, then call process() until it
    returns COMPLETE; the visible frames gather in `frames`, (H, W, C)
    tensors on `device`, and their durations in ms in `durations`.

    device: where the AC lanes, the render and the frames run and stay;
    "cuda" (the default) raises where no card is present, and "cpu" takes
    the kernels' plain torch versions."""

    def __init__(self, options: JxlDecoderOptions | None = None, device="cuda"):
        from .simple import PIXEL_FORMATS

        self.options = options or JxlDecoderOptions()
        if self.options.pixel_format not in PIXEL_FORMATS:
            raise ValueError(f"unknown pixel format {self.options.pixel_format!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "JxlDecoder: no CUDA device is available; pass device='cpu' "
                "to decode on the host"
            )
        self.boxes = _BoxParser()
        self.stage = "file_header"
        self.cursor = 0  # bits of the codestream consumed so far
        self.file_header: FileHeader | None = None
        self.image_info: ImageInfo | None = None
        self.icc_profile: bytes | None = None
        self.state: DecoderState | None = None
        self.frame: Frame | None = None
        self.frames: list = []
        self.frame_infos: list[dict] = []
        self.durations: list[float] = []
        self._preview_pending = False
        self._input_ended = False
        self._events: list[Event] = []
        self.scan = _FrameScanInfo()
        self._scan_frozen = False
        self._skip_visible = 0
        self.preview = None  # the preview frame with skip_preview=False, (h, w, 3)
        # the size hint of the last NEED_MORE_INPUT (ref api/mod.rs:36-54):
        # feed at least this many more bytes before process() can progress
        self.bytes_needed: int | None = None
        self._progress_marker = (0, 0)  # (sections decoded, least passes done)
        self._lf_preview = None
        self._lf_flush_len = 0

    # -- input ----------------------------------------------------------------

    def feed(self, data: bytes) -> None:
        self.boxes.feed(data)

    def end_input(self) -> None:
        self._input_ended = True
        self.boxes.finish()

    # -- processing ------------------------------------------------------------

    def _reader(self) -> BitReader:
        # over the live, append-only codestream buffer without a copy; a new
        # reader each step sees the bytes appended since
        br = BitReader(self.boxes.codestream)
        br.pos = self.cursor
        return br

    def process(self) -> Event:
        while True:
            if self._events:
                return self._events.pop(0)
            try:
                ev = self._step()
            except OutOfBounds as e:
                if self._input_ended:
                    raise InvalidBitstream("truncated input") from e
                self.bytes_needed = e.needed
                return Event.NEED_MORE_INPUT
            self.bytes_needed = None
            if ev is not None:
                return ev

    def _step(self) -> Event | None:
        if self.stage == "file_header":
            with trace.span("decoder.header"):
                br = self._reader()
                self.file_header = FileHeader.read(br)
            self.cursor = br.pos
            meta = self.file_header.image_metadata
            self.stage = "icc" if meta.color_encoding.want_icc else "post_icc"
            return None
        if self.stage == "icc":
            from ..icc.decode import read_icc

            with trace.span("decoder.header"):
                br = self._reader()
                self.icc_profile = read_icc(br)
            self.cursor = br.pos
            self.stage = "post_icc"
            return None
        if self.stage == "post_icc":
            return self._image_info()
        if self.stage == "frame_header":
            with trace.span("decoder.header"):
                return self._frame_header()
        if self.stage == "frame_sections":
            return self._frame_sections()
        if self.stage == "done":
            return Event.COMPLETE
        raise AssertionError(self.stage)

    def _image_info(self) -> Event:
        meta = self.file_header.image_metadata
        w, h = self.file_header.xsize, self.file_header.ysize
        if meta.orientation.is_transposing:
            w, h = h, w
        self.image_info = ImageInfo(
            w, h, num_extra_channels=len(meta.extra_channel_info),
            bits_per_sample=meta.bit_depth.bits_per_sample,
            have_animation=meta.animation is not None, orientation=int(meta.orientation),
            preview_size=(meta.preview.xsize, meta.preview.ysize) if meta.preview else None,
        )
        if self.options.sample_limit is not None:
            # untrusted headers must not ask for huge allocations (ref
            # codestream_parser/mod.rs:61-74)
            total = (max(self.file_header.xsize, 16) * self.file_header.ysize
                     * (3 + len(meta.extra_channel_info)))
            if total >= self.options.sample_limit:
                raise LimitExceeded(
                    f"image needs {total} samples, limit {self.options.sample_limit}")
        self.state = DecoderState(self.file_header, self.options)
        self._preview_pending = meta.preview is not None
        self.stage = "frame_header"
        return Event.IMAGE_INFO

    def _frame_header(self) -> Event | None:
        from .simple import parse_frame

        br = self._reader()
        br.jump_to_byte_boundary()
        start_byte = br.pos // 8
        for lo, hi in self.boxes.ooo_ranges:
            if lo <= start_byte < hi:
                # ref tests/api.rs:36-44: a frame starts in a box that is a
                # checkpoint (in logical order)
                raise InvalidBox("frame starts in out-of-order jxlp box")
        if self._preview_pending:
            pframe = parse_frame(br, self.file_header, None, preview=True)
            br.jump_to_byte_boundary()
            if not self.options.skip_preview:
                self.preview = self._decode_preview(pframe, br)
            else:
                # the preview's sections must be present before the skip
                br.skip_bits(pframe.toc.total_size * 8)
            self.cursor = br.pos
            self._preview_pending = False
            return None
        counters = (self.state.visible_frame_index, self.state.nonvisible_frame_index)
        frame = parse_frame(br, self.file_header, self.state)
        if self.options.scan_frames_only:
            # skip the sections once they are all there; until then the
            # stage reruns from the frame's start, so nothing may change
            # (jxl_tpu moves its cursor and records the frame first, and
            # fails on the rerun: ROADMAP.md queue 3)
            br.jump_to_byte_boundary()
            if br.total_bits_available() < frame.toc.total_size * 8:
                self.state.visible_frame_index, self.state.nonvisible_frame_index = counters
                raise OutOfBounds(frame.toc.total_size - br.total_bits_available() // 8)
        self.frame = frame
        self.cursor = br.pos
        header = frame.header
        if not self._scan_frozen:
            self.scan.record(header, self.file_header.image_metadata.animation, start_byte)
        self.frame_infos.append({"is_last": header.is_last, "duration": header.duration,
                                 "name": header.name, "is_visible": header.is_visible})
        if self.options.scan_frames_only:
            self.cursor += frame.toc.total_size * 8
            if header.is_last:
                self.stage = "done"
                return Event.COMPLETE
            return Event.FRAME_START
        from ..utils import devhealth

        frame.render_host = devhealth.host_route(header, self.device)
        self.frame.begin_sections(self.device)
        self._progress_marker = (0, 0)
        self._lf_flush_len = 0
        self.stage = "frame_sections"
        return Event.FRAME_START

    def _decode_preview(self, pframe: Frame, br: BitReader):
        """The preview frame (skip_preview=False, ref options.rs:21),
        decoded and rendered whole once its bytes are there: (h, w, 3)."""
        from ..render.simple import color_transform, render_frame_channels

        total = pframe.toc.total_size
        if br.total_bits_available() < total * 8:
            raise OutOfBounds(total - br.total_bits_available() // 8)
        pframe.decode_all_sections(br, self.device)
        planes, color_done, _ = render_frame_channels(pframe, self.device)
        if not color_done:
            planes = color_transform(pframe, planes)
        return torch.stack(planes[:3], dim=-1)

    def _frame_sections(self) -> Event:
        # sections decode as their bytes arrive (ref frame_info.rs:551-604)
        frame = self.frame
        toc_end = (self.cursor + 7) // 8
        codestream = self.boxes.codestream
        with trace.span("decoder.sections"):
            need = frame.process_sections_incremental(codestream, toc_end, len(codestream))
        if need is not None:
            ev = self._progression_event(frame)
            if ev is not None:
                return ev  # the next process() comes back here and reports the need
            if self._input_ended:
                raise InvalidBitstream("truncated frame")
            raise OutOfBounds(need - len(codestream))
        self.cursor = (toc_end + frame.toc.total_size) * 8
        self._finish_frame()
        if frame.header.is_last:
            self.stage = "done"
            self._events.append(Event.COMPLETE)
        else:
            self.stage = "frame_header"
        return Event.FRAME_DONE

    def _progression_event(self, frame) -> Event | None:
        """FRAME_PROGRESSION as the progressive mode asks."""
        mode = self.options.progressive_mode
        if mode is ProgressiveMode.FULL_FRAME:
            return None
        if frame.lf_global is None or (
            frame.header.encoding == Encoding.VARDCT and not frame._lf_finalized
        ):
            return None  # nothing to render yet
        n_dec = sum(frame._sec_decoded)
        min_pass = min(frame._passes_done) if frame._passes_done else 0
        prev = self._progress_marker
        self._progress_marker = (n_dec, min_pass)
        if mode is ProgressiveMode.EAGER:
            return Event.FRAME_PROGRESSION if n_dec > prev[0] else None
        return Event.FRAME_PROGRESSION if min_pass > prev[1] else None

    def _finish_frame(self) -> None:
        from ..render.simple import color_transform
        from .simple import duration_ms, finish_frame

        frame = self.frame
        header = frame.header
        meta = self.file_header.image_metadata
        arr = finish_frame(frame, self.state, self.device, self.options.pixel_format,
                           self.options)
        if (header.lf_level == 1 and not header.needs_blending() and meta.xyb_encoded
                and not meta.extra_channel_info):
            # the 1/8-scale preview of the LF frame (ref frame/lf_preview.rs:
            # 279 maybe_preview_lf_frame), for callers to show before any
            # section of the main frame arrives
            pv = color_transform(frame, list(self.state.lf_frames[0].clone().unbind(0)))
            self._lf_preview = torch.stack(pv, dim=-1).to(self.device)
        if arr is None:
            return
        if self._skip_visible > 0:
            # seeking: this frame only rebuilds the slots the target needs
            self._skip_visible -= 1
            return
        self.frames.append(arr)
        self.durations.append(duration_ms(header, meta))

    # -- frame scan and seek ------------------------------------------------------------

    @property
    def scanned_frames(self) -> list[VisibleFrameInfo]:
        """The visible frames found so far (ref api/decoder.rs:95-99); with
        scan_frames_only, the decode's main output."""
        return self.scan.scanned

    def start_new_frame(self, seek_target: VisibleFrameSeekTarget) -> None:
        """Seek: drop the frame-level state and resume parsing at the
        target (ref api/decoder.rs:195-206); call after a scan, then keep
        calling process()."""
        self._scan_frozen = True
        self.frame = None
        self._events.clear()
        self.frames.clear()
        self.durations.clear()
        self.options = type(self.options)(**{**self.options.__dict__, "scan_frames_only": False})
        self.cursor = seek_target.decode_start_offset * 8
        self._skip_visible = seek_target.visible_frames_to_skip
        self.stage = "frame_header"

    # -- progressive rendering -----------------------------------------------------------

    def lf_preview(self):
        """The 1/8-scale preview from a decoded lf_level-1 LF frame (ref
        frame/lf_preview.rs:279), an (h, w, 3) tensor on the device, for
        XYB images without extra channels, once the LF frame is decoded;
        None otherwise."""
        return self._lf_preview

    def flush_pixels(self):
        """The current frame as far as its sections have arrived, an (H, W,
        C) float32 tensor on the device, or None when nothing renders yet
        (ref api/decoder.rs:176 flush_pixels, frame_info.rs:607 do_flush).
        A pure re-render: the decode state comes out as it went in, and
        decoding goes on after it. The lane decoder runs over the sections
        queued since its last launch (K3, adding into the frame's
        coefficients); VarDCT groups with no AC pass yet take the LF image
        upsampled 8x; the whole render runs on the device (K1 once for a
        filtered frame), then the colour transform, the blend and the
        orientation."""
        frame = self.frame
        if self.stage != "frame_sections" or frame is None:
            return None
        with trace.span("decoder.flush"):
            return self._flush(frame)

    def _flush(self, frame):
        from ..render.simple import blend_and_extend, color_transform, render_frame_channels

        header = frame.header
        partial_lf = False
        if frame.lf_global is None:
            if not self._try_partial_lf_global(frame):
                return self._flush_lf_frame_preview(frame)
            partial_lf = True
        is_vardct = header.encoding == Encoding.VARDCT
        if is_vardct and not frame._lf_finalized:
            return self._flush_lf_frame_preview(frame)
        saved_mg = frame.lf_global.modular_global
        try:
            # the render reads a transformed copy; the decode keeps its own
            mg = copy.deepcopy(saved_mg)
            mg.run_transforms()
            frame.lf_global.modular_global = mg
            no_ac = ()
            if is_vardct:
                frame.launch_pending_lanes()
                no_ac = [g for g, done in enumerate(frame._passes_done) if done == 0]
            planes, color_done, _ = render_frame_channels(frame, self.device, "f32",
                                                          no_ac_groups=no_ac)
            if header.frame_type != FrameType.REFERENCE_ONLY and not color_done:
                planes = color_transform(frame, planes)
            if header.needs_blending():
                canvas = blend_and_extend(frame, planes)
            else:
                canvas = [p[: self.file_header.ysize, : self.file_header.xsize] for p in planes]
            return self._oriented(torch.stack(canvas, dim=-1))
        finally:
            if partial_lf:
                # the partial LfGlobal served this flush only; the decode
                # reads the section again once it is whole
                frame.lf_global = None
            else:
                frame.lf_global.modular_global = saved_mg

    def _oriented(self, arr):
        from ..render.simple import apply_orientation

        if self.options.apply_orientation:
            return apply_orientation(arr, self.file_header.image_metadata.orientation)
        return arr

    def _flush_lf_frame_preview(self, frame):
        """The flush of a frame that reads a stored LF frame before its own
        sections render: that LF frame upsampled 8x to the image's size
        (ref frame/lf_preview.rs:279 and the Upsample8x flush path)."""
        from ..render.simple import color_transform
        from ..render.stages import core as st

        header = frame.header
        if header.encoding != Encoding.VARDCT or not header.has_lf_frame or self.state is None:
            return None
        lf = self.state.lf_frames[header.lf_level]
        if lf is None:
            return None
        kern = st.build_upsample_kernels(self.file_header.transform_data.weights8, 8)
        w, h = self.file_header.xsize, self.file_header.ysize
        planes = [st.upsample(p, kern, 8)[:h, :w] for p in lf.to(self.device).unbind(0)]
        planes = color_transform(frame, planes)
        return self._oriented(torch.stack(planes, dim=-1))

    def _try_partial_lf_global(self, frame) -> bool:
        """The flush's decode of an LfGlobal section whose bytes have not
        all arrived (ref frame_info.rs:607-652 has_partial_lf,
        decode_lf_global allow_partial): Modular regular and LF frames
        only, tried again once the section's bytes have grown 1.5x."""
        from ..errors import JxlError

        header = frame.header
        if header.encoding != Encoding.MODULAR:
            return False
        if header.frame_type not in (FrameType.REGULAR, FrameType.LF_FRAME):
            return False
        codestream = self.boxes.codestream
        toc_end = (self.cursor + 7) // 8
        stored = (frame.toc.permutation[0] if frame.toc.permuted else 0
                  ) if header.num_toc_entries > 1 else 0
        start = frame._stored_end[stored] - frame.toc.entries[stored]
        end = frame._stored_end[stored]
        avail = min(len(codestream) - toc_end, end) - start
        if avail <= 0:
            return False
        if 2 * avail <= 3 * self._lf_flush_len:
            return False
        self._lf_flush_len = avail
        br = BitReader(bytes(codestream[toc_end + start : toc_end + start + avail]))
        try:
            frame.decode_lf_global(br, allow_partial=True)
        except JxlError:
            frame.lf_global = None
            return False
        if frame.lf_global is None or not frame.lf_global.modular_global.early_render_ok:
            frame.lf_global = None
            return False
        return True
