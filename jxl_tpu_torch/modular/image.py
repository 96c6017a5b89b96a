"""Full-frame modular image: channel planning, per-section decode, and
global inverse-transform application.

Capability reference: jxl/src/frame/modular/mod.rs (FullModularImage).
Design difference from the reference (deliberate, TPU-first): instead of a
chunked transform-step DAG with per-grid dependency counting, channels are
decoded directly into views of full-size planes (each group's rect is an
independent sub-image, exactly as the format specifies) and the inverse
transforms then run once, whole-image and vectorized — the shape a device
program wants. Incremental re-render for progressive flushes re-runs the
(pure) transform pass.
"""

from __future__ import annotations

import numpy as np

from ..errors import JxlError
from ..io.bit_reader import BitReader
from ..io.headers.frame import Encoding, FrameHeader
from ..io.headers.modular import GroupHeader
from .channel import ChannelInfo, ModularChannel
from .decode import ModularStreamId, decode_modular_subbitstream
from .transforms import inverse_apply_steps, meta_apply_transforms
from .tree import Tree


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


_PLAN_CACHE: dict = {}


def _build_plan(channels, header, frame_header):
    """Transform meta-apply + section assignment (ref modular/mod.rs:
    353-419): coded channels in coded order; LfGlobal takes the
    meta-or-small prefix, LfGroup takes shift >= 3, each pass takes its
    downsampling bracket."""
    buffer_infos, coded, transform_steps = meta_apply_transforms(
        channels, header
    )
    group_dim = frame_header.group_dim
    coded_infos = [(i, buffer_infos[b]) for i, b in enumerate(coded)]
    prefix_len = 0
    for _, info in coded_infos:
        if info.is_meta_or_small(group_dim):
            prefix_len += 1
        else:
            break
    rest = coded_infos[prefix_len:]

    sections = [[coded[i] for i, _ in coded_infos[:prefix_len]]]
    sections.append(
        [coded[i] for i, info in rest if info.is_shift_in_range(3, 1 << 30)]
    )
    for p in range(frame_header.passes.num_passes):
        lo, hi = frame_header.passes.downsampling_bracket(p)
        sections.append(
            [coded[i] for i, info in rest if info.is_shift_in_range(lo, hi)]
        )

    grid_kind = ["none"] * len(buffer_infos)
    for b in sections[1]:
        grid_kind[b] = "lf"
    for sec in sections[2:]:
        for b in sec:
            grid_kind[b] = "hf"
    return (buffer_infos, coded, transform_steps, sections, grid_kind)


class FullModularImage:
    def __init__(self):
        self.buffer_infos: list[ChannelInfo] = []
        self.coded: list[int] = []
        self.transform_steps: list = []
        self.section_buffer_indices: list[list[int]] = []
        self.storage: list[ModularChannel] = []
        self.global_header: GroupHeader | None = None
        self.grid_kind: list[str] = []  # 'none' | 'lf' | 'hf' per buffer
        self.num_input_channels = 0
        self.transforms_applied = False
        # buffer -> (h, w) int32 tensor of the buffers whose group streams
        # K6 decoded on the card (modular/group_lanes.py, which drops their
        # host planes from storage), until output_channel(take=True) hands
        # it over; then the buffer is in taken_planes
        self.device_planes: dict = {}
        self.taken_planes: set = set()
        # early partial render (ref modular/mod.rs:489-492): progressive
        # flushes may decode section 0 partially only for squeeze-coded
        # images without multi-channel/delta palettes, and only render once
        # at least one full level of channels is in (green-martians guard)
        self.can_do_early_partial_render = False
        self.needed_section0_channels = 0
        self.early_render_ok = False

    # -- planning ---------------------------------------------------------

    @staticmethod
    def read(
        frame_header: FrameHeader,
        image_metadata,
        modular_color_channels: int,
        br: BitReader,
        allocate: bool = True,
    ) -> "FullModularImage":
        channels = FullModularImage.channel_list(
            frame_header, image_metadata, modular_color_channels
        )
        header = GroupHeader.read(br) if channels else None
        return FullModularImage.from_header(
            frame_header, channels, header, allocate=allocate
        )

    @staticmethod
    def channel_list(
        frame_header: FrameHeader, image_metadata, modular_color_channels: int
    ) -> list[ChannelInfo]:
        bits = image_metadata.bit_depth.bits_per_sample
        channels: list[ChannelInfo] = []
        for c in range(modular_color_channels):
            shift = (frame_header.hshift(c), frame_header.vshift(c))
            w, h = frame_header.size()
            channels.append(
                ChannelInfo(
                    (_ceil_div(w, 1 << shift[0]), _ceil_div(h, 1 << shift[1])),
                    shift,
                    bits,
                    c,
                )
            )
        for idx, ecups in enumerate(frame_header.ec_upsampling):
            shift_ec = _ceil_log2(ecups)
            shift_color = _ceil_log2(frame_header.upsampling)
            shift = shift_ec - shift_color
            assert shift >= 0
            w, h = frame_header.size_upsampled()
            ec_bits = image_metadata.extra_channel_info[idx].bit_depth.bits_per_sample
            channels.append(
                ChannelInfo(
                    (_ceil_div(w, ecups), _ceil_div(h, ecups)),
                    (shift, shift),
                    ec_bits,
                    3 + idx,
                )
            )
        return channels

    @staticmethod
    def from_header(
        frame_header: FrameHeader,
        channels: list[ChannelInfo],
        header: GroupHeader | None,
        allocate: bool = True,
    ) -> "FullModularImage":
        """Plan + storage from an already-parsed GroupHeader (the anim
        fold parses per-frame headers natively and re-plans here)."""
        self = FullModularImage()
        self.num_input_channels = len(channels)
        num_sections = 2 + frame_header.passes.num_passes
        if not channels:
            self.section_buffer_indices = [[] for _ in range(num_sections)]
            return self
        self.global_header = header

        # The planning below (transform meta-apply + section assignment)
        # is a pure function of the channel list, the header transforms
        # and the frame geometry — animations re-derive the identical
        # plan for every frame, so it is memoized (descriptor objects are
        # never mutated during decode; storage is always allocated fresh).
        wp = header.wp_header
        key = (
            tuple(
                (c.size, c.shift, c.bit_depth_bits, c.output_channel_idx)
                for c in channels
            ),
            tuple(
                (
                    t.id, t.begin_channel, t.rct_type, t.num_channels,
                    t.num_colors, t.num_deltas, t.predictor_id,
                    tuple(
                        (s.horizontal, s.in_place, s.begin_channel,
                         s.num_channels)
                        for s in t.squeezes
                    ),
                )
                for t in header.transforms
            ),
            (wp.p1c, wp.p2c, wp.p3ca, wp.p3cb, wp.p3cc, wp.p3cd, wp.p3ce,
             wp.w0, wp.w1, wp.w2, wp.w3),
            frame_header.group_dim,
            frame_header.passes.num_passes,
            tuple(
                frame_header.passes.downsampling_bracket(p)
                for p in range(frame_header.passes.num_passes)
            ),
        )
        cached = _PLAN_CACHE.get(key)
        if cached is None:
            plan = _build_plan(channels, header, frame_header)
            if len(_PLAN_CACHE) > 64:
                _PLAN_CACHE.clear()
            _PLAN_CACHE[key] = plan
        else:
            plan = cached
        (
            self.buffer_infos,
            self.coded,
            self.transform_steps,
            self.section_buffer_indices,
            self.grid_kind,
        ) = plan

        # Allocate full-size planes for every buffer. Banded (O(group-row)
        # memory) decoding passes allocate=False and supplies its own
        # per-band buffers instead (api/banded.py).
        if allocate:
            self.storage = [
                ModularChannel(info.size, info.shift, info.bit_depth_bits)
                for info in self.buffer_infos
            ]
        else:
            self.storage = [
                ModularChannel((0, 0), info.shift, info.bit_depth_bits)
                for info in self.buffer_infos
            ]

        from ..io.headers.modular import TransformId

        has_problematic_palette = any(
            t.id == TransformId.PALETTE
            and (t.num_channels > 1 or t.predictor_id != 0)
            for t in header.transforms
        )
        has_squeeze = any(t.id == TransformId.SQUEEZE for t in header.transforms)
        num_meta = sum(
            1
            for b in self.coded
            if self.buffer_infos[b].is_meta
        )
        self.can_do_early_partial_render = (
            not has_problematic_palette and has_squeeze
        )
        self.needed_section0_channels = len(channels) + num_meta
        return self

    # -- decoding -----------------------------------------------------------

    def _cell_view(self, frame_header: FrameHeader, buf: int, group: int) -> ModularChannel:
        info = self.buffer_infos[buf]
        kind = self.grid_kind[buf]
        mc = self.storage[buf]
        if kind == "none":
            return mc
        shift = info.shift
        if kind == "lf":
            dim = frame_header.lf_group_dim
            shape = frame_header.size_lf_groups()
        else:
            dim = frame_header.group_dim
            shape = frame_header.size_groups()
        dx = dim >> shift[0]
        dy = dim >> shift[1]
        gx, gy = group % shape[0], group // shape[0]
        x0, y0 = gx * dx, gy * dy
        w = max(min(info.size[0] - x0, dx), 0)
        h = max(min(info.size[1] - y0, dy), 0)
        if w == 0 or h == 0:
            # ref get_grid_rect normalizes clipped-empty rects to (0, 0);
            # with_buffers then drops them from the stream's channel list
            # entirely (renumbering!) — see modular/buffers.rs:193-202.
            return mc.view(0, 0, 0, 0)
        return mc.view(x0, y0, w, h)

    def read_section0(
        self, frame_header, global_tree, br: BitReader, allow_partial: bool = False
    ) -> None:
        if not self.buffer_infos:
            return
        bufs = [self.storage[b] for b in self.section_buffer_indices[0]]
        if allow_partial and self.can_do_early_partial_render:
            partial = [0]
            try:
                decode_modular_subbitstream(
                    bufs,
                    ModularStreamId.global_data(),
                    self.global_header,
                    global_tree,
                    br,
                    partial_out=partial,
                )
                num_decoded = len(bufs)
            except JxlError:
                num_decoded = partial[0]
                # zero the unsafe tail so stale garbage never renders
                for b in bufs[num_decoded:]:
                    b.data[...] = 0
            self.early_render_ok = (
                num_decoded > 0 and num_decoded >= self.needed_section0_channels
            )
            return
        decode_modular_subbitstream(
            bufs, ModularStreamId.global_data(), self.global_header, global_tree, br
        )
        self.early_render_ok = True

    def read_lf_stream(self, frame_header, global_tree, group: int, br: BitReader):
        if not self.buffer_infos:
            return
        bufs = [
            self._cell_view(frame_header, b, group)
            for b in self.section_buffer_indices[1]
        ]
        bufs = [b for b in bufs if b.data.shape != (0, 0)]
        decode_modular_subbitstream(
            bufs,
            ModularStreamId.modular_lf(frame_header, group),
            None,
            global_tree,
            br,
        )

    def read_hf_stream(self, frame_header, global_tree, pass_idx: int, group: int, br: BitReader):
        if not self.buffer_infos:
            return
        bufs = [
            self._cell_view(frame_header, b, group)
            for b in self.section_buffer_indices[2 + pass_idx]
        ]
        bufs = [b for b in bufs if b.data.shape != (0, 0)]
        decode_modular_subbitstream(
            bufs,
            ModularStreamId.modular_hf(frame_header, pass_idx, group),
            None,
            global_tree,
            br,
        )

    # -- finalization -----------------------------------------------------------

    def run_transforms(self) -> None:
        if not self.transforms_applied:
            inverse_apply_steps(self.transform_steps, self.storage)
            self.transforms_applied = True

    def output_channel(self, output_idx: int, take: bool = False):
        """Final (post-transform) plane for output channel `output_idx`:
        a numpy array, or the card's tensor of a plane K6 decoded there.
        take=True hands such a tensor over (the image keeps no reference),
        so that the render frees it once it has converted it; a later read
        of that channel raises."""
        for buf, info in enumerate(self.buffer_infos):
            if info.output_channel_idx == output_idx:
                if buf in self.taken_planes:
                    raise RuntimeError(f"output channel {output_idx} was handed over")
                if buf in self.device_planes:
                    if not take:
                        return self.device_planes[buf]
                    self.taken_planes.add(buf)
                    return self.device_planes.pop(buf)
                return self.storage[buf].data
        raise KeyError(f"no output channel {output_idx}")
