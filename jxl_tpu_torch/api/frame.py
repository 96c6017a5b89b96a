"""Frame decoding orchestration (host planner).

Capability reference: jxl/src/frame/{mod,decode}.rs. Parses LfGlobal →
LF groups → HfGlobal → HF groups, dispatching Modular and VarDCT section
decoding. A VarDCT frame's AC coefficients are decoded by the lane
decoder (vardct/device_group.py: kernel K3 on the card, its plain torch
version on the CPU) or, with JXL_TPU_AC=host or for streams the lane
decoder does not take, by the native host decoder; either way they end
up as one dense buffer for vardct/device_frame.py. The global modular
image carries the frame's extra channels; in a VarDCT frame each group
codes its part of them right after its AC tokens, and such frames decode
group by group on the host (vardct/group.py:decode_vardct_group, then the
group's modular HF stream). A frame of more than one pass decodes each
group's passes in turn, and each pass's coefficients add into the same
buffer. LfGlobal holds the patches dictionary (read against the decoder
state's reference slots), the splines, whose draw cache is built there,
and the noise parameters. A VarDCT frame that reads an LF frame
(USE_LF_FRAME) codes no LF coefficients: it adopts the LF frame's planes
from the decoder state, a tensor on the decode's device that stays there
for the render (vardct/device_frame.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import LfQuantFactorTooSmall, NoLfFrame
from ..io.bit_reader import BitReader
from ..io.bundle import F16
from ..io.headers import ColorSpace, FileHeader
from ..io.headers.frame import Encoding, FrameHeader, Toc
from ..modular.image import FullModularImage
from ..modular.tree import Tree
from ..utils import trace

# LF quantization defaults (ref quant_weights.rs LF_QUANT)
LF_QUANT = (1.0 / 4096.0, 1.0 / 512.0, 1.0 / 256.0)


@dataclass
class LfQuantFactors:
    quant_factors: tuple = LF_QUANT

    @staticmethod
    def read(br: BitReader) -> "LfQuantFactors":
        if br.read(1) == 1:
            return LfQuantFactors()
        f16 = F16()
        qf = tuple(f16.read(br) / 128.0 for _ in range(3))
        for v in qf:
            if v < 1e-8:
                raise LfQuantFactorTooSmall("LF quant factor too small")
        return LfQuantFactors(qf)

    @property
    def inv_quant_factors(self):
        return tuple(1.0 / v for v in self.quant_factors)


@dataclass
class QuantizerParams:
    global_scale: int = 1
    quant_lf: int = 1

    GLOBAL_SCALE_DENOM = 1 << 16

    @property
    def inv_global_scale(self) -> float:
        return self.GLOBAL_SCALE_DENOM / self.global_scale


@dataclass
class LfGlobalState:
    lf_quant: LfQuantFactors = None
    quant_params: QuantizerParams = None
    block_context_map: object = None
    color_correlation_params: object = None
    tree: Tree = None
    modular_global: FullModularImage = None
    patches: object = None  # features/patches.py PatchesDictionary, when the frame has patches
    splines: object = None  # features/splines.py Splines, when the frame has splines
    noise: object = None  # features/noise.py Noise, when the frame has noise


def run_parallel(fn, items) -> None:
    """fn over items on a host thread pool (the native decoders release the
    GIL); every result is read, so the first error raises."""
    import contextvars
    import os
    from concurrent.futures import ThreadPoolExecutor

    n_workers = min(len(items), os.cpu_count() or 1)
    if n_workers < 2:
        for it in items:
            fn(it)
        return
    # each item runs in a copy of the caller's context, so that the
    # workers see its lossless BatchContext (modular/device_lossless.py)
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        for f in [ex.submit(contextvars.copy_context().run, fn, it) for it in items]:
            f.result()


class Frame:
    """One frame's decode state."""

    def __init__(self, header: FrameHeader, toc: Toc, file_header: FileHeader, decoder_state=None):
        self.header = header
        self.toc = toc
        self.file_header = file_header
        self.decoder_state = decoder_state
        meta = file_header.image_metadata
        is_gray = (
            not header.do_ycbcr
            and not meta.xyb_encoded
            and meta.color_encoding.color_space == ColorSpace.GRAY
        )
        self.color_channels = 1 if is_gray else 3
        self.lf_global: LfGlobalState | None = None
        self.hf_global = None
        self.lf_image = None  # [3] float planes in 8x8-block resolution
        # (3, bh, bw) float32 LF adopted from an LF frame, on its device
        self.lf_device = None
        self.hf_meta = None
        # the dense (G * 3 * 256 * 256,) int32 AC coefficients of a VarDCT
        # frame: a tensor from the lane decoder, or numpy from the host
        self.device_ac_flat = None
        self.device_ac_ok = None
        self.host_ac_flat = None
        # the host render route (utils/devhealth.py:host_route): the frame's
        # AC decodes on the host and render/simple.py renders it with the
        # native C++; set by decode_image's loop and JxlDecoder
        self.render_host = False

    @property
    def modular_color_channels(self) -> int:
        return 0 if self.header.encoding == Encoding.VARDCT else self.color_channels

    # -- section handling ------------------------------------------------------

    def split_sections(self, br: BitReader) -> list[BitReader]:
        """Carve per-section readers out of `br` and undo TOC permutation."""
        stored = [br.split_at(n) for n in self.toc.entries]
        if not self.toc.permuted:
            return stored
        return [stored[self.toc.permutation[i]] for i in range(len(stored))]

    def section_index(self, kind: str, *, group: int = 0, pass_idx: int = 0) -> int:
        if self.header.num_toc_entries == 1:
            return 0
        if kind == "lf_global":
            return 0
        if kind == "lf":
            return 1 + group
        if kind == "hf_global":
            return self.header.num_lf_groups + 1
        if kind == "hf":
            return 2 + self.header.num_lf_groups + self.header.num_groups * pass_idx + group
        raise KeyError(kind)

    # -- LfGlobal ----------------------------------------------------------------

    def decode_lf_global(self, br: BitReader, allow_partial: bool = False,
                         allocate_modular: bool = True) -> None:
        """ref frame/decode.rs:314-434: the patches dictionary (read
        against the reference slots' shapes), the splines, the noise
        parameters, then the tables and the global Modular image; the
        splines' draw cache is built once the colour correlation is known
        (ref jxl_tpu/api/frame.py:171-174, 231-233). With allow_partial
        (the progressive flush of an LfGlobal section whose bytes have not
        all arrived), the section-0 Modular channels decode as far as the
        bytes go and the finished ones are kept
        (modular_global.early_render_ok says whether they render). With
        allocate_modular=False the global Modular image gets no
        whole-frame planes but those of the global section's channels
        (FullModularImage.read(allocate=False)): the banded decode
        (api/banded.py) decodes each group row's channels into band
        buffers of its own."""
        header = self.header
        is_vardct = header.encoding == Encoding.VARDCT
        state = LfGlobalState()
        if header.has_patches:
            from ..features.patches import PatchesDictionary

            w, h = header.size_padded()
            refs = self.decoder_state.reference_frames if self.decoder_state else [None] * 4
            state.patches = PatchesDictionary.read(
                br, w, h, len(self.file_header.image_metadata.extra_channel_info), refs
            )
        if header.has_splines:
            from ..features.splines import Splines

            state.splines = Splines.read(br, header.width * header.height)
        if header.has_noise:
            from ..features.noise import Noise

            state.noise = Noise.read(br)
        num_ec = len(self.file_header.image_metadata.extra_channel_info)
        size_limit = min(
            1024
            + header.width * header.height * (self.color_channels + num_ec) // 16,
            1 << 22,
        )
        # one native call for the table sequence (lf-quant, [VarDCT:
        # quantizer, block context map, CfL], global tree)
        from .. import native

        res = native.decode_lf_global_tables_native(br, is_vardct, size_limit)
        state.lf_quant = LfQuantFactors(res["lf_quant"])
        if is_vardct:
            from ..vardct.block_context import BlockContextMap
            from ..vardct.cfl import ColorCorrelationParams

            state.quant_params = QuantizerParams(*res["quant_params"])
            if res["bctx_default"]:
                state.block_context_map = BlockContextMap.default()
            else:
                state.block_context_map = BlockContextMap(
                    res["lf_thresholds"], res["qf_thresholds"], res["bctx_map"],
                    res["num_lf_contexts"], res["bctx_num_contexts"],
                )
            state.color_correlation_params = ColorCorrelationParams(*res["cfl"])
        state.tree = res["tree"]
        if state.splines is not None:
            w, h = header.size()
            state.splines.initialize_draw_cache(w, h, state.color_correlation_params)
        state.modular_global = FullModularImage.read(
            header,
            self.file_header.image_metadata,
            self.modular_color_channels,
            br,
            allocate=allocate_modular,
        )
        if not allocate_modular:
            # the global section's own channels (palettes, small channels)
            # are read here, so they get their planes
            from ..modular.channel import ModularChannel

            mg = state.modular_global
            for b in mg.section_buffer_indices[0] if mg.buffer_infos else ():
                info = mg.buffer_infos[b]
                mg.storage[b] = ModularChannel(info.size, info.shift, info.bit_depth_bits)
        state.modular_global.read_section0(header, state.tree, br, allow_partial=allow_partial)
        self.lf_global = state

    # -- LF / HF groups ------------------------------------------------------------

    def decode_lf_group(self, group: int, br: BitReader) -> None:
        """ref jxl_tpu/api/frame.py:248-263: a VarDCT frame's LF
        coefficients, or the adopted LF frame, then the modular LF stream
        and the HF metadata."""
        header = self.header
        state = self.lf_global
        if header.encoding == Encoding.VARDCT:
            from ..vardct.lf import decode_hf_metadata, decode_vardct_lf, try_decode_lf_group

            if header.has_lf_frame:
                if self.lf_device is None:  # once, at the first LF group
                    self._adopt_lf_frame()
            elif try_decode_lf_group(self, group, br):
                return  # LF coefficients, (empty) modular LF and HF metadata
            else:
                decode_vardct_lf(self, group, br)
            state.modular_global.read_lf_stream(header, state.tree, group, br)
            decode_hf_metadata(self, group, br)
            return
        state.modular_global.read_lf_stream(header, state.tree, group, br)

    def _adopt_lf_frame(self) -> None:
        """USE_LF_FRAME: the LF image is the planes of the LF frame one
        level up, kept in the decoder state on the decode's device (ref
        decode.rs:744-750; jxl_tpu/api/frame.py:265-288). They become
        lf_device, (3, bh, bw) float32 on that device, clipped or padded
        with zeros to the frame's blocks, and stay there for the render:
        nothing comes back to the host. A missing LF frame raises
        NoLfFrame."""
        from ..vardct.lf import ensure_vardct_buffers

        ensure_vardct_buffers(self)
        slots = self.decoder_state.lf_frames if self.decoder_state else [None] * 4
        lf = slots[self.header.lf_level]
        if lf is None:
            raise NoLfFrame("frame references a missing LF frame")
        bw, bh = self.header.size_blocks()
        h, w = min(bh, lf.shape[1]), min(bw, lf.shape[2])
        out = torch.zeros((3, bh, bw), dtype=torch.float32, device=lf.device)
        out[:, :h, :w] = lf[:, :h, :w]
        self.lf_device = out

    def decode_hf_global(self, br: BitReader) -> None:
        if self.header.encoding == Encoding.VARDCT:
            from ..vardct.hf_global import decode_hf_global

            self.hf_global = decode_hf_global(self, br)

    def finalize_lf(self) -> None:
        if self.header.should_do_adaptive_lf_smoothing and self.lf_image is not None:
            from ..vardct.lf import adaptive_lf_smoothing

            adaptive_lf_smoothing(self)

    def decode_hf_group(self, group: int, pass_readers: list[tuple[int, BitReader]]) -> None:
        """One group's HF sections: a VarDCT frame's AC into the group's
        slot of host_ac_flat, then each pass's modular HF stream at the bit
        where its AC ended (ref jxl_tpu/api/frame.py:_decode_hf_group)."""
        state = self.lf_global
        if self.header.encoding == Encoding.VARDCT:
            from ..vardct.group import GROUP_DIM, decode_vardct_group

            pool = self.host_ac_flat.reshape(-1, 3, GROUP_DIM * GROUP_DIM)
            decode_vardct_group(self, group, pass_readers, pool[group])
        for pass_idx, br in pass_readers:
            state.modular_global.read_hf_stream(
                self.header, state.tree, pass_idx, group, br
            )

    # -- whole-frame decode ------------------------------------------------------------

    def decode_all_sections(self, br: BitReader, device="cuda") -> None:
        """Decode every section. A VarDCT frame's AC coefficients are
        decoded on `device` (the lane decoder; the card unless the caller
        asks for the CPU) unless JXL_TPU_AC=host or the stream needs the
        host decoder. A Modular frame's channel-static streams go to the
        lossless lanes on `device` when device_lossless.enabled says so:
        they are flushed back into the channels before the transforms
        (ref jxl_tpu/api/frame.py:523-544). Otherwise, on the card, a
        Modular frame whose group streams K6 takes
        (modular/group_lanes.py) decodes them there, into planes that stay
        on the card for the render."""
        from ..modular import device_lossless

        header = self.header
        device = torch.device(device)
        if header.encoding == Encoding.VARDCT:
            self._decode_vardct_sections(br, device)
        else:
            lanes = (device_lossless.BatchContext(device)
                     if device_lossless.enabled(device) else None)
            card = (device if device.type == "cuda" and lanes is None and not self.render_host
                    else None)
            with device_lossless.activate(lanes):
                self._decode_modular_sections(br, card)
            if lanes is not None:
                lanes.flush()
        self.lf_global.modular_global.run_transforms()

    def _decode_modular_sections(self, br: BitReader, card=None) -> None:
        """The sections of a Modular frame; its group streams by K6 on
        `card` (a CUDA device, or None for the host) when the stream takes
        that route."""
        from ..modular import group_lanes

        header = self.header
        if header.num_toc_entries == 1:
            sec = self.split_sections(br)[0]
            with trace.span("frame.lf_global"):
                self.decode_lf_global(sec)
            with trace.span("frame.lf_groups"):
                for g in range(header.num_lf_groups):
                    self.decode_lf_group(g, sec)
            with trace.span("frame.modular_groups"):
                for g in range(header.num_groups):
                    self.decode_hf_group(
                        g, [(p, sec) for p in range(header.passes.num_passes)]
                    )
        else:
            sections = self.split_sections(br)
            with trace.span("frame.lf_global"):
                self.decode_lf_global(sections[self.section_index("lf_global")])
            with trace.span("frame.lf_groups"):
                for g in range(header.num_lf_groups):
                    self.decode_lf_group(g, sections[self.section_index("lf", group=g)])
            jobs = [
                (
                    g,
                    [
                        (p, sections[self.section_index("hf", group=g, pass_idx=p)])
                        for p in range(header.passes.num_passes)
                    ],
                )
                for g in range(header.num_groups)
            ]
            with trace.span("frame.modular_groups"):
                if card is None or not group_lanes.decode_on_card(self, sections, card):
                    self._decode_hf_groups_parallel(jobs)

    def _decode_vardct_sections(self, br: BitReader, device) -> None:
        """ref frame/decode.rs section order; the AC routing of
        jxl_tpu/api/frame.py:_try_device_ac without its TPU-measured gates:
        an eligible frame of more than one section takes the lane decoder
        on either device, unless JXL_TPU_AC=host sends it to the native
        host decoder."""
        from ..vardct.device_group import decode_ac_sections_device

        readers = self.decode_vardct_head(br)
        if self.header.num_toc_entries != 1 and self.takes_lanes():
            decode_ac_sections_device(self, readers, device)
            return
        self.decode_vardct_ac_on_host(self.hf_jobs(readers),
                                      torch.device("cpu") if self.render_host else device)

    def decode_vardct_head(self, br: BitReader) -> dict:
        """A VarDCT frame's sections up to its AC: LfGlobal, the LF groups,
        HfGlobal and the LF smoothing. Returns the HF section readers,
        {(group, pass): BitReader}; a frame of one section has one, the
        section's own reader at the bit after HfGlobal."""
        header = self.header
        single = header.num_toc_entries == 1
        sections = self.split_sections(br)
        sec = sections[0]
        with trace.span("frame.lf_global"):
            self.decode_lf_global(sec if single else sections[self.section_index("lf_global")])
        with trace.span("frame.lf_groups"):
            for g in range(header.num_lf_groups):
                self.decode_lf_group(g, sec if single
                                     else sections[self.section_index("lf", group=g)])
        with trace.span("frame.hf_global"):
            self.decode_hf_global(sec if single else sections[self.section_index("hf_global")])
            self.finalize_lf()
        return {(g, p): sec if single else sections[self.section_index("hf", group=g, pass_idx=p)]
                for g in range(header.num_groups) for p in range(header.passes.num_passes)}

    def hf_jobs(self, readers: dict) -> list:
        """decode_vardct_ac_on_host's jobs from decode_vardct_head's readers."""
        return [(g, [(p, readers[(g, p)]) for p in range(self.header.passes.num_passes)])
                for g in range(self.header.num_groups)]

    def decode_vardct_ac_on_host(self, jobs, device, pool=None) -> None:
        """A VarDCT frame's AC on the host, into host_ac_flat: a
        single-pass frame without modular HF channels in one native call
        for the whole frame; any other frame (more than one pass, or
        modular HF channels after each group's AC) group by group over the
        thread pool, each job decoding its group's passes in turn, each
        pass's AC and then its modular HF stream (ref
        jxl_tpu/api/frame.py:620; the groups write disjoint slots of one
        pool, and a group's passes add into its slot). The pool is
        page-locked when the render runs on the card, so its upload needs
        no staging copy and no wait. jobs: [(group, [(pass, BitReader)])]
        in group order. pool: the zeroed (G * 3 * 256 * 256,) int32 buffer
        to decode into (a view of a larger pool shared by several frames),
        else one made here."""
        from ..vardct.group import try_decode_hf_groups

        pool = self._host_ac_pool(device) if pool is None else pool
        if try_decode_hf_groups(self, [(g, readers[0][1]) for g, readers in jobs], pool):
            return
        self.host_ac_flat = pool
        self._decode_hf_groups_parallel(jobs)

    def _host_ac_pool(self, device) -> np.ndarray:
        """A zeroed dense (G * 3 * 256 * 256,) int32 coefficient pool for
        the host AC decoder, page-locked when the render runs on the card."""
        from ..vardct.group import GROUP_DIM

        n = self.header.num_groups * 3 * GROUP_DIM * GROUP_DIM
        if torch.device(device).type == "cuda":
            return torch.zeros(n, dtype=torch.int32, pin_memory=True).numpy()
        return np.zeros(n, np.int32)

    def _decode_hf_groups_parallel(self, jobs) -> None:
        """Fan HF-group section decoding out over a host thread pool (the
        reference's work-stealing render fan-out, frame/render.rs:373-459).
        Per-group entropy runs in C++ with the GIL released, and groups
        write disjoint rects, so sections decode concurrently; pass order
        within a group is preserved inside each job."""
        run_parallel(lambda job: self.decode_hf_group(*job), jobs)

    def takes_lanes(self) -> bool:
        """Whether the frame's AC takes the lane decoder (K3 on the card):
        an eligible VarDCT frame, unless JXL_TPU_AC=host sends it to the
        native host decoder or the frame is on the host render route."""
        import os

        from ..vardct.device_group import eligible_for_device_ac

        return (not self.render_host and os.environ.get("JXL_TPU_AC", "auto") != "host"
                and eligible_for_device_ac(self))

    # -- incremental section decode (the streaming decoder) ---------------------------------
    #
    # Sections decode as their bytes arrive, in dependency order (ref
    # codestream_parser/frame_info.rs:551-604; jxl_tpu/api/frame.py:330-440):
    # LfGlobal, the LF groups, HfGlobal, finalize_lf, then each group's
    # passes in pass order. A frame that takes the lane decoder queues each
    # complete (group, pass) section on the host and launches K3 over the
    # queue only when pixels are needed (launch_pending_lanes: at the end
    # of the frame, or at a progressive flush), so a streaming decode
    # without a flush launches it once, as decode_image does. Host-route
    # frames decode group by group as their sections arrive.

    def begin_sections(self, device="cuda") -> None:
        """Start an incremental decode whose AC and render run on `device`."""
        ends = np.cumsum(self.toc.entries).tolist()
        self._stored_end = ends  # byte end of each stored section, from the TOC's end
        self._sec_decoded = [False] * len(self.toc.entries)
        self._lf_finalized = False
        self._passes_done = [0] * self.header.num_groups
        self._transforms_done = False
        self.device = torch.device(device)
        self.ac_route = None  # "lanes" or "host", chosen after HfGlobal
        self.pending_lanes = {}  # {(group, pass): BitReader} not yet launched

    def _section_end(self, logical: int) -> int:
        stored = self.toc.permutation[logical] if self.toc.permuted else logical
        return self._stored_end[stored]

    def _section_reader(self, logical: int, codestream, toc_end: int) -> BitReader:
        stored = self.toc.permutation[logical] if self.toc.permuted else logical
        start = self._stored_end[stored] - self.toc.entries[stored]
        return BitReader(bytes(codestream[toc_end + start : toc_end + self._stored_end[stored]]))

    def _choose_ac_route(self) -> None:
        """The AC routing of _decode_vardct_sections: the lane decoder for
        an eligible frame unless JXL_TPU_AC=host, else the host decoder
        group by group into host_ac_flat."""
        if self.header.encoding != Encoding.VARDCT:
            return
        if self.takes_lanes():
            self.ac_route = "lanes"
        else:
            self.ac_route = "host"
            self.host_ac_flat = self._host_ac_pool(
                torch.device("cpu") if self.render_host else self.device)

    def launch_pending_lanes(self) -> int:
        """Launch the lane decoder (K3 on the card) once over the queued
        sections, adding their coefficients into device_ac_flat; returns
        the number of lanes launched (0 launches nothing)."""
        if not self.pending_lanes:
            return 0
        from ..vardct.device_group import decode_ac_sections_device

        lanes, self.pending_lanes = self.pending_lanes, {}
        decode_ac_sections_device(self, lanes, self.device)
        return len(lanes)

    def process_sections_incremental(self, codestream, toc_end: int, avail: int) -> int | None:
        """Decode every section whose bytes have arrived (`avail` bytes of
        `codestream`, the frame's sections starting at byte `toc_end`).
        Returns None once the frame is decoded, else the absolute byte
        position the next section needs. A frame of one section decodes
        through decode_all_sections once its bytes are all there."""
        header = self.header
        rel_avail = avail - toc_end
        if header.num_toc_entries == 1:
            if rel_avail < self._stored_end[0]:
                return toc_end + self._stored_end[0]
            if not self._sec_decoded[0]:
                self.decode_all_sections(self._section_reader(0, codestream, toc_end),
                                         self.device)
                self._sec_decoded[0] = True
                self._lf_finalized = self._transforms_done = True
                self._passes_done = [header.passes.num_passes] * header.num_groups
            return None

        def ready(logical):
            return not self._sec_decoded[logical] and rel_avail >= self._section_end(logical)

        def take(logical):
            self._sec_decoded[logical] = True
            return self._section_reader(logical, codestream, toc_end)

        i_lfg = self.section_index("lf_global")
        if self.lf_global is None:
            if not ready(i_lfg):
                return toc_end + self._section_end(i_lfg)
            self.decode_lf_global(take(i_lfg))
        for g in range(header.num_lf_groups):
            if ready(self.section_index("lf", group=g)):
                self.decode_lf_group(g, take(self.section_index("lf", group=g)))
        i_hfg = self.section_index("hf_global")
        if ready(i_hfg):
            self.decode_hf_global(take(i_hfg))
        if not self._lf_finalized and all(
                self._sec_decoded[self.section_index("lf", group=g)]
                for g in range(header.num_lf_groups)) and self._sec_decoded[i_hfg]:
            self.finalize_lf()
            self._choose_ac_route()
            self._lf_finalized = True

        if self._lf_finalized:
            jobs = []
            for g in range(header.num_groups):
                readers = []
                p = self._passes_done[g]
                while p < header.passes.num_passes and ready(
                        self.section_index("hf", group=g, pass_idx=p)):
                    readers.append((p, take(self.section_index("hf", group=g, pass_idx=p))))
                    p += 1
                if not readers:
                    continue
                self._passes_done[g] = p
                if self.ac_route == "lanes":
                    self.pending_lanes.update({(g, q): br for q, br in readers})
                else:
                    jobs.append((g, readers))
            if jobs:
                self._decode_hf_groups_parallel(jobs)

        if all(self._sec_decoded):
            self.launch_pending_lanes()
            if not self._transforms_done:
                self.lf_global.modular_global.run_transforms()
                self._transforms_done = True
            return None
        need = min(self._section_end(i) for i, d in enumerate(self._sec_decoded) if not d)
        return toc_end + max(need, rel_avail + 1)

    # -- outputs ---------------------------------------------------------------------------

    def modular_channel(self, idx: int) -> np.ndarray:
        return self.lf_global.modular_global.output_channel(idx)
