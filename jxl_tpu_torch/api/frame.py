"""Frame decoding orchestration (host planner), Modular frames only.

Capability reference: jxl/src/frame/{mod,decode}.rs. Parses LfGlobal →
LF groups → HfGlobal → HF groups, dispatching modular section decoding
and producing channel planes for the render pipeline. VarDCT sections,
patches, splines and noise are outside this package's slice: the entry
point (api/simple.py) rejects such frames before any section is read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import LfQuantFactorTooSmall, NotSupported
from ..io.bit_reader import BitReader
from ..io.bundle import F16
from ..io.headers import ColorSpace, FileHeader
from ..io.headers.frame import Encoding, FrameHeader, Toc
from ..modular.image import FullModularImage
from ..modular.tree import Tree

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
class LfGlobalState:
    lf_quant: LfQuantFactors = None
    tree: Tree = None
    modular_global: FullModularImage = None


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

    def decode_lf_global(self, br: BitReader) -> None:
        """ref frame/decode.rs:314-434, Modular frames without patches,
        splines or noise."""
        header = self.header
        if header.encoding != Encoding.MODULAR:
            raise NotSupported("VarDCT frames are not in this package's slice")
        state = LfGlobalState()
        num_ec = len(self.file_header.image_metadata.extra_channel_info)
        size_limit = min(
            1024
            + header.width * header.height * (self.color_channels + num_ec) // 16,
            1 << 22,
        )
        # one native call for the table sequence (lf-quant, global tree)
        from .. import native

        res = native.decode_lf_global_tables_native(br, False, size_limit)
        state.lf_quant = LfQuantFactors(res["lf_quant"])
        state.tree = res["tree"]
        state.modular_global = FullModularImage.read(
            header,
            self.file_header.image_metadata,
            self.modular_color_channels,
            br,
        )
        state.modular_global.read_section0(header, state.tree, br)
        self.lf_global = state

    # -- LF / HF groups ------------------------------------------------------------

    def decode_lf_group(self, group: int, br: BitReader) -> None:
        state = self.lf_global
        state.modular_global.read_lf_stream(self.header, state.tree, group, br)

    def decode_hf_group(self, group: int, pass_readers: list[tuple[int, BitReader]]) -> None:
        state = self.lf_global
        for pass_idx, br in pass_readers:
            state.modular_global.read_hf_stream(
                self.header, state.tree, pass_idx, group, br
            )

    # -- whole-frame decode ------------------------------------------------------------

    def decode_all_sections(self, br: BitReader) -> None:
        header = self.header
        if header.num_toc_entries == 1:
            sec = self.split_sections(br)[0]
            self.decode_lf_global(sec)
            for g in range(header.num_lf_groups):
                self.decode_lf_group(g, sec)
            for g in range(header.num_groups):
                self.decode_hf_group(
                    g, [(p, sec) for p in range(header.passes.num_passes)]
                )
        else:
            sections = self.split_sections(br)
            self.decode_lf_global(sections[self.section_index("lf_global")])
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
            self._decode_hf_groups_parallel(jobs)
        self.lf_global.modular_global.run_transforms()

    def _decode_hf_groups_parallel(self, jobs) -> None:
        """Fan HF-group section decoding out over a host thread pool (the
        reference's work-stealing render fan-out, frame/render.rs:373-459).
        Per-group entropy runs in C++ with the GIL released, and groups
        write disjoint rects, so sections decode concurrently; pass order
        within a group is preserved inside each job."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        n_workers = min(len(jobs), os.cpu_count() or 1)
        if n_workers < 2:
            for g, readers in jobs:
                self.decode_hf_group(g, readers)
            return
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs = [ex.submit(self.decode_hf_group, g, r) for g, r in jobs]
            for f in futs:
                f.result()

    # -- outputs ---------------------------------------------------------------------------

    def modular_channel(self, idx: int) -> np.ndarray:
        return self.lf_global.modular_global.output_channel(idx)
