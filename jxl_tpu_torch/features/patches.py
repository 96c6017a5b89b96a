"""Patches: rectangles copied from reference frames with per-channel
blend modes — the dictionary and its reader.

Counterpart of jxl_tpu/features/patches.py (capability reference:
jxl/src/features/patches.rs). The dictionary is host metadata: reading it
looks only at the reference slots' shapes, never at their pixels, which
stay on the decode's device. The patches are applied by
render/pipeline.py:patches_stage, at coded resolution onto the 3 + num_ec
channel planes, from reference frames saved before the colour transform;
PatchesDictionary.apply_rows is its plain version, patch by patch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..entropy import Histograms, SymbolReader
from ..errors import (PatchesInvalidAlphaChannel, PatchesInvalidBlendMode, PatchesInvalidDelta,
                      PatchesInvalidReference, PatchesOutOfBounds, PatchesPostColorTransform,
                      PatchesTooMany)
from ..io.bit_reader import BitReader

# contexts (ref patches.rs PatchContext)
_NUM_REF_PATCH = 0
_REFERENCE_FRAME = 1
_PATCH_SIZE = 2
_PATCH_REFERENCE_POSITION = 3
_PATCH_POSITION = 4
_PATCH_BLEND_MODE = 5
_PATCH_OFFSET = 6
_PATCH_COUNT = 7
_PATCH_ALPHA_CHANNEL = 8
_PATCH_CLAMP = 9
_NUM_CONTEXTS = 10

MAX_STORED_FRAMES = 4


class BlendMode:
    NONE = 0
    REPLACE = 1
    ADD = 2
    MUL = 3
    BLEND_ABOVE = 4
    BLEND_BELOW = 5
    ALPHA_WEIGHTED_ADD_ABOVE = 6
    ALPHA_WEIGHTED_ADD_BELOW = 7
    COUNT = 8

    @staticmethod
    def uses_alpha(m):
        return m in (4, 5, 6, 7)

    @staticmethod
    def uses_clamp(m):
        return BlendMode.uses_alpha(m) or m == BlendMode.MUL


@dataclass(frozen=True)
class PatchBlending:
    mode: int
    alpha_channel: int = 0
    clamp: bool = False


@dataclass
class RefPosition:
    reference: int
    x0: int
    y0: int
    xsize: int
    ysize: int


@dataclass
class PatchPosition:
    x: int
    y: int
    ref_pos_idx: int


class PatchesDictionary:
    def __init__(self, positions, blendings, ref_positions, blendings_stride):
        self.positions = positions
        self.blendings = blendings
        self.ref_positions = ref_positions
        self.blendings_stride = blendings_stride

    @staticmethod
    def read(br: BitReader, xsize: int, ysize: int, num_extra_channels: int, reference_frames):
        """ref patches.rs read. reference_frames: the decoder state's four
        slots, each None or {"frame": (C, H, W) planes,
        "saved_before_color_transform": bool}; only the planes' shape is
        read."""
        stride = num_extra_channels + 1
        histograms = Histograms.decode(_NUM_CONTEXTS, br, allow_lz77=True)
        reader = SymbolReader(histograms, br)
        num_ref_patch = reader.read_unsigned(histograms, br, _NUM_REF_PATCH)
        num_pixels = xsize * ysize
        max_ref_patches = 1024 + num_pixels // 4
        max_patches = max_ref_patches * 4
        if num_ref_patch > max_ref_patches:
            raise PatchesTooMany("too many reference patches")
        positions: list[PatchPosition] = []
        blendings: list[PatchBlending] = []
        ref_positions: list[RefPosition] = []
        total_patches = 0
        for _ in range(num_ref_patch):
            reference = reader.read_unsigned(histograms, br, _REFERENCE_FRAME)
            if reference >= MAX_STORED_FRAMES:
                raise PatchesInvalidReference("patch reference too large")
            x0 = reader.read_unsigned(histograms, br, _PATCH_REFERENCE_POSITION)
            y0 = reader.read_unsigned(histograms, br, _PATCH_REFERENCE_POSITION)
            rw = reader.read_unsigned(histograms, br, _PATCH_SIZE) + 1
            rh = reader.read_unsigned(histograms, br, _PATCH_SIZE) + 1
            rf = reference_frames[reference]
            if rf is None:
                raise PatchesInvalidReference("patch references missing frame")
            if not rf.get("saved_before_color_transform", True):
                raise PatchesPostColorTransform("patch references post-CT frame")
            ref_h, ref_w = rf["frame"][0].shape
            if x0 + rw > ref_w or y0 + rh > ref_h:
                raise PatchesOutOfBounds("patch reference position out of bounds")
            id_count = reader.read_unsigned(histograms, br, _PATCH_COUNT) + 1
            total_patches += id_count
            if total_patches > max_patches:
                raise PatchesTooMany("too many patches")
            for i in range(id_count):
                if i == 0:
                    px = reader.read_unsigned(histograms, br, _PATCH_POSITION)
                    py = reader.read_unsigned(histograms, br, _PATCH_POSITION)
                else:
                    dx = reader.read_signed(histograms, br, _PATCH_OFFSET)
                    dy = reader.read_signed(histograms, br, _PATCH_OFFSET)
                    px = positions[-1].x + dx
                    py = positions[-1].y + dy
                    if px < 0 or py < 0:
                        raise PatchesInvalidDelta("invalid patch delta")
                if px + rw > xsize or py + rh > ysize:
                    raise PatchesOutOfBounds("patch out of bounds")
                for _ in range(stride):
                    mode = reader.read_unsigned(histograms, br, _PATCH_BLEND_MODE)
                    if mode >= BlendMode.COUNT:
                        raise PatchesInvalidBlendMode("invalid patch blend mode")
                    alpha_channel = 0
                    clamp = False
                    if BlendMode.uses_alpha(mode) and stride > 2:
                        alpha_channel = reader.read_unsigned(
                            histograms, br, _PATCH_ALPHA_CHANNEL
                        )
                        if alpha_channel >= num_extra_channels:
                            raise PatchesInvalidAlphaChannel("invalid patch alpha channel")
                    if BlendMode.uses_clamp(mode):
                        clamp = reader.read_unsigned(histograms, br, _PATCH_CLAMP) != 0
                    blendings.append(PatchBlending(mode, alpha_channel, clamp))
                positions.append(PatchPosition(px, py, len(ref_positions)))
            ref_positions.append(RefPosition(reference, x0, y0, rw, rh))
        reader.check_final_state(histograms, br)
        return PatchesDictionary(positions, blendings, ref_positions, stride)

    # -- application (plain version) ------------------------------------------

    def apply_rows(self, planes, row0: int, extra_channel_info, reference_frames) -> None:
        """Apply every patch, in dictionary order, onto `planes` (3 +
        num_ec float32 tensors covering rows [row0, row0 + rows) of the
        frame), in place (ref jxl_tpu/features/patches.py:159). Blending is
        per pixel, so each patch clipped to the rows gives the whole
        frame's result row for row. The plain version of
        render/pipeline.py:patches_stage."""
        from .blending import perform_blending

        row1 = row0 + planes[0].shape[0]
        stride = self.blendings_stride
        for pi, pos in enumerate(self.positions):
            rp = self.ref_positions[pos.ref_pos_idx]
            y0, y1 = max(pos.y, row0), min(pos.y + rp.ysize, row1)
            if y1 <= y0:
                continue
            ry0 = rp.y0 + (y0 - pos.y)
            ref = reference_frames[rp.reference]["frame"]
            fg = [p[ry0 : ry0 + (y1 - y0), rp.x0 : rp.x0 + rp.xsize] for p in ref]
            bg = [p[y0 - row0 : y1 - row0, pos.x : pos.x + rp.xsize] for p in planes]
            out = perform_blending(bg, fg, self.blendings[pi * stride],
                                   self.blendings[pi * stride + 1 : (pi + 1) * stride],
                                   extra_channel_info)
            for p, o in zip(bg, out):
                p.copy_(o)
