"""Frame header, passes, blending info, restoration filter, TOC.

Capability reference: jxl/src/headers/{frame_header,toc}.rs (spec section
"Frame header"). Written as an explicit procedural reader because many
fields' conditions and defaults depend on earlier fields and on image-level
metadata. Group-geometry helpers at the bottom become the device sharding
spec for the render pipeline.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dfield

from ...errors import InvalidBitstream, InvalidBlending, InvalidEcUpsampling, InvalidLfLevel, InvalidPasses, Non444ChromaSubsampling, NonPatchReferenceWithCrop, PatchesUnsupportedMixedUpsampling
from ..bit_reader import BitReader
from ..bundle import (
    Bits,
    BitsOffset,
    Extensions,
    F16,
    JxlString,
    U32,
    Val,
    unpack_signed,
)
from .permutation import read_toc_permutation

GROUP_DIM = 256
BLOCK_DIM = 8


class FrameType(enum.IntEnum):
    REGULAR = 0
    LF_FRAME = 1
    REFERENCE_ONLY = 2
    SKIP_PROGRESSIVE = 3


class Encoding(enum.IntEnum):
    VARDCT = 0
    MODULAR = 1


class Flags:
    ENABLE_NOISE = 1
    ENABLE_PATCHES = 2
    ENABLE_SPLINES = 0x10
    USE_LF_FRAME = 0x20
    SKIP_ADAPTIVE_LF_SMOOTHING = 0x80


class BlendingMode(enum.IntEnum):
    REPLACE = 0
    ADD = 1
    BLEND = 2
    ALPHA_WEIGHTED_ADD = 3
    MUL = 4


_U64 = None  # placeholder to make imports explicit below


def _read_u64(br: BitReader) -> int:
    from ..bundle import U64

    return U64().read(br)


_H_SHIFT = [0, 1, 1, 0]
_V_SHIFT = [0, 1, 0, 1]


def _floor_log2(x: int) -> int:
    return x.bit_length() - 1


@dataclass
class Passes:
    num_passes: int = 1
    num_ds: int = 0
    shift: list = dfield(default_factory=list)
    downsample: list = dfield(default_factory=list)
    last_pass: list = dfield(default_factory=list)

    @staticmethod
    def read(br: BitReader) -> "Passes":
        p = Passes()
        p.num_passes = U32(Val(1), Val(2), Val(3), BitsOffset(3, 4)).read(br)
        if p.num_passes != 1:
            p.num_ds = U32(Val(0), Val(1), Val(2), BitsOffset(1, 3)).read(br)
            p.shift = [br.read(2) for _ in range(p.num_passes - 1)]
            ds_coder = U32(Val(1), Val(2), Val(4), Val(8))
            p.downsample = [ds_coder.read(br) for _ in range(p.num_ds)]
            lp_coder = U32(Val(0), Val(1), Val(2), Bits(3))
            p.last_pass = [lp_coder.read(br) for _ in range(p.num_ds)]
        else:
            p.shift = []
        return p

    def downsampling_bracket(self, pass_idx: int) -> tuple[int, int]:
        """(min_shift, max_shift) of coefficients contributed by this pass."""
        max_shift = 2
        min_shift = 3
        for i in range(pass_idx + 1):
            for j in range(self.num_ds):
                if i == self.last_pass[j]:
                    min_shift = _floor_log2(self.downsample[j])
            if i + 1 == self.num_passes:
                min_shift = 0
            if i != pass_idx:
                max_shift = max(min_shift - 1, 0) if min_shift > 0 else 0
        return (min_shift, max_shift)


@dataclass
class BlendingInfo:
    mode: BlendingMode = BlendingMode.REPLACE
    alpha_channel: int = 0
    clamp: bool = False
    source: int = 0

    @staticmethod
    def read(br: BitReader, num_extra_channels: int, full_frame: bool) -> "BlendingInfo":
        b = BlendingInfo()
        raw_mode = U32(Val(0), Val(1), Val(2), BitsOffset(2, 3)).read(br)
        if raw_mode > BlendingMode.MUL:
            raise InvalidBlending(f"invalid blending mode {raw_mode}")
        b.mode = BlendingMode(raw_mode)
        uses_alpha = b.mode in (BlendingMode.BLEND, BlendingMode.ALPHA_WEIGHTED_ADD)
        if num_extra_channels > 0 and uses_alpha:
            b.alpha_channel = U32(Val(0), Val(1), Val(2), BitsOffset(3, 3)).read(br)
        if (num_extra_channels > 0 and uses_alpha) or b.mode == BlendingMode.MUL:
            b.clamp = br.read(1) != 0
        if not (full_frame and b.mode == BlendingMode.REPLACE):
            b.source = br.read(2)
        return b


_DEFAULT_EPF_SHARP_LUT = [0.0, 1 / 7, 2 / 7, 3 / 7, 4 / 7, 5 / 7, 6 / 7, 1.0]


@dataclass
class RestorationFilter:
    gab: bool = True
    gab_x_weight1: float = 0.115169525
    gab_x_weight2: float = 0.061248592
    gab_y_weight1: float = 0.115169525
    gab_y_weight2: float = 0.061248592
    gab_b_weight1: float = 0.115169525
    gab_b_weight2: float = 0.061248592
    epf_iters: int = 2
    epf_sharp_lut: list = dfield(default_factory=lambda: list(_DEFAULT_EPF_SHARP_LUT))
    epf_channel_scale: list = dfield(default_factory=lambda: [40.0, 5.0, 3.5])
    epf_pass1_zeroflush: float = 0.45
    epf_pass2_zeroflush: float = 0.6
    epf_quant_mul: float = 0.46
    epf_pass0_sigma_scale: float = 0.9
    epf_pass2_sigma_scale: float = 6.5
    epf_border_sad_mul: float = 2.0 / 3.0
    epf_sigma_for_modular: float = 1.0

    @staticmethod
    def read(br: BitReader, encoding: Encoding) -> "RestorationFilter":
        rf = RestorationFilter()
        if br.read(1) != 0:  # all_default
            return rf
        f16 = F16()
        rf.gab = br.read(1) != 0
        if rf.gab and br.read(1) != 0:  # gab_custom
            rf.gab_x_weight1 = f16.read(br)
            rf.gab_x_weight2 = f16.read(br)
            rf.gab_y_weight1 = f16.read(br)
            rf.gab_y_weight2 = f16.read(br)
            rf.gab_b_weight1 = f16.read(br)
            rf.gab_b_weight2 = f16.read(br)
        rf.epf_iters = br.read(2)
        if rf.epf_iters > 0:
            if encoding == Encoding.VARDCT and br.read(1) != 0:  # sharp_custom
                rf.epf_sharp_lut = [f16.read(br) for _ in range(8)]
            if br.read(1) != 0:  # weight_custom
                rf.epf_channel_scale = [f16.read(br) for _ in range(3)]
                rf.epf_pass1_zeroflush = f16.read(br)
                rf.epf_pass2_zeroflush = f16.read(br)
            if br.read(1) != 0:  # sigma_custom
                if encoding == Encoding.VARDCT:
                    rf.epf_quant_mul = f16.read(br)
                rf.epf_pass0_sigma_scale = f16.read(br)
                rf.epf_pass2_sigma_scale = f16.read(br)
                rf.epf_border_sad_mul = f16.read(br)
            if encoding == Encoding.MODULAR:
                rf.epf_sigma_for_modular = f16.read(br)
        Extensions().read(br)
        return rf


_CROP_COORD = U32(Bits(8), BitsOffset(11, 256), BitsOffset(14, 2304), BitsOffset(30, 18688))


class FrameHeader:
    """One frame's header plus derived geometry.

    Constructed via FrameHeader.read(br, file_header). The `postprocess`
    adjustments (ec_upsampling dim-shift, x_qm_scale reset) are applied
    at the end of read, as in ref frame_header.rs:655-665.
    """

    def __init__(self):
        self.frame_type = FrameType.REGULAR
        self.encoding = Encoding.VARDCT
        self.flags = 0
        self.do_ycbcr = False
        self.jpeg_upsampling = [0, 0, 0]
        self.upsampling = 1
        self.ec_upsampling: list[int] = []
        self.group_size_shift = 1
        self.x_qm_scale = 3
        self.b_qm_scale = 2
        self.passes = Passes()
        self.lf_level = 0
        self.have_crop = False
        self.x0 = 0
        self.y0 = 0
        self.frame_width = 0
        self.frame_height = 0
        self.completely_covers = False
        self.full_frame = True
        self.blending_info = BlendingInfo()
        self.ec_blending_info: list[BlendingInfo] = []
        self.duration = 0
        self.timecode = 0
        self.is_last = True
        self.save_as_reference = 0
        self.can_be_referenced = False
        self.save_before_ct = False
        self.name = ""
        self.restoration_filter = RestorationFilter()
        self.width = 0
        self.height = 0
        self.maxhs = 0
        self.maxvs = 0
        self.num_extra_channels = 0

    # -- parsing -------------------------------------------------------------

    @staticmethod
    def read(br: BitReader, file_header) -> "FrameHeader":
        meta = file_header.image_metadata
        return FrameHeader.read_with(
            br,
            xyb_encoded=meta.xyb_encoded,
            extra_channel_info=meta.extra_channel_info,
            have_animation=meta.animation is not None,
            have_timecode=(meta.animation.have_timecodes if meta.animation else False),
            img_width=file_header.xsize,
            img_height=file_header.ysize,
        )

    @staticmethod
    def read_with(
        br: BitReader,
        *,
        xyb_encoded: bool,
        extra_channel_info: list,
        have_animation: bool,
        have_timecode: bool,
        img_width: int,
        img_height: int,
    ) -> "FrameHeader":
        h = FrameHeader()
        num_ec = len(extra_channel_info)
        h.num_extra_channels = num_ec
        h.ec_upsampling = [1] * num_ec
        h.ec_blending_info = [BlendingInfo() for _ in range(num_ec)]

        br.jump_to_byte_boundary()  # frame headers are byte-aligned
        all_default = br.read(1) != 0
        if not all_default:
            h.frame_type = FrameType(br.read(2))
            h.encoding = Encoding(br.read(1))
            h.flags = _read_u64(br)
            if not xyb_encoded:
                h.do_ycbcr = br.read(1) != 0
            use_lf_frame = (h.flags & Flags.USE_LF_FRAME) != 0
            if h.do_ycbcr and not use_lf_frame:
                h.jpeg_upsampling = [br.read(2) for _ in range(3)]
            ups_coder = U32(Val(1), Val(2), Val(4), Val(8))
            if not use_lf_frame:
                h.upsampling = ups_coder.read(br)
                h.ec_upsampling = [ups_coder.read(br) for _ in range(num_ec)]
            if h.encoding == Encoding.MODULAR:
                h.group_size_shift = br.read(2)
            if h.encoding == Encoding.VARDCT and xyb_encoded:
                h.x_qm_scale = br.read(3)
                h.b_qm_scale = br.read(3)
            if h.frame_type != FrameType.REFERENCE_ONLY:
                h.passes = Passes.read(br)
            if h.frame_type == FrameType.LF_FRAME:
                h.lf_level = U32(Val(1), Val(2), Val(3), Val(4)).read(br)
            if h.frame_type != FrameType.LF_FRAME:
                h.have_crop = br.read(1) != 0
            if h.have_crop and h.frame_type != FrameType.REFERENCE_ONLY:
                h.x0 = unpack_signed(_CROP_COORD.read(br))
                h.y0 = unpack_signed(_CROP_COORD.read(br))
            if h.have_crop:
                h.frame_width = _CROP_COORD.read(br)
                h.frame_height = _CROP_COORD.read(br)

            h.completely_covers = (
                h.x0 <= 0
                and h.y0 <= 0
                and h.frame_width + h.x0 >= img_width
                and h.frame_height + h.y0 >= img_height
            )
            h.full_frame = (not h.have_crop) or h.completely_covers

            is_normal = h.frame_type in (FrameType.REGULAR, FrameType.SKIP_PROGRESSIVE)
            if is_normal:
                h.blending_info = BlendingInfo.read(br, num_ec, h.full_frame)
                h.ec_blending_info = [
                    BlendingInfo.read(br, num_ec, h.full_frame) for _ in range(num_ec)
                ]
                if have_animation:
                    h.duration = U32(Val(0), Val(1), Bits(8), Bits(32)).read(br)
                if have_timecode:
                    h.timecode = br.read(32)
                h.is_last = br.read(1) != 0
            else:
                h.is_last = False
            if h.frame_type != FrameType.LF_FRAME and not h.is_last:
                h.save_as_reference = br.read(2)

            h.can_be_referenced = (
                not h.is_last
                and h.frame_type != FrameType.LF_FRAME
                and (h.duration == 0 or h.save_as_reference != 0)
            )
            save_before_ct_def_false = (
                h.can_be_referenced
                and h.blending_info.mode == BlendingMode.REPLACE
                and h.full_frame
                and is_normal
            )
            h.save_before_ct = h.frame_type == FrameType.LF_FRAME
            if h.frame_type == FrameType.REFERENCE_ONLY or save_before_ct_def_false:
                h.save_before_ct = br.read(1) != 0
            h.name = JxlString().read(br)
            h.restoration_filter = RestorationFilter.read(br, h.encoding)
            Extensions().read(br)
        else:
            h.x_qm_scale = 3 if xyb_encoded else 2

        h.width = h.frame_width if h.frame_width else img_width
        h.height = h.frame_height if h.frame_height else img_height
        h.maxhs = max((_H_SHIFT[c] for c in h.jpeg_upsampling), default=0)
        h.maxvs = max((_V_SHIFT[c] for c in h.jpeg_upsampling), default=0)

        h._check(extra_channel_info)

        # postprocess (ref frame_header.rs:655-665) — runs after validation
        if h.upsampling > 1:
            for i, info in enumerate(extra_channel_info):
                h.ec_upsampling[i] <<= info.dim_shift
        if h.encoding != Encoding.VARDCT or not xyb_encoded:
            h.x_qm_scale = 2
        return h

    def _check(self, extra_channel_info):
        if self.upsampling > 1:
            for info, ec_up in zip(extra_channel_info, self.ec_upsampling):
                eff = ec_up << info.dim_shift
                if eff < self.upsampling or eff > 8:
                    raise InvalidEcUpsampling("invalid ec_upsampling")
        if self.has_patches and self.upsampling != 1:
            for ec_up in self.ec_upsampling:
                if ec_up != self.upsampling:
                    raise PatchesUnsupportedMixedUpsampling("patches with mixed upsampling")
        num_ec = self.num_extra_channels
        for info in [self.blending_info] + self.ec_blending_info:
            if (
                num_ec > 0
                and info.mode in (BlendingMode.BLEND, BlendingMode.ALPHA_WEIGHTED_ADD)
                and info.alpha_channel >= num_ec
            ):
                raise InvalidBlending("invalid blending alpha channel")
        if self.has_lf_frame and self.lf_level >= 4:
            raise InvalidLfLevel("invalid lf_level")
        p = self.passes
        if p.num_ds >= p.num_passes:
            raise InvalidPasses("num_ds >= num_passes")
        for a, b in zip(p.downsample, p.downsample[1:]):
            if b >= a:
                raise InvalidPasses("passes downsample non-decreasing")
        for a, b in zip(p.last_pass, p.last_pass[1:]):
            if b <= a:
                raise InvalidPasses("passes last_pass non-increasing")
        for lp in p.last_pass:
            if lp >= p.num_passes:
                raise InvalidPasses("last_pass too large")
        if (
            not self.save_before_ct
            and not self.full_frame
            and self.frame_type == FrameType.REFERENCE_ONLY
        ):
            raise NonPatchReferenceWithCrop("cropped non-patch reference frame")
        if (
            not self.is444
            and (self.flags & Flags.SKIP_ADAPTIVE_LF_SMOOTHING) == 0
            and self.encoding == Encoding.VARDCT
        ):
            raise Non444ChromaSubsampling("non-444 chroma subsampling with LF smoothing")

    # -- feature flags ---------------------------------------------------------

    @property
    def has_patches(self) -> bool:
        return (self.flags & Flags.ENABLE_PATCHES) != 0

    @property
    def has_noise(self) -> bool:
        return (self.flags & Flags.ENABLE_NOISE) != 0

    @property
    def has_splines(self) -> bool:
        return (self.flags & Flags.ENABLE_SPLINES) != 0

    @property
    def has_lf_frame(self) -> bool:
        return (self.flags & Flags.USE_LF_FRAME) != 0

    @property
    def should_do_adaptive_lf_smoothing(self) -> bool:
        return (
            (self.flags & Flags.SKIP_ADAPTIVE_LF_SMOOTHING) == 0
            and not self.has_lf_frame
            and self.encoding == Encoding.VARDCT
        )

    @property
    def is_visible(self) -> bool:
        return (self.is_last or self.duration > 0) and self.frame_type in (
            FrameType.REGULAR,
            FrameType.SKIP_PROGRESSIVE,
        )

    def needs_blending(self) -> bool:
        if self.frame_type not in (FrameType.REGULAR, FrameType.SKIP_PROGRESSIVE):
            return False
        replace_all = self.blending_info.mode == BlendingMode.REPLACE and all(
            b.mode == BlendingMode.REPLACE for b in self.ec_blending_info
        )
        return self.have_crop or not replace_all

    # -- chroma shifts ---------------------------------------------------------

    def raw_hshift(self, c: int) -> int:
        return _H_SHIFT[self.jpeg_upsampling[c]]

    def hshift(self, c: int) -> int:
        return self.maxhs - self.raw_hshift(c)

    def raw_vshift(self, c: int) -> int:
        return _V_SHIFT[self.jpeg_upsampling[c]]

    def vshift(self, c: int) -> int:
        return self.maxvs - self.raw_vshift(c)

    @property
    def is444(self) -> bool:
        return all(self.hshift(c) == 0 and self.vshift(c) == 0 for c in range(3))

    # -- geometry (the device sharding spec) -----------------------------------

    @property
    def log_group_dim(self) -> int:
        return GROUP_DIM.bit_length() - 2 + self.group_size_shift  # log2(256)-1+s

    @property
    def group_dim(self) -> int:
        return 1 << self.log_group_dim

    @property
    def lf_group_dim(self) -> int:
        return self.group_dim * BLOCK_DIM

    def size(self) -> tuple[int, int]:
        w, hgt = self.size_upsampled()
        u = self.upsampling
        return (-(-w // u), -(-hgt // u))

    def size_upsampled(self) -> tuple[int, int]:
        d = 1 << (3 * self.lf_level)
        return (-(-self.width // d), -(-self.height // d))

    def size_blocks(self) -> tuple[int, int]:
        w, hgt = self.size()
        return (
            (-(-w // (BLOCK_DIM << self.maxhs))) << self.maxhs,
            (-(-hgt // (BLOCK_DIM << self.maxvs))) << self.maxvs,
        )

    def size_padded(self) -> tuple[int, int]:
        if self.encoding == Encoding.MODULAR:
            return self.size()
        bw, bh = self.size_blocks()
        return (bw * BLOCK_DIM, bh * BLOCK_DIM)

    def size_padded_upsampled(self) -> tuple[int, int]:
        w, hgt = self.size_padded()
        return (w * self.upsampling, hgt * self.upsampling)

    def size_groups(self) -> tuple[int, int]:
        w, hgt = self.size()
        g = self.group_dim
        return (-(-w // g), -(-hgt // g))

    def size_lf_groups(self) -> tuple[int, int]:
        bw, bh = self.size_blocks()
        g = self.group_dim
        return (-(-bw // g), -(-bh // g))

    @property
    def num_groups(self) -> int:
        gx, gy = self.size_groups()
        return gx * gy

    @property
    def num_lf_groups(self) -> int:
        gx, gy = self.size_lf_groups()
        return gx * gy

    @property
    def num_toc_entries(self) -> int:
        if self.num_groups == 1 and self.passes.num_passes == 1:
            return 1
        return 2 + self.num_lf_groups + self.num_groups * self.passes.num_passes

    def block_group_rect(self, group: int) -> tuple[tuple[int, int], tuple[int, int]]:
        """((x0, y0), (w, h)) of `group` in 8x8-block units."""
        gx_count, _ = self.size_groups()
        bw, bh = self.size_blocks()
        gdb = self.group_dim >> 3
        gx, gy = group % gx_count, group // gx_count
        ox, oy = gx * gdb, gy * gdb
        return ((ox, oy), (min(bw - ox, gdb), min(bh - oy, gdb)))

    def lf_group_rect(self, group: int) -> tuple[tuple[int, int], tuple[int, int]]:
        """((x0, y0), (w, h)) of LF `group` in 8x8-block units."""
        gx_count, _ = self.size_lf_groups()
        bw, bh = self.size_blocks()
        g = self.group_dim
        gx, gy = group % gx_count, group // gx_count
        ox, oy = gx * g, gy * g
        return ((ox, oy), (min(bw - ox, g), min(bh - oy, g)))


_TOC_ENTRY = U32(Bits(10), BitsOffset(14, 1024), BitsOffset(22, 17408), BitsOffset(30, 4211712))


@dataclass
class Toc:
    permuted: bool
    permutation: list[int]  # section order: permutation[i] = stored index
    entries: list[int]  # byte sizes in stored order

    @staticmethod
    def read(br: BitReader, num_entries: int) -> "Toc":
        permuted = br.read(1) != 0
        permutation = read_toc_permutation(br, num_entries, permuted)
        entries = [_TOC_ENTRY.read(br) for _ in range(num_entries)]
        br.jump_to_byte_boundary()
        return Toc(permuted, permutation, entries)

    @property
    def total_size(self) -> int:
        return sum(self.entries)
