"""Multi-frame test streams, and checks that the JAX package reads them back.

The frames' content comes from the single-frame writers
(test_torch_vardct_streams.py:encode_xyb_vardct,
test_torch_streams.py:encode_xyb_modular): `frame_sections` takes a
writer's codestream apart at its TOC, and `encode_frames` puts such
sections under one file header (with an animation header, a preview or
neither) and a frame header of its own each, written here: frame type,
crop (x0/y0 may be negative), the colour's and each extra channel's
blending info, duration, is_last, save_as_reference, save_before_ct,
the patches flag and the restoration filters. A patches frame carries a
dictionary (`patches_dictionary`) of many patches, coded with two flat
rANS clusters and HybridUint configs, ahead of the rest of its LfGlobal
section.

The streams:
- `anim_vardct_stream`: an XYB VarDCT animation, a full first frame saved
  to slot 1 after the colour transform, then cropped frames across the
  canvas (one with a negative x0, one past the right edge, one with a
  negative y0) blending by REPLACE, ADD and MUL over sources 0 and 1;
- `anim_rgba_stream`: an sRGB (not XYB) Modular animation with an 8-bit
  straight alpha, whose cropped frames BLEND with their alpha, as an
  animated GIF or APNG converts;
- `patches_stream`: a REFERENCE_ONLY XYB Modular glyph atlas saved before
  the colour transform in slot 0, then an XYB VarDCT frame whose
  dictionary places 16x32 glyphs from it (a screen of text);
- `anim_replace_stream`: a small VarDCT animation of REPLACE frames and
  durations alone, the kind jxl_tpu's batched animation route takes (of
  single-section frames up to 256x256, which its animation fold takes;
  with an alpha channel or not).
Any of them may start with a preview frame.

This module imports neither jax nor jxl_tpu at the top: chip_smoke.py
imports the writer. The tests below import the JAX package inside each
test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pytest

from mini_encoder import BW, u32, u64
from test_torch_streams import encode_xyb_modular
from test_torch_vardct_streams import (USE_LF_FRAME, BitList, _signed_token, bitlist_bits,
                                       encode_xyb_vardct, hybrid_tokens, write_ans_flat_histograms,
                                       write_bits, write_colour_encoding, write_passes,
                                       write_rans_stream)

# frame types and blending modes, as the frame header codes them
REGULAR, LF_FRAME, REFERENCE_ONLY = 0, 1, 2
REPLACE, ADD, BLEND, ALPHA_WEIGHTED_ADD, MUL = range(5)
# a patch's blend modes, as the dictionary codes them (features/patches.py
# BlendMode): modes 3-7 code a clamp flag
PATCH_REPLACE, PATCH_ADD, PATCH_MUL = 1, 2, 3
ENABLE_PATCHES = 2
# sRGB colours of the non-XYB Modular frames: 128 + 32 r, 96 + 32 r and
# 160 + 32 r for residuals r in -2..1 (the writer's modular order is
# channel 0, 1, 2)
RGB_LEAVES = ((128, 5), (96, 5), (160, 5))
GLYPH = (16, 32)  # a patch's width and height
TICKS = 4  # each animation frame's duration, at 100 ticks a second

_SIZE = (("bits", 9), ("bits", 13), ("bits", 18), ("bits", 30))
_UPS = (("val", 1), ("val", 2), ("val", 4), ("val", 8))
_BLEND_MODE = (("val", 0), ("val", 1), ("val", 2), ("bitsoff", 2, 3))
_ALPHA_CHANNEL = (("val", 0), ("val", 1), ("val", 2), ("bitsoff", 3, 3))
_DURATION = (("val", 0), ("val", 1), ("bits", 8), ("bits", 32))
_CROP = (("bits", 8), ("bitsoff", 11, 256), ("bitsoff", 14, 2304), ("bitsoff", 30, 18688))
_TOC_ENTRY = (("bits", 10), ("bitsoff", 14, 1024), ("bitsoff", 22, 17408),
              ("bitsoff", 30, 4211712))


@dataclass
class FrameSpec:
    """One frame of encode_frames: its sections (from frame_sections) and
    its frame header's fields. blend and each entry of ec_blend are
    (mode, alpha_channel, clamp, source); crop is (x0, y0, width, height)
    or None (a REFERENCE_ONLY frame codes no x0, y0)."""

    sections: list
    encoding: str  # "vardct" or "modular"
    frame_type: int = REGULAR
    crop: tuple | None = None
    blend: tuple = (REPLACE, 0, False, 0)
    ec_blend: tuple = ()
    duration: int = 0
    is_last: bool = False
    save_as_reference: int = 0
    save_before_ct: bool = False
    filters: bool = True
    flags: int = 0
    lf_level: int = 1
    passes: int = 1


def frame_sections(data: bytes) -> list:
    """The section bytes of a single-frame codestream of the writers, cut
    at its TOC (read with jxl_tpu_torch's own header readers)."""
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.io.headers.frame import FrameHeader, Toc

    br = BitReader(data)
    fh = FileHeader.read(br)
    header = FrameHeader.read(br, fh)
    toc = Toc.read(br, header.num_toc_entries)
    assert not toc.permuted
    pos = br.pos // 8
    out = []
    for n in toc.entries:
        out.append(data[pos : pos + n])
        pos += n
    assert pos == len(data)
    return out


def _file_header(w: BW, width, height, xyb, num_ec, animation, preview, icc=None):
    """The file header (and, with `icc`, the bits of an ICC profile from
    test_torch_icc_streams.encode_icc after it)."""
    w.write(0xFF, 8)
    w.write(0x0A, 8)
    w.write(0, 1)  # SizeHeader: not small
    u32(w, _SIZE, height - 1)
    w.write(0, 3)  # ratio
    u32(w, _SIZE, width - 1)
    w.write(0, 1)  # ImageMetadata all_default = 0
    extra = animation is not None or preview is not None
    w.write(int(extra), 1)  # extra_fields
    if extra:
        w.write(0, 3)  # orientation: identity
        w.write(0, 1)  # no intrinsic size
        w.write(int(preview is not None), 1)
        if preview is not None:
            pw, ph = preview
            w.write(0, 1)  # not div8
            u32(w, (("bits", 6), ("bitsoff", 8, 64), ("bitsoff", 10, 320),
                    ("bitsoff", 12, 1344)), ph - 1)
            w.write(0, 3)  # ratio
            u32(w, (("bits", 6), ("bitsoff", 8, 64), ("bitsoff", 10, 320),
                    ("bitsoff", 12, 1344)), pw - 1)
        w.write(int(animation is not None), 1)
        if animation is not None:
            num, den = animation
            u32(w, (("val", 100), ("val", 1000), ("bitsoff", 10, 1), ("bitsoff", 30, 1)), num)
            u32(w, (("val", 1), ("val", 1001), ("bitsoff", 8, 1), ("bitsoff", 10, 1)), den)
            w.write(0, 2)  # num_loops: 0 (forever)
            w.write(0, 1)  # no timecodes
    w.write(0, 1)  # integer samples
    w.write(0, 2)  # 8 bits
    w.write(1, 1)  # modular_16bit_sufficient
    w.write(num_ec, 2)  # extra channels: Val(0) or Val(1)
    for _ in range(num_ec):
        w.write(1, 1)  # ExtraChannelInfo all_default: 8-bit straight alpha
    w.write(int(xyb), 1)  # xyb_encoded
    write_colour_encoding(w, icc)
    if extra:
        w.write(1, 1)  # tone mapping all_default
    w.write(0, 2)  # extensions
    w.write(1, 1)  # CustomTransformData all_default
    if icc is not None:
        write_bits(w, icc)


def _blending(w: BW, b, num_ec, full_frame):
    mode, alpha, clamp, source = b
    u32(w, _BLEND_MODE, mode)
    uses_alpha = mode in (BLEND, ALPHA_WEIGHTED_ADD)
    if num_ec and uses_alpha:
        u32(w, _ALPHA_CHANNEL, alpha)
    if (num_ec and uses_alpha) or mode == MUL:
        w.write(int(clamp), 1)
    if not (full_frame and mode == REPLACE):
        w.write(source, 2)
    elif source:
        raise ValueError("a full REPLACE frame codes no blend source")


def _frame_header(w: BW, f: FrameSpec, img, xyb, num_ec, animation):
    """FrameHeader fields in the order FrameHeader.read_with reads them."""
    img_w, img_h = img
    w.pad_to_byte()
    w.write(0, 1)  # all_default = 0
    w.write(f.frame_type, 2)
    w.write(0 if f.encoding == "vardct" else 1, 1)
    u64(w, f.flags)
    if not xyb:
        w.write(0, 1)  # do_ycbcr
    if not f.flags & USE_LF_FRAME:  # a frame that reads an LF frame codes none
        u32(w, _UPS, 1)  # upsampling
        for _ in range(num_ec):
            u32(w, _UPS, 1)  # ec_upsampling
    if f.encoding == "modular":
        w.write(1, 2)  # group_size_shift = 1 -> 256
    elif xyb:
        w.write(3, 3)  # x_qm_scale
        w.write(2, 3)  # b_qm_scale
    if f.frame_type != REFERENCE_ONLY:
        write_passes(w, f.passes)
    if f.frame_type == LF_FRAME:
        u32(w, (("val", 1), ("val", 2), ("val", 3), ("val", 4)), f.lf_level)
    full_frame = True
    if f.frame_type != LF_FRAME:
        w.write(int(f.crop is not None), 1)
        if f.crop is not None:
            x0, y0, cw, ch = f.crop
            if f.frame_type != REFERENCE_ONLY:
                u32(w, _CROP, int(_signed_token(x0)))
                u32(w, _CROP, int(_signed_token(y0)))
                full_frame = x0 <= 0 and y0 <= 0 and cw + x0 >= img_w and ch + y0 >= img_h
            else:
                full_frame = False
            u32(w, _CROP, cw)
            u32(w, _CROP, ch)
    normal = f.frame_type == REGULAR
    is_last = f.is_last if normal else False
    if normal:
        for b in (f.blend,) + tuple(f.ec_blend):
            _blending(w, b, num_ec, full_frame)
        if animation is not None:
            u32(w, _DURATION, f.duration)
        w.write(int(f.is_last), 1)
    elif f.is_last or f.duration:
        raise ValueError("only a REGULAR frame has a duration or is the last")
    if f.frame_type != LF_FRAME and not is_last:
        w.write(f.save_as_reference, 2)
    elif f.save_as_reference:
        raise ValueError("this frame codes no save_as_reference")
    can_be_referenced = (not is_last and f.frame_type != LF_FRAME
                         and (f.duration == 0 or f.save_as_reference != 0))
    before_ct_coded = f.frame_type == REFERENCE_ONLY or (
        can_be_referenced and f.blend[0] == REPLACE and full_frame and normal)
    if before_ct_coded:
        w.write(int(f.save_before_ct), 1)
    elif f.save_before_ct:
        raise ValueError("this frame codes no save_before_ct")
    u32(w, (("val", 0), ("bits", 4), ("bitsoff", 5, 16), ("bitsoff", 10, 48)), 0)  # name
    if f.filters:
        w.write(1, 1)  # RestorationFilter all_default (gaborish, EPF 2 steps)
    else:
        w.write(0, 1)
        w.write(0, 1)  # gaborish off
        w.write(0, 2)  # epf_iters 0
        w.write(0, 2)  # extensions
    w.write(0, 2)  # extensions
    w.write(0, 1)  # TOC not permuted
    w.pad_to_byte()
    for s in f.sections:
        u32(w, _TOC_ENTRY, len(s))
    w.pad_to_byte()


def encode_frames(width: int, height: int, frames, *, xyb: bool = True, num_ec: int = 0,
                  animation=None, preview=None, icc=None) -> bytes:
    """A codestream of `frames` (FrameSpec list) under one file header:
    8-bit, sRGB, XYB or not, num_ec 8-bit straight alpha channels (0 or 1),
    an animation header (tps numerator, denominator) or None, and a preview
    (FrameSpec, its (width, height)) or None, written before the frames.
    icc: None, or the bytes of an ICC profile, embedded after the file
    header (before the preview)."""
    w = BW()
    if icc is not None:
        from test_torch_icc_streams import encode_icc

        icc = encode_icc(icc)
    _file_header(w, width, height, xyb, num_ec, animation,
                 None if preview is None else preview[1], icc)
    out = bytearray()
    todo = [(preview[0], preview[1])] if preview is not None else []
    todo += [(f, (width, height)) for f in frames]
    for f, img in todo:
        _frame_header(w, f, img, xyb, num_ec, animation)
        out += w.finish()
        w = BW()
        for s in f.sections:
            out += s
    return bytes(out)


# -- the patches dictionary ------------------------------------------------------

# the dictionary's ten contexts over two clusters: positions and offsets in
# cluster 1 (HybridUint (4, 1, 0), 64 symbols), the rest in cluster 0 ((4, 0,
# 0), 32 symbols)
_PATCH_CMAP = [0, 0, 0, 1, 1, 0, 1, 0, 0, 0]
_PATCH_ALPHABETS = (32, 64)
_PATCH_UINT = ((4, 0, 0), (4, 1, 0))


def patches_dictionary(refs, placements, mode=PATCH_ADD, num_ec=0) -> tuple:
    """(bits, nbits): the dictionary of ref patch `i` = refs[i], a (slot,
    x0, y0, width, height) rect, placed at placements[i], a list of (x, y)
    in decode order (the first absolute, the rest as signed offsets from
    the previous), each with blend `mode` on the colour and every extra
    channel. bits is a uint8 array of nbits bits, LSB first."""
    toks = [(0, len(refs))]
    stride = num_ec + 1
    for (slot, x0, y0, rw, rh), places in zip(refs, placements):
        toks += [(1, slot), (3, x0), (3, y0), (2, rw - 1), (2, rh - 1), (7, len(places) - 1)]
        for i, (x, y) in enumerate(places):
            if i == 0:
                toks += [(4, x), (4, y)]
            else:
                px, py = places[i - 1]
                toks += [(6, int(_signed_token(x - px))), (6, int(_signed_token(y - py)))]
            for _ in range(stride):
                toks.append((5, mode))
                if mode >= 4 and stride > 2:
                    raise ValueError("alpha modes with more than one extra channel")
                if mode >= PATCH_MUL:
                    toks.append((9, 0))  # clamp off
    w = BitList()
    write_ans_flat_histograms(w, _PATCH_CMAP, _PATCH_ALPHABETS, _PATCH_UINT)
    ctx = np.array([c for c, _ in toks])
    cl = np.array(_PATCH_CMAP)[ctx]
    tk, raw, nraw = hybrid_tokens([v for _, v in toks], cl, _PATCH_UINT, _PATCH_ALPHABETS)
    write_rans_stream(w, tk, cl, raw, nraw, _PATCH_ALPHABETS)
    bits = bitlist_bits(w)
    return bits, len(bits)


def prepend_bits(bits, section: bytes) -> bytes:
    """`bits` (uint8 0/1, LSB first) followed by the bits of `section`."""
    tail = np.unpackbits(np.frombuffer(section, np.uint8), bitorder="little")
    return np.packbits(np.concatenate([bits, tail]), bitorder="little").tobytes()


def text_layout(width, height, atlas, num_patches, num_glyphs, seed, overlap=0):
    """(refs, placements): num_glyphs GLYPH-sized cells of the atlas
    (width, height) in slot 0, and num_patches distinct cells of a
    GLYPH-sized grid over the frame, each showing one glyph, grouped by
    glyph in raster order: a screen of text. With overlap > 0, that many
    more patches sit half a glyph down and right of a chosen one."""
    gw, gh = GLYPH
    aw, ah = atlas
    per_row = aw // gw
    assert num_glyphs <= per_row * (ah // gh)
    refs = [(0, gw * (g % per_row), gh * (g // per_row), gw, gh) for g in range(num_glyphs)]
    rng = np.random.default_rng(seed)
    cols, rows = width // gw, height // gh
    cells = np.sort(rng.choice(cols * rows, num_patches, replace=False))
    glyph = rng.integers(0, num_glyphs, num_patches)
    xs, ys = (cells % cols) * gw, (cells // cols) * gh
    extra = rng.choice(num_patches, overlap, replace=False) if overlap else []
    ok = [(xs[i] + gw + gw // 2 <= width and ys[i] + gh + gh // 2 <= height) for i in extra]
    xs = np.concatenate([xs, [xs[i] + gw // 2 for i, k in zip(extra, ok) if k]]).astype(int)
    ys = np.concatenate([ys, [ys[i] + gh // 2 for i, k in zip(extra, ok) if k]]).astype(int)
    glyph = np.concatenate([glyph, rng.integers(0, num_glyphs, int(sum(ok)))])
    placements = [[(int(x), int(y)) for x, y, g in zip(xs, ys, glyph) if g == k]
                  for k in range(num_glyphs)]
    used = [i for i, p in enumerate(placements) if p]
    return [refs[i] for i in used], [placements[i] for i in used]


# -- the streams ------------------------------------------------------------------


def _vardct(width, height, seed, density=0.2):
    data, _ = encode_xyb_vardct(width, height, seed=seed, density=density)
    return frame_sections(data)


def _modular(width, height, seed, **kw):
    data, _ = encode_xyb_modular(width, height, seed=seed, **kw)
    return frame_sections(data)


def crop_offsets(width, height, cw, ch):
    """Seven crop offsets across a width x height canvas for cw x ch
    frames: a negative x0, one past the right edge, one at the bottom, a
    negative y0 and three inside."""
    dx, dy = width - cw, height - ch
    return [(-cw // 8, dy // 4), (dx + cw // 8, dy // 2), (dx // 2, 0), (dx // 4, dy),
            (3 * dx // 4, dy // 3), (0, -ch // 8), (dx // 3, dy // 2)]


# (mode, clamp, source) of the cropped VarDCT frames, in turn
VARDCT_BLENDS = ((ADD, False, 1), (REPLACE, False, 1), (MUL, True, 1), (REPLACE, False, 0),
                 (ADD, False, 0), (MUL, False, 1), (ADD, False, 1))


def _preview_spec(xyb, num_ec):
    pw, ph = 320, 40
    sections = _modular(pw, ph, seed=99, num_ec=num_ec,
                        **({} if xyb else {"leaves": RGB_LEAVES}))
    return FrameSpec(sections, "modular", is_last=True, duration=TICKS), (pw, ph)


def anim_vardct_stream(width, height, crop, num_frames=8, seed=0, preview=False) -> bytes:
    """An XYB VarDCT animation at 100 ticks a second, TICKS a frame: frame
    0 full and saved to slot 1 after the colour transform, the others
    crop-sized (crop = (width, height)) at crop_offsets, blending as
    VARDCT_BLENDS and each saved to slot 1; default filters."""
    cw, ch = crop
    frames = [FrameSpec(_vardct(width, height, seed), "vardct", duration=TICKS,
                        save_as_reference=1)]
    offs = crop_offsets(width, height, cw, ch)
    for k in range(1, num_frames):
        mode, clamp, source = VARDCT_BLENDS[(k - 1) % len(VARDCT_BLENDS)]
        x0, y0 = offs[(k - 1) % len(offs)]
        last = k == num_frames - 1
        frames.append(FrameSpec(_vardct(cw, ch, seed + k), "vardct", crop=(x0, y0, cw, ch),
                                blend=(mode, 0, clamp, source), duration=TICKS, is_last=last,
                                save_as_reference=0 if last else 1))
    return encode_frames(width, height, frames, animation=(100, 1),
                         preview=_preview_spec(True, 0) if preview else None)


def anim_rgba_stream(width, height, crop, num_frames=8, seed=0, preview=False) -> bytes:
    """An 8-bit sRGB Modular animation with a straight alpha, as an
    animated GIF or APNG converts: frame 0 full, REPLACE; the others
    crop-sized at crop_offsets, the colour and the alpha each BLENDing
    with the alpha over slot 1, each saved there; no filters."""
    cw, ch = crop

    def content(w, h, s):
        return _modular(w, h, s, leaves=RGB_LEAVES, num_ec=1)

    frames = [FrameSpec(content(width, height, seed), "modular", duration=TICKS,
                        save_as_reference=1, filters=False, ec_blend=((REPLACE, 0, False, 0),))]
    offs = crop_offsets(width, height, cw, ch)
    for k in range(1, num_frames):
        x0, y0 = offs[(k - 1) % len(offs)]
        last = k == num_frames - 1
        frames.append(FrameSpec(content(cw, ch, seed + k), "modular", crop=(x0, y0, cw, ch),
                                blend=(BLEND, 0, False, 1), ec_blend=((BLEND, 0, False, 1),),
                                duration=TICKS, is_last=last,
                                save_as_reference=0 if last else 1, filters=False))
    return encode_frames(width, height, frames, xyb=False, num_ec=1, animation=(100, 1),
                         preview=_preview_spec(False, 1) if preview else None)


def patches_stream(width, height, atlas, num_patches, num_glyphs, seed=0, mode=PATCH_ADD,
                   overlap=0, preview=False) -> bytes:
    """A still image of two frames: a REFERENCE_ONLY XYB Modular glyph
    atlas of size `atlas`, saved before the colour transform in slot 0
    (no filters), then the last frame, an XYB VarDCT frame with the
    default filters whose dictionary places num_patches GLYPH-sized
    patches from num_glyphs atlas cells (text_layout) with blend `mode`."""
    aw, ah = atlas
    ref = FrameSpec(_modular(aw, ah, seed), "modular", frame_type=REFERENCE_ONLY,
                    crop=(0, 0, aw, ah), save_before_ct=True, filters=False)
    refs, places = text_layout(width, height, atlas, num_patches, num_glyphs, seed + 1, overlap)
    bits, _ = patches_dictionary(refs, places, mode)
    sections = _vardct(width, height, seed + 2)
    sections[0] = prepend_bits(bits, sections[0])
    main = FrameSpec(sections, "vardct", flags=ENABLE_PATCHES, is_last=True)
    return encode_frames(width, height, [ref, main],
                         preview=_preview_spec(True, 0) if preview else None)


def anim_replace_stream(width, height, num_frames=5, seed=0, num_ec=0, density=0.2,
                        frame_kw=None, **kw) -> bytes:
    """A small XYB VarDCT animation of full REPLACE frames, each shown for
    TICKS + its index ticks: no frame is referenced, so jxl_tpu's batched
    animation route takes it. A frame of at most 256x256 is one section
    (one TOC entry), the frames the whole-animation fold takes. num_ec=1
    adds an 8-bit straight alpha to every frame, replaced as the colour.
    kw: encode_xyb_vardct options for every frame; frame_kw(k): more of
    them for frame k (two sets of dequant tables by turns, for one)."""
    def sections(k):
        more = dict(kw, **(frame_kw(k) if frame_kw else {}))
        return frame_sections(encode_xyb_vardct(width, height, seed=seed + k, density=density,
                                                num_ec=num_ec, **more)[0])

    frames = [FrameSpec(sections(k), "vardct", duration=TICKS + k,
                        ec_blend=((REPLACE, 0, False, 0),) * num_ec,
                        is_last=k == num_frames - 1) for k in range(num_frames)]
    return encode_frames(width, height, frames, num_ec=num_ec, animation=(100, 1))


def anim_crop_replace_stream(width, height, crop, num_frames=8, seed=0,
                             density=0.2) -> bytes:
    """An XYB VarDCT animation whose frames stand alone, as a GIF's
    frames do once disposed: frame 0 full, the others crop-sized (crop =
    (width, height)) at crop_offsets (a negative x0, one past the right
    edge, a negative y0, ...), every frame REPLACE over the empty slot 0,
    none saved; default filters. jxl_tpu's multihost decode takes it."""
    cw, ch = crop
    frames = [FrameSpec(_vardct(width, height, seed, density), "vardct", duration=TICKS)]
    offs = crop_offsets(width, height, cw, ch)
    for k in range(1, num_frames):
        x0, y0 = offs[(k - 1) % len(offs)]
        frames.append(FrameSpec(_vardct(cw, ch, seed + k, density), "vardct",
                                crop=(x0, y0, cw, ch), duration=TICKS,
                                is_last=k == num_frames - 1))
    return encode_frames(width, height, frames, animation=(100, 1))


def lf_frame_stream(width=320, height=200, levels=1, passes=1, seed=5, density=0.2,
                    lz77=False) -> bytes:
    """A progressive still image as cjxl -p --progressive_dc writes it: an
    XYB Modular LF frame at 1/8 of the image's size (lf_level 1, no
    filters), then the last frame, an XYB VarDCT frame with the default
    filters that reads its LF from it (USE_LF_FRAME) and codes its AC in
    `passes` passes (lz77: LZ77 on in the AC histograms, which sends the
    AC to the host decoder). With levels=2 the LF frame is itself a VarDCT
    frame (lf_level 1) that reads its LF from a Modular LF frame at 1/64
    of the image's size (lf_level 2); its width must then pass 256."""
    frames = []
    for level in range(levels, 0, -1):
        d = 8 ** level
        lw, lh = -(-width // d), -(-height // d)
        if level == levels:
            frames.append(FrameSpec(_modular(lw, lh, seed + level), "modular",
                                    frame_type=LF_FRAME, lf_level=level, filters=False))
        else:
            data, _ = encode_xyb_vardct(lw, lh, seed=seed + level, density=density,
                                        lf_frame=True)
            frames.append(FrameSpec(frame_sections(data), "vardct", frame_type=LF_FRAME,
                                    lf_level=level, flags=USE_LF_FRAME))
    data, _ = encode_xyb_vardct(width, height, seed=seed, density=density, passes=passes,
                                lf_frame=True, lz77=lz77)
    frames.append(FrameSpec(frame_sections(data), "vardct", is_last=True, flags=USE_LF_FRAME,
                            passes=passes))
    return encode_frames(width, height, frames)


CONTAINER_SIGNATURE = bytes([0, 0, 0, 0x0C, 0x4A, 0x58, 0x4C, 0x20, 0x0D, 0x0A, 0x87, 0x0A])


def box(kind: bytes, payload: bytes) -> bytes:
    """An ISOBMFF box with a 32-bit size."""
    return (8 + len(payload)).to_bytes(4, "big") + kind + payload


def jxlp_container(codestream: bytes, cuts, order=None) -> bytes:
    """`codestream` in a JPEG XL container: the signature, an ftyp box,
    then jxlp boxes holding the codestream cut at the byte offsets `cuts`,
    part i indexed i (the last with the high bit set), placed in the file
    in `order` (default: index order)."""
    bounds = [0, *cuts, len(codestream)]
    parts = [codestream[a:b] for a, b in zip(bounds, bounds[1:])]
    last = len(parts) - 1
    boxes = [box(b"jxlp", (i | (0x80000000 if i == last else 0)).to_bytes(4, "big") + p)
             for i, p in enumerate(parts)]
    order = range(len(parts)) if order is None else order
    return (CONTAINER_SIGNATURE + box(b"ftyp", b"jxl \0\0\0\0jxl ")
            + b"".join(boxes[i] for i in order))


# -- the JAX package reads the streams back -------------------------------------


def _ref_decode(data, **kw):
    from jxl_tpu.api.simple import decode_image

    return decode_image(data, **kw)


def test_one_frame_rewraps_to_the_writers_bytes():
    """A writer's single frame, taken apart and put back under this
    module's headers, gives the writer's own bytes: the headers here write
    what the single-frame writers write, and those writers are unchanged."""
    v, _ = encode_xyb_vardct(520, 300, seed=5)
    assert encode_frames(520, 300, [FrameSpec(frame_sections(v), "vardct", is_last=True)]) == v
    m, _ = encode_xyb_modular(600, 700, seed=3)
    assert encode_frames(600, 700, [FrameSpec(frame_sections(m), "modular", is_last=True)]) == m


@pytest.mark.parametrize("preview", [False, True])
def test_jxl_tpu_reads_the_vardct_animation(preview, monkeypatch):
    monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "off")
    data = anim_vardct_stream(320, 200, (288, 96), num_frames=5, seed=3, preview=preview)
    img = _ref_decode(data)
    meta = img.file_header.image_metadata
    assert (meta.preview is not None) == preview
    assert meta.animation.tps_numerator == 100 and meta.animation.tps_denominator == 1
    assert len(img.frames) == 5 and img.durations == [40.0] * 5
    assert all(f.shape == (200, 320, 3) for f in img.frames)
    assert all(np.isfinite(f).all() for f in img.frames)


def test_jxl_tpu_reads_the_rgba_animation(monkeypatch):
    monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "off")
    data = anim_rgba_stream(320, 200, (288, 96), num_frames=5, seed=4)
    img = _ref_decode(data)
    assert not img.file_header.image_metadata.xyb_encoded
    assert len(img.frames) == 5 and img.durations == [40.0] * 5
    assert all(f.shape == (200, 320, 4) for f in img.frames)
    # frame 0's alpha is the writer's: 0, 64, 128 or 192 over 255
    assert set(np.unique(np.round(img.frames[0][..., 3] * 255)).tolist()) <= {0, 64, 128, 192}


def test_frame_headers_read_as_written():
    from jxl_tpu.api.simple import parse_frame
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader

    data = anim_vardct_stream(320, 200, (288, 96), num_frames=5, seed=3)
    br = BitReader(data)
    fh = FileHeader.read(br)
    headers = []
    while True:
        br.jump_to_byte_boundary()
        frame = parse_frame(br, fh)
        headers.append(frame.header)
        br.jump_to_byte_boundary()
        br.skip_bits(frame.toc.total_size * 8)
        if frame.header.is_last:
            break
    offs = crop_offsets(320, 200, 288, 96)
    assert len(headers) == 5
    assert not headers[0].have_crop and headers[0].save_as_reference == 1
    assert not headers[0].save_before_ct and headers[0].can_be_referenced
    for k, h in enumerate(headers[1:], 1):
        assert (h.x0, h.y0, h.width, h.height) == (*offs[k - 1], 288, 96)
        mode, clamp, source = VARDCT_BLENDS[k - 1]
        assert (int(h.blending_info.mode), h.blending_info.clamp, h.blending_info.source) == (
            mode, clamp, source)
        assert h.duration == TICKS and h.is_visible and h.needs_blending()
    assert headers[1].x0 < 0 and headers[2].x0 + 288 > 320
    assert headers[-1].is_last


def test_jxl_tpu_reads_the_patches_stream():
    from jxl_tpu.api.simple import parse_frame
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader

    data = patches_stream(512, 384, (320, 64), 120, 30, seed=6)
    img = _ref_decode(data)
    assert len(img.frames) == 1 and img.frames[0].shape == (384, 512, 3)
    assert img.durations == [0.0]
    br = BitReader(data)
    fh = FileHeader.read(br)
    ref = parse_frame(br, fh).header
    assert int(ref.frame_type) == REFERENCE_ONLY and ref.save_before_ct
    assert (ref.width, ref.height) == (320, 64) and not ref.is_visible


def test_jxl_tpu_reads_many_patches_with_their_positions():
    """The dictionary of 500 patches reads back, through jxl_tpu's
    reader, as the layout wrote it: each patch's position, reference rect
    and ADD blending."""
    from jxl_tpu.features.patches import PatchesDictionary
    from jxl_tpu.io.bit_reader import BitReader

    refs, places = text_layout(1024, 768, (320, 64), 500, 40, 11)
    bits, nbits = patches_dictionary(refs, places, PATCH_ADD)
    br = BitReader(np.packbits(bits, bitorder="little").tobytes() + bytes(8))
    slot = {"frame": [np.zeros((64, 320), np.float32)] * 3, "saved_before_color_transform": True}
    pd = PatchesDictionary.read(br, 1024, 768, 0, [slot, None, None, None])
    assert br.pos == nbits
    want = [(x, y, r) for r, p in enumerate(places) for x, y in p]
    assert [(p.x, p.y, p.ref_pos_idx) for p in pd.positions] == want
    assert [(r.reference, r.x0, r.y0, r.xsize, r.ysize) for r in pd.ref_positions] == refs
    assert {(b.mode, b.clamp) for b in pd.blendings} == {(2, False)}


def test_lf_frame_headers_read_as_written():
    from jxl_tpu.api.simple import parse_frame
    from jxl_tpu.io.bit_reader import BitReader
    from jxl_tpu.io.headers import FileHeader

    br = BitReader(lf_frame_stream())
    fh = FileHeader.read(br)
    lf = parse_frame(br, fh)
    assert int(lf.header.frame_type) == LF_FRAME and lf.header.lf_level == 1
    assert lf.header.size() == (40, 25) and len(lf.toc.entries) == 1
    br.jump_to_byte_boundary()
    br.skip_bits(lf.toc.total_size * 8)
    main = parse_frame(br, fh)
    assert main.header.is_last and main.header.size() == (320, 200)


def test_jxl_tpu_reads_the_replace_animation_on_both_routes(monkeypatch):
    data = anim_replace_stream(320, 200, 5, seed=8)
    monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "off")
    a = _ref_decode(data, pixel_format="u8")
    monkeypatch.delenv("JXL_TPU_BATCH_ANIM")
    b = _ref_decode(data, pixel_format="u8")
    assert a.durations == b.durations == [10.0 * (TICKS + k) for k in range(5)]
    for x, y in zip(a.frames, b.frames):
        assert x.shape == (200, 320, 3)
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1


@pytest.mark.parametrize("size, num_ec", [((192, 128), 0), ((256, 256), 0), ((192, 128), 1)])
def test_jxl_tpu_reads_the_single_section_animation(size, num_ec, monkeypatch):
    """Frames of at most 256x256 are one section each (one TOC entry), the
    frames jxl_tpu's animation fold takes; its per-frame loop and its
    default batched route read them alike."""
    data = anim_replace_stream(*size, 4, seed=12, num_ec=num_ec)
    monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "off")
    a = _ref_decode(data, pixel_format="u8")
    monkeypatch.delenv("JXL_TPU_BATCH_ANIM")
    b = _ref_decode(data, pixel_format="u8")
    assert a.durations == b.durations == [10.0 * (TICKS + k) for k in range(4)]
    for x, y in zip(a.frames, b.frames):
        assert x.shape == (size[1], size[0], 3 + num_ec)
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1
