"""Whole-animation native fold: one C++ call decodes every frame's
section chain (LfGlobal tables, the global Modular group header and
section-0 channels, the VarDCT LF group with its HF metadata, the
adaptive LF smoothing, HfGlobal and the HF group's AC), and light frame
shims carry the results to the batched render (render/batch_anim.py).

The counterpart of jxl_tpu/render/anim_fold.py. It takes animations of
single-section frames (one TOC entry: one pass, one 256-px group), where
the per-frame Python around five native calls a frame would dominate.
The fold decodes the AC on the host, so K3 does not run on this route.

Frame 0 is decoded both ways: through the per-frame section path (which
also supplies the Modular plan and the dequant matrices) and in the fold.
Its LF planes, HF metadata, CfL tiles, block table, coefficients and
quantizer must agree bit for bit; a disagreement is a fault of the fold
and raises (jxl_tpu quietly reruns the per-frame loop instead). A stream
the fold does not take (local trees, Modular LF or HF streams, per-frame
changes of the group header, custom dequant matrices) makes it decline:
try_anim_fold returns None, trace counts "anim_fold_fallback", and the
caller decodes the frames section by section. JXL_TPU_ANIM_FOLD=0 turns
the fold off. When every frame's Modular plan is squeezes alone (an alpha
channel's squeeze pyramid), one native call runs all frames' inverse
squeezes in the fold's arena (squeeze_arena), and the shims skip their
own.

Unlike jxl_tpu, the fold's buffers are allocated for each call
(native.anim_decode_frames_native: no process-wide arena), and the
C++ span cache of HfGlobal keys on the block-context count as well as
the bits.

Capability reference: frame/decode.rs:314-583 (section chain),
frame/group.rs:384-618 (HF groups).
"""

from __future__ import annotations

import os

import numpy as np

from ..errors import NativeDecodeError
from ..io.bit_reader import BitReader
from ..io.headers.frame import Encoding
from ..utils import trace


def _pack_group_header(gh) -> np.ndarray | None:
    """The C++ fold's packing of a GroupHeader (the rows of
    jxl_anim_decode_frames' gh_out: use_global_tree, the transform count,
    the packed length, the weighted-predictor header, then each
    transform's fields and its squeezes), so that the fold's parse of
    each frame's header can be held against the Python parse of frame 0.
    None when the transforms need more than the 81 packed words."""
    from ..io.headers.modular import TransformId

    out = np.zeros(96, np.int32)
    out[0] = 1 if gh.use_global_tree else 0
    out[1] = len(gh.transforms)
    wp = gh.wp_header
    out[3:15] = (wp.p1c, wp.p2c, wp.p3ca, wp.p3cb, wp.p3cc, wp.p3cd, wp.p3ce,
                 wp.w0, wp.w1, wp.w2, wp.w3, 0)
    packed: list[int] = []
    for t in gh.transforms:
        palette = t.id == TransformId.PALETTE
        if t.id == TransformId.RCT:
            rct_or_nchan = t.rct_type
        else:
            rct_or_nchan = t.num_channels if palette else 0
        packed += [int(t.id), t.begin_channel if t.id != TransformId.SQUEEZE else 0,
                   rct_or_nchan, t.num_colors if palette else 0,
                   t.num_deltas if palette else 0, t.predictor_id if palette else 0,
                   len(t.squeezes)]
        for s in t.squeezes:
            packed += [int(s.horizontal), int(s.in_place), s.begin_channel, s.num_channels]
    if len(packed) > 81:
        return None
    out[2] = len(packed)
    out[15 : 15 + len(packed)] = packed
    return out


class _FoldModular:
    """The global Modular image of one folded frame, over its row of the
    fold's channel arena: every buffer of the frame's plan has a fixed
    offset there, where the fold wrote the coded channels. When every
    frame's plan is squeezes alone, squeeze_arena has run them all in the
    arena (pre_applied) and the outputs are views of it; otherwise the
    inverse transforms run on ModularChannel copies of those views, once."""

    def __init__(self, plan, chan_row, offsets, pre_applied=False):
        self.buffer_infos = plan.buffer_infos
        self.transform_steps = plan.transform_steps
        self.section_buffer_indices = plan.section_buffer_indices
        self._chan_row = chan_row
        self._offsets = offsets
        self.storage = None
        self.transforms_applied = pre_applied or not plan.transform_steps

    def _buffer_view(self, buf: int) -> np.ndarray:
        w, h = self.buffer_infos[buf].size
        off = int(self._offsets[buf])
        return self._chan_row[off : off + w * h].reshape(h, w)

    def run_transforms(self) -> None:
        if self.transforms_applied:
            return
        from ..modular.channel import ModularChannel
        from ..modular.transforms import inverse_apply_steps

        self.storage = [
            ModularChannel(info.size, info.shift, info.bit_depth_bits,
                           data=np.ascontiguousarray(self._buffer_view(buf)))
            for buf, info in enumerate(self.buffer_infos)
        ]
        inverse_apply_steps(self.transform_steps, self.storage)
        self.transforms_applied = True

    def output_channel(self, output_idx: int) -> np.ndarray:
        self.run_transforms()
        for buf, info in enumerate(self.buffer_infos):
            if info.output_channel_idx == output_idx:
                return self.storage[buf].data if self.storage is not None else \
                    self._buffer_view(buf)
        raise KeyError(f"no output channel {output_idx}")


def _squeeze_records(plan, offsets) -> np.ndarray:
    """(n, 11) int64 jxl_squeeze_chain records of `plan`'s inverse squeeze
    steps, in the order they run, over one frame's arena row: each step's
    buffers as byte offsets into the row (the caller adds the row's
    address), then their geometry, as modular/transforms.py's
    _squeeze_chain_native lays them out. Steps with an empty output are
    left out, as apply_hsqueeze and apply_vsqueeze skip them."""
    rows = []
    infos = plan.buffer_infos
    for step in reversed(plan.transform_steps):
        wo, ho = infos[step.buf_out].size
        if wo == 0 or ho == 0:
            continue
        wa, ha = infos[step.buf_in[0]].size
        wr, hr = infos[step.buf_in[1]].size
        pa, pr, po = (int(offsets[b]) * 4 for b in (*step.buf_in, step.buf_out))
        sa, sr = (wa if wa * ha else 0), (wr if wr * hr else 0)
        if step.horizontal:
            rows.append((1, pa, sa, pr, sr, po, wo, ho, wa, wr, wo))
        else:
            rows.append((0, pa, sa, pr, sr, po, wo, wo, ha, hr, ho))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 11)


def squeeze_arena(plans, offsets_all, chan) -> bool:
    """Run every frame's inverse squeezes in the fold's (F, elems) int32
    channel arena `chan` in one native call (native.squeeze_chain_raw; as
    jxl_tpu/render/anim_fold.py:355-411): frame 0's records tiled with
    each frame's row address when every frame has the same steps, buffers
    and offsets, else each frame's records in turn. Returns False, and
    touches nothing, unless every frame's plan is squeezes alone and one
    has a step; the shims then run their transforms themselves."""
    from .. import native
    from ..modular.transforms import SqueezeStep

    if not all(isinstance(st, SqueezeStep) for mg in plans for st in mg.transform_steps):
        return False
    if not any(mg.transform_steps for mg in plans):
        return False
    base, row = chan.ctypes.data, chan.strides[0]
    shared = all(mg.transform_steps == plans[0].transform_steps
                 and mg.buffer_infos == plans[0].buffer_infos
                 and np.array_equal(offsets_all[f], offsets_all[0])
                 for f, mg in enumerate(plans))
    if shared:
        r0 = _squeeze_records(plans[0], offsets_all[0])
        recs = np.tile(r0, (len(plans), 1))
        at = base + np.repeat(np.arange(len(plans), dtype=np.int64) * row, len(r0))
    else:
        parts = [_squeeze_records(mg, offsets_all[f]) for f, mg in enumerate(plans)]
        recs = np.concatenate(parts)
        at = base + np.repeat(np.arange(len(plans), dtype=np.int64) * row,
                              [len(p) for p in parts])
    for col in (1, 3, 5):
        recs[:, col] += at
    if len(recs):
        native.squeeze_chain_raw(recs)
    trace.metrics.add("anim_fold_squeeze_steps", len(recs))
    return True


class _FoldLfGlobal:
    __slots__ = ("quant_params", "color_correlation_params", "modular_global")


class _FoldHfGlobal:
    __slots__ = ("dequant_matrices",)


class _FoldFrame:
    """What render/batch_anim.py reads of a frame: its headers, LfGlobal
    and HfGlobal results, LF planes, HF metadata, its row of the fold's
    coefficient pool and its block table."""

    __slots__ = ("header", "toc", "file_header", "decoder_state", "lf_global", "hf_global",
                 "lf_image", "lf_device", "hf_meta", "icc_profile", "coeffs", "blocks")


def _decode_one_frame_deferred(fh, codestream, rec, icc_profile, device):
    """Frame `rec` through the per-frame section path, nothing rendered:
    the fold's oracle and the source of its Modular plan and dequant
    matrices. Its AC is decoded on the host (a single-section frame's
    route), into frame.host_ac_flat."""
    from ..api.frame import Frame
    from ..api.state import DecoderState

    header, toc, sections_start = rec
    state = DecoderState(fh)
    if header.is_visible:
        state.visible_frame_index += 1
    br = BitReader(codestream)
    br.pos = sections_start
    frame = Frame(header, toc, fh, state)
    frame.icc_profile = icc_profile
    frame.decode_all_sections(br, device)
    return frame


def _decline():
    trace.metrics.add("anim_fold_fallback", 1)
    return None


def eligible(recs) -> bool:
    """Every frame is single-section VarDCT: one TOC entry, one pass,
    256-px groups, at most 32x32 blocks."""
    for header, _toc, _pos in recs:
        bw, bh = header.size_blocks()
        if (header.num_toc_entries != 1 or header.passes.num_passes != 1
                or header.group_dim != 256 or header.encoding != Encoding.VARDCT
                or bw > 32 or bh > 32):
            return False
    return True


def _oracle_mismatches(f0, out, fdims, tdims) -> list:
    """The names of frame 0's fold outputs that differ from the per-frame
    decode `f0`: LF planes, HF metadata, CfL tiles, block table,
    coefficients, quantizer and colour correlation."""
    from ..vardct.group import _BlockList

    w, h = fdims[0]
    tw, th = tdims[0]
    hf0 = f0.hf_meta

    def view(slab, hh, ww):
        return slab[0].reshape(-1)[: hh * ww].reshape(hh, ww)

    bad = [f"lf[{c}]" for c in range(3)
           if not np.array_equal(out["lf"][c, 0].reshape(-1)[: h * w].reshape(h, w),
                                 f0.lf_image[c])]
    for key, slab, hh, ww in (("raw_quant", "rq", h, w), ("quant_lf", "qlf", h, w),
                              ("transform", "tmap", h, w), ("epf", "epf", h, w),
                              ("ytox", "ytox", th, tw), ("ytob", "ytob", th, tw)):
        if not np.array_equal(view(out[slab], hh, ww), hf0[key]):
            bad.append(key)
    bl = _BlockList(f0, 0)
    gx0, gy0 = bl.origin
    want = np.stack([bl.bxs + gx0, bl.bys + gy0, bl.tids, bl.offs], 1).astype(np.int32)
    if not np.array_equal(out["blocks"][0, : int(out["blk_counts"][0])], want):
        bad.append("blocks")
    if not np.array_equal(out["pool"][0].reshape(-1), np.asarray(f0.host_ac_flat)):
        bad.append("coefficients")
    qp = f0.lf_global.quant_params
    if (int(out["scal"][0, 0]), int(out["scal"][0, 1])) != (qp.global_scale, qp.quant_lf):
        bad.append("quant_params")
    ccp = f0.lf_global.color_correlation_params
    scal, dbl = out["scal"][0], out["dbl"][0]
    if (int(scal[10]), float(dbl[3]), float(dbl[4]), int(scal[11]), int(scal[12])) != (
            ccp.color_factor, float(ccp.base_correlation_x), float(ccp.base_correlation_b),
            ccp.ytox_lf, ccp.ytob_lf):
        bad.append("color_correlation")
    return bad


def try_anim_fold(fh, codestream, recs, icc_profile, device="cuda", span_cache: bool = True):
    """The fold over `recs` ([(FrameHeader, Toc, first section bit)] of
    every frame): a list of frame shims, sections decoded, nothing
    rendered, or None when JXL_TPU_ANIM_FOLD=0 or the fold declines the
    stream (trace counts "anim_fold_fallback"). Raises NativeDecodeError
    when frame 0's fold outputs differ from its per-frame decode.
    span_cache=False turns the C++ bit-span caches off."""
    if os.environ.get("JXL_TPU_ANIM_FOLD", "1") == "0":
        return None
    if not eligible(recs):
        return _decline()
    from .. import native
    from ..api.frame import QuantizerParams
    from ..modular.image import FullModularImage
    from ..vardct.block_context import BlockContextMap
    from ..vardct.cfl import ColorCorrelationParams
    from ..vardct.transform_map import INVALID_TRANSFORM

    meta = fh.image_metadata
    f0 = _decode_one_frame_deferred(fh, codestream, recs[0], icc_profile, device)
    lg0 = f0.lf_global
    if lg0.tree is None:
        return _decline()
    mg0 = lg0.modular_global
    gh0 = getattr(mg0, "global_header", None) if mg0.buffer_infos else None
    if gh0 is not None and not gh0.use_global_tree:
        return _decline()
    if any(s for s in mg0.section_buffer_indices[1:]):
        return _decline()
    gh0_packed = _pack_group_header(gh0) if gh0 is not None else np.zeros(96, np.int32)
    if gh0_packed is None:
        return _decline()

    # each frame's Modular plan (a squeeze plan depends on the frame's
    # size); frame 0's group header is assumed for all and checked after
    plans = [mg0] + [
        FullModularImage.from_header(h, FullModularImage.channel_list(h, meta, 0), gh0,
                                     allocate=False)
        for h, _, _ in recs[1:]]
    offsets_all, tmpl_parts = [], []
    chan_counts = np.zeros(len(recs), np.int32)
    chan_tmpl_off = np.zeros(len(recs), np.int64)
    chan_frame_elems = n_rows = 0
    for f, mg in enumerate(plans):
        if any(s for s in mg.section_buffer_indices[1:]):
            return _decline()
        offsets = np.zeros(max(len(mg.buffer_infos), 1), np.int64)
        off = 0
        for buf, info in enumerate(mg.buffer_infos):
            offsets[buf] = off
            off += info.size[0] * info.size[1]
        sec0 = mg.section_buffer_indices[0] if mg.buffer_infos else []
        tmpl = np.zeros((len(sec0), 6), np.int64)
        for i, buf in enumerate(sec0):
            info = mg.buffer_infos[buf]
            w, h = info.size
            sx, sy = info.shift if info.shift is not None else (-1, -1)
            tmpl[i] = (w, h, sx, sy, w, offsets[buf])
        chan_counts[f] = len(sec0)
        chan_tmpl_off[f] = n_rows
        n_rows += len(sec0)
        tmpl_parts.append(tmpl)
        offsets_all.append(offsets)
        chan_frame_elems = max(chan_frame_elems, off)
    chan_template = np.concatenate(tmpl_parts).reshape(-1)

    num_ec = len(meta.extra_channel_info)
    # the smallest frame's limit: a limit below a frame's own can only make
    # the fold refuse, never take a stream the per-frame decode refuses
    tree_size_limit = min(
        min(1024 + h.width * h.height * (f0.color_channels + num_ec) // 16 for h, _, _ in recs),
        1 << 22)
    fdims = [h.size_blocks() for h, _, _ in recs]
    tdims = [(-(-w // 8), -(-h // 8)) for w, h in fdims]
    cbw, cbh = -(-fh.xsize // 8), -(-fh.ysize // 8)
    sbw = max(cbw, max(w for w, _ in fdims))
    sbh = max(cbh, max(h for _, h in fdims))
    tcw, tch = -(-sbw // 8), -(-sbh // 8)
    h0 = recs[0][0]
    out = native.anim_decode_frames_native(
        BitReader(codestream),
        np.array([pos for _, _, pos in recs], np.uint64),
        np.array([pos // 8 + toc.total_size for _, toc, pos in recs], np.uint64),
        sbw, sbh, tcw, tch,
        np.array([w for w, _ in fdims], np.int32), np.array([h for _, h in fdims], np.int32),
        np.array([h0.hshift(c) for c in range(3)], np.int32),
        np.array([h0.vshift(c) for c in range(3)], np.int32),
        1 if h0.is444 else 0,
        np.array([1 if h.should_do_adaptive_lf_smoothing else 0 for h, _, _ in recs], np.uint8),
        chan_counts, chan_tmpl_off, chan_template, chan_frame_elems, tree_size_limit,
        np.asarray(BlockContextMap.default().context_map, np.uint8), INVALID_TRANSFORM,
        has_modular=gh0 is not None, span_cache=span_cache,
    )
    if out is None:
        return None  # counted by the binding
    if not np.array_equal(out["gh"][0], gh0_packed):
        trace.metrics.add("anim_fold_oracle_mismatch", 1)
        raise NativeDecodeError("the animation fold read frame 0's group header apart from "
                                "its per-frame decode")
    if not (out["gh"] == out["gh"][0]).all():
        # a later frame's group header is not frame 0's, whose plans the
        # fold decoded every frame's channels with
        return _decline()
    bad = _oracle_mismatches(f0, out, fdims, tdims)
    if bad:
        trace.metrics.add("anim_fold_oracle_mismatch", 1)
        raise NativeDecodeError(
            f"the animation fold disagrees with frame 0's per-frame decode on {bad}")

    def view(slab, f, hh, ww):
        return slab[f].reshape(-1)[: hh * ww].reshape(hh, ww)

    pre_applied = squeeze_arena(plans, offsets_all, out["chan"])
    frames = []
    for f, (header, toc, _pos) in enumerate(recs):
        w, h = fdims[f]
        tw, th = tdims[f]
        scal, dbl = out["scal"][f], out["dbl"][f]
        lg = _FoldLfGlobal()
        lg.quant_params = QuantizerParams(int(scal[0]), int(scal[1]))
        lg.color_correlation_params = ColorCorrelationParams(
            int(scal[10]), float(dbl[3]), float(dbl[4]), int(scal[11]), int(scal[12]))
        lg.modular_global = _FoldModular(plans[f], out["chan"][f], offsets_all[f], pre_applied)
        hg = _FoldHfGlobal()
        hg.dequant_matrices = f0.hf_global.dequant_matrices
        fr = _FoldFrame()
        fr.header, fr.toc, fr.file_header = header, toc, fh
        fr.decoder_state = f0.decoder_state
        fr.icc_profile = icc_profile
        fr.lf_global, fr.hf_global = lg, hg
        fr.lf_image = [out["lf"][c, f].reshape(-1)[: h * w].reshape(h, w) for c in range(3)]
        fr.lf_device = None
        fr.hf_meta = {
            "ytox": view(out["ytox"], f, th, tw), "ytob": view(out["ytob"], f, th, tw),
            "raw_quant": view(out["rq"], f, h, w), "transform": view(out["tmap"], f, h, w),
            "epf": view(out["epf"], f, h, w), "quant_lf": view(out["qlf"], f, h, w),
        }
        fr.coeffs = out["pool"][f].reshape(-1)
        fr.blocks = out["blocks"][f, : int(out["blk_counts"][f])]
        frames.append(fr)
    trace.metrics.add("anim_fold_frames", len(frames))
    return frames

