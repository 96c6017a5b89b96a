"""VarDCT LF decode: LF coefficients (as modular stream), dequant+CfL at LF,
HF metadata (CfL maps, transform map, raw quant, EPF sharpness), and
adaptive LF smoothing.

Capability reference: jxl/src/frame/modular/mod.rs:845-1089 and
frame/adaptive_lf_smoothing.rs; the counterpart of jxl_tpu/vardct/lf.py.
The LF group section decodes in one native call where the stream allows
it, else through the modular decoder; numeric parts are numpy on the
host. A frame that reads an LF frame codes no LF coefficients
(try_decode_lf_group declines it; api/frame.py adopts the LF frame's
planes). upsample_lf_groups fills the groups a progressive flush has no
AC for yet, on the render's device.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidBitstream, InvalidEpfValue
from ..io.bit_reader import BitReader
from ..modular.channel import ModularChannel
from ..modular.decode import ModularStreamId, decode_modular_subbitstream
from .transform_map import INVALID_TRANSFORM


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def ensure_vardct_buffers(frame) -> None:
    if frame.lf_image is None:
        bw, bh = frame.header.size_blocks()
        frame.lf_image = [np.zeros((bh, bw), dtype=np.float32) for _ in range(3)]
    if frame.hf_meta is None:
        bw, bh = frame.header.size_blocks()
        tw, th = -(-bw // 8), -(-bh // 8)
        frame.hf_meta = {
            "ytox": np.zeros((th, tw), dtype=np.int8),
            "ytob": np.zeros((th, tw), dtype=np.int8),
            "raw_quant": np.zeros((bh, bw), dtype=np.int32),
            "transform": np.full((bh, bw), INVALID_TRANSFORM, dtype=np.uint8),
            "epf": np.zeros((bh, bw), dtype=np.uint8),
            "quant_lf": np.zeros((bh, bw), dtype=np.uint8),
        }


def try_decode_lf_group(frame, group: int, br: BitReader) -> bool:
    """One native call for the whole VarDCT LF-group section: LF modular
    substream + dequant + CfL at LF + quant-lf bucketing + HF metadata +
    transform placement (ref frame/modular/mod.rs:939-1089). Returns
    False when ineligible (no global tree, modular LF channels present,
    local transforms in-stream) so the caller runs the Python sequence."""
    header = frame.header
    state = frame.lf_global
    if header.has_lf_frame or state.tree is None:
        return False
    mg = state.modular_global
    if len(mg.section_buffer_indices) > 1 and mg.section_buffer_indices[1]:
        return False  # modular LF channels interleave: Python path
    from .. import native

    ensure_vardct_buffers(frame)
    (ox, oy), (w, h) = header.lf_group_rect(group)
    qp = state.quant_params
    inv_quant_lf = qp.GLOBAL_SCALE_DENOM / (qp.global_scale * qp.quant_lf)
    lf_factors = np.array(
        [f * inv_quant_lf for f in state.lf_quant.quant_factors], dtype=np.float64
    )
    ccp = state.color_correlation_params
    bctx = state.block_context_map
    hf = frame.hf_meta
    from .transform_map import _CBX, _CBY

    lf_thr = np.array(
        [t for ch in bctx.lf_thresholds for t in ch], dtype=np.int32
    )
    n_lf_thr = np.array([len(ch) for ch in bctx.lf_thresholds], dtype=np.int32)
    return native.decode_lf_group_vardct_native(
        br, state.tree, group, header.num_lf_groups, ox, oy, w, h,
        frame.lf_image[0].shape[1],
        np.array([header.hshift(c) for c in range(3)], dtype=np.int32),
        np.array([header.vshift(c) for c in range(3)], dtype=np.int32),
        1 if header.is444 else 0, lf_factors,
        float(ccp.y_to_x_lf), float(ccp.y_to_b_lf),
        bctx.num_lf_contexts, lf_thr, n_lf_thr,
        frame.lf_image, hf["quant_lf"], hf["ytox"], hf["ytob"],
        hf["transform"], hf["raw_quant"], hf["epf"],
        np.asarray(_CBX, dtype=np.int32), np.asarray(_CBY, dtype=np.int32),
        INVALID_TRANSFORM,
    )


def decode_vardct_lf(frame, group: int, br: BitReader) -> None:
    """ref modular/mod.rs:939-990 + dequant_lf :845-936."""
    header = frame.header
    state = frame.lf_global
    ensure_vardct_buffers(frame)
    extra_precision = br.read(2)
    mul = 1.0 / (1 << extra_precision)
    stream_id = ModularStreamId.vardct_lf(header, group)
    (ox, oy), (w, h) = header.lf_group_rect(group)

    bits = frame.file_header.image_metadata.bit_depth.bits_per_sample

    def shrink(c):
        return (w >> header.hshift(c), h >> header.vshift(c))

    buffers = [
        ModularChannel(shrink(1), (0, 0), bits),
        ModularChannel(shrink(0), (0, 0), bits),
        ModularChannel(shrink(2), (0, 0), bits),
    ]
    decode_modular_subbitstream(buffers, stream_id, None, state.tree, br)

    qp = state.quant_params
    inv_quant_lf = qp.GLOBAL_SCALE_DENOM / (qp.global_scale * qp.quant_lf)
    lf_factors = [f * inv_quant_lf for f in state.lf_quant.quant_factors]
    ccp = state.color_correlation_params
    bctx = state.block_context_map

    qy_i = buffers[0].data
    qx_i = buffers[1].data
    qb_i = buffers[2].data
    qy = qy_i.astype(np.float32)
    qx = qx_i.astype(np.float32)
    qb = qb_i.astype(np.float32)

    if header.is444:
        in_x = qx * (lf_factors[0] * mul)
        in_y = qy * (lf_factors[1] * mul)
        in_b = qb * (lf_factors[2] * mul)
        frame.lf_image[1][oy : oy + h, ox : ox + w] = in_y
        frame.lf_image[0][oy : oy + h, ox : ox + w] = in_y * ccp.y_to_x_lf + in_x
        frame.lf_image[2][oy : oy + h, ox : ox + w] = in_y * ccp.y_to_b_lf + in_b
    else:
        # modular stream order is [Y, X, B]; lf channel c<2 uses stream c^1
        for c in range(3):
            cw, ch = shrink(c)
            fac = lf_factors[c] * mul
            src = [qy, qx, qb][c ^ 1 if c < 2 else c]
            sx = ox >> header.hshift(c)
            sy = oy >> header.vshift(c)
            frame.lf_image[c][sy : sy + ch, sx : sx + cw] = src[:ch, :cw] * fac

    # quant_lf context bucket image (ref :903-934)
    qlf = frame.hf_meta["quant_lf"]
    if bctx.num_lf_contexts <= 1:
        qlf[oy : oy + h, ox : ox + w] = 0
    else:
        # vectorized threshold bucketing with chroma-shift upsampling
        def upsampled(plane, c):
            ys = np.arange(h) >> header.vshift(c)
            xs = np.arange(w) >> header.hshift(c)
            return plane[np.ix_(ys, xs)]

        px = upsampled(qx_i, 0)
        py = upsampled(qy_i, 1)
        pb = upsampled(qb_i, 2)
        bucket = np.zeros((h, w), dtype=np.int32)
        for t in bctx.lf_thresholds[0]:
            bucket += px > t
        tmp = np.zeros((h, w), dtype=np.int32)
        for t in bctx.lf_thresholds[2]:
            tmp += pb > t
        bucket = bucket * (len(bctx.lf_thresholds[2]) + 1) + tmp
        tmp = np.zeros((h, w), dtype=np.int32)
        for t in bctx.lf_thresholds[1]:
            tmp += py > t
        bucket = bucket * (len(bctx.lf_thresholds[1]) + 1) + tmp
        qlf[oy : oy + h, ox : ox + w] = bucket.astype(np.uint8)


def decode_hf_metadata(frame, group: int, br: BitReader) -> None:
    """ref modular/mod.rs:992-1089."""
    header = frame.header
    state = frame.lf_global
    ensure_vardct_buffers(frame)
    stream_id = ModularStreamId.lf_meta(header, group)
    (ox, oy), (w, h) = header.lf_group_rect(group)
    upper_bound = w * h
    count = br.read(_ceil_log2(upper_bound)) + 1
    cw, ch = -(-w // 8), -(-h // 8)
    cox, coy = ox >> 3, oy >> 3
    bits = frame.file_header.image_metadata.bit_depth.bits_per_sample
    buffers = [
        ModularChannel((cw, ch), (3, 3), bits),
        ModularChannel((cw, ch), (3, 3), bits),
        ModularChannel((count, 2), None, bits),
        ModularChannel((w, h), (0, 0), bits),
    ]
    # Note: the transform/epf channels carry shift metadata in the reference
    # via new_with_shift/new; shifts only affect local squeeze defaults,
    # which do not occur in these streams.
    decode_modular_subbitstream(buffers, stream_id, None, state.tree, br)

    hf = frame.hf_meta
    hf["ytox"][coy : coy + ch, cox : cox + cw] = np.clip(buffers[0].data, -128, 127).astype(np.int8)
    hf["ytob"][coy : coy + ch, cox : cox + cw] = np.clip(buffers[1].data, -128, 127).astype(np.int8)

    transform_image = buffers[2].data
    epf_image = buffers[3].data
    if np.any((epf_image < 0) | (epf_image >= 8)):
        raise InvalidEpfValue("invalid EPF value")
    hf["epf"][oy : oy + h, ox : ox + w] = epf_image.astype(np.uint8)

    tmap = hf["transform"]
    rqmap = hf["raw_quant"]
    _place_transforms(
        frame, tmap, rqmap, transform_image, count, ox, oy, w, h, header
    )


_PLACE_ERRORS = {
    4: "invalid VarDCT transform map",
    5: "invalid transform",
    6: "big block with chroma subsampling",
    7: "HF block out of bounds",
}


def _place_transforms(frame, tmap, rqmap, transform_image, count, ox, oy, w, h, header):
    import ctypes

    from .. import native
    from .transform_map import _CBX, _CBY

    lib = native.get_lib()
    raw_t = np.ascontiguousarray(transform_image[0], dtype=np.int32)
    raw_q = np.ascontiguousarray(transform_image[1], dtype=np.int32)
    cbx = np.asarray(_CBX, dtype=np.int32)
    cby = np.asarray(_CBY, dtype=np.int32)
    ret = lib.jxl_place_transforms(
        native._ptr(raw_t, ctypes.c_int32), native._ptr(raw_q, ctypes.c_int32),
        ctypes.c_int(count),
        tmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rqmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(tmap.shape[1]), ctypes.c_int(w), ctypes.c_int(h),
        ctypes.c_int(ox), ctypes.c_int(oy),
        ctypes.c_int(1 if header.is444 else 0),
        native._ptr(cbx, ctypes.c_int32), native._ptr(cby, ctypes.c_int32),
        ctypes.c_int(INVALID_TRANSFORM),
    )
    if ret != 0:
        raise InvalidBitstream(_PLACE_ERRORS.get(ret, f"transform placement failed ({ret})"))


_W_SIDE = 0.20345139757231578
_W_CORNER = 0.0334829185968739
_W_CENTER = 1.0 - 4.0 * (_W_SIDE + _W_CORNER)


def adaptive_lf_smoothing(frame) -> None:
    """3x3 self-correcting LF smoothing in place (ref
    adaptive_lf_smoothing.rs), in the native library."""
    import ctypes

    from .. import native

    state = frame.lf_global
    qp = state.quant_params
    inv_quant_lf = qp.GLOBAL_SCALE_DENOM / (qp.global_scale * qp.quant_lf)
    lf_factors = [f * inv_quant_lf for f in state.lf_quant.quant_factors]
    lf = frame.lf_image
    h, w = lf[0].shape
    if h <= 2 or w <= 2:
        return
    f = ctypes.c_float
    native.get_lib().jxl_adaptive_lf_smooth(
        native._ptr(lf[0], f), native._ptr(lf[1], f), native._ptr(lf[2], f),
        ctypes.c_int64(h), ctypes.c_int64(w),
        f(np.float32(lf_factors[0])), f(np.float32(lf_factors[1])),
        f(np.float32(lf_factors[2])),
        f(np.float32(_W_CORNER)), f(np.float32(_W_SIDE)),
        f(np.float32(_W_CENTER)),
    )


def upsample_lf_groups(frame, planes: list, groups) -> list:
    """The progressive flush's pixels of the VarDCT groups in `groups`,
    which have no AC pass yet: a 5x5 Upsample8x of the LF image (ref
    frame/decode.rs:58-156 upsample_lf_group; jxl_tpu/vardct/lf.py:328),
    whose borders come from the neighbouring LF groups and are mirrored
    only at the image's edges. That is the whole LF plane upsampled once,
    with the mirror padding of render/stages/core.py:upsample, and kept at
    those groups' pixels: one pass a channel for every such group, on the
    planes' device. planes: the render's three VarDCT planes (XYB, or Cb,
    Y, Cr each at its own size); returns new planes, `planes` unchanged.
    The LF is the frame's own (lf_image) or the adopted LF frame
    (lf_device)."""
    import torch

    from ..render.stages import core as st

    header = frame.header
    dev = planes[0].device
    if frame.lf_device is not None:
        lf = frame.lf_device.to(dev)
    else:
        lf = st.to_device(np.stack(frame.lf_image).astype(np.float32), dev)
    kern = st.build_upsample_kernels(frame.file_header.transform_data.weights8, 8)
    bw, bh = header.size_blocks()
    out = []
    for c in range(3):
        hs, vs = header.hshift(c), header.vshift(c)
        lfw, lfh = (bw + (1 << hs) - 1) >> hs, (bh + (1 << vs) - 1) >> vs
        mask = np.zeros((lfh, lfw), dtype=bool)
        for g in groups:
            (gx0, gy0), (gw, gh) = header.block_group_rect(g)
            x0, y0 = gx0 >> hs, gy0 >> vs
            mask[y0 : (gy0 + gh + (1 << vs) - 1) >> vs, x0 : (gx0 + gw + (1 << hs) - 1) >> hs] = True
        hc, wc = planes[c].shape
        px = st.to_device(mask, dev).repeat_interleave(8, 0).repeat_interleave(8, 1)[:hc, :wc]
        up = st.upsample(lf[c, :lfh, :lfw].contiguous(), kern, 8)[:hc, :wc]
        out.append(torch.where(px, up, planes[c]))
    return out
