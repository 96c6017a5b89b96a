"""VarDCT HF groups on the host: block geometry, the AC item table, the
quant bias, the native whole-frame AC decode, and the per-group AC decode
of frames whose groups also carry modular HF channels.

Capability reference: jxl/src/frame/group.rs; the counterpart of
jxl_tpu/vardct/group.py. A frame on the caller's device renders through
vardct/device_frame.py; a frame on the host render route
(utils/devhealth.py) through render_vardct_frame_host here: the dequant,
chroma from luma and inverse transforms of every group at once, bucketed
by transform type, in the native C++ (jxl_dct8_fused for 4:4:4 DCT8
blocks, jxl_dequant_cfl for the others) and the port's transforms_batch.py
on CPU tensors. jxl_tpu's pure-Python AC decoder (_decode_pass_oracle)
does not come across: the port's native library raises when it cannot be
built, so nothing would call it.
"""

from __future__ import annotations

import numpy as np

from ..io.headers.frame import Encoding
from .transform_map import block_shape_id, covered_blocks_x, covered_blocks_y

BLOCK_DIM = 8
BLOCK_SIZE = 64
GROUP_DIM = 256


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def adjust_quant_bias(quant: np.ndarray, c: int, biases) -> np.ndarray:
    """ref group.rs:85-97."""
    q = quant.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        adjusted = np.where(quant == 0, 0.0, q - np.float32(biases[3]) / q)
    return np.where(np.abs(quant) < 2, q * np.float32(biases[c]), adjusted).astype(
        np.float32
    )


_CBX_ARR = np.array([covered_blocks_x(t) for t in range(27)], dtype=np.int32)
_CBY_ARR = np.array([covered_blocks_y(t) for t in range(27)], dtype=np.int32)
_SHAPE_ARR = np.array([block_shape_id(t) for t in range(27)], dtype=np.int32)


class _BlockList:
    """Geometry of all transform blocks in a group, precomputed once.

    Vectorized over the group's transform map: per-block arrays (raster
    order, matching the reference's by/bx scan in frame/group.rs:418).
    `offs` is each block's int32 offset into the group's coefficient
    buffer: the running sum of the earlier blocks' coefficient counts.
    """

    def __init__(self, frame, group):
        header = frame.header
        hf = frame.hf_meta
        (gx0, gy0), (gw, gh) = header.block_group_rect(group)
        self.origin = (gx0, gy0)
        self.size = (gw, gh)
        self.hshift = [header.hshift(c) for c in range(3)]
        self.vshift = [header.vshift(c) for c in range(3)]
        region = np.asarray(hf["transform"][gy0 : gy0 + gh, gx0 : gx0 + gw])
        bys, bxs = np.nonzero(region >= 128)
        self.bys = bys.astype(np.int32)
        self.bxs = bxs.astype(np.int32)
        self.tids = (region[bys, bxs] & 127).astype(np.int32)
        self.cxs = _CBX_ARR[self.tids]
        self.cys = _CBY_ARR[self.tids]
        self.shape_ids = _SHAPE_ARR[self.tids]
        sizes = self.cxs * self.cys * BLOCK_SIZE
        self.offs = np.zeros(len(sizes), dtype=np.int32)
        if len(sizes) > 1:
            # np.cumsum into an int32 out keeps the reference's int32 offsets
            np.cumsum(sizes[:-1], out=self.offs[1:])
        self._pass_cache = {}


def _build_pass_items(frame, bl, bctx):
    """Pass-independent item table of the AC decoders, vectorized.

    Rows interleave channels (1, 0, 2) per block in raster order, matching
    the bitstream token order (ref frame/group.rs:418-446). Columns: c,
    sbx, sby, num_blocks, num_coeffs, block_context, (6, 7 filled by the
    caller), c*GD*GD + coefficient offset, cx, cy. Also returns each row's
    (shape_id, c) order key and the keys in first-occurrence order.
    """
    hshift, vshift = bl.hshift, bl.vshift
    (gx0, gy0) = bl.origin
    hf = frame.hf_meta
    n = len(bl.tids)
    rq = np.asarray(hf["raw_quant"])[gy0 + bl.bys, gx0 + bl.bxs].astype(np.int64)
    qlf = np.asarray(hf["quant_lf"])[gy0 + bl.bys, gx0 + bl.bxs].astype(np.int64)
    if bctx.qf_thresholds:
        thr = np.asarray(bctx.qf_thresholds, dtype=np.int64)
        qf_idx = (rq[:, None] > thr[None, :]).sum(axis=1)
    else:
        qf_idx = np.zeros(n, dtype=np.int64)
    cmap = np.asarray(bctx.context_map, dtype=np.int32)
    nq1 = len(bctx.qf_thresholds) + 1
    num_blocks = bl.cxs * bl.cys
    num_coeffs = num_blocks * BLOCK_SIZE

    cols = np.zeros((n, 3, 11), dtype=np.int32)
    valid = np.zeros((n, 3), dtype=bool)
    keys = np.zeros((n, 3), dtype=np.int32)
    for j, c in enumerate((1, 0, 2)):
        hs, vs = hshift[c], vshift[c]
        sbx = bl.bxs >> hs
        sby = bl.bys >> vs
        valid[:, j] = ((sbx << hs) == bl.bxs) & ((sby << vs) == bl.bys)
        cidx = (c ^ 1) if c < 2 else 2
        midx = (cidx * 13 + bl.shape_ids.astype(np.int64)) * nq1 + qf_idx
        midx = midx * bctx.num_lf_contexts + qlf
        keys[:, j] = bl.shape_ids * 3 + c
        cols[:, j, 0] = c
        cols[:, j, 1] = sbx
        cols[:, j, 2] = sby
        cols[:, j, 3] = num_blocks
        cols[:, j, 4] = num_coeffs
        cols[:, j, 5] = cmap[midx]
        cols[:, j, 8] = c * GROUP_DIM * GROUP_DIM + bl.offs
        cols[:, j, 9] = bl.cxs
        cols[:, j, 10] = bl.cys
    vmask = valid.reshape(-1)
    items = cols.reshape(-1, 11)[vmask]
    flat_keys = keys.reshape(-1)[vmask]
    # (shape_id, c) keys in first-occurrence order; order lengths are fixed
    # per shape so the concatenated-offset layout is identical across passes
    _, first = np.unique(flat_keys, return_index=True)
    ordered_keys = flat_keys[np.sort(first)]
    return items, flat_keys, ordered_keys.tolist()


def try_decode_hf_groups(frame, group_readers: list, pool: np.ndarray) -> bool:
    """Whole-frame native HF-group decode: one C++ call decodes every
    group's AC section into `pool`, the zeroed dense (G * 3 * GD * GD,)
    int32 buffer (page-locked when the render runs on the card), kept as
    frame.host_ac_flat for the render.

    Single-pass VarDCT frames whose modular HF sections carry no channels;
    returns False for any other frame. `group_readers` is
    [(group_index, BitReader)] in group order. Raises typed errors on
    invalid streams."""
    header = frame.header
    if header.encoding != Encoding.VARDCT or header.passes.num_passes != 1:
        return False
    from .. import native

    state = frame.lf_global
    mg = state.modular_global
    if any(len(s) > 0 for s in mg.section_buffer_indices[2:]):
        return False  # modular HF channels interleave with the AC tokens
    hf_global = frame.hf_global
    hf = frame.hf_meta
    bctx = state.block_context_map
    pstate = hf_global.passes[0]

    tmap = hf["transform"]
    # coeff orders for the shapes present in this frame, concatenated with
    # a per-(shape, channel)-key offset LUT
    tids = np.unique(tmap[tmap >= 128]).astype(np.int32) & 127
    shapes = np.unique(_SHAPE_ARR[tids]).tolist()
    order_off = np.zeros(13 * 3, dtype=np.int32)
    parts = []
    pos = 0
    for s in shapes:
        for c in range(3):
            k = int(s) * 3 + c
            arr = np.ascontiguousarray(pstate.coeff_orders[k], dtype=np.int32)
            order_off[k] = pos
            parts.append(arr)
            pos += len(arr)
    orders_arr = np.concatenate(parts) if parts else np.zeros(1, np.int32)

    n = len(group_readers)
    if [g for g, _ in group_readers] != list(range(header.num_groups)):
        raise ValueError("try_decode_hf_groups takes every group, in order")
    stride = GROUP_DIM * GROUP_DIM  # VarDCT groups are always 256 px
    if pool.shape != (n * 3 * stride,) or pool.dtype != np.int32:
        raise ValueError("pool must be the frame's (G * 3 * GD * GD,) int32 buffer")
    bw, bh = header.size_blocks()
    out_pos = native.decode_hf_groups_native(
        [sec for _, sec in group_readers],
        list(range(n)),
        list(range(n)),
        bw, bh, header.size_groups()[0], GROUP_DIM // BLOCK_DIM,
        np.array([header.hshift(c) for c in range(3)], dtype=np.int32),
        np.array([header.vshift(c) for c in range(3)], dtype=np.int32),
        np.ascontiguousarray(tmap),
        np.ascontiguousarray(hf["raw_quant"], dtype=np.int32),
        np.ascontiguousarray(hf["quant_lf"]),
        np.asarray(bctx.context_map, dtype=np.uint8),
        bctx.num_contexts, bctx.num_lf_contexts,
        np.asarray(bctx.qf_thresholds, dtype=np.int32),
        bctx.num_ac_contexts, hf_global.num_histograms,
        _CBX_ARR, _CBY_ARR, _SHAPE_ARR,
        native.pack_entropy(pstate.histograms),
        orders_arr, order_off,
        header.passes.shift[0] if len(header.passes.shift) > 0 else 0,
        pool, stride,
    )
    for i, (_, sec) in enumerate(group_readers):
        sec.pos = out_pos[i]
    frame.host_ac_flat = pool
    return True


def decode_vardct_group(frame, group: int, pass_readers: list, coeffs: np.ndarray) -> None:
    """One group's AC, pass after pass, into `coeffs`, the group's
    (3, GD * GD) int32 slot of the frame's coefficient pool (ref
    frame/group.rs:384-618; jxl_tpu/vardct/group.py:decode_vardct_group
    and _decode_pass_native). pass_readers: [(pass index, BitReader)];
    each reader is left at the bit after its AC, where the group's
    modular HF stream of that pass begins."""
    from .. import native
    from ..errors import InvalidHistogramIndex

    header = frame.header
    hf_global = frame.hf_global
    bctx = frame.lf_global.block_context_map
    bl = _BlockList(frame, group)
    items, flat_keys, ordered_keys = _build_pass_items(frame, bl, bctx)
    gw, gh = bl.size
    nz_dims = np.zeros((3, 3), dtype=np.int32)
    pos = 0
    for c in range(3):
        w, h = gw >> bl.hshift[c], gh >> bl.vshift[c]
        nz_dims[c] = (w, h, pos)
        pos += w * h
    num_histo_bits = _ceil_log2(hf_global.num_histograms)
    for pass_idx, br in pass_readers:
        histogram_index = br.read(num_histo_bits)
        if histogram_index >= hf_global.num_histograms:
            raise InvalidHistogramIndex("invalid histogram index")
        pstate = hf_global.passes[pass_idx]
        # the pass's coefficient orders of the group's (shape, channel) keys
        off_lut = np.zeros(max(ordered_keys, default=0) + 1, dtype=np.int32)
        parts = []
        at = 0
        for k in ordered_keys:
            parts.append(np.asarray(pstate.coeff_orders[k], dtype=np.int32))
            off_lut[k] = at
            at += len(parts[-1])
        orders = np.concatenate(parts) if parts else np.zeros(1, np.int32)
        pass_items = items.copy()
        pass_items[:, 6] = histogram_index * bctx.num_ac_contexts
        pass_items[:, 7] = off_lut[flat_keys]
        shift = header.passes.shift[pass_idx] if pass_idx < len(header.passes.shift) else 0
        native.decode_vardct_ac_native(
            br, native.pack_entropy(pstate.histograms), pass_items, orders, coeffs, shift,
            bctx.num_contexts, np.zeros(max(pos, 1), dtype=np.int32), nz_dims,
        )


# -- the host render ----------------------------------------------------------


def ensure_pixel_buffers(frame) -> list:
    """frame.vardct_pixels, three zeroed float32 planes (bh*8 >> vshift(c),
    bw*8 >> hshift(c)), made at the first call (ref
    jxl_tpu/vardct/group.py:44)."""
    if getattr(frame, "vardct_pixels", None) is None:
        bw, bh = frame.header.size_blocks()
        frame.vardct_pixels = [
            np.zeros(((bh * BLOCK_DIM) >> frame.header.vshift(c),
                      (bw * BLOCK_DIM) >> frame.header.hshift(c)), dtype=np.float32)
            for c in range(3)
        ]
    return frame.vardct_pixels


def _scatter_blocks(outp, pix, bx, by) -> None:
    """(n, ph, pw) float32 pixel blocks into the plane `outp` at rows by*8,
    columns bx*8 (ref jxl_tpu/vardct/group.py:288): the native row copy, or
    one fancy-index assignment where it declines (blocks never overlap)."""
    from .. import native

    pix = np.asarray(pix, dtype=np.float32)
    if native.scatter_blocks_native(outp, pix, bx, by):
        return
    n, ph, pw = pix.shape
    rows = by[:, None, None] * BLOCK_DIM + np.arange(ph)[None, :, None]
    cols = bx[:, None, None] * BLOCK_DIM + np.arange(pw)[None, None, :]
    outp[rows, cols] = pix


def render_vardct_frame_host(frame, flat=None) -> list:
    """The frame's three planes (XYB, or Cb, Y, Cr at their own sizes), as
    float32 numpy arrays the caller owns, rendered on the host (ref
    jxl_tpu/vardct/group.py:render_vardct_frame_host, :489): every block
    of every group at once (render_blocks_host). flat: the dense (G * 3 *
    GD * GD,) int32 coefficients of every group in order;
    frame.host_ac_flat by default, zeros before any AC."""
    if flat is None:
        flat = frame.host_ac_flat
    if flat is None:
        flat = np.zeros(frame.header.num_groups * 3 * GROUP_DIM * GROUP_DIM, np.int32)
    planes = ensure_pixel_buffers(frame)
    frame.vardct_pixels = None  # the next render starts from zeros
    render_blocks_host([frame], flat, [0], planes, planes[1].shape[0])
    return planes


def _host_lf(frame) -> list:
    """The frame's LF planes as float32 numpy: its own (lf_image) or the
    adopted LF frame's (lf_device), which a frame on the host route holds
    on the host (api/simple.py:finish_frame keeps a host-routed LF frame's
    planes there); a CUDA tensor raises."""
    if frame.lf_device is not None:
        return list(frame.lf_device.numpy())
    return [np.asarray(p, dtype=np.float32) for p in frame.lf_image]


def render_blocks_host(frames, flat, slots, planes, rows_apart: int) -> int:
    """Dequant + CfL + inverse transform of every block of every group of
    `frames`, one transform type at a time over all of them (ref
    jxl_tpu/vardct/group.py:_render_group, :556-735, and the transforms
    of jxl_tpu/render/batch_anim.py:render_frames_batched_host), into
    `planes`, three float32 planes in which frame f's rows start at f *
    rows_apart (a multiple of 8; one frame for a still, an animation's
    stack for render/batch_anim.py). flat: the dense int32 coefficients,
    numpy or a CPU tensor, frame f's group g at slot slots[f] + g. A
    chroma-subsampled frame renders alone, each channel at its own grid.
    4:4:4 DCT8 blocks go through jxl_dct8_fused in one pass; every other
    type through jxl_dequant_cfl, then transforms_batch.py's inverse
    transform on CPU tensors, all three channels in one call for a 4:4:4
    single-block type. Frames that code the same dequant tables share one
    call a type; a frame with tables of its own (an animation's frames
    may each code theirs) takes calls of its own with its matrices.
    Returns the number of transform types."""
    import torch

    from .. import native
    from .cfl import COLOR_TILE_DIM_IN_BLOCKS
    from .device_frame import placed_blocks
    from .transforms import idct_matrix
    from .transforms_batch import transform_to_pixels_batch

    header = frames[0].header
    is444 = header.is444
    assert is444 or len(frames) == 1, "a chroma-subsampled frame renders alone"
    hshift = [header.hshift(c) for c in range(3)]
    vshift = [header.vshift(c) for c in range(3)]
    flat = np.ascontiguousarray(flat.numpy() if isinstance(flat, torch.Tensor) else flat,
                                dtype=np.int32).reshape(-1)
    biases = np.asarray(frames[0].file_header.transform_data.opsin_inverse_matrix.quant_biases,
                        dtype=np.float32)
    dqms = [fr.hf_global.dequant_matrices for fr in frames]
    F = len(frames)
    # each frame's matrix set: the first frame whose tables equal its own
    mset = np.array([next(j for j in range(f + 1) if dqms[j] is dqms[f] or all(
        a is b or np.array_equal(a, b) for a, b in zip(dqms[j].tables, dqms[f].tables)))
        for f in range(F)])
    dims = [fr.header.size_blocks() for fr in frames]
    cbw, cbh = max(d[0] for d in dims), max(d[1] for d in dims)
    tch, tcw = -(-cbh // COLOR_TILE_DIM_IN_BLOCKS), -(-cbw // COLOR_TILE_DIM_IN_BLOCKS)
    # the frames' tables, padded to the largest frame: LF (each channel at
    # its own grid), raw quant, CfL tiles; a frame's inverse global scale,
    # x and b dequant scales, colour factor and base correlations x, b
    lf = np.zeros((3, F, cbh, cbw), np.float32)
    rq = np.ones((F, cbh, cbw), np.int32)
    yx = np.zeros((F, tch, tcw), np.float32)
    yb = np.zeros((F, tch, tcw), np.float32)
    k = np.zeros((6, F), np.float32)
    parts = []
    stride = 3 * GROUP_DIM * GROUP_DIM
    for f, fr in enumerate(frames):
        bw, bh = dims[f]
        hf = fr.hf_meta
        for c, p in enumerate(_host_lf(fr)[:3]):
            ph, pw = min(p.shape[0], cbh), min(p.shape[1], cbw)
            lf[c, f, :ph, :pw] = p[:ph, :pw]
        rq[f, :bh, :bw] = hf["raw_quant"][:bh, :bw]
        th, tw = hf["ytox"].shape
        yx[f, :th, :tw] = hf["ytox"]
        yb[f, :th, :tw] = hf["ytob"]
        ccp = fr.lf_global.color_correlation_params
        k[:, f] = (fr.lf_global.quant_params.inv_global_scale,
                   (1.0 / 1.25) ** (fr.header.x_qm_scale - 2.0),
                   (1.0 / 1.25) ** (fr.header.b_qm_scale - 2.0), ccp.color_factor,
                   ccp.base_correlation_x, ccp.base_correlation_b)
        tid, gbx, gby, gi, off = placed_blocks(fr, list(range(fr.header.num_groups)))
        parts.append((tid, gbx, gby, (gi + slots[f]) * stride + off, np.full(len(tid), f)))
    all_tid, all_gbx, all_gby, all_base, all_f = map(np.concatenate, zip(*parts))
    igs, xdm, bdm, cf, bcx, bcb = (row[all_f] for row in k)
    sy = igs / rq[all_f, all_gby, all_gbx].astype(np.float32)
    all_scl = np.stack([sy * xdm, sy, sy * bdm], axis=1)
    ty, tx = all_gby // COLOR_TILE_DIM_IN_BLOCKS, all_gbx // COLOR_TILE_DIM_IN_BLOCKS
    all_xcc = bcx + yx[all_f, ty, tx] / cf
    all_bcc = bcb + yb[all_f, ty, tx] / cf
    coeffs = [flat, flat[GROUP_DIM * GROUP_DIM:], flat[2 * GROUP_DIM * GROUP_DIM:]]
    idct8 = np.ascontiguousarray(idct_matrix(8), dtype=np.float32)
    row0 = all_f * (rows_apart // BLOCK_DIM)  # a frame's first block row in the planes

    def blocks_of(outp, pix, bx, by):
        ph, pw = pix.shape[1:]
        oh, ow = outp.shape
        if ph == pw == BLOCK_DIM and oh % BLOCK_DIM == 0 and ow % BLOCK_DIM == 0:
            outp.reshape(oh // BLOCK_DIM, BLOCK_DIM, ow // BLOCK_DIM, BLOCK_DIM)[
                by, :, bx, :] = pix
        else:
            _scatter_blocks(outp, pix, bx, by)

    all_set = mset[all_f]
    for t, s in sorted(set(zip(all_tid.tolist(), all_set.tolist()))):
        m = (all_tid == t) & (all_set == s)
        fidx, bx, by, offs = all_f[m], all_gbx[m], all_gby[m], all_base[m].astype(np.int64)
        scl, xcc, bcc, r0 = all_scl[m], all_xcc[m], all_bcc[m], row0[m]
        cx, cy = covered_blocks_x(t), covered_blocks_y(t)
        nc = cx * cy * BLOCK_SIZE
        n = len(bx)
        mats = np.ascontiguousarray(dqms[s].matrix3(t, nc), dtype=np.float32)
        if is444 and t == 0 and native.dct8_fused_native(
                coeffs, offs, scl, xcc, bcc, mats, biases, lf[:, fidx, by, bx], idct8,
                planes, bx, r0 + by):
            continue
        dq = native.dequant_cfl_native(coeffs, offs, nc, mats, scl, xcc, bcc, biases)
        if is444 and cx == 1 and cy == 1:
            # the three channels in one call
            pix3 = transform_to_pixels_batch(
                t, torch.from_numpy(np.ascontiguousarray(
                    lf[:, fidx, by, bx].T).reshape(3 * n, 1, 1)),
                torch.from_numpy(dq.reshape(3 * n, nc)), padded=False).numpy()
            pix3 = pix3.reshape(n, 3, *pix3.shape[1:])
            for c in range(3):
                blocks_of(planes[c], pix3[:, c], bx, r0 + by)
            continue
        iy, ix = np.arange(cy), np.arange(cx)
        for c in (1, 0, 2):
            if is444:
                sel = np.arange(n)
                lfx, lfy = bx, by
            else:
                # a channel decodes only at the blocks aligned to its grid
                hs, vs = hshift[c], vshift[c]
                sel = np.nonzero((((bx >> hs) << hs) == bx) & (((by >> vs) << vs) == by))[0]
                if len(sel) == 0:
                    continue
                lfx, lfy = bx[sel] >> hs, by[sel] >> vs
            tiles = lf[c, fidx[sel, None, None], lfy[:, None, None] + iy[None, :, None],
                       lfx[:, None, None] + ix[None, None, :]]
            pix = transform_to_pixels_batch(
                t, torch.from_numpy(np.ascontiguousarray(tiles)),
                torch.from_numpy(np.ascontiguousarray(dq[sel, c])), padded=False).numpy()
            if is444 or _inside(planes[c], lfx, lfy, pix.shape[1:]):
                blocks_of(planes[c], pix, lfx, r0[sel] + lfy)
            else:
                _scatter_dropping(planes[c], pix, lfx, lfy)
    return len(np.unique(all_tid))


def _inside(plane, bx, by, shape) -> bool:
    """Whether every block of `shape` (ph, pw) at (bx*8, by*8) lies inside
    the plane."""
    oh, ow = plane.shape
    return bool(len(bx) == 0 or (bx.max() * BLOCK_DIM + shape[1] <= ow
                                 and by.max() * BLOCK_DIM + shape[0] <= oh))


def _scatter_dropping(plane, pix, bx, by) -> None:
    """Blocks into a chroma plane, the pixels past its edge dropped (the
    reference's mode "drop"; vardct/device_frame.py's spare slot)."""
    n, ph, pw = pix.shape
    oh, ow = plane.shape
    rows = by[:, None, None] * BLOCK_DIM + np.arange(ph)[None, :, None]
    cols = bx[:, None, None] * BLOCK_DIM + np.arange(pw)[None, None, :]
    rows, cols = np.broadcast_arrays(rows, cols)
    keep = (rows < oh) & (cols < ow)
    plane[rows[keep], cols[keep]] = pix[keep]
