"""Whole-frame VarDCT dequant + CfL + IDCT, in torch on the coefficient
buffer's device.

The counterpart of jxl_tpu/vardct/device_frame.py:render_vardct_frame_device
and render_vardct_frame_device_subsampled (the reference's per-group
numeric path, frame/group.rs:138-237 dequant_and_transform_to_pixels, over
the whole frame): per transform type, gather the blocks' quantized
coefficients from the dense (G * 3 * GD * GD,) int32 buffer in place,
dequantize with the quant bias, add chroma from luma, run the inverse
transforms (transforms_batch.py) and scatter the pixels. The LF is the
frame's own or, for a frame that reads an LF frame, that frame's planes,
already on the device. The planes stay on the device for the filters.
The host tables of a render go up through
render/stages/core.py:to_device_all: pinned, one copy a dtype, without a
wait.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.vardct_blocks import dequant, vardct_blocks
from ..render.stages.core import to_device_all
from ..utils import trace
from .group import BLOCK_SIZE, GROUP_DIM
from .transform_map import covered_blocks_x, covered_blocks_y
from .transforms_batch import transform_to_pixels_batch

BLOCK_DIM = 8
COLOR_TILE_DIM_IN_BLOCKS = 8
_GROUP_STRIDE = 3 * GROUP_DIM * GROUP_DIM


def eligible(frame) -> bool:
    """Any VarDCT frame with placed transforms."""
    if frame.hf_meta is None:
        return False
    return bool((frame.hf_meta["transform"] >= 128).any())


_BLOCK_COEFFS = np.array([covered_blocks_x(t) * covered_blocks_y(t) for t in range(27)],
                         dtype=np.int64) * BLOCK_SIZE


def block_tables(frame, group_ids: list, layout: int, by0: int = 0, bx0: int = 0,
                 W: int = 0) -> tuple:
    """(counts, out): the frame's block tables in `layout` from one native
    pass over its transform map (native jxl_block_tables), the blocks
    placed in the groups `group_ids` (slot i of the coefficient buffer
    holds group group_ids[i]) in placement order: the groups in list
    order, each group's blocks in raster order, their coefficient offsets
    as vardct/group.py:_BlockList.offs (and so both AC decoders) lay them
    out. Counted in `block_tables_built`."""
    from .. import native

    header = frame.header
    gx_count, gy_count = header.size_groups()
    counts, out = native.block_tables_native(
        np.ascontiguousarray(frame.hf_meta["transform"], np.uint8),
        np.asarray(group_ids, np.int32).reshape(-1), gx_count * gy_count, gx_count,
        header.group_dim // BLOCK_DIM, np.array([header.hshift(c) for c in range(3)], np.int32),
        np.array([header.vshift(c) for c in range(3)], np.int32), _BLOCK_COEFFS,
        _GROUP_STRIDE, layout, by0, bx0, W)
    trace.metrics.add("block_tables_built")
    return counts, out


def placed_blocks(frame, group_ids: list, by0: int = 0) -> tuple:
    """(tid, gbx, gby, group index, coefficient offset) int64 arrays of
    every block placed in the groups `group_ids` (the group index is the
    position in that list, the slot of the coefficient buffer; gby counts
    from block row by0), in block_tables' order."""
    counts, out = block_tables(frame, group_ids, 0, by0)
    return tuple(out.reshape(5, -1))


def _constants(frame) -> tuple:
    """(x_dm, b_dm, 1/global_scale, colour factor, base correlations x and
    b): float32 values as Python floats (torch keeps tensors float32)."""
    header = frame.header
    ccp = frame.lf_global.color_correlation_params
    qp = frame.lf_global.quant_params
    return tuple(float(np.float32(v)) for v in (
        (1.0 / 1.25) ** (header.x_qm_scale - 2.0), (1.0 / 1.25) ** (header.b_qm_scale - 2.0),
        qp.inv_global_scale, ccp.color_factor, ccp.base_correlation_x,
        ccp.base_correlation_b))


def _frame_tables(frame, by0: int = 0, by1: int | None = None) -> list:
    """The host tables every render uploads: raw quant (bh, bw) int32,
    ytox and ytob tiles float32, quant biases (4,); with block rows
    [by0, by1) (by0 a multiple of the colour tile's 8 blocks), those rows
    of raw quant and the colour tile rows that cover them."""
    bw, bh = frame.header.size_blocks()
    by1 = bh if by1 is None else by1
    ty0 = by0 // COLOR_TILE_DIM_IN_BLOCKS
    ty1 = -(-by1 // COLOR_TILE_DIM_IN_BLOCKS)
    tw = -(-bw // COLOR_TILE_DIM_IN_BLOCKS)
    hf = frame.hf_meta
    biases = frame.file_header.transform_data.opsin_inverse_matrix.quant_biases
    return [
        np.asarray(hf["raw_quant"][by0:by1], np.int32),
        np.asarray(hf["ytox"][ty0:ty1, :tw], np.float32),
        np.asarray(hf["ytob"][ty0:ty1, :tw], np.float32),
        np.asarray(biases, np.float32),
    ]


def _upload(frame, extra: list, dev, by0: int = 0, by1: int | None = None) -> list:
    """[LF (3, by1 - by0, bw), raw quant, ytox, ytob, biases, *extra] on
    dev, block rows [by0, by1) (the whole frame by default): the host
    arrays in one render/stages/core.py:to_device_all. The LF is the
    frame's own (lf_image, from its LF coefficients) or, for a frame that
    reads an LF frame, the adopted planes, already on the device
    (api/frame.py:_adopt_lf_frame)."""
    tables = _frame_tables(frame, by0, by1)
    if frame.lf_device is not None:
        return [frame.lf_device[:, by0:by1].to(dev)] + to_device_all(tables + extra, dev)
    lf = np.stack([p[by0:by1] for p in frame.lf_image]).astype(np.float32)
    return to_device_all([lf] + tables + extra, dev)


def _matrices(frame, t: int, nc: int) -> np.ndarray:
    """(3, nc) float32 dequant weights of transform type t."""
    dqm = frame.hf_global.dequant_matrices
    return np.stack([np.asarray(dqm.matrix(t, c)[:nc], np.float32) for c in range(3)])


def _cfl_factors(gbx, gby, ytox, ytob, cf, bcx, bcb) -> tuple:
    """(x, b) chroma-from-luma factors of the blocks at (gbx, gby): the
    base correlation plus the block's colour tile's ytox or ytob over the
    colour factor."""
    tx = gbx // COLOR_TILE_DIM_IN_BLOCKS
    ty = gby // COLOR_TILE_DIM_IN_BLOCKS
    return bcx + ytox[ty, tx] / cf, bcb + ytob[ty, tx] / cf


def frame_factors(frame) -> np.ndarray:
    """(6, 1) float32: the frame's x_dm, b_dm, 1/global_scale, colour
    factor and base correlations x and b, one column (the k of
    ops/vardct_blocks.py:vardct_blocks)."""
    return np.array(_constants(frame), np.float32).reshape(6, 1)


def _split(out, counts, rows: int, shape) -> dict:
    """{key: view of out}: out's consecutive tables of counts[key] blocks
    (rows int64 each), one for each nonzero count, of shape shape(n)."""
    views, at = {}, 0
    for key in np.flatnonzero(counts).tolist():
        n = int(counts[key])
        views[key] = out[at : at + rows * n].reshape(shape(n))
        at += rows * n
    return views


def frame_columns(frame, group_ids: list, by0: int = 0, bx0: int = 0,
                  bx1: int | None = None) -> dict:
    """{tid: (n, 4) int64 columns} (ops/vardct_blocks.py:block_columns) of
    the blocks placed in the groups `group_ids` (slot i of the coefficient
    buffer holds group group_ids[i]), for planes of block columns [bx0,
    bx1) and block rows from by0, and LF, raw quant and colour tile tables
    of the frame's width from block row by0 (by0 a multiple of 8)."""
    bw = frame.header.size_blocks()[0]
    bx1 = bw if bx1 is None else bx1
    counts, out = block_tables(frame, group_ids, 1, by0, bx0, (bx1 - bx0) * BLOCK_DIM)
    return _split(out, counts[0], 4, lambda n: (n, 4))


def render_vardct_frame_device(frame, flat) -> torch.Tensor:
    """(3, bh*8, bw*8) float32 planes in XYB on flat's device, from the
    dense (G * 3 * GD * GD,) int32 coefficient buffer `flat` of every
    group in order."""
    bh = frame.header.size_blocks()[1]
    return render_block_rows(frame, flat, list(range(frame.header.num_groups)), 0, bh)


def render_block_rows(frame, flat, group_ids: list, by0: int, by1: int,
                      matrices=None, bx0: int = 0, bx1: int | None = None) -> torch.Tensor:
    """(3, (by1 - by0)*8, (bx1 - bx0)*8) float32 planes in XYB on flat's
    device: block rows [by0, by1) and columns [bx0, bx1) (every column by
    default) of a 4:4:4 frame, which the groups `group_ids` cover exactly,
    from `flat`, the dense (len(group_ids) * 3 * GD * GD,) int32
    coefficient buffer of those groups in that order. The whole frame is
    every group over every block row; a band of the banded decode
    (vardct/device_band.py) is one group row, and a rank's tile of the
    sharded decode (parallel/sharded_render.py) a rectangle of groups:
    their pixels are the frame's there, from the same per-block work
    (ops/vardct_blocks.py:vardct_blocks, a block's pixels from that block
    alone). by0 is a multiple of 8 (the colour tiles). matrices: {tid: (3,
    nc) float32} dequant weights already made (a band renderer keeps them
    across bands), else made here."""
    header = frame.header
    if not header.is444:
        raise ValueError("a chroma-subsampled frame renders through "
                         "render_vardct_frame_device_subsampled")
    dev = flat.device
    bw = header.size_blocks()[0]
    bx1 = bw if bx1 is None else bx1
    nbh = by1 - by0
    W = (bx1 - bx0) * BLOCK_DIM
    with trace.span("render.blocks"):
        cols = frame_columns(frame, group_ids, by0, bx0, bx1)
        types = sorted(cols)
        host = [frame_factors(frame)]
        for t in types:
            nc = covered_blocks_x(t) * covered_blocks_y(t) * BLOCK_SIZE
            mats = matrices[t] if matrices is not None else _matrices(frame, t, nc)
            host += [cols[t], mats[None]]
    with trace.span("render.transforms"):
        lf, rq, ytox, ytob, b_c, k, *per_type = _upload(frame, host, dev, by0, by1)
        lf = lf.reshape(3, -1)
        planes = torch.zeros((3, nbh * BLOCK_DIM * W), dtype=torch.float32, device=dev)
        for i, t in enumerate(types):
            vardct_blocks(t, flat, per_type[2 * i], lf, bw, rq, ytox, ytob, k, b_c,
                          per_type[2 * i + 1], planes, W)
    return planes.reshape(3, nbh * BLOCK_DIM, W)


def subsampled_jobs(frame) -> tuple:
    """(types, jobs) of a chroma-subsampled frame's render: the transform
    types placed in it, ascending, and {(channel, type): (4, n) int64 rows
    gbx, gby, group slot, coefficient offset} of the blocks of that type
    aligned to the channel's grid, channel outer and types ascending, a
    job with no such block left out."""
    counts, out = block_tables(frame, list(range(frame.header.num_groups)), 2)
    types = np.flatnonzero(counts[0]).tolist()
    for t in types:
        if covered_blocks_x(t) != 1 or covered_blocks_y(t) != 1:
            raise ValueError(f"transform {t} covers more than one block in a subsampled frame")
    rows = _split(out, counts[1:].reshape(-1), 4, lambda n: (4, n))
    return types, {divmod(key, len(_BLOCK_COEFFS)): r for key, r in rows.items()}


def render_vardct_frame_device_subsampled(frame, flat) -> list:
    """The chroma-subsampled render (4:2:0, 4:2:2, 4:4:0; DCT8-sized
    transforms only, as the format allows): [Cb, Y, Cr] float32 planes on
    flat's device, channel c at its own size (bh*8 >> vshift(c), bw*8 >>
    hshift(c)), from the dense coefficient buffer `flat`.

    Channel c decodes only at the blocks aligned to its grid; its LF is
    read at the channel's block (cby, cbx) of the frame's (3, bh, bw) LF
    stack, stride bw; X and B add Y's dequantized block at the same
    full-resolution block (Y's matrix, no x/b scale). Unlike the
    reference, which upsamples and crops in the same program, the planes
    come back at their own sizes: the render pipeline's chroma upsampling
    stages (render/pipeline.py) upsample each channel, horizontal first,
    before the visible crop and the filters, the same order (ref
    render/simple.py:145-146)."""
    header = frame.header
    dev = flat.device
    x_dm, b_dm, igs, cf, bcx, bcb = _constants(frame)
    bw, bh = header.size_blocks()
    H, W = bh * BLOCK_DIM, bw * BLOCK_DIM
    with trace.span("render.blocks"):
        types, job_rows = subsampled_jobs(frame)
        # every upload in one copy a dtype: the tables, each type's
        # matrices, then each job's rows
        host = [_matrices(frame, t, BLOCK_SIZE) for t in types]
        jobs = list(job_rows)
        for rows in job_rows.values():
            host += list(rows)
    with trace.span("render.transforms"):
        lf, rq, ytox, ytob, b_c, *rest = _upload(frame, host, dev)
        lf_flat = lf.reshape(3, -1)
        mats = dict(zip(types, rest))
        job_blocks = rest[len(types):]
        stride_c = GROUP_DIM * GROUP_DIM
        lanes = torch.arange(BLOCK_SIZE, device=dev)
        py = torch.arange(BLOCK_DIM, device=dev)

        def dequant_c(qb, c, t, scale):
            return dequant(qb, b_c[c], b_c[3], mats[t][c][None], scale[:, None])

        sizes = [(H >> header.vshift(c), W >> header.hshift(c)) for c in range(3)]
        # one slot past each plane takes the pixels the reference drops
        planes = [torch.zeros(hc * wc + 1, dtype=torch.float32, device=dev) for hc, wc in sizes]
        for k, (c, t) in enumerate(jobs):
            gbx, gby, gi, off = job_blocks[4 * k : 4 * k + 4]
            hs, vs = header.hshift(c), header.vshift(c)
            hc, wc = sizes[c]
            base = gi * _GROUP_STRIDE + off
            scaled_y = igs / rq[gby, gbx].to(torch.float32)

            def gather(ch):
                return flat[((base + ch * stride_c)[:, None] + lanes[None, :]).reshape(-1)
                            ].reshape(-1, BLOCK_SIZE)

            dq = dequant_c(gather(c), c, t, scaled_y * {0: x_dm, 1: 1.0, 2: b_dm}[c])
            if c != 1:
                # CfL: Y's dequantized block at the same full-resolution block
                cc = _cfl_factors(gbx, gby, ytox, ytob, cf, bcx, bcb)[c // 2]
                dq = dq + cc[:, None] * dequant_c(gather(1), 1, t, scaled_y)
            cbx, cby = gbx >> hs, gby >> vs
            lf_tiles = lf_flat[c][cby * bw + cbx]
            pix = transform_to_pixels_batch(t, lf_tiles[:, None, None], dq.contiguous())
            rows = cby[:, None, None] * BLOCK_DIM + py[None, :, None]
            cols = cbx[:, None, None] * BLOCK_DIM + py[None, None, :]
            # the reference drops pixels past the channel's plane (mode
            # "drop"): here they land in the spare slot, without a boolean
            # mask that would make the host wait for the card
            idx = torch.where((rows < hc) & (cols < wc), rows * wc + cols, hc * wc)
            planes[c][idx.expand_as(pix).reshape(-1)] = pix.reshape(-1)
    return [p[: hc * wc].reshape(hc, wc) for p, (hc, wc) in zip(planes, sizes)]
