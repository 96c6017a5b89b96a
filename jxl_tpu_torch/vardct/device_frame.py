"""Whole-frame VarDCT dequant + CfL + IDCT of a 4:4:4 frame, in torch on
the coefficient buffer's device.

The counterpart of jxl_tpu/vardct/device_frame.py:render_vardct_frame_device
(the reference's per-group numeric path, frame/group.rs:138-237
dequant_and_transform_to_pixels, over the whole frame): per transform type,
gather the blocks' quantized coefficients from the dense
(G * 3 * GD * GD,) int32 buffer in place, dequantize with the quant bias,
add chroma from luma, run the inverse transforms (transforms_batch.py) and
scatter the pixels. The planes stay on the device for the filters.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _frame_blocks(frame, group_ids: list) -> dict:
    """{tid: (gbx, gby, group index, coefficient offset)} int32 arrays over
    the whole frame. Offsets follow raster placement order within each
    group, as vardct/group.py:_BlockList.offs (and so both AC decoders)
    lay coefficients out."""
    header = frame.header
    tmap = frame.hf_meta["transform"]
    by_tid: dict[int, list] = {}
    for gi, g in enumerate(group_ids):
        (gx0, gy0), (gw, gh) = header.block_group_rect(g)
        sub = tmap[gy0 : gy0 + gh, gx0 : gx0 + gw]
        ys, xs = np.nonzero(sub >= 128)  # raster order
        tids = (sub[ys, xs] & 127).astype(np.int32)
        sizes = np.array([covered_blocks_x(t) * covered_blocks_y(t) for t in range(27)],
                         dtype=np.int64)[tids] * BLOCK_SIZE
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        for t in np.unique(tids).tolist():
            sel = tids == t
            rec = by_tid.setdefault(t, [[], [], [], []])
            rec[0].append(xs[sel] + gx0)
            rec[1].append(ys[sel] + gy0)
            rec[2].append(np.full(int(sel.sum()), gi, dtype=np.int64))
            rec[3].append(offs[sel])
    return {
        t: tuple(np.concatenate(parts).astype(np.int32) for parts in rec)
        for t, rec in by_tid.items()
    }


def render_vardct_frame_device(frame, flat) -> torch.Tensor:
    """(3, bh*8, bw*8) float32 planes in XYB on flat's device, from the
    dense (G * 3 * GD * GD,) int32 coefficient buffer `flat` of every
    group in order."""
    header = frame.header
    if not header.is444:
        from ..errors import NotSupported

        raise NotSupported("chroma-subsampled VarDCT frames are not in this package's slice")
    dev = flat.device
    hf = frame.hf_meta
    lf_global = frame.lf_global
    ccp = lf_global.color_correlation_params
    qp = lf_global.quant_params
    dqm = frame.hf_global.dequant_matrices
    biases = np.asarray(
        frame.file_header.transform_data.opsin_inverse_matrix.quant_biases, dtype=np.float32
    )
    # float32 constants, as Python floats (torch keeps tensors float32)
    x_dm, b_dm, igs, cf, bcx, bcb = (float(np.float32(v)) for v in (
        (1.0 / 1.25) ** (header.x_qm_scale - 2.0), (1.0 / 1.25) ** (header.b_qm_scale - 2.0),
        qp.inv_global_scale, ccp.color_factor, ccp.base_correlation_x,
        ccp.base_correlation_b))
    bw, bh = header.size_blocks()
    W = bw * BLOCK_DIM
    th = -(-bh // COLOR_TILE_DIM_IN_BLOCKS)
    tw = -(-bw // COLOR_TILE_DIM_IN_BLOCKS)

    def up(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t if dtype is None else t.to(dtype)).to(dev)

    blocks = _frame_blocks(frame, list(range(header.num_groups)))
    lf_flat = up(np.stack(frame.lf_image)).reshape(3, -1)
    rq = up(hf["raw_quant"], torch.int32)
    ytox = up(hf["ytox"][:th, :tw]).to(torch.float32)
    ytob = up(hf["ytob"][:th, :tw]).to(torch.float32)
    b_c = up(biases)
    planes = torch.zeros((3, bh * BLOCK_DIM * W), dtype=torch.float32, device=dev)
    stride_c = GROUP_DIM * GROUP_DIM
    for t in sorted(blocks):
        gbx, gby, gi, off = (up(a).to(torch.int64) for a in blocks[t])
        n = gbx.shape[0]
        cx, cy = covered_blocks_x(t), covered_blocks_y(t)
        nc = cx * cy * BLOCK_SIZE
        mats = up(np.stack([np.asarray(dqm.matrix(t, c)[:nc], np.float32) for c in range(3)]))
        base = gi * _GROUP_STRIDE + off
        gidx = (base[:, None, None] + torch.arange(3, device=dev)[None, :, None] * stride_c
                + torch.arange(nc, device=dev)[None, None, :])
        qb = flat[gidx.reshape(-1)].reshape(n, 3, nc)
        q = qb.to(torch.float32)
        # quant bias where |q| < 2, else q - b3/q; 0 stays 0
        adj = torch.where(qb.abs() < 2, q * b_c[:3][None, :, None],
                          q - b_c[3] / torch.where(qb == 0, 1.0, q))
        adj = torch.where(qb == 0, 0.0, adj)
        scaled_y = igs / rq[gby, gbx].to(torch.float32)
        tx = gbx // COLOR_TILE_DIM_IN_BLOCKS
        ty = gby // COLOR_TILE_DIM_IN_BLOCKS
        x_cc = bcx + ytox[ty, tx] / cf
        b_cc = bcb + ytob[ty, tx] / cf
        scales = torch.stack([scaled_y * x_dm, scaled_y, scaled_y * b_dm], dim=1)
        dq = adj * mats[None] * scales[:, :, None]
        # X and B get Y's dequantized value times their correlation
        dq[:, 0] += x_cc[:, None] * dq[:, 1]
        dq[:, 2] += b_cc[:, None] * dq[:, 1]
        iy = torch.arange(cy, device=dev)
        ix = torch.arange(cx, device=dev)
        lf_idx = ((gby[:, None, None] + iy[None, :, None]) * bw
                  + gbx[:, None, None] + ix[None, None, :]).reshape(-1)
        py = torch.arange(cy * BLOCK_DIM, device=dev)
        px = torch.arange(cx * BLOCK_DIM, device=dev)
        pidx = ((gby[:, None, None] * BLOCK_DIM + py[None, :, None]) * W
                + gbx[:, None, None] * BLOCK_DIM + px[None, None, :]).reshape(-1)
        for c in (1, 0, 2):
            lf_tiles = lf_flat[c][lf_idx].reshape(n, cy, cx)
            pix = transform_to_pixels_batch(t, lf_tiles, dq[:, c].contiguous())
            planes[c, pidx] = pix.reshape(-1)
    return planes.reshape(3, bh * BLOCK_DIM, W)
