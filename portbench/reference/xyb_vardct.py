"""The plain reference of the xyb_vardct configurations: the 8-bit sRGB
image of a 4:4:4 XYB VarDCT frame, from what the benchmark's writer put
in the stream (writers/xyb_vardct.py: the quantized LF, the HF metadata,
the dequant tables as coded and the dense quantized AC coefficients), in
plain torch on one device. Nothing here reads the stream's bits or
imports the decoder.

The steps, as ISO/IEC 18181-1 defines them (libjxl's
jxl/src/frame/group.rs, modular/mod.rs dequant_lf,
adaptive_lf_smoothing.rs): the LF dequantized with the LF quant factors
and chroma from luma, then adaptively smoothed; each block's AC
coefficients with the quant bias, times its dequant matrix and
inv_global_scale / raw quant (X times 0.8, the x_qm_scale of 3), chroma
from luma from its 64-px colour tile; the inverse transforms (idct.py)
with the LF as each block's lowest frequencies; gaborish and two EPF
steps with the per-block sigma; XYB to sRGB and the dithered 8-bit output
(stages.py). precision="tf32" runs the inverse transforms' matrix
products in TF32 on the card: the control of the benchmark's comparison.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..writers import spec
from . import dequant, idct, stages

LF_QUANT = (1.0 / 4096.0, 1.0 / 512.0, 1.0 / 256.0)
GROUP_BLOCKS = 32
GROUP_STRIDE = 3 * 256 * 256
COLOR_FACTOR = 84
BASE_CORRELATION_X, BASE_CORRELATION_B = 0.0, 1.0
W_SIDE = 0.20345139757231578
W_CORNER = 0.0334829185968739
W_CENTER = 1.0 - 4.0 * (W_SIDE + W_CORNER)


def lf_planes(coded, device) -> torch.Tensor:
    """(3, bh, bw) float32 LF of X, Y and B, dequantized, chroma from luma
    added and adaptively smoothed."""
    lfq = coded["lf_quant"] or LF_QUANT
    inv_quant_lf = (1 << 16) / (coded["global_scale"] * coded["quant_lf"])
    fac = [stages.f32(f * inv_quant_lf) for f in lfq]
    q = torch.from_numpy(np.asarray(coded["lf"], np.float32)).to(device)
    x, y, b = q[0] * fac[0], q[1] * fac[1], q[2] * fac[2]
    p = [y * stages.f32(BASE_CORRELATION_X) + x, y, y * stages.f32(BASE_CORRELATION_B) + b]
    h, w = p[0].shape
    if h <= 2 or w <= 2:
        return torch.stack(p)
    gap = torch.full((h - 2, w - 2), 0.5, dtype=torch.float32, device=device)
    smooth = []
    for c in range(3):
        v = p[c]
        corner = v[:-2, :-2] + v[:-2, 2:] + v[2:, :-2] + v[2:, 2:]
        side = v[1:-1, :-2] + v[1:-1, 2:] + v[:-2, 1:-1] + v[2:, 1:-1]
        mc = v[1:-1, 1:-1]
        s = (corner * stages.f32(W_CORNER) + side * stages.f32(W_SIDE)
             + mc * stages.f32(W_CENTER))
        gap = torch.maximum(gap, ((mc - s) / fac[c]).abs())
        smooth.append(s)
    factor = (3.0 - 4.0 * gap).clamp_min(0.0)
    out = []
    for c in range(3):
        v = p[c].clone()
        mc = v[1:-1, 1:-1]
        v[1:-1, 1:-1] = (smooth[c] - mc) * factor + mc
        out.append(v)
    return torch.stack(out)


def _block_offsets(tmap) -> tuple:
    """Every placed block's (type, bx, by, first coefficient in the dense
    buffer): a group's blocks in raster order, each at the running sum of
    the earlier blocks' coefficient counts, after the group's slot."""
    bh, bw = tmap.shape
    gxn = -(-bw // GROUP_BLOCKS)
    ys, xs = np.nonzero(tmap >= 128)
    g = (ys // GROUP_BLOCKS) * gxn + xs // GROUP_BLOCKS
    order = np.lexsort((xs, ys, g))
    ys, xs, g = ys[order], xs[order], g[order]
    tids = (tmap[ys, xs] & 127).astype(np.int64)
    sizes = 64 * np.array(spec.CBX)[tids] * np.array(spec.CBY)[tids]
    offs = np.cumsum(sizes) - sizes
    first = np.r_[True, g[1:] != g[:-1]]
    offs -= offs[np.maximum.accumulate(np.where(first, np.arange(len(g)), 0))]
    return tids, xs, ys, g * GROUP_STRIDE + offs


def xyb_planes(coded, device, precision: str = "float32") -> list:
    """The three (bh*8, bw*8) float32 XYB planes before the filters."""
    tmap = np.asarray(coded["transform"])
    bh, bw = tmap.shape
    lf = lf_planes(coded, device)
    flat = torch.from_numpy(np.asarray(coded["coeffs"], np.int32)).to(device)
    tids, xs, ys, base = _block_offsets(tmap)
    mats = dequant.matrices(coded["dequant"], np.unique(tids).tolist())
    inv_gs = (1 << 16) / coded["global_scale"]
    b_c = [stages.f32(v) for v in stages.QUANT_BIASES]
    dm = [stages.f32(0.8), 1.0, 1.0]  # (1 / 1.25) ** (qm_scale - 2): 3 for X, 2 for B
    rq = torch.from_numpy(np.asarray(coded["raw_quant"], np.float32)).to(device)
    ytox = torch.from_numpy(np.asarray(coded["ytox"], np.float32)).to(device)
    ytob = torch.from_numpy(np.asarray(coded["ytob"], np.float32)).to(device)
    planes = torch.zeros((3, bh * 8, bw * 8), dtype=torch.float32, device=device)
    consts = idct.Consts(device)
    tf32 = precision == "tf32"
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    for t in np.unique(tids).tolist():
        sel = tids == t
        bx = torch.from_numpy(xs[sel]).to(device)
        by = torch.from_numpy(ys[sel]).to(device)
        cx, cy = spec.CBX[t], spec.CBY[t]
        nc = 64 * cx * cy
        idx = (torch.from_numpy(base[sel]).to(device)[:, None, None]
               + torch.arange(3, device=device)[None, :, None] * (256 * 256)
               + torch.arange(nc, device=device)[None, None, :])
        qb = flat[idx]
        qf = qb.to(torch.float32)
        adj = torch.where(qb.abs() < 2, qf * torch.tensor(b_c[:3], device=device)[None, :, None],
                          qf - b_c[3] / torch.where(qb == 0, 1.0, qf))
        adj = torch.where(qb == 0, 0.0, adj)
        scaled_y = stages.f32(inv_gs) / rq[by, bx]
        scale = torch.stack([scaled_y * dm[0], scaled_y, scaled_y * dm[2]], dim=1)
        dq = adj * torch.from_numpy(mats[t]).to(device)[None] * scale[:, :, None]
        tx, ty = bx // 8, by // 8
        x_cc = BASE_CORRELATION_X + ytox[ty, tx] / COLOR_FACTOR
        b_cc = BASE_CORRELATION_B + ytob[ty, tx] / COLOR_FACTOR
        dq[:, 0] += x_cc[:, None] * dq[:, 1]
        dq[:, 2] += b_cc[:, None] * dq[:, 1]
        iy = torch.arange(cy, device=device)
        ix = torch.arange(cx, device=device)
        py = torch.arange(8 * cy, device=device)
        px = torch.arange(8 * cx, device=device)
        rows = (by[:, None] * 8 + py[None, :])[:, :, None]
        cols = (bx[:, None] * 8 + px[None, :])[:, None, :]
        with _tf32(tf32):
            for c in (1, 0, 2):
                lf_tiles = lf[c][by[:, None, None] + iy[None, :, None],
                                 bx[:, None, None] + ix[None, None, :]]
                pix = idct.transform_to_pixels(consts, t, lf_tiles, dq[:, c].contiguous())
                planes[c][rows, cols] = pix
    return list(planes.unbind(0))


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 matrix products on the card inside the block (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def render(coded, width: int, height: int, device, precision: str = "float32"):
    """(height, width, 3) float32: the frame the writer coded as sRGB 8-bit
    output before its rounding (stages.xyb_to_output)."""
    # the filters mirror at the image's edge, not at the blocks' padding
    planes = [p[:height, :width] for p in xyb_planes(coded, device, precision)]
    if coded["filters"]:
        planes = [stages.gaborish(p) for p in planes]
        sig = stages.inv_sigma_blocks(coded["raw_quant"], coded["epf"], coded["global_scale"])
        sig = torch.from_numpy(sig).to(device)
        sig_px = sig.repeat_interleave(8, 0).repeat_interleave(8, 1)[:height, :width]
        for step in (1, 2):
            planes = stages.epf_step(planes, sig_px, step)
    return stages.xyb_to_output(planes, width, height)
