"""The plain reference of the ycbcr_vardct configurations: the 8-bit image
of a recompressed JPEG's YCbCr VarDCT frame (DCT8, chroma subsampled,
no restoration filters), from what the benchmark's writer put in the
stream (writers/ycbcr_vardct.py: the quantized LF of each channel at its
own size, the raw quant field, the dequant tables as coded and the dense
quantized AC coefficients), in plain torch on one device. Nothing here
reads the stream's bits or imports the decoder.

The steps, as ISO/IEC 18181-1 defines them for such a frame:

- the LF of each channel at its own resolution, dequantized with the
  default LF quant factors; the frame skips the adaptive LF smoothing,
  and the LF's chroma from luma applies only where every channel shares
  Y's grid (4:4:4);
- each channel's AC at the blocks aligned to its grid, with the quant
  bias, times the channel's dequant table and inv_global_scale over the
  raw quant of the block (a non-XYB frame scales no channel by its
  qm_scale); a chroma block adds chroma from luma times Y's dequantized
  block at the same full-resolution block, whose factors a recompressed
  JPEG codes as zero;
- the DCT8 inverse (idct.py) with the LF as each block's lowest
  frequency, each channel's pixels on its own grid;
- the chroma upsampling, for a channel with shifts (hs, vs): hs
  horizontal doublings, then vs vertical ones, each output pair 3/4 of
  its sample plus 1/4 of the neighbour before it and after it, the
  samples at the channel's visible edge (ceil(width / 2^hs) by
  ceil(height / 2^vs)) replicated outward;
- YCbCr to RGB with the JPEG (JFIF) matrix, Y offset by 128/255;
- the dithered 8-bit output (stages.py).

precision="tf32" computes the inverse transforms in TF32, the control
of the benchmark's comparison: their operands rounded to TF32's 10-bit
mantissa, as the card's tensor cores take them with TF32 on, and the
products allowed TF32. The flag alone changes nothing here: cuBLAS runs
these batched 8x8 products on kernels without tensor cores.
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
Y_OFFSET = 128.0 / 255.0
# (Cb, Cr) weights of R, G and B
YCBCR_TO_RGB = ((0.0, 1.402), (-0.344136, -0.714136), (1.772, 0.0))


def lf_planes(coded, device) -> list:
    """[Cb, Y, Cr] float32 LF, each at its own block resolution."""
    inv_quant_lf = (1 << 16) / (coded["global_scale"] * coded["quant_lf"])
    out = [torch.from_numpy(np.asarray(q, np.float32)).to(device)
           * stages.f32(f * inv_quant_lf) for q, f in zip(coded["lf"], LF_QUANT)]
    if not any(coded["hshift"]) and not any(coded["vshift"]):
        bx, bb = (stages.f32(v) for v in coded["base_correlation"])
        out = [out[1] * bx + out[0], out[1], out[1] * bb + out[2]]
    return out


def _blocks(tmap) -> tuple:
    """(bx, by, first coefficient in the dense buffer) of every block: a
    group's blocks in raster order, 64 coefficients each."""
    bh, bw = tmap.shape
    if not (tmap == 128).all():
        raise ValueError("the reference renders frames of DCT8 blocks only")
    gxn = -(-bw // GROUP_BLOCKS)
    ys, xs = np.nonzero(tmap >= 128)
    g = (ys // GROUP_BLOCKS) * gxn + xs // GROUP_BLOCKS
    order = np.lexsort((xs, ys, g))
    ys, xs, g = ys[order], xs[order], g[order]
    rank = np.arange(len(g)) - np.searchsorted(g, g)  # the block's place in its group
    return xs, ys, g * GROUP_STRIDE + 64 * rank


def channel_planes(coded, device, precision: str = "float32") -> list:
    """[Cb, Y, Cr] float32 planes before the chroma upsampling, channel c
    (bh * 8 >> vshift, bw * 8 >> hshift)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    tmap = np.asarray(coded["transform"])
    bh, bw = tmap.shape
    hs, vs = coded["hshift"], coded["vshift"]
    lf = lf_planes(coded, device)
    flat = torch.from_numpy(np.asarray(coded["coeffs"], np.int32)).to(device)
    xs, ys, base = _blocks(tmap)
    mats = torch.from_numpy(dequant.matrices(coded["dequant"], [spec.DCT])[spec.DCT]).to(device)
    biases = [stages.f32(v) for v in stages.QUANT_BIASES]
    inv_gs = stages.f32((1 << 16) / coded["global_scale"])
    rq = torch.from_numpy(np.asarray(coded["raw_quant"], np.float32)).to(device)
    cfl = [torch.from_numpy(np.asarray(coded[k], np.float32)).to(device)
           for k in ("ytox", "ytob")]
    tf32 = precision == "tf32"
    consts = _Tf32Consts(device) if tf32 else idct.Consts(device)
    lanes = torch.arange(64, device=device)
    py = torch.arange(8, device=device)

    def dequantized(c, bx, by, first):
        q = flat[(first + c * 256 * 256)[:, None] + lanes[None, :]]
        qf = q.to(torch.float32)
        adj = torch.where(q.abs() < 2, qf * biases[c],
                          qf - biases[3] / torch.where(q == 0, 1.0, qf))
        adj = torch.where(q == 0, 0.0, adj)
        return adj * mats[c][None, :] * (inv_gs / rq[by, bx])[:, None]

    planes = []
    for c in range(3):
        on_grid = (xs % (1 << hs[c]) == 0) & (ys % (1 << vs[c]) == 0)
        bx = torch.from_numpy(xs[on_grid]).to(device)
        by = torch.from_numpy(ys[on_grid]).to(device)
        first = torch.from_numpy(base[on_grid]).to(device)
        dq = dequantized(c, bx, by, first)
        if c != 1:
            factor = (stages.f32(coded["base_correlation"][c // 2])
                      + cfl[c // 2][by // 8, bx // 8] / COLOR_FACTOR)
            dq = dq + factor[:, None] * dequantized(1, bx, by, first)
        cbx, cby = bx >> hs[c], by >> vs[c]
        tiles = lf[c][cby, cbx][:, None, None]
        if tf32:
            tiles, dq = to_tf32(tiles), to_tf32(dq)
        with _tf32(tf32):
            pix = idct.transform_to_pixels(consts, spec.DCT, tiles, dq.contiguous())
        plane = torch.zeros(((bh >> vs[c]) * 8, (bw >> hs[c]) * 8), dtype=torch.float32,
                            device=device)
        plane[(cby[:, None, None] * 8 + py[None, :, None]),
              (cbx[:, None, None] * 8 + py[None, None, :])] = pix
        planes.append(plane)
    return planes


def upsample_h(plane):
    """2x along the rows: sample x gives 3/4 x + 1/4 (x - 1), then 3/4 x
    + 1/4 (x + 1), the edge samples replicated outward."""
    before = torch.cat([plane[:, :1], plane[:, :-1]], dim=1)
    after = torch.cat([plane[:, 1:], plane[:, -1:]], dim=1)
    three = plane * stages.f32(0.75)
    out = torch.stack([three + before * stages.f32(0.25), three + after * stages.f32(0.25)],
                      dim=2)
    return out.reshape(plane.shape[0], 2 * plane.shape[1])


def upsample_v(plane):
    """2x down the columns, the same stencil."""
    return upsample_h(plane.T).T


def upsampled(plane, hs: int, vs: int, width: int, height: int):
    """A channel with shifts (hs, vs) at the image's width x height: cut
    to its visible samples, hs horizontal doublings, then vs vertical
    ones."""
    plane = plane[: -(-height // (1 << vs)), : -(-width // (1 << hs))]
    for _ in range(hs):
        plane = upsample_h(plane)
    for _ in range(vs):
        plane = upsample_v(plane)
    return plane[:height, :width]


def ycbcr_to_rgb(cb, y, cr) -> list:
    """[R, G, B] of the JPEG's YCbCr, its Y centred on 0."""
    y = y + stages.f32(Y_OFFSET)
    return [y + cb * stages.f32(wb) + cr * stages.f32(wr) for wb, wr in YCBCR_TO_RGB]


def to_tf32(x):
    """float32 `x` rounded to TF32 (10 mantissa bits), to nearest, ties to
    even."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


class _Tf32Consts(idct.Consts):
    """idct.Consts whose matrices are rounded to TF32."""

    def get(self, name: str, n: int) -> torch.Tensor:
        return to_tf32(super().get(name, n))


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 matrix products and convolutions on the card inside the block
    (the control); float32 elsewhere."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def render(coded, width: int, height: int, device, precision: str = "float32"):
    """(height, width, 3) float32: the frame the writer coded as 8-bit
    output before its rounding (stages.to_u8_unrounded)."""
    planes = [upsampled(p, coded["hshift"][c], coded["vshift"][c], width, height)
              for c, p in enumerate(channel_planes(coded, device, precision))]
    rgb = ycbcr_to_rgb(*planes)
    return torch.stack([stages.to_u8_unrounded(p, i) for i, p in enumerate(rgb)], dim=-1)
