"""Inverse VarDCT transforms: all 27 block types.

Capability reference: jxl_transforms/src/{transform.rs,idct2d.rs,
reinterpreting_dct2d.rs,tests.rs}. The math follows the reference's own
slow oracle exactly (tests.rs:26-176):

- IDCT basis A(N)[y,u] = sqrt(2) * alpha(u) * cos((y+0.5) u pi / N),
  alpha(0)=1/sqrt(2) (so IDCT(FDCT(x)) = N*x — unnormalized pair).
- Coefficient storage is row-major (8*min(cx,cy), 8*max(cx,cy)):
  tall blocks store their coefficients transposed.
- "Reinterpreting DCT" recovers the lowest frequencies from the LF image:
  2-D unnormalized DCT of the (cy,cx) LF tile divided by the normative
  scales(n)[i] = cos(i pi/16n) cos(i pi/8n) cos(i pi/4n) * n.

Formulated as matrix multiplications: on TPU these become batched MXU
matmuls (see ops/idct.py); this module is the numpy host oracle with
identical numerics.
"""

from __future__ import annotations

import functools

import numpy as np

from ._afv_basis import AFV4X4BASIS
from .transform_map import HfTransformType as T, covered_blocks_x, covered_blocks_y

BLOCK_DIM = 8


@functools.lru_cache(maxsize=None)
def idct_matrix(n: int) -> np.ndarray:
    """A(N)[y, u] — pixels = A @ coeffs."""
    u = np.arange(n)[None, :]
    y = np.arange(n)[:, None]
    alpha = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    return (np.sqrt(2.0) * alpha * np.cos((y + 0.5) * u * np.pi / n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """D(N)[u, y] — coeffs = D @ pixels (unnormalized: D @ A = N*I)."""
    return idct_matrix(n).T.copy()


@functools.lru_cache(maxsize=None)
def dct_scales(n: int) -> np.ndarray:
    """Normative reinterpreting-DCT scales (ref tests.rs:136-146)."""
    i = np.arange(n, dtype=np.float64)
    return (
        np.cos(i / (16 * n) * np.pi)
        * np.cos(i / (8 * n) * np.pi)
        * np.cos(i / (4 * n) * np.pi)
        * n
    ).astype(np.float32)


def coeff_storage_shape(t: int) -> tuple[int, int]:
    """(rows, cols) of the coefficient storage: (8*min, 8*max)."""
    cx, cy = covered_blocks_x(t), covered_blocks_y(t)
    return (BLOCK_DIM * min(cx, cy), BLOCK_DIM * max(cx, cy))


def pixel_shape(t: int) -> tuple[int, int]:
    """(rows, cols) of the output pixel block."""
    return (BLOCK_DIM * covered_blocks_y(t), BLOCK_DIM * covered_blocks_x(t))


def idct2d(coeffs: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """2-D IDCT of a flat coefficient buffer -> (rows, cols) pixels.

    Matches ref slow_idct2d: for rows >= cols the flat buffer is
    reinterpreted as a (cols, rows) matrix (transposed storage).
    """
    if rows < cols:
        t = coeffs.reshape(rows, cols).T
    else:
        t = coeffs.reshape(cols, rows)
    # t: (cols? , rows?) — shape (C', R') with C' = cols-dim first
    step1 = idct_matrix(t.shape[0]) @ t
    out = idct_matrix(step1.shape[1]) @ step1.T
    return out  # (rows, cols)


def reinterpreting_dct(lf_tile: np.ndarray) -> np.ndarray:
    """Scaled DCT of the LF tile (cy, cx) -> (min, max) coefficient matrix.

    ref slow_reinterpreting_dct2d (tests.rs:147-176).
    """
    a, b = lf_tile.shape  # rows=cy, cols=cx
    d1 = dct_matrix(a) @ lf_tile  # (a, b)
    d2 = dct_matrix(b) @ d1.T  # (b, a)
    if a < b:
        res = d2.T  # (a, b)
        res = res / (dct_scales(a)[:, None] * dct_scales(b)[None, :])
    else:
        res = d2  # (b, a)
        res = res / (dct_scales(b)[:, None] * dct_scales(a)[None, :])
    return res.astype(np.float32)


_AFV_BASIS = np.array(AFV4X4BASIS, dtype=np.float32).reshape(16, 16)


def _afv_to_pixels(afv_kind: int, coeffs: np.ndarray) -> np.ndarray:
    """ref transform.rs:304-372. coeffs: (8,8) incl. LF at [0,0]."""
    afv_x = afv_kind & 1
    afv_y = afv_kind // 2
    pixels = np.zeros((8, 8), dtype=np.float32)
    b00, b01, b10 = coeffs[0, 0], coeffs[0, 1], coeffs[1, 0]
    dcs = np.array(
        [(b00 + b10 + b01) * 4.0, b00 + b10 - b01, b00 - b10], dtype=np.float32
    )
    # AFV on (even, even)
    c = coeffs[0:8:2, 0:8:2].copy()
    c[0, 0] = dcs[0]
    block = (c.reshape(1, 16) @ _AFV_BASIS).reshape(4, 4)
    by = block[::-1, :] if afv_y == 1 else block
    bxy = by[:, ::-1] if afv_x == 1 else by
    pixels[afv_y * 4 : afv_y * 4 + 4, afv_x * 4 : afv_x * 4 + 4] = bxy
    # DCT4x4 on (even rows, odd cols)
    c = coeffs[0:8:2, 1:8:2].copy()
    c[0, 0] = dcs[1]
    blk = idct_matrix(4) @ (idct_matrix(4) @ c).T  # slow_idct2d square
    pixels[afv_y * 4 : afv_y * 4 + 4, (1 - afv_x) * 4 : (1 - afv_x) * 4 + 4] = blk
    # DCT4x8 on odd rows
    c = coeffs[1:8:2, :].copy()
    c[0, 0] = dcs[2]
    blk = idct2d(c.ravel(), 4, 8)
    pixels[(1 - afv_y) * 4 : (1 - afv_y) * 4 + 4, :] = blk
    return pixels


def _idct2_top_block(s: int, block: np.ndarray) -> np.ndarray:
    out = block.copy()
    n = s // 2
    c00 = block[:n, :n]
    c01 = block[:n, n : 2 * n]
    c10 = block[n : 2 * n, :n]
    c11 = block[n : 2 * n, n : 2 * n]
    out[0 : 2 * n : 2, 0 : 2 * n : 2] = c00 + c01 + c10 + c11
    out[0 : 2 * n : 2, 1 : 2 * n : 2] = c00 + c01 - c10 - c11
    out[1 : 2 * n : 2, 0 : 2 * n : 2] = c00 - c01 + c10 - c11
    out[1 : 2 * n : 2, 1 : 2 * n : 2] = c00 - c01 - c10 + c11
    return out


def transform_to_pixels(t: int, lf_tile: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Inverse transform: LF tile (cy,cx) + flat AC coefficients -> pixels.

    `coeffs` is the flat num_coeffs dequantized buffer in storage order;
    positions covered by the reinterpreting DCT are overwritten from LF.
    Returns (cy*8, cx*8) pixels. ref transform.rs:375-662.
    """
    cx, cy = covered_blocks_x(t), covered_blocks_y(t)
    rows, cols = pixel_shape(t)

    if t == T.DCT:
        buf = coeffs.copy()
        buf[0] = lf_tile[0, 0]
        return idct2d(buf, 8, 8)

    if t in (T.AFV0, T.AFV1, T.AFV2, T.AFV3):
        buf = coeffs.copy().reshape(8, 8)
        buf[0, 0] = lf_tile[0, 0]
        return _afv_to_pixels(int(t) - int(T.AFV0), buf)

    if t == T.IDENTITY:
        c = coeffs.copy().reshape(8, 8)
        c[0, 0] = lf_tile[0, 0]
        out = np.zeros((8, 8), dtype=np.float32)
        dcs = [
            c[0, 0] + c[0, 1] + c[1, 0] + c[1, 1],
            c[0, 0] + c[0, 1] - c[1, 0] - c[1, 1],
            c[0, 0] - c[0, 1] + c[1, 0] - c[1, 1],
            c[0, 0] - c[0, 1] - c[1, 0] + c[1, 1],
        ]
        for y in range(2):
            for x in range(2):
                block_dc = dcs[y * 2 + x]
                residual_sum = 0.0
                for iy in range(4):
                    for ix in range(4):
                        if ix == 0 and iy == 0:
                            continue
                        residual_sum += c[y + iy * 2, x + ix * 2]
                center = block_dc - residual_sum * (1.0 / 16.0)
                out[4 * y + 1, 4 * x + 1] = center
                for iy in range(4):
                    for ix in range(4):
                        if ix == 1 and iy == 1:
                            continue
                        out[y * 4 + iy, x * 4 + ix] = c[y + iy * 2, x + ix * 2] + center
                out[y * 4, x * 4] = c[y + 2, x + 2] + center
        return out

    if t == T.DCT2X2:
        c = coeffs.copy().reshape(8, 8)
        c[0, 0] = lf_tile[0, 0]
        c = _idct2_top_block(2, c)
        c = _idct2_top_block(4, c)
        return _idct2_top_block(8, c)

    if t == T.DCT4X4:
        c = coeffs.copy().reshape(8, 8)
        c[0, 0] = lf_tile[0, 0]
        dcs = [
            c[0, 0] + c[0, 1] + c[1, 0] + c[1, 1],
            c[0, 0] + c[0, 1] - c[1, 0] - c[1, 1],
            c[0, 0] - c[0, 1] + c[1, 0] - c[1, 1],
            c[0, 0] - c[0, 1] - c[1, 0] + c[1, 1],
        ]
        out = np.zeros((8, 8), dtype=np.float32)
        for y in range(2):
            for x in range(2):
                block = c[y::2, x::2].copy()
                block[0, 0] = dcs[y * 2 + x]
                pix = idct_matrix(4) @ (idct_matrix(4) @ block).T
                out[y * 4 : y * 4 + 4, x * 4 : x * 4 + 4] = pix
        return out

    if t in (T.DCT8X4, T.DCT4X8):
        c = coeffs.copy().reshape(8, 8)
        c[0, 0] = lf_tile[0, 0]
        dcs = [c[0, 0] + c[1, 0], c[0, 0] - c[1, 0]]
        out = np.zeros((8, 8), dtype=np.float32)
        if t == T.DCT8X4:
            for x in range(2):
                block = c[x::2, :].copy()  # (4, 8)
                block[0, 0] = dcs[x]
                pix = idct2d(block.ravel(), 8, 4)  # (8 rows, 4 cols)
                out[:, x * 4 : x * 4 + 4] = pix
        else:
            for y in range(2):
                block = c[y::2, :].copy()
                block[0, 0] = dcs[y]
                pix = idct2d(block.ravel(), 4, 8)
                out[y * 4 : y * 4 + 4, :] = pix
        return out

    # general DCT >= 16 in one dimension: reinterpreting DCT for LF
    srows, scols = coeff_storage_shape(t)
    buf = coeffs.copy().reshape(srows, scols)
    lfc = reinterpreting_dct(lf_tile.astype(np.float32))
    buf[: lfc.shape[0], : lfc.shape[1]] = lfc
    return idct2d(buf.ravel(), rows, cols)
