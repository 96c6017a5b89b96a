"""Inverse VarDCT transforms in plain torch, (N, ...) blocks of one type at a
time: the transform types the benchmark's writer places (DCT8, DCT16x16
and every 1x1 type).

The math of ISO/IEC 18181-1's inverse transforms as float32 matrix
products (libjxl's jxl_transforms slow oracle: IDCT basis A(N)[y, u] =
sqrt(2) alpha(u) cos((y + 0.5) u pi / N), the lowest frequencies of a
large block from its LF tile by the reinterpreting DCT). A frozen copy,
as of the first benchmark, of the decoder package's plain batched
transforms, with the same fixed chunk of blocks a product: cuBLAS picks
its kernel by a product's shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..writers import spec
from .afv_basis import AFV4X4BASIS

_AFV_BASIS = np.array(AFV4X4BASIS, dtype=np.float32).reshape(16, 16)
# pixels a chunk: 4 MB of float32 a product on the card, 64 KB on the CPU
CHUNK_PIXELS = 1 << 20
CPU_CHUNK_PIXELS = 1 << 14


@functools.lru_cache(maxsize=None)
def idct_matrix(n: int) -> np.ndarray:
    """A(N)[y, u]: pixels = A @ coeffs."""
    u = np.arange(n)[None, :]
    y = np.arange(n)[:, None]
    alpha = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    return (np.sqrt(2.0) * alpha * np.cos((y + 0.5) * u * np.pi / n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_scales(n: int) -> np.ndarray:
    """The reinterpreting DCT's normative scales."""
    i = np.arange(n, dtype=np.float64)
    return (np.cos(i / (16 * n) * np.pi) * np.cos(i / (8 * n) * np.pi)
            * np.cos(i / (4 * n) * np.pi) * n).astype(np.float32)


def pixel_shape(t: int) -> tuple:
    return 8 * spec.CBY[t], 8 * spec.CBX[t]


def coeff_storage_shape(t: int) -> tuple:
    cx, cy = spec.CBX[t], spec.CBY[t]
    return 8 * min(cx, cy), 8 * max(cx, cy)


class Consts:
    """The float32 constant matrices on one device."""

    def __init__(self, device):
        self.device = device
        self._cache = {}

    def get(self, name: str, n: int) -> torch.Tensor:
        key = (name, n)
        if key not in self._cache:
            src = {"idct": idct_matrix, "dct": lambda k: idct_matrix(k).T.copy(),
                   "scales": dct_scales, "afv": lambda _: _AFV_BASIS}[name](n)
            self._cache[key] = torch.from_numpy(np.ascontiguousarray(src)).to(self.device)
        return self._cache[key]


def idct2d(k: Consts, coeffs, rows: int, cols: int):
    """(N, rows*cols) flat coefficient buffers -> (N, rows, cols) pixels."""
    n = coeffs.shape[0]
    if rows < cols:
        t = coeffs.reshape(n, rows, cols).transpose(1, 2)
    else:
        t = coeffs.reshape(n, cols, rows)
    s1 = torch.matmul(k.get("idct", t.shape[1]), t)
    return torch.matmul(k.get("idct", t.shape[2]), s1.transpose(1, 2))


def reinterpreting_dct(k: Consts, lf):
    """(N, a, b) LF tiles -> (N, min, max) scaled DCT coefficients."""
    _, a, b = lf.shape
    d1 = torch.matmul(k.get("dct", a), lf)
    d2 = torch.matmul(d1, k.get("dct", b).T).transpose(1, 2)
    if a < b:
        return d2.transpose(1, 2) / (k.get("scales", a)[None, :, None]
                                     * k.get("scales", b)[None, None, :])
    return d2 / (k.get("scales", b)[None, :, None] * k.get("scales", a)[None, None, :])


def _idct4_sq(k: Consts, c):
    a = k.get("idct", 4)
    return torch.matmul(a, torch.matmul(a, c).transpose(1, 2))


def _idct2_top_block(s, block):
    out = block.clone()
    n = s // 2
    c00 = block[:, :n, :n]
    c01 = block[:, :n, n : 2 * n]
    c10 = block[:, n : 2 * n, :n]
    c11 = block[:, n : 2 * n, n : 2 * n]
    out[:, 0 : 2 * n : 2, 0 : 2 * n : 2] = c00 + c01 + c10 + c11
    out[:, 0 : 2 * n : 2, 1 : 2 * n : 2] = c00 + c01 - c10 - c11
    out[:, 1 : 2 * n : 2, 0 : 2 * n : 2] = c00 - c01 + c10 - c11
    out[:, 1 : 2 * n : 2, 1 : 2 * n : 2] = c00 - c01 - c10 + c11
    return out


def _with_dc(c, dc):
    c = c.clone()
    c[:, 0, 0] = dc
    return c


def _corner_dcs4(c):
    b00, b01, b10, b11 = c[:, 0, 0], c[:, 0, 1], c[:, 1, 0], c[:, 1, 1]
    return [b00 + b01 + b10 + b11, b00 + b01 - b10 - b11,
            b00 - b01 + b10 - b11, b00 - b01 - b10 + b11]


def _identity(c, n):
    """The Hornuss transform."""
    dcs = _corner_dcs4(c)
    out = torch.zeros((n, 8, 8), dtype=c.dtype, device=c.device)
    for y in range(2):
        for x in range(2):
            rs = None
            for iy in range(4):
                for ix in range(4):
                    if ix == 0 and iy == 0:
                        continue
                    v = c[:, y + iy * 2, x + ix * 2]
                    rs = v if rs is None else rs + v
            center = dcs[y * 2 + x] - rs * np.float32(1.0 / 16.0)
            out[:, y * 4 : y * 4 + 4, x * 4 : x * 4 + 4] = c[:, y::2, x::2] + center[:, None, None]
            out[:, 4 * y + 1, 4 * x + 1] = center
            out[:, y * 4, x * 4] = c[:, y + 2, x + 2] + center
    return out


def _afv(k: Consts, afv_kind, lf, coeffs):
    n = coeffs.shape[0]
    c = _with_dc(coeffs.reshape(n, 8, 8), lf[:, 0, 0])
    afv_x, afv_y = afv_kind & 1, afv_kind // 2
    b00, b01, b10 = c[:, 0, 0], c[:, 0, 1], c[:, 1, 0]
    dcs = [(b00 + b10 + b01) * 4.0, b00 + b10 - b01, b00 - b10]
    pixels = torch.zeros((n, 8, 8), dtype=coeffs.dtype, device=coeffs.device)
    cc = _with_dc(c[:, 0:8:2, 0:8:2], dcs[0])
    block = torch.matmul(cc.reshape(n, 16), k.get("afv", 16)).reshape(n, 4, 4)
    if afv_y == 1:
        block = block.flip(1)
    if afv_x == 1:
        block = block.flip(2)
    pixels[:, afv_y * 4 : afv_y * 4 + 4, afv_x * 4 : afv_x * 4 + 4] = block
    cd = _with_dc(c[:, 0:8:2, 1:8:2], dcs[1])
    x0 = (1 - afv_x) * 4
    pixels[:, afv_y * 4 : afv_y * 4 + 4, x0 : x0 + 4] = _idct4_sq(k, cd)
    ce = _with_dc(c[:, 1:8:2, :], dcs[2])
    y0 = (1 - afv_y) * 4
    pixels[:, y0 : y0 + 4, :] = idct2d(k, ce.reshape(n, 32), 4, 8)
    return pixels


def _chunk(k: Consts, t: int, lf, coeffs):
    n = coeffs.shape[0]
    rows, cols = pixel_shape(t)
    if t == spec.DCT:
        buf = coeffs.clone()
        buf[:, 0] = lf[:, 0, 0]
        return idct2d(k, buf, 8, 8)
    if spec.AFV0 <= t <= spec.AFV3:
        return _afv(k, t - spec.AFV0, lf, coeffs)
    if t in (spec.IDENTITY, spec.DCT2X2, spec.DCT4X4, spec.DCT8X4, spec.DCT4X8):
        c = _with_dc(coeffs.reshape(n, 8, 8), lf[:, 0, 0])
        if t == spec.DCT2X2:
            c = _idct2_top_block(2, c)
            c = _idct2_top_block(4, c)
            return _idct2_top_block(8, c)
        if t == spec.DCT4X4:
            dcs = _corner_dcs4(c)
            quads = [[_idct4_sq(k, _with_dc(c[:, y::2, x::2], dcs[y * 2 + x])) for x in range(2)]
                     for y in range(2)]
            return torch.cat([torch.cat(quads[0], dim=2), torch.cat(quads[1], dim=2)], dim=1)
        if t in (spec.DCT8X4, spec.DCT4X8):
            dcs = [c[:, 0, 0] + c[:, 1, 0], c[:, 0, 0] - c[:, 1, 0]]
            outs = []
            for j in range(2):
                blk = _with_dc(c[:, j::2, :], dcs[j]).reshape(n, 32)
                outs.append(idct2d(k, blk, 8, 4) if t == spec.DCT8X4 else idct2d(k, blk, 4, 8))
            return torch.cat(outs, dim=2 if t == spec.DCT8X4 else 1)
        return _identity(c, n)
    if t != spec.DCT16X16:
        raise ValueError(f"transform type {t} is not one the benchmark's writer places")
    srows, scols = coeff_storage_shape(t)
    buf = coeffs.reshape(n, srows, scols).clone()
    lfc = reinterpreting_dct(k, lf.float())
    buf[:, : lfc.shape[1], : lfc.shape[2]] = lfc
    return idct2d(k, buf.reshape(n, srows * scols), rows, cols)


def transform_to_pixels(k: Consts, t: int, lf, coeffs):
    """lf (N, cy, cx) and dequantized coeffs (N, num_coeffs) float32 on one
    device -> (N, rows, cols) pixels, in chunks of a fixed block count a
    type, the last one padded with zero blocks."""
    n = coeffs.shape[0]
    rows, cols = pixel_shape(t)
    chunk = CHUNK_PIXELS if coeffs.device.type == "cuda" else CPU_CHUNK_PIXELS
    size = max(1, chunk // (rows * cols))
    if n == size:
        return _chunk(k, t, lf, coeffs)
    out = torch.empty((n, rows, cols), dtype=torch.float32, device=coeffs.device)
    for i in range(0, n, size):
        m = min(size, n - i)
        lf_c, co_c = lf[i : i + m], coeffs[i : i + m]
        if m < size:
            lf_c = torch.nn.functional.pad(lf_c, (0, 0, 0, 0, 0, size - m))
            co_c = torch.nn.functional.pad(co_c, (0, 0, 0, size - m))
        out[i : i + m] = _chunk(k, t, lf_c, co_c)[:m]
    return out
