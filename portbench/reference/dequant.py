"""Dequantization matrices from the parameters a stream codes, as plain
NumPy: the "Quantization weights" of ISO/IEC 18181-1 (libjxl's
jxl/src/frame/quant_weights.rs). A frozen copy, as of the first benchmark,
of the decoder package's plain table computation, taking the writer's
record of what it coded in place of a bit reader.
"""

from __future__ import annotations

import math

import numpy as np

from ..writers import spec

ALMOST_ZERO = 1e-8


def _mult(v: float) -> float:
    return 1.0 + v if v > 0 else 1.0 / (1.0 - v)


def _interpolate(pos: float, mx: float, array) -> float:
    scaled = pos * (len(array) - 1) / mx
    idx = int(scaled)
    a, b = array[idx], array[idx + 1]
    return a * (b / a) ** (scaled - idx)


def _bands(row) -> list:
    bands = [row[0]]
    for v in row[1:]:
        bands.append(bands[-1] * _mult(v))
    if min(bands) < ALMOST_ZERO:
        raise ValueError("invalid distance band")
    return bands


def _quant_weights(rows: int, cols: int, params) -> np.ndarray:
    """(3, rows, cols) interpolated distance-band weights."""
    out = np.zeros((3, rows, cols), dtype=np.float32)
    for c in range(3):
        bands = _bands(params[c])
        num_bands = len(params[c])
        scale = (num_bands - 1) / (math.sqrt(2.0) + 1e-6)
        dy = np.arange(rows, dtype=np.float64)[:, None] * (scale / (rows - 1))
        dx = np.arange(cols, dtype=np.float64)[None, :] * (scale / (cols - 1))
        dist = np.sqrt(dx * dx + dy * dy)
        if num_bands == 1:
            out[c] = bands[0]
            continue
        idx = np.minimum(np.floor(dist).astype(int), num_bands - 2)
        frac = dist - np.floor(dist)
        barr = np.array(bands + [bands[-1]], dtype=np.float64)
        out[c] = (barr[idx + 1] / barr[idx]) ** frac * barr[idx]
    return out


_AFV_FREQS = [0.0, 0.0, 0.8517778890324296, 5.37778436506804, 0.0, 0.0,
              4.734747904497923, 5.449245381693219, 1.6598270267479331, 4.0,
              7.275749096817861, 10.423227632456525, 2.662932286148962,
              7.630657783650829, 8.962388608184032, 12.97166202570235]


def compute_table(mode: str, data, kind: int) -> np.ndarray:
    """(3, n) float32 dequant multipliers (1 / weight) of table kind
    `kind` coded in `mode` with the parameters `data`, in coefficient
    storage order."""
    wrows, wcols = 8 * spec.REQUIRED_SIZE_X[kind], 8 * spec.REQUIRED_SIZE_Y[kind]
    num = wrows * wcols
    weights = np.zeros((3, num), dtype=np.float32)
    if mode == "identity":
        for c in range(3):
            weights[c, :64] = data[c][0]
            weights[c, 1] = data[c][1]
            weights[c, 8] = data[c][1]
            weights[c, 9] = data[c][2]
    elif mode == "dct2":
        for c in range(3):
            w = data[c]
            m = weights[c].reshape(8, 8)
            m[0, 0] = 0xBAD
            m[0, 1] = m[1, 0] = w[0]
            m[1, 1] = w[1]
            m[:2, 2:4] = w[2]
            m[2:4, :2] = w[2]
            m[2:4, 2:4] = w[3]
            m[:4, 4:8] = w[4]
            m[4:8, :4] = w[4]
            m[4:8, 4:8] = w[5]
    elif mode == "dct4":
        params, xyb_mul = data
        w44 = _quant_weights(4, 4, params)
        for c in range(3):
            m = weights[c].reshape(8, 8)
            m[:] = np.repeat(np.repeat(w44[c], 2, 0), 2, 1)
            m[0, 1] /= xyb_mul[c][0]
            m[1, 0] /= xyb_mul[c][0]
            m[1, 1] /= xyb_mul[c][1]
    elif mode == "dct4x8":
        params, xyb_mul = data
        w48 = _quant_weights(4, 8, params)
        for c in range(3):
            m = weights[c].reshape(8, 8)
            m[:] = np.repeat(w48[c], 2, 0)
            m[1, 0] /= xyb_mul[c]
    elif mode == "dct":
        weights[:] = _quant_weights(wrows, wcols, data).reshape(3, num)
    elif mode == "raw":
        qtable, den = data
        weights[:] = 1.0 / (den * np.array(qtable, dtype=np.float32).reshape(3, num))
    elif mode == "afv":
        params4x8, params4x4, afv_weights = data
        lo = 0.8517778890324296
        hi = 12.97166202570235 - lo + 1e-6
        w48 = _quant_weights(4, 8, params4x8)
        w44 = _quant_weights(4, 4, params4x4)
        for c in range(3):
            aw = afv_weights[c]
            bands = [aw[5]]
            for i in range(1, 4):
                bands.append(bands[-1] * _mult(aw[i + 5]))
            m = weights[c].reshape(8, 8)
            m[0, 0] = 1.0
            m[1, 0] = aw[0]
            m[0, 1] = aw[1]
            m[2, 0] = aw[2]
            m[0, 2] = aw[3]
            m[2, 2] = aw[4]
            for y in range(4):
                for x in range(4):
                    if x >= 2 or y >= 2:
                        m[2 * y, 2 * x] = _interpolate(_AFV_FREQS[y * 4 + x] - lo, hi, bands)
            for y in range(4):
                for x in range(8):
                    if x or y:
                        m[2 * y + 1, x] = w48[c, y, x]
            for y in range(4):
                for x in range(4):
                    if x or y:
                        m[2 * y, 2 * x + 1] = w44[c, y, x]
    else:
        raise ValueError(f"unknown dequant mode {mode!r}")
    if np.any((weights < ALMOST_ZERO) | (weights > 1.0 / ALMOST_ZERO)):
        raise ValueError("invalid quantization table weight")
    return (1.0 / weights).astype(np.float32)


def library_table(kind: int) -> np.ndarray:
    """The library's table of kind `kind` (those the benchmark's
    transforms use)."""
    d = spec.DCT_BANDS
    return {
        0: lambda: compute_table("dct", d["dct"], 0),
        1: lambda: compute_table("identity", spec.IDENTITY_W, 1),
        2: lambda: compute_table("dct2", spec.DCT2_W, 2),
        3: lambda: compute_table("dct4", (d["dct4x4"], [[1.0, 1.0]] * 3), 3),
        4: lambda: compute_table("dct", d["dct16x16"], 4),
        9: lambda: compute_table("dct4x8", (d["dct4x8"], [1.0, 1.0, 1.0]), 9),
        10: lambda: compute_table("afv", (d["dct4x8"], d["dct4x4"], spec.AFV_W), 10),
    }[kind]()


def matrices(coded_tables, transform_types) -> dict:
    """{transform type: (3, n) float32 multipliers} of the types in use,
    from the writer's record of the coded tables (None: every table the
    library's)."""
    out = {}
    for t in transform_types:
        kind = spec.TABLE_FOR_TYPE[t]
        mode, data = ("library", None) if coded_tables is None else coded_tables[kind]
        n = 64 * spec.CBX[t] * spec.CBY[t]
        table = library_table(kind) if mode == "library" else compute_table(mode, data, kind)
        out[t] = table[:, :n]
    return out
