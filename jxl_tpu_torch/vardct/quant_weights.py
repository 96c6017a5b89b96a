"""Adaptive dequantization weight tables: 17 table kinds x 8 encoding modes.

Capability reference: jxl/src/frame/quant_weights.rs (spec "Quantization
weights"). Default parameter values are normative spec constants. Tables
are computed once per frame and shipped to the device as constant f32
tensors in the coefficient storage layout (narrow x wide, see
transforms.py).
"""

from __future__ import annotations

import math

import numpy as np

from ..errors import HfQuantFactorTooSmall, InvalidAFVBands, InvalidBitstream, InvalidDistanceBand, InvalidQuantEncoding, InvalidQuantizationTableWeight, InvalidRawQuantTable
from ..io.bit_reader import BitReader
from ..io.bundle import F16 as _F16
from .transform_map import HfTransformType as T

ALMOST_ZERO = 1e-8
NUM_QUANT_TABLES = 17
BLOCK_DIM = 8

# QuantTable kind per transform type (ref quant_weights.rs:323-346)
_TABLE_FOR_TYPE = {
    T.DCT: 0, T.IDENTITY: 1, T.DCT2X2: 2, T.DCT4X4: 3, T.DCT16X16: 4,
    T.DCT32X32: 5, T.DCT16X8: 6, T.DCT8X16: 6, T.DCT32X8: 7, T.DCT8X32: 7,
    T.DCT32X16: 8, T.DCT16X32: 8, T.DCT4X8: 9, T.DCT8X4: 9,
    T.AFV0: 10, T.AFV1: 10, T.AFV2: 10, T.AFV3: 10,
    T.DCT64X64: 11, T.DCT64X32: 12, T.DCT32X64: 12,
    T.DCT128X128: 13, T.DCT128X64: 14, T.DCT64X128: 14,
    T.DCT256X256: 15, T.DCT256X128: 16, T.DCT128X256: 16,
}

REQUIRED_SIZE_X = [1, 1, 1, 1, 2, 4, 1, 1, 2, 1, 1, 8, 4, 16, 8, 32, 16]
REQUIRED_SIZE_Y = [1, 1, 1, 1, 2, 4, 2, 4, 4, 1, 1, 8, 8, 16, 16, 32, 32]

# -- normative default distance-band parameters (spec; ref :380-858) ---------

_D = {
    "dct": [
        [3150.0, 0.0, -0.4, -0.4, -0.4, -2.0],
        [560.0, 0.0, -0.3, -0.3, -0.3, -0.3],
        [512.0, -2.0, -1.0, 0.0, -1.0, -2.0],
    ],
    "dct16x16": [
        [8996.8725711814115328, -1.3000777393353804, -0.49424529824571225,
         -0.439093774457103443, -0.6350101832695744, -0.90177264050827612,
         -1.6162099239887414],
        [3191.48366296844234752, -0.67424582104194355, -0.80745813428471001,
         -0.44925837484843441, -0.35865440981033403, -0.31322389111877305,
         -0.37615025315725483],
        [1157.50408145487200256, -2.0531423165804414, -1.4,
         -0.50687130033378396, -0.42708730624733904, -1.4856834539296244,
         -4.9209142884401604],
    ],
    "dct32x32": [
        [15718.40830982518931456, -1.025, -0.98, -0.9012, -0.4,
         -0.48819395464, -0.421064, -0.27],
        [7305.7636810695983104, -0.8041958212306401, -0.7633036457487539,
         -0.55660379990111464, -0.49785304658857626, -0.43699592683512467,
         -0.40180866526242109, -0.27321683125358037],
        [3803.53173721215041536, -3.060733579805728, -2.0413270132490346,
         -2.0235650159727417, -0.5495389509954993, -0.4, -0.4, -0.3],
    ],
    "dct8x16": [
        [7240.7734393502, -0.7, -0.7, -0.2, -0.2, -0.2, -0.5],
        [1448.15468787004, -0.5, -0.5, -0.5, -0.2, -0.2, -0.2],
        [506.854140754517, -1.4, -0.2, -0.5, -0.5, -1.5, -3.6],
    ],
    "dct8x32": [
        [16283.2494710648897, -1.7812845336559429, -1.6309059012653515,
         -1.0382179034313539, -0.85, -0.7, -0.9, -1.2360638576849587],
        [5089.15750884921511936, -0.320049391452786891, -0.35362849922161446,
         -0.30340000000000003, -0.61, -0.5, -0.5, -0.6],
        [3397.77603275308720128, -0.321327362693153371, -0.34507619223117997,
         -0.70340000000000003, -0.9, -1.0, -1.0, -1.1754605576265209],
    ],
    "dct16x32": [
        [13844.97076442300573, -0.97113799999999995, -0.658, -0.42026,
         -0.22712, -0.2206, -0.226, -0.6],
        [4798.964084220744293, -0.61125308982767057, -0.83770786552491361,
         -0.79014862079498627, -0.2692727459704829, -0.38272769465388551,
         -0.22924222653091453, -0.20719098826199578],
        [1807.236946760964614, -1.2, -1.2, -0.7, -0.7, -0.7, -0.4, -0.5],
    ],
    "dct4x8": [
        [2198.050556016380522, -0.96269623020744692, -0.76194253026666783,
         -0.6551140670773547],
        [764.3655248643528689, -0.92630200888366945, -0.9675229603596517,
         -0.27845290869168118],
        [527.107573587542228, -1.4594385811273854, -1.450082094097871593,
         -1.5843722511996204],
    ],
    "dct4x4": [
        [2200.0, 0.0, 0.0, 0.0],
        [392.0, 0.0, 0.0, 0.0],
        [112.0, -0.25, -0.25, -0.5],
    ],
}

_BIG = [
    [26629.073922049845, -1.025, -0.78, -0.65012, -0.19041574084286472,
     -0.20819395464, -0.421064, -0.32733845535848671],
    [9311.3238710010046, -0.3041958212306401, -0.3633036457487539,
     -0.35660379990111464, -0.3443074455424403, -0.33699592683512467,
     -0.30180866526242109, -0.27321683125358037],
    [4992.2486445538634, -1.2, -1.2, -0.8, -0.7, -0.7, -0.4, -0.5],
]
_BIG_RECT = [
    [23629.073922049845] + _BIG[0][1:],
    [8611.3238710010046] + _BIG[1][1:],
    [4492.2486445538634] + _BIG[2][1:],
]


def _scaled(base, f):
    return [[row[0] * f] + row[1:] for row in base]


_IDENTITY_W = [[280.0, 3160.0, 3160.0], [60.0, 864.0, 864.0], [18.0, 200.0, 200.0]]
_DCT2_W = [
    [3840.0, 2560.0, 1280.0, 640.0, 480.0, 300.0],
    [960.0, 640.0, 320.0, 180.0, 140.0, 120.0],
    [640.0, 320.0, 128.0, 64.0, 32.0, 16.0],
]
_AFV_W = [
    [3072.0, 3072.0, 256.0, 256.0, 256.0, 414.0, 0.0, 0.0, 0.0],
    [1024.0, 1024.0, 50.0, 50.0, 50.0, 58.0, 0.0, 0.0, 0.0],
    [384.0, 384.0, 12.0, 12.0, 12.0, 22.0, -0.25, -0.25, -0.25],
]

LF_QUANT = (1.0 / 4096.0, 1.0 / 512.0, 1.0 / 256.0)


# -- encodings -----------------------------------------------------------------


class DctParams:
    __slots__ = ("params",)

    def __init__(self, params):
        self.params = [list(row) for row in params]

    @staticmethod
    def decode(br: BitReader) -> "DctParams":
        num_bands = br.read(4) + 1
        f16 = _F16()
        params = []
        for _ in range(3):
            row = [f16.read(br) for _ in range(num_bands)]
            if row[0] < ALMOST_ZERO:
                raise HfQuantFactorTooSmall("HF quant factor too small")
            row[0] *= 64.0
            params.append(row)
        return DctParams(params)


def _mult(v: float) -> float:
    return 1.0 + v if v > 0 else 1.0 / (1.0 - v)


def _interpolate_vec(scaled_pos: float, array) -> float:
    idx = int(math.floor(scaled_pos))
    frac = scaled_pos - idx
    a, b = array[idx], array[idx + 1]
    return (b / a) ** frac * a


def _interpolate(pos: float, mx: float, array) -> float:
    scaled = pos * (len(array) - 1) / mx
    idx = int(scaled)
    a, b = array[idx], array[idx + 1]
    return a * (b / a) ** (scaled - idx)


def _bands(row) -> list:
    bands = [row[0]]
    for v in row[1:]:
        nb = bands[-1] * _mult(v)
        if nb < ALMOST_ZERO:
            raise InvalidDistanceBand("invalid distance band")
        bands.append(nb)
    if bands[0] < ALMOST_ZERO:
        raise InvalidDistanceBand("invalid distance band")
    return bands


def _get_quant_weights(rows: int, cols: int, params: DctParams) -> np.ndarray:
    """(3, rows, cols) interpolated distance-band weights (ref :1140-1177)."""
    out = np.zeros((3, rows, cols), dtype=np.float32)
    for c in range(3):
        bands = _bands(params.params[c])
        num_bands = len(params.params[c])
        scale = (num_bands - 1) / (math.sqrt(2.0) + 1e-6)
        rcpcol = scale / (cols - 1)
        rcprow = scale / (rows - 1)
        dy = np.arange(rows, dtype=np.float64)[:, None] * rcprow
        dx = np.arange(cols, dtype=np.float64)[None, :] * rcpcol
        dist = np.sqrt(dx * dx + dy * dy)
        if num_bands == 1:
            out[c, :, :] = bands[0]
        else:
            idx = np.floor(dist).astype(int)
            idx = np.minimum(idx, num_bands - 2)
            frac = dist - np.floor(dist)
            barr = np.array(bands + [bands[-1]], dtype=np.float64)
            a = barr[idx]
            b = barr[idx + 1]
            out[c, :, :] = (b / a) ** frac * a
    return out


# -- table computation --------------------------------------------------------


def _compute_table(mode: str, data, table_idx: int) -> np.ndarray:
    """Returns (3, wrows*wcols) inverse weights (1/weight)."""
    wrows = 8 * REQUIRED_SIZE_X[table_idx]
    wcols = 8 * REQUIRED_SIZE_Y[table_idx]
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
        w44 = _get_quant_weights(4, 4, params)
        for c in range(3):
            m = weights[c].reshape(8, 8)
            for y in range(8):
                for x in range(8):
                    m[y, x] = w44[c, y // 2, x // 2]
            m[0, 1] /= xyb_mul[c][0]
            m[1, 0] /= xyb_mul[c][0]
            m[1, 1] /= xyb_mul[c][1]
    elif mode == "dct4x8":
        params, xyb_mul = data
        w48 = _get_quant_weights(4, 8, params)
        for c in range(3):
            m = weights[c].reshape(8, 8)
            for y in range(8):
                m[y, :] = w48[c, y // 2, :]
            m[1, 0] /= xyb_mul[c]
    elif mode == "dct":
        params = data
        weights[:] = _get_quant_weights(wrows, wcols, params).reshape(3, num)
    elif mode == "raw":
        qtable, qtable_den = data
        if len(qtable) != 3 * num:
            raise InvalidRawQuantTable("invalid raw quant table size")
        arr = np.array(qtable, dtype=np.float32).reshape(3, num)
        weights[:] = 1.0 / (qtable_den * arr)
    elif mode == "afv":
        params4x8, params4x4, afv_weights = data
        FREQS = [0.0, 0.0, 0.8517778890324296, 5.37778436506804, 0.0, 0.0,
                 4.734747904497923, 5.449245381693219, 1.6598270267479331, 4.0,
                 7.275749096817861, 10.423227632456525, 2.662932286148962,
                 7.630657783650829, 8.962388608184032, 12.97166202570235]
        LO = 0.8517778890324296
        HI = 12.97166202570235 - LO + 1e-6
        w48 = _get_quant_weights(4, 8, params4x8)
        w44 = _get_quant_weights(4, 4, params4x4)
        for c in range(3):
            aw = afv_weights[c]
            bands = [aw[5]]
            if bands[0] < ALMOST_ZERO:
                raise InvalidAFVBands("invalid AFV band")
            for i in range(1, 4):
                bands.append(bands[-1] * _mult(aw[i + 5]))
                if bands[-1] < ALMOST_ZERO:
                    raise InvalidAFVBands("invalid AFV band")
            m = weights[c].reshape(8, 8)
            m[0, 0] = 1.0
            m[1, 0] = aw[0]
            m[0, 1] = aw[1]
            m[2, 0] = aw[2]
            m[0, 2] = aw[3]
            m[2, 2] = aw[4]
            for y in range(4):
                for x in range(4):
                    if x < 2 and y < 2:
                        continue
                    m[2 * y, 2 * x] = _interpolate(FREQS[y * 4 + x] - LO, HI, bands)
            for y in range(4):
                for x in range(8):
                    if x == 0 and y == 0:
                        continue
                    m[2 * y + 1, x] = w48[c, y, x]
            for y in range(4):
                for x in range(4):
                    if x == 0 and y == 0:
                        continue
                    m[2 * y, 2 * x + 1] = w44[c, y, x]
    else:
        raise AssertionError(mode)

    if np.any((weights < ALMOST_ZERO) | (weights > 1.0 / ALMOST_ZERO)):
        raise InvalidQuantizationTableWeight("invalid quantization table weight")
    return (1.0 / weights).astype(np.float32)


def _library_table(idx: int) -> np.ndarray:
    if idx == 0:
        return _compute_table("dct", DctParams(_D["dct"]), 0)
    if idx == 1:
        return _compute_table("identity", _IDENTITY_W, 1)
    if idx == 2:
        return _compute_table("dct2", _DCT2_W, 2)
    if idx == 3:
        return _compute_table("dct4", (DctParams(_D["dct4x4"]), [[1.0, 1.0]] * 3), 3)
    if idx == 4:
        return _compute_table("dct", DctParams(_D["dct16x16"]), 4)
    if idx == 5:
        return _compute_table("dct", DctParams(_D["dct32x32"]), 5)
    if idx == 6:
        return _compute_table("dct", DctParams(_D["dct8x16"]), 6)
    if idx == 7:
        return _compute_table("dct", DctParams(_D["dct8x32"]), 7)
    if idx == 8:
        return _compute_table("dct", DctParams(_D["dct16x32"]), 8)
    if idx == 9:
        return _compute_table("dct4x8", (DctParams(_D["dct4x8"]), [1.0, 1.0, 1.0]), 9)
    if idx == 10:
        return _compute_table(
            "afv", (DctParams(_D["dct4x8"]), DctParams(_D["dct4x4"]), _AFV_W), 10
        )
    if idx == 11:
        return _compute_table("dct", DctParams(_scaled(_BIG, 0.9)), 11)
    if idx == 12:
        return _compute_table("dct", DctParams(_scaled(_BIG_RECT, 0.65)), 12)
    if idx == 13:
        return _compute_table("dct", DctParams(_scaled(_BIG, 1.8)), 13)
    if idx == 14:
        return _compute_table("dct", DctParams(_scaled(_BIG_RECT, 1.3)), 14)
    if idx == 15:
        return _compute_table("dct", DctParams(_scaled(_BIG, 3.6)), 15)
    if idx == 16:
        return _compute_table("dct", DctParams(_scaled(_BIG_RECT, 2.6)), 16)
    raise AssertionError(idx)


_LIBRARY_CACHE: dict[int, np.ndarray] = {}


def library_table(idx: int) -> np.ndarray:
    if idx not in _LIBRARY_CACHE:
        _LIBRARY_CACHE[idx] = _library_table(idx)
    return _LIBRARY_CACHE[idx]


class DequantMatrices:
    """All 17 dequant tables for a frame, each (3, num) f32."""

    def __init__(self, tables):
        self.tables = tables

    def matrix(self, hf_type: int, c: int) -> np.ndarray:
        """Flat weights for channel c in coefficient storage order."""
        idx = _TABLE_FOR_TYPE[T(hf_type)]
        return self.tables[idx][c]

    def matrix3(self, hf_type: int, num_coeffs: int) -> np.ndarray:
        """(3, num_coeffs) channel stack, memoized per transform type
        (the per-group render loop asks for it once per tid per group)."""
        cache = getattr(self, "_m3", None)
        if cache is None:
            cache = self._m3 = {}
        key = (hf_type, num_coeffs)
        m = cache.get(key)
        if m is None:
            m = np.stack(
                [self.matrix(hf_type, c)[:num_coeffs] for c in range(3)]
            )
            cache[key] = m
        return m

    @staticmethod
    def decode(frame, br: BitReader) -> "DequantMatrices":
        """ref quant_weights.rs:1090-1128 + QuantEncoding::decode."""
        if br.read(1) == 1:
            return DequantMatrices([library_table(i) for i in range(NUM_QUANT_TABLES)])
        f16 = _F16()
        tables = []
        for i in range(NUM_QUANT_TABLES):
            rx, ry = REQUIRED_SIZE_X[i], REQUIRED_SIZE_Y[i]
            required_size = rx * ry
            mode = br.read(3)
            if mode == 0:
                tables.append(library_table(i))
                continue
            if mode in (1, 2, 3, 4, 5) and required_size != 1:
                raise InvalidQuantEncoding("invalid quant encoding for table size")
            if mode == 1:
                w = []
                for _ in range(3):
                    row = []
                    for _ in range(3):
                        v = f16.read(br)
                        if abs(v) < ALMOST_ZERO:
                            raise HfQuantFactorTooSmall("HF quant factor too small")
                        row.append(v * 64.0)
                    w.append(row)
                tables.append(_compute_table("identity", w, i))
            elif mode == 2:
                w = []
                for _ in range(3):
                    row = []
                    for _ in range(6):
                        v = f16.read(br)
                        if abs(v) < ALMOST_ZERO:
                            raise HfQuantFactorTooSmall("HF quant factor too small")
                        row.append(v * 64.0)
                    w.append(row)
                tables.append(_compute_table("dct2", w, i))
            elif mode == 3:
                xyb_mul = []
                for _ in range(3):
                    row = []
                    for _ in range(2):
                        v = f16.read(br)
                        if abs(v) < ALMOST_ZERO:
                            raise HfQuantFactorTooSmall("HF quant factor too small")
                        row.append(v)
                    xyb_mul.append(row)
                params = DctParams.decode(br)
                tables.append(_compute_table("dct4", (params, xyb_mul), i))
            elif mode == 4:
                xyb_mul = []
                for _ in range(3):
                    v = f16.read(br)
                    if abs(v) < ALMOST_ZERO:
                        raise HfQuantFactorTooSmall("HF quant factor too small")
                    xyb_mul.append(v)
                params = DctParams.decode(br)
                tables.append(_compute_table("dct4x8", (params, xyb_mul), i))
            elif mode == 5:
                w = []
                for _ in range(3):
                    row = [f16.read(br) for _ in range(9)]
                    for k in range(6):
                        row[k] *= 64.0
                    w.append(row)
                p48 = DctParams.decode(br)
                p44 = DctParams.decode(br)
                tables.append(_compute_table("afv", (p48, p44, w), i))
            elif mode == 6:
                params = DctParams.decode(br)
                tables.append(_compute_table("dct", params, i))
            elif mode == 7:
                qtable_den = f16.read(br)
                if qtable_den < ALMOST_ZERO:
                    raise InvalidRawQuantTable("invalid raw quant table denominator")
                from ..modular.decode import ModularStreamId, decode_modular_subbitstream
                from ..modular.channel import ModularChannel

                size = (rx * BLOCK_DIM, ry * BLOCK_DIM)
                chans = [ModularChannel(size, (0, 0), 8) for _ in range(3)]
                decode_modular_subbitstream(
                    chans,
                    ModularStreamId.quant_table(frame.header, i),
                    None,
                    frame.lf_global.tree,
                    br,
                )
                qtable = []
                for ch in chans:
                    vals = ch.data.ravel().tolist()
                    if any(v <= 0 for v in vals):
                        raise InvalidRawQuantTable("invalid raw quant table entry")
                    qtable.extend(vals)
                tables.append(_compute_table("raw", (qtable, qtable_den), i))
            else:
                raise InvalidQuantEncoding("invalid quant encoding mode")
        return DequantMatrices(tables)
