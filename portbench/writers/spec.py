"""Tables of the JPEG XL format that the benchmark's writers and its plain
reference both need, as plain NumPy.

A frozen copy, as of the first benchmark, of what the writers took from the
decoder package: the transform map's geometry (transform_map.py), the
natural coefficient orders (coeff_order.py), the default block-context map
(block_context.py), the ANS alias tables of a flat distribution
(entropy/ans.py) and the library's dequantization parameters
(quant_weights.py). The values are the format's normative constants
(ISO/IEC 18181-1; libjxl's jxl/src/frame/*.rs in the reference decoder).
"""

from __future__ import annotations

import functools

import numpy as np

# -- transform types -------------------------------------------------------------

DCT, IDENTITY, DCT2X2, DCT4X4, DCT16X16 = 0, 1, 2, 3, 4
DCT4X8, DCT8X4, AFV0, AFV3 = 12, 13, 14, 17
# blocks covered horizontally / vertically, and the order family (shape id)
CBX = (1, 1, 1, 1, 2, 4, 1, 2, 1, 4, 2, 4, 1, 1, 1, 1, 1, 1, 8, 4, 8, 16, 8, 16, 32, 16, 32)
CBY = (1, 1, 1, 1, 2, 4, 2, 1, 4, 1, 4, 2, 1, 1, 1, 1, 1, 1, 8, 8, 4, 16, 16, 8, 32, 32, 16)
SHAPE_ID = (0, 1, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 1, 1, 1, 1, 1, 1, 7, 8, 8, 9, 10, 10, 11, 12, 12)
# the transform type whose natural order each shape id uses
TRANSFORM_TYPE_LUT = (0, 1, 4, 5, 7, 9, 11, 18, 20, 21, 23, 24, 26)
# dequant table kind of each transform type
TABLE_FOR_TYPE = (0, 1, 2, 3, 4, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10, 10, 11, 12, 12, 13,
                  14, 14, 15, 16, 16)
BLOCK_SIZE = 64


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


@functools.lru_cache(maxsize=None)
def natural_order_array(t: int) -> np.ndarray:
    """The natural (zig-zag) order of transform type t: out[k] is the
    storage index of the k-th coefficient (cx >= cy)."""
    cx, cy = CBX[t], CBY[t]
    xsize = cx * 8
    xs = cx // cy
    xsm = xs - 1
    xss = _ceil_log2(xs)
    out = [0] * (cx * cy * BLOCK_SIZE)
    cur = cx * cy
    for i in range(xsize):
        for j in range(i + 1):
            x, y = j, i - j
            if i % 2:
                x, y = y, x
            if y & xsm:
                continue
            y >>= xss
            if x < cx and y < cy:
                val = y * cx + x
            else:
                val = cur
                cur += 1
            out[val] = y * xsize + x
    for ir in range(1, xsize):
        i = xsize - ir - 1
        for j in range(i + 1):
            x = xsize - 1 - (i - j)
            y = xsize - 1 - j
            if i % 2:
                x, y = y, x
            if y & xsm:
                continue
            y >>= xss
            out[cur] = y * xsize + x
            cur += 1
    a = np.array(out, dtype=np.int32)
    a.setflags(write=False)
    return a


# the default block-context map (15 contexts) over channel index * 13 + shape
DEFAULT_BLOCK_CONTEXTS = np.array(
    [0, 1, 2, 2, 3, 3, 4, 5, 6, 6, 6, 6, 6] + [7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14] * 2)

# -- ANS -------------------------------------------------------------------------

SUM_PROBS = 1 << 12


class FlatHistogram:
    """The alias table a decoder builds for a flat distribution over
    `alphabet` symbols at log alphabet size `log_alpha` (Vose's method, as
    the format's reference decoder lays it out)."""

    def __init__(self, alphabet: int, log_alpha: int):
        table = 1 << log_alpha
        base, rem = divmod(SUM_PROBS, alphabet)
        self.dist = [base + (1 if i < rem else 0) for i in range(alphabet)] + [0] * (
            table - alphabet)
        self.log_bucket_size = 12 - log_alpha
        self.bucket_mask = (1 << self.log_bucket_size) - 1
        bucket_size = 1 << self.log_bucket_size
        cutoff = list(self.dist)
        symbol = list(range(table))
        offset = [0] * table
        underfull = [i for i in range(table) if cutoff[i] < bucket_size]
        overfull = [i for i in range(table) if cutoff[i] > bucket_size]
        while overfull and underfull:
            o = overfull.pop()
            u = underfull.pop()
            cutoff[o] -= bucket_size - cutoff[u]
            symbol[u] = o
            offset[u] = cutoff[o]
            if cutoff[o] < bucket_size:
                underfull.append(o)
            elif cutoff[o] > bucket_size:
                overfull.append(o)
        if overfull or underfull:
            raise ValueError("distribution must sum to 4096")
        full = [cutoff[i] == bucket_size for i in range(table)]
        self.alias_symbol = [i if full[i] else symbol[i] for i in range(table)]
        self.alias_cutoff = [bucket_size if full[i] else cutoff[i] for i in range(table)]
        self.alias_offset = [0 if full[i] else offset[i] - cutoff[i] for i in range(table)]


# -- dequantization: the library's parameters -------------------------------------

NUM_QUANT_TABLES = 17
REQUIRED_SIZE_X = (1, 1, 1, 1, 2, 4, 1, 1, 2, 1, 1, 8, 4, 16, 8, 32, 16)
REQUIRED_SIZE_Y = (1, 1, 1, 1, 2, 4, 2, 4, 4, 1, 1, 8, 8, 16, 16, 32, 32)
DCT_BANDS = {
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
BIG = [
    [26629.073922049845, -1.025, -0.78, -0.65012, -0.19041574084286472,
     -0.20819395464, -0.421064, -0.32733845535848671],
    [9311.3238710010046, -0.3041958212306401, -0.3633036457487539,
     -0.35660379990111464, -0.3443074455424403, -0.33699592683512467,
     -0.30180866526242109, -0.27321683125358037],
    [4992.2486445538634, -1.2, -1.2, -0.8, -0.7, -0.7, -0.4, -0.5],
]
IDENTITY_W = [[280.0, 3160.0, 3160.0], [60.0, 864.0, 864.0], [18.0, 200.0, 200.0]]
DCT2_W = [
    [3840.0, 2560.0, 1280.0, 640.0, 480.0, 300.0],
    [960.0, 640.0, 320.0, 180.0, 140.0, 120.0],
    [640.0, 320.0, 128.0, 64.0, 32.0, 16.0],
]
AFV_W = [
    [3072.0, 3072.0, 256.0, 256.0, 256.0, 414.0, 0.0, 0.0, 0.0],
    [1024.0, 1024.0, 50.0, 50.0, 50.0, 58.0, 0.0, 0.0, 0.0],
    [384.0, 384.0, 12.0, 12.0, 12.0, 22.0, -0.25, -0.25, -0.25],
]


def scaled_bands(base, f):
    return [[row[0] * f] + row[1:] for row in base]


def library_dct_bands(kind: int):
    """The library's distance bands of DCT table kind `kind` (those the
    writers code in mode 6)."""
    return {0: DCT_BANDS["dct"], 4: DCT_BANDS["dct16x16"], 5: DCT_BANDS["dct32x32"],
            6: DCT_BANDS["dct8x16"], 11: scaled_bands(BIG, 0.9)}[kind]
