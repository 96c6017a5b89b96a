"""Coefficient scan orders: 13 natural zig-zag orders + coded permutations.

Capability reference: jxl/src/frame/coeff_order.rs.
"""

from __future__ import annotations

import functools

from ..entropy import Histograms, SymbolReader
from ..io.bit_reader import BitReader
from ..io.headers.permutation import decode_permutation
from .transform_map import (
    HfTransformType as T,
    covered_blocks_x,
    covered_blocks_y,
)

NUM_ORDERS = 13
NUM_PERMUTATION_CONTEXTS = 8
BLOCK_SIZE = 64

TRANSFORM_TYPE_LUT = [
    T.DCT, T.IDENTITY, T.DCT16X16, T.DCT32X32, T.DCT8X16, T.DCT8X32,
    T.DCT16X32, T.DCT64X64, T.DCT32X64, T.DCT128X128, T.DCT64X128,
    T.DCT256X256, T.DCT128X256,
]


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


@functools.lru_cache(maxsize=None)
def natural_coeff_order(t: int) -> tuple:
    """Zig-zag order for a cx x cy transform (cx >= cy); out[k] = storage idx.

    ref coeff_order.rs:67-121.
    """
    cx = covered_blocks_x(t)
    cy = covered_blocks_y(t)
    assert cx >= cy
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
        ip = xsize - ir
        i = ip - 1
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
    return tuple(out)


@functools.lru_cache(maxsize=None)
def natural_order_array(t: int):
    """Process-cached int32 array view of the natural zig-zag order."""
    import numpy as np

    a = np.array(natural_coeff_order(t), dtype=np.int32)
    a.setflags(write=False)
    return a


class CoeffOrders:
    """Lazy per-(order, channel) scan permutations: only coded
    permutations are materialized; natural orders resolve to the
    process-wide cached arrays (animations decode one of these per
    frame — building all 39 dense orders each time dominated small-frame
    HfGlobal cost)."""

    __slots__ = ("_coded",)

    def __init__(self, coded: dict):
        self._coded = coded

    def __getitem__(self, idx: int):
        v = self._coded.get(idx)
        if v is not None:
            return v
        return natural_order_array(TRANSFORM_TYPE_LUT[idx // 3])


def _coded_orders(used_orders: int) -> list:
    """[(order index, transform type)] of the orders `used_orders` codes."""
    return [(o, t) for o, t in enumerate(TRANSFORM_TYPE_LUT) if (used_orders >> o) & 1]


def decode_coeff_orders(used_orders: int, br: BitReader) -> "CoeffOrders":
    """Per (order, channel) scan permutations (ref coeff_order.rs:123-149;
    jxl_tpu/vardct/coeff_order.py:108): the permutation histograms, then
    every coded permutation's Lehmer code in one native call
    (native.read_permutations_native), each applied to its tail by
    native.apply_lehmer. decode_coeff_orders_plain is the same read in
    Python, symbol by symbol."""
    import numpy as np

    from .. import native

    if used_orders == 0:
        return CoeffOrders({})
    histograms = Histograms.decode(NUM_PERMUTATION_CONTEXTS, br, allow_lz77=True)
    coded = _coded_orders(used_orders)
    blocks = [covered_blocks_x(t) * covered_blocks_y(t) for _, t in coded for _ in range(3)]
    sizes = [nb * BLOCK_SIZE for nb in blocks]
    codes = native.read_permutations_native(histograms, br, sizes, blocks, True)
    coded_perms: dict = {}
    for i, code in enumerate(codes):
        if not len(code):
            continue  # the natural order
        ord_idx, t = coded[i // 3]
        nb = blocks[i]
        tail = native.apply_lehmer(code, sizes[i] - nb)
        order = np.concatenate([np.arange(nb, dtype=np.int32), tail + np.int32(nb)])
        coded_perms[3 * ord_idx + i % 3] = natural_order_array(t)[order]
    return CoeffOrders(coded_perms)


def decode_coeff_orders_plain(used_orders: int, br: BitReader) -> "CoeffOrders":
    """decode_coeff_orders read symbol by symbol in Python
    (io/headers/permutation.py:decode_permutation), the plain version the
    tests hold the native read to."""
    import numpy as np

    if used_orders == 0:
        return CoeffOrders({})
    coded_perms: dict = {}
    histograms = Histograms.decode(NUM_PERMUTATION_CONTEXTS, br, allow_lz77=True)
    reader = SymbolReader(histograms, br)
    for ord_idx, t in _coded_orders(used_orders):
        num_blocks = covered_blocks_x(t) * covered_blocks_y(t)
        size = num_blocks * BLOCK_SIZE
        for c in range(3):
            perm = decode_permutation(size, num_blocks, histograms, br, reader)
            coded_perms[3 * ord_idx + c] = natural_order_array(t)[np.asarray(perm, np.int32)]
    reader.check_final_state(histograms, br)
    return CoeffOrders(coded_perms)
