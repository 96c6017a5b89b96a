"""VarDCT transform types and block-geometry LUTs.

Capability reference: jxl_transforms/src/transform_map.rs. Naming: DCTAxB
covers A pixel rows x B pixel columns (A = cy*8, B = cx*8).
"""

from __future__ import annotations

import enum


class HfTransformType(enum.IntEnum):
    DCT = 0
    IDENTITY = 1
    DCT2X2 = 2
    DCT4X4 = 3
    DCT16X16 = 4
    DCT32X32 = 5
    DCT16X8 = 6
    DCT8X16 = 7
    DCT32X8 = 8
    DCT8X32 = 9
    DCT32X16 = 10
    DCT16X32 = 11
    DCT4X8 = 12
    DCT8X4 = 13
    AFV0 = 14
    AFV1 = 15
    AFV2 = 16
    AFV3 = 17
    DCT64X64 = 18
    DCT64X32 = 19
    DCT32X64 = 20
    DCT128X128 = 21
    DCT128X64 = 22
    DCT64X128 = 23
    DCT256X256 = 24
    DCT256X128 = 25
    DCT128X256 = 26


NUM_TRANSFORM_TYPES = 27
INVALID_TRANSFORM = 27

# blocks covered horizontally / vertically, and shape id (order family)
_CBX = [1, 1, 1, 1, 2, 4, 1, 2, 1, 4, 2, 4, 1, 1, 1, 1, 1, 1, 8, 4, 8, 16, 8, 16, 32, 16, 32]
_CBY = [1, 1, 1, 1, 2, 4, 2, 1, 4, 1, 4, 2, 1, 1, 1, 1, 1, 1, 8, 8, 4, 16, 16, 8, 32, 32, 16]
_SHAPE_ID = [0, 1, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 1, 1, 1, 1, 1, 1, 7, 8, 8, 9, 10, 10, 11, 12, 12]


def covered_blocks_x(t: int) -> int:
    return _CBX[t]


def covered_blocks_y(t: int) -> int:
    return _CBY[t]


def block_shape_id(t: int) -> int:
    return _SHAPE_ID[t]
