"""Chroma-from-luma color correlation parameters.

Capability reference: jxl/src/frame/color_correlation_map.rs.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import BaseColorCorrelationOutOfRange, InvalidBitstream
from ..io.bit_reader import BitReader
from ..io.bundle import F16

COLOR_TILE_DIM = 64
COLOR_TILE_DIM_IN_BLOCKS = 8
DEFAULT_COLOR_FACTOR = 84


@dataclass
class ColorCorrelationParams:
    color_factor: int = DEFAULT_COLOR_FACTOR
    base_correlation_x: float = 0.0
    base_correlation_b: float = 1.0
    ytox_lf: int = 0
    ytob_lf: int = 0

    @staticmethod
    def read(br: BitReader) -> "ColorCorrelationParams":
        if br.read(1) == 1:
            return ColorCorrelationParams()
        sel = br.read(2)
        if sel == 0:
            color_factor = DEFAULT_COLOR_FACTOR
        elif sel == 1:
            color_factor = 256
        elif sel == 2:
            color_factor = br.read(8) + 2
        else:
            color_factor = br.read(16) + 258
        f16 = F16()
        bx = f16.read(br)
        bb = f16.read(br)
        if bx > 4.0 or bb > 4.0:
            raise BaseColorCorrelationOutOfRange("base color correlation out of range")
        ytox_lf = br.read(8) - 128
        ytob_lf = br.read(8) - 128
        return ColorCorrelationParams(color_factor, bx, bb, ytox_lf, ytob_lf)

    def y_to_x(self, factor: int) -> float:
        return self.base_correlation_x + factor / self.color_factor

    def y_to_b(self, factor: int) -> float:
        return self.base_correlation_b + factor / self.color_factor

    @property
    def y_to_x_lf(self) -> float:
        return self.y_to_x(self.ytox_lf)

    @property
    def y_to_b_lf(self) -> float:
        return self.y_to_b(self.ytob_lf)
