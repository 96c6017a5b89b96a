"""Modular-mode stream headers: weighted-predictor params, transforms.

Capability reference: jxl/src/headers/modular.rs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dfield

from ...errors import InvalidBitstream, InvalidPredictor, InvalidRCT, InvalidVarDCTTransform
from ..bit_reader import BitReader
from ..bundle import Bits, BitsOffset, U32, Val


class TransformId(enum.IntEnum):
    RCT = 0
    PALETTE = 1
    SQUEEZE = 2


NUM_PREDICTORS = 16  # modular predictors 0..15 (see modular/predict.py)


@dataclass
class WeightedHeader:
    p1c: int = 16
    p2c: int = 10
    p3ca: int = 7
    p3cb: int = 7
    p3cc: int = 7
    p3cd: int = 0
    p3ce: int = 0
    w0: int = 0xD
    w1: int = 0xC
    w2: int = 0xC
    w3: int = 0xC

    @staticmethod
    def read(br: BitReader) -> "WeightedHeader":
        w = WeightedHeader()
        if br.read(1) != 0:  # all_default
            return w
        w.p1c = br.read(5)
        w.p2c = br.read(5)
        w.p3ca = br.read(5)
        w.p3cb = br.read(5)
        w.p3cc = br.read(5)
        w.p3cd = br.read(5)
        w.p3ce = br.read(5)
        w.w0 = br.read(4)
        w.w1 = br.read(4)
        w.w2 = br.read(4)
        w.w3 = br.read(4)
        return w


@dataclass
class SqueezeParams:
    horizontal: bool
    in_place: bool
    begin_channel: int
    num_channels: int

    @staticmethod
    def read(br: BitReader) -> "SqueezeParams":
        horizontal = br.read(1) != 0
        in_place = br.read(1) != 0
        begin = U32(Bits(3), BitsOffset(6, 8), BitsOffset(10, 72), BitsOffset(13, 1096)).read(br)
        num = U32(Val(1), Val(2), Val(3), BitsOffset(4, 4)).read(br)
        return SqueezeParams(horizontal, in_place, begin, num)


@dataclass
class Transform:
    id: TransformId
    begin_channel: int = 0
    rct_type: int = 6
    num_channels: int = 3
    num_colors: int = 256
    num_deltas: int = 0
    predictor_id: int = 0
    squeezes: list = dfield(default_factory=list)

    @staticmethod
    def read(br: BitReader) -> "Transform":
        tid = br.read(2)
        if tid == 3:
            raise InvalidVarDCTTransform("invalid transform id")
        t = Transform(TransformId(tid))
        begin_coder = U32(Bits(3), BitsOffset(6, 8), BitsOffset(10, 72), BitsOffset(13, 1096))
        if t.id in (TransformId.RCT, TransformId.PALETTE):
            t.begin_channel = begin_coder.read(br)
        if t.id == TransformId.RCT:
            t.rct_type = U32(Val(6), Bits(2), BitsOffset(4, 2), BitsOffset(6, 10)).read(br)
            if t.rct_type >= 42:
                raise InvalidRCT(f"invalid RCT type {t.rct_type}")
        if t.id == TransformId.PALETTE:
            t.num_channels = U32(Val(1), Val(3), Val(4), BitsOffset(13, 1)).read(br)
            t.num_colors = U32(Bits(8), BitsOffset(10, 256), BitsOffset(12, 1280), BitsOffset(16, 5376)).read(br)
            t.num_deltas = U32(Val(0), BitsOffset(8, 1), BitsOffset(10, 257), BitsOffset(16, 1281)).read(br)
            t.predictor_id = br.read(4)
            if t.predictor_id >= NUM_PREDICTORS:
                raise InvalidPredictor(f"invalid predictor {t.predictor_id}")
        if t.id == TransformId.SQUEEZE:
            n = U32(Val(0), BitsOffset(4, 1), BitsOffset(6, 9), BitsOffset(8, 41)).read(br)
            t.squeezes = [SqueezeParams.read(br) for _ in range(n)]
        return t


@dataclass
class GroupHeader:
    use_global_tree: bool
    wp_header: WeightedHeader
    transforms: list

    @staticmethod
    def read(br: BitReader) -> "GroupHeader":
        use_global_tree = br.read(1) != 0
        wp = WeightedHeader.read(br)
        n = U32(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(8, 18)).read(br)
        transforms = [Transform.read(br) for _ in range(n)]
        return GroupHeader(use_global_tree, wp, transforms)
