"""Block context map for AC coefficient entropy contexts.

Capability reference: jxl/src/frame/block_context_map.rs.
"""

from __future__ import annotations

from ..errors import InvalidBitstream, InvalidContextMap, TooManyBlockContexts
from ..io.bit_reader import BitReader
from ..io.bundle import unpack_signed

NUM_ORDERS = 13
NON_ZERO_BUCKETS = 37
ZERO_DENSITY_CONTEXT_COUNT = 458
ZERO_DENSITY_CONTEXT_LIMIT = 474

COEFF_FREQ_CONTEXT = [
    0xBAD, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 15, 16, 16,
    17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22, 23, 23, 23, 23, 24, 24,
    24, 24, 25, 25, 25, 25, 26, 26, 26, 26, 27, 27, 27, 27, 28, 28, 28, 28,
    29, 29, 29, 29, 30, 30, 30, 30,
]

COEFF_NUM_NONZERO_CONTEXT = [
    0xBAD, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123, 152, 152, 152,
    152, 152, 152, 152, 152, 180, 180, 180, 180, 180, 180, 180, 180, 180, 180,
    180, 180, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206,
]


def _shrc(v: int, s: int) -> int:
    return -(-v >> s) if False else (v + (1 << s) - 1) >> s


def zero_density_context(nonzeros_left: int, k: int, log_num_blocks: int, prev: int) -> int:
    nz = (nonzeros_left + (1 << log_num_blocks) - 1) >> log_num_blocks
    kn = k >> log_num_blocks
    return (COEFF_NUM_NONZERO_CONTEXT[nz & 63] + COEFF_FREQ_CONTEXT[kn & 63]) * 2 + prev


class BlockContextMap:
    def __init__(self, lf_thresholds, qf_thresholds, context_map, num_lf_contexts, num_contexts):
        self.lf_thresholds = lf_thresholds
        self.qf_thresholds = qf_thresholds
        self.context_map = context_map
        self.num_lf_contexts = num_lf_contexts
        self.num_contexts = num_contexts

    @property
    def num_ac_contexts(self) -> int:
        return self.num_contexts * (NON_ZERO_BUCKETS + ZERO_DENSITY_CONTEXT_COUNT)

    @staticmethod
    def default() -> "BlockContextMap":
        return BlockContextMap(
            [[], [], []],
            [],
            [0, 1, 2, 2, 3, 3, 4, 5, 6, 6, 6, 6, 6]
            + [7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14] * 2,
            1,
            15,
        )

    @staticmethod
    def read(br: BitReader) -> "BlockContextMap":
        if br.read(1) == 1:
            return BlockContextMap.default()
        num_lf_contexts = 1
        lf_thresholds = []
        for _ in range(3):
            n = br.read(4)
            vals = []
            for _ in range(n):
                sel = br.read(2)
                if sel == 0:
                    u = br.read(4)
                elif sel == 1:
                    u = br.read(8) + 16
                elif sel == 2:
                    u = br.read(16) + 272
                else:
                    u = br.read(32) + 65808
                vals.append(unpack_signed(u))
            lf_thresholds.append(vals)
            num_lf_contexts *= n + 1
        nq = br.read(4)
        qf_thresholds = []
        for _ in range(nq):
            sel = br.read(2)
            if sel == 0:
                v = br.read(2)
            elif sel == 1:
                v = br.read(3) + 4
            elif sel == 2:
                v = br.read(5) + 12
            else:
                v = br.read(8) + 44
            qf_thresholds.append(v + 1)
        if num_lf_contexts * (nq + 1) > 64:
            raise InvalidContextMap("block context map too large")
        from ..entropy.reader import decode_context_map

        size = 3 * NUM_ORDERS * num_lf_contexts * (nq + 1)
        context_map = decode_context_map(size, br)
        num_contexts = max(context_map) + 1
        if num_contexts > 16:
            raise TooManyBlockContexts("too many block contexts")
        return BlockContextMap(
            lf_thresholds, qf_thresholds, context_map, num_lf_contexts, num_contexts
        )

    def block_context(self, lf_idx: int, qf: int, shape_id: int, c: int) -> int:
        qf_idx = sum(1 for t in self.qf_thresholds if qf > t)
        idx = (c ^ 1) if c < 2 else 2
        idx = idx * NUM_ORDERS + shape_id
        idx = idx * (len(self.qf_thresholds) + 1) + qf_idx
        idx = idx * self.num_lf_contexts + lf_idx
        return self.context_map[idx]

    def nonzero_context(self, nonzeros: int, block_context: int) -> int:
        if nonzeros < 8:
            ctx = nonzeros
        elif nonzeros < 64:
            ctx = 4 + nonzeros // 2
        else:
            ctx = 36
        return ctx * self.num_contexts + block_context

    def zero_density_context_offset(self, block_context: int) -> int:
        return self.num_contexts * NON_ZERO_BUCKETS + ZERO_DENSITY_CONTEXT_COUNT * block_context
