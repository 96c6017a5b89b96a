"""Histogram bundles and the symbol reader (with LZ77).

Capability reference: jxl/src/entropy_coding/decode.rs and context_map.rs.
A `Histograms` bundle holds: optional LZ77 params, a context map (possibly
itself entropy coded with move-to-front), per-cluster hybrid-uint configs,
and ANS or prefix codes. `SymbolReader` carries the mutable decode state
(ANS state, LZ77 ring window) and supports checkpoint/restore for
progressive partial-decode rollback.
"""

from __future__ import annotations

from ..errors import InvalidBitstream, InvalidContextMap, Lz77Disallowed
from ..io.bit_reader import BitReader
from ..io.bundle import U32, Bits, BitsOffset, Val
from .ans import ANS_CHECKSUM, AnsCodes
from .huffman import HUFFMAN_MAX_BITS, HuffmanCodes
from .hybrid_uint import HybridUint

# 2-D LZ77 special distances: (offset, dist) pairs for the 120 smallest
# neighborhoods, scaled by image width (spec Table C.1).
_SPECIAL_DISTANCES = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1),
    (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3),
    (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3),
    (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4),
    (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1),
    (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6),
    (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7),
    (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7), (7, 4),
    (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5),
    (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
]

_LOG_WINDOW_SIZE = 20
_WINDOW_MASK = (1 << _LOG_WINDOW_SIZE) - 1

_LZ77_MIN_SYMBOL = U32(Val(224), Val(512), Val(4096), BitsOffset(15, 8))
_LZ77_MIN_LENGTH = U32(Val(3), Val(4), BitsOffset(2, 5), BitsOffset(8, 9))


def _move_to_front_inverse(values: list[int]) -> list[int]:
    mtf = list(range(256))
    out = []
    for index in values:
        v = mtf[index]
        out.append(v)
        if index:
            del mtf[index]
            mtf.insert(0, v)
    return out


def decode_context_map(num_contexts: int, br: BitReader) -> list[int]:
    """ref: entropy_coding/context_map.rs:43-76."""
    if br.read(1) != 0:  # simple
        bits_per_entry = br.read(2)
        if bits_per_entry:
            return [br.read(bits_per_entry) for _ in range(num_contexts)]
        return [0] * num_contexts
    use_mtf = br.read(1) != 0
    histograms = Histograms.decode(1, br, allow_lz77=num_contexts > 2)
    from .. import native

    vals = native.read_unsigned_run(histograms, br, 0, num_contexts, check_final=True)
    if vals is not None:
        if vals.max(initial=0) > 255:
            raise InvalidContextMap("context map value too large")
        ctx_map = [int(v) for v in vals]
    else:
        reader = SymbolReader(histograms, br)
        ctx_map = []
        for _ in range(num_contexts):
            mv = reader.read_unsigned(histograms, br, 0)
            if mv > 255:
                raise InvalidContextMap(f"context map value {mv} too large")
            ctx_map.append(mv)
        reader.check_final_state(histograms, br)
    if use_mtf:
        ctx_map = _move_to_front_inverse(ctx_map)
    num_histograms = max(ctx_map) + 1
    if len(set(ctx_map)) != num_histograms:
        raise InvalidContextMap("context map has holes")
    return ctx_map


class Histograms:
    __slots__ = (
        "lz77_enabled",
        "lz77_min_symbol",
        "lz77_min_length",
        "lz77_length_uint",
        "context_map",
        "lz_dist_cluster",
        "log_alpha_size",
        "uint_configs",
        "codes",
        "use_prefix_code",
        "_native_packed",  # memoized native-decoder table pack
    )

    @staticmethod
    def decode(num_contexts: int, br: BitReader, allow_lz77: bool) -> "Histograms":
        from .. import native

        if native.available():
            h = native.decode_histograms_native(br, num_contexts, allow_lz77)
            if h is not None:
                return h
        return Histograms._decode_py(num_contexts, br, allow_lz77)

    @staticmethod
    def _decode_py(num_contexts: int, br: BitReader, allow_lz77: bool) -> "Histograms":
        h = Histograms.__new__(Histograms)
        h.lz77_enabled = br.read(1) != 0
        if h.lz77_enabled:
            if not allow_lz77:
                raise Lz77Disallowed("LZ77 not allowed in this stream")
            h.lz77_min_symbol = _LZ77_MIN_SYMBOL.read(br)
            h.lz77_min_length = _LZ77_MIN_LENGTH.read(br)
            h.lz77_length_uint = HybridUint.decode(8, br)
            num_contexts += 1
        else:
            h.lz77_min_symbol = h.lz77_min_length = 0
            h.lz77_length_uint = None

        if num_contexts > 1:
            h.context_map = decode_context_map(num_contexts, br)
        else:
            h.context_map = [0]
        assert len(h.context_map) == num_contexts
        # captured before any later resize() pads the map with zeros
        h.lz_dist_cluster = h.context_map[-1] if h.lz77_enabled else 0

        h.use_prefix_code = br.read(1) != 0
        if h.use_prefix_code:
            h.log_alpha_size = HUFFMAN_MAX_BITS
        else:
            h.log_alpha_size = br.read(2) + 5
        num_histograms = max(h.context_map) + 1
        h.uint_configs = [
            HybridUint.decode(h.log_alpha_size, br) for _ in range(num_histograms)
        ]
        if h.use_prefix_code:
            h.codes = HuffmanCodes.decode(num_histograms, br)
        else:
            h.codes = AnsCodes.decode(num_histograms, h.log_alpha_size, br)
        return h

    def map_context_to_cluster(self, context: int) -> int:
        return self.context_map[context]

    @property
    def num_histograms(self) -> int:
        return max(self.context_map) + 1

    def resize(self, num_contexts: int) -> None:
        if num_contexts < len(self.context_map):
            self.context_map = self.context_map[:num_contexts]
        else:
            self.context_map = self.context_map + [0] * (
                num_contexts - len(self.context_map)
            )

    def single_symbol(self, ctx: int):
        return self.codes.single_symbol(ctx)

    @property
    def is_rle(self) -> bool:
        """Fast-lossless backbone: LZ77 distances always 1 and lengths direct."""
        lz = self.lz_dist_cluster
        return (
            self.codes.single_symbol(lz) == 1
            and self.uint_configs[lz].is_split_exponent_zero
        )

    def can_use_config_420_fast_path(self) -> bool:
        return not self.lz77_enabled and all(
            c.is_config_420 for c in self.uint_configs
        )


class SymbolReader:
    """Mutable decode state: ANS state + optional LZ77 ring window."""

    __slots__ = (
        "ans_state",
        "is_ans",
        "window",
        "num_to_copy",
        "copy_pos",
        "num_decoded",
        "min_symbol",
        "min_length",
        "dist_multiplier",
        "lz77",
        "error",
    )

    def __init__(self, histograms: Histograms, br: BitReader, image_width: int | None = None):
        self.is_ans = not histograms.use_prefix_code
        self.ans_state = br.read(32) if self.is_ans else ANS_CHECKSUM
        self.lz77 = histograms.lz77_enabled
        self.error = None
        if self.lz77:
            self.min_symbol = histograms.lz77_min_symbol
            self.min_length = histograms.lz77_min_length
            self.dist_multiplier = image_width or 0
            self.window = [0] * 0
            self.num_to_copy = 0
            self.copy_pos = 0
            self.num_decoded = 0

    # -- core symbol read ------------------------------------------------

    def _read_token(self, histograms: Histograms, br: BitReader, cluster: int) -> int:
        if self.is_ans:
            sym, self.ans_state = histograms.codes.histograms[cluster].read(
                br, self.ans_state
            )
            return sym
        return histograms.codes.read(br, cluster)

    def _push(self, token: int) -> None:
        off = self.num_decoded & _WINDOW_MASK
        if off < len(self.window):
            self.window[off] = token
        else:
            self.window.append(token)
        self.num_decoded += 1

    def read_unsigned_clustered(
        self, histograms: Histograms, br: BitReader, cluster: int
    ) -> int:
        if not self.lz77:
            token = self._read_token(histograms, br, cluster)
            return histograms.uint_configs[cluster].read(token, br)

        if self.num_to_copy > 0:
            sym = self.window[self.copy_pos & _WINDOW_MASK]
            self.copy_pos += 1
            self.num_to_copy -= 1
            self._push(sym)
            return sym
        token = self._read_token(histograms, br, cluster)
        if token < self.min_symbol:
            sym = histograms.uint_configs[cluster].read(token, br)
            self._push(sym)
            return sym
        if self.num_decoded == 0:
            self.error = "LZ77 repeat at stream start"
            return 0
        num_to_copy = (
            histograms.lz77_length_uint.read(token - self.min_symbol, br)
            + self.min_length
        )
        if num_to_copy >= (1 << 32):
            self.error = "LZ77 length overflow"
            return 0
        lz = histograms.lz_dist_cluster
        dist_token = self._read_token(histograms, br, lz)
        distance_sym = histograms.uint_configs[lz].read(dist_token, br)

        if self.dist_multiplier == 0:
            distance_sub_1 = distance_sym
        elif distance_sym >= 120:
            distance_sub_1 = distance_sym - 120
        else:
            offset, dist = _SPECIAL_DISTANCES[distance_sym]
            d = self.dist_multiplier * dist + offset - 1
            distance_sub_1 = d if d >= 0 else 0
        distance = min(min(distance_sub_1, (1 << 20) - 1) + 1, self.num_decoded)
        self.copy_pos = self.num_decoded - distance
        self.num_to_copy = num_to_copy

        sym = self.window[self.copy_pos & _WINDOW_MASK]
        self.copy_pos += 1
        self.num_to_copy -= 1
        self._push(sym)
        return sym

    def read_unsigned(self, histograms: Histograms, br: BitReader, context: int) -> int:
        return self.read_unsigned_clustered(
            histograms, br, histograms.context_map[context]
        )

    def read_signed(self, histograms: Histograms, br: BitReader, context: int) -> int:
        u = self.read_unsigned(histograms, br, context)
        return -((u + 1) >> 1) if (u & 1) else (u >> 1)

    # -- validation / checkpointing -----------------------------------------

    def check_final_state(self, histograms: Histograms, br: BitReader) -> None:
        if self.error is not None:
            raise InvalidBitstream(self.error)
        br.check_no_overrun()
        if self.is_ans and self.ans_state != ANS_CHECKSUM:
            raise InvalidBitstream(
                f"ANS checksum mismatch: 0x{self.ans_state:x} != 0x{ANS_CHECKSUM:x}"
            )

    def checkpoint(self, max_rollback: int) -> dict:
        """Snapshot enough state to rewind up to `max_rollback` symbols
        (ref: entropy_coding/decode.rs:409-483; used by progressive flush)."""
        state = {"ans_state": self.ans_state, "error": self.error}
        if self.lz77:
            start = self.num_decoded & _WINDOW_MASK
            tail = []
            for k in range(max_rollback):
                p = (start + k) & _WINDOW_MASK
                tail.append(self.window[p] if p < len(self.window) else 0)
            state.update(
                num_to_copy=self.num_to_copy,
                copy_pos=self.copy_pos,
                num_decoded=self.num_decoded,
                window_tail=tail,
            )
        return state

    def restore(self, state: dict) -> None:
        self.ans_state = state["ans_state"]
        self.error = state["error"]
        if self.lz77 and "num_decoded" in state:
            num_decoded = state["num_decoded"]
            rewind = self.num_decoded - num_decoded
            tail = state["window_tail"]
            for k in range(rewind):
                p = (num_decoded + k) & _WINDOW_MASK
                if p < len(self.window):
                    self.window[p] = tail[k]
            self.num_to_copy = state["num_to_copy"]
            self.copy_pos = state["copy_pos"]
            self.num_decoded = num_decoded
