"""rANS entropy decoding: 12-bit alias-table rANS.

Capability reference: jxl/src/entropy_coding/ans.rs. Independent
implementation from the JPEG XL spec (ISO/IEC 18181-1 C.2): distributions
sum to 4096; four distribution encodings (two-symbol / single / evenly
distributed / complex with RLE and a static prefix code); Vose alias
method for O(1) symbol lookup; 16-bit renormalization; final state must
equal 0x130000.

Tables are stored as flat parallel lists so they can be packed into int32
device arrays for the Pallas decode kernel unchanged (see ops/ans_kernel).
"""

from __future__ import annotations

from ..errors import AlphabetTooLarge, InvalidAnsHistogram, InvalidBitstream
from ..io.bit_reader import BitReader

LOG_SUM_PROBS = 12
SUM_PROBS = 1 << LOG_SUM_PROBS
ANS_CHECKSUM = 0x130000

# Static prefix code for the complex-distribution log-counts
# (spec: kLogCountLut). symbol -> (code bits LSB-first, length).
_LOG_COUNT_CODES = {
    0: (0b10001, 5),
    1: (0b1011, 4),
    2: (0b1111, 4),
    3: (0b0011, 4),
    4: (0b1001, 4),
    5: (0b0111, 4),
    6: (0b100, 3),
    7: (0b010, 3),
    8: (0b101, 3),
    9: (0b110, 3),
    10: (0b000, 3),
    11: (0b100001, 6),
    12: (0b0000001, 7),
    13: (0b1000001, 7),
}

_RLE_MARKER = 13  # symbol meaning "repeat previous count"


def _build_log_count_lut():
    lut = [(0, 0)] * 128
    for sym, (code, length) in _LOG_COUNT_CODES.items():
        for high in range(1 << (7 - length)):
            lut[(high << length) | code] = (sym, length)
    return lut


_LOG_COUNT_LUT = _build_log_count_lut()


def read_u8(br: BitReader) -> int:
    """varint-ish u8: 0, or 2^n + n extra bits (n = u(3))."""
    if br.read(1) == 0:
        return 0
    n = br.read(3)
    return (1 << n) + br.read(n)


def _read_log_count(br: BitReader) -> int:
    sym, length = _LOG_COUNT_LUT[br.peek(7)]
    br.consume(length)
    return sym


def decode_distribution(br: BitReader, table_size: int) -> list[int]:
    """Decode one probability distribution summing to SUM_PROBS.

    Returns `dist` of length table_size (1 << log_alpha_size).
    """
    dist = [0] * table_size

    if br.read(1) != 0:
        if br.read(1) != 0:
            # two symbols with explicit probability split
            v0 = read_u8(br)
            v1 = read_u8(br)
            if v0 == v1 or max(v0, v1) >= table_size:
                raise InvalidAnsHistogram("invalid two-symbol ANS distribution")
            prob = br.read(LOG_SUM_PROBS)
            dist[v0] = prob
            dist[v1] = SUM_PROBS - prob
        else:
            # single symbol, probability 1
            val = read_u8(br)
            if val >= table_size:
                raise InvalidAnsHistogram("invalid single-symbol ANS distribution")
            dist[val] = SUM_PROBS
    elif br.read(1) != 0:
        # evenly distributed over alphabet
        alphabet_size = read_u8(br) + 1
        if alphabet_size > table_size:
            raise AlphabetTooLarge("ANS alphabet too large")
        base, rem = divmod(SUM_PROBS, alphabet_size)
        for i in range(alphabet_size):
            dist[i] = base + (1 if i < rem else 0)
    else:
        _decode_complex_distribution(br, dist, table_size)
    return dist


def _decode_complex_distribution(br: BitReader, dist: list[int], table_size: int):
    # unary-coded length (0..3) then shift
    length = 0
    while length < 3 and br.read(1) != 0:
        length += 1
    shift = br.read(length) + (1 << length) - 1
    if shift > 13:
        raise InvalidAnsHistogram("ANS shift too large")
    alphabet_size = read_u8(br) + 3
    if alphabet_size > table_size:
        raise AlphabetTooLarge("ANS alphabet too large")

    # First pass: read log-counts; RLE marker repeats the previous count.
    logcounts = [0] * alphabet_size
    same_as_prev = [False] * alphabet_size
    omit_pos = -1
    omit_log = -1
    idx = 0
    while idx < alphabet_size:
        sym = _read_log_count(br)
        if sym == _RLE_MARKER:
            repeat = read_u8(br) + 4
            if idx + repeat > alphabet_size:
                raise InvalidAnsHistogram("ANS RLE overruns alphabet")
            for i in range(idx, idx + repeat):
                same_as_prev[i] = True
            idx += repeat
            continue
        logcounts[idx] = sym
        if sym > omit_log:
            omit_log = sym
            omit_pos = idx
        idx += 1
    if omit_pos < 0 or (omit_pos + 1 < alphabet_size and same_as_prev[omit_pos + 1]):
        raise InvalidAnsHistogram("invalid ANS omit position")

    # Second pass: expand log-counts to counts (with `shift` precision bits).
    acc = 0
    prev = 0
    for i in range(alphabet_size):
        if same_as_prev[i]:
            dist[i] = prev
            acc += prev
            if acc >= SUM_PROBS:
                raise InvalidAnsHistogram("ANS distribution overflow")
            continue
        code = logcounts[i]
        if code == 0:
            prev = 0
            continue
        if i == omit_pos:
            prev = 0
            continue
        if code > 1:
            zeros = code - 1
            bitcount = shift - ((LOG_SUM_PROBS - zeros) >> 1)
            bitcount = max(0, min(bitcount, zeros))
            code = (1 << zeros) + (br.read(bitcount) << (zeros - bitcount))
        dist[i] = code
        prev = code
        acc += code
        if acc >= SUM_PROBS:
            raise InvalidAnsHistogram("ANS distribution overflow")
    dist[omit_pos] = SUM_PROBS - acc


class AnsHistogram:
    """One decoded histogram with its alias table.

    Parallel arrays of length `n_buckets = SUM_PROBS >> log_bucket_size`:
      dist[i]        - probability of symbol i (0 beyond alphabet)
      alias_symbol/ alias_offset/ alias_cutoff/ alias_dist - alias mapping
    """

    __slots__ = (
        "dist",
        "alias_symbol",
        "alias_offset",
        "alias_cutoff",
        "alias_dist",
        "log_bucket_size",
        "bucket_mask",
        "single_symbol",
    )

    @staticmethod
    def decode(br: BitReader, log_alpha_size: int) -> "AnsHistogram":
        assert 5 <= log_alpha_size <= 8
        table_size = 1 << log_alpha_size
        log_bucket_size = LOG_SUM_PROBS - log_alpha_size
        bucket_size = 1 << log_bucket_size

        dist = decode_distribution(br, table_size)

        h = AnsHistogram.__new__(AnsHistogram)
        h.log_bucket_size = log_bucket_size
        h.bucket_mask = bucket_size - 1
        h.dist = dist

        single = next((i for i, d in enumerate(dist) if d == SUM_PROBS), None)
        h.single_symbol = single
        if single is not None:
            # Degenerate: every state maps to `single`, state is unchanged.
            n = table_size
            h.alias_symbol = [single] * n
            h.alias_cutoff = [0] * n
            h.alias_offset = [bucket_size * i for i in range(n)]
            h.alias_dist = [SUM_PROBS] * n
            return h

        h._build_alias_map(table_size, bucket_size)
        return h

    def _build_alias_map(self, table_size: int, bucket_size: int):
        """Vose alias method: symbol i's first `cutoff_i` slots stay in its
        home bucket; surplus slots are donated to underfull buckets."""
        dist = self.dist
        cutoff = list(dist)
        symbol = list(range(table_size))
        offset = [0] * table_size

        underfull = [i for i in range(table_size) if cutoff[i] < bucket_size]
        overfull = [i for i in range(table_size) if cutoff[i] > bucket_size]
        while overfull and underfull:
            o = overfull.pop()
            u = underfull.pop()
            by = bucket_size - cutoff[u]
            cutoff[o] -= by
            symbol[u] = o
            offset[u] = cutoff[o]
            if cutoff[o] < bucket_size:
                underfull.append(o)
            elif cutoff[o] > bucket_size:
                overfull.append(o)
        assert not overfull and not underfull, "distribution must sum to 4096"

        self.alias_symbol = [0] * table_size
        self.alias_cutoff = [0] * table_size
        self.alias_offset = [0] * table_size
        self.alias_dist = [0] * table_size
        for i in range(table_size):
            if cutoff[i] == bucket_size:
                # bucket fully owned by its home symbol
                self.alias_symbol[i] = i
                self.alias_cutoff[i] = bucket_size  # pos never >= bucket_size
                self.alias_offset[i] = 0
                self.alias_dist[i] = dist[i]
            else:
                self.alias_symbol[i] = symbol[i]
                self.alias_cutoff[i] = cutoff[i]
                self.alias_offset[i] = offset[i] - cutoff[i]
                self.alias_dist[i] = dist[symbol[i]]

    def read(self, br: BitReader, state: int) -> tuple[int, int]:
        """Decode one symbol; returns (symbol, new_state)."""
        idx = state & 0xFFF
        i = idx >> self.log_bucket_size
        pos = idx & self.bucket_mask
        if pos >= self.alias_cutoff[i]:
            sym = self.alias_symbol[i]
            off = self.alias_offset[i] + pos
            d = self.alias_dist[i]
        else:
            sym = i
            off = pos
            d = self.dist[i]
        state = (state >> LOG_SUM_PROBS) * d + off
        if state < (1 << 16):
            state = (state << 16) | br.read_opt(16)
        return sym, state


class AnsCodes:
    __slots__ = ("histograms",)

    @staticmethod
    def decode(num: int, log_alpha_size: int, br: BitReader) -> "AnsCodes":
        c = AnsCodes.__new__(AnsCodes)
        c.histograms = [AnsHistogram.decode(br, log_alpha_size) for _ in range(num)]
        return c

    def single_symbol(self, ctx: int):
        return self.histograms[ctx].single_symbol


class NativeAnsCodes:
    """AnsCodes over tables decoded by the native library: one contiguous
    (C, 5, table_size) int32 array (dist, alias_symbol/offset/cutoff/dist
    rows — the exact wire layout of pack_entropy and the device kernels)."""

    __slots__ = ("tables", "singles", "log_bucket_size", "_hists")

    def __init__(self, tables, singles, log_bucket_size: int):
        self.tables = tables
        self.singles = singles
        self.log_bucket_size = log_bucket_size
        self._hists = None

    @property
    def histograms(self):
        if self._hists is None:
            self._hists = [
                _NativeHistView(self.tables[c], int(self.singles[c]), self.log_bucket_size)
                for c in range(self.tables.shape[0])
            ]
        return self._hists

    def single_symbol(self, ctx: int):
        s = int(self.singles[ctx])
        return None if s < 0 else s


class _NativeHistView:
    """Per-cluster view with AnsHistogram's attribute surface."""

    __slots__ = ("dist", "alias_symbol", "alias_offset", "alias_cutoff",
                 "alias_dist", "single_symbol", "log_bucket_size", "bucket_mask")

    def __init__(self, rows, single: int, log_bucket_size: int):
        self.dist = rows[0]
        self.alias_symbol = rows[1]
        self.alias_offset = rows[2]
        self.alias_cutoff = rows[3]
        self.alias_dist = rows[4]
        self.single_symbol = None if single < 0 else single
        self.log_bucket_size = log_bucket_size
        self.bucket_mask = (1 << log_bucket_size) - 1

    def read(self, br: BitReader, state: int) -> tuple[int, int]:
        idx = state & 0xFFF
        i = idx >> self.log_bucket_size
        pos = idx & self.bucket_mask
        if pos >= self.alias_cutoff[i]:
            sym = int(self.alias_symbol[i])
            off = int(self.alias_offset[i]) + pos
            d = int(self.alias_dist[i])
        else:
            sym = i
            off = pos
            d = int(self.dist[i])
        state = (state >> LOG_SUM_PROBS) * d + off
        if state < (1 << 16):
            state = (state << 16) | br.read_opt(16)
        return sym, state
