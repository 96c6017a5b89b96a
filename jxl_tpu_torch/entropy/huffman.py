"""Brotli-style canonical prefix (Huffman) codes.

Capability reference: jxl/src/entropy_coding/huffman.rs. Independent
implementation of the Brotli prefix-code format used by JPEG XL: simple
codes (1-4 symbols), code-length-coded complex codes, and a two-level
lookup table (8-bit root) for O(1) decode. Codes are read LSB-first.
"""

from __future__ import annotations

from ..errors import AlphabetTooLarge, InvalidBitstream, InvalidHuffman
from ..io.bit_reader import BitReader

HUFFMAN_MAX_BITS = 15
TABLE_BITS = 8
TABLE_SIZE = 1 << TABLE_BITS
CODE_LENGTHS_CODE = 18
DEFAULT_CODE_LENGTH = 8
CODE_LENGTH_REPEAT_CODE = 16

# Static 5-max-bit prefix code used to read the code-length code lengths.
# symbol -> (code value LSB-first, length); from the Brotli/JXL spec.
_STATIC_LENGTH_CODES = {
    0: (0b00, 2),
    1: (0b0111, 4),
    2: (0b011, 3),
    3: (0b10, 2),
    4: (0b01, 2),
    5: (0b1111, 4),
}
_CODE_LENGTH_CODE_ORDER = [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _build_static_lut():
    lut = [(0, 0)] * 16
    for sym, (code, length) in _STATIC_LENGTH_CODES.items():
        for high in range(1 << (4 - length)):
            lut[(high << length) | code] = (sym, length)
    return lut


_STATIC_LUT = _build_static_lut()


def decode_varint16(br: BitReader) -> int:
    if br.read(1) != 0:
        nbits = br.read(4)
        if nbits == 0:
            return 1
        return (1 << nbits) + br.read(nbits)
    return 0


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _next_key(key: int, length: int) -> int:
    """Canonical-code successor: increment the bit-reversed key."""
    step = 1 << (length - 1)
    while key & step:
        step >>= 1
    return (key & (step - 1)) + step if step else 0


class Table:
    """Two-level decode table: entries of (nbits, value)."""

    __slots__ = ("bits", "values")

    def __init__(self, bits, values):
        self.bits = bits
        self.values = values

    # -- construction ---------------------------------------------------

    @staticmethod
    def from_code_lengths(root_bits: int, code_lengths: list[int]) -> "Table":
        if len(code_lengths) > (1 << HUFFMAN_MAX_BITS):
            raise AlphabetTooLarge("huffman alphabet too large")
        counts = [0] * (HUFFMAN_MAX_BITS + 1)
        for v in code_lengths:
            counts[v] += 1

        # symbols sorted by (length, symbol)
        offsets = [0] * (HUFFMAN_MAX_BITS + 1)
        max_length = 1
        total = 0
        for length in range(1, HUFFMAN_MAX_BITS + 1):
            offsets[length] = total
            if counts[length]:
                total += counts[length]
                max_length = length
        sorted_syms = [0] * len(code_lengths)
        for sym, length in enumerate(code_lengths):
            if length:
                sorted_syms[offsets[length]] = sym
                offsets[length] += 1

        table_bits = root_bits
        table_size = 1 << table_bits
        bits = [0] * table_size
        values = [0] * table_size

        # degenerate: single used symbol
        if counts[HUFFMAN_MAX_BITS] == 0 and total == 1:
            for i in range(table_size):
                values[i] = sorted_syms[0]
            return Table(bits, values)

        counts = list(counts)
        if table_bits > max_length:
            table_bits = max_length
            table_size = 1 << table_bits

        # root table
        key = 0
        sym_idx = 0
        step = 2
        for length in range(1, table_bits + 1):
            while counts[length]:
                value = sorted_syms[sym_idx]
                sym_idx += 1
                for pos in range(key, table_size, step):
                    bits[pos] = length
                    values[pos] = value
                key = _next_key(key, length)
                counts[length] -= 1
            step <<= 1

        # replicate the (possibly shrunken) root table to full root size
        full_root = 1 << root_bits
        while table_size < full_root:
            bits[table_size : 2 * table_size] = bits[:table_size]
            values[table_size : 2 * table_size] = values[:table_size]
            # list was preallocated at 1<<root_bits; extend slices copy in place
            table_size <<= 1
        table_size = full_root

        # second-level tables
        mask = full_root - 1
        low = -1
        table_pos = 0
        sub_size = 0
        sub_bits = 0
        step = 2
        for length in range(root_bits + 1, max_length + 1):
            while counts[length]:
                if (key & mask) != low:
                    table_pos += sub_size if sub_size else full_root
                    # size of this sub-table: enough for remaining lengths
                    sub_bits = Table._next_table_bits(counts, length, root_bits)
                    sub_size = 1 << sub_bits
                    low = key & mask
                    bits[low] = sub_bits + root_bits
                    values[low] = table_pos - low
                    need = table_pos + sub_size
                    if len(bits) < need:
                        bits.extend([0] * (need - len(bits)))
                        values.extend([0] * (need - len(values)))
                counts[length] -= 1
                nb = length - root_bits
                value = sorted_syms[sym_idx]
                sym_idx += 1
                start = table_pos + (key >> root_bits)
                for pos in range(start, table_pos + sub_size, step):
                    bits[pos] = nb
                    values[pos] = value
                key = _next_key(key, length)
            step <<= 1
        return Table(bits, values)

    @staticmethod
    def _next_table_bits(counts, length: int, root_bits: int) -> int:
        left = 1 << (length - root_bits)
        while length < HUFFMAN_MAX_BITS:
            if left <= counts[length]:
                break
            left -= counts[length]
            length += 1
            left <<= 1
        return length - root_bits

    @staticmethod
    def _simple(al_size: int, br: BitReader) -> "Table":
        max_bits = _ceil_log2(al_size)
        num_symbols = br.read(2) + 1
        syms = []
        for _ in range(num_symbols):
            s = br.read(max_bits)
            if s >= al_size:
                raise InvalidHuffman("huffman symbol out of range")
            syms.append(s)
        if len(set(syms)) != len(syms):
            raise InvalidHuffman("duplicate huffman symbols")
        tree_select = br.read(1) != 0 if num_symbols == 4 else False

        bits = [0] * TABLE_SIZE
        values = [0] * TABLE_SIZE
        if num_symbols == 1:
            values = [syms[0]] * TABLE_SIZE
        elif num_symbols == 2:
            a, b = sorted(syms)
            for i in range(TABLE_SIZE):
                bits[i] = 1
                values[i] = b if (i & 1) else a
            # codes: a='0', b='1'
        elif num_symbols == 3:
            a = syms[0]
            b, c = sorted(syms[1:])
            # a='0' (1 bit), b='01', c='11' (2 bits, LSB-first low bits)
            for i in range(TABLE_SIZE):
                if (i & 1) == 0:
                    bits[i], values[i] = 1, a
                elif (i & 3) == 0b01:
                    bits[i], values[i] = 2, b
                else:
                    bits[i], values[i] = 2, c
        elif not tree_select:
            a, b, c, d = sorted(syms)
            # all 2-bit: '00'=a, '10'=b, '01'=c, '11'=d (canonical LSB-first)
            vals = [a, c, b, d]
            for i in range(TABLE_SIZE):
                bits[i] = 2
                values[i] = vals[i & 3]
        else:
            a, b = syms[0], syms[1]
            c, d = sorted(syms[2:])
            # a='0'(1), b='01'... canonical: a len1, b len2, c,d len3
            for i in range(TABLE_SIZE):
                if (i & 1) == 0:
                    bits[i], values[i] = 1, a
                elif (i & 3) == 0b01:
                    bits[i], values[i] = 2, b
                elif (i & 7) == 0b011:
                    bits[i], values[i] = 3, c
                else:  # (i & 7) == 0b111
                    bits[i], values[i] = 3, d
        return Table(bits, values)

    @staticmethod
    def _read_code_lengths(cl_lengths: list[int], al_size: int, br: BitReader) -> list[int]:
        table = Table.from_code_lengths(5, cl_lengths)
        symbol = 0
        prev_len = DEFAULT_CODE_LENGTH
        repeat = 0
        repeat_len = 0
        space = 1 << 15
        code_lengths = [0] * al_size
        while symbol < al_size and space > 0:
            idx = br.peek(5)
            br.consume(table.bits[idx])
            code_len = table.values[idx]
            if code_len < CODE_LENGTH_REPEAT_CODE:
                repeat = 0
                code_lengths[symbol] = code_len
                symbol += 1
                if code_len:
                    prev_len = code_len
                    space -= 32768 >> code_len
                    if space < 0:
                        raise InvalidHuffman("huffman code over-subscribed")
            else:
                extra_bits = code_len - 14
                new_len = prev_len if code_len == CODE_LENGTH_REPEAT_CODE else 0
                if repeat_len != new_len:
                    repeat = 0
                    repeat_len = new_len
                old_repeat = repeat
                if repeat > 0:
                    repeat = (repeat - 2) << extra_bits
                repeat += br.read(extra_bits) + 3
                delta = repeat - old_repeat
                if symbol + delta > al_size:
                    raise InvalidHuffman("huffman repeat overruns alphabet")
                for i in range(delta):
                    code_lengths[symbol + i] = repeat_len
                symbol += delta
                if repeat_len:
                    space -= delta << (15 - repeat_len)
                    if space < 0:
                        raise InvalidHuffman("huffman code over-subscribed")
        if space != 0:
            raise InvalidHuffman("huffman code under-subscribed")
        return code_lengths

    @staticmethod
    def decode(al_size: int, br: BitReader) -> "Table":
        if al_size == 1:
            return Table([0] * TABLE_SIZE, [0] * TABLE_SIZE)
        if al_size >= (1 << HUFFMAN_MAX_BITS):
            raise AlphabetTooLarge("huffman alphabet too large")
        simple_or_skip = br.read(2)
        if simple_or_skip == 1:
            return Table._simple(al_size, br)
        # complex: read code lengths for the code-length alphabet
        cl_lengths = [0] * CODE_LENGTHS_CODE
        space = 32
        num_codes = 0
        for i in range(simple_or_skip, CODE_LENGTHS_CODE):
            if space <= 0:
                break
            sym, length = _STATIC_LUT[br.peek(4)]
            br.consume(length)
            cl_lengths[_CODE_LENGTH_CODE_ORDER[i]] = sym
            if sym:
                space -= 32 >> sym
                num_codes += 1
        if num_codes != 1 and space != 0:
            raise InvalidHuffman("invalid code-length code")
        code_lengths = Table._read_code_lengths(cl_lengths, al_size, br)
        return Table.from_code_lengths(TABLE_BITS, code_lengths)

    # -- decoding ----------------------------------------------------------

    def read(self, br: BitReader) -> int:
        pos = br.peek(TABLE_BITS)
        n_bits = self.bits[pos]
        if n_bits > TABLE_BITS:
            br.pos += TABLE_BITS
            pos += self.values[pos] + br.peek(n_bits - TABLE_BITS)
        br.pos += self.bits[pos]
        return self.values[pos]


class NativeHuffmanCodes:
    """HuffmanCodes over two-level tables decoded by the native library:
    concatenated bits/values arrays with per-cluster offsets (the exact
    wire layout of pack_entropy's prefix path)."""

    __slots__ = ("offsets", "bits", "values", "singles")

    def __init__(self, offsets, bits, values, singles):
        self.offsets = offsets
        self.bits = bits
        self.values = values
        self.singles = singles

    def read(self, br: BitReader, ctx: int) -> int:
        base = int(self.offsets[ctx])
        pos = base + br.peek(TABLE_BITS)
        n_bits = int(self.bits[pos])
        if n_bits > TABLE_BITS:
            br.pos += TABLE_BITS
            pos += int(self.values[pos]) + br.peek(n_bits - TABLE_BITS)
        br.pos += int(self.bits[pos])
        return int(self.values[pos])

    def single_symbol(self, ctx: int):
        s = int(self.singles[ctx])
        return None if s < 0 else s


class HuffmanCodes:
    __slots__ = ("tables",)

    @staticmethod
    def decode(num: int, br: BitReader) -> "HuffmanCodes":
        sizes = [decode_varint16(br) + 1 for _ in range(num)]
        if max(sizes) >= (1 << HUFFMAN_MAX_BITS):
            raise AlphabetTooLarge("huffman alphabet too large")
        c = HuffmanCodes.__new__(HuffmanCodes)
        c.tables = [Table.decode(sz, br) for sz in sizes]
        return c

    def read(self, br: BitReader, ctx: int) -> int:
        return self.tables[ctx].read(br)

    def single_symbol(self, ctx: int):
        t = self.tables[ctx]
        if t.bits[0] == 0:
            return t.values[0]
        return None
