"""Bit writer and prefix-code helpers of the benchmark's stream writers.

A frozen copy of the repository's test tooling (tests/mini_encoder.py: BW,
u32, u64, varint16, write_prefix_histograms, token_bits) as of the first
benchmark, so that later changes to the decoder or its tests cannot change
the benchmark's inputs. Field layouts follow the JPEG XL codestream
(ISO/IEC 18181-1).
"""

from __future__ import annotations


class BW:
    """LSB-first bit writer (matches io/bit_reader.py read order)."""

    def __init__(self):
        self.bits = 0
        self.n = 0
        self.out = bytearray()

    def write(self, value: int, nbits: int):
        assert 0 <= value < (1 << nbits) or nbits == 0
        self.bits |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.bits & 0xFF)
            self.bits >>= 8
            self.n -= 8

    def pad_to_byte(self):
        if self.n:
            self.out.append(self.bits & 0xFF)
            self.bits = 0
            self.n = 0

    def finish(self) -> bytes:
        self.pad_to_byte()
        return bytes(self.out)


def u32(w: BW, opts, value: int):
    """U32 coder: pick the first selector that can represent `value`.
    opts entries: ("val", v) | ("bits", n) | ("bitsoff", n, off)."""
    for sel, opt in enumerate(opts):
        kind = opt[0]
        if kind == "val" and opt[1] == value:
            w.write(sel, 2)
            return
        if kind == "bits" and 0 <= value < (1 << opt[1]):
            w.write(sel, 2)
            w.write(value, opt[1])
            return
        if kind == "bitsoff" and opt[2] <= value < opt[2] + (1 << opt[1]):
            w.write(sel, 2)
            w.write(value - opt[2], opt[1])
            return
    raise ValueError(f"u32 cannot encode {value} with {opts}")


def u64(w: BW, value: int):
    if value == 0:
        w.write(0, 2)
    elif 1 <= value <= 16:
        w.write(1, 2)
        w.write(value - 1, 4)
    elif 17 <= value <= 272:
        w.write(2, 2)
        w.write(value - 17, 8)
    else:
        raise NotImplementedError("large u64")


def varint16(w: BW, v: int):
    """huffman.py decode_varint16 inverse."""
    if v == 0:
        w.write(0, 1)
        return
    w.write(1, 1)
    if v == 1:
        w.write(0, 4)
        return
    nbits = v.bit_length() - 1
    w.write(nbits, 4)
    w.write(v - (1 << nbits), nbits)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def write_prefix_histograms(w: BW, num_contexts: int, tokens: set):
    """Histograms bundle where all contexts share ONE prefix-coded cluster
    whose alphabet contains exactly `tokens` (1-4 distinct values), using
    the Brotli 'simple' table form."""
    toks = sorted(tokens)
    assert 1 <= len(toks) <= 4
    w.write(0, 1)  # lz77_enabled = 0
    if num_contexts > 1:
        w.write(1, 1)  # context map: simple
        w.write(0, 2)  # bits_per_entry = 0 -> all zeros
    w.write(1, 1)  # use_prefix_code
    # hybrid-uint config for cluster 0 at log_alpha_size=15:
    # split_exponent (4 bits) = 15 -> token == value, no msb/lsb fields
    w.write(15, 4)
    # HuffmanCodes: varint16(alphabet_size - 1) then the table
    al_size = toks[-1] + 1
    varint16(w, al_size - 1)
    if al_size == 1:
        return  # trivial table, zero bits per symbol
    # simple form
    w.write(1, 2)  # simple_or_skip = 1
    w.write(len(toks) - 1, 2)  # num_symbols - 1
    max_bits = _ceil_log2(al_size)
    for s in toks:
        w.write(s, max_bits)
    if len(toks) == 4:
        w.write(0, 1)  # tree_select = 0 -> four 2-bit codes
    # codes assigned by token_bits below (entropy/huffman.py Table._simple)


def token_bits(tokens: set, value: int):
    """The (code, nbits) one symbol costs under write_prefix_histograms,
    matching the decoder's simple-form code assignment (LSB-first)."""
    toks = sorted(tokens)
    if len(toks) == 1:
        return (0, 0)
    if len(toks) == 2:
        return (toks.index(value), 1)
    if len(toks) == 3:
        # syms[0]='0' (1 bit); remaining sorted: '01', '11'
        if value == toks[0]:
            return (0, 1)
        return (0b01, 2) if value == toks[1] else (0b11, 2)
    # 4 symbols, tree_select=0: sorted a,b,c,d -> '00','10','01','11'
    return {toks[0]: (0b00, 2), toks[1]: (0b10, 2), toks[2]: (0b01, 2), toks[3]: (0b11, 2)}[value]
