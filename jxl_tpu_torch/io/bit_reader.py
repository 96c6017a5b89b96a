"""Little-endian bit-level reader over a byte buffer.

Capability parity with the reference's 56-bit-refill reader
(ref: jxl/src/bit_reader.rs:13-249), re-designed for Python: instead of a
64-bit rolling buffer we read straight out of the byte string with
arbitrary-precision ints (reads are not capped at 56 bits). Exactness of
the out-of-bounds byte accounting matters: the streaming layer converts
`OutOfBounds(n)` into `NeedsMoreInput` size hints, and the 1-byte-at-a-time
streaming tests depend on it.

The *hot* bit consumption (ANS/modular symbol streams) does NOT go through
this class in the production path — sections are handed as raw byte ranges
to the native/device entropy kernels. This reader serves headers, tables,
and the host oracle.
"""

from __future__ import annotations

from ..errors import NonZeroPadding, OutOfBounds


class BitReader:
    __slots__ = ("data", "pos", "len_bits")

    def __init__(self, data):
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError("BitReader needs a bytes-like object")
        # bytearray input is wrapped zero-copy: the streaming decoder builds
        # a fresh reader over its (append-only) codestream buffer every
        # process() call, and copying the whole stream each time would make
        # byte-at-a-time feeding O(N^2). len_bits snapshots the length at
        # construction; appended bytes become visible to the next reader.
        self.data = data if isinstance(data, (bytes, bytearray)) else bytes(data)
        self.pos = 0
        self.len_bits = len(self.data) * 8

    # -- core ---------------------------------------------------------------

    def peek(self, n: int) -> int:
        """Read `n` bits without consuming; zero-padded past the end."""
        p = self.pos
        b0 = p >> 3
        nbytes = ((p & 7) + n + 7) >> 3
        chunk = self.data[b0 : b0 + nbytes]
        v = int.from_bytes(chunk, "little")
        return (v >> (p & 7)) & ((1 << n) - 1)

    def consume(self, n: int) -> None:
        if self.pos + n > self.len_bits:
            raise OutOfBounds((self.pos + n - self.len_bits + 7) >> 3)
        self.pos += n

    def read(self, n: int) -> int:
        """Read and consume `n` bits (LSB-first)."""
        p = self.pos
        if p + n > self.len_bits:
            raise OutOfBounds((p + n - self.len_bits + 7) >> 3)
        b0 = p >> 3
        nbytes = ((p & 7) + n + 7) >> 3
        v = int.from_bytes(self.data[b0 : b0 + nbytes], "little")
        self.pos = p + n
        return (v >> (p & 7)) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        from .bundle import unpack_signed

        return unpack_signed(self.read(n))

    def read_opt(self, n: int) -> int:
        """Optimistic read: zero-padded past the end; overrun is recorded in
        `pos` and detected later by check_no_overrun() (hot entropy paths)."""
        v = self.peek(n)
        self.pos += n
        return v

    def check_no_overrun(self) -> None:
        if self.pos > self.len_bits:
            raise OutOfBounds((self.pos - self.len_bits + 7) >> 3)

    # -- bookkeeping ----------------------------------------------------------

    def total_bits_read(self) -> int:
        return self.pos

    def total_bits_available(self) -> int:
        return self.len_bits - self.pos

    def skip_bits(self, n: int) -> None:
        self.consume(n)

    def bits_to_next_byte(self) -> int:
        return (-self.pos) & 7

    def jump_to_byte_boundary(self) -> None:
        """Advance to byte boundary; skipped bits must be zero."""
        if self.read(self.bits_to_next_byte()) != 0:
            raise NonZeroPadding("non-zero padding bits at byte boundary")

    def split_at(self, n_bytes: int) -> "BitReader":
        """Carve off a reader for the next `n_bytes` full bytes; advance self.

        ref behavior: jxl/src/bit_reader.rs:234-249 (used to hand each TOC
        section its own independent reader).
        """
        self.jump_to_byte_boundary()
        start = self.pos >> 3
        end = start + n_bytes
        if end * 8 > self.len_bits:
            raise OutOfBounds(end - (self.len_bits >> 3))
        ret = BitReader(bytes(self.data[start:end]))
        self.pos = end * 8
        return ret

    def remaining_bytes(self) -> bytes:
        """Bytes from the current (byte-aligned) position to the end."""
        assert self.pos % 8 == 0
        return bytes(self.data[self.pos >> 3 :])
