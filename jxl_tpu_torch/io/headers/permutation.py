"""Lehmer-coded permutations (TOC section order, coefficient orders).

Capability reference: jxl/src/headers/permutation.rs. The Lehmer code is
decoded with an order-statistics Fenwick tree (O(n log n)); contexts are
ceil_log2(prev+1) clamped to 7.
"""

from __future__ import annotations

from ...errors import InvalidBitstream, InvalidPermutation
from ...io.bit_reader import BitReader


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _context(x: int) -> int:
    return min(_ceil_log2(x + 1), 7)


def decode_lehmer_code(code: list[int], base: list[int]) -> list[int]:
    """Apply Lehmer code `code` to `base`: out[i] = i-th smallest unused."""
    n = len(base)
    if n == 0:
        raise InvalidPermutation("empty permutation")
    if n >= 64:
        from ... import native

        idx = native.apply_lehmer(code, n) if native.available() else None
        if idx is not None:
            return [base[i] for i in idx]
    # Fenwick tree over "still unused" counts, padded to a power of two
    padded = 1
    while padded < n:
        padded <<= 1
    tree = [((i + 1) & -(i + 1)) for i in range(padded)]

    out = []
    for i in range(n):
        code_i = code[i] if i < len(code) else 0
        if code_i > n - i - 1:
            raise InvalidPermutation("invalid Lehmer code value")
        rank = code_i + 1
        bit = padded
        nxt = 0
        while bit:
            cand = nxt + bit
            bit >>= 1
            if cand <= padded and tree[cand - 1] < rank:
                nxt = cand
                rank -= tree[cand - 1]
        out.append(base[nxt])
        nxt += 1
        while nxt <= padded:
            tree[nxt - 1] -= 1
            nxt += nxt & -nxt
    return out


def decode_permutation(
    size: int, skip: int, histograms, br: BitReader, reader
) -> list[int]:
    """Entropy-coded permutation of 0..size-1, identity on the first `skip`."""
    end = reader.read_unsigned(histograms, br, _context(size))
    if end > size - skip:
        # distinguish truncated input (optimistic reads return zero-padded
        # garbage) from a genuinely invalid stream, so streaming resume works
        br.check_no_overrun()
        raise InvalidPermutation(f"invalid permutation size {end} > {size - skip}")
    lehmer = []
    prev = 0
    for _ in range(end):
        val = reader.read_unsigned(histograms, br, _context(prev))
        lehmer.append(val)
        prev = val
    br.check_no_overrun()
    perm = list(range(size))
    if end > 0:
        perm[skip:] = decode_lehmer_code(lehmer, perm[skip:])
    # validate in-range (decode_lehmer_code already bounds-checks)
    return perm


def read_toc_permutation(br: BitReader, num_entries: int, permuted: bool) -> list[int]:
    """TOC permutation: 8 contexts, LZ77 allowed; byte-aligned afterwards.

    ref: headers/encodings.rs:177-198.
    """
    from ...entropy import Histograms, SymbolReader

    if permuted:
        histograms = Histograms.decode(8, br, allow_lz77=True)
        reader = SymbolReader(histograms, br)
        perm = decode_permutation(num_entries, 0, histograms, br, reader)
    else:
        perm = list(range(num_entries))
    br.jump_to_byte_boundary()
    return perm
