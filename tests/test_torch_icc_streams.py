"""Embedded ICC profile streams, and checks that the JAX package reads
them back.

`encode_icc(profile)` writes an ICC profile the way the decoder reads it
(ref icc/{mod,stream,header,tag}.rs; jxl_tpu_torch/icc/decode.py): the
U64 length of the coded byte stream, the histograms over the 41 ICC
contexts plus LZ77's distance context, then the stream's bytes, each under
the context of the two bytes before it (icc/decode.py:_icc_context),
rANS-coded, runs of a repeated byte as LZ77 copies at distance 1. The
coded stream is what _reconstruct_profile turns back into the same
profile: the output size and the commands' size, the commands, then the
data. The data starts with the 128 header bytes less their prediction;
the commands code the tag table (common tag codes, the rTRC/gTRC/bTRC and
rXYZ/gXYZ/bXYZ shortcuts, implicit starts and sizes) and then the tag
data: common type signatures, XYZ values, a 16-bit table under the
second-order linear prediction (the shuffled residuals of a smooth curve
are long runs), and raw copies.

Profiles: `display_p3_profile()` and `pq_profile()`, the port's own
synthesized profiles (color/icc_synth.py) of Display-P3 and of BT.2100 PQ,
whose TRC is a 4096-entry curv table.

This module imports neither jax nor jxl_tpu at the top: chip_smoke.py
imports the writer. The tests below import the JAX package inside each
test.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

from test_torch_vardct_streams import (BitList, bitlist_bits, hybrid_encode, hybrid_tokens,
                                       write_ans_flat_histograms, write_rans_stream)

ICC_CONTEXTS = 41
HEADER_SIZE = 128
# clusters: three over the byte contexts, one for LZ77's distances
_CMAP = [0] + [1 + c % 2 for c in range(1, ICC_CONTEXTS)] + [3]
_ALPHABETS = (64, 64, 64, 32)
_UINT = ((4, 0, 0), (4, 0, 0), (4, 0, 0), (4, 0, 0))
LZ_MIN_SYMBOL = 32  # above every byte's token (at most 19 under (4, 0, 0))
LZ_MIN_LENGTH = 3
LZ_LENGTH_UINT = (4, 0, 0)
_XYZ_TAGS = (b"rXYZ", b"gXYZ", b"bXYZ", b"kXYZ", b"wtpt", b"bkpt", b"lumi")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unshuffle2(b: bytes) -> bytes:
    """The bytes whose width-2 shuffle (icc/decode.py:_shuffle_w2) is `b`:
    the shuffle interleaves the first half with the second."""
    n, h = len(b), len(b) // 2
    odd = n % 2
    src = np.empty(n, np.int64)  # the input index of each output byte
    src[0 : 2 * h : 2] = np.arange(h)
    src[1 : 2 * h : 2] = np.arange(h) + h + odd
    if odd:
        src[n - 1] = h
    out = np.zeros(n, np.uint8)
    out[src] = np.frombuffer(b, np.uint8)
    return out.tobytes()


def _tag_table(profile: bytes):
    n = struct.unpack(">I", profile[HEADER_SIZE : HEADER_SIZE + 4])[0]
    tags = []
    for i in range(n):
        at = HEADER_SIZE + 4 + 12 * i
        sig = profile[at : at + 4]
        start, size = struct.unpack(">II", profile[at + 4 : at + 12])
        tags.append((sig, start, size))
    return tags


def coded_profile(profile: bytes) -> bytes:
    """The coded ICC stream whose reconstruction is `profile`."""
    from jxl_tpu_torch.icc.decode import _COMMON_DATA, _COMMON_TAGS, _predict_header

    size = len(profile)
    assert size > HEADER_SIZE
    header = bytearray(HEADER_SIZE)
    for i in range(HEADER_SIZE):  # each prediction reads earlier coded bytes only
        header[i] = (profile[i] - _predict_header(i, size, bytes(header))) & 0xFF
    data = bytearray(header)
    cmd = bytearray()
    # the tag table
    tags = _tag_table(profile)
    cmd += _varint(len(tags) + 1)
    prev_start, prev_size = len(tags) * 12 + HEADER_SIZE, 0
    i = 0
    while i < len(tags):
        sig, start, tsize = tags[i]
        code, skip = 1, 0
        if (sig == b"rTRC" and tags[i + 1 : i + 3] == [(b"gTRC", start, tsize),
                                                       (b"bTRC", start, tsize)]):
            code, skip = 2, 2
        elif (sig == b"rXYZ" and tags[i + 1 : i + 3] == [(b"gXYZ", start + tsize, tsize),
                                                         (b"bXYZ", start + 2 * tsize, tsize)]):
            code, skip = 3, 2
        elif sig in _COMMON_TAGS:  # the plain code (rTRC and rXYZ have two)
            code = len(_COMMON_TAGS) + 1 - _COMMON_TAGS[::-1].index(sig)
        command = code
        implicit_size = 20 if sig in _XYZ_TAGS else prev_size
        if start != prev_start + prev_size:
            command |= 64
        if tsize != implicit_size:
            command |= 128
        cmd.append(command)
        if code == 1:
            data += sig
        if command & 64:
            cmd += _varint(start)
        if command & 128:
            cmd += _varint(tsize)
        prev_start, prev_size = start, tsize
        i += 1 + skip
    cmd.append(0)  # the end of the tag list
    # the tag data, from the end of the table
    pos = HEADER_SIZE + 4 + 12 * len(tags)
    starts = sorted({(s, n) for _, s, n in tags})

    def raw(a, b):
        if b > a:
            cmd.append(1)
            cmd.extend(_varint(b - a))
            data.extend(profile[a:b])

    for start, tsize in starts:
        raw(pos, start)
        pos = max(pos, start)
        end = start + tsize
        body = profile[start:end]
        if start < pos:
            continue
        if body[:4] == b"XYZ " and tsize == 20 and body[4:8] == b"\0" * 4:
            cmd.append(10)
            data += body[8:20]
            pos = end
            continue
        if body[:4] in _COMMON_DATA and body[4:8] == b"\0" * 4:
            cmd.append(16 + _COMMON_DATA.index(body[:4]))
            pos = start + 8
        if body[:4] == b"curv" and tsize > 64:
            # the count, then the 16-bit table under order-1 prediction
            raw(pos, pos + 4)
            pos += 4
            num = end - pos
            cmd += bytes([4, 1 | (1 << 2)]) + _varint(num)
            target = np.frombuffer(profile, np.uint8)
            resid = bytearray(num)
            for k in range(0, num, 2):
                p0 = int.from_bytes(profile[pos + k - 2 : pos + k], "big")
                p1 = int.from_bytes(profile[pos + k - 4 : pos + k - 2], "big")
                pred = (2 * p0 - p1) & 0xFFFFFFFF
                for j in range(min(2, num - k)):
                    resid[k + j] = (int(target[pos + k + j]) - (pred >> (8 * (1 - j)))) & 0xFF
            data += _unshuffle2(bytes(resid))
            pos = end
            continue
        raw(pos, end)
        pos = end
    raw(pos, size)
    return _varint(size) + _varint(len(cmd)) + bytes(cmd) + bytes(data)


def _u64(w, v: int) -> None:
    """U64 (ref bundle U64) of any value."""
    if v == 0:
        w.write(0, 2)
    elif v <= 16:
        w.write(1, 2)
        w.write(v - 1, 4)
    elif v <= 272:
        w.write(2, 2)
        w.write(v - 17, 8)
    else:
        w.write(3, 2)
        w.write(v & 0xFFF, 12)
        v >>= 12
        while v:
            w.write(1, 1)
            w.write(v & 0xFF, 8)
            v >>= 8
        w.write(0, 1)


def encode_icc(profile: bytes) -> np.ndarray:
    """The embedded ICC stream of `profile`: a uint8 array of 0/1 bits,
    LSB first."""
    from jxl_tpu_torch.icc.decode import _icc_context

    blob = coded_profile(profile)
    w = BitList()
    _u64(w, len(blob))
    write_ans_flat_histograms(w, _CMAP, _ALPHABETS, _UINT,
                              lz77=(LZ_MIN_SYMBOL, LZ_MIN_LENGTH, LZ_LENGTH_UINT))
    vals, cls, lz = [], [], []  # lz: a (length, distance) copy at this token
    i = 0
    while i < len(blob):
        cl = _CMAP[_icc_context(i, blob[i - 1] if i else 0, blob[i - 2] if i > 1 else 0)]
        run = 0
        if i:
            while i + run < len(blob) and blob[i + run] == blob[i - 1]:
                run += 1
        if run >= LZ_MIN_LENGTH:
            vals.append(run - LZ_MIN_LENGTH)
            cls.append(cl)
            lz.append(True)
            vals.append(0)  # distance 1
            cls.append(3)
            lz.append(False)
            i += run
        else:
            vals.append(blob[i])
            cls.append(cl)
            lz.append(False)
            i += 1
    tk, raw, nraw = hybrid_tokens(np.where(lz, 0, vals), cls, _UINT, _ALPHABETS)
    is_len = np.array(lz, bool)
    if is_len.any():
        t, r, n = hybrid_encode(np.array(vals)[is_len], LZ_LENGTH_UINT)
        tk[is_len], raw[is_len], nraw[is_len] = LZ_MIN_SYMBOL + t, r, n
    assert (tk < np.array(_ALPHABETS)[cls]).all()
    write_rans_stream(w, tk, cls, raw, nraw, _ALPHABETS)
    return bitlist_bits(w)


def _encoding(primaries=None, tf=None):
    from jxl_tpu_torch.io.headers.image import default_color_encoding

    enc = default_color_encoding()
    if primaries is not None:
        enc.primaries = primaries
    if tf is not None:
        enc.tf.transfer_function = tf
    return enc


def display_p3_profile() -> bytes:
    """The port's synthesized Display-P3 profile (sRGB transfer curve)."""
    from jxl_tpu_torch.color.icc_synth import synthesize_icc
    from jxl_tpu_torch.io.headers import Primaries

    return synthesize_icc(_encoding(Primaries.P3))


def pq_profile() -> bytes:
    """The port's synthesized BT.2100 PQ profile: its TRC is a 4096-entry
    curv table, shared by rTRC, gTRC and bTRC."""
    from jxl_tpu_torch.color.icc_synth import synthesize_icc
    from jxl_tpu_torch.io.headers import Primaries, TransferFunction

    return synthesize_icc(_encoding(Primaries.BT2100, TransferFunction.PQ), 10000.0)


PROFILES = {"display_p3": display_p3_profile, "pq": pq_profile}


# -- the JAX package reads the profiles back -------------------------------------


def _bits_reader(bits, reader_cls):
    data = np.packbits(np.concatenate([bits, np.zeros(64, np.uint8)]),
                       bitorder="little").tobytes()
    return reader_cls(data)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_jxl_tpu_reconstructs_the_coded_profile(name):
    from jxl_tpu.icc.decode import _reconstruct_profile

    profile = PROFILES[name]()
    assert _reconstruct_profile(coded_profile(profile)) == profile


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_jxl_tpu_reads_the_icc_stream(name):
    from jxl_tpu.icc.decode import read_icc
    from jxl_tpu.io.bit_reader import BitReader

    profile = PROFILES[name]()
    bits = encode_icc(profile)
    br = _bits_reader(bits, BitReader)
    assert read_icc(br) == profile
    assert br.pos == len(bits)


def test_pq_profile_codes_long_runs_as_copies():
    profile = pq_profile()
    blob = coded_profile(profile)
    assert len(profile) > 8192 and profile.count(b"curv") == 1
    # a literal byte costs at least 6 bits under the flat 64-symbol
    # histograms: fewer bits than that a byte means LZ77 copied the runs
    assert len(encode_icc(profile)) < 6 * len(blob)
