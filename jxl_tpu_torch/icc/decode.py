"""JXL entropy-coded ICC profile decompression.

Capability reference: jxl/src/icc/{mod,stream,header,tag}.rs (spec
"ICC profile encoding"): a context-modeled byte stream whose contexts
depend on the previous two bytes, followed by a command-based
reconstruction (header prediction, common tag/data substitution, byte
shuffles, linear prediction). The counterpart of jxl_tpu/icc/decode.py:
the byte stream decodes in the native library (native/modular_decode.cc
jxl_decode_icc), which raises when it cannot be built; _icc_context is
the context model it implements, kept here as the specification the
tests hold it to.
"""

from __future__ import annotations

from ..entropy import Histograms
from ..errors import IccEndOfStream, IccTooLarge, InvalidIccStream
from ..io.bit_reader import BitReader
from ..io.bundle import U64

ICC_CONTEXTS = 41
ICC_HEADER_SIZE = 128

_COMMON_TAGS = [
    b"rTRC", b"rXYZ", b"cprt", b"wtpt", b"bkpt", b"rXYZ", b"gXYZ", b"bXYZ",
    b"kXYZ", b"rTRC", b"gTRC", b"bTRC", b"kTRC", b"chad", b"desc", b"chrm",
    b"dmnd", b"dmdd", b"lumi",
]

_COMMON_DATA = [b"XYZ ", b"desc", b"text", b"mluc", b"para", b"curv", b"sf32", b"gbd "]


def _icc_context(size: int, b1: int, b2: int) -> int:
    if size <= ICC_HEADER_SIZE:
        return 0
    if (0x41 <= b1 <= 0x5A) or (0x61 <= b1 <= 0x7A):
        p1 = 0
    elif (0x30 <= b1 <= 0x39) or b1 in (0x2E, 0x2C):
        p1 = 1
    elif b1 <= 1:
        p1 = 2 + b1
    elif b1 <= 15:
        p1 = 4
    elif 241 <= b1 <= 254:
        p1 = 5
    elif b1 == 255:
        p1 = 6
    else:
        p1 = 7
    if (0x41 <= b2 <= 0x5A) or (0x61 <= b2 <= 0x7A):
        p2 = 0
    elif (0x30 <= b2 <= 0x39) or b2 in (0x2E, 0x2C):
        p2 = 1
    elif b2 <= 15:
        p2 = 2
    elif b2 >= 241:
        p2 = 3
    else:
        p2 = 4
    return 1 + p1 + 8 * p2


def read_icc(br: BitReader) -> bytes:
    """Decode the entropy-coded ICC blob + reconstruct the profile."""
    length = U64().read(br)
    if length > (1 << 24):
        raise IccTooLarge("ICC too large")
    histograms = Histograms.decode(ICC_CONTEXTS, br, allow_lz77=True)

    from .. import native

    return _reconstruct_profile(native.decode_icc_native(histograms, br, length))


class _Stream:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        if self.pos >= len(self.data):
            raise IccEndOfStream("ICC end of stream")
        self.pos += 1
        return self.data[self.pos - 1]

    def exact(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise IccEndOfStream("ICC end of stream")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def varint(self) -> int:
        value = 0
        shift = 0
        while shift < 63:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return value

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos

    @property
    def at_end(self) -> bool:
        return self.pos >= len(self.data)


def _predict_header(idx: int, output_size: int, header: bytes) -> int:
    if idx <= 3:
        return (output_size >> (8 * (3 - idx))) & 0xFF
    if idx == 8:
        return 4
    if 12 <= idx <= 23:
        return b"mntrRGB XYZ "[idx - 12]
    if 36 <= idx <= 39:
        return b"acsp"[idx - 36]
    if idx in (41, 42) and header[40:41] == b"A":
        return ord("P")
    if idx == 43 and header[40:41] == b"A":
        return ord("L")
    if idx == 41 and header[40:41] == b"M":
        return ord("S")
    if idx == 42 and header[40:41] == b"M":
        return ord("F")
    if idx == 43 and header[40:41] == b"M":
        return ord("T")
    if idx == 42 and header[40:42] == b"SG":
        return ord("I")
    if idx == 43 and header[40:42] == b"SG":
        return ord(" ")
    if idx == 42 and header[40:42] == b"SU":
        return ord("N")
    if idx == 43 and header[40:42] == b"SU":
        return ord("W")
    if idx == 70:
        return 246
    if idx == 71:
        return 214
    if idx == 73:
        return 1
    if idx == 78:
        return 211
    if idx == 79:
        return 45
    if 80 <= idx <= 83:
        return header[4 + idx - 80]
    return 0


def _shuffle_w2(b: bytes) -> bytes:
    n = len(b)
    h = n // 2
    odd = n % 2
    out = bytearray()
    for i in range(h):
        out.append(b[i])
        out.append(b[i + h + odd])
    if odd:
        out.append(b[h])
    return bytes(out)


def _shuffle_w4(b: bytes) -> bytes:
    n = len(b)
    step = n // 4
    wide = n % 4
    out = bytearray()
    for i in range(step):
        base = i
        for _ in range(wide):
            out.append(b[base])
            base += step + 1
        for _ in range(wide, 4):
            out.append(b[base])
            base += step
    for i in range(1, wide + 1):
        out.append(b[(step + 1) * i - 1])
    return bytes(out)


def _reconstruct_profile(coded: bytes) -> bytes:
    stream = _Stream(coded)
    output_size = stream.varint()
    commands_size = stream.varint()
    if stream.pos + commands_size > len(coded):
        raise InvalidIccStream("invalid ICC stream")
    if output_size > (1 << 28):
        raise IccTooLarge("ICC too large")
    if output_size + 65536 < len(coded):
        raise IccTooLarge("ICC too large")
    commands = _Stream(stream.exact(commands_size))
    data = stream

    header_size = min(output_size, ICC_HEADER_SIZE)
    header_data = data.exact(header_size)
    out = bytearray(output_size)
    pos = 0
    for idx in range(header_size):
        out[idx] = (header_data[idx] + _predict_header(idx, output_size, header_data)) & 0xFF
    pos = header_size
    if output_size <= ICC_HEADER_SIZE:
        return bytes(out)

    def w(b: bytes):
        nonlocal pos
        if pos + len(b) > output_size:
            raise InvalidIccStream("ICC output overflow")
        out[pos : pos + len(b)] = b
        pos += len(b)

    # tag list
    v = commands.varint()
    if v >= 1:
        num_tags = v - 1
        if (output_size - ICC_HEADER_SIZE) // 12 < num_tags:
            raise InvalidIccStream("invalid ICC stream: num_tags")
        w(num_tags.to_bytes(4, "big"))
        prev_tagstart = num_tags * 12 + ICC_HEADER_SIZE
        prev_tagsize = 0
        while not commands.at_end:
            command = commands.u8()
            tagcode = command & 63
            if tagcode == 0:
                break
            if tagcode == 1:
                tag = data.exact(4)
            elif 2 <= tagcode <= 20:
                tag = _COMMON_TAGS[tagcode - 2]
            else:
                raise InvalidIccStream("invalid ICC tag code")
            if command & 64:
                tagstart = commands.varint()
            else:
                tagstart = prev_tagstart + prev_tagsize
            if command & 128:
                tagsize = commands.varint()
            elif tag in (b"rXYZ", b"gXYZ", b"bXYZ", b"kXYZ", b"wtpt", b"bkpt", b"lumi"):
                tagsize = 20
            else:
                tagsize = prev_tagsize
            if tagstart + tagsize > output_size:
                raise InvalidIccStream("ICC tag overflow")
            prev_tagstart, prev_tagsize = tagstart, tagsize
            w(tag)
            w(tagstart.to_bytes(4, "big"))
            w(tagsize.to_bytes(4, "big"))
            if tagcode == 2:
                w(b"gTRC" + tagstart.to_bytes(4, "big") + tagsize.to_bytes(4, "big"))
                w(b"bTRC" + tagstart.to_bytes(4, "big") + tagsize.to_bytes(4, "big"))
            elif tagcode == 3:
                w(b"gXYZ" + (tagstart + tagsize).to_bytes(4, "big") + tagsize.to_bytes(4, "big"))
                w(b"bXYZ" + (tagstart + 2 * tagsize).to_bytes(4, "big") + tagsize.to_bytes(4, "big"))

    # tag data commands
    while not commands.at_end:
        command = commands.u8()
        if command == 1:
            num = commands.varint()
            w(data.exact(num))
        elif command in (2, 3):
            num = commands.varint()
            b = data.exact(num)
            w(_shuffle_w2(b) if command == 2 else _shuffle_w4(b))
        elif command == 4:
            flags = commands.u8()
            width = (flags & 3) + 1
            order = (flags >> 2) & 3
            if width == 3 or order == 3:
                raise InvalidIccStream("invalid ICC predict command")
            stride = commands.varint() if (flags & 16) else width
            if stride < width or stride * 4 >= pos:
                raise InvalidIccStream("invalid ICC stride")
            num = commands.varint()
            b = data.exact(num)
            if width == 2:
                b = _shuffle_w2(b)
            elif width == 4:
                b = _shuffle_w4(b)
            for i in range(0, num, width):
                prev = [0, 0, 0]
                for j in range(order + 1):
                    off = pos - stride * (j + 1)
                    chunk = bytes(out[off : off + width])
                    prev[j] = int.from_bytes(b"\0" * (4 - width) + chunk, "big")
                if order == 0:
                    p = prev[0]
                elif order == 1:
                    p = 2 * prev[0] - prev[1]
                else:
                    p = 3 * (prev[0] - prev[1]) + prev[2]
                p &= 0xFFFFFFFF
                for j in range(min(width, num - i)):
                    val = (b[i + j] + (p >> (8 * (width - 1 - j)))) & 0xFF
                    out[pos] = val
                    pos += 1
        elif command == 10:
            buf = bytearray(20)
            buf[:4] = b"XYZ "
            buf[8:] = data.exact(12)
            w(bytes(buf))
        elif 16 <= command <= 23:
            w(_COMMON_DATA[command - 16] + b"\0" * 4)
        else:
            raise InvalidIccStream("invalid ICC command")

    if pos != output_size:
        raise InvalidIccStream("ICC profile size mismatch")
    if not data.at_end:
        raise InvalidIccStream("ICC stream not fully consumed")
    return bytes(out)
