"""ISOBMFF-style JXL container handling (non-streaming helper).

Detects bare codestreams vs containers and extracts the codestream from
jxlc / jxlp boxes (out-of-order jxlp handled by index). The streaming,
checkpointable BoxParser lives in api/box_parser.py; this helper serves
whole-file decode and tests. ref capability: jxl/src/api/inner/box_parser.rs,
api/signature.rs.
"""

from __future__ import annotations

from ..errors import InvalidBitstream, InvalidBox, InvalidSignature, OutOfBounds

CONTAINER_SIG = bytes(
    [0x00, 0x00, 0x00, 0x0C, 0x4A, 0x58, 0x4C, 0x20, 0x0D, 0x0A, 0x87, 0x0A]
)
CODESTREAM_SIG = bytes([0xFF, 0x0A])


def detect_signature(data: bytes) -> str:
    """Return 'codestream', 'container', or raise."""
    if len(data) < 2:
        raise OutOfBounds(2 - len(data))
    if data[:2] == CODESTREAM_SIG:
        return "codestream"
    n = min(len(data), len(CONTAINER_SIG))
    if data[:n] == CONTAINER_SIG[:n]:
        if len(data) < len(CONTAINER_SIG):
            raise OutOfBounds(len(CONTAINER_SIG) - len(data))
        return "container"
    raise InvalidSignature("not a JPEG XL file")


def iter_boxes(data: bytes):
    """Yield (box_type: bytes, payload: memoryview) over a full container."""
    pos = 0
    view = memoryview(data)
    while pos < len(data):
        if pos + 8 > len(data):
            raise OutOfBounds(pos + 8 - len(data))
        size = int.from_bytes(data[pos : pos + 4], "big")
        btype = bytes(data[pos + 4 : pos + 8])
        header = 8
        if size == 1:
            if pos + 16 > len(data):
                raise OutOfBounds(pos + 16 - len(data))
            size = int.from_bytes(data[pos + 8 : pos + 16], "big")
            header = 16
        if size == 0:
            payload = view[pos + header :]
            pos = len(data)
        else:
            if size < header:
                raise InvalidBox(f"box size {size} smaller than header")
            if pos + size > len(data):
                raise OutOfBounds(pos + size - len(data))
            payload = view[pos + header : pos + size]
            pos += size
        yield btype, payload


def extract_codestream_ex(data: bytes) -> tuple[bytes, list[tuple[int, int]]]:
    """Return (codestream, ooo_ranges) from a .jxl file (bare or container).

    ooo_ranges are codestream byte ranges whose jxlp box was received out
    of physical order (or while other parts were pending); frames must not
    start inside such ranges (ref box_parser.rs:120-133 add_checkpoint and
    tests/api.rs decode_ooo_jxlp_invalid_animated_container)."""
    kind = detect_signature(data)
    if kind == "codestream":
        return bytes(data), []
    parts = {}
    ooo = set()
    jxlc = None
    for btype, payload in iter_boxes(data):
        if btype == b"jxlc":
            jxlc = bytes(payload)
        elif btype == b"jxlp":
            if len(payload) < 4:
                raise InvalidBox("jxlp box too small")
            idx = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            # in-order iff every logically-preceding part is physically
            # before this one and no logically-later part has been seen
            if set(parts) != set(range(idx)):
                ooo.add(idx)
            parts[idx] = bytes(payload[4:])
    if jxlc is not None:
        return jxlc, []
    if parts:
        if sorted(parts) != list(range(len(parts))):
            raise InvalidBox("jxlp part indices not contiguous")
        ranges = []
        pos = 0
        for i in sorted(parts):
            if i in ooo:
                ranges.append((pos, pos + len(parts[i])))
            pos += len(parts[i])
        return b"".join(parts[i] for i in sorted(parts)), ranges
    raise InvalidBox("container has no codestream boxes")


def extract_codestream(data: bytes) -> bytes:
    """Return the raw codestream bytes from a .jxl file (bare or container)."""
    return extract_codestream_ex(data)[0]
