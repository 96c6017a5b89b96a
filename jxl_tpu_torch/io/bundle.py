"""Declarative header ("bundle") codec.

The JPEG XL header format encodes struct fields with a small set of coders:
2-bit-selected U32s, variable-length u64, f16-as-f32, bools, enums,
conditional fields and `all_default` shortcuts. The reference implements
this with a derive macro (ref: jxl/src/headers/encodings.rs:13-408,
jxl_macros/src/lib.rs:684-718); here the same semantics are expressed as
field descriptors on plain Python classes, turned into a reader by the
@bundle decorator. Headers parse once per frame on the host — clarity over
speed.

Usage:

    @bundle
    class BitDepth:
        floating_point: bool = field(Bool(), default=False)
        bits_per_sample: int = field(
            U32(Val(8), Val(10), Val(12), BitsOffset(6, 1)),
            condition=lambda s, ns: not s.floating_point, default=8)

Conditions/defaults may be callables taking (partial_self, nonserialized).
A field named `all_default` short-circuits: if it reads True every later
field keeps its default.
"""

from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Any, Callable, Optional

from ..errors import FloatNaNOrInf, InvalidBitstream, InvalidEnum, SizeOverflow
from .bit_reader import BitReader


def unpack_signed(u: int) -> int:
    """Map unsigned to signed: 0->0, 1->-1, 2->1, 3->-2, 4->2, ...

    (spec UnpackSigned; ref: entropy_coding/decode.rs:31-33)
    """
    if u & 1:
        return -((u + 1) >> 1)
    return u >> 1


# -- U32 leaf coders ----------------------------------------------------------


class Bits:
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n

    def read(self, br: BitReader) -> int:
        return br.read(self.n)


class BitsOffset:
    __slots__ = ("n", "off")

    def __init__(self, n: int, off: int):
        self.n = n
        self.off = off

    def read(self, br: BitReader) -> int:
        return br.read(self.n) + self.off


class Val:
    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v

    def read(self, br: BitReader) -> int:
        return self.v


class U32:
    """2-bit selector choosing one of four leaf encodings."""

    __slots__ = ("opts",)

    def __init__(self, d0, d1, d2, d3):
        self.opts = (d0, d1, d2, d3)

    def read(self, br: BitReader) -> int:
        return self.opts[br.read(2)].read(br)


class SignedU32:
    """U32 followed by unpack_signed."""

    __slots__ = ("inner",)

    def __init__(self, d0, d1, d2, d3):
        self.inner = U32(d0, d1, d2, d3)

    def read(self, br: BitReader) -> int:
        return unpack_signed(self.inner.read(br))


class U64:
    """Variable-length u64 (ref: headers/encodings.rs:112-138)."""

    def read(self, br: BitReader) -> int:
        sel = br.read(2)
        if sel == 0:
            return 0
        if sel == 1:
            return 1 + br.read(4)
        if sel == 2:
            return 17 + br.read(8)
        result = br.read(12)
        shift = 12
        while br.read(1) == 1:
            if shift >= 60:
                assert shift == 60
                return result | (br.read(4) << shift)
            result |= br.read(8) << shift
            shift += 8
        return result


class Bool:
    def read(self, br: BitReader) -> bool:
        return br.read(1) != 0


class F16:
    """16-bit IEEE half, returned as float; NaN/Inf is an error."""

    def read(self, br: BitReader) -> float:
        bits = br.read(16)
        v = _struct.unpack("<e", bits.to_bytes(2, "little"))[0]
        if v != v or v in (float("inf"), float("-inf")):
            raise FloatNaNOrInf("f16 header field is NaN or Inf")
        return float(v)


ENUM_CODER = U32(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(6, 18))


class Enum:
    """JXL enum encoding; validates membership."""

    __slots__ = ("cls",)

    def __init__(self, cls):
        self.cls = cls

    def read(self, br: BitReader):
        v = ENUM_CODER.read(br)
        try:
            return self.cls(v)
        except ValueError:
            raise InvalidEnum(self.cls.__name__, v) from None


class JxlString:
    """Length-prefixed latin-1 string (ref: encodings.rs:140-175)."""

    LEN = U32(Val(0), Bits(4), BitsOffset(5, 16), BitsOffset(10, 48))

    def read(self, br: BitReader) -> str:
        n = self.LEN.read(br)
        return "".join(chr(br.read(8)) for _ in range(n))


class Vector:
    """Length-prefixed vector of values."""

    __slots__ = ("size_coder", "value_coder")

    def __init__(self, size_coder, value_coder):
        self.size_coder = size_coder
        self.value_coder = value_coder

    def read(self, br: BitReader):
        n = self.size_coder.read(br)
        if n > (1 << 24):
            raise SizeOverflow(f"vector length {n} too large")
        return [read_value(self.value_coder, br) for _ in range(n)]


class Array:
    """Fixed-count array of values."""

    __slots__ = ("count", "value_coder")

    def __init__(self, count: int, value_coder):
        self.count = count
        self.value_coder = value_coder

    def read(self, br: BitReader):
        return [read_value(self.value_coder, br) for _ in range(self.count)]


class Extensions:
    """Extension block: u64 selector bitmap + per-bit u64 sizes, skipped.

    ref: headers/encodings.rs:380-408.
    """

    def read(self, br: BitReader):
        selector = U64().read(br)
        total = 0
        for i in range(64):
            if selector & (1 << i):
                total += U64().read(br)
        if total > (1 << 40):
            raise SizeOverflow("extensions too large")
        br.skip_bits(total)
        return {}


def read_value(coder, br: BitReader, nonserialized=None):
    """Read one value with `coder`; bundle classes read recursively."""
    if isinstance(coder, type) and hasattr(coder, "read_bundle"):
        return coder.read_bundle(br, nonserialized)
    return coder.read(br)


# -- field descriptors + @bundle ----------------------------------------------


@dataclasses.dataclass
class _FieldSpec:
    coder: Any
    condition: Optional[Callable] = None
    default: Any = None
    nonserialized: bool = False  # supplied by caller, never read from stream
    name: str = ""


def field(coder, *, condition=None, default=None):
    return _FieldSpec(coder=coder, condition=condition, default=default)


def nonserialized(default=None):
    return _FieldSpec(coder=None, nonserialized=True, default=default)


def _resolve(v, obj, ns):
    return v(obj, ns) if callable(v) else v


def bundle(cls):
    """Class decorator generating `read_bundle(br, nonserialized=None)`.

    Fields are read in declaration order. `all_default` (if present and
    True) stops reading and leaves every remaining field at its default.
    """
    specs = []
    for name, value in list(cls.__dict__.items()):
        if isinstance(value, _FieldSpec):
            value.name = name
            specs.append(value)
            setattr(cls, name, None)
    cls._bundle_fields = specs

    def read_bundle(br: BitReader, ns=None):
        obj = cls.__new__(cls)
        defaulting = False
        for spec in specs:
            if spec.nonserialized:
                setattr(obj, spec.name, _resolve(spec.default, obj, ns))
                continue
            cond_ok = True
            if spec.condition is not None:
                cond_ok = spec.condition(obj, ns)
            if defaulting or not cond_ok:
                setattr(obj, spec.name, _resolve(spec.default, obj, ns))
            else:
                c = spec.coder
                if isinstance(c, type) and hasattr(c, "read_bundle"):
                    coder = c
                elif callable(c) and not hasattr(c, "read"):
                    coder = c(obj, ns)  # coder depends on earlier fields
                else:
                    coder = c
                setattr(obj, spec.name, read_value(coder, br, ns))
            if spec.name == "all_default" and getattr(obj, "all_default"):
                defaulting = True
        if hasattr(obj, "check"):
            obj.check(ns)
        return obj

    cls.read_bundle = staticmethod(read_bundle)

    def _repr(self):
        parts = ", ".join(f"{s.name}={getattr(self, s.name)!r}" for s in specs)
        return f"{cls.__name__}({parts})"

    if "__repr__" not in cls.__dict__:
        cls.__repr__ = _repr
    return cls
