"""Hybrid-uint token coding: token -> (prefix, direct bits) integer.

Capability reference: jxl/src/entropy_coding/hybrid_uint.rs (spec C.3.3).
Config (split_exponent, msb_in_token, lsb_in_token); tokens below
split = value; above: token encodes msb/lsb bits and a bit count.
"""

from __future__ import annotations

from ..errors import InvalidBitstream, InvalidUintConfig
from ..io.bit_reader import BitReader


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


class HybridUint:
    __slots__ = ("split_token", "split_exponent", "msb_in_token", "lsb_in_token")

    def __init__(self, split_exponent: int, msb_in_token: int, lsb_in_token: int):
        self.split_exponent = split_exponent
        self.split_token = 1 << split_exponent
        self.msb_in_token = msb_in_token
        self.lsb_in_token = lsb_in_token

    @staticmethod
    def decode(log_alpha_size: int, br: BitReader) -> "HybridUint":
        split_exponent = br.read(_ceil_log2(log_alpha_size + 1))
        if split_exponent != log_alpha_size:
            nbits = _ceil_log2(split_exponent + 1)
            msb_in_token = br.read(nbits)
            if msb_in_token > split_exponent:
                raise InvalidUintConfig("invalid hybrid-uint config (msb)")
            nbits = _ceil_log2(split_exponent - msb_in_token + 1)
            lsb_in_token = br.read(nbits)
        else:
            msb_in_token = 0
            lsb_in_token = 0
        if lsb_in_token + msb_in_token > split_exponent:
            raise InvalidUintConfig("invalid hybrid-uint config (lsb+msb)")
        return HybridUint(split_exponent, msb_in_token, lsb_in_token)

    def read(self, token: int, br: BitReader) -> int:
        if token < self.split_token:
            return token
        bits_in_token = self.lsb_in_token + self.msb_in_token
        nbits = (
            self.split_exponent
            - bits_in_token
            + ((token - self.split_token) >> bits_in_token)
        )
        # invalid streams can request >=32 bits; mask like the format requires
        nbits &= 31
        low = token & ((1 << self.lsb_in_token) - 1)
        token_nolow = token >> self.lsb_in_token
        bits = br.read_opt(nbits)
        hi = (token_nolow & ((1 << self.msb_in_token) - 1)) | (1 << self.msb_in_token)
        # u32 wrapping semantics (matters for >=32-significant-bit samples)
        return ((((hi << nbits) | bits) << self.lsb_in_token) | low) & 0xFFFFFFFF

    @property
    def is_config_420(self) -> bool:
        return (
            self.split_exponent == 4 and self.msb_in_token == 2 and self.lsb_in_token == 0
        )

    @property
    def is_split_exponent_zero(self) -> bool:
        return self.split_exponent == 0
