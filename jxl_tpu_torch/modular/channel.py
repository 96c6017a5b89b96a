"""Modular image channels: numpy-backed int32 planes with shift metadata.

Capability reference: jxl/src/frame/modular/buffers.rs + ChannelInfo in
modular/mod.rs. Channels carry a (hshift, vshift) downsampling shift
(None for meta-channels such as palettes) and a bit depth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ChannelInfo:
    size: Tuple[int, int]  # (width, height)
    shift: Optional[Tuple[int, int]]  # None for meta channels
    bit_depth_bits: int = 8
    output_channel_idx: Optional[int] = None

    @property
    def is_meta(self) -> bool:
        return self.shift is None

    def is_meta_or_small(self, group_dim: int) -> bool:
        return self.is_meta or (self.size[0] <= group_dim and self.size[1] <= group_dim)

    def is_shift_in_range(self, lo: int, hi: int) -> bool:
        if self.shift is None:
            return False
        s = min(self.shift)
        return lo <= s <= hi

    def is_equivalent(self, other: "ChannelInfo") -> bool:
        return (
            self.size == other.size
            and self.shift == other.shift
            and self.bit_depth_bits == other.bit_depth_bits
        )


class ModularChannel:
    """A decoded (or being-decoded) channel plane. data is (h, w) int32."""

    __slots__ = ("data", "shift", "bit_depth_bits")

    def __init__(self, size, shift, bit_depth_bits=8, data=None):
        w, h = size
        self.data = data if data is not None else np.zeros((h, w), dtype=np.int32)
        self.shift = shift
        self.bit_depth_bits = bit_depth_bits

    @property
    def size(self):
        return (self.data.shape[1], self.data.shape[0])

    def view(self, x0, y0, w, h) -> "ModularChannel":
        """A mutable rectangular view (used for per-group decode)."""
        c = ModularChannel.__new__(ModularChannel)
        c.data = self.data[y0 : y0 + h, x0 : x0 + w]
        c.shift = self.shift
        c.bit_depth_bits = self.bit_depth_bits
        return c

    def channel_info(self) -> ChannelInfo:
        return ChannelInfo(self.size, self.shift, self.bit_depth_bits)
