"""Film-grain (photon) noise synthesis.

Counterpart of jxl_tpu/features/noise.py. Capability reference:
jxl/src/features/noise.rs, util/xorshift128plus.rs, render/stages/noise.rs,
frame/decode.rs:585-695. The xorshift128+ random field is made on the host
by the native library (native/filters.cc, bit-exact: 8-lane generator,
split-mix seeding, one seed a group's upsampling subregion), into a pinned
buffer when it is bound for the card; the 5x5 convolution and the
strength-LUT modulated add run as torch ops on the planes' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.bit_reader import BitReader
from ..render.stages.core import _pad_mirror, f32, to_device

_M64 = (1 << 64) - 1


class Noise:
    def __init__(self, lut=None):
        self.lut = lut if lut is not None else [0.0] * 8

    @staticmethod
    def read(br: BitReader) -> "Noise":
        return Noise([br.read(10) / 1024.0 for _ in range(8)])

    def strength(self, vx):
        """Piecewise-linear 8-point LUT (ref noise.rs:20-39) on a tensor."""
        k_scale = f32(len(self.lut) - 2)
        scaled = torch.clamp_min(vx * k_scale, 0.0)
        floor = torch.floor(scaled)
        frac = scaled - floor
        big = scaled >= k_scale + 1.0
        floor = torch.where(big, torch.full_like(floor, k_scale), floor)
        frac = torch.where(big, torch.ones_like(frac), frac)
        idx = torch.clamp_max(floor.to(torch.int64), len(self.lut) - 2)
        lut = to_device(np.asarray(self.lut, dtype=np.float32), vx.device)
        low = lut[idx]
        hi = lut[idx + 1]
        return torch.clamp((hi - low) * frac + low, 0.0, 1.0)


class Xorshift128Plus:
    """8-lane xorshift128+ with split-mix seeding (bit-exact with the
    reference); the plain Python generator the native field is held to."""

    N = 8

    @staticmethod
    def _split_mix(z: int) -> int:
        z &= _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        return (z ^ (z >> 31)) & _M64

    def __init__(self, seed1: int, seed2: int, seed3: int, seed4: int):
        s0 = [0] * self.N
        s1 = [0] * self.N
        s0[0] = self._split_mix((((seed1 << 32) + seed2) + 0x9E3779B97F4A7C15) & _M64)
        s1[0] = self._split_mix((((seed3 << 32) + seed4) + 0x9E3779B97F4A7C15) & _M64)
        for i in range(1, self.N):
            s0[i] = self._split_mix(s0[i - 1])
            s1[i] = self._split_mix(s1[i - 1])
        self.s0 = np.array(s0, dtype=np.uint64)
        self.s1 = np.array(s1, dtype=np.uint64)

    def fill(self) -> np.ndarray:
        """Returns 8 u64 of random bits, advancing the state."""
        new_s1 = self.s0.copy()
        self.s0 = self.s1.copy()
        bits = new_s1 + self.s0
        new_s1 = new_s1 ^ (new_s1 << np.uint64(23))
        new_s1 = new_s1 ^ self.s0 ^ (new_s1 >> np.uint64(18)) ^ (self.s0 >> np.uint64(5))
        self.s1 = new_s1
        return bits


def bits_to_float(bits_u32: np.ndarray) -> np.ndarray:
    """Random bits -> floats in [1, 2) (the generator's 23 high bits)."""
    return ((bits_u32 >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)


def generate_noise_field(frame, pin_memory: bool = False) -> torch.Tensor:
    """The whole-image (3, hu, wu) float32 random field on the host,
    seeded per group and upsampling subregion from the frame counters
    (ref frame/decode.rs:585-695; each row draws ceil((width + 2) / 16)
    batches, as libjxl does). pin_memory: make it in page-locked memory,
    for an asynchronous upload."""
    from .. import native

    hu, wu, *geo = _field_geometry(frame)
    field = torch.empty((3, hu, wu), dtype=torch.float32, pin_memory=pin_memory)
    native.noise_field_native(field.numpy(), *geo)
    return field


def _field_geometry(frame) -> tuple:
    """(hu, wu, upsampling, group_dim, gx_count, gy_count, vfi, nfi) of the
    frame's noise field."""
    header = frame.header
    wu, hu = header.size_upsampled()
    gx_count, gy_count = header.size_groups()
    vfi = frame.decoder_state.visible_frame_index if frame.decoder_state else 1
    nfi = frame.decoder_state.nonvisible_frame_index if frame.decoder_state else 0
    return hu, wu, header.upsampling, header.group_dim, gx_count, gy_count, vfi, nfi


def generate_noise_field_rows(frame, y_lo: int, y_hi: int, pin_memory: bool = False):
    """Rows [y_lo, y_hi) (clipped to the field) of the whole-image noise
    field, a (3, rows, wu) float32 tensor on the host, bit for bit the same
    rows of generate_noise_field (ref jxl_tpu/features/noise.py:163). The
    generator is seeded a subregion, so only the subregions that meet the
    rows run, and the draws of a subregion's rows before y_lo are made and
    dropped (native filters.cc jxl_noise_field_rows). The banded decode
    (api/banded.py) takes a band and the convolution's 2-row margin."""
    from .. import native

    hu, wu, *geo = _field_geometry(frame)
    y_lo, y_hi = max(0, y_lo), min(hu, y_hi)
    field = torch.empty((3, max(y_hi - y_lo, 0), wu), dtype=torch.float32,
                        pin_memory=pin_memory)
    native.noise_field_rows_native(field.numpy(), hu, wu, *geo, y_lo, y_hi)
    return field


def generate_noise_field_rows_reference(frame, y_lo: int, y_hi: int) -> np.ndarray:
    """The plain version of generate_noise_field_rows: the Python loop of
    jxl_tpu/features/noise.py:185-274 over Xorshift128Plus, (3, rows, wu)
    float32 numpy."""
    hu, wu, up, group_dim, gx_count, gy_count, vfi, nfi = _field_geometry(frame)
    y_lo, y_hi = max(0, y_lo), min(hu, y_hi)
    bufs = np.zeros((3, max(y_hi - y_lo, 0), wu), dtype=np.float32)
    per_batch = 16
    for gy in range(gy_count):
        gby0 = gy * up * group_dim
        gby1 = min((gy + 1) * up * group_dim, hu)
        if gby1 <= y_lo or gby0 >= y_hi:
            continue
        for gx in range(gx_count):
            bx0 = gx * up * group_dim
            buf_xsize = min((gx + 1) * up * group_dim, wu) - bx0
            for iy in range(up):
                for ix in range(up):
                    sx0, sy0 = ix * group_dim, iy * group_dim
                    sub_xsize = min((ix + 1) * group_dim, buf_xsize) - sx0
                    sub_ysize = min((iy + 1) * group_dim, gby1 - gby0) - sy0
                    if sub_xsize <= 0 or sub_ysize <= 0:
                        continue
                    abs0 = gby0 + sy0
                    if abs0 >= y_hi or abs0 + sub_ysize <= y_lo:
                        continue
                    rng = Xorshift128Plus(vfi, nfi, (gx * up + ix) * group_dim,
                                          (gy * up + iy) * group_dim)
                    nbatch = -(-(sub_xsize + 2) // per_batch)
                    for c in range(3):
                        for y in range(sub_ysize):
                            abs_y = abs0 + y
                            if abs_y >= y_hi and c == 2:
                                break
                            want = y_lo <= abs_y < y_hi
                            for b in range(nbatch):
                                bits64 = rng.fill()
                                take = min(per_batch, sub_xsize - b * per_batch)
                                if not want or take <= 0:
                                    continue
                                u32 = np.empty(16, dtype=np.uint32)
                                u32[0::2] = (bits64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                                u32[1::2] = (bits64 >> np.uint64(32)).astype(np.uint32)
                                xoff = bx0 + sx0 + b * per_batch
                                bufs[c, abs_y - y_lo, xoff : xoff + take] = bits_to_float(
                                    u32[:take])
    return bufs


def convolve_noise(plane):
    """5x5 sum*0.16 + center*(-3.84) (ref stages/noise.rs ConvolveNoise)."""
    p = _pad_mirror(plane, 2, 2)
    h, w = plane.shape
    total = None
    for dy in range(5):
        for dx in range(5):
            v = p[dy : dy + h, dx : dx + w]
            total = v if total is None else total + v
    center = p[2 : 2 + h, 2 : 2 + w]
    return (total - center) * f32(0.16) + center * f32(-3.84)


def add_noise(planes, noise_planes, noise: Noise, ccp):
    """ref stages/noise.rs AddNoiseStage: the convolved field, scaled by
    the LUT strength of the local intensity, added to X, Y and B in XYB.
    ccp: the frame's colour correlation (its LF Y-to-X and Y-to-B), or
    None for 0 and 1."""
    if all(v == 0.0 for v in noise.lut):
        return planes
    norm_const = f32(0.22)
    ytox = f32(ccp.y_to_x_lf if ccp else 0.0)
    ytob = f32(ccp.y_to_b_lf if ccp else 1.0)
    vx, vy, vb = planes[0], planes[1], planes[2]
    rnd_r, rnd_g, rnd_c = noise_planes
    in_g = vy - vx
    in_r = vy + vx
    sg = noise.strength(in_g * f32(0.5))
    sr = noise.strength(in_r * f32(0.5))
    ar = rnd_r * norm_const
    ag = rnd_g * norm_const
    ac = rnd_c * norm_const
    k_rg = f32(0.9921875)
    k_rgn = f32(0.0078125)
    red_noise = sr * (k_rgn * ar + k_rg * ac)
    green_noise = sg * (k_rgn * ag + k_rg * ac)
    rg = red_noise + green_noise
    return [
        vx + ytox * rg + red_noise - green_noise,
        vy + rg,
        vb + ytob * rg,
    ]
