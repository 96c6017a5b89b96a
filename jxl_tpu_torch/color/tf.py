"""Transfer functions on torch tensors: sRGB, BT.709, PQ, HLG, gamma
(precise variants).

Capability reference: jxl/src/color/tf.rs. Same operation order as the
JAX package's numpy version; scalars are float32-rounded before they
enter an op. PQ runs in float64, as the numpy reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..render.stages.core import f32


def linear_to_srgb(v):
    a = v.abs()
    out = torch.where(
        a <= f32(0.0031308),
        a * f32(12.92),
        f32(1.055) * torch.pow(a, f32(1.0 / 2.4)) - f32(0.055),
    )
    return torch.copysign(out, v)


def srgb_to_linear(v):
    a = v.abs()
    out = torch.where(
        a <= f32(0.04045),
        a / f32(12.92),
        torch.pow((a + f32(0.055)) / f32(1.055), f32(2.4)),
    )
    return torch.copysign(out, v)


def linear_to_bt709(v):
    a = v.abs()
    out = torch.where(
        a < f32(0.018053968510807),
        a * f32(4.5),
        f32(1.09929682680944) * torch.pow(a, f32(0.45)) - f32(0.09929682680944),
    )
    return torch.copysign(out, v)


def linear_to_gamma(v, g: float):
    return torch.copysign(torch.pow(v.abs(), f32(g)), v)


# -- PQ (SMPTE ST 2084) ---------------------------------------------------

_PQ_M1 = 2610.0 / 16384
_PQ_M2 = (2523.0 / 4096) * 128
_PQ_C1 = 3424.0 / 4096
_PQ_C2 = (2413.0 / 4096) * 32
_PQ_C3 = (2392.0 / 4096) * 32


def linear_to_pq(v, intensity_target: float):
    # 1.0 == intensity_target nits; PQ encodes absolute 10000-nit range
    a = v.abs().double() * (intensity_target / 10000.0)
    ym = torch.pow(a, _PQ_M1)
    out = torch.pow((_PQ_C1 + _PQ_C2 * ym) / (1.0 + _PQ_C3 * ym), _PQ_M2)
    return torch.copysign(out, v.double()).float()


def pq_to_linear(v, intensity_target: float):
    a = v.abs().double()
    vp = torch.pow(a, 1.0 / _PQ_M2)
    num = (vp - _PQ_C1).clamp_min(0.0)
    out = torch.pow(num / (_PQ_C2 - _PQ_C3 * vp), 1.0 / _PQ_M1)
    return torch.copysign(out * (10000.0 / intensity_target), v.double()).float()


# -- HLG (ARIB STD-B67) ------------------------------------------------------

_HLG_A = 0.17883277
_HLG_B = 1.0 - 4.0 * _HLG_A
_HLG_C = 0.5 - _HLG_A * np.log(4.0 * _HLG_A)


def scene_to_hlg(v):
    a = v.abs()
    out = torch.where(
        a <= f32(1.0 / 12.0),
        torch.sqrt(f32(3.0) * a),
        f32(_HLG_A) * torch.log((f32(12.0) * a - f32(_HLG_B)).clamp_min(1e-30))
        + f32(_HLG_C),
    )
    return torch.copysign(out, v)


def hlg_to_scene(v):
    a = v.abs()
    out = torch.where(
        a <= 0.5,
        a * a / f32(3.0),
        (torch.exp((a - f32(_HLG_C)) / f32(_HLG_A)) + f32(_HLG_B)) / f32(12.0),
    )
    return torch.copysign(out, v)


def hlg_display_to_scene(intensity_target: float, luminances, rows):
    """Inverse HLG OOTF: display-light -> scene-light (ref tf.rs)."""
    gamma = 1.2 * 1.111 ** np.log2(intensity_target / 1000.0)
    exp = f32((1.0 - gamma) / gamma)
    r, g, b = rows
    lum = f32(luminances[0]) * r + f32(luminances[1]) * g + f32(luminances[2]) * b
    mul = torch.where(lum > f32(1e-10), torch.pow(lum.abs(), exp), torch.zeros_like(lum))
    return (r * mul, g * mul, b * mul)
