"""Output color info for XYB-encoded frames.

Capability reference: jxl/src/render/stages/xyb.rs:20-146 OutputColorInfo.
The XYB stage always produces *linear sRGB-primaries* RGB; when the image's
nominal color space uses different primaries / white point (e.g. Display-P3,
BT.2100) or is grayscale, the conversion is folded into the opsin inverse
matrix, and the per-primary luminances (needed by HLG) are recomputed.
Images whose color is described only by an embedded ICC profile render to
sRGB (the CLI/CMS converts onward, ref jxl_cli/src/dec/mod.rs:431).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.headers import ColorSpace, Primaries, TransferFunction, WhitePoint
from .icc_synth import (
    adapt_to_xyz_d50,
    primaries_to_xyz,
    primaries_to_xyz_d50,
    primaries_xy,
    white_point_xy,
)

SRGB_LUMINANCES = (0.2126, 0.7152, 0.0722)
_SRGB_PRIMS = [(0.6399987, 0.33001015), (0.3000038, 0.60000336), (0.15000205, 0.059997204)]
_D65 = (0.3127, 0.3290)


@dataclass(frozen=True)
class OutputColorInfo:
    luminances: tuple  # (3,) luminance of each output primary
    intensity_target: float
    matrix: tuple  # 9 floats: (possibly primaries-adjusted) opsin inverse
    tf: tuple  # ("enum", TransferFunction) | ("gamma", float)


def output_color_info(file_header) -> OutputColorInfo:
    """Mirror of OutputColorInfo::from_header (ref xyb.rs:65-146)."""
    meta = file_header.image_metadata
    ce = meta.color_encoding
    opsin = file_header.transform_data.opsin_inverse_matrix
    it = float(meta.tone_mapping.intensity_target)
    base = np.array(opsin.inverse_matrix, dtype=np.float64).reshape(3, 3)

    def srgb_output():
        return OutputColorInfo(
            SRGB_LUMINANCES,
            it,
            tuple(float(v) for v in base.reshape(-1)),
            ("enum", TransferFunction.SRGB),
        )

    if ce.want_icc or ce.color_space == ColorSpace.XYB:
        return srgb_output()

    luminances = SRGB_LUMINANCES
    matrix = base
    if ce.color_space == ColorSpace.GRAY:
        lum = np.array(SRGB_LUMINANCES, dtype=np.float64)
        srgb_to_luminance = np.stack([lum, lum, lum])
        matrix = srgb_to_luminance @ base
    else:  # RGB (UNKNOWN color spaces keep sRGB primaries)
        prims = primaries_xy(ce)
        w = white_point_xy(ce)
        if (
            ce.color_space == ColorSpace.RGB
            and (ce.primaries != Primaries.SRGB or ce.white_point != WhitePoint.D65)
        ):
            srgb_to_xyzd50 = primaries_to_xyz_d50(_SRGB_PRIMS, *_D65)
            original_to_xyz = primaries_to_xyz(prims, *w)
            luminances = tuple(float(v) for v in original_to_xyz[1])
            adapt = adapt_to_xyz_d50(*w)
            original_to_xyzd50 = adapt @ original_to_xyz
            srgb_to_original = np.linalg.inv(original_to_xyzd50) @ srgb_to_xyzd50
            matrix = srgb_to_original @ base

    if ce.tf.have_gamma:
        tf = ("gamma", float(ce.tf.gamma_value()))
    else:
        tf = ("enum", ce.tf.transfer_function)
    return OutputColorInfo(
        tuple(float(v) for v in luminances),
        it,
        tuple(float(v) for v in matrix.reshape(-1)),
        tf,
    )
