"""XYB -> linear RGB conversion on torch tensors.

Capability reference: jxl/src/render/stages/xyb.rs + api/xyb_constants.rs.
Same operation order as the JAX package's numpy/jnp version; scalars are
float32-rounded before they enter an op.
"""

from __future__ import annotations

import numpy as np

from ..render.stages.core import f32

SRGB_LUMINANCES = (0.2126, 0.7152, 0.0722)


def xyb_to_linear(
    x,
    y,
    b,
    opsin,  # OpsinInverseMatrix header
    intensity_target: float = 255.0,
    matrix=None,  # override: primaries-adjusted inverse matrix (9 floats)
):
    """Returns (r, g, b) linear, 1.0 == intensity_target nits."""
    mat = np.array(
        opsin.inverse_matrix if matrix is None else matrix, dtype=np.float32
    ).tolist()
    biases = np.array(opsin.opsin_biases, dtype=np.float32)
    bias_cbrt = np.cbrt(biases).astype(np.float32).tolist()
    intensity_scale = np.float32(255.0 / intensity_target)
    scaled_bias = (biases * intensity_scale).tolist()
    intensity_scale = float(intensity_scale)

    l = y + x - bias_cbrt[0]
    m = y - x - bias_cbrt[1]
    s = b - bias_cbrt[2]
    l = l * l * (l * intensity_scale) + scaled_bias[0]
    m = m * m * (m * intensity_scale) + scaled_bias[1]
    s = s * s * (s * intensity_scale) + scaled_bias[2]

    r_out = mat[0] * l + mat[1] * m + mat[2] * s
    g_out = mat[3] * l + mat[4] * m + mat[5] * s
    b_out = mat[6] * l + mat[7] * m + mat[8] * s
    return r_out, g_out, b_out


def ycbcr_to_rgb(y, cb, cr):
    """JXL YCbCr (zero-centered) -> RGB (ref stages/ycbcr.rs): the Y offset
    is 128/255 (8-bit midpoint), not 1/2."""
    yp = y + f32(128.0 / 255.0)
    r = f32(1.402) * cr + yp
    g = yp - f32(0.344136) * cb - f32(0.714136) * cr
    b = f32(1.772) * cb + yp
    return r, g, b
