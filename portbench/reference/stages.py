"""The render stages after the planes, in plain torch: gaborish, the edge
preserving filter (EPF), XYB to linear sRGB, the sRGB transfer curve and
the dithered 8-bit output, each as ISO/IEC 18181-1 and libjxl's render
stages (jxl/src/render/stages/) define it, with the format's default
restoration filter and opsin. A frozen copy, as of the first benchmark, of
the decoder package's plain stage bodies; scalars enter an op rounded to
float32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BLOCK_DIM = 8
MIN_SIGMA = -3.90524291751269967465540850526868
INV_SIGMA_NUM = -1.1715728752538099024
# the default restoration filter
GAB_WEIGHTS = (0.115169525, 0.061248592)
EPF_SHARP_LUT = [0.0, 1 / 7, 2 / 7, 3 / 7, 4 / 7, 5 / 7, 6 / 7, 1.0]
EPF_CHANNEL_SCALE = (40.0, 5.0, 3.5)
EPF_QUANT_MUL = 0.46
EPF_PASS0_SIGMA_SCALE = 0.9
EPF_PASS2_SIGMA_SCALE = 6.5
EPF_BORDER_SAD_MUL = 2.0 / 3.0
# the default opsin inverse matrix and biases
OPSIN_INVERSE_MATRIX = (
    11.031566901960783, -9.866943921568629, -0.16462299647058826,
    -3.254147380392157, 4.418770392156863, -0.16462299647058826,
    -3.6588512862745097, 2.7129230470588235, 1.9459282392156863,
)
OPSIN_BIASES = (-0.0037930732552754493,) * 3
QUANT_BIASES = (1.0 - 0.05465007330715401, 1.0 - 0.07005449891748593,
                1.0 - 0.049935103337343655, 0.145)
DITHER = np.load(os.path.join(os.path.dirname(__file__), "dither_table.npy"))


def f32(x: float) -> float:
    return float(np.float32(x))


def _mirror_index(n: int, b: int, device):
    i = torch.arange(-b, n + b, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def pad_mirror(plane, b: int):
    """Mirror padding with the edge sample repeated, b on every side."""
    h, w = plane.shape[-2:]
    plane = plane.index_select(-2, _mirror_index(h, b, plane.device))
    return plane.index_select(-1, _mirror_index(w, b, plane.device))


def gaborish(plane):
    """The 3x3 self-normalized blur."""
    w1, w2 = GAB_WEIGHTS
    total = 1.0 + w1 * 4.0 + w2 * 4.0
    c0, c1, c2 = f32(1.0 / total), f32(w1 / total), f32(w2 / total)
    p = pad_mirror(plane, 1)
    c = p[1:-1, 1:-1]
    side = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    corner = p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]
    return c * c0 + side * c1 + corner * c2


_PLUS5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_EPF0_NEIGHBORS = ((-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
                   (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0))
_EPF1_NEIGHBORS = ((-1, 0), (0, -1), (0, 1), (1, 0))


def inv_sigma_blocks(raw_quant, epf, global_scale: int):
    """The per-block stored 1/sigma (bh, bw) float32 of a VarDCT frame from
    its raw quant field and EPF sharpness."""
    quant_scale = 1.0 / ((1 << 16) / global_scale)
    rq = np.asarray(raw_quant, np.float32)
    sigma_quant = EPF_QUANT_MUL / (quant_scale * rq * INV_SIGMA_NUM)
    sigma = sigma_quant * np.array(EPF_SHARP_LUT, dtype=np.float32)[np.asarray(epf)]
    return (1.0 / np.minimum(sigma, -1e-4)).astype(np.float32)


def epf_step(planes, inv_sigma_px, step: int):
    """EPF iteration `step` (0, 1 or 2) over the three planes with a
    per-pixel stored 1/sigma."""
    if step == 0:
        scale, neighbors, pattern, border = EPF_PASS0_SIGMA_SCALE, _EPF0_NEIGHBORS, _PLUS5, 3
    elif step == 1:
        scale, neighbors, pattern, border = 1.0, _EPF1_NEIGHBORS, _PLUS5, 2
    else:
        scale, neighbors, pattern, border = EPF_PASS2_SIGMA_SCALE, _EPF1_NEIGHBORS, ((0, 0),), 1
    sm = scale * 1.65
    bsm = sm * EPF_BORDER_SAD_MUL
    h, w = planes[0].shape
    dev = planes[0].device
    ys = torch.arange(h, device=dev) % BLOCK_DIM
    xs = torch.arange(w, device=dev) % BLOCK_DIM
    on_border = (((ys == 0) | (ys == BLOCK_DIM - 1))[:, None]
                 | ((xs == 0) | (xs == BLOCK_DIM - 1))[None, :])
    sad_mul = torch.where(on_border, torch.tensor(f32(bsm), device=dev),
                          torch.tensor(f32(sm), device=dev))
    padded = [pad_mirror(p, border) for p in planes]

    def at(p, dy, dx):
        return p[border + dy : border + dy + h, border + dx : border + dx + w]

    inv_sigma = inv_sigma_px * sad_mul
    r = max(max(abs(py), abs(px)) for (py, px) in pattern)
    weights = []
    for (ny, nx) in neighbors:
        sad = None
        for c, p in enumerate(padded):
            a = p[border - r : border + r + h, border - r : border + r + w]
            b = p[border - r + ny : border + r + ny + h, border - r + nx : border + r + nx + w]
            diff = (a - b).abs()
            s = None
            for (py, px) in pattern:
                d = diff[r + py : r + py + h, r + px : r + px + w]
                s = d if s is None else s + d
            term = s * f32(EPF_CHANNEL_SCALE[c])
            sad = term if sad is None else sad + term
        weights.append((sad * inv_sigma + 1.0).clamp_min(0.0))
    total = weights[0]
    for wgt in weights[1:]:
        total = total + wgt
    wsum = total + 1.0
    passthrough = inv_sigma_px < f32(MIN_SIGMA)
    out = []
    for p in padded:
        acc = at(p, 0, 0)
        for wgt, (ny, nx) in zip(weights, neighbors):
            acc = acc + wgt * at(p, ny, nx)
        out.append(torch.where(passthrough, at(p, 0, 0), acc / wsum))
    return out


def xyb_to_linear(x, y, b, dtype=torch.float32):
    """Linear sRGB (1.0 = 255 nits) from XYB with the default opsin, in
    `dtype` (float32; a lower precision for a control)."""
    mat = np.array(OPSIN_INVERSE_MATRIX, dtype=np.float32).tolist()
    biases = np.array(OPSIN_BIASES, dtype=np.float32)
    bias_cbrt = np.cbrt(biases).astype(np.float32).tolist()
    scaled_bias = biases.tolist()
    x, y, b = (v.to(dtype) for v in (x, y, b))
    lo = y + x - bias_cbrt[0]
    mid = y - x - bias_cbrt[1]
    s = b - bias_cbrt[2]
    lo = lo * lo * lo + scaled_bias[0]
    mid = mid * mid * mid + scaled_bias[1]
    s = s * s * s + scaled_bias[2]
    out = [mat[3 * i] * lo + mat[3 * i + 1] * mid + mat[3 * i + 2] * s for i in range(3)]
    return [o.to(torch.float32) for o in out]


def linear_to_srgb(v):
    a = v.abs()
    out = torch.where(a <= f32(0.0031308), a * f32(12.92),
                      f32(1.055) * torch.pow(a, f32(1.0 / 2.4)) - f32(0.055))
    return torch.copysign(out, v)


def to_u8_unrounded(plane, channel: int):
    """The 8-bit output before its rounding: scaled to 0-255, the 32x32
    blue-noise dither added at the channel's offset, clamped. The output
    is this rounded half to even."""
    h, w = plane.shape
    dev = plane.device
    tab = torch.from_numpy(DITHER.reshape(-1)).to(dev)
    ys = (torch.arange(h, device=dev) + 13 * channel) % 32
    xs = (torch.arange(w, device=dev) + 23 * channel) % 32
    return (plane * f32(255.0) + tab[ys[:, None] * 32 + xs[None, :]]).clamp(0.0, f32(255.0))


def xyb_to_output(planes, width: int, height: int, dtype=torch.float32):
    """(height, width, 3) float32: the sRGB 8-bit output of three XYB
    planes, cropped, before its rounding (to_u8_unrounded)."""
    planes = [p[:height, :width] for p in planes]
    rgb = xyb_to_linear(*planes, dtype=dtype)
    return torch.stack([to_u8_unrounded(linear_to_srgb(c), i) for i, c in enumerate(rgb)],
                       dim=-1)

