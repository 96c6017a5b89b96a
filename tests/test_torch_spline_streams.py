"""Spline test streams, and checks that the JAX package reads them back.

`encode_splines(splines, quant_adjust)` writes the LfGlobal spline bundle
(ref spline.rs:826-889; features/splines.py:Splines.read) as a bit array:
flat rANS histograms over the bundle's six contexts in two clusters, then
the number of splines, each spline's starting point (the first absolute,
the others as signed offsets from the one before), the quantization
adjustment, and per spline its control-point count, its control points as
second differences, and its 3 x 32 colour and 32 sigma DCT coefficients.
`random_splines` draws splines across a frame: 8-16 control points a
spline, a brush of sigma 1-4 px, colours that show in XYB.
`encode_xyb_vardct(..., splines=...)` puts the bundle in its frame
(ENABLE_SPLINES).

This module imports neither jax nor jxl_tpu at the top: chip_smoke.py
imports the writer. The tests below import the JAX package inside each
test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pytest

from test_torch_vardct_streams import (BitList, _signed_token, bitlist_bits, encode_xyb_vardct,
                                       hybrid_tokens, write_ans_flat_histograms, write_rans_stream)

# contexts of the bundle (ref spline.rs): quantization adjustment,
# starting position, spline count, control-point count, control point,
# DCT coefficient; positions and control points in cluster 1
_CMAP = [0, 1, 0, 0, 1, 0]
_ALPHABETS = (32, 64)
_UINT = ((4, 0, 0), (4, 1, 0))
# the sigma DCT's DC coefficient of a brush of sigma 1 px: sigma is the
# coefficient times its channel weight 0.3333
SIGMA_DC_PER_PX = 3


@dataclass
class SplineSpec:
    """One spline: its control points, absolute integer (x, y) pairs (the
    first is its starting point), and its quantized DCT coefficients:
    colour (3 rows of 32, X, Y, B) and sigma (32)."""

    points: list
    color_dct: list
    sigma_dct: list


def encode_splines(splines, quant_adjust: int = 0) -> np.ndarray:
    """The LfGlobal spline bundle of `splines` (SplineSpec list) with the
    quantization adjustment `quant_adjust`: a uint8 array of 0/1 bits,
    LSB first."""
    toks = [(2, len(splines) - 1)]
    last = (0, 0)
    for i, sp in enumerate(splines):
        x, y = sp.points[0]
        if i == 0:
            toks += [(1, x), (1, y)]
        else:
            toks += [(1, int(_signed_token(x - last[0]))), (1, int(_signed_token(y - last[1])))]
        last = (x, y)
    toks.append((0, int(_signed_token(quant_adjust))))
    for sp in splines:
        pts = np.asarray(sp.points, np.int64)
        d = np.diff(pts, axis=0)
        dd = np.diff(np.concatenate([np.zeros((1, 2), np.int64), d]), axis=0)
        toks.append((3, len(dd)))
        for ddx, ddy in dd.tolist():
            toks += [(4, int(_signed_token(ddx))), (4, int(_signed_token(ddy)))]
        for v in np.concatenate([np.asarray(sp.color_dct).reshape(-1),
                                 np.asarray(sp.sigma_dct)]).tolist():
            toks.append((5, int(_signed_token(v))))
    w = BitList()
    write_ans_flat_histograms(w, _CMAP, _ALPHABETS, _UINT)
    cl = np.array(_CMAP)[np.array([c for c, _ in toks])]
    tk, raw, nraw = hybrid_tokens([v for _, v in toks], cl, _UINT, _ALPHABETS)
    write_rans_stream(w, tk, cl, raw, nraw, _ALPHABETS)
    return bitlist_bits(w)


def random_splines(rng, width: int, height: int, count: int, points=(8, 16), sigma=(1, 4),
                   step: int = 24) -> list:
    """`count` SplineSpecs inside a width x height frame: each a walk of
    `points` (inclusive range) control points, steps of up to `step` px
    that never stay put, a brush of sigma in the inclusive range `sigma`
    px (its sigma DC) and a colour of a low-frequency X, Y and B."""
    out = []
    for _ in range(count):
        n = int(rng.integers(points[0], points[1] + 1))
        p = [(int(rng.integers(step, width - step)), int(rng.integers(step, height - step)))]
        while len(p) < n:
            dx, dy = (int(v) for v in rng.integers(-step, step + 1, 2))
            x = min(max(p[-1][0] + dx, 0), width - 1)
            y = min(max(p[-1][1] + dy, 0), height - 1)
            if (x, y) != p[-1]:
                p.append((x, y))
        color = np.zeros((3, 32), np.int64)
        color[0, :3] = rng.integers(-8, 9, 3)
        color[1, :3] = rng.integers(1, 7, 3) * np.array([1, 1, -1])
        color[2, :3] = rng.integers(-4, 5, 3)
        sig = np.zeros(32, np.int64)
        sig[0] = SIGMA_DC_PER_PX * int(rng.integers(sigma[0], sigma[1] + 1))
        sig[1] = int(rng.integers(-1, 2))
        out.append(SplineSpec(p, color.tolist(), sig.tolist()))
    return out


def splines_stream(width, height, count, seed=0, **kw):
    """(codestream, splines): an XYB VarDCT frame of `count` random
    splines (random_splines) over its AC (encode_xyb_vardct keywords)."""
    rng = np.random.default_rng(seed)
    splines = random_splines(rng, width, height, count)
    data, _ = encode_xyb_vardct(width, height, seed=seed, splines=splines, **kw)
    return data, splines


# -- the JAX package reads the bundle back ------------------------------------------


def _ref_read(bits, num_pixels):
    from jxl_tpu.features.splines import Splines
    from jxl_tpu.io.bit_reader import BitReader

    data = np.packbits(np.concatenate([bits, np.zeros(64, np.uint8)]),
                       bitorder="little").tobytes()
    return Splines.read(BitReader(data), num_pixels)


@pytest.mark.parametrize("seed,quant_adjust", [(1, 0), (2, 3), (3, -5)])
def test_jxl_tpu_reads_the_bundle_as_written(seed, quant_adjust):
    rng = np.random.default_rng(seed)
    splines = random_splines(rng, 600, 400, 5)
    s = _ref_read(encode_splines(splines, quant_adjust), 600 * 400)
    assert s.quantization_adjustment == quant_adjust
    assert [tuple(int(v) for v in p) for p in s.starting_points] == [sp.points[0]
                                                                     for sp in splines]
    for got, sp in zip(s.splines, splines):
        assert got.color_dct == sp.color_dct and got.sigma_dct == sp.sigma_dct
        # the control points come back from their second differences
        pts = [sp.points[0]]
        dx = dy = 0
        for ddx, ddy in got.control_points:
            dx, dy = dx + ddx, dy + ddy
            pts.append((pts[-1][0] + dx, pts[-1][1] + dy))
        assert pts == [tuple(p) for p in sp.points]


def test_random_splines_keep_their_shape():
    rng = np.random.default_rng(4)
    splines = random_splines(rng, 3840, 2160, 64)
    assert len(splines) == 64
    for sp in splines:
        assert 8 <= len(sp.points) <= 16
        assert all(a != b for a, b in zip(sp.points, sp.points[1:]))
        assert 1 <= sp.sigma_dct[0] // SIGMA_DC_PER_PX <= 4


def test_jxl_tpu_decodes_a_splines_frame():
    from jxl_tpu.api.simple import decode_image

    data, _ = splines_stream(520, 136, 6, seed=5, density=0.1)
    plain, _ = encode_xyb_vardct(520, 136, seed=5, density=0.1)
    a = decode_image(data).frames[0]
    b = decode_image(plain).frames[0]
    assert a.shape == b.shape == (136, 520, 3)
    assert np.abs(a - b).max() > 0.05  # the splines show
