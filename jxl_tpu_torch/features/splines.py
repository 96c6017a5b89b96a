"""Splines: centripetal Catmull-Rom curves with DCT32-coded color/sigma,
rendered as Gaussian brush segments.

Capability reference: jxl/src/features/spline.rs + util/fast_math.rs; the
counterpart of jxl_tpu/features/splines.py. The fast_cos / fast_erff
approximations are reproduced exactly. The draw cache is one (S, 8)
float32 table, a row a segment: centre x, y, maximum distance, 1/sigma,
intensity term (sigma / 4 times the arc-length weight) and colour X, Y, B,
the values jxl_tpu's segments hold, rounded to float32 as its native splat
reads them. The render's spline stage (render/pipeline.py:splines_stage)
splats the table on the planes' device; draw and draw_rows are the plain
host version of that splat, with the native splat's (jxl_spline_splat)
float32 box bounds and operation order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import SplineAdjacentCoincidingControlPoints, SplinesAreaTooLarge, SplinesDeltaLimit, SplinesDistanceTooLarge, SplinesPointOutOfRange, SplinesTooMany, SplinesTooManyControlPoints
from ..entropy import Histograms, SymbolReader
from ..io.bit_reader import BitReader
from ..io.bundle import unpack_signed

_QUANT_ADJ_CTX = 0
_START_POS_CTX = 1
_NUM_SPLINES_CTX = 2
_NUM_CP_CTX = 3
_CP_CTX = 4
_DCT_CTX = 5
_NUM_CONTEXTS = 6
_MAX_CP = 1 << 20
_DELTA_LIMIT = 1 << 30
_POS_LIMIT = 1 << 23
_DESIRED_DIST = 1.0
_CHANNEL_WEIGHT = (0.0042, 0.075, 0.07, 0.3333)


def fast_cos(x):
    """ref util/fast_math.rs:16-41 (vectorized)."""
    x = np.asarray(x, dtype=np.float32)
    pi2 = np.float32(2 * math.pi)
    npi2 = np.floor(x * np.float32(0.5 / math.pi)) * pi2
    xmod = x - npi2
    x_pi = np.minimum(xmod, pi2 - xmod)
    above = x_pi >= np.float32(math.pi / 2)
    x_ph = np.where(above, np.float32(math.pi) - x_pi, x_pi)
    xs = x_ph * np.float32(0.25)
    x2 = xs * xs
    x4 = x2 * x2
    pre = x4 * np.float32(0.06960438) + (x2 * np.float32(-0.84087373) + np.float32(1.68179268))
    s1 = pre * pre - np.float32(math.sqrt(2.0))
    s2 = s1 * s1 - np.float32(1.0)
    return np.where(above, -s2, s2).astype(np.float32)


def fast_erf(x):
    """ref util/fast_math.rs:45-59, in float32 on a float32 numpy array or
    torch tensor (the spline stage evaluates it on the device)."""
    absx = abs(x)
    d1 = absx * 7.77394369e-02 + 2.05260015e-04
    d2 = d1 * absx + 2.32120216e-01
    d3 = d2 * absx + 2.77820801e-01
    d4 = d3 * absx + 1.0
    d5 = d4 * d4
    inv = 1.0 / d5
    if isinstance(x, np.ndarray):
        return np.copysign(-inv * inv + 1.0, x).astype(np.float32)
    return torch.copysign(-inv * inv + 1.0, x)


def _area_limit(image_size: int) -> int:
    return min(1024 * image_size + (1 << 32), 1 << 42)


@dataclass
class QuantizedSpline:
    control_points: list
    color_dct: list  # [3][32] int
    sigma_dct: list  # [32] int


class Splines:
    def __init__(self):
        self.quantization_adjustment = 0
        self.splines: list[QuantizedSpline] = []
        self.starting_points: list = []
        self.table = np.zeros((0, 8), np.float32)  # the draw cache

    @staticmethod
    def read(br: BitReader, num_pixels: int) -> "Splines":
        """ref spline.rs:826-889."""
        s = Splines()
        histograms = Histograms.decode(_NUM_CONTEXTS, br, allow_lz77=True)
        reader = SymbolReader(histograms, br)
        num_splines = reader.read_unsigned(histograms, br, _NUM_SPLINES_CTX) + 1
        max_cp = min(_MAX_CP, num_pixels // 2)
        if num_splines > max_cp:
            raise SplinesTooMany("too many splines")
        last_x = last_y = 0
        for i in range(num_splines):
            ux = reader.read_unsigned(histograms, br, _START_POS_CTX)
            uy = reader.read_unsigned(histograms, br, _START_POS_CTX)
            if i != 0:
                x = unpack_signed(ux) + last_x
                y = unpack_signed(uy) + last_y
            else:
                x, y = ux, uy
            if max(abs(x), abs(y)) >= _POS_LIMIT:
                raise SplinesPointOutOfRange("spline coordinates out of range")
            s.starting_points.append((float(x), float(y)))
            last_x, last_y = x, y
        s.quantization_adjustment = reader.read_signed(histograms, br, _QUANT_ADJ_CTX)
        total_cp = 0
        for _ in range(num_splines):
            n = reader.read_unsigned(histograms, br, _NUM_CP_CTX)
            total_cp += n
            if total_cp > max_cp:
                raise SplinesTooManyControlPoints("too many control points")
            cps = []
            for _ in range(n):
                dx = reader.read_signed(histograms, br, _CP_CTX)
                dy = reader.read_signed(histograms, br, _CP_CTX)
                if max(abs(dx), abs(dy)) >= _DELTA_LIMIT:
                    raise SplinesDeltaLimit("spline delta too large")
                cps.append((dx, dy))
            color_dct = [
                [reader.read_signed(histograms, br, _DCT_CTX) for _ in range(32)]
                for _ in range(3)
            ]
            sigma_dct = [reader.read_signed(histograms, br, _DCT_CTX) for _ in range(32)]
            s.splines.append(QuantizedSpline(cps, color_dct, sigma_dct))
        reader.check_final_state(histograms, br)
        return s

    # -- dequantize + draw cache ---------------------------------------------

    def initialize_draw_cache(self, image_xsize, image_ysize, ccp, high_precision=False):
        y_to_x = ccp.y_to_x_lf if ccp else 0.0
        y_to_b = ccp.y_to_b_lf if ccp else 1.0
        image_area = image_xsize * image_ysize
        area_limit = _area_limit(image_area)
        total_area = 0
        rows = []
        inv_quant = (
            1.0 / (1.0 + 0.125 * self.quantization_adjustment)
            if self.quantization_adjustment >= 0
            else 1.0 - 0.125 * self.quantization_adjustment
        )
        for qspline, start in zip(self.splines, self.starting_points):
            cps, color_dct, sigma_dct, est_area = _dequantize(
                qspline, start, inv_quant, y_to_x, y_to_b, image_area
            )
            total_area += est_area
            if total_area > area_limit:
                raise SplinesAreaTooLarge("splines area too large")
            for a, b in zip(cps, cps[1:]):
                if a == b:
                    raise SplineAdjacentCoincidingControlPoints("identical adjacent spline points")
            pts = _catmull_rom(cps)
            draw_pts = _equally_spaced(pts, _DESIRED_DIST)
            if not draw_pts:
                continue
            length = (len(draw_pts) - 2) * _DESIRED_DIST + draw_pts[-1][1]
            if length <= 0.0:
                continue
            rows.append(_segments(draw_pts, length, color_dct, sigma_dct, high_precision))
        if rows:
            self.table = np.concatenate(rows).astype(np.float32)
        else:
            self.table = np.zeros((0, 8), np.float32)

    # -- rendering ------------------------------------------------------------

    def draw(self, planes):
        """Additively splat all segments onto 3 whole-image float32 planes."""
        return self.draw_rows(planes, 0)

    def draw_rows(self, planes, row0: int):
        """Additively splat onto 3 float32 band planes covering global rows
        [row0, row0 + rows), segment by segment: the box of a segment is
        rounded to even from its float32 bounds, as jxl_spline_splat
        rounds it, and each sample is computed in its float32 order."""
        rows, w = planes[0].shape
        row1 = row0 + rows
        c = np.float32(0.35355338)
        half = np.float32(0.5)
        for cx, cy, md, inv_sigma, s4m, *color in self.table:
            x0 = max(0, int(np.rint(cx - md)))
            x1 = min(w, int(np.rint(cx + md)) + 1)
            y0 = max(row0, int(np.rint(cy - md)))
            y1 = min(row1, int(np.rint(cy + md)) + 1)
            if x1 <= x0 or y1 <= y0:
                continue
            dx = np.arange(x0, x1, dtype=np.float32) - cx
            dy = np.arange(y0, y1, dtype=np.float32) - cy
            dist = np.sqrt(dx[None, :] * dx[None, :] + dy[:, None] * dy[:, None])
            f = fast_erf((dist * half + c) * inv_sigma) - fast_erf((dist * half - c) * inv_sigma)
            local = s4m * f * f
            for ci in range(3):
                planes[ci][y0 - row0 : y1 - row0, x0:x1] += color[ci] * local
        return planes


def _dequantize(qspline, start, inv_quant, y_to_x, y_to_b, image_area):
    """ref spline.rs:237-338."""
    area_limit = _area_limit(image_area)
    px, py = round(start[0]), round(start[1])
    cps = [(float(px), float(py))]
    cur_x, cur_y = int(px), int(py)
    dx = dy = 0
    manhattan = 0
    for (ddx, ddy) in qspline.control_points:
        dx += ddx
        dy += ddy
        if max(abs(dx), abs(dy)) >= _POS_LIMIT:
            raise SplinesDeltaLimit("spline delta out of range")
        manhattan += abs(dx) + abs(dy)
        if manhattan > area_limit:
            raise SplinesDistanceTooLarge("spline too long")
        cur_x += dx
        cur_y += dy
        if max(abs(cur_x), abs(cur_y)) >= _POS_LIMIT:
            raise SplinesPointOutOfRange("spline point out of range")
        cps.append((float(cur_x), float(cur_y)))

    frac_sqrt2 = 1.0 / math.sqrt(2.0)
    color_dct = []
    for c in range(3):
        row = []
        for i in range(32):
            f = frac_sqrt2 if i == 0 else 1.0
            row.append(qspline.color_dct[c][i] * f * _CHANNEL_WEIGHT[c] * inv_quant)
        color_dct.append(row)
    for i in range(32):
        color_dct[0][i] += y_to_x * color_dct[1][i]
        color_dct[2][i] += y_to_b * color_dct[1][i]

    color = [0, 0, 0]
    for c in range(3):
        for i in range(32):
            color[c] += math.ceil(inv_quant * abs(qspline.color_dct[c][i]))
    color[0] += math.ceil(abs(y_to_x)) * color[1]
    color[2] += math.ceil(abs(y_to_b)) * color[1]
    max_color = max(color)
    logcolor = max(1, _ceil_log2(1 + max_color))
    weight_limit = math.ceil(
        math.sqrt((area_limit / logcolor) / max(manhattan, 1))
    )

    sigma_dct = []
    width_estimate = 0
    for i in range(32):
        f = frac_sqrt2 if i == 0 else 1.0
        sigma_dct.append(qspline.sigma_dct[i] * f * _CHANNEL_WEIGHT[3] * inv_quant)
        weight_f = math.ceil(inv_quant * abs(qspline.sigma_dct[i]))
        weight = int(min(weight_limit, max(weight_f, 1.0)))
        width_estimate += weight * weight * logcolor
    est_area = width_estimate * manhattan
    return cps, color_dct, sigma_dct, est_area


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _catmull_rom(points):
    """ref spline.rs:360-419."""
    if not points:
        return []
    if len(points) == 1:
        return [points[0]]
    NUM = 16
    p = [tuple(points[0][k] + (points[0][k] - points[1][k]) for k in range(2))]
    p += [tuple(pt) for pt in points]
    p.append(tuple(points[-1][k] + (points[-1][k] - points[-2][k]) for k in range(2)))
    d = [math.sqrt(math.hypot(p[i + 1][0] - p[i][0], p[i + 1][1] - p[i][1])) for i in range(len(p) - 1)]
    result = []
    for i in range(len(points) - 1):
        # window p[i..i+4] with deltas d[i..i+3]
        w = [p[i], p[i + 1], p[i + 2], p[i + 3]]
        wd = [d[i], d[i + 1], d[i + 2]]
        result.append(w[1])
        t = [0.0] * 4
        for k in range(3):
            t[k + 1] = t[k] + wd[k]
        for j in range(1, NUM):
            tt = wd[0] + (j / NUM) * wd[1]
            a = []
            for k in range(3):
                r = (tt - t[k]) / wd[k] if wd[k] else 0.0
                a.append(
                    tuple(w[k][m] + (w[k + 1][m] - w[k][m]) * r for m in range(2))
                )
            b = []
            for k in range(2):
                denom = wd[k] + wd[k + 1]
                r = (tt - t[k]) / denom if denom else 0.0
                b.append(tuple(a[k][m] + (a[k + 1][m] - a[k][m]) * r for m in range(2)))
            r = (tt - t[1]) / wd[1] if wd[1] else 0.0
            result.append(tuple(b[0][m] + (b[1][m] - b[0][m]) * r for m in range(2)))
    result.append(points[-1])
    return result


def _equally_spaced(points, desired):
    """ref spline.rs:421-454."""
    if not points:
        return []
    out = [(points[0], desired)]
    if len(points) == 1:
        return out
    acc = 0.0
    for i in range(len(points) - 1):
        cur = points[i]
        nxt = points[i + 1]
        seg = (nxt[0] - cur[0], nxt[1] - cur[1])
        seg_len = math.hypot(*seg)
        if seg_len == 0.0:
            continue
        unit = (seg[0] / seg_len, seg[1] / seg_len)
        if acc + seg_len >= desired:
            cur = (cur[0] + unit[0] * (desired - acc), cur[1] + unit[1] * (desired - acc))
            out.append((cur, desired))
            acc -= desired
        acc += seg_len
        while acc >= desired:
            cur = (cur[0] + unit[0] * desired, cur[1] + unit[1] * desired)
            out.append((cur, desired))
            acc -= desired
    out.append((points[-1], acc))
    return out


def _segments(draw_pts, length, color_dct, sigma_dct, high_precision):
    """(n, 8) float64 rows of the draw cache of one spline's arc-length
    samples (ref spline.rs:456-520; jxl_tpu's _add_segments, vectorized
    over the samples), the samples whose sigma is finite and non-zero."""
    inv_length = 1.0 / length
    P = len(draw_pts)
    idxs = np.arange(P, dtype=np.float32)
    progress = np.minimum(
        idxs * np.float32(_DESIRED_DIST * inv_length), np.float32(1.0)
    )
    t = np.float32(31.0) * progress
    ang = (
        np.arange(32, dtype=np.float32)[None, :]
        * np.float32(math.pi / 32.0)
        * (t[:, None] + np.float32(0.5))
    )
    cosines = np.float32(math.sqrt(2.0)) * fast_cos(ang)  # (P, 32)
    cd = np.asarray(color_dct, dtype=np.float32)  # (3, 32)
    sd = np.asarray(sigma_dct, dtype=np.float32)  # (32,)
    colors = cosines @ cd.T  # (P, 3)
    sigmas = cosines @ sd  # (P,)
    mults = np.asarray([m for _, m in draw_pts], dtype=np.float64)
    ok = (
        np.isfinite(sigmas)
        & (sigmas != 0.0)
        & np.isfinite(mults)
    )
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ok &= np.isfinite(1.0 / sigmas)
        distance_exp = 5.0 if high_precision else 3.0
        max_color = np.maximum(
            np.abs(colors.astype(np.float64) * mults[:, None]).max(axis=1),
            np.abs(0.01 * mults),
        )
        s64 = sigmas.astype(np.float64)
        max_dist = np.sqrt(
            np.maximum(
                0.0,
                -2.0 * s64 * s64 * (math.log(0.1) * distance_exp - np.log(max_color)),
            )
        )
        inv_sigma = 1.0 / s64
        s4m = 0.25 * s64 * mults
    pts = np.asarray([pt for pt, _ in draw_pts], dtype=np.float64)
    seg = np.concatenate(
        [pts, np.stack([max_dist, inv_sigma, s4m], 1), colors.astype(np.float64)], 1
    )
    return seg[ok]
