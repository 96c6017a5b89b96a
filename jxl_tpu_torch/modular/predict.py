"""Modular predictors, including the self-correcting weighted predictor.

Capability reference: jxl/src/frame/modular/predict.rs (spec "Self-correcting
predictor"). All arithmetic follows the reference's integer semantics
(i32 wrap for stored pixels/properties, i64 intermediates, u32 error
accumulators) so lossless decode is bit-exact.
"""

from __future__ import annotations

import enum

_I32_MASK = 0xFFFFFFFF


def wrap_i32(x: int) -> int:
    x &= _I32_MASK
    return x - 0x100000000 if x >= 0x80000000 else x


def wrap_u32(x: int) -> int:
    return x & _I32_MASK


class Predictor(enum.IntEnum):
    ZERO = 0
    WEST = 1
    NORTH = 2
    AVG_W_N = 3
    SELECT = 4
    GRADIENT = 5
    WEIGHTED = 6
    NORTH_EAST = 7
    NORTH_WEST = 8
    WEST_WEST = 9
    AVG_W_NW = 10
    AVG_N_NW = 11
    AVG_N_NE = 12
    AVG_ALL = 13

    @property
    def requires_full_row(self) -> bool:
        return self in (
            Predictor.WEIGHTED,
            Predictor.NORTH_EAST,
            Predictor.AVG_N_NE,
            Predictor.AVG_ALL,
        )


NUM_PREDICTORS = 14


def clamped_gradient(left: int, top: int, topleft: int) -> int:
    mn = min(left, top)
    mx = max(left, top)
    grad = left + top - topleft
    g = mx if topleft < mn else grad
    return mn if topleft > mx else g


def _select(left: int, top: int, topleft: int) -> int:
    p = left + top - topleft
    return left if abs(p - left) < abs(p - top) else top


def predict_one(pred: int, pd, wp_pred: int) -> int:
    """pd = (left, top, toptop, topleft, topright, leftleft, toprightright)"""
    left, top, toptop, topleft, topright, leftleft, toprightright = pd
    if pred == Predictor.ZERO:
        return 0
    if pred == Predictor.WEST:
        return left
    if pred == Predictor.NORTH:
        return top
    if pred == Predictor.AVG_W_N:
        return _trunc_div2(top + left)
    if pred == Predictor.SELECT:
        return _select(left, top, topleft)
    if pred == Predictor.GRADIENT:
        return clamped_gradient(left, top, topleft)
    if pred == Predictor.WEIGHTED:
        return wp_pred
    if pred == Predictor.NORTH_EAST:
        return topright
    if pred == Predictor.NORTH_WEST:
        return topleft
    if pred == Predictor.WEST_WEST:
        return leftleft
    if pred == Predictor.AVG_W_NW:
        return _trunc_div2(left + topleft)
    if pred == Predictor.AVG_N_NW:
        return _trunc_div2(top + topleft)
    if pred == Predictor.AVG_N_NE:
        return _trunc_div2(top + topright)
    # AVG_ALL — Rust `/ 16` truncates toward zero (not an arithmetic shift)
    v = 6 * top - 2 * toptop + 7 * left + leftleft + toprightright + 3 * topright + 8
    return -((-v) >> 4) if v < 0 else v >> 4


def _trunc_div2(v: int) -> int:
    # Rust i64 `/ 2` truncates toward zero.
    return -((-v) >> 1) if v < 0 else v >> 1


# -- weighted predictor -------------------------------------------------------

_PRED_EXTRA_BITS = 3
_PREDICTION_ROUND = ((1 << _PRED_EXTRA_BITS) >> 1) - 1  # = 3
_DIVLOOKUP = [(1 << 24) // (i + 1) for i in range(64)]


class WeightedPredictorState:
    """Per-channel weighted-predictor state: 4 sub-predictors with
    per-pixel error feedback across two alternating rows."""

    __slots__ = ("xsize", "pred_errors", "error", "w", "p1c", "p2c", "p3c", "prediction", "pred")

    def __init__(self, wp_header, xsize: int):
        n = (xsize + 1) * 2
        self.xsize = xsize
        # 4 parallel u32 error accumulators
        self.pred_errors = [[0] * n for _ in range(4)]
        self.error = [0] * n  # i32 signed errors
        self.w = [wp_header.w0, wp_header.w1, wp_header.w2, wp_header.w3]
        self.p1c = wp_header.p1c
        self.p2c = wp_header.p2c
        self.p3c = [wp_header.p3ca, wp_header.p3cb, wp_header.p3cc, wp_header.p3cd, wp_header.p3ce]
        self.prediction = [0, 0, 0, 0]
        self.pred = 0

    def predict_and_property(self, x: int, y: int, pd) -> tuple[int, int]:
        left, top, toptop, topleft, topright, _leftleft, _toprightright = pd
        xs = self.xsize
        if y & 1:
            cur_row, prev_row = 0, xs + 1
        else:
            cur_row, prev_row = xs + 1, 0
        pos_ne = x + 1 if x + 1 < xs else x
        pos_nw = x - 1 if x > 0 else 0

        pe = self.pred_errors
        errs = []
        shifts = []
        divs = []
        ws = []
        for k in range(4):
            row = pe[k]
            e = (row[prev_row + x] + row[prev_row + pos_ne] + row[prev_row + pos_nw]) & _I32_MASK
            errs.append(e)
            sh = max((e + 1).bit_length() - 1 - 5, 0)
            shifts.append(sh)
            d = _DIVLOOKUP[e >> sh]
            divs.append(d)
            ws.append(4 + ((self.w[k] * d) >> sh))

        err = self.error
        te_w = err[cur_row + x]
        te_n = err[prev_row + 1 + x]
        te_nw = err[prev_row + 1 + pos_nw]
        te_ne = err[prev_row + 1 + pos_ne]
        sum_wn = te_n + te_w

        p = te_w
        if abs(te_n) > abs(p):
            p = te_n
        if abs(te_nw) > abs(p):
            p = te_nw
        if abs(te_ne) > abs(p):
            p = te_ne

        n8 = top << _PRED_EXTRA_BITS
        w8 = left << _PRED_EXTRA_BITS
        ne8 = topright << _PRED_EXTRA_BITS
        nw8 = topleft << _PRED_EXTRA_BITS
        nn8 = toptop << _PRED_EXTRA_BITS

        p0 = w8 + ne8 - n8
        p1 = n8 - (((sum_wn + te_ne) * self.p1c) >> 5)
        p2 = w8 - (((sum_wn + te_nw) * self.p2c) >> 5)
        p3 = n8 - (
            (
                te_nw * self.p3c[0]
                + te_n * self.p3c[1]
                + te_ne * self.p3c[2]
                + (nn8 - n8) * self.p3c[3]
                + (nw8 - w8) * self.p3c[4]
            )
            >> 5
        )

        wsum = ws[0] + ws[1] + ws[2] + ws[3]
        log_weight = wsum.bit_length() - 1  # floor_log2_nonzero
        sh = log_weight - 4
        w0s, w1s, w2s, w3s = (wv >> sh for wv in ws)
        weight_sum = w0s + w1s + w2s + w3s
        ssum = (weight_sum >> 1) - 1 + w0s * p0 + w1s * p1 + w2s * p2 + w3s * p3
        pred = (ssum * _DIVLOOKUP[weight_sum - 1]) >> 24

        if ((te_n ^ te_w) | (te_n ^ te_nw)) <= 0:
            mx = max(w8, ne8, n8)
            mn = min(w8, ne8, n8)
            pred = max(mn, min(mx, pred))
        self.prediction = [p0, p1, p2, p3]
        self.pred = pred
        return ((pred + _PREDICTION_ROUND) >> _PRED_EXTRA_BITS, wrap_i32(p))

    def update_errors(self, correct_val: int, x: int, y: int) -> None:
        xs = self.xsize
        if y & 1:
            cur_row, prev_row = 0, xs + 1
        else:
            cur_row, prev_row = xs + 1, 0
        val = correct_val << _PRED_EXTRA_BITS
        self.error[cur_row + x + 1] = wrap_i32(self.pred - val)
        pe = self.pred_errors
        for k in range(4):
            e = ((abs(self.prediction[k] - val) + _PREDICTION_ROUND) >> _PRED_EXTRA_BITS) & _I32_MASK
            row = pe[k]
            row[cur_row + x] = e
            row[prev_row + x + 1] = (row[prev_row + x + 1] + e) & _I32_MASK
