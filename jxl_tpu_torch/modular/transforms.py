"""Inverse modular transforms: RCT, Palette, Squeeze — plus the meta-apply
bookkeeping that rewrites the channel list before decoding.

Capability reference: jxl/src/frame/modular/transforms/{rct,palette,squeeze,
meta_apply,apply_local}.rs. Whole-channel application, vectorized with
numpy along the non-sequential axis (unsqueeze has a serial dependency
along its squeeze axis only, so rows/columns batch cleanly — the same
structure the device kernels exploit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..errors import InvalidBitstream, InvalidChannelRange, InvalidVarDCTTransform, MetaSqueezeRequiresInPlace, MixingDifferentChannels, TooManySqueezes
from ..io.headers.modular import GroupHeader, Transform, TransformId, WeightedHeader
from .channel import ChannelInfo, ModularChannel
from .predict import Predictor, WeightedPredictorState, clamped_gradient, predict_one, wrap_i32

# -- transform steps -------------------------------------------------------


@dataclass
class RctStep:
    buf_in: list  # 3 decoded buffers
    buf_out: list  # 3 output buffers
    op: int  # 0..6
    perm: int  # 0..5


@dataclass
class SqueezeStep:
    horizontal: bool
    buf_in: list  # [avg, residual]
    buf_out: int


@dataclass
class PaletteStep:
    buf_in: int
    buf_pal: int
    buf_out: list
    num_colors: int
    num_deltas: int
    predictor: Predictor
    wp_header: WeightedHeader


# -- meta apply -------------------------------------------------------------


class _Chan:
    """(buffer id, ChannelInfo) pair used during meta-apply."""

    __slots__ = ("buf", "info")

    def __init__(self, buf, info):
        self.buf = buf
        self.info = info

    def __repr__(self):
        return f"({self.buf}, {self.info})"


def _check_equal(channels: List[_Chan], first: int, num: int):
    if first + num > len(channels):
        raise InvalidChannelRange("invalid channel range for transform")
    for i in range(1, num):
        if not channels[first].info.is_equivalent(channels[first + i].info):
            raise MixingDifferentChannels("transform mixes different channels")


def default_squeeze(channels: List[_Chan]):
    """ref squeeze.rs:42-108."""
    from ..io.headers.modular import SqueezeParams

    num_meta = 0
    for c in channels:
        if c.info.is_meta:
            num_meta += 1
        else:
            break
    w, h = channels[num_meta].info.size
    nc = len(channels) - num_meta
    params = []
    if nc > 2 and channels[num_meta + 1].info.size == (w, h):
        sp = dict(horizontal=True, in_place=False, begin_channel=num_meta + 1, num_channels=2)
        if w > 1:
            params.append(SqueezeParams(**sp))
        if h > 1:
            params.append(SqueezeParams(**{**sp, "horizontal": False}))
    MAX_FIRST = 8
    base = dict(begin_channel=num_meta, num_channels=nc, in_place=True)
    if w <= h and h > MAX_FIRST:
        params.append(SqueezeParams(horizontal=False, **base))
        h = -(-h // 2)
    while w > MAX_FIRST or h > MAX_FIRST:
        if w > MAX_FIRST:
            params.append(SqueezeParams(horizontal=True, **base))
            w = -(-w // 2)
        if h > MAX_FIRST:
            params.append(SqueezeParams(horizontal=False, **base))
            h = -(-h // 2)
    return params


def meta_apply_single_transform(
    transform: Transform,
    header: GroupHeader,
    channels: List[_Chan],
    transform_steps: list,
    add_buffer,
):
    """Rewrites `channels` and appends steps. `add_buffer(info) -> buf_id`.

    ref meta_apply.rs:48-235.
    """
    if transform.id == TransformId.RCT:
        begin = transform.begin_channel
        op = transform.rct_type % 7
        perm = transform.rct_type // 7
        _check_equal(channels, begin, 3)
        buf_out = [channels[begin + i].buf for i in range(3)]
        buf_in = []
        for i in range(3):
            c = channels[begin + i]
            info = ChannelInfo(c.info.size, c.info.shift, c.info.bit_depth_bits, None)
            c.buf = add_buffer(info)
            c.info = info
            buf_in.append(c.buf)
        transform_steps.append(RctStep(buf_in, buf_out, op, perm))

    elif transform.id == TransformId.SQUEEZE:
        steps = transform.squeezes if transform.squeezes else default_squeeze(channels)
        step_for_buf = {}
        for step in steps:
            begin = step.begin_channel
            num = step.num_channels
            end = begin + num
            if end > len(channels):
                raise InvalidChannelRange("invalid squeeze channel range")
            if channels[begin].info.is_meta != channels[end - 1].info.is_meta:
                raise MixingDifferentChannels("squeeze mixes meta and data channels")
            if channels[begin].info.is_meta and not step.in_place:
                raise MetaSqueezeRequiresInPlace("meta squeeze requires in_place")
            new_offset = end if step.in_place else len(channels)
            for ic in range(num):
                chan = channels[begin + ic].info
                if chan.shift is not None:
                    if chan.shift[0] > 30 or chan.shift[1] > 30:
                        raise TooManySqueezes("too many squeezes")
                    new_shift = (
                        (chan.shift[0] + 1, chan.shift[1])
                        if step.horizontal
                        else (chan.shift[0], chan.shift[1] + 1)
                    )
                else:
                    new_shift = None
                w, h = chan.size
                if step.horizontal:
                    size0 = (-(-w // 2), h)
                    size1 = (w - -(-w // 2), h)
                else:
                    size0 = (w, -(-h // 2))
                    size1 = (w, h - -(-h // 2))
                info0 = ChannelInfo(size0, new_shift, chan.bit_depth_bits, None)
                buf0 = add_buffer(info0)
                info1 = ChannelInfo(size1, new_shift, chan.bit_depth_bits, None)
                buf1 = add_buffer(info1)
                step_for_buf[buf0] = len(transform_steps)
                buf_out = channels[begin + ic].buf
                transform_steps.append(
                    SqueezeStep(step.horizontal, [buf0, buf1], buf_out)
                )
                channels[begin + ic] = _Chan(buf0, info0)
                channels.insert(new_offset + ic, _Chan(buf1, info1))

    elif transform.id == TransformId.PALETTE:
        begin = transform.begin_channel
        num = transform.num_channels
        _check_equal(channels, begin, num)
        bd = channels[begin].info.bit_depth_bits
        pal_info = ChannelInfo(
            (transform.num_colors + transform.num_deltas, num), None, bd, None
        )
        pchan = add_buffer(pal_info)
        in_info = ChannelInfo(
            channels[begin].info.size, channels[begin].info.shift, bd, None
        )
        inchan = add_buffer(in_info)
        buf_out = [channels[begin + i].buf for i in range(num)]
        transform_steps.append(
            PaletteStep(
                inchan,
                pchan,
                buf_out,
                transform.num_colors,
                transform.num_deltas,
                Predictor(transform.predictor_id),
                header.wp_header,
            )
        )
        del channels[begin + 1 : begin + num]
        channels[begin] = _Chan(inchan, in_info)
        channels.insert(0, _Chan(pchan, pal_info))
    else:
        raise InvalidVarDCTTransform("invalid transform id")


def meta_apply_transforms(channel_infos: List[ChannelInfo], header: GroupHeader):
    """Returns (buffer_infos, coded: list of buf ids in coded order, steps).

    buffer_infos[i] = ChannelInfo for buffer i (inputs first, then
    transform-created buffers). ref meta_apply.rs:238-299.
    """
    buffer_infos = list(channel_infos)
    channels = [_Chan(i, info) for i, info in enumerate(channel_infos)]
    transform_steps: list = []

    def add_buffer(info):
        buffer_infos.append(info)
        return len(buffer_infos) - 1

    for t in header.transforms:
        meta_apply_single_transform(t, header, channels, transform_steps, add_buffer)

    coded = [c.buf for c in channels]
    return buffer_infos, coded, transform_steps


def meta_apply_local(buffers: List[ModularChannel], header: GroupHeader):
    """Local (per-substream) transforms. Returns (coded_buffers, steps,
    storage) where storage maps buf ids to channels (ref apply_local.rs)."""
    infos = [b.channel_info() for b in buffers]
    buffer_infos, coded, steps = meta_apply_transforms(infos, header)
    storage: List[Optional[ModularChannel]] = list(buffers)
    for info in buffer_infos[len(buffers) :]:
        storage.append(ModularChannel(info.size, info.shift, info.bit_depth_bits))
    coded_buffers = [storage[i] for i in coded]
    return coded_buffers, steps, storage


# -- RCT --------------------------------------------------------------------

_RCT_PERM = {
    0: (0, 1, 2),  # Rgb
    1: (2, 0, 1),  # Gbr: out slots get (b, r, g)
    2: (1, 2, 0),  # Brg
    3: (0, 2, 1),  # Rbg
    4: (1, 0, 2),  # Grb
    5: (2, 1, 0),  # Bgr
}


def apply_rct(storage, step: RctStep):
    v0 = storage[step.buf_in[0]].data
    v1 = storage[step.buf_in[1]].data
    v2 = storage[step.buf_in[2]].data
    op = step.op
    from .. import native

    if native.rct_native(
        (v0, v1, v2),
        tuple(storage[step.buf_out[i]].data for i in range(3)),
        op,
        step.perm,
    ):
        return
    with np.errstate(over="ignore"):
        if op == 0:
            pass
        elif op == 1:
            v2 = v2 + v0
        elif op == 2:
            v1 = v1 + v0
        elif op == 3:
            v1 = v1 + v0
            v2 = v2 + v0
        elif op == 4:
            v1 = v1 + ((v0 + v2) >> 1)
        elif op == 5:
            v2 = v2 + v0
            v1 = v1 + ((v0 + v2) >> 1)
        elif op == 6:
            y, co, cg = v0, v1, v2
            y = y - (cg >> 1)
            g = cg + y
            y = y - (co >> 1)
            r = y + co
            v0, v1, v2 = r, g, y
    res = (v0, v1, v2)
    src = _RCT_PERM[step.perm]
    for slot in range(3):
        storage[step.buf_out[slot]].data[...] = res[src[slot]]


# -- Squeeze -----------------------------------------------------------------


def _trunc_div(x, d):
    return np.where(x < 0, -((-x) // d), x // d)


def _smooth_tendency(b, a, n):
    """Vectorized smooth tendency (ref squeeze.rs:147-171), int64 arrays."""
    bma = b - a
    amn = a - n
    m1 = (b >= a) & (a >= n)
    m2 = (b <= a) & (a <= n)
    d1 = (4 * b - 3 * n - a + 6) // 12  # positive in branch 1
    d1 = np.where(d1 - (d1 & 1) > 2 * bma, 2 * bma + 1, d1)
    d1 = np.where(d1 + (d1 & 1) > 2 * amn, 2 * amn, d1)
    d2 = _trunc_div(4 * b - 3 * n - a - 6, 12)  # negative in branch 2
    d2 = np.where(d2 + (d2 & 1) < 2 * bma, 2 * bma - 1, d2)
    d2 = np.where(d2 - (d2 & 1) < 2 * amn, 2 * amn, d2)
    return np.where(m1, d1, np.where(m2, d2, 0))


def _unsqueeze(avg, res, next_avg, prev):
    tendency = _smooth_tendency(prev, avg, next_avg)
    diff = res + tendency
    a = avg + _trunc_div(diff, 2)
    b = a - diff
    return a, b


def _native_squeeze(storage, step: SqueezeStep, horizontal: bool) -> bool:
    from .. import native

    lib = native.get_lib()
    if lib is None:
        return False
    import ctypes

    avg = np.ascontiguousarray(storage[step.buf_in[0]].data)
    res = np.ascontiguousarray(storage[step.buf_in[1]].data)
    out = storage[step.buf_out].data
    if not out.flags["C_CONTIGUOUS"]:
        return False
    _ptr = native._ptr
    i32 = ctypes.c_int32
    if horizontal:
        h, wo = out.shape
        lib.jxl_hsqueeze(
            _ptr(avg, i32), ctypes.c_int64(avg.shape[1] if avg.size else 0),
            _ptr(res, i32), ctypes.c_int64(res.shape[1] if res.size else 0),
            _ptr(out, i32), ctypes.c_int64(wo),
            ctypes.c_int(h), ctypes.c_int(avg.shape[1]), ctypes.c_int(res.shape[1]),
            ctypes.c_int(wo),
        )
    else:
        ho, w = out.shape
        lib.jxl_vsqueeze(
            _ptr(avg, i32), ctypes.c_int64(avg.shape[1] if avg.size else 0),
            _ptr(res, i32), ctypes.c_int64(res.shape[1] if res.size else 0),
            _ptr(out, i32), ctypes.c_int64(w),
            ctypes.c_int(w), ctypes.c_int(avg.shape[0]), ctypes.c_int(res.shape[0]),
            ctypes.c_int(ho),
        )
    return True


def apply_hsqueeze(storage, step: SqueezeStep):
    out = storage[step.buf_out].data
    h, w_out = out.shape
    if h == 0 or w_out == 0:
        return
    if _native_squeeze(storage, step, True):
        return
    avg = storage[step.buf_in[0]].data.astype(np.int64)
    res = storage[step.buf_in[1]].data.astype(np.int64)
    w = res.shape[1]
    if w == 0:
        out[:, 0] = avg[:, 0]
        return
    has_tail = (w_out & 1) == 1
    prev = avg[:, 0].copy()
    x_end = w if has_tail else w - 1
    for x in range(x_end):
        a, b = _unsqueeze(avg[:, x], res[:, x], avg[:, x + 1], prev)
        out[:, 2 * x] = a
        out[:, 2 * x + 1] = b
        prev = b
    if has_tail:
        out[:, 2 * w] = avg[:, w]
    else:
        a, b = _unsqueeze(avg[:, w - 1], res[:, w - 1], avg[:, w - 1], prev)
        out[:, 2 * w - 2] = a
        out[:, 2 * w - 1] = b


def apply_vsqueeze(storage, step: SqueezeStep):
    out = storage[step.buf_out].data
    h_out, w = out.shape
    if h_out == 0 or w == 0:
        return
    if _native_squeeze(storage, step, False):
        return
    avg = storage[step.buf_in[0]].data.astype(np.int64)
    res = storage[step.buf_in[1]].data.astype(np.int64)
    h = res.shape[0]
    if h == 0:
        out[0, :] = avg[0, :]
        return
    has_tail = (h_out & 1) == 1
    prev = avg[0, :].copy()
    y_end = h if has_tail else h - 1
    for y in range(y_end):
        a, b = _unsqueeze(avg[y], res[y], avg[y + 1], prev)
        out[2 * y, :] = a
        out[2 * y + 1, :] = b
        prev = b
    if has_tail:
        out[2 * h, :] = avg[h, :]
    else:
        a, b = _unsqueeze(avg[h - 1], res[h - 1], avg[h - 1], prev)
        out[2 * h - 2, :] = a
        out[2 * h - 1, :] = b


# -- Palette ------------------------------------------------------------------

# Normative delta-palette table (spec; ref palette.rs:48-121).
_DELTA_PALETTE = [
    (0, 0, 0), (4, 4, 4), (11, 0, 0), (0, 0, -13), (0, -12, 0), (-10, -10, -10),
    (-18, -18, -18), (-27, -27, -27), (-18, -18, 0), (0, 0, -32), (-32, 0, 0),
    (-37, -37, -37), (0, -32, -32), (24, 24, 45), (50, 50, 50), (-45, -24, -24),
    (-24, -45, -45), (0, -24, -24), (-34, -34, 0), (-24, 0, -24), (-45, -45, -24),
    (64, 64, 64), (-32, 0, -32), (0, -32, 0), (-32, 0, 32), (-24, -45, -24),
    (45, 24, 45), (24, -24, -45), (-45, -24, 24), (80, 80, 80), (64, 0, 0),
    (0, 0, -64), (0, -64, -64), (-24, -24, 45), (96, 96, 96), (64, 64, 0),
    (45, -24, -24), (34, -34, 0), (112, 112, 112), (24, -45, -45), (45, 45, -24),
    (0, -32, 32), (24, -24, 45), (0, 96, 96), (45, -24, 24), (24, -45, -24),
    (-24, -45, 24), (0, -64, 0), (96, 0, 0), (128, 128, 128), (64, 0, 64),
    (144, 144, 144), (96, 96, 0), (-36, -36, 36), (45, -24, -45), (45, -45, -24),
    (0, 0, -96), (0, 128, 128), (0, 96, 0), (45, 24, -45), (-128, 0, 0),
    (24, -45, 24), (-45, 24, -45), (64, 0, -64), (64, -64, -64), (96, 0, 96),
    (45, -45, 24), (24, 45, -45), (64, 64, -64), (128, 128, 0), (0, 0, -128),
    (-24, 45, -45),
]

_SMALL_CUBE = 4
_SMALL_CUBE_BITS = 2
_LARGE_CUBE = 5
_LARGE_CUBE_OFFSET = _SMALL_CUBE ** 3


def _scale4(value: int, bit_depth: int) -> int:
    return (value * ((1 << bit_depth) - 1)) >> 2


def get_palette_value(palette: np.ndarray, index: int, c: int, palette_size: int, bit_depth: int) -> int:
    """ref palette.rs:41-168 (incl. implicit small/large cube + delta table)."""
    if index < 0:
        if c >= 3:
            return 0
        idx = -(index + 1)
        idx %= 1 + 2 * (len(_DELTA_PALETTE) - 1)
        result = _DELTA_PALETTE[(idx + 1) >> 1][c] * (-1 if (idx & 1) == 0 else 1)
        if bit_depth > 8:
            result *= 1 << (bit_depth - 8)
        return result
    index = int(index)
    if palette_size <= index < palette_size + _LARGE_CUBE_OFFSET:
        if c >= 3:
            return 0
        i = index - palette_size
        i >>= c * _SMALL_CUBE_BITS
        return _scale4(i % _SMALL_CUBE, bit_depth) + (1 << max(bit_depth - 3, 0))
    if index >= palette_size + _LARGE_CUBE_OFFSET:
        if c >= 3:
            return 0
        i = index - palette_size - _LARGE_CUBE_OFFSET
        if c == 1:
            i //= _LARGE_CUBE
        elif c == 2:
            i //= _LARGE_CUBE * _LARGE_CUBE
        return _scale4(i % _LARGE_CUBE, bit_depth)
    return int(palette[c, index])


def apply_palette(storage, step: PaletteStep):
    """ref palette.rs:169-253 (do_palette_step_general)."""
    buf_in = storage[step.buf_in]
    palette = storage[step.buf_pal].data
    outs = [storage[b] for b in step.buf_out]
    h, w = buf_in.data.shape
    bit_depth = min(buf_in.bit_depth_bits, 24)
    num_colors, num_deltas = step.num_colors, step.num_deltas
    pred = step.predictor

    if w == 0:
        return
    psz = num_colors + num_deltas

    from .. import native

    if num_deltas == 0 and pred == Predictor.ZERO and not native.available():
        idx = buf_in.data
        # vectorized gather with implicit-cube / delta handling per element
        for c, out in enumerate(outs):
            out.data[...] = _palette_lookup_vec(
                palette, idx, c, num_colors, bit_depth
            )
        return

    if native.available():
        import ctypes

        lib = native.get_lib()
        wp = step.wp_header
        wp_params = np.array(
            [wp.p1c, wp.p2c, wp.p3ca, wp.p3cb, wp.p3cc, wp.p3cd, wp.p3ce,
             wp.w0, wp.w1, wp.w2, wp.w3, 0],
            dtype=np.int32,
        )
        idx = np.ascontiguousarray(buf_in.data)
        pal = np.ascontiguousarray(palette)
        for c, out in enumerate(outs):
            dst = np.zeros((h, w), dtype=np.int32)
            lib.jxl_palette_apply(
                native._ptr(idx, ctypes.c_int32), ctypes.c_int(w), ctypes.c_int(h),
                native._ptr(pal, ctypes.c_int32), ctypes.c_int(palette.shape[1]),
                ctypes.c_int(c), native._ptr(dst, ctypes.c_int32),
                ctypes.c_int(num_colors), ctypes.c_int(num_deltas),
                ctypes.c_int(int(pred)), native._ptr(wp_params, ctypes.c_int32),
                ctypes.c_int(bit_depth),
            )
            out.data[...] = dst
        return

    if pred == Predictor.WEIGHTED:
        for c, out in enumerate(outs):
            wp = WeightedPredictorState(step.wp_header, w)
            od = out.data
            for y in range(h):
                row_idx = buf_in.data[y].tolist()
                for x in range(w):
                    index = int(row_idx[x])
                    entry = get_palette_value(palette, index, c, psz, bit_depth)
                    pd = _pd_get(od, x, y, w)
                    wp_pred, _ = wp.predict_and_property(x, y, pd)
                    p = predict_one(pred, pd, wp_pred)
                    val = wrap_i32(p + entry) if index < num_deltas else entry
                    od[y, x] = val
                    wp.update_errors(val, x, y)
    else:
        for c, out in enumerate(outs):
            od = out.data
            for y in range(h):
                row_idx = buf_in.data[y].tolist()
                for x in range(w):
                    index = int(row_idx[x])
                    entry = get_palette_value(palette, index, c, psz, bit_depth)
                    if index < num_deltas:
                        p = predict_one(pred, _pd_get(od, x, y, w), 0)
                        val = wrap_i32(p + entry)
                    else:
                        val = entry
                    od[y, x] = val


def _pd_get(data: np.ndarray, x: int, y: int, w: int):
    """PredictionData::get over a numpy plane (ref predict.rs:129-137)."""
    if x > 0:
        left = int(data[y, x - 1])
    elif y > 0:
        left = int(data[y - 1, 0])
    else:
        left = 0
    if y > 0:
        top = int(data[y - 1, x])
        topleft = int(data[y - 1, x - 1]) if x > 0 else left
        topright = int(data[y - 1, x + 1]) if x + 1 < w else top
        toprightright = int(data[y - 1, x + 2]) if x + 2 < w else topright
    else:
        top = topleft = topright = toprightright = left
    leftleft = int(data[y, x - 2]) if x > 1 else left
    toptop = int(data[y - 2, x]) if y > 1 else top
    return (left, top, toptop, topleft, topright, leftleft, toprightright)


def _palette_lookup_vec(palette: np.ndarray, idx: np.ndarray, c: int, palette_size: int, bit_depth: int):
    """Vectorized get_palette_value for non-delta palettes (the common case)."""
    out = np.zeros(idx.shape, dtype=np.int64)
    neg = idx < 0
    small = (idx >= palette_size) & (idx < palette_size + _LARGE_CUBE_OFFSET)
    large = idx >= palette_size + _LARGE_CUBE_OFFSET
    direct = ~(neg | small | large)

    if direct.any():
        safe = np.where(direct, idx, 0)
        out[direct] = palette[c][safe[direct]]
    if c < 3:
        if neg.any():
            i = -(idx[neg].astype(np.int64) + 1)
            i %= 1 + 2 * (len(_DELTA_PALETTE) - 1)
            table = np.array([d[c] for d in _DELTA_PALETTE], dtype=np.int64)
            vals = table[(i + 1) >> 1] * np.where((i & 1) == 0, -1, 1)
            if bit_depth > 8:
                vals *= 1 << (bit_depth - 8)
            out[neg] = vals
        if small.any():
            i = (idx[small].astype(np.int64) - palette_size) >> (c * _SMALL_CUBE_BITS)
            out[small] = ((i % _SMALL_CUBE) * ((1 << bit_depth) - 1) >> 2) + (
                1 << max(bit_depth - 3, 0)
            )
        if large.any():
            i = idx[large].astype(np.int64) - palette_size - _LARGE_CUBE_OFFSET
            if c == 1:
                i //= _LARGE_CUBE
            elif c == 2:
                i //= _LARGE_CUBE * _LARGE_CUBE
            out[large] = (i % _LARGE_CUBE) * ((1 << bit_depth) - 1) >> 2
    return out.astype(np.int32)


# -- dispatcher ----------------------------------------------------------------


def _unit_rw(unit):
    """(reads, writes) buffer-index sets for a unit (a list of steps)."""
    reads, writes = set(), set()
    for step in unit:
        if isinstance(step, RctStep):
            reads.update(step.buf_in)
            writes.update(step.buf_out)
        elif isinstance(step, SqueezeStep):
            reads.update(step.buf_in)
            writes.add(step.buf_out)
        else:  # PaletteStep
            reads.add(step.buf_in)
            reads.add(step.buf_pal)
            writes.update(step.buf_out)
    return reads, writes


def _build_units(steps):
    """Schedulable units in inverse (decode) order: maximal consecutive
    squeeze runs stay fused (one native chain call) but split into
    buffer-connected components first, so independent chains (distinct
    channels' pyramids) remain separately schedulable; everything else
    is its own unit."""
    rev = list(reversed(steps))
    units = []
    i = 0
    while i < len(rev):
        if isinstance(rev[i], SqueezeStep):
            j = i
            while j < len(rev) and isinstance(rev[j], SqueezeStep):
                j += 1
            run = rev[i:j]
            # union-find over buffer indices: steps sharing any buffer
            # stay in one (order-preserving) chain
            parent: dict = {}

            def find(x):
                while parent.setdefault(x, x) != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for s in run:
                bufs = [s.buf_out, *s.buf_in]
                r0 = find(bufs[0])
                for b in bufs[1:]:
                    parent[find(b)] = r0
            comps: dict = {}
            for s in run:
                comps.setdefault(find(s.buf_out), []).append(s)
            units.extend(comps.values())
            i = j
        else:
            units.append([rev[i]])
            i += 1
    return units


def _apply_one_unit(unit, storage):
    if isinstance(unit[0], SqueezeStep):
        if not _squeeze_chain_native(storage, unit):
            for s in unit:
                if s.horizontal:
                    apply_hsqueeze(storage, s)
                else:
                    apply_vsqueeze(storage, s)
    elif isinstance(unit[0], RctStep):
        apply_rct(storage, unit[0])
    elif isinstance(unit[0], PaletteStep):
        apply_palette(storage, unit[0])
    else:
        raise AssertionError(f"unknown step {unit[0]}")


def _apply_units_parallel(units, storage, n_workers):
    """Dependency-counted concurrent execution (ref step.rs:245-269):
    unit j waits on every earlier unit whose writes intersect j's
    reads/writes or whose reads intersect j's writes. Ready units run on
    a thread pool; any worker exception cancels the remainder and
    re-raises (partial mutation only matters on error paths, where the
    caller discards the frame)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    rw = [_unit_rw(u) for u in units]
    n = len(units)
    deps = [0] * n
    dependents: list[list[int]] = [[] for _ in range(n)]
    for j in range(n):
        rj, wj = rw[j]
        for i in range(j):
            ri, wi = rw[i]
            if wi & (rj | wj) or ri & wj:
                deps[j] += 1
                dependents[i].append(j)

    lock = threading.Lock()
    done = threading.Event()
    state = {"remaining": n, "error": None}

    with ThreadPoolExecutor(max_workers=min(n_workers, n)) as pool:
        def run(idx):
            try:
                _apply_one_unit(units[idx], storage)
            except BaseException as e:  # propagate bitstream/assertion errors
                with lock:
                    state["error"] = state["error"] or e
                    state["remaining"] = 0
                done.set()
                return
            ready = []
            with lock:
                if state["error"] is not None:
                    return
                state["remaining"] -= 1
                if state["remaining"] == 0:
                    done.set()
                for j in dependents[idx]:
                    deps[j] -= 1
                    if deps[j] == 0:
                        ready.append(j)
            for j in ready:
                pool.submit(run, j)

        initial = [i for i in range(n) if deps[i] == 0]
        for i in initial:
            pool.submit(run, i)
        done.wait()
    if state["error"] is not None:
        raise state["error"]


def inverse_apply_steps(steps, storage):
    """Inverse-apply transform steps in reverse order (decode direction).

    Maximal runs of squeeze steps go through ONE native call
    (jxl_squeeze_chain) — animations run ~24 per frame on the alpha
    channel and the per-step ctypes round trips dominated the math.

    With JXL_TPU_THREADS > 1, independent units run concurrently via a
    dependency-counted scheduler (ref transforms/step.rs:245-269) — the
    native squeeze/RCT kernels release the GIL, so distinct channels'
    chains genuinely parallelize; order among independent units cannot
    change outputs, so the result is bit-exact vs the serial walk."""
    import os

    n_workers = int(os.environ.get("JXL_TPU_THREADS", "0")) or (
        os.cpu_count() or 1
    )
    if n_workers > 1 and len(steps) > 1:
        units = _build_units(steps)
        if len(units) > 1:
            _apply_units_parallel(units, storage, n_workers)
            return
    rev = list(reversed(steps))
    i = 0
    while i < len(rev):
        step = rev[i]
        if isinstance(step, RctStep):
            apply_rct(storage, step)
            i += 1
        elif isinstance(step, SqueezeStep):
            j = i
            while j < len(rev) and isinstance(rev[j], SqueezeStep):
                j += 1
            if not _squeeze_chain_native(storage, rev[i:j]):
                for s in rev[i:j]:
                    if s.horizontal:
                        apply_hsqueeze(storage, s)
                    else:
                        apply_vsqueeze(storage, s)
            i = j
        elif isinstance(step, PaletteStep):
            apply_palette(storage, step)
            i += 1
        else:
            raise AssertionError(f"unknown step {step}")


def _squeeze_chain_native(storage, steps) -> bool:
    """Submit a run of inverse squeeze steps as one native call. Returns
    False (caller falls back per-step) when the library is unavailable or
    any buffer is non-contiguous — pointers are snapshotted BEFORE the
    chain runs, so a lazily-copied non-contiguous input would break the
    step-to-step aliasing the chain relies on."""
    from .. import native

    lib = native.get_lib()
    if lib is None:
        return False
    import ctypes

    recs = np.empty((len(steps), 11), dtype=np.int64)
    n = 0
    for step in steps:
        out = storage[step.buf_out].data
        if out.size == 0:
            continue  # apply_{h,v}squeeze early-return shapes
        avg = storage[step.buf_in[0]].data
        res = storage[step.buf_in[1]].data
        for a in (out, avg, res):
            if a.dtype != np.int32 or not a.flags.c_contiguous:
                return False
        if step.horizontal:
            h, wo = out.shape
            recs[n] = (
                1, avg.ctypes.data, avg.shape[1] if avg.size else 0,
                res.ctypes.data, res.shape[1] if res.size else 0,
                out.ctypes.data, wo, h, avg.shape[1], res.shape[1], wo,
            )
        else:
            ho, w = out.shape
            recs[n] = (
                0, avg.ctypes.data, avg.shape[1] if avg.size else 0,
                res.ctypes.data, res.shape[1] if res.size else 0,
                out.ctypes.data, w, w, avg.shape[0], res.shape[0], ho,
            )
        n += 1
    if n:
        lib.jxl_squeeze_chain(
            ctypes.c_int(n), native._ptr(recs, ctypes.c_int64)
        )
    return True
