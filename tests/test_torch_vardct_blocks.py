"""The 4:4:4 VarDCT block render (ops/vardct_blocks.py, K5 on the card).

On the CPU: the render's block tables from the native pass
(vardct/device_frame.py:block_tables: placed_blocks, frame_columns,
subsampled_jobs) against their numpy oracle (placed_blocks_oracle) bit
for bit, over the whole frame, bands, tiles, group lists out of order,
subsampled frames, the host route and the batched animation; the
per-type columns (frame_columns, render/batch_anim.py:_block_tables)
against the formulas the render used before them (each block's first
coefficient, LF index, first pixel, raw quant and colour tile); what the
pass refuses; its counter; the wrapper's argument checks, which raise
ValueError before any build; the constants' layout against the kernel
source's.

On the card (`cuda` marker; this module imports no JAX, so it runs
there with `python -m pytest --noconftest tests/test_torch_vardct_blocks.py
-m cuda`): K5 against its plain version for each of the 27 types, with
the tolerance below; calls of 1, 7, 256 and 3000 blocks against one call,
bit for bit; decode_banded, the band route, the tiles of the sharded
render and the batched animation route against the whole frame or the
per-frame loop, bit for bit; blocks whose columns pass 2^31; the launch
counters of a 4K frame.
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu_torch.ops import vardct_blocks as K
from jxl_tpu_torch.vardct import device_frame as DF
from jxl_tpu_torch.vardct.transform_map import covered_blocks_x, covered_blocks_y
from test_torch_frame_streams import anim_replace_stream
from test_torch_vardct_streams import encode_xyb_vardct

STRIDE = 3 * 256 * 256
STREAMS = {
    # 3x3 groups, the last group row and column short
    "mixed_520x516": lambda: encode_xyb_vardct(520, 516, seed=3, density=0.1),
    # a group row each of DCT256, DCT128, DCT64, DCT32 and the DCT16 fill
    "large_520x1040": lambda: encode_xyb_vardct(520, 1040, seed=10, density=0.1,
                                                transforms="large"),
}
_CACHE = {}
# K5 against its plain version on the card, max abs difference over
# pixels of order 1: the kernel sums each product in index order with fused
# multiply-adds, cuBLAS in its own order
TOLERANCE = 2e-6


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()[0]
    return _CACHE[name]


def _frame(data):
    """The port's parse of a one-frame stream up to HfGlobal: the maps the
    block tables read."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(frame.header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    frame.decode_hf_global(sections[frame.section_index("hf_global")])
    frame.finalize_lf()
    return frame


def _regions(frame) -> dict:
    """{name: (group_ids, by0, by1, bx0, bx1)}: the whole frame, each band,
    each tile of a 2x2 sharded grid."""
    from jxl_tpu_torch.parallel.sharded_render import frame_tiles
    from jxl_tpu_torch.vardct.device_band import band_block_rows, band_groups

    bw, bh = frame.header.size_blocks()
    out = {"whole": (list(range(frame.header.num_groups)), 0, bh, 0, bw)}
    for gy in range(frame.header.size_groups()[1]):
        out[f"band{gy}"] = (band_groups(frame, gy), *band_block_rows(frame, gy), 0, bw)
    for i, tile in enumerate(frame_tiles(SimpleNamespace(ny=2, nx=2), frame)):
        if not tile.empty:
            by0, by1, bx0, bx1 = tile.blocks
            out[f"tile{i}"] = (list(tile.groups), by0, by1, bx0, bx1)
    return out


def placed_blocks_oracle(frame, group_ids: list, by0: int = 0) -> tuple:
    """The numpy construction of vardct/device_frame.py:placed_blocks, the
    oracle of the native block tables: (tid, gbx, gby, group index,
    coefficient offset) int64 arrays, the groups in list order and each
    group's blocks in raster order, offsets restarting at each group."""
    header = frame.header
    tmap = np.asarray(frame.hf_meta["transform"])
    gdb = header.group_dim // 8
    gx_count, gy_count = header.size_groups()
    ys, xs = np.nonzero(tmap >= 128)
    slot = np.full(gx_count * gy_count, -1, np.int64)
    slot[list(group_ids)] = np.arange(len(group_ids))
    gi = slot[(ys // gdb) * gx_count + xs // gdb]
    keep = gi >= 0
    ys, xs, gi = ys[keep], xs[keep], gi[keep]
    order = np.lexsort((xs, ys, gi))  # by group, then raster within it
    ys, xs, gi = ys[order], xs[order], gi[order]
    tids = (tmap[ys, xs] & 127).astype(np.int64)
    sizes = DF._BLOCK_COEFFS[tids]
    offs = np.cumsum(sizes) - sizes
    first = np.r_[True, gi[1:] != gi[:-1]] if len(gi) else np.zeros(0, bool)
    offs -= offs[np.maximum.accumulate(np.where(first, np.arange(len(gi)), 0))]
    return tids, xs.astype(np.int64), ys.astype(np.int64) - by0, gi, offs


def oracle_by_type(frame, group_ids: list, by0: int = 0) -> dict:
    """placed_blocks_oracle by type: {tid: (gbx, gby, group index,
    coefficient offset)}, each type's blocks in placement order."""
    tids, *cols = placed_blocks_oracle(frame, group_ids, by0)
    return {t: tuple(a[tids == t] for a in cols) for t in np.unique(tids).tolist()}


def oracle_columns(frame, group_ids: list, by0: int, bx0: int, bx1: int) -> dict:
    """frame_columns from the oracle's blocks and block_columns."""
    bw = frame.header.size_blocks()[0]
    tids, gbx, gby, gi, off = placed_blocks_oracle(frame, group_ids, by0)
    return K.block_columns(tids, gbx, gby, gi * STRIDE + off, bw, (bx1 - bx0) * 8, bx0)


def _assert_same(got, want):
    """Bit for bit: the same keys in the same order, arrays of the same
    dtype, shape and values."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _assert_columns(cols, want):
    """cols: (n, 4) int64; want: the former render's arrays of those blocks."""
    assert cols.dtype == np.int64 and cols.shape == (len(want["base"]), 4)
    np.testing.assert_array_equal(cols[:, 0], want["base"])
    np.testing.assert_array_equal(cols[:, 1], want["lf0"])
    np.testing.assert_array_equal(cols[:, 2], want["pix0"])
    # the raw quant sits on the LF grid; the colour tiles at column 3
    np.testing.assert_array_equal(want["rq_table"][cols[:, 1]], want["rq"])
    np.testing.assert_array_equal(want["ytox_table"][cols[:, 3]], want["ytox"])
    np.testing.assert_array_equal(want["ytob_table"][cols[:, 3]], want["ytob"])


@pytest.mark.parametrize("name", list(STREAMS))
def test_frame_columns_equal_the_former_tables(name):
    frame = _frame(_stream(name))
    bw = frame.header.size_blocks()[0]
    hf = frame.hf_meta
    regions = _regions(frame)
    assert {"whole", "band1", "tile3"} <= set(regions)
    for region, (groups, by0, by1, bx0, bx1) in regions.items():
        got = DF.frame_columns(frame, groups, by0, bx0, bx1)
        rq, ytox, ytob, _ = DF._frame_tables(frame, by0, by1)
        W = (bx1 - bx0) * 8
        _assert_same(got, oracle_columns(frame, groups, by0, bx0, bx1))
        _assert_same(DF.placed_blocks(frame, groups, by0),
                     placed_blocks_oracle(frame, groups, by0))
        # the former render_block_rows' arithmetic, type by type
        blocks = oracle_by_type(frame, groups, by0)
        assert sorted(got) == sorted(blocks), region
        for t, (gbx, gby, gi, off) in blocks.items():
            _assert_columns(got[t], {
                "base": gi * STRIDE + off, "lf0": gby * bw + gbx,
                "pix0": gby * (8 * W) + (gbx - bx0) * 8,
                "rq_table": rq.reshape(-1), "rq": hf["raw_quant"][by0 + gby, gbx],
                "ytox_table": ytox.reshape(-1), "ytox": hf["ytox"][(by0 + gby) // 8, gbx // 8],
                "ytob_table": ytob.reshape(-1), "ytob": hf["ytob"][(by0 + gby) // 8, gbx // 8]})
            assert (gbx >= bx0).all() and (gbx < bx1).all(), (region, t)


def test_batched_columns_equal_the_former_tables(monkeypatch):
    """_block_tables of a batched animation (every frame's blocks in one
    call a type): the former per-block arrays, frame by frame."""
    from jxl_tpu_torch.render import batch_anim

    seen = []
    real = batch_anim._block_tables

    def spy(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(batch_anim, "_block_tables", spy)
    monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "1")
    monkeypatch.setenv("JXL_TPU_AC", "host")
    data = anim_replace_stream(320, 200, 5, seed=8)
    jxl_tpu_torch.decode_image(data, pixel_format="f32", device="cpu")
    assert len(seen) == 1
    (frames, slots, cbh, cbw, Hp, Wp), (tables, per_type) = seen[0]
    F = len(frames)
    assert F == 5
    tch, tcw = -(-cbh // 8), -(-cbw // 8)
    rq_t, yx_t, yb_t = tables
    assert rq_t.dtype == np.int32 and rq_t.shape == (F * cbh * cbw,)
    rows = []  # the former arrays: (tid, base, lf0, pix0, rq, ytox, ytob, frame)
    for f, fr in enumerate(frames):
        tid, gbx, gby, gi, off = placed_blocks_oracle(fr, list(range(fr.header.num_groups)))
        hf = fr.hf_meta
        rows.append((tid, (gi + slots[f]) * STRIDE + off, f * (cbh * cbw) + gby * cbw + gbx,
                     f * (Hp * Wp) + gby * (8 * Wp) + gbx * 8, hf["raw_quant"][gby, gbx],
                     hf["ytox"][gby // 8, gbx // 8], hf["ytob"][gby // 8, gbx // 8],
                     np.full(len(tid), f)))
    tid, base, lf0, pix0, rq, yx, yb, fidx = map(np.concatenate, zip(*rows))
    order = np.argsort(tid, kind="stable")
    k_all = np.concatenate([DF.frame_factors(fr) for fr in frames], axis=1)
    assert sorted(per_type) == sorted(np.unique(tid).tolist())
    for t, (cols, k, mats) in per_type.items():
        sel = order[tid[order] == t]
        _assert_columns(cols, {"base": base[sel], "lf0": lf0[sel], "pix0": pix0[sel],
                               "rq_table": rq_t, "rq": rq[sel], "ytox_table": yx_t,
                               "ytox": yx[sel], "ytob_table": yb_t, "ytob": yb[sel]})
        np.testing.assert_array_equal(k, k_all[:, fidx[sel]])
        nc = covered_blocks_x(t) * covered_blocks_y(t) * 64
        assert mats.shape == (1, 3, nc)  # one set of tables in this animation
    assert tch * tcw * F == yx_t.size


def test_block_columns_refuse_negative_columns():
    one = np.zeros(1, np.int64)
    with pytest.raises(ValueError):
        K.block_columns(one, one, one, one - 1, 8, 64)
    with pytest.raises(ValueError):
        K.block_columns(one, one + 1, one, one, 8, 64, bx0=2)


def test_block_columns_hold_a_frame_past_int32():
    """A 4:4:4 frame of 190 x 190 groups (48640 px a side, 28 GB of
    coefficients and as much of planes): slots past 10,922 put the first
    coefficient past 2^31, block rows past 5,518 the first pixel; the
    columns keep both whole."""
    bw = 190 * 32
    W = bw * 8
    slot = np.array([0, 10_924, 190 * 190 - 1], np.int64)
    off = np.array([64, 0, 65_472], np.int64)
    gbx = np.array([0, 17, bw - 1], np.int64)
    gby = np.array([0, 2_000, bw - 1], np.int64)
    tids = np.array([0, 0, 3], np.int64)
    cols = K.block_columns(tids, gbx, gby, slot * STRIDE + off, bw, W)
    assert sorted(cols) == [0, 3] and all(c.dtype == np.int64 for c in cols.values())
    got = np.concatenate([cols[0], cols[3]])
    assert got[1, 0] == 10_924 * STRIDE > 1 << 31
    np.testing.assert_array_equal(got[:, 0], slot * STRIDE + off)
    np.testing.assert_array_equal(got[:, 1], gby * bw + gbx)
    np.testing.assert_array_equal(got[:, 2], gby * 8 * W + gbx * 8)
    assert got[2, 2] > 1 << 31
    np.testing.assert_array_equal(got[:, 3], (gby // 8) * (bw // 8) + gbx // 8)


def _fake_frame(tmap, group_dim: int = 256, hshift=(0, 0, 0), vshift=(0, 0, 0)):
    """A frame with only what the block tables read: its header's sizes
    and shifts and its (bh, bw) transform map."""
    bh, bw = tmap.shape
    gdb = group_dim // 8
    gx, gy = -(-bw // gdb), -(-bh // gdb)
    header = SimpleNamespace(
        group_dim=group_dim, num_groups=gx * gy, size_groups=lambda: (gx, gy),
        size_blocks=lambda: (bw, bh), hshift=lambda c: hshift[c], vshift=lambda c: vshift[c],
        is444=not any(hshift) and not any(vshift))
    return SimpleNamespace(header=header, hf_meta={"transform": tmap})


def _without_group(frame, g: int):
    """frame's transform map with group g's blocks unplaced."""
    tmap = np.array(frame.hf_meta["transform"])
    gdb = frame.header.group_dim // 8
    gx = frame.header.size_groups()[0]
    tmap[(g // gx) * gdb : (g // gx + 1) * gdb, (g % gx) * gdb : (g % gx + 1) * gdb] &= 127
    return _fake_frame(tmap, frame.header.group_dim)


# (groups, by0, bx0, bx1) of the 3x3 groups of mixed_520x516, or a frame
# made from it
_GROUP_LISTS = {
    "reversed": lambda f: (f, list(range(9))[::-1], 0, 0, None),
    "out_of_raster": lambda f: (f, [4, 0, 8, 2, 6, 1, 3, 5, 7], 0, 0, None),
    "listed_twice": lambda f: (f, [0, 4, 0, 2, 1, 3, 5, 6, 7, 8], 0, 0, None),
    "tile_out_of_order": lambda f: (f, [5, 4, 2, 1], 0, 32, 65),
    "band_out_of_order": lambda f: (f, [5, 3, 4], 32, 0, None),
    "no_groups": lambda f: (f, [], 0, 0, None),
    "no_placed_blocks": lambda f: (_without_group(f, 4), [4], 32, 32, 64),
}


@pytest.mark.parametrize("case", list(_GROUP_LISTS))
def test_native_tables_follow_the_group_list(case):
    """placed_blocks and frame_columns equal the oracle bit for bit for
    group lists out of raster order, a group listed twice (its last slot
    holds it) and regions with no placed block."""
    frame, groups, by0, bx0, bx1 = _GROUP_LISTS[case](_frame(_stream("mixed_520x516")))
    bx1 = frame.header.size_blocks()[0] if bx1 is None else bx1
    want = placed_blocks_oracle(frame, groups, by0)
    _assert_same(DF.placed_blocks(frame, groups, by0), want)
    _assert_same(DF.frame_columns(frame, groups, by0, bx0, bx1),
                 oracle_columns(frame, groups, by0, bx0, bx1))
    assert (len(want[0]) == 0) == (case in ("no_groups", "no_placed_blocks"))


@pytest.mark.parametrize("subsampling", ["420", "422", "440"])
def test_subsampled_jobs_equal_the_oracle(subsampling):
    """The jobs of a chroma-subsampled render: channel outer, types
    ascending, each job's rows gbx, gby, group slot and offset of the
    blocks aligned to its channel's grid, as the former mask loop over
    the oracle's blocks made them."""
    data = encode_xyb_vardct(520, 516, seed=21, density=0.05, transforms="dct8",
                             subsampling=subsampling)[0]
    frame = _frame(data)
    header = frame.header
    assert not header.is444
    types, jobs = DF.subsampled_jobs(frame)
    blocks = oracle_by_type(frame, list(range(header.num_groups)))
    want = {}
    for c in range(3):
        hs, vs = header.hshift(c), header.vshift(c)
        for t in sorted(blocks):
            gbx, gby = blocks[t][:2]
            m = (((gbx >> hs) << hs) == gbx) & (((gby >> vs) << vs) == gby)
            if m.any():
                want[(c, t)] = np.stack([a[m] for a in blocks[t]])
    assert types == sorted(blocks)
    _assert_same(jobs, want)
    sizes = [jobs[(c, 0)].shape[1] for c in range(3)]
    assert sizes[0] == sizes[2] < sizes[1]  # Y at full resolution


# decodes whose frames go through placed_blocks: (stream, environment)
_PLACED_ROUTES = {
    "host_still": (lambda: _stream("mixed_520x516"), {"JXL_TPU_DEVICE": "off"}),
    "batched_animation": (lambda: anim_replace_stream(320, 200, 5, seed=8),
                          {"JXL_TPU_BATCH_ANIM": "1", "JXL_TPU_AC": "host"}),
    "batched_animation_host": (lambda: anim_replace_stream(320, 200, 5, seed=8),
                               {"JXL_TPU_BATCH_ANIM": "1", "JXL_TPU_DEVICE": "off"}),
}


@pytest.mark.parametrize("route", list(_PLACED_ROUTES))
def test_placed_blocks_of_the_host_route_and_the_batched_animation(route, monkeypatch):
    """placed_blocks as the host route (vardct/group.py:render_blocks_host)
    and the batched animation (render/batch_anim.py) call it: every call's
    rows equal the oracle's bit for bit."""
    stream, env = _PLACED_ROUTES[route]
    calls = []
    real = DF.placed_blocks

    def spy(frame, group_ids, by0=0):
        out = real(frame, group_ids, by0)
        calls.append((frame, list(group_ids), by0, out))
        return out

    monkeypatch.setattr(DF, "placed_blocks", spy)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jxl_tpu_torch.decode_image(stream(), pixel_format="f32", device="cpu")
    assert len(calls) == (1 if route == "host_still" else 5)
    for frame, groups, by0, out in calls:
        assert groups == list(range(frame.header.num_groups))
        _assert_same(out, placed_blocks_oracle(frame, groups, by0))


def _with_transform(value: int):
    def make(frame):
        tmap = np.array(frame.hf_meta["transform"])
        tmap[40, 40] = value
        return _fake_frame(tmap, frame.header.group_dim)
    return make


def _call_native(**bad):
    """native.block_tables_native on a 2x2-group map, with `bad` replacing
    arguments."""
    from jxl_tpu_torch import native

    args = dict(tmap=np.full((64, 64), 128, np.uint8), group_ids=np.arange(4, dtype=np.int32),
                num_groups=4, gxc=2, gdim_blocks=32, hshift3=np.zeros(3, np.int32),
                vshift3=np.zeros(3, np.int32), block_coeffs=DF._BLOCK_COEFFS,
                group_stride=STRIDE, layout=1, W=512)
    args.update(bad)
    return native.block_tables_native(**args)


# each case: (what it breaks, the error it raises)
_REFUSED = {
    "transform_27_placed": (lambda f: DF.placed_blocks(_with_transform(128 + 27)(f), [4]),
                            "NativeDecodeError"),
    "transform_27_columns": (lambda f: DF.frame_columns(_with_transform(128 + 27)(f), [4], 32,
                                                        32, 64), "NativeDecodeError"),
    "transform_127_jobs": (lambda f: DF.block_tables(_with_transform(255)(f), [4], 2),
                           "NativeDecodeError"),
    "negative_column": (lambda f: DF.frame_columns(f, [0], 0, 1, 32), "ValueError"),
    "row_above_by0": (lambda f: DF.frame_columns(f, [0], 8, 0, 65), "ValueError"),
    "group_past_the_frame": (lambda f: DF.placed_blocks(f, [9]), "ValueError"),
    "negative_group": (lambda f: DF.placed_blocks(f, [-1]), "ValueError"),
    "tmap_int32": (lambda f: _call_native(tmap=np.full((64, 64), 128, np.int32)),
                   "ValueError"),
    "tmap_strided": (lambda f: _call_native(tmap=np.full((64, 128), 128, np.uint8)[:, ::2]),
                     "ValueError"),
    "group_ids_int64": (lambda f: _call_native(group_ids=np.arange(4)), "ValueError"),
    "shifts_of_two_channels": (lambda f: _call_native(hshift3=np.zeros(2, np.int32)),
                               "ValueError"),
    "shift_of_4": (lambda f: _call_native(vshift3=np.array([0, 4, 0], np.int32)), "ValueError"),
    "block_coeffs_int32": (lambda f: _call_native(block_coeffs=np.zeros(27, np.int32)),
                           "ValueError"),
    "layout_3": (lambda f: _call_native(layout=3), "ValueError"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_native_tables_refuse(case):
    """A transform id past the 27 raises NativeDecodeError; a negative
    column (as block_columns refuses it), a group past the frame and
    arrays the pass cannot take raise ValueError."""
    from jxl_tpu_torch.errors import NativeDecodeError

    call, error = _REFUSED[case]
    frame = _frame(_stream("mixed_520x516"))
    with pytest.raises({"NativeDecodeError": NativeDecodeError, "ValueError": ValueError}[error]):
        call(frame)


def test_native_columns_hold_a_frame_past_int32():
    """The columns of a 4:4:4 frame of 190 x 190 groups (48640 px a side):
    a block in slot 10,924 has its first coefficient past 2^31, the last
    block row its first pixel; the native columns equal the oracle's."""
    side = 190 * 32
    tmap = np.zeros((side, side), np.uint8)
    tmap[0, 0] = tmap[57 * 32 + 3, 94 * 32 + 17] = 128  # DCT8; group 57 * 190 + 94
    tmap[side - 2, side - 2] = 128 + 3  # DCT16 at the last group's end
    tmap[side - 1, 5] = 128 + 1
    frame = _fake_frame(tmap)
    groups = list(range(190 * 190))
    cols = DF.frame_columns(frame, groups, 0, 0, side)
    _assert_same(cols, oracle_columns(frame, groups, 0, 0, side))
    assert list(cols) == [0, 1, 3]
    assert cols[0][1, 0] == (57 * 190 + 94) * STRIDE > 1 << 31
    assert cols[1][0, 2] == (side - 1) * 8 * side * 8 + 5 * 8 > 1 << 31
    _assert_same(DF.placed_blocks(frame, groups), placed_blocks_oracle(frame, groups))


def _stream_4k():
    if "4k" not in _CACHE:
        _CACHE["4k"] = encode_xyb_vardct(3840, 2160, seed=7)[0]
    return _CACHE["4k"]


@pytest.mark.parametrize("traced", [True, False])
def test_block_tables_built_counts_each_render_call(traced, monkeypatch):
    """block_tables_built counts one for each render of block rows of a
    4K frame, as many as the render calls that launch K5 (the whole frame,
    then each band of the banded decode), and none with tracing off."""
    from jxl_tpu_torch.utils import trace
    from jxl_tpu_torch.vardct.device_band import BandRenderer

    frame = _frame(_stream_4k())
    launches = []
    # K5 is the card's; the count is the host's, so no block is rendered
    monkeypatch.setattr(DF, "vardct_blocks", lambda t, *args: launches.append(t))
    flat = torch.zeros(1, dtype=torch.int32)
    renders = 0
    trace.enable(traced)
    trace.reset()
    try:
        DF.render_vardct_frame_device(frame, flat)
        renders += 1
        band = BandRenderer(frame)
        for gy in range(frame.header.size_groups()[1]):
            band.render(gy, flat)
            renders += 1
        counted = trace.metrics.get("block_tables_built")
    finally:
        trace.enable(False)
        trace.reset()
    assert renders == 10 and len(launches) > renders
    assert counted == (renders if traced else 0)


def _random_blocks(t: int, n: int, seed: int, device, per_block: bool = False) -> dict:
    """vardct_blocks' arguments for n random blocks of type t side by side
    in one row of blocks (seeded numpy), on `device`: quantized values in
    [-6, 6] with 40% zeros, LF and colour tiles of order 1, dequant weights
    in [0.01, 2], so that pixels are of order 1. per_block: a column of
    factors and a row of weights a block, as the batched animation route
    gives when its frames' tables differ."""
    rng = np.random.default_rng(seed)
    cx, cy = covered_blocks_x(t), covered_blocks_y(t)
    nc = cx * cy * 64
    flat = rng.integers(-6, 7, n * nc + STRIDE).astype(np.int32)
    flat[rng.random(flat.shape) < 0.4] = 0
    bw = n * cx + 3
    cols = np.stack([np.arange(n) * nc + rng.integers(0, 100, n), np.arange(n) * cx + 1,
                     np.arange(n) * cx * 8 + 8, rng.integers(0, 5, n)], 1).astype(np.int64)
    k = np.array([1.1, 0.9, 1.0 / 512, 84.0, 0.0, 1.0], np.float32).reshape(6, 1)
    mats = rng.uniform(0.01, 2.0, (n if per_block else 1, 3, nc)).astype(np.float32)
    if per_block:
        k = (k * rng.uniform(0.8, 1.2, (6, n))).astype(np.float32)
    arrays = dict(
        flat=flat, cols=cols, lf=rng.normal(0, 0.5, (3, cy * bw)).astype(np.float32),
        rq=rng.integers(1, 60, cy * bw).astype(np.int32),
        ytox=rng.normal(0, 3, 5).astype(np.float32), ytob=rng.normal(0, 3, 5).astype(np.float32),
        k=k, bias=np.array([-0.05, -0.06, -0.07, 0.145], np.float32), mats=mats)
    out = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for name, a in arrays.items()}
    out.update(lf_stride=bw, W=bw * 8,
               planes=torch.zeros((3, cy * 8 * bw * 8), dtype=torch.float32, device=device))
    return out


def _call(fn, t: int, a: dict, cols=None) -> torch.Tensor:
    """fn (vardct_blocks or its plain version) on a copy of a's planes."""
    planes = a["planes"].clone()
    fn(t, a["flat"], a["cols"] if cols is None else cols, a["lf"], a["lf_stride"], a["rq"],
       a["ytox"], a["ytob"], a["k"], a["bias"], a["mats"], planes, a["W"])
    return planes


# each case breaks one argument of a valid call
_BAD = {
    "type_27": lambda a: a.update(t=27),
    "flat_int64": lambda a: a.update(flat=a["flat"].long()),
    "flat_2d": lambda a: a.update(flat=a["flat"].reshape(-1, 2)),
    "cols_int32": lambda a: a.update(cols=a["cols"].int()),
    "cols_3_wide": lambda a: a.update(cols=a["cols"][:, :3].contiguous()),
    "cols_strided": lambda a: a.update(cols=a["cols"].t().contiguous().t()),
    "lf_2_rows": lambda a: a.update(lf=a["lf"][:2]),
    "lf_float64": lambda a: a.update(lf=a["lf"].double()),
    "lf_column_stride": lambda a: a.update(lf=a["lf"][:, ::2]),
    "rq_float": lambda a: a.update(rq=a["rq"].float()),
    "ytox_strided": lambda a: a.update(ytox=a["ytox"][::2]),
    "k_5_rows": lambda a: a.update(k=a["k"][:5]),
    "k_2_columns": lambda a: a.update(k=a["k"].repeat(1, 2)),
    "k_strided": lambda a: a.update(k=a["k"].repeat(1, 3).t().contiguous().t()),
    "bias_3": lambda a: a.update(bias=a["bias"][:3]),
    "mats_2_rows": lambda a: a.update(mats=a["mats"].repeat(2, 1, 1)),
    "mats_other_type": lambda a: a.update(mats=a["mats"][:, :, :32].contiguous()),
    "mats_strided": lambda a: a.update(mats=a["mats"].repeat(1, 1, 2)[:, :, ::2]),
    "planes_int32": lambda a: a.update(planes=a["planes"].int()),
    "planes_column_stride": lambda a: a.update(planes=a["planes"][:, ::2]),
    "W_zero": lambda a: a.update(W=0),
    "lf_stride_zero": lambda a: a.update(lf_stride=0),
    "planes_not_a_tensor": lambda a: a.update(planes=a["planes"].numpy()),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_wrapper_refuses_bad_arguments_before_any_build(case, monkeypatch):
    def no_build(*args, **kw):
        raise AssertionError("the kernel was built for arguments it refuses")

    monkeypatch.setattr(K._nvcc, "build", no_build)
    a = _random_blocks(0, 3, seed=1, device="cpu")
    a["t"] = 0
    _BAD[case](a)
    with pytest.raises(ValueError):
        K.vardct_blocks(a["t"], a["flat"], a["cols"], a["lf"], a["lf_stride"], a["rq"],
                        a["ytox"], a["ytob"], a["k"], a["bias"], a["mats"], a["planes"], a["W"])


def test_constants_follow_the_kernels_layout():
    """constants() as csrc/vardct_blocks.cu reads it: IDCT(1..256), DCT(1..256),
    the scales of sides 1..32, the AFV basis."""
    src = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                            "vardct_blocks.cu")).read()
    total = int(re.search(r"kIdctTotal = (\d+);", src).group(1))
    assert total == sum(n * n for n in K._SIDES)
    assert "kScalesOff = 2 * kIdctTotal" in src and "kAfvOff = kScalesOff + 63" in src
    c = K.constants()
    assert c.dtype == np.float32 and c.shape == (2 * total + 63 + 256,)
    from jxl_tpu_torch.vardct.transforms import dct_matrix, dct_scales, idct_matrix

    at = sum(n * n for n in (1, 2, 4, 8))  # IDCT(16)
    np.testing.assert_array_equal(c[at : at + 256].reshape(16, 16), idct_matrix(16))
    np.testing.assert_array_equal(c[total + at : total + at + 256].reshape(16, 16),
                                  dct_matrix(16))
    np.testing.assert_array_equal(c[2 * total + 15 : 2 * total + 31], dct_scales(16))


def test_the_cpu_takes_the_plain_version():
    """On the CPU the wrapper runs the plain version and launches nothing."""
    a = _random_blocks(14, 4, seed=2, device="cpu")
    before = K.vardct_blocks.launches
    got = _call(K.vardct_blocks, 14, a)
    assert torch.equal(got, _call(K.vardct_blocks_reference, 14, a))
    assert K.vardct_blocks.launches == before and got.abs().max() > 0.1


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K5 runs only there")
    return torch.device("cuda")


def _blocks_of(t: int) -> int:
    """Blocks a card test renders of type t: 3000 of the small types, fewer
    of the large (their planes grow with the side)."""
    return {1: 3000, 2: 1500, 4: 1000, 8: 500, 16: 200, 32: 100, 64: 40, 128: 20,
            256: 12, 512: 6, 1024: 3}[covered_blocks_x(t) * covered_blocks_y(t)]


def plain_differences(device) -> dict:
    """{type: max abs difference of K5 from its plain version, both
    variants of factors and weights}: what TOLERANCE is set from."""
    out = {}
    for t in range(27):
        worst = 0.0
        for per_block in (False, True):
            a = _random_blocks(t, min(_blocks_of(t), 256), 100 + t, device, per_block)
            got = _call(K.vardct_blocks, t, a)
            want = _call(K.vardct_blocks_reference, t, a)
            assert want.abs().max() > 0.1  # pixels of order 1
            worst = max(worst, float((got - want).abs().max()))
        out[t] = worst
    return out


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    before = K.vardct_blocks.launches
    diffs = plain_differences(cuda_device)
    assert K.vardct_blocks.launches == before + 54
    assert max(diffs.values()) <= TOLERANCE, diffs


@pytest.mark.cuda
@pytest.mark.parametrize("t", range(27))
def test_calls_of_any_size_agree_bit_for_bit_on_card(t, cuda_device):
    n = _blocks_of(t)
    a = _random_blocks(t, n, 200 + t, cuda_device)
    whole = _call(K.vardct_blocks, t, a)
    for size in (1, 7, 256, 3000):
        parts = a["planes"].clone()
        for i in range(0, n, size):
            K.vardct_blocks(t, a["flat"], a["cols"][i : i + size], a["lf"], a["lf_stride"],
                            a["rq"], a["ytox"], a["ytob"], a["k"], a["bias"], a["mats"], parts,
                            a["W"])
        assert torch.equal(parts, whole), size


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0, 4])
def test_columns_past_int32_on_card(t, cuda_device):
    """Blocks whose first coefficient and first pixel lie past 2^31 (a
    frame of more than 10,922 groups; 35 GB of card memory): their pixels
    equal the same blocks' at small offsets, bit for bit, and nothing
    else is written."""
    n = 40
    a = _random_blocks(t, n, 300 + t, cuda_device)
    want = _call(K.vardct_blocks, t, a)
    far = 1 << 31
    shift = -(-far // a["W"]) * a["W"]  # whole pixel rows
    flat = torch.zeros(far + a["flat"].numel(), dtype=torch.int32, device=cuda_device)
    flat[far:] = a["flat"]
    cols = a["cols"].clone()
    cols[:, 0] += far
    cols[:, 2] += shift
    planes = torch.zeros((3, shift + a["planes"].shape[1]), dtype=torch.float32,
                         device=cuda_device)
    K.vardct_blocks(t, flat, cols, a["lf"], a["lf_stride"], a["rq"], a["ytox"], a["ytob"],
                    a["k"], a["bias"], a["mats"], planes, a["W"])
    assert torch.equal(planes[:, shift:], want)
    for c in range(3):  # a reduction a channel: no temporary the size of the planes
        lo, hi = torch.aminmax(planes[c, :shift])
        assert float(lo) == float(hi) == 0.0, c
    del flat, planes
    torch.cuda.empty_cache()


def _decode(data, **env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return jxl_tpu_torch.decode_image(data, pixel_format="f32")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAMS))
def test_band_routes_equal_the_whole_frame_on_card(name, cuda_device):
    data = _stream(name)
    whole = jxl_tpu_torch.decode_image(data, pixel_format="f32").frames[0]
    rows = torch.empty_like(whole)

    def sink(y0, block):
        rows[y0 : y0 + block.shape[0]] = block

    jxl_tpu_torch.decode_banded(data, sink, pixel_format="f32")
    assert torch.equal(rows, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAMS))
def test_sharded_tiles_equal_the_whole_frame_on_card(name, cuda_device):
    """Each tile of a 2x2 sharded grid, rendered from its own groups'
    coefficients as parallel/sharded_render.py renders a rank's tile,
    equals the whole frame's planes there."""
    frame = _frame(_stream(name))
    groups = frame.header.num_groups
    rng = np.random.default_rng(5)
    coeffs = torch.from_numpy(rng.integers(-4, 5, groups * STRIDE).astype(np.int32)).cuda()
    regions = _regions(frame)
    groups_all, by0, by1, bx0, bx1 = regions.pop("whole")
    whole = DF.render_block_rows(frame, coeffs, groups_all, by0, by1)
    for region, (ids, by0, by1, bx0, bx1) in regions.items():
        own = torch.cat([coeffs[g * STRIDE : (g + 1) * STRIDE] for g in ids])
        got = DF.render_block_rows(frame, own, ids, by0, by1, bx0=bx0, bx1=bx1)
        assert torch.equal(got, whole[:, by0 * 8 : by1 * 8, bx0 * 8 : bx1 * 8]), region


@pytest.mark.cuda
def test_batched_animation_equals_the_loop_on_card(cuda_device):
    data = anim_replace_stream(320, 200, 5, seed=8)
    loop = _decode(data, JXL_TPU_BATCH_ANIM="off")
    before = K.vardct_blocks.launches
    batched = _decode(data, JXL_TPU_BATCH_ANIM="1")
    assert K.vardct_blocks.launches > before
    assert len(batched.frames) == len(loop.frames) == 5
    for a, b in zip(batched.frames, loop.frames):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_counters_of_a_4k_frame_on_card(cuda_device):
    """vardct_d1's mix (DCT16 and the ten 8x8 types): one launch a type."""
    from jxl_tpu_torch.utils import trace

    data = encode_xyb_vardct(3840, 2160, seed=7)[0]
    jxl_tpu_torch.decode_image(data)  # builds
    trace.enable()
    trace.reset()
    try:
        jxl_tpu_torch.decode_image(data)
        launches = trace.metrics.get("vardct_blocks_launches")
        blocks = trace.metrics.get("vardct_blocks_blocks")
        tables = trace.metrics.get("block_tables_built")
    finally:
        trace.enable(False)
    tmap = _frame(data).hf_meta["transform"]
    assert launches == 11 == len(np.unique(tmap[tmap >= 128] & 127))
    assert blocks == int((tmap >= 128).sum())
    assert tables == 1  # one render call, one native pass
