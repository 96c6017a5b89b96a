"""Host planner of the lane AC decoder: every HF section of a frame
becomes one lane of ops/device_ac.py:decode_ac_sections (kernel K3 on the
card, its plain torch version on the CPU), and the decoded coefficients
stay where they were decoded, for vardct/device_frame.py.

The counterpart of jxl_tpu/vardct/device_group.py. Capability reference:
jxl/src/frame/group.rs:384-618 (the decode loop); the native host decoder
(vardct/group.py:try_decode_hf_groups) gives the same coefficients bit for
bit. The lanes' item table, the rows that decoder builds a group, comes
from one native pass over the frame's maps (native.lane_items_native).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.headers.frame import Encoding
from ..utils import trace
from .group import _CBX_ARR, _CBY_ARR, _SHAPE_ARR, BLOCK_DIM, GROUP_DIM, _ceil_log2


def _next_pow2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << max(0, (max(n, 1) - 1).bit_length()))


def eligible_for_device_ac(frame) -> bool:
    """The lane decoder covers frames whose HF sections hold only the
    VarDCT AC tokens (no modular HF channels: nothing needs the post-AC
    bit cursor), coded with ANS and without LZ77 in every pass, with one
    alias-table geometry across passes."""
    if frame.header.encoding != Encoding.VARDCT or frame.hf_global is None:
        return False
    mg = frame.lf_global.modular_global
    num_passes = frame.header.passes.num_passes
    if mg.buffer_infos and any(mg.section_buffer_indices[2 + p] for p in range(num_passes)):
        return False
    hists = [p.histograms for p in frame.hf_global.passes]
    if any(h.use_prefix_code or h.lz77_enabled for h in hists):
        return False
    from .. import native

    geo = {(pk["table_size"], pk["log_bucket"]) for pk in map(native.pack_entropy, hists)}
    return len(geo) == 1


def lane_tables(frame) -> dict:
    """The frame's pass-independent inputs of decode_ac_sections, built
    once and kept on the frame (a streaming decode launches the lanes of
    the sections that have arrived, in more than one call): "items",
    "orders", "tables", "uint_cfgs", "context_map", the keywords
    log_bucket, num_bctx, total, n_buckets, and the per-pass and per-group
    bases the lanes read ("pass_order_base", "ctx_base", "n_items")."""
    cached = getattr(frame, "_lane_tables", None)
    if cached is not None:
        return cached
    from .. import native

    header = frame.header
    hf_global = frame.hf_global
    bctx = frame.lf_global.block_context_map
    num_groups = header.num_groups

    bw, bh = header.size_blocks()
    hf = frame.hf_meta
    tmap = np.ascontiguousarray(hf["transform"][:bh, :bw])
    # orders: one concatenated array over (pass, used order keys); the
    # transform ids in use from one count over the map
    tids = np.flatnonzero(np.bincount(tmap.ravel(), minlength=256)[128:])
    shapes = np.unique(_SHAPE_ARR[tids])
    used_keys = [int(s) * 3 + c for s in shapes for c in range(3)]
    order_parts = []
    pass_order_base = []
    key_lut = np.zeros(40, dtype=np.int32)
    pos = 0
    for p, pstate in enumerate(hf_global.passes):
        pass_order_base.append(pos)
        for k in used_keys:
            order = np.asarray(pstate.coeff_orders[k], dtype=np.int32)
            if p == 0:
                key_lut[k] = pos
            order_parts.append(order)
            pos += len(order)
    orders = np.concatenate(order_parts) if order_parts else np.zeros(1, np.int32)

    # one flat (C, 5, NB) stack of every pass's clusters; context maps
    # shifted per pass so one flat map serves all lanes
    packs = [native.pack_entropy(p.histograms) for p in hf_global.passes]
    tables = np.concatenate([pk["ans_tables"] for pk in packs]).astype(np.int32)
    uint_cfgs = np.concatenate([pk["uint_configs"] for pk in packs]).astype(np.int32)
    cluster_base = np.cumsum([0] + [pk["ans_tables"].shape[0] for pk in packs])
    ctx_base = np.cumsum([0] + [len(pk["context_map"]) for pk in packs])
    context_map = np.concatenate([
        pk["context_map"].astype(np.int32) + np.int32(cluster_base[p]) for p, pk in enumerate(packs)
    ])

    # the item table: one native pass counts each group's rows, a second
    # writes them and zeros the padding
    map_args = (
        tmap, np.ascontiguousarray(hf["raw_quant"][:bh, :bw], dtype=np.int32),
        np.ascontiguousarray(hf["quant_lf"][:bh, :bw], dtype=np.uint8),
        header.size_groups()[0], num_groups, header.group_dim // BLOCK_DIM,
        np.array([header.hshift(c) for c in range(3)], dtype=np.int32),
        np.array([header.vshift(c) for c in range(3)], dtype=np.int32),
        np.asarray(bctx.context_map, dtype=np.int32), bctx.num_lf_contexts,
        np.asarray(bctx.qf_thresholds, dtype=np.int32), _CBX_ARR, _CBY_ARR, _SHAPE_ARR,
        key_lut, GROUP_DIM * GROUP_DIM,
    )
    n_items = np.zeros(num_groups, dtype=np.int32)
    i_max = _next_pow2(native.lane_items_native(*map_args, n_items), 16)
    items = np.empty((num_groups, i_max, 10), dtype=np.int32)
    native.lane_items_native(*map_args, n_items, items)
    trace.metrics.add("lane_tables_built")
    frame._lane_tables = dict(
        items=items, orders=orders, tables=tables, uint_cfgs=uint_cfgs,
        context_map=context_map, log_bucket=int(packs[0]["log_bucket"]),
        num_bctx=bctx.num_contexts, total=num_groups * 3 * GROUP_DIM * GROUP_DIM,
        n_buckets=int(packs[0]["table_size"]), pass_order_base=pass_order_base,
        ctx_base=ctx_base, n_items=n_items,
    )
    return frame._lane_tables


def lane_inputs(frame, group_readers: dict, band=None) -> dict:
    """The numpy inputs of decode_ac_sections for the (group, pass)
    sections of `group_readers`, {(group, pass): BitReader}, one lane each
    in (group, pass) order: {"streams", eight lane arrays, "items",
    "orders", "tables", "uint_cfgs", "context_map", and the keywords
    log_bucket, num_bctx, total, n_buckets}. Each reader's histogram index
    is read here. The tables cover the whole frame (lane_tables), so the
    lanes of any subset of sections land where one call over all of them
    puts them.

    band: a list of groups (a group row of the banded decode, or a
    rank's rectangle of groups in the sharded decode) that holds every
    group of `group_readers`. The lanes then decode into a band-sized
    buffer, slot i for group band[i] (total = len(band) * 3 * GD * GD):
    lane_group and the coefficient bases count slots, and "items" holds
    only the band's rows, so the card holds O(band) for them."""
    from ..errors import InvalidHistogramIndex

    header = frame.header
    hf_global = frame.hf_global
    bctx = frame.lf_global.block_context_map
    num_histo_bits = _ceil_log2(hf_global.num_histograms)
    tabs = lane_tables(frame)
    slot = None if band is None else {g: i for i, g in enumerate(band)}
    items = tabs["items"] if band is None else tabs["items"][list(band)]
    total = tabs["total"] if band is None else len(band) * 3 * GROUP_DIM * GROUP_DIM

    keys = sorted(group_readers)
    S = len(keys)
    lanes = {name: np.zeros(S, np.int32) for name in (
        "start_bits", "lane_group", "lane_ctx_off", "lane_shift", "lane_order_base",
        "lane_coeff_base", "lane_n_items", "lane_end_bits")}
    datas = []
    for li, (g, p) in enumerate(keys):
        br = group_readers[(g, p)]
        hist_idx = br.read(num_histo_bits)
        if hist_idx >= hf_global.num_histograms:
            raise InvalidHistogramIndex("invalid histogram index")
        gs = g if slot is None else slot[g]
        lanes["lane_group"][li] = gs
        lanes["lane_ctx_off"][li] = hist_idx * bctx.num_ac_contexts + tabs["ctx_base"][p]
        lanes["lane_shift"][li] = header.passes.shift[p] if p < len(header.passes.shift) else 0
        lanes["lane_order_base"][li] = tabs["pass_order_base"][p]
        lanes["lane_coeff_base"][li] = gs * 3 * GROUP_DIM * GROUP_DIM
        lanes["lane_n_items"][li] = tabs["n_items"][g]
        lanes["lane_end_bits"][li] = len(br.data) * 8
        lanes["start_bits"][li] = br.pos
        datas.append(bytes(br.data))
    l_max = _next_pow2(max(len(d) for d in datas) + 8, 64)
    streams = np.zeros((S, l_max), dtype=np.uint8)
    for i, d in enumerate(datas):
        streams[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
    return dict(
        streams=streams, **lanes, items=np.ascontiguousarray(items),
        **{k: tabs[k] for k in ("orders", "tables", "uint_cfgs", "context_map")},
        **{k: tabs[k] for k in LANE_KEYWORDS if k != "total"}, total=total,
    )


# the scalar (keyword) inputs among those of lane_inputs()
LANE_KEYWORDS = ("log_bucket", "num_bctx", "total", "n_buckets")


def run_lanes(inputs: dict, device, out=None):
    """decode_ac_sections on `device` with the numpy `inputs` of
    lane_inputs(): (coeffs (total,) int32, ok (S,) bool) tensors there;
    with `out`, a (total,) int32 tensor there, the coefficients add into
    it.
    The tables are checked and packed here, on the host, and go up with
    the other arrays (pack_tables raises ValueError on tables K3 cannot
    take), all in one render/stages/core.py:to_device_all: pinned, one
    copy a dtype, without a wait."""
    from ..ops.device_ac import decode_ac_sections, pack_tables
    from ..render.stages.core import to_device_all

    trace.metrics.add("k3_lanes", len(inputs["streams"]))
    with trace.span("frame.k3_launch"):
        buckets, cfgs = pack_tables(inputs["tables"], inputs["uint_cfgs"], inputs["context_map"])
        names = [k for k in inputs if k not in LANE_KEYWORDS]
        *up, packed_buckets, packed_cfgs = to_device_all(
            [inputs[k] for k in names] + [buckets, cfgs], device)
        return decode_ac_sections(**dict(zip(names, up)),
                                  **{k: inputs[k] for k in LANE_KEYWORDS},
                                  packed_buckets=packed_buckets, packed_cfgs=packed_cfgs,
                                  out=out)


def merge_lane_inputs(parts: list, total_slots: int) -> dict:
    """One launch's inputs over the lanes of several frames: parts is
    [(lane_inputs() of a frame, slot0)], each frame's group g landing in
    slot slot0 + g of a (total_slots * 3 * GD * GD,) buffer. Each frame
    keeps its own tables: its item rows, orders, clusters and context map
    are stacked after the frames before it, and its lanes' row, order,
    context and coefficient bases move with them. The frames must share
    the keywords log_bucket, n_buckets and num_bctx (ValueError else)."""
    kw = {k: parts[0][0][k] for k in LANE_KEYWORDS if k != "total"}
    if any(inp[k] != v for inp, _ in parts for k, v in kw.items()):
        raise ValueError("merged lanes need one log_bucket, n_buckets and num_bctx")
    i_max = max(inp["items"].shape[1] for inp, _ in parts)
    l_max = max(inp["streams"].shape[1] for inp, _ in parts)
    merged = {k: [] for k in parts[0][0] if k not in LANE_KEYWORDS}
    rows = ords = clusters = ctx = 0
    for inp, slot0 in parts:
        shift = {"lane_group": rows, "lane_ctx_off": ctx, "lane_order_base": ords,
                 "lane_coeff_base": slot0 * 3 * GROUP_DIM * GROUP_DIM, "context_map": clusters}
        for k, parts_k in merged.items():
            v = inp[k] + shift[k] if k in shift else inp[k]
            if k == "streams":
                v = np.pad(v, ((0, 0), (0, l_max - v.shape[1])))
            elif k == "items":
                v = np.pad(v, ((0, 0), (0, i_max - v.shape[1]), (0, 0)))
            parts_k.append(v)
        rows += inp["items"].shape[0]
        ords += len(inp["orders"])
        clusters += inp["tables"].shape[0]
        ctx += len(inp["context_map"])
    out = {k: np.concatenate(v) for k, v in merged.items()}
    return dict(out, **kw, total=total_slots * 3 * GROUP_DIM * GROUP_DIM)


def decode_ac_frames(jobs: list, total_slots: int, device, out=None):
    """The AC of several frames' sections in one lane launch (K3 on the
    card) a distinct (log_bucket, n_buckets, num_bctx): jobs is [(frame,
    {(group, pass): BitReader}, slot0)], frame f's group g decoding into
    slot slot0 + g of the (total_slots * 3 * GD * GD,) int32 buffer on
    `device` (`out`, whose coefficients the lanes add to, or zeros).
    Returns (buffer, the lanes' ok flags, one (S,) bool tensor a launch),
    without reading the flags: check_lane_flags reads them."""
    by_key: dict = {}
    with trace.span("frame.lane_plan"):
        for frame, readers, slot0 in jobs:
            inp = lane_inputs(frame, readers)
            key = tuple(inp[k] for k in LANE_KEYWORDS if k != "total")
            by_key.setdefault(key, []).append((inp, slot0))
    oks = []
    for parts in by_key.values():
        out, ok = run_lanes(merge_lane_inputs(parts, total_slots), device, out=out)
        oks.append(ok)
    return out, oks


def check_lane_flags(oks: list) -> None:
    """Read lane flags (a sync point) and raise on corrupt lanes."""
    from ..errors import NativeDecodeError

    if not oks:
        return
    flags = torch.cat(oks).cpu().numpy()
    if not flags.all():
        bad = np.nonzero(~flags)[0].tolist()
        raise NativeDecodeError(f"lane AC decode failed for sections {bad}")


def decode_ac_sections_device(frame, group_readers: dict, device) -> None:
    """Decode the (group, pass) AC sections of `group_readers` of an
    eligible frame on `device`, in one launch. The coefficients add into
    the frame's one buffer, frame.device_ac_flat, which stays there (the
    first launch makes it): a streaming decode that launches the sections
    as they arrive, in several calls, ends with the buffer one call over
    every section gives, bit for bit. The per-lane flags join
    frame.device_ac_ok until check_device_ac_ok reads them."""
    with trace.span("frame.lane_plan"):
        inputs = lane_inputs(frame, group_readers)
    coeffs, ok = run_lanes(inputs, device, out=frame.device_ac_flat)
    frame.device_ac_flat = coeffs
    frame.device_ac_ok = ok if frame.device_ac_ok is None else torch.cat([frame.device_ac_ok, ok])


def check_device_ac_ok(frame) -> None:
    """Read the lane flags (a sync point) and raise on corrupt lanes."""
    ok = getattr(frame, "device_ac_ok", None)
    if ok is None:
        return
    frame.device_ac_ok = None
    check_lane_flags([ok])
