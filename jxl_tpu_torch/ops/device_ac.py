"""VarDCT AC coefficient decode, one lane per (group, pass) section: rANS +
HybridUint + context modeling for every HF section of a frame.

`decode_ac_sections` launches the kernel K3 (csrc/ans_lanes.cu, built by
ops/ans_lanes.py) for CUDA tensors and takes the plain torch version,
`decode_ac_sections_reference`, for tensors on the CPU; it never falls
back. K3 replaces the XLA lane decoder
jxl_tpu/ops/device_ac.py:decode_ac_sections, whose lockstep body the plain
version is: one token per lane per step until every lane finishes, with
each chunk of steps' (index, value) pairs scatter-added into the
coefficient buffer.

What bounds K3 on an H100: each lane is a serial chain of dependent steps
(a token's context and table row depend on the tokens before it), so a
launch takes the longest lane's token count times one step's dependent
latency. K3 keeps that chain in registers and shared memory: 64-bit
windows read from a ring of the lane's bytes, the lane's slice of the
context map, packed 64-bit alias buckets (one load a symbol) with the
HybridUint configs beside them, a ring of the group's items, and the
nonzeros map (see the note at the top of the .cu file). Their layout is
csrc/kernel_geometry.h's; `ac_smem_plan` chooses the two sizes it leaves
open from the tables' shapes. `pack_tables` checks and packs the tables
on the host, where they are built (vardct/device_group.py:run_lanes
passes the packed tables to the wrapper, so the card's path reads nothing
back), and raises ValueError on tables the packing cannot hold.
Coefficients are stored with an integer atomic add, which sums the passes
of a group in any order to the same values.

Semantics mirror the native host decoder (native/modular_decode.cc
jxl_decode_vardct_ac, ref frame/group.rs:384-618), with the XLA version's
clipping and int32 wrap-around, which the plain version carries in int64
and wraps with `_w32`.

Eligibility (checked by the caller, vardct/device_group.py): ANS
histograms without LZ77, and no modular HF channels in the sections.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .ans_lanes import check_launch, load
from .device_ans import ans_step, hybrid_uint, read_bits

GROUP_DIM_BLOCKS = 32  # blocks per group side
NZ_AREA = GROUP_DIM_BLOCKS * GROUP_DIM_BLOCKS
CHUNK = 1024  # lockstep steps per scatter-add

# zero-density context LUTs (ref block_context_map.rs:21-47)
_FREQ_CTX = np.array(
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
     15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
     23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
     27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30],
    dtype=np.int64,
)
_NUM_NZ_CTX = np.array(
    [0, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123,
     152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
     180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
     206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
     206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206],
    dtype=np.int64,
)

# K3's shared-memory plan
SMEM_LIMIT = 227 * 1024  # bytes a block may use on sm_90
# what one lane's block may take, so that two blocks fit on an SM (228 KB,
# 1 KB of it reserved a block): 264 lanes run at once on 132 SMs
BLOCK_BUDGET = (228 * 1024) // 2 - 1024
# context-map entries a lane reads with a block context in range: the
# num_bctx * (37 + 458) AC contexts and the 16 the zero-density LUTs reach
# past them (ref block_context_map.rs)
CTX_PER_BCTX = 37 + 458
CTX_TAIL = 16

# (low, high) of each row of a (C, 5, NB) table that a packed bucket holds:
# dist, alias symbol, alias offset, alias cutoff, alias dist
BUCKET_RANGES = ((0, 4096), (0, 4095), (-4096, 4095), (0, 4096), (0, 4096))
_BUCKET_ROWS = ("dist", "alias symbol", "alias offset", "alias cutoff", "alias dist")

_LANE_ARRAYS = ("start_bits", "lane_group", "lane_ctx_off", "lane_shift",
                "lane_order_base", "lane_coeff_base", "lane_n_items", "lane_end_bits")
_TABLE_ARRAYS = ("items", "orders", "tables", "uint_cfgs", "context_map")


def _w32(x):
    """int64 tensor -> the int32 value XLA's wrapping arithmetic gives."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


_REGIONS = ("nonzeros_map", "luts", "items", "stream", "context_slice", "uint_cfgs", "tables")


def ac_smem_layout(tab_shared: bool, C: int, NB: int, ctx_slice: int) -> dict:
    """Bytes of each shared-memory region of K3 as the kernel lays them
    out (csrc/kernel_geometry.h, read through the host library), in its
    order: the fixed regions (nonzeros map, LUTs, item ring, stream ring),
    then the context slice, the HybridUint configs and the packed tables
    (when shared); "total" is the block's dynamic shared memory."""
    off = native.k3_layout(tab_shared, C, NB, ctx_slice)["offsets"]
    regions = {name: off[i + 1] - off[i] for i, name in enumerate(_REGIONS)}
    regions["total"] = off[-1]
    return regions


def ac_smem_plan(*, C: int, NB: int, num_bctx: int, NC: int,
                 budget: int = BLOCK_BUDGET) -> dict:
    """K3's per-launch shared-memory plan from the tables' shapes: C
    clusters of NB buckets, num_bctx block contexts, a context map of NC
    entries. The stream and item rings have a fixed size whatever the
    section's length and the group's item count (the kernel restages them
    as the lane goes); the lane's context slice comes next (the contexts a
    block context in range reaches, in 16-bit cluster ids), then the
    packed tables if they still fit (else the kernel reads them from
    global memory). The wrapper passes the two choices, tab_shared and
    ctx_slice, to the launch. Raises ValueError on more clusters than 16
    bits hold, or when the fixed regions exceed the budget."""
    budget = min(budget, SMEM_LIMIT)
    sizes = native.k3_layout(False, C, NB, 0)
    fixed = sizes["offsets"][-1]
    if C > 1 << 16 or fixed > budget:
        raise ValueError(f"decode_ac_sections cannot take {C} clusters: "
                         f"{fixed} bytes of shared memory before the tables")
    want = max(1, num_bctx * CTX_PER_BCTX + CTX_TAIL)
    ctx_slice = max(0, min(want, (budget - fixed - 15) // sizes["ctx_entry_bytes"]))
    tab_shared = ac_smem_layout(True, C, NB, ctx_slice)["total"] <= budget
    layout = ac_smem_layout(tab_shared, C, NB, ctx_slice)
    return dict(tab_shared=tab_shared, ctx_slice=ctx_slice,
                ctx_entry_bytes=sizes["ctx_entry_bytes"], ring_half=sizes["ring_half"],
                item_half=sizes["item_half"], item_slot_bytes=sizes["item_slot_bytes"],
                regions=layout, smem_bytes=layout["total"])


def check_table_ranges(tables, uint_cfgs, context_map) -> None:
    """Raise ValueError on tables K3's packing cannot hold: a bucket field
    outside BUCKET_RANGES, a HybridUint config outside 0 <= msb, lsb and
    msb + lsb <= split_exponent <= 31, or a context-map entry that is not a
    cluster. Takes numpy arrays."""
    lo = np.array([r[0] for r in BUCKET_RANGES]).reshape(1, 5, 1)
    hi = np.array([r[1] for r in BUCKET_RANGES]).reshape(1, 5, 1)
    bad_rows = ((tables < lo) | (tables > hi)).any(axis=(0, 2))
    for row in np.nonzero(bad_rows)[0]:
        raise ValueError(f"tables: {_BUCKET_ROWS[row]} outside {BUCKET_RANGES[row]}")
    se, msb, lsb = uint_cfgs.astype(np.int64).T
    if ((msb < 0) | (lsb < 0) | (msb + lsb > se) | (se > 31)).any():
        raise ValueError("uint_cfgs: need 0 <= msb, lsb and msb + lsb <= split_exponent <= 31")
    if ((context_map < 0) | (context_map >= tables.shape[0])).any():
        raise ValueError(f"context_map: entries must be clusters in [0, {tables.shape[0]})")


def pack_buckets(tables) -> np.ndarray:
    """(C, 5, NB) alias tables (numpy) -> (C, NB, 2) int32, each bucket one
    little-endian 64-bit word: bits 0-12 alias cutoff, 13-25 dist, 26-38
    alias dist, 39-50 alias symbol, 51-63 alias offset (two's complement).
    Fields must lie in BUCKET_RANGES (check_table_ranges)."""
    dist, asym, aoff, cut, adist = np.moveaxis(tables.astype(np.int64), 1, 0)
    low = cut | (dist << 13) | ((adist & 0x3F) << 26)
    high = (adist >> 6) | (asym << 7) | ((aoff & 0x1FFF) << 19)
    return np.stack([low, high], axis=-1).astype(np.uint32).view(np.int32)


def pack_hybrid_configs(uint_cfgs) -> np.ndarray:
    """(C, 3) HybridUint configs (numpy) -> (C,) int32 split_exponent | msb
    << 8 | lsb << 16."""
    se, msb, lsb = uint_cfgs.astype(np.int32).T
    return np.ascontiguousarray(se | (msb << 8) | (lsb << 16))


def pack_tables(tables, uint_cfgs, context_map) -> tuple:
    """What K3 reads in place of `tables` and `uint_cfgs`, from the numpy
    arrays where they are built: (packed buckets (C, NB, 2) int32, packed
    HybridUint configs (C,) int32). Raises ValueError on tables the packing
    cannot hold (check_table_ranges)."""
    check_table_ranges(tables, uint_cfgs, context_map)
    return pack_buckets(tables), pack_hybrid_configs(uint_cfgs)


def decode_ac_sections_reference(streams, start_bits, lane_group, lane_ctx_off, lane_shift,
                                 lane_order_base, lane_coeff_base, lane_n_items,
                                 lane_end_bits, items, orders, tables, uint_cfgs,
                                 context_map, *, log_bucket: int, num_bctx: int,
                                 total: int, n_buckets: int):
    """The plain torch version (lockstep over lanes); arguments and results
    as decode_ac_sections."""
    dev = streams.device
    S = streams.shape[0]
    i64 = torch.int64

    def lane(x):
        return x.to(i64)

    start_bits, lane_group, lane_ctx_off, lane_shift, lane_order_base, lane_coeff_base, \
        lane_n_items, lane_end_bits = map(lane, (start_bits, lane_group, lane_ctx_off,
                                                 lane_shift, lane_order_base, lane_coeff_base,
                                                 lane_n_items, lane_end_bits))
    n_items_max = items.shape[1]
    items_flat = items.reshape(-1, 10).to(i64)
    orders = orders.to(i64)
    tflat = tables.reshape(-1).to(i64)
    tlast = tflat.numel() - 1
    cfgs = uint_cfgs.to(i64)
    cmap = context_map.to(i64)
    freq_ctx = torch.from_numpy(_FREQ_CTX).to(dev)
    num_nz_ctx = torch.from_numpy(_NUM_NZ_CTX).to(dev)
    ar = torch.arange(NZ_AREA, device=dev)
    nz_ys, nz_xs = ar // GROUP_DIM_BLOCKS, ar % GROUP_DIM_BLOCKS
    lanes = torch.arange(S, device=dev)

    state = read_bits(streams, start_bits, torch.full((S,), 32, dtype=i64, device=dev))
    bitpos = start_bits + 32
    item = torch.zeros(S, dtype=i64, device=dev)
    k = torch.full((S,), -1, dtype=i64, device=dev)
    nonzeros = torch.zeros(S, dtype=i64, device=dev)
    prev = torch.zeros(S, dtype=i64, device=dev)
    err = torch.zeros(S, dtype=torch.bool, device=dev)
    nzmap = torch.zeros((S, 3 * NZ_AREA), dtype=i64, device=dev)
    coeffs = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    dests = torch.empty((CHUNK, S), dtype=i64, device=dev)
    vals = torch.empty((CHUNK, S), dtype=torch.int32, device=dev)

    while bool(((item < lane_n_items) & ~err).any()):
        dests.fill_(total)
        for step in range(CHUNK):
            active = (item < lane_n_items) & ~err
            if step % 64 == 0 and not bool(active.any()):
                break
            f = items_flat[lane_group * n_items_max + item.clamp(0, n_items_max - 1)]
            c, sbx, sby, num_blocks, num_coeffs, bctx, order_off, coeffs_off, cxv, cyv = \
                f.unbind(1)
            nbl = num_blocks.clamp(min=1)
            lnb = torch.floor(torch.log2(nbl.to(torch.float64))).to(i64)
            need_nz = k < 0

            # context selection: nonzeros prediction from the lane's map
            ch_base = c * NZ_AREA
            up = nzmap[lanes, (ch_base + (sby - 1) * GROUP_DIM_BLOCKS + sbx).clamp(0, 3 * NZ_AREA - 1)]
            left = nzmap[lanes, (ch_base + sby * GROUP_DIM_BLOCKS + (sbx - 1).clamp(min=0))
                         .clamp(0, 3 * NZ_AREA - 1)]
            avg = torch.div(_w32(up + left + 1), 2, rounding_mode="floor")
            predicted = torch.where(sbx == 0, torch.where(sby == 0, 32, up),
                                    torch.where(sby == 0, left, avg))
            nzctx = torch.where(predicted < 8, predicted,
                                torch.where(predicted < 64, 4 + predicted // 2, 36))
            ctx_nz = _w32(nzctx * num_bctx + bctx + lane_ctx_off)
            nzl = torch.clamp((nonzeros + (1 << lnb) - 1) >> lnb, max=63)
            kn = k.clamp(0, 1 << 20) >> lnb
            histo_base = num_bctx * 37 + 458 * bctx + lane_ctx_off
            ctx_coef = histo_base + (num_nz_ctx[nzl & 63] + freq_ctx[kn & 63]) * 2 + prev
            ctx = torch.where(need_nz, ctx_nz, ctx_coef)
            ctx = torch.where(active, ctx, 0)
            cluster = cmap[ctx.clamp(0, cmap.numel() - 1)]

            # rANS symbol + HybridUint
            sym, nstate, nbitpos = ans_step(
                state, bitpos, streams,
                lambda r, i: tflat[((cluster * 5 + r) * n_buckets + i).clamp(0, tlast)],
                log_bucket,
            )
            cfg = cfgs[cluster]
            value, nbitpos = hybrid_uint(sym, cfg[:, 0], cfg[:, 1], cfg[:, 2], streams, nbitpos)

            # nonzeros-token branch
            nz_val = _w32(value)
            bad_nz = need_nz & (_w32(nz_val + num_blocks) > num_coeffs)
            fill = torch.div(_w32(nz_val + num_blocks - 1), nbl, rounding_mode="floor")
            do_write = need_nz & active & ~bad_nz
            if bool(do_write.any()):
                # the (cy, cx) rect at (sby, sbx) of channel c gets `fill`
                in_rect = ((nz_ys[None, :] >= sby[:, None])
                           & (nz_ys[None, :] < (sby + cyv)[:, None])
                           & (nz_xs[None, :] >= sbx[:, None])
                           & (nz_xs[None, :] < (sbx + cxv)[:, None]))
                ch_sel = torch.arange(3, device=dev)[None, :, None] == c[:, None, None]
                write = (do_write[:, None, None] & in_rect[:, None, :] & ch_sel).reshape(S, -1)
                nzmap = torch.where(write, fill[:, None], nzmap)
            prev_init = torch.where(nz_val > (num_coeffs >> 4), 0, 1)

            # coefficient-token branch
            neg = _w32(-_w32(((value + 1) & 0xFFFFFFFF) >> 1))
            coeff = torch.where((value & 1) == 1, neg, value >> 1)
            coeff = _w32(coeff << lane_shift)
            emit = active & ~need_nz
            ordv = orders[(lane_order_base + order_off + k.clamp(min=0)).clamp(0, orders.numel() - 1)]
            dest = lane_coeff_base + coeffs_off + ordv
            ok_dest = emit & (dest >= 0) & (dest < total)
            dests[step] = torch.where(ok_dest, dest, total)
            vals[step] = torch.where(ok_dest, coeff, 0).to(torch.int32)
            is_nonzero = (coeff != 0) & emit
            nz_after = nonzeros - is_nonzero.to(i64)

            # transitions
            start_coeffs = need_nz & (nz_val > 0) & ~bad_nz
            skip_item = need_nz & (nz_val == 0) & ~bad_nz
            coeffs_exhausted = emit & (nz_after > 0) & (k + 1 >= num_coeffs)
            coeffs_done = emit & ((nz_after == 0) | (k + 1 >= num_coeffs))
            err = err | (active & (bad_nz | coeffs_exhausted))
            advance = (skip_item | coeffs_done) & active
            nk = torch.where(advance, -1, torch.where(start_coeffs, num_blocks,
                                                      torch.where(emit, k + 1, k)))
            nnonzeros = torch.where(start_coeffs, nz_val, torch.where(emit, nz_after, nonzeros))
            nprev = torch.where(need_nz, prev_init, is_nonzero.to(i64))
            prev = torch.where(active, nprev, prev)
            state = torch.where(active, nstate, state)
            bitpos = torch.where(active, nbitpos, bitpos)
            item = torch.where(active, item + advance.to(i64), item)
            k = torch.where(active, nk, k)
            nonzeros = torch.where(active, nnonzeros, nonzeros)
        coeffs.index_add_(0, dests.reshape(-1), vals.reshape(-1))

    ok = ~err & (item >= lane_n_items) & (state == 0x130000) & (bitpos <= lane_end_bits)
    return coeffs[:total], ok


def decode_ac_sections(streams, start_bits, lane_group, lane_ctx_off, lane_shift,
                       lane_order_base, lane_coeff_base, lane_n_items, lane_end_bits,
                       items, orders, tables, uint_cfgs, context_map, *, log_bucket: int,
                       num_bctx: int, total: int, n_buckets: int, packed_buckets=None,
                       packed_cfgs=None, out=None):
    """Decode every lane's AC token stream.

    streams (S, L) uint8, zero-padded (>= 8 bytes slack); eight (S,) int32
    lane arrays: start bit of the ANS init state, row of `items`,
    histogram_index * num_ac_contexts + the pass's context base, pass
    shift, base into `orders`, base into the coefficient buffer, item
    count, 8 * section bytes; items (G, I, 10) int32 (c, sbx, sby,
    num_blocks, num_coeffs, block context, order offset, coefficient
    offset, cx, cy); orders (O,) int32; tables (C, 5, NB) int32 packed
    alias tables; uint_cfgs (C, 3) int32; context_map (NC,) int32; all on
    one device. packed_buckets, packed_cfgs: pack_tables() of the same
    tables, on the same device, made where the tables are built; the
    kernel reads them in place of `tables` and `uint_cfgs`. Without them
    the wrapper copies the tables to the host to check and pack them (a
    sync on the card). Returns (coeffs (total,) int32, ok (S,) bool): ok
    means no range error, every item walked, final state 0x130000, and the
    cursor within the section's bytes. Raises ValueError on tables K3's
    packing cannot hold (check_table_ranges): always on the CPU, and on the
    card when it packs them itself. out: a (total,) int32 buffer on the
    same device that the lanes' coefficients add into (K3's stores are
    atomic adds, so lanes decoded in separate calls sum to the buffer one
    call over all of them gives); it is then the coefficients returned."""
    lane_arrays = (start_bits, lane_group, lane_ctx_off, lane_shift, lane_order_base,
                   lane_coeff_base, lane_n_items, lane_end_bits)
    tabs = (items, orders, tables, uint_cfgs, context_map)
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be an (S, L) uint8 tensor")
    S = streams.shape[0]
    for name, x in zip(_LANE_ARRAYS + _TABLE_ARRAYS, lane_arrays + tabs):
        if x.dtype != torch.int32 or x.device != streams.device:
            raise ValueError(f"{name} must be int32 on {streams.device}")
    for name, x in zip(_LANE_ARRAYS, lane_arrays):
        if tuple(x.shape) != (S,):
            raise ValueError(f"{name} must have shape ({S},), got {tuple(x.shape)}")
    if items.dim() != 3 or items.shape[2] != 10:
        raise ValueError(f"items must be (G, I, 10), got {tuple(items.shape)}")
    if tables.dim() != 3 or tables.shape[1] != 5 or tables.shape[2] != n_buckets:
        raise ValueError(f"tables must be (C, 5, {n_buckets}), got {tuple(tables.shape)}")
    if tuple(uint_cfgs.shape) != (tables.shape[0], 3):
        raise ValueError(f"uint_cfgs must be ({tables.shape[0]}, 3)")
    if min(items.shape[1], orders.numel(), context_map.numel(), tables.shape[0]) == 0:
        raise ValueError("empty items, orders, context map or tables")
    if not 0 <= log_bucket <= 12 or n_buckets << log_bucket < 4096:
        raise ValueError(f"bad log_bucket {log_bucket} for {n_buckets} buckets")
    C = tables.shape[0]
    if (packed_buckets is None) != (packed_cfgs is None):
        raise ValueError("pass both packed_buckets and packed_cfgs, or neither")
    if packed_buckets is not None:
        for name, x, shape in (("packed_buckets", packed_buckets, (C, n_buckets, 2)),
                               ("packed_cfgs", packed_cfgs, (C,))):
            if x.dtype != torch.int32 or x.device != streams.device or tuple(x.shape) != shape:
                raise ValueError(f"{name} must be int32 {shape} on {streams.device}")
    if out is not None and (out.dtype != torch.int32 or out.device != streams.device
                            or tuple(out.shape) != (total,) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({total},) int32 tensor on {streams.device}")
    kw = dict(log_bucket=log_bucket, num_bctx=num_bctx, total=total, n_buckets=n_buckets)
    if streams.device.type == "cpu":
        check_table_ranges(tables.numpy(), uint_cfgs.numpy(), context_map.numpy())
        coeffs, ok = decode_ac_sections_reference(streams, *lane_arrays, *tabs, **kw)
        if out is None:
            return coeffs, ok
        return out.add_(coeffs), ok
    if streams.device.type != "cuda":
        raise ValueError(f"decode_ac_sections runs on cpu or cuda, not {streams.device}")
    if packed_buckets is None:
        # the small tables come to the host in one copy, to be checked and
        # packed, and the packed ones go up in one
        n_tab, n_cfg = tables.numel(), uint_cfgs.numel()
        flat = torch.cat([tables.reshape(-1), uint_cfgs.reshape(-1), context_map.reshape(-1)])
        flat = flat.cpu().numpy()
        buckets, cfgs = pack_tables(flat[:n_tab].reshape(tables.shape),
                                    flat[n_tab : n_tab + n_cfg].reshape(uint_cfgs.shape),
                                    flat[n_tab + n_cfg :])
        up = torch.from_numpy(np.concatenate([buckets.reshape(-1), cfgs])).to(streams.device)
        packed_buckets, packed_cfgs = up[: buckets.size], up[buckets.size :]
    if not all(x.is_contiguous() for x in (streams, packed_buckets, packed_cfgs)
               + lane_arrays + tabs):
        raise ValueError("decode_ac_sections takes contiguous tensors")
    plan = ac_smem_plan(C=C, NB=n_buckets, num_bctx=num_bctx, NC=context_map.numel())
    lib = load()
    coeffs = torch.zeros(total, dtype=torch.int32, device=streams.device) if out is None else out
    ok = torch.empty(S, dtype=torch.uint8, device=streams.device)
    with torch.cuda.device(streams.device):
        stream = torch.cuda.current_stream(streams.device).cuda_stream
        err = lib.ac_sections_launch(
            streams.data_ptr(), S, streams.shape[1],
            *(x.data_ptr() for x in lane_arrays),
            items.data_ptr(), items.shape[1], orders.data_ptr(), orders.numel(),
            packed_buckets.data_ptr(), packed_cfgs.data_ptr(), C, n_buckets,
            context_map.data_ptr(), context_map.numel(), log_bucket, num_bctx, total,
            coeffs.data_ptr(), ok.data_ptr(), int(plan["tab_shared"]), plan["ctx_slice"], stream,
        )
    check_launch(lib, err, "decode_ac_sections")
    decode_ac_sections.launches += 1
    return coeffs, ok.bool()


decode_ac_sections.launches = 0
