"""VarDCT HF groups on the host: block geometry, the AC item table, the
quant bias, the native whole-frame AC decode, and the per-group AC decode
of frames whose groups also carry modular HF channels.

Capability reference: jxl/src/frame/group.rs; the counterpart of the parts
of jxl_tpu/vardct/group.py that this package's VarDCT path runs. The host
numeric render of that module does not come across: the port renders
VarDCT frames through vardct/device_frame.py on either device. Nor does
its pure-Python AC decoder (_decode_pass_oracle): the port's native
library raises when it cannot be built, so nothing would call it.
"""

from __future__ import annotations

import numpy as np

from ..io.headers.frame import Encoding
from .transform_map import block_shape_id, covered_blocks_x, covered_blocks_y

BLOCK_DIM = 8
BLOCK_SIZE = 64
GROUP_DIM = 256


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def adjust_quant_bias(quant: np.ndarray, c: int, biases) -> np.ndarray:
    """ref group.rs:85-97."""
    q = quant.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        adjusted = np.where(quant == 0, 0.0, q - np.float32(biases[3]) / q)
    return np.where(np.abs(quant) < 2, q * np.float32(biases[c]), adjusted).astype(
        np.float32
    )


_CBX_ARR = np.array([covered_blocks_x(t) for t in range(27)], dtype=np.int32)
_CBY_ARR = np.array([covered_blocks_y(t) for t in range(27)], dtype=np.int32)
_SHAPE_ARR = np.array([block_shape_id(t) for t in range(27)], dtype=np.int32)


class _BlockList:
    """Geometry of all transform blocks in a group, precomputed once.

    Vectorized over the group's transform map: per-block arrays (raster
    order, matching the reference's by/bx scan in frame/group.rs:418).
    `offs` is each block's int32 offset into the group's coefficient
    buffer: the running sum of the earlier blocks' coefficient counts.
    """

    def __init__(self, frame, group):
        header = frame.header
        hf = frame.hf_meta
        (gx0, gy0), (gw, gh) = header.block_group_rect(group)
        self.origin = (gx0, gy0)
        self.size = (gw, gh)
        self.hshift = [header.hshift(c) for c in range(3)]
        self.vshift = [header.vshift(c) for c in range(3)]
        region = np.asarray(hf["transform"][gy0 : gy0 + gh, gx0 : gx0 + gw])
        bys, bxs = np.nonzero(region >= 128)
        self.bys = bys.astype(np.int32)
        self.bxs = bxs.astype(np.int32)
        self.tids = (region[bys, bxs] & 127).astype(np.int32)
        self.cxs = _CBX_ARR[self.tids]
        self.cys = _CBY_ARR[self.tids]
        self.shape_ids = _SHAPE_ARR[self.tids]
        sizes = self.cxs * self.cys * BLOCK_SIZE
        self.offs = np.zeros(len(sizes), dtype=np.int32)
        if len(sizes) > 1:
            # np.cumsum into an int32 out keeps the reference's int32 offsets
            np.cumsum(sizes[:-1], out=self.offs[1:])
        self._pass_cache = {}


def _build_pass_items(frame, bl, bctx):
    """Pass-independent item table of the AC decoders, vectorized.

    Rows interleave channels (1, 0, 2) per block in raster order, matching
    the bitstream token order (ref frame/group.rs:418-446). Columns: c,
    sbx, sby, num_blocks, num_coeffs, block_context, (6, 7 filled by the
    caller), c*GD*GD + coefficient offset, cx, cy. Also returns each row's
    (shape_id, c) order key and the keys in first-occurrence order.
    """
    hshift, vshift = bl.hshift, bl.vshift
    (gx0, gy0) = bl.origin
    hf = frame.hf_meta
    n = len(bl.tids)
    rq = np.asarray(hf["raw_quant"])[gy0 + bl.bys, gx0 + bl.bxs].astype(np.int64)
    qlf = np.asarray(hf["quant_lf"])[gy0 + bl.bys, gx0 + bl.bxs].astype(np.int64)
    if bctx.qf_thresholds:
        thr = np.asarray(bctx.qf_thresholds, dtype=np.int64)
        qf_idx = (rq[:, None] > thr[None, :]).sum(axis=1)
    else:
        qf_idx = np.zeros(n, dtype=np.int64)
    cmap = np.asarray(bctx.context_map, dtype=np.int32)
    nq1 = len(bctx.qf_thresholds) + 1
    num_blocks = bl.cxs * bl.cys
    num_coeffs = num_blocks * BLOCK_SIZE

    cols = np.zeros((n, 3, 11), dtype=np.int32)
    valid = np.zeros((n, 3), dtype=bool)
    keys = np.zeros((n, 3), dtype=np.int32)
    for j, c in enumerate((1, 0, 2)):
        hs, vs = hshift[c], vshift[c]
        sbx = bl.bxs >> hs
        sby = bl.bys >> vs
        valid[:, j] = ((sbx << hs) == bl.bxs) & ((sby << vs) == bl.bys)
        cidx = (c ^ 1) if c < 2 else 2
        midx = (cidx * 13 + bl.shape_ids.astype(np.int64)) * nq1 + qf_idx
        midx = midx * bctx.num_lf_contexts + qlf
        keys[:, j] = bl.shape_ids * 3 + c
        cols[:, j, 0] = c
        cols[:, j, 1] = sbx
        cols[:, j, 2] = sby
        cols[:, j, 3] = num_blocks
        cols[:, j, 4] = num_coeffs
        cols[:, j, 5] = cmap[midx]
        cols[:, j, 8] = c * GROUP_DIM * GROUP_DIM + bl.offs
        cols[:, j, 9] = bl.cxs
        cols[:, j, 10] = bl.cys
    vmask = valid.reshape(-1)
    items = cols.reshape(-1, 11)[vmask]
    flat_keys = keys.reshape(-1)[vmask]
    # (shape_id, c) keys in first-occurrence order; order lengths are fixed
    # per shape so the concatenated-offset layout is identical across passes
    _, first = np.unique(flat_keys, return_index=True)
    ordered_keys = flat_keys[np.sort(first)]
    return items, flat_keys, ordered_keys.tolist()


def try_decode_hf_groups(frame, group_readers: list, pool: np.ndarray) -> bool:
    """Whole-frame native HF-group decode: one C++ call decodes every
    group's AC section into `pool`, the zeroed dense (G * 3 * GD * GD,)
    int32 buffer (page-locked when the render runs on the card), kept as
    frame.host_ac_flat for the render.

    Single-pass VarDCT frames whose modular HF sections carry no channels;
    returns False for any other frame. `group_readers` is
    [(group_index, BitReader)] in group order. Raises typed errors on
    invalid streams."""
    header = frame.header
    if header.encoding != Encoding.VARDCT or header.passes.num_passes != 1:
        return False
    from .. import native

    state = frame.lf_global
    mg = state.modular_global
    if any(len(s) > 0 for s in mg.section_buffer_indices[2:]):
        return False  # modular HF channels interleave with the AC tokens
    hf_global = frame.hf_global
    hf = frame.hf_meta
    bctx = state.block_context_map
    pstate = hf_global.passes[0]

    tmap = hf["transform"]
    # coeff orders for the shapes present in this frame, concatenated with
    # a per-(shape, channel)-key offset LUT
    tids = np.unique(tmap[tmap >= 128]).astype(np.int32) & 127
    shapes = np.unique(_SHAPE_ARR[tids]).tolist()
    order_off = np.zeros(13 * 3, dtype=np.int32)
    parts = []
    pos = 0
    for s in shapes:
        for c in range(3):
            k = int(s) * 3 + c
            arr = np.ascontiguousarray(pstate.coeff_orders[k], dtype=np.int32)
            order_off[k] = pos
            parts.append(arr)
            pos += len(arr)
    orders_arr = np.concatenate(parts) if parts else np.zeros(1, np.int32)

    n = len(group_readers)
    if [g for g, _ in group_readers] != list(range(header.num_groups)):
        raise ValueError("try_decode_hf_groups takes every group, in order")
    stride = GROUP_DIM * GROUP_DIM  # VarDCT groups are always 256 px
    if pool.shape != (n * 3 * stride,) or pool.dtype != np.int32:
        raise ValueError("pool must be the frame's (G * 3 * GD * GD,) int32 buffer")
    bw, bh = header.size_blocks()
    out_pos = native.decode_hf_groups_native(
        [sec for _, sec in group_readers],
        list(range(n)),
        list(range(n)),
        bw, bh, header.size_groups()[0], GROUP_DIM // BLOCK_DIM,
        np.array([header.hshift(c) for c in range(3)], dtype=np.int32),
        np.array([header.vshift(c) for c in range(3)], dtype=np.int32),
        np.ascontiguousarray(tmap),
        np.ascontiguousarray(hf["raw_quant"], dtype=np.int32),
        np.ascontiguousarray(hf["quant_lf"]),
        np.asarray(bctx.context_map, dtype=np.uint8),
        bctx.num_contexts, bctx.num_lf_contexts,
        np.asarray(bctx.qf_thresholds, dtype=np.int32),
        bctx.num_ac_contexts, hf_global.num_histograms,
        _CBX_ARR, _CBY_ARR, _SHAPE_ARR,
        native.pack_entropy(pstate.histograms),
        orders_arr, order_off,
        header.passes.shift[0] if len(header.passes.shift) > 0 else 0,
        pool, stride,
    )
    for i, (_, sec) in enumerate(group_readers):
        sec.pos = out_pos[i]
    frame.host_ac_flat = pool
    return True


def decode_vardct_group(frame, group: int, pass_readers: list, coeffs: np.ndarray) -> None:
    """One group's AC, pass after pass, into `coeffs`, the group's
    (3, GD * GD) int32 slot of the frame's coefficient pool (ref
    frame/group.rs:384-618; jxl_tpu/vardct/group.py:decode_vardct_group
    and _decode_pass_native). pass_readers: [(pass index, BitReader)];
    each reader is left at the bit after its AC, where the group's
    modular HF stream of that pass begins."""
    from .. import native
    from ..errors import InvalidHistogramIndex

    header = frame.header
    hf_global = frame.hf_global
    bctx = frame.lf_global.block_context_map
    bl = _BlockList(frame, group)
    items, flat_keys, ordered_keys = _build_pass_items(frame, bl, bctx)
    gw, gh = bl.size
    nz_dims = np.zeros((3, 3), dtype=np.int32)
    pos = 0
    for c in range(3):
        w, h = gw >> bl.hshift[c], gh >> bl.vshift[c]
        nz_dims[c] = (w, h, pos)
        pos += w * h
    num_histo_bits = _ceil_log2(hf_global.num_histograms)
    for pass_idx, br in pass_readers:
        histogram_index = br.read(num_histo_bits)
        if histogram_index >= hf_global.num_histograms:
            raise InvalidHistogramIndex("invalid histogram index")
        pstate = hf_global.passes[pass_idx]
        # the pass's coefficient orders of the group's (shape, channel) keys
        off_lut = np.zeros(max(ordered_keys, default=0) + 1, dtype=np.int32)
        parts = []
        at = 0
        for k in ordered_keys:
            parts.append(np.asarray(pstate.coeff_orders[k], dtype=np.int32))
            off_lut[k] = at
            at += len(parts[-1])
        orders = np.concatenate(parts) if parts else np.zeros(1, np.int32)
        pass_items = items.copy()
        pass_items[:, 6] = histogram_index * bctx.num_ac_contexts
        pass_items[:, 7] = off_lut[flat_keys]
        shift = header.passes.shift[pass_idx] if pass_idx < len(header.passes.shift) else 0
        native.decode_vardct_ac_native(
            br, native.pack_entropy(pstate.histograms), pass_items, orders, coeffs, shift,
            bctx.num_contexts, np.zeros(max(pos, 1), dtype=np.int32), nz_dims,
        )
