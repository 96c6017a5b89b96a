"""Modular channel decoding: per-pixel MA-tree prediction + residuals.

Capability reference: jxl/src/frame/modular/decode/{bitstream,channel,
common}.rs. This is the host oracle (pure Python, bit-exact); the
production hot path is the native decoder in ops/native (same semantics,
verified against this oracle).
"""

from __future__ import annotations

from ..errors import InvalidBitstream, NoGlobalTree, OutOfBounds
from ..entropy import Histograms, SymbolReader
from ..io.bit_reader import BitReader
from ..io.headers.modular import GroupHeader
from .channel import ModularChannel
from .predict import (
    Predictor,
    WeightedPredictorState,
    clamped_gradient,
    predict_one,
    wrap_i32,
)
from .tree import NUM_NONREF_PROPERTIES, Tree


class ModularStreamId:
    """Stream id assignment (ref decode/common.rs:16-42)."""

    @staticmethod
    def global_data() -> int:
        return 0

    @staticmethod
    def vardct_lf(frame_header, group: int) -> int:
        return 1 + group

    @staticmethod
    def modular_lf(frame_header, group: int) -> int:
        return 1 + frame_header.num_lf_groups + group

    @staticmethod
    def lf_meta(frame_header, group: int) -> int:
        return 1 + frame_header.num_lf_groups * 2 + group

    @staticmethod
    def quant_table(frame_header, q: int) -> int:
        return 1 + frame_header.num_lf_groups * 3 + q

    NUM_QUANT_TABLES = 17

    @staticmethod
    def modular_hf(frame_header, pass_idx: int, group: int) -> int:
        return (
            1
            + frame_header.num_lf_groups * 3
            + ModularStreamId.NUM_QUANT_TABLES
            + frame_header.num_groups * pass_idx
            + group
        )


def _precompute_references(buffers, chan: int, y: int, num_ref_props: int, w: int):
    """refs[x] = flat list of 4 properties per matching previous channel."""
    refs = [[0] * num_ref_props for _ in range(w)]
    offset = 0
    cur = buffers[chan]
    ch, cw = cur.data.shape
    for i in range(chan):
        if offset >= num_ref_props:
            break
        j = chan - i - 1
        other = buffers[j]
        if other.data.shape != cur.data.shape or other.shift != cur.shift:
            continue
        row = other.data[y].tolist()
        prev = other.data[y - 1].tolist() if y > 0 else row
        for x in range(cw):
            r = refs[x]
            v = int(row[x])
            r[offset] = wrap_i32(abs(v))
            r[offset + 1] = v
            vleft = int(row[x - 1]) if x > 0 else 0
            vtop = int(prev[x]) if y > 0 else vleft
            vtopleft = (int(prev[x - 1]) if x > 0 else vleft) if y > 0 else vleft
            vpred = clamped_gradient(vleft, vtop, vtopleft)
            r[offset + 2] = wrap_i32(abs(v - vpred))
            r[offset + 3] = wrap_i32(v - vpred)
        offset += 4
    return refs


def decode_modular_channel(
    buffers: list[ModularChannel],
    chan: int,
    stream_id: int,
    header: GroupHeader,
    tree: Tree,
    reader: SymbolReader,
    br: BitReader,
) -> None:
    mc = buffers[chan]
    h, w = mc.data.shape
    histograms = tree.histograms
    nodes = tree.nodes

    num_ref_props = 0
    if tree.num_properties > NUM_NONREF_PROPERTIES:
        extra = tree.num_properties - NUM_NONREF_PROPERTIES
        num_ref_props = -(-extra // 4) * 4
    use_wp = tree.uses_weighted
    wp = WeightedPredictorState(header.wp_header, w) if use_wp else None

    props = [0] * (NUM_NONREF_PROPERTIES + num_ref_props)
    props[0] = chan
    props[1] = stream_id

    single_leaf = nodes[0].is_leaf

    prev_row = None
    prevprev = None
    for y in range(h):
        refs = (
            _precompute_references(buffers, chan, y, num_ref_props, w)
            if num_ref_props
            else None
        )
        props[2] = y
        props[9] = 0
        row = [0] * w
        for x in range(w):
            # neighborhood (ref predict.rs get_rows)
            if x > 0:
                left = row[x - 1]
            elif y > 0:
                left = prev_row[0]
            else:
                left = 0
            if y > 0:
                top = prev_row[x]
                topleft = prev_row[x - 1] if x > 0 else left
                topright = prev_row[x + 1] if x + 1 < w else top
                toprightright = prev_row[x + 2] if x + 2 < w else topright
            else:
                top = left
                topleft = left
                topright = left
                toprightright = left
            leftleft = row[x - 2] if x > 1 else left
            toptop = prevprev[x] if y > 1 else top
            pd = (left, top, toptop, topleft, topright, leftleft, toprightright)

            if use_wp:
                wp_pred, wp_prop = wp.predict_and_property(x, y, pd)
            else:
                wp_pred, wp_prop = 0, 0

            if single_leaf:
                leaf = nodes[0]
            else:
                props[3] = x
                props[4] = wrap_i32(abs(top))
                props[5] = wrap_i32(abs(left))
                props[6] = top
                props[7] = left
                props[8] = wrap_i32(left - props[9])
                props[9] = wrap_i32(left + top - topleft)
                props[10] = wrap_i32(left - topleft)
                props[11] = wrap_i32(topleft - top)
                props[12] = wrap_i32(top - topright)
                props[13] = wrap_i32(top - toptop)
                props[14] = wrap_i32(left - leftleft)
                props[15] = wp_prop
                if refs is not None:
                    props[NUM_NONREF_PROPERTIES:] = refs[x]
                leaf = tree.walk(props)

            guess = predict_one(leaf.predictor, pd, wp_pred) + leaf.offset
            dec = reader.read_signed(histograms, br, leaf.context)
            val = wrap_i32(guess + leaf.multiplier * dec)
            if use_wp:
                wp.update_errors(val, x, y)
            row[x] = val
        mc.data[y, :] = row
        prevprev = prev_row
        prev_row = row


def decode_modular_subbitstream(
    buffers: list[ModularChannel],
    stream_id: int,
    header: GroupHeader | None,
    global_tree: Tree | None,
    br: BitReader,
    partial_out: list | None = None,
) -> None:
    """Decode one modular sub-bitstream into `buffers` (in coded order).

    If `header` is None it is read from the stream, and any local
    transforms are applied (inverse) after decoding.
    With `partial_out` (a 1-element list), errors still raise but the
    number of channels decoded with a safety margin is recorded and their
    data kept (ref decode/bitstream.rs last_safe_buf semantics).
    ref: decode/bitstream.rs:142-243.
    """
    if all(b.data.size == 0 for b in buffers):
        if partial_out is not None:
            partial_out[0] = len(buffers)
        return

    from .transforms import inverse_apply_steps, meta_apply_local

    transform_steps = []
    storage = None
    local_buffers = buffers
    if header is None:
        header = GroupHeader.read(br)
        if header.transforms:
            local_buffers, transform_steps, storage = meta_apply_local(buffers, header)

    if header.use_global_tree and global_tree is None:
        raise NoGlobalTree("stream uses global tree but none was decoded")
    if not header.use_global_tree:
        num_local_samples = sum(
            b.data.shape[0] * b.data.shape[1] for b in local_buffers
        )
        size_limit = min(1024 + num_local_samples, 1 << 20)
        tree = Tree.read(br, size_limit)
    else:
        tree = global_tree

    image_width = max((b.data.shape[1] for b in local_buffers), default=0)

    # a channel-static stream goes to the lossless lanes when a whole-frame
    # decode activated a BatchContext (modular/device_lossless.py)
    from . import device_lossless

    if device_lossless.maybe_submit(
        local_buffers, tree, header, transform_steps, br,
        stream_id, image_width, partial_out,
    ):
        return

    from .. import native

    if not native.decode_modular_native(
        local_buffers, stream_id, header, tree, br, image_width, partial_out
    ):
        reader = SymbolReader(tree.histograms, br, image_width)
        last_safe = 0
        for i, b in enumerate(local_buffers):
            if b.data.size == 0:
                continue
            if br.total_bits_available() >= 32:  # DECODE_SAFETY_MARGIN
                last_safe = i
            try:
                decode_modular_channel(
                    local_buffers, i, stream_id, header, tree, reader, br
                )
            except (InvalidBitstream, OutOfBounds):
                if partial_out is not None:
                    partial_out[0] = last_safe
                raise
        try:
            reader.check_final_state(tree.histograms, br)
        except (InvalidBitstream, OutOfBounds):
            if partial_out is not None:
                partial_out[0] = last_safe
            raise
        if partial_out is not None:
            partial_out[0] = len(local_buffers)

    if transform_steps:
        inverse_apply_steps(transform_steps, storage)
