"""The card route of a Modular frame's group sections: every group stream
decoded by K6 (ops/modular_lanes.py), one lane a stream, into int32 planes
born on the card.

The route is decided from the stream. `plan` takes a frame of more than
one section whose every group stream (each (group, pass) section with
channels) uses the global tree, is rANS-coded without LZ77, reads at most
the 16 properties that need no previous channel, and has no group-local
transform but one RCT over its first three channels, in a frame whose
global image has no transform to follow the groups; it returns None for
any other frame, which decodes on the host as before
(api/frame.py:_decode_hf_groups_parallel).

Host work a frame: each GroupHeader read (from a copy of its section's
reader), each channel's subtree of the MA tree pruned on properties 0 and
1 (the channel's index in its stream and the stream id; once a channel
index when the tree never splits on the stream id) as
native/modular_decode.cc:PruneTreeForChannel does, each leaf's cluster and
HybridUint configuration folded into the leaf, the alias tables packed as
that file's PackAnsTables packs them, and one lane table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.headers.modular import GroupHeader, TransformId
from ..ops import modular_lanes
from ..utils import trace
from .decode import ModularStreamId


def _packed_tree(tree) -> np.ndarray:
    from .. import native

    arr = getattr(tree, "_native_packed", None)
    if arr is None:
        arr = native.pack_tree(tree)
        tree._native_packed = arr
    return arr


def prune(tree_arr: np.ndarray, ch: int, sid: int) -> list:
    """The subtree of a (channel index, stream id): tree_arr's rows
    (native.pack_tree) with every split on property 0 or 1 resolved, in
    PruneTreeForChannel's order; children renumbered into the list."""
    rows = tree_arr.tolist()

    def resolve(i):
        while True:
            p, v, left, right = rows[i][:4]
            if p == 0:
                i = left if ch > v else right
            elif p == 1:
                i = left if sid > v else right
            else:
                return i

    out = [list(rows[resolve(0)])]
    stack = [0] if out[0][0] >= 0 else []
    while stack:
        my = stack.pop()
        l, r = resolve(out[my][2]), resolve(out[my][3])
        out[my][2] = len(out)
        out.append(list(rows[l]))
        if rows[l][0] >= 0:
            stack.append(len(out) - 1)
        out[my][3] = len(out)
        out.append(list(rows[r]))
        if rows[r][0] >= 0:
            stack.append(len(out) - 1)
    return out


def pack_nodes(sub: list, ent: dict) -> tuple:
    """(K6's rows (n, 8) int32, whether the subtree reads WP, its depth:
    the splits on its longest path) of a pruned
    subtree: a split (property, value, child where greater, other child)
    and four zeros; a leaf (-1, 0, itself, itself), so that a walk past it
    stays there, then its payload (predictor, offset, multiplier, cluster
    | split_exponent << 8 | msb_in_token << 16 | lsb_in_token << 24): its
    context becomes its cluster and that cluster's HybridUint config. A
    predictor past 13 is 13, as the native loop's PredictOne takes it."""
    cmap, cfgs = ent["context_map"], ent["uint_configs"]
    out = np.zeros((len(sub), 8), np.int64)
    uses_wp = False
    depth = [0] * len(sub)  # children come after their parent
    for i, (p, v, left, right, pred, off, mul, ctx) in enumerate(sub):
        if p >= 0:
            out[i, :4] = (p, v, left, right)
            uses_wp |= p == 15
            depth[left] = depth[right] = depth[i] + 1
        else:
            c = int(cmap[ctx])
            se, msb, lsb = (int(x) for x in cfgs[c])
            out[i] = (-1, 0, i, i, min(pred, 13), off, mul, c | se << 8 | msb << 16 | lsb << 24)
            uses_wp |= pred == 6
    return out.astype(np.int32), uses_wp, max(depth)


def pack_tables(ent: dict) -> np.ndarray:
    """The alias tables, one uint64 a bucket: symbol, offset, cutoff, dist
    and alias dist at bits 0, 8, 21, 34 and 47 (PackAnsTables)."""
    t = ent["ans_tables"].astype(np.uint64)  # (C, 5, table_size)
    m13 = np.uint64(0x1FFF)
    return np.ascontiguousarray(
        (t[:, 1] & np.uint64(0xFF)) | ((t[:, 2] & m13) << np.uint64(8))
        | ((t[:, 3] & m13) << np.uint64(21)) | ((t[:, 0] & m13) << np.uint64(34))
        | ((t[:, 4] & m13) << np.uint64(47))).reshape(-1)


def _cells(geometry, gx_n, group):
    """(buffer, x0, y0, w, h) of a group's non-empty channel cells
    (FullModularImage._cell_view's rectangles); geometry: (buffer, width,
    height, cell width, cell height) of each buffer of the section."""
    gx, gy = group % gx_n, group // gx_n
    out = []
    for b, bw, bh, dx, dy in geometry:
        x0, y0 = gx * dx, gy * dy
        w, h = min(bw - x0, dx), min(bh - y0, dy)
        if w > 0 and h > 0:
            out.append((b, x0, y0, w, h))
    return out


def _group_header(sec, cache: dict):
    """(GroupHeader, the bit after it) of a section's reader, left where it
    is; raises what GroupHeader.read raises. A header reads exactly its own
    bits, so a section whose first n bits are those of a header parsed
    before holds the same header: cache maps n to {those bits: header}."""
    p = sec.pos
    for n, known in cache.items():
        end = (p + n + 7) // 8
        if end <= len(sec.data):
            v = int.from_bytes(sec.data[p // 8 : end], "little") >> (p % 8) & ((1 << n) - 1)
            gh = known.get(v)
            if gh is not None:
                return gh, p + n
    br = sec.__class__(sec.data)
    br.pos = p
    gh = GroupHeader.read(br)
    n = br.pos - p
    v = int.from_bytes(sec.data[p // 8 : (p + n + 7) // 8], "little") >> (p % 8) & ((1 << n) - 1)
    cache.setdefault(n, {})[v] = gh
    return gh, br.pos


def plan(frame, sections) -> tuple | None:
    """(LaneTable, {buffer: (h, w)}) of a frame that takes the card route
    (module docstring), else None. sections: the frame's section readers
    (Frame.split_sections), left where they are."""
    from .. import native

    fh = frame.header
    state = frame.lf_global
    mg, tree = state.modular_global, state.tree
    if fh.num_toc_entries == 1 or tree is None or not mg.buffer_infos or mg.transform_steps:
        return None
    hist = tree.histograms
    if hist.use_prefix_code or hist.lz77_enabled or tree.num_properties > 16:
        return None
    if mg.section_buffer_indices[0] or mg.section_buffer_indices[1]:
        return None
    ent = native.pack_entropy(hist)
    tree_arr = _packed_tree(tree)
    by_stream = bool((tree_arr[:, 0] == 1).any())
    lanes, chans, nodes, shapes, subtrees = [], [], [], {}, {}
    n_nodes = 0
    data = []
    byte_off = 0
    planes: dict = {}
    gx_n, dim, num_groups = fh.size_groups()[0], fh.group_dim, fh.num_groups
    headers: dict = {}
    for p in range(fh.passes.num_passes):
        geometry = []
        for b in mg.section_buffer_indices[2 + p]:
            info = mg.buffer_infos[b]
            geometry.append((b, info.size[0], info.size[1], dim >> info.shift[0],
                             dim >> info.shift[1]))
        # a pass's group sections and stream ids run on with the group
        sec0 = frame.section_index("hf", group=0, pass_idx=p)
        sid0 = ModularStreamId.modular_hf(fh, p, 0)
        for g in range(num_groups):
            cells = _cells(geometry, gx_n, g)
            if not cells:
                continue
            sec = sections[sec0 + g]
            try:
                gh, start = _group_header(sec, headers)
            except Exception:
                return None  # the host route raises what it raises
            if not gh.use_global_tree:
                return None
            rct = -1
            if gh.transforms:
                t = gh.transforms[0]
                if (len(gh.transforms) > 1 or t.id != TransformId.RCT or t.begin_channel != 0
                        or len(cells) < 3 or len({c[3:] for c in cells[:3]}) != 1
                        or len({mg.buffer_infos[c[0]].shift for c in cells[:3]}) != 1):
                    return None
                rct = t.rct_type
            sid = sid0 + g
            first = len(chans)
            for ci, (b, x0, y0, w, h) in enumerate(cells):
                key = (ci, sid if by_stream else -1)
                if key not in subtrees:
                    packed, uses_wp, depth = pack_nodes(prune(tree_arr, ci, sid), ent)
                    subtrees[key] = (n_nodes, len(packed), uses_wp, depth)
                    nodes.append(packed)
                    n_nodes += len(packed)
                off, n, uses_wp, depth = subtrees[key]
                if b not in planes:
                    planes[b] = len(planes)
                    info = mg.buffer_infos[b]
                    shapes[b] = (info.size[1], info.size[0])
                chans.append((planes[b], x0, y0, w, h, shapes[b][1], off, n, int(uses_wp),
                              depth))
            wp = gh.wp_header
            lanes.append((byte_off, len(sec.data), start, sid, rct, first, len(cells),
                          wp.p1c, wp.p2c, wp.p3ca, wp.p3cb, wp.p3cc, wp.p3cd, wp.p3ce,
                          wp.w0, wp.w1, wp.w2, wp.w3))
            data.append(sec.data)
            byte_off += len(sec.data)
    if not lanes:
        return None
    chans_arr = np.array(chans, np.int64).reshape(-1, modular_lanes.CHAN_FIELDS)
    table = modular_lanes.LaneTable(
        data=np.frombuffer(b"".join(data), np.uint8),
        lanes=np.array(lanes, np.int64).reshape(-1, modular_lanes.LANE_FIELDS),
        chans=chans_arr,
        nodes=np.concatenate(nodes),
        tab=pack_tables(ent),
        log_bucket=int(ent["log_bucket"]),
        table_size=int(ent["table_size"]),
        wmax=int(chans_arr[:, 3].max()),
        tree=tree,
    )
    order = sorted(planes, key=planes.get)
    return table, {b: shapes[b] for b in order}


def decode_on_card(frame, sections, device) -> bool:
    """Decode the frame's group streams by K6 into planes on `device`, kept
    in the global image's device_planes in place of the host planes, which
    are dropped unwritten, when the frame takes the route; False (nothing
    done) when it does not."""
    planned = plan(frame, sections)
    if planned is None:
        return False
    table, shapes = planned
    planes = [torch.empty(s, dtype=torch.int32, device=device) for s in shapes.values()]
    modular_lanes.decode_lanes(table, planes)
    mg = frame.lf_global.modular_global
    mg.device_planes.update(zip(shapes, planes))
    for b in shapes:
        mg.storage[b] = None
    if trace.enabled():
        trace.metrics.add("modular_card_streams", len(table.lanes))
    return True
