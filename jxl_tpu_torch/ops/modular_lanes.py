"""K6, the group streams of a Modular frame decoded one lane a stream
(csrc/modular_lanes.cu), with its plain version.

A lane is one group section's sub-bitstream after its GroupHeader: its
channels through the frame's MA tree, the weighted predictor with the
group's WP header, the rANS symbols, the final-state check, then the
group's inverse RCT. The lane table (`LaneTable`, built by
modular/group_lanes.py) holds, a lane: the section's byte offset and length
in `data`, the bit after its GroupHeader, the stream id, the RCT (-1 for
none), its channels and the group's eleven WP numbers; a channel: its
plane, its rectangle there, its pruned subtree in `nodes`, whether that
subtree reads WP and its depth. `nodes` has two int4 a node (group_lanes.pack_nodes): a
split (property, value, the child taken when the property is greater,
the other child), or a leaf (-1, 0, itself, itself) and its payload
(predictor, offset, multiplier, cluster | split_exponent << 8 |
msb_in_token << 16 | lsb_in_token << 24). `tab` holds the alias tables, a
64-bit word a bucket, as native/modular_decode.cc packs them.

No JAX kernel has this counterpart: jxl_tpu decodes these streams on the
host. `decode_lanes` launches K6 for planes on the card (one launch for
every lane of the table) or runs the plain version for planes on the CPU:
each lane through the existing native loop (native.decode_modular_native,
from the lane table's offsets, start bits, WP numbers and rectangles, with
the table's unpruned tree), then its RCT (native.rct_native). It never
falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import _nvcc

LANE_FIELDS = 18  # byte_off, byte_len, start_bit, stream_id, rct, first_chan, num_chans, 11 WP
CHAN_FIELDS = 10  # plane, x0, y0, w, h, stride, node_off, n_nodes, uses_wp, depth
# K6 reads the subtrees and the alias tables from shared memory when each
# channel's subtree has at most NODE_CAP nodes and the tables take at most
# TAB_SHARED_BYTES; else from device memory through the read-only cache
NODE_CAP = 1024
TAB_SHARED_BYTES = 96 * 1024

_lock = threading.Lock()
_lib = None
# what the last build in this process reported (seconds, nvcc's output);
# None when the library was already built
build_info = None


@dataclass
class LaneTable:
    """A frame's lanes (module docstring). `tree` is the frame's MA tree
    (with its histograms) for the plain version; `wmax` the widest channel."""

    data: np.ndarray  # uint8, the sections' bytes back to back
    lanes: np.ndarray  # (L, LANE_FIELDS) int64
    chans: np.ndarray  # (C, CHAN_FIELDS) int64
    nodes: np.ndarray  # (N, 8) int32
    tab: np.ndarray  # (words,) uint64
    log_bucket: int
    table_size: int
    wmax: int
    tree: object


def load():
    """Build csrc/modular_lanes.cu with nvcc for sm_90a at first use (into
    the package's _build/ directory) and load it; raises NativeBuildError
    when the build fails."""
    global _lib, build_info
    with _lock:
        if _lib is not None:
            return _lib
        path, info = _nvcc.build("modular_lanes")
        if info is not None:
            build_info = info
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.modular_lanes_launch.argtypes = [p, ctypes.c_longlong, p, i, p, p, p, i, i, i, p, p,
                                             i, i, i, p]
        lib.modular_lanes_launch.restype = i
        lib.modular_lanes_error_string.argtypes = [i]
        lib.modular_lanes_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def _raise_status(status: np.ndarray) -> None:
    """NativeDecodeError of the first lane whose status is not 0, with the
    host loop's code (2 overrun, 1 a wrong final state)."""
    from ..errors import NativeDecodeError

    bad = np.flatnonzero(status)
    if len(bad):
        raise NativeDecodeError(f"native modular decode failed (code {int(status[bad[0]])})")


def decode_lanes_plain(table: LaneTable, planes: list) -> None:
    """The plain version: each lane through the native host loop, then its
    RCT, into CPU int32 planes."""
    from .. import native
    from ..io.bit_reader import BitReader
    from ..io.headers.modular import GroupHeader, WeightedHeader
    from ..modular.channel import ModularChannel

    arrays = [p.numpy() for p in planes]
    for lane in table.lanes.tolist():
        off, n, start, sid, rct, first, count = lane[:7]
        br = BitReader(table.data[off : off + n].tobytes())
        br.pos = start
        views = [ModularChannel((w, h), (0, 0), data=arrays[plane][y0 : y0 + h, x0 : x0 + w])
                 for plane, x0, y0, w, h, *_ in table.chans[first : first + count].tolist()]
        header = GroupHeader(True, WeightedHeader(*lane[7:18]), [])
        native.decode_modular_native(views, sid, header, table.tree, br,
                                     max(v.data.shape[1] for v in views))
        if rct >= 0:
            rgb = tuple(v.data for v in views[:3])
            native.rct_native(rgb, rgb, rct % 7, rct // 7)


def decode_lanes(table: LaneTable, planes: list) -> None:
    """Decode every lane of `table` into `planes`, (h, w) int32 tensors,
    all on the CPU (the plain version) or all on one card (K6, one launch;
    the host then reads the lanes' status words, a wait for the card).
    Raises NativeDecodeError for the first lane that fails, with the host
    loop's code."""
    dev = planes[0].device
    if any(p.device != dev or p.dtype != torch.int32 or p.dim() != 2 for p in planes):
        raise ValueError("decode_lanes takes (h, w) int32 planes on one device")
    if dev.type == "cpu":
        decode_lanes_plain(table, planes)
        return
    if dev.type != "cuda":
        raise ValueError(f"decode_lanes runs on cpu or cuda, not {dev}")
    if any(not p.is_contiguous() for p in planes):
        raise ValueError("decode_lanes takes contiguous planes")
    from ..render.stages import core as st

    lib = load()
    L = len(table.lanes)
    if L == 0:
        return
    ptrs = np.array([p.data_ptr() for p in planes], np.int64)
    data, lanes, chans, tab, ptrs_d, nodes = st.to_device_all(
        [table.data, table.lanes, table.chans, table.tab.view(np.int64), ptrs, table.nodes], dev)
    status = torch.empty(L, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.modular_lanes_launch(
            data.data_ptr(), data.numel(), lanes.data_ptr(), L, chans.data_ptr(),
            nodes.data_ptr(), tab.data_ptr(), table.tab.size, table.log_bucket,
            table.table_size, ptrs_d.data_ptr(), status.data_ptr(), table.wmax, NODE_CAP,
            int(shared(table)), stream)
    if err != 0:
        raise RuntimeError("modular_lanes kernel launch failed: "
                           f"{lib.modular_lanes_error_string(err).decode()}")
    decode_lanes.launches += 1
    _raise_status(status.cpu().numpy())


decode_lanes.launches = 0


def shared(table: LaneTable) -> bool:
    """Whether K6 reads `table`'s subtrees and alias tables from shared
    memory (NODE_CAP, TAB_SHARED_BYTES)."""
    return (table.tab.size * 8 <= TAB_SHARED_BYTES
            and int(table.chans[:, 7].max(initial=0)) <= NODE_CAP)

