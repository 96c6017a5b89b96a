"""Native host decoder: builds (g++, cached) and wraps modular_decode.cc.

The C++ path decodes whole modular sub-bitstreams from raw section bytes
at production speed; the Python readers in entropy/ and modular/ are the
oracle it matches. The library is built at first use into the package's
_build/ directory (listed in .gitignore). A failed build raises: there is
no silent fallback to the Python readers.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading as _threading

import numpy as np

from ..errors import NativeBuildError
from ..utils import trace

_DIR = pathlib.Path(__file__).parent
_BUILD_DIR = _DIR.parent / "_build"
# (source, extra g++ flags). The decode kernels must match numpy's separate
# mul+add bit-exactly (GCC contracts a*b+c into fma by default at -O3);
# colors.cc alone gets fast-math, for vectorized powf (libmvec).
_SOURCES = (
    (_DIR / "modular_decode.cc", ["-ffp-contract=off"]),
    (_DIR / "filters.cc", []),
    (_DIR / "hostops.cc", ["-ffp-contract=off"]),
    (_DIR / "colors.cc", ["-ffast-math", "-fopenmp-simd"]),
    (_DIR / "kernel_geometry.cc", []),
)
# headers the sources include from the CUDA kernels' directory
_HEADERS = (_DIR.parent / "csrc" / "kernel_geometry.h",)

_lib = None
_lib_lock = _threading.Lock()
_hist_scratch = _threading.local()


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags (Linux), to key the build."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"".join(
        ln for ln in lines if ln.startswith((b"model name", b"flags"))
    )[:4096]


def _build() -> pathlib.Path:
    """Compile the sources (in parallel) into one shared library,
    keyed by a hash of sources and flags. Concurrent processes serialize
    on a lock file; the library is renamed into place only when complete."""
    # -march=native: the library is only valid on the CPU it was built for
    key = _cpu_id() + b"".join(s.read_bytes() + " ".join(f).encode() for s, f in _SOURCES)
    key += b"".join(h.read_bytes() for h in _HEADERS)
    tag = hashlib.sha256(key).hexdigest()[:16]
    out = _BUILD_DIR / f"_modular_decode_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        base = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC"]
        objs = [_BUILD_DIR / f"_{s.stem}_{tag}.o" for s, _ in _SOURCES]
        procs = [
            subprocess.Popen(
                base + extra + ["-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for (s, extra), o in zip(_SOURCES, objs)
        ]
        try:
            for (s, _), p in zip(_SOURCES, procs):
                log = p.communicate(timeout=600)[0]
                if p.returncode != 0:
                    raise NativeBuildError(
                        f"g++ failed on {s.name}:\n{log.decode(errors='replace')}"
                    )
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run(
                ["g++", "-shared", *map(str, objs), "-o", str(tmp)],
                capture_output=True, timeout=120,
            )
            if res.returncode != 0:
                raise NativeBuildError(
                    f"g++ link failed:\n{res.stderr.decode(errors='replace')}"
                )
            os.replace(tmp, out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for o in objs:
                o.unlink(missing_ok=True)
    return out


def get_lib():
    """The loaded native library; builds it at first use and raises
    NativeBuildError when the build fails."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name in (
                "jxl_decode_modular", "jxl_read_unsigned_run",
                "jxl_decode_lf_global_tables", "jxl_decode_histograms",
                "jxl_decode_tree", "jxl_apply_lehmer", "jxl_decode_icc",
                "jxl_read_permutations",
            ):
                getattr(lib, name).restype = ctypes.c_int
            lib.jxl_rct.restype = None
            lib.jxl_squeeze_chain.restype = None
            lib.jxl_squeeze_chain.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.jxl_spline_splat.restype = None
            lib.jxl_gradient_reconstruct.restype = None
            lib.jxl_noise_field.restype = None
            lib.jxl_noise_field.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 4
                + [ctypes.c_uint32] * 2
            )
            lib.jxl_noise_field_rows.restype = None
            lib.jxl_noise_field_rows.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 4
                + [ctypes.c_uint32] * 2 + [ctypes.c_int64] * 2
            )
            lib.jxl_lane_items.restype = ctypes.c_int
            lib.jxl_lane_items.argtypes = (
                [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int32]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int]
            )
            lib.jxl_block_tables.restype = ctypes.c_int
            lib.jxl_block_tables.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                + [ctypes.c_int64] + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
                + [ctypes.c_void_p] * 2
            )
            _bind_host_route(lib)
            _lib = lib
    return _lib


def k1_geometry(use_gab: bool, epf_iters: int) -> dict:
    """K1's tile for one stage set, as csrc/kernel_geometry.h defines it."""
    out = (ctypes.c_longlong * 6)()
    get_lib().jxl_k1_geometry(int(use_gab), int(epf_iters), out)
    return dict(zip(("halo", "halo_x", "rows", "cols", "planes", "smem_bytes"), out))


def k3_layout(tab_shared: bool, C: int, NB: int, ctx_slice: int) -> dict:
    """K3's shared-memory layout, as csrc/kernel_geometry.h defines it:
    "offsets", the byte offsets of its seven regions in order and of their
    end; the stream ring half in words, the item ring half in items, and
    the bytes of an item slot and of a context-slice entry."""
    out = (ctypes.c_longlong * 12)()
    get_lib().jxl_k3_layout(int(tab_shared), int(C), int(NB), int(ctx_slice), out)
    return dict(offsets=tuple(out[:8]), ring_half=out[8], item_half=out[9],
                item_slot_bytes=out[10], ctx_entry_bytes=out[11])


def k2_plan(S: int, T: int, L: int, sms: int) -> dict:
    """K2's launch plan, as csrc/kernel_geometry.h defines it: streams
    (warps) and threads a block, ring words a stream, shared bytes a block,
    the table's bytes and the steps between a warp's token stores."""
    fn = get_lib().jxl_k2_plan
    fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * 6)()
    fn(S, T, L, sms, out)
    return dict(zip(("warps", "threads", "ring_words", "smem_bytes", "table_bytes", "chunk"),
                    out))


def available() -> bool:
    """Always true once get_lib() returned: a failed build raised."""
    return get_lib() is not None


def _ptr(arr, typ):
    # c_void_p(addr) is ~2x cheaper than data_as(POINTER(typ)) and ctypes
    # passes either identically to untyped (no-argtypes) foreign calls.
    # Pin the array on the pointer object (like data_as does) so inline
    # temporaries stay alive for the duration of the foreign call.
    p = ctypes.c_void_p(arr.ctypes.data)
    p._arr = arr
    return p


def _databuf(br):
    """Zero-copy ctypes view of the reader's backing buffer (bytes pass
    through; bytearray wraps via from_buffer — copying the whole stream
    per native call made streaming decodes O(N * sections))."""
    d = br.data
    if isinstance(d, bytes):
        return d
    return (ctypes.c_char * len(d)).from_buffer(d)


def pack_entropy(histograms):
    """Pack a Histograms bundle into flat arrays for the native decoder.

    Memoized per Histograms object: modular decodes reuse one bundle for
    hundreds of substreams."""
    cached = getattr(histograms, "_native_packed", None)
    if cached is not None:
        return cached
    packed = _pack_entropy(histograms)
    try:
        histograms._native_packed = packed
    except AttributeError:  # foreign histogram-like object without the slot
        pass
    return packed


def _pack_entropy(histograms):
    from ..entropy.ans import NativeAnsCodes
    from ..entropy.huffman import NativeHuffmanCodes

    n_clusters = histograms.num_histograms
    use_prefix = histograms.use_prefix_code
    if isinstance(histograms.codes, NativeHuffmanCodes):
        ctx_map = np.array(histograms.context_map, dtype=np.uint8)
        cfgs = np.zeros((n_clusters, 3), dtype=np.int32)
        for c in range(n_clusters):
            u = histograms.uint_configs[c]
            cfgs[c] = (u.split_exponent, u.msb_in_token, u.lsb_in_token)
        if histograms.lz77_enabled:
            lz = histograms.lz77_length_uint
            lz_cfg = np.array(
                [lz.split_exponent, lz.msb_in_token, lz.lsb_in_token], np.int32
            )
        else:
            lz_cfg = np.zeros(3, dtype=np.int32)
        return {
            "use_prefix": 1,
            "ans_tables": np.zeros(1, dtype=np.int32),
            "table_size": 0,
            "log_bucket": 0,
            "huff_offsets": histograms.codes.offsets,
            "huff_bits": histograms.codes.bits,
            "huff_values": histograms.codes.values,
            "context_map": ctx_map,
            "uint_configs": cfgs,
            "lz77": int(histograms.lz77_enabled),
            "min_symbol": histograms.lz77_min_symbol,
            "min_length": histograms.lz77_min_length,
            "lz_cfg": lz_cfg,
            "lz_dist_cluster": histograms.lz_dist_cluster,
        }
    if isinstance(histograms.codes, NativeAnsCodes):
        # natively-decoded tables are already in the packed wire layout
        ctx_map = np.array(histograms.context_map, dtype=np.uint8)
        cfgs = np.zeros((n_clusters, 3), dtype=np.int32)
        for c in range(n_clusters):
            u = histograms.uint_configs[c]
            cfgs[c] = (u.split_exponent, u.msb_in_token, u.lsb_in_token)
        if histograms.lz77_enabled:
            lz = histograms.lz77_length_uint
            lz_cfg = np.array(
                [lz.split_exponent, lz.msb_in_token, lz.lsb_in_token], np.int32
            )
        else:
            lz_cfg = np.zeros(3, dtype=np.int32)
        return {
            "use_prefix": 0,
            "ans_tables": histograms.codes.tables,
            "table_size": histograms.codes.tables.shape[2],
            "log_bucket": histograms.codes.log_bucket_size,
            "huff_offsets": np.zeros(1, dtype=np.int32),
            "huff_bits": np.zeros(1, dtype=np.int32),
            "huff_values": np.zeros(1, dtype=np.int32),
            "context_map": ctx_map,
            "uint_configs": cfgs,
            "lz77": int(histograms.lz77_enabled),
            "min_symbol": histograms.lz77_min_symbol,
            "min_length": histograms.lz77_min_length,
            "lz_cfg": lz_cfg,
            "lz_dist_cluster": histograms.lz_dist_cluster,
        }
    if use_prefix:
        offsets = np.zeros(n_clusters, dtype=np.int32)
        bits_l, values_l = [], []
        pos = 0
        for c in range(n_clusters):
            t = histograms.codes.tables[c]
            offsets[c] = pos
            bits_l.extend(t.bits)
            values_l.extend(t.values)
            pos += len(t.bits)
        ans_tables = np.zeros(1, dtype=np.int32)
        huff = (
            offsets,
            np.array(bits_l, dtype=np.int32),
            np.array(values_l, dtype=np.int32),
        )
        table_size, log_bucket = 0, 0
    else:
        hs = histograms.codes.histograms
        table_size = len(hs[0].dist)
        log_bucket = hs[0].log_bucket_size
        ans_tables = np.zeros((n_clusters, 5, table_size), dtype=np.int32)
        for c, h in enumerate(hs):
            ans_tables[c, 0] = h.dist
            ans_tables[c, 1] = h.alias_symbol
            ans_tables[c, 2] = h.alias_offset
            ans_tables[c, 3] = h.alias_cutoff
            ans_tables[c, 4] = h.alias_dist
        huff = (
            np.zeros(1, dtype=np.int32),
            np.zeros(1, dtype=np.int32),
            np.zeros(1, dtype=np.int32),
        )
    ctx_map = np.array(histograms.context_map, dtype=np.uint8)
    cfgs = np.zeros((n_clusters, 3), dtype=np.int32)
    for c in range(n_clusters):
        u = histograms.uint_configs[c]
        cfgs[c] = (u.split_exponent, u.msb_in_token, u.lsb_in_token)
    if histograms.lz77_enabled:
        lz = histograms.lz77_length_uint
        lz_cfg = np.array([lz.split_exponent, lz.msb_in_token, lz.lsb_in_token], dtype=np.int32)
    else:
        lz_cfg = np.zeros(3, dtype=np.int32)
    return {
        "use_prefix": int(use_prefix),
        "ans_tables": np.ascontiguousarray(ans_tables),
        "table_size": table_size,
        "log_bucket": log_bucket,
        "huff_offsets": huff[0],
        "huff_bits": huff[1],
        "huff_values": huff[2],
        "context_map": ctx_map,
        "uint_configs": np.ascontiguousarray(cfgs),
        "lz77": int(histograms.lz77_enabled),
        "min_symbol": histograms.lz77_min_symbol,
        "min_length": histograms.lz77_min_length,
        "lz_cfg": lz_cfg,
        "lz_dist_cluster": histograms.lz_dist_cluster,
    }


def decode_histograms_native(br, num_contexts: int, allow_lz77: bool):
    """Decode a Histograms bundle natively. Returns the filled Histograms
    object, None when the native library is unavailable or the bundle uses
    prefix codes (caller falls back to the Python oracle); raises on
    bitstream errors."""
    lib = get_lib()
    from ..errors import InvalidBitstream, InvalidPermutation, NativeDecodeError, OutOfBounds
    from ..entropy.ans import NativeAnsCodes
    from ..entropy.hybrid_uint import HybridUint
    from ..entropy.reader import Histograms

    max_clusters = min(num_contexts + 1, 256)
    meta = np.zeros(16, dtype=np.int32)
    lz_cfg = np.zeros(3, dtype=np.int32)
    # scratch the native decoder fully writes for the region we slice;
    # reused per thread (results are .copy()'d out below)
    scr = _hist_scratch.__dict__
    if scr.get("cap", -1) < num_contexts:
        scr["cap"] = max(num_contexts, 4096)
        scr["cmap"] = np.empty(scr["cap"] + 1, dtype=np.uint8)
        scr["cfgs"] = np.empty((256, 3), dtype=np.int32)
        scr["tables"] = np.empty((256, 5, 256), dtype=np.int32)
        scr["singles"] = np.empty(256, dtype=np.int32)
        scr["huff_off"] = np.empty(256, dtype=np.int32)
    cmap = scr["cmap"]
    cfgs = scr["cfgs"]
    tables = scr["tables"]
    singles = scr["singles"]
    huff_off = scr["huff_off"]
    if "huff_bits" not in scr:
        scr["huff_bits"] = np.empty(1 << 14, dtype=np.int32)
        scr["huff_vals"] = np.empty(1 << 14, dtype=np.int32)
    data = _databuf(br)
    while True:
        huff_bits = scr["huff_bits"]
        huff_vals = scr["huff_vals"]
        huff_cap = len(huff_bits)
        bit_pos = ctypes.c_uint64(br.pos)
        ret = lib.jxl_decode_histograms(
            data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
            ctypes.c_int(num_contexts), ctypes.c_int(1 if allow_lz77 else 0),
            _ptr(meta, ctypes.c_int32), _ptr(lz_cfg, ctypes.c_int32),
            _ptr(cmap, ctypes.c_uint8), _ptr(cfgs, ctypes.c_int32),
            _ptr(tables, ctypes.c_int32), _ptr(singles, ctypes.c_int32),
            _ptr(huff_off, ctypes.c_int32), _ptr(huff_bits, ctypes.c_int32),
            _ptr(huff_vals, ctypes.c_int32), ctypes.c_int64(huff_cap),
        )
        if ret != 9:
            break
        grown = max(huff_cap * 2, int(meta[11]))
        scr["huff_bits"] = np.empty(grown, dtype=np.int32)
        scr["huff_vals"] = np.empty(grown, dtype=np.int32)
    if ret == 8:
        return None  # needs the python oracle
    if ret == 2:
        raise OutOfBounds(1)
    if ret != 0:
        raise NativeDecodeError(f"native histogram decode failed (code {ret})")
    br.pos = bit_pos.value
    return _histograms_from_packed(
        meta, lz_cfg, cmap, cfgs, tables, singles,
        huff_off, huff_bits, huff_vals, num_contexts,
    )


def _histograms_from_packed(
    meta, lz_cfg, cmap, cfgs, tables, singles, huff_off, huff_bits, huff_vals,
    num_contexts,
):
    """Build a Histograms object (with its _native_packed dict attached)
    from the jxl_decode_histograms output-array convention. The arrays are
    shared per-thread scratch — everything kept is copied out."""
    from ..entropy.ans import NativeAnsCodes
    from ..entropy.hybrid_uint import HybridUint
    from ..entropy.reader import Histograms

    h = Histograms.__new__(Histograms)
    h.lz77_enabled = bool(meta[0])
    h.lz77_min_symbol = int(meta[1])
    h.lz77_min_length = int(meta[2])
    h.lz77_length_uint = (
        HybridUint(int(lz_cfg[0]), int(lz_cfg[1]), int(lz_cfg[2]))
        if h.lz77_enabled
        else None
    )
    n_ctx = num_contexts + (1 if h.lz77_enabled else 0)
    h.context_map = cmap[:n_ctx].tolist()
    h.lz_dist_cluster = h.context_map[-1] if h.lz77_enabled else 0
    h.use_prefix_code = bool(meta[10])
    h.log_alpha_size = int(meta[6])
    num_clusters = int(meta[7])
    table_size = int(meta[8])
    h.uint_configs = [
        HybridUint(int(cfgs[c, 0]), int(cfgs[c, 1]), int(cfgs[c, 2]))
        for c in range(num_clusters)
    ]
    # copies, not views: cmap/cfgs are shared per-thread scratch
    cfgs_arr = cfgs[:num_clusters].copy()
    lz_cfg_arr = lz_cfg.copy() if h.lz77_enabled else np.zeros(3, dtype=np.int32)
    ctx_arr = cmap[:n_ctx].copy()
    if h.use_prefix_code:
        from ..entropy.huffman import NativeHuffmanCodes

        n = int(meta[11])
        h.codes = NativeHuffmanCodes(
            huff_off[:num_clusters].copy(), huff_bits[:n].copy(),
            huff_vals[:n].copy(), singles[:num_clusters].copy(),
        )
        h._native_packed = {
            "use_prefix": 1,
            "ans_tables": np.zeros(1, dtype=np.int32),
            "table_size": 0,
            "log_bucket": 0,
            "huff_offsets": h.codes.offsets,
            "huff_bits": h.codes.bits,
            "huff_values": h.codes.values,
            "context_map": ctx_arr,
            "uint_configs": cfgs_arr,
            "lz77": int(h.lz77_enabled),
            "min_symbol": h.lz77_min_symbol,
            "min_length": h.lz77_min_length,
            "lz_cfg": lz_cfg_arr,
            "lz_dist_cluster": h.lz_dist_cluster,
        }
    else:
        # the native decoder packs clusters contiguously at stride table_size
        packed = (
            tables.reshape(-1)[: num_clusters * 5 * table_size]
            .reshape(num_clusters, 5, table_size)
            .copy()
        )
        h.codes = NativeAnsCodes(
            packed, singles[:num_clusters].copy(), int(meta[9])
        )
        h._native_packed = {
            "use_prefix": 0,
            "ans_tables": packed,
            "table_size": table_size,
            "log_bucket": int(meta[9]),
            "huff_offsets": np.zeros(1, dtype=np.int32),
            "huff_bits": np.zeros(1, dtype=np.int32),
            "huff_values": np.zeros(1, dtype=np.int32),
            "context_map": ctx_arr,
            "uint_configs": cfgs_arr,
            "lz77": int(h.lz77_enabled),
            "min_symbol": h.lz77_min_symbol,
            "min_length": h.lz77_min_length,
            "lz_cfg": lz_cfg_arr,
            "lz_dist_cluster": h.lz_dist_cluster,
        }
    return h


def pack_tree(tree) -> np.ndarray:
    nodes = np.zeros((len(tree.nodes), 8), dtype=np.int32)
    for i, n in enumerate(tree.nodes):
        if n.is_leaf:
            nodes[i] = (-1, 0, 0, 0, int(n.predictor), n.offset, n.multiplier, n.context)
        else:
            nodes[i] = (n.property, n.splitval, n.left, n.right, 0, 0, 1, 0)
    return nodes


def _entropy_args(ent, dist_multiplier: int = 0):
    """The shared ctypes argument tail for packed entropy tables
    (memoized on the packed dict for the common dist_multiplier=0)."""
    if dist_multiplier == 0:
        cached = ent.get("_eargs0")
        if cached is None:
            cached = _entropy_args_build(ent, 0)
            ent["_eargs0"] = cached
        return cached
    return _entropy_args_build(ent, dist_multiplier)


def _entropy_args_build(ent, dist_multiplier: int):
    return (
        ctypes.c_int(ent["use_prefix"]),
        _ptr(ent["ans_tables"], ctypes.c_int32), ctypes.c_int(ent["table_size"]),
        ctypes.c_int(ent["log_bucket"]),
        _ptr(ent["huff_offsets"], ctypes.c_int32),
        _ptr(ent["huff_bits"], ctypes.c_int32),
        _ptr(ent["huff_values"], ctypes.c_int32),
        _ptr(ent["context_map"], ctypes.c_uint8),
        ctypes.c_int(len(ent["context_map"])),
        _ptr(ent["uint_configs"], ctypes.c_int32),
        ctypes.c_int(ent["lz77"]), ctypes.c_uint32(ent["min_symbol"]),
        ctypes.c_uint32(ent["min_length"]), _ptr(ent["lz_cfg"], ctypes.c_int32),
        ctypes.c_int(ent["lz_dist_cluster"]), ctypes.c_uint32(dist_multiplier),
    )


def decode_tree_native(histograms, br, size_limit: int):
    """MA-tree node loop natively. Returns (nodes_arr (N,8) int32,
    max_property) or None when unavailable; raises on bitstream errors."""
    lib = get_lib()
    from ..errors import InvalidBitstream, InvalidPermutation, NativeDecodeError, OutOfBounds

    ent = pack_entropy(histograms)
    data = _databuf(br)
    cap = 1 << 12
    # (tree nodes scratch below is sliced to the decoded count)
    while True:
        nodes = np.empty((cap, 8), dtype=np.int32)
        count = ctypes.c_int64(0)
        max_prop = ctypes.c_int32(0)
        bit_pos = ctypes.c_uint64(br.pos)
        ret = lib.jxl_decode_tree(
            data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
            *_entropy_args(ent),
            ctypes.c_int64(size_limit), ctypes.c_int64(cap),
            _ptr(nodes, ctypes.c_int32), ctypes.byref(count),
            ctypes.byref(max_prop),
        )
        if ret != 9:
            break
        cap *= 4
    if ret == 2:
        raise OutOfBounds(1)
    if ret != 0:
        raise NativeDecodeError(f"native tree decode failed (code {ret})")
    br.pos = bit_pos.value
    return nodes[: count.value], int(max_prop.value)


def read_permutations_native(histograms, br, sizes, skips, check_final: bool):
    """The Lehmer codes of len(sizes) permutations that share one entropy
    decoder (modular_decode.cc jxl_read_permutations; the counterpart of
    jxl_tpu/native/__init__.py:read_permutations_native): permutation p of
    sizes[p] entries, identity on its first skips[p], codes its end and
    then that many Lehmer values, each in the context of the one before.
    Returns a list of uint32 arrays, the coded values of each permutation
    (its tail past them is 0), and moves br past them; with check_final
    the decoder's final state is checked too. Raises OutOfBounds on a
    stream that ends early, InvalidPermutation on an end past sizes[p] -
    skips[p] and NativeDecodeError on any other fault."""
    lib = get_lib()
    from ..errors import InvalidPermutation, NativeDecodeError, OutOfBounds

    ent = pack_entropy(histograms)
    data = _databuf(br)
    sz = np.asarray(sizes, dtype=np.uint32)
    sk = np.asarray(skips, dtype=np.uint32)
    cap = max(int(sz.sum()), 1)
    lehmer = np.zeros(cap, dtype=np.uint32)
    ends = np.zeros(len(sz), dtype=np.int64)
    bit_pos = ctypes.c_uint64(br.pos)
    ret = lib.jxl_read_permutations(
        data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
        *_entropy_args(ent),
        ctypes.c_int(len(sz)), _ptr(sz, ctypes.c_uint32), _ptr(sk, ctypes.c_uint32),
        _ptr(lehmer, ctypes.c_uint32), ctypes.c_int64(cap), _ptr(ends, ctypes.c_int64),
        ctypes.c_int(1 if check_final else 0),
    )
    if ret == 2:
        raise OutOfBounds(1)
    if ret == 3:
        raise InvalidPermutation("invalid permutation size")
    if ret != 0:
        raise NativeDecodeError(f"native permutation decode failed (code {ret})")
    br.pos = bit_pos.value
    bounds = np.concatenate([[0], np.cumsum(ends)])
    return [lehmer[bounds[p] : bounds[p + 1]] for p in range(len(sz))]


def read_unsigned_run(histograms, br, ctx: int, count: int,
                      check_final: bool = False, dist_multiplier: int = 0):
    """Decode `count` clustered unsigned values at a fixed context natively
    (e.g. the entropy-coded context map). Returns a uint32 array or None
    when the native library is unavailable."""
    lib = get_lib()
    from ..errors import InvalidBitstream, InvalidPermutation, NativeDecodeError

    ent = pack_entropy(histograms)
    out = np.zeros(max(count, 1), dtype=np.uint32)
    data = _databuf(br)
    bit_pos = ctypes.c_uint64(br.pos)
    ret = lib.jxl_read_unsigned_run(
        data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
        ctypes.c_int(ent["use_prefix"]),
        _ptr(ent["ans_tables"], ctypes.c_int32), ctypes.c_int(ent["table_size"]),
        ctypes.c_int(ent["log_bucket"]),
        _ptr(ent["huff_offsets"], ctypes.c_int32),
        _ptr(ent["huff_bits"], ctypes.c_int32),
        _ptr(ent["huff_values"], ctypes.c_int32),
        _ptr(ent["context_map"], ctypes.c_uint8), ctypes.c_int(len(ent["context_map"])),
        _ptr(ent["uint_configs"], ctypes.c_int32),
        ctypes.c_int(ent["lz77"]), ctypes.c_uint32(ent["min_symbol"]),
        ctypes.c_uint32(ent["min_length"]), _ptr(ent["lz_cfg"], ctypes.c_int32),
        ctypes.c_int(ent["lz_dist_cluster"]), ctypes.c_uint32(dist_multiplier),
        ctypes.c_int(ctx), ctypes.c_int(count), _ptr(out, ctypes.c_uint32),
        ctypes.c_int(1 if check_final else 0),
    )
    if ret != 0:
        raise NativeDecodeError(f"native unsigned-run decode failed (code {ret})")
    br.pos = bit_pos.value
    return out


def _runs_general_loop(tree_arr, num_props: int, residuals: bool) -> bool:
    """Whether jxl_decode_modular decodes a sub-bitstream with this packed
    tree in its general tree loop, and not a specialised one: mirrors its
    gradient_only, residual-mode (chan_static) and wp_only analysis
    (modular_decode.cc)."""
    leaf = tree_arr[:, 0] < 0
    pred, split_props = tree_arr[leaf, 4], tree_arr[~leaf, 0]
    simple = (tree_arr[leaf, 5] == 0).all() and (tree_arr[leaf, 6] == 1).all()
    chan_split = (split_props == 0).all()
    if chan_split and simple and (pred == 5).all():
        return False  # gradient-only: the RLE or the gradient loop
    if residuals and chan_split and simple and np.isin(pred, (0, 1, 2, 5)).all():
        return False  # raw residuals for the device lanes
    wp_only = (len(split_props) > 0 and (split_props == 15).all()
               and num_props <= 16 and np.isin(pred, (0, 6)).all())
    return not wp_only


def decode_modular_native(
    buffers, stream_id, header, tree, br, image_width, partial_out=None,
    residuals=False,
) -> bool:
    """Decode all channels of a modular sub-bitstream natively.

    Returns True on success (br.pos advanced, buffers filled); raises on
    bitstream errors. Falls back (returns False) if unavailable.

    While tracing is on it counts the sub-bitstream in
    `modular_group_streams`, and its samples in `modular_tree_samples`
    when the general tree loop decoded them (not a specialised one).

    With residuals=True (caller must have checked tree.is_gradient_only),
    buffers receive the raw signed residuals instead of reconstructed
    pixels — the device wavefront reconstruction consumes these.

    With `partial_out` (a 1-element list), bitstream errors still raise but
    partial_out[0] receives the number of channels decoded with a safety
    margin before the failure, and those channels' data is kept (ref
    decode/bitstream.rs last_safe_buf partial-decode semantics).
    """
    lib = get_lib()
    from ..errors import InvalidBitstream, InvalidPermutation, NativeDecodeError

    ent = pack_entropy(tree.histograms)
    tree_arr = getattr(tree, "_native_packed", None)
    if tree_arr is None:
        tree_arr = pack_tree(tree)
        try:
            tree._native_packed = tree_arr
        except AttributeError:
            pass
    wp = header.wp_header
    wp_params = getattr(wp, "_native_params", None)
    if wp_params is None:
        wp_params = np.array(
            [wp.p1c, wp.p2c, wp.p3ca, wp.p3cb, wp.p3cc, wp.p3cd, wp.p3ce,
             wp.w0, wp.w1, wp.w2, wp.w3, 0],
            dtype=np.int32,
        )
        try:
            wp._native_params = wp_params
        except AttributeError:
            pass

    # Channels decode straight into the caller's planes (flag bit 2:
    # ChannelDesc.offset carries the absolute base address) when every
    # buffer is a C-contiguous int32 plane; otherwise fall back to the
    # packed scratch + copy-out layout.
    direct = all(
        b.data.dtype == np.int32 and b.data.flags.c_contiguous for b in buffers
    )
    chan_info = np.empty((max(len(buffers), 1), 6), dtype=np.int64)
    if direct:
        out = np.empty(1, dtype=np.int32)
        for i, b in enumerate(buffers):
            h, w = b.data.shape
            shift = b.shift if b.shift is not None else (-1, -1)
            chan_info[i] = (w, h, shift[0], shift[1], w, b.data.ctypes.data)
    else:
        total = sum(b.data.shape[0] * b.data.shape[1] for b in buffers)
        # every live channel element is written by the decode loops
        out = np.empty(max(total, 1), dtype=np.int32)
        off = 0
        for i, b in enumerate(buffers):
            h, w = b.data.shape
            shift = b.shift if b.shift is not None else (-1, -1)
            chan_info[i] = (w, h, shift[0], shift[1], w, off)
            off += h * w

    data = _databuf(br)
    bit_pos = ctypes.c_uint64(br.pos)
    num_decoded = ctypes.c_int64(0)
    # the per-histograms / per-tree ctypes argument tuples are constant
    # across the hundreds of substreams sharing one bundle — memoize them
    # (animations spend real time in this marshaling otherwise)
    margs = ent.get("_modular_args")
    if margs is None:
        margs = (
            ctypes.c_int(ent["use_prefix"]),
            _ptr(ent["ans_tables"], ctypes.c_int32), ctypes.c_int(ent["table_size"]),
            ctypes.c_int(ent["log_bucket"]),
            _ptr(ent["huff_offsets"], ctypes.c_int32),
            _ptr(ent["huff_bits"], ctypes.c_int32),
            _ptr(ent["huff_values"], ctypes.c_int32),
            _ptr(ent["context_map"], ctypes.c_uint8), ctypes.c_int(len(ent["context_map"])),
            _ptr(ent["uint_configs"], ctypes.c_int32),
            ctypes.c_int(ent["lz77"]), ctypes.c_uint32(ent["min_symbol"]),
            ctypes.c_uint32(ent["min_length"]), _ptr(ent["lz_cfg"], ctypes.c_int32),
            ctypes.c_int(ent["lz_dist_cluster"]),
        )
        ent["_modular_args"] = margs
    ret = lib.jxl_decode_modular(
        data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
        *margs,
        ctypes.c_uint32(image_width if ent["lz77"] else 0),
        _ptr(tree_arr, ctypes.c_int32), ctypes.c_int(len(tree_arr)),
        ctypes.c_int(tree.num_properties),
        _ptr(wp_params, ctypes.c_int32),
        ctypes.c_int(len(buffers)), _ptr(chan_info, ctypes.c_int64),
        _ptr(out, ctypes.c_int32), ctypes.c_int(stream_id),
        ctypes.byref(num_decoded),
        ctypes.c_int((1 if residuals else 0) | (4 if direct else 0)),
    )
    if ret != 0:
        if partial_out is not None:
            partial_out[0] = int(num_decoded.value)
            if not direct:
                off = 0
                for i, b in enumerate(buffers):
                    h, w = b.data.shape
                    if i < num_decoded.value:
                        b.data[...] = out[off : off + h * w].reshape(h, w)
                    off += h * w
        raise NativeDecodeError(f"native modular decode failed (code {ret})")
    br.pos = bit_pos.value
    if not direct:
        off = 0
        for b in buffers:
            h, w = b.data.shape
            b.data[...] = out[off : off + h * w].reshape(h, w)
            off += h * w
    if trace.enabled():
        trace.metrics.add("modular_group_streams")
        if _runs_general_loop(tree_arr, tree.num_properties, residuals):
            trace.metrics.add("modular_tree_samples", sum(b.data.size for b in buffers))
    return True


_NAT_ORDERS = None


def _natural_orders_concat():
    """Process-cached concatenation of the 13 natural zig-zag orders
    (int32) + the 14-entry prefix-offset table for the native HfGlobal
    fast path."""
    global _NAT_ORDERS
    if _NAT_ORDERS is None:
        from ..vardct.coeff_order import TRANSFORM_TYPE_LUT, natural_order_array

        parts = [natural_order_array(t) for t in TRANSFORM_TYPE_LUT]
        off = np.zeros(14, dtype=np.int32)
        for i, p in enumerate(parts):
            off[i + 1] = off[i] + len(p)
        _NAT_ORDERS = (
            np.ascontiguousarray(np.concatenate(parts)).astype(np.int32),
            off,
        )
    return _NAT_ORDERS


_hf_global_scratch = _threading.local()


def decode_hf_global_native(br, num_histo_bits: int, num_ac_contexts: int):
    """Single-pass HfGlobal with all-default dequant matrices in one
    native call (ref frame/decode.rs:513-583): default bit,
    num_histograms, pass-0 order selector, coded coefficient orders
    (permutations + Lehmer against the cached natural orders), AC
    histograms. Returns (num_histograms, used_orders, coded-orders dict,
    Histograms), or None when the stream carries custom matrices or
    prefix-coded order histograms (bit position untouched: the Python
    readers of vardct/hf_global.py read it); raises typed errors on bad
    streams."""
    lib = get_lib()
    from ..errors import InvalidPermutation, NativeDecodeError, OutOfBounds

    nat, nat_off = _natural_orders_concat()
    scr = _hf_global_scratch.__dict__
    max_ctx = (1 << num_histo_bits) * num_ac_contexts + 8
    if scr.get("cap", -1) < max_ctx:
        scr["cap"] = max(max_ctx, 4096)
        scr["cmap"] = np.empty(scr["cap"] + 1, dtype=np.uint8)
    if "orders" not in scr:
        scr["orders"] = np.empty(3 * len(nat), dtype=np.int32)
        scr["cfgs"] = np.empty((256, 3), dtype=np.int32)
        scr["tables"] = np.empty((256, 5, 256), dtype=np.int32)
        scr["singles"] = np.empty(256, dtype=np.int32)
        scr["huff_off"] = np.empty(256, dtype=np.int32)
        scr["huff_bits"] = np.empty(1 << 14, dtype=np.int32)
        scr["huff_vals"] = np.empty(1 << 14, dtype=np.int32)
    info = np.zeros(2, dtype=np.int32)
    meta = np.zeros(16, dtype=np.int32)
    lz_cfg = np.zeros(3, dtype=np.int32)
    orders = scr["orders"]
    cmap = scr["cmap"]
    cfgs = scr["cfgs"]
    tables = scr["tables"]
    singles = scr["singles"]
    huff_off = scr["huff_off"]
    data = _databuf(br)
    while True:
        huff_bits = scr["huff_bits"]
        huff_vals = scr["huff_vals"]
        bit_pos = ctypes.c_uint64(br.pos)
        ret = lib.jxl_decode_hf_global(
            data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
            ctypes.c_int(num_histo_bits), ctypes.c_int(num_ac_contexts),
            _ptr(nat, ctypes.c_int32), _ptr(nat_off, ctypes.c_int32),
            _ptr(info, ctypes.c_int32), _ptr(orders, ctypes.c_int32),
            _ptr(meta, ctypes.c_int32), _ptr(lz_cfg, ctypes.c_int32),
            _ptr(cmap, ctypes.c_uint8), _ptr(cfgs, ctypes.c_int32),
            _ptr(tables, ctypes.c_int32), _ptr(singles, ctypes.c_int32),
            _ptr(huff_off, ctypes.c_int32), _ptr(huff_bits, ctypes.c_int32),
            _ptr(huff_vals, ctypes.c_int32), ctypes.c_int64(len(huff_bits)),
        )
        if ret != 9:
            break
        grown = max(len(huff_bits) * 2, int(meta[11]))
        scr["huff_bits"] = np.empty(grown, dtype=np.int32)
        scr["huff_vals"] = np.empty(grown, dtype=np.int32)
    if ret == 100 or ret == 8:
        return None  # custom matrices / prefix path: python oracle
    if ret == 2:
        raise OutOfBounds(1)
    if ret == 3:
        raise InvalidPermutation("invalid permutation size")
    if ret != 0:
        raise NativeDecodeError(f"native HfGlobal decode failed (code {ret})")
    br.pos = bit_pos.value
    num_histograms = int(info[0])
    used_orders = int(info[1])
    coded = {}
    pos = 0
    for o in range(13):
        if not (used_orders >> o) & 1:
            continue
        size = int(nat_off[o + 1] - nat_off[o])
        for c in range(3):
            coded[3 * o + c] = orders[pos : pos + size].copy()
            pos += size
    histograms = _histograms_from_packed(
        meta, lz_cfg, cmap, cfgs, tables, singles,
        huff_off, scr["huff_bits"], scr["huff_vals"],
        num_histograms * num_ac_contexts,
    )
    return num_histograms, used_orders, coded, histograms


def decode_lf_global_tables_native(br, is_vardct: bool, tree_size_limit: int):
    """LfGlobal table sequence in one native call (ref frame/decode.rs:
    314-434): LF quant factors, [VarDCT: quantizer params + block context
    map + CfL params], optional global MA tree incl. leaf histograms.

    Returns a dict of constructed objects (lf_quant tuple, quant params,
    block ctx map fields, cfl fields, tree) or None when unavailable;
    raises typed errors on invalid streams."""
    lib = get_lib()
    from ..errors import (
        BaseColorCorrelationOutOfRange,
        FloatNaNOrInf,
        InvalidContextMap,
        LfQuantFactorTooSmall,
        NativeDecodeError,
        OutOfBounds,
        TooManyBlockContexts,
        TreeTooLarge,
    )

    scr = _hist_scratch.__dict__
    if scr.get("cap", -1) < 4096:
        scr["cap"] = 4096
        scr["cmap"] = np.empty(scr["cap"] + 1, dtype=np.uint8)
        scr["cfgs"] = np.empty((256, 3), dtype=np.int32)
        scr["tables"] = np.empty((256, 5, 256), dtype=np.int32)
        scr["singles"] = np.empty(256, dtype=np.int32)
        scr["huff_off"] = np.empty(256, dtype=np.int32)
    if "huff_bits" not in scr:
        scr["huff_bits"] = np.empty(1 << 14, dtype=np.int32)
        scr["huff_vals"] = np.empty(1 << 14, dtype=np.int32)
    if "lfg_scal" not in scr:
        scr["lfg_scal"] = np.empty(24, dtype=np.int32)
        scr["lfg_dbl"] = np.empty(8, dtype=np.float64)
        scr["lfg_lfthr"] = np.empty(48, dtype=np.int32)
        scr["lfg_qfthr"] = np.empty(16, dtype=np.int32)
        scr["lfg_bctx"] = np.empty(2600, dtype=np.uint8)
        scr["lfg_tree"] = np.empty((1 << 12, 8), dtype=np.int32)
    meta = np.zeros(16, dtype=np.int32)
    lz_cfg = np.zeros(3, dtype=np.int32)
    scal = scr["lfg_scal"]
    dbl = scr["lfg_dbl"]
    scal[:] = 0
    data = _databuf(br)
    while True:
        huff_bits = scr["huff_bits"]
        huff_vals = scr["huff_vals"]
        tree_nodes = scr["lfg_tree"]
        bit_pos = ctypes.c_uint64(br.pos)
        ret = lib.jxl_decode_lf_global_tables(
            data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
            ctypes.c_int(1 if is_vardct else 0),
            ctypes.c_int64(tree_size_limit), ctypes.c_int64(len(tree_nodes)),
            _ptr(scal, ctypes.c_int32), _ptr(dbl, ctypes.c_double),
            _ptr(scr["lfg_lfthr"], ctypes.c_int32),
            _ptr(scr["lfg_qfthr"], ctypes.c_int32),
            _ptr(scr["lfg_bctx"], ctypes.c_uint8),
            _ptr(tree_nodes, ctypes.c_int32),
            _ptr(meta, ctypes.c_int32), _ptr(lz_cfg, ctypes.c_int32),
            _ptr(scr["cmap"], ctypes.c_uint8), _ptr(scr["cfgs"], ctypes.c_int32),
            _ptr(scr["tables"], ctypes.c_int32), _ptr(scr["singles"], ctypes.c_int32),
            _ptr(scr["huff_off"], ctypes.c_int32),
            _ptr(huff_bits, ctypes.c_int32), _ptr(huff_vals, ctypes.c_int32),
            ctypes.c_int64(len(huff_bits)),
        )
        if ret == 9:
            grown = max(len(huff_bits) * 2, int(meta[11]))
            scr["huff_bits"] = np.empty(grown, dtype=np.int32)
            scr["huff_vals"] = np.empty(grown, dtype=np.int32)
            continue
        if ret == 11:
            scr["lfg_tree"] = np.empty((len(tree_nodes) * 4, 8), dtype=np.int32)
            continue
        break
    if ret == 2:
        raise OutOfBounds(1)
    if ret == 20:
        raise LfQuantFactorTooSmall("LF quant factor too small")
    if ret == 21:
        raise InvalidContextMap("invalid block context map")
    if ret == 22:
        raise TooManyBlockContexts("too many block contexts")
    if ret == 23:
        raise BaseColorCorrelationOutOfRange("base color correlation out of range")
    if ret == 24:
        raise FloatNaNOrInf("f16 header field is NaN or Inf")
    if ret == 25:
        raise NativeDecodeError("invalid MA tree value")
    if ret != 0:
        raise NativeDecodeError(f"native lf-global decode failed (code {ret})")

    out = {
        "lf_quant": (float(dbl[0]), float(dbl[1]), float(dbl[2])),
        "tree": None,
    }
    if is_vardct:
        out["quant_params"] = (int(scal[0]), int(scal[1]))
        if scal[2]:
            out["bctx_default"] = True
        else:
            out["bctx_default"] = False
            thr = scr["lfg_lfthr"]
            n0, n1, n2 = int(scal[5]), int(scal[6]), int(scal[7])
            out["lf_thresholds"] = [
                thr[:n0].tolist(),
                thr[n0 : n0 + n1].tolist(),
                thr[n0 + n1 : n0 + n1 + n2].tolist(),
            ]
            out["qf_thresholds"] = scr["lfg_qfthr"][: int(scal[4])].tolist()
            out["bctx_map"] = scr["lfg_bctx"][: int(scal[8])].tolist()
            out["num_lf_contexts"] = int(scal[3])
            out["bctx_num_contexts"] = int(scal[9])
        out["cfl"] = (
            int(scal[10]), float(dbl[3]), float(dbl[4]),
            int(scal[11]), int(scal[12]),
        )
    if scal[13]:
        from ..modular.tree import Tree

        count = int(scal[14])
        arr = np.ascontiguousarray(scr["lfg_tree"][:count])
        t = Tree.__new__(Tree)
        t._arr = arr
        t._nodes = None
        t._native_packed = arr
        t.num_properties = int(scal[15]) + 1
        t._validate_arr(arr)
        t.histograms = _histograms_from_packed(
            meta, lz_cfg, scr["cmap"], scr["cfgs"], scr["tables"],
            scr["singles"], scr["huff_off"], scr["huff_bits"],
            scr["huff_vals"], (count + 1) // 2,
        )
        out["tree"] = t
    br.pos = bit_pos.value
    return out


def apply_lehmer(code, n: int):
    """Order-statistics application of a Lehmer code: returns the int32
    index array `idx` with out[i] = base[idx[i]] (the i-th smallest
    still-unused position), or None when the native lib is unavailable.
    Raises InvalidPermutation on invalid code values."""
    lib = get_lib()
    from ..errors import InvalidPermutation

    code_arr = np.asarray(code, dtype=np.uint32)
    out = np.empty(n, dtype=np.int32)
    ret = lib.jxl_apply_lehmer(
        _ptr(code_arr, ctypes.c_uint32),
        ctypes.c_int64(len(code_arr)),
        ctypes.c_int64(n),
        _ptr(out, ctypes.c_int32),
    )
    if ret != 0:
        raise InvalidPermutation("invalid Lehmer code value")
    return out


def squeeze_chain_raw(recs) -> None:
    """One jxl_squeeze_chain call over (n, 11) int64 records, each an
    inverse squeeze step (horizontal flag, then the average channel's,
    the residual channel's and the output's absolute address and
    geometry), applied in order: the whole-animation fold runs every
    frame's inverse squeezes through it (render/anim_fold.py; the
    counterpart of jxl_tpu/native/__init__.py:squeeze_chain_raw, which
    returns False when its library is missing, where this one raises
    NativeBuildError as every binding here does). The caller keeps the
    buffers alive for the call."""
    lib = get_lib()
    recs = np.ascontiguousarray(recs, dtype=np.int64)
    if recs.ndim != 2 or recs.shape[1] != 11:
        raise ValueError(f"squeeze records are (n, 11), not {recs.shape}")
    lib.jxl_squeeze_chain(len(recs), recs.ctypes.data)


def rct_native(ins, outs, op: int, perm: int) -> bool:
    """Fused in-place-safe RCT over three int32 planes (hostops.cc jxl_rct;
    ref transforms/rct.rs:18-50). ins/outs: 3 (h, w) int32 arrays (views
    OK; outs may alias ins). Returns False when native is unavailable."""
    lib = get_lib()
    h, w = ins[0].shape
    args = []
    for a in (*ins, *outs):
        assert a.dtype == np.int32 and a.strides[1] == 4, (a.dtype, a.strides)
        args.append(_ptr(a, ctypes.c_int32))
        args.append(ctypes.c_int64(a.strides[0] // 4))
    lib.jxl_rct(*args, ctypes.c_int64(w), ctypes.c_int64(h),
                ctypes.c_int(op), ctypes.c_int(perm))
    return True


def decode_lf_group_vardct_native(
    br, tree, group, num_lf_groups, ox, oy, w, h, bw, hshift3, vshift3,
    is444, lf_factors3, ytox_lf, ytob_lf, num_lf_contexts, lf_thr, n_lf_thr,
    lf_planes, qlfmap, ytox_map, ytob_map, tmap, rqmap, epf_map, cbx, cby,
    invalid_transform,
):
    """VarDCT LF-group decode in one native call: LF modular substream +
    dequant + CfL at LF + quant-lf bucketing + HF metadata substream +
    transform placement (ref frame/modular/mod.rs:939-1089).

    Returns True on success (br.pos advanced, planes/maps written),
    False when the stream needs the Python path (local tree / local
    transforms); raises typed errors on invalid streams."""
    lib = get_lib()
    from ..errors import InvalidBitstream, InvalidEpfValue, NativeDecodeError

    ent = pack_entropy(tree.histograms)
    tree_arr = getattr(tree, "_native_packed", None)
    if tree_arr is None:
        tree_arr = pack_tree(tree)
        try:
            tree._native_packed = tree_arr
        except AttributeError:
            pass
    data = _databuf(br)
    bit_pos = ctypes.c_uint64(br.pos)
    ret = lib.jxl_decode_lf_group_vardct(
        data, ctypes.c_uint64(len(data)), ctypes.byref(bit_pos),
        ctypes.c_int(ent["use_prefix"]),
        _ptr(ent["ans_tables"], ctypes.c_int32), ctypes.c_int(ent["table_size"]),
        ctypes.c_int(ent["log_bucket"]),
        _ptr(ent["huff_offsets"], ctypes.c_int32),
        _ptr(ent["huff_bits"], ctypes.c_int32),
        _ptr(ent["huff_values"], ctypes.c_int32),
        _ptr(ent["context_map"], ctypes.c_uint8),
        ctypes.c_int(len(ent["context_map"])),
        _ptr(ent["uint_configs"], ctypes.c_int32),
        ctypes.c_int(ent["lz77"]), ctypes.c_uint32(ent["min_symbol"]),
        ctypes.c_uint32(ent["min_length"]), _ptr(ent["lz_cfg"], ctypes.c_int32),
        ctypes.c_int(ent["lz_dist_cluster"]),
        _ptr(tree_arr, ctypes.c_int32), ctypes.c_int(len(tree_arr)),
        ctypes.c_int(tree.num_properties),
        ctypes.c_int(group), ctypes.c_int(num_lf_groups),
        ctypes.c_int(ox), ctypes.c_int(oy), ctypes.c_int(w), ctypes.c_int(h),
        ctypes.c_int(bw),
        _ptr(hshift3, ctypes.c_int32), _ptr(vshift3, ctypes.c_int32),
        ctypes.c_int(is444),
        _ptr(lf_factors3, ctypes.c_double),
        ctypes.c_float(ytox_lf), ctypes.c_float(ytob_lf),
        ctypes.c_int(num_lf_contexts),
        _ptr(lf_thr, ctypes.c_int32), _ptr(n_lf_thr, ctypes.c_int32),
        lf_planes[0].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lf_planes[1].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lf_planes[2].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        qlfmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ytox_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ytob_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(ytox_map.shape[1]),
        tmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rqmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        epf_map.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _ptr(cbx, ctypes.c_int32), _ptr(cby, ctypes.c_int32),
        ctypes.c_int(invalid_transform),
    )
    if ret == 8:
        return False  # local tree/transforms: Python path
    if ret == 10:
        raise InvalidEpfValue("invalid EPF value")
    if ret in (4, 5, 6, 7):
        from ..vardct.lf import _PLACE_ERRORS

        raise InvalidBitstream(_PLACE_ERRORS.get(ret, f"placement failed ({ret})"))
    if ret != 0:
        raise NativeDecodeError(f"native lf-group decode failed (code {ret})")
    br.pos = bit_pos.value
    return True


def decode_hf_groups_native(
    readers, group_ids, slots, bw, bh, gxc, gdim_blocks, hshift3, vshift3,
    tmap, rqmap, qlfmap, bctx_cmap, num_bctx, num_lf_contexts, qf_thr,
    num_ac_contexts, num_histograms, cbx, cby, shape_lut, ent, orders,
    order_off, shift, coeff_pool, chan_stride, blocks_out=None,
    blk_counts=None,
):
    """Whole-frame single-pass VarDCT AC decode: one native call loops the
    HF group sections (histogram selector, per-block item build from the
    transform/raw-quant/quant-lf maps, shared AC loop, final-state check).
    With blocks_out/blk_counts ((n, gdim^2, 4) int32 and (n,) int32), the
    per-group block tables [gbx, gby, tid, coeff_off] are exported for the
    render passes.

    Returns the list of final bit positions per reader; raises typed
    errors on bad streams."""
    lib = get_lib()
    from ..errors import (
        InvalidBitstream,
        InvalidHistogramIndex,
        InvalidNumNonZeros,
        NativeDecodeError,
    )

    n = len(readers)
    ptrs = (ctypes.c_void_p * n)()
    sizes = (ctypes.c_uint64 * n)()
    poss = (ctypes.c_uint64 * n)()
    keep = []
    for i, br in enumerate(readers):
        buf = _databuf(br)
        keep.append(buf)
        if isinstance(buf, bytes):
            ptrs[i] = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)
        else:
            ptrs[i] = ctypes.cast(buf, ctypes.c_void_p)
        sizes[i] = len(buf)
        poss[i] = br.pos
    gids = np.ascontiguousarray(group_ids, dtype=np.int32)
    slots_arr = np.ascontiguousarray(slots, dtype=np.int32)
    ret = lib.jxl_decode_hf_groups(
        ptrs, sizes, poss, ctypes.c_int(n), _ptr(gids, ctypes.c_int32),
        ctypes.c_int(bw), ctypes.c_int(bh), ctypes.c_int(gxc),
        ctypes.c_int(gdim_blocks),
        _ptr(hshift3, ctypes.c_int32), _ptr(vshift3, ctypes.c_int32),
        _ptr(tmap, ctypes.c_uint8), _ptr(rqmap, ctypes.c_int32),
        _ptr(qlfmap, ctypes.c_uint8),
        _ptr(bctx_cmap, ctypes.c_uint8), ctypes.c_int(num_bctx),
        ctypes.c_int(num_lf_contexts),
        _ptr(qf_thr, ctypes.c_int32), ctypes.c_int(len(qf_thr)),
        ctypes.c_int(num_ac_contexts), ctypes.c_int(num_histograms),
        _ptr(cbx, ctypes.c_int32), _ptr(cby, ctypes.c_int32),
        _ptr(shape_lut, ctypes.c_int32),
        ctypes.c_int(ent["use_prefix"]),
        _ptr(ent["ans_tables"], ctypes.c_int32), ctypes.c_int(ent["table_size"]),
        ctypes.c_int(ent["log_bucket"]),
        _ptr(ent["huff_offsets"], ctypes.c_int32),
        _ptr(ent["huff_bits"], ctypes.c_int32),
        _ptr(ent["huff_values"], ctypes.c_int32),
        _ptr(ent["context_map"], ctypes.c_uint8),
        ctypes.c_int(len(ent["context_map"])),
        _ptr(ent["uint_configs"], ctypes.c_int32),
        ctypes.c_int(ent["lz77"]), ctypes.c_uint32(ent["min_symbol"]),
        ctypes.c_uint32(ent["min_length"]), _ptr(ent["lz_cfg"], ctypes.c_int32),
        ctypes.c_int(ent["lz_dist_cluster"]),
        _ptr(orders, ctypes.c_int32), _ptr(order_off, ctypes.c_int32),
        ctypes.c_int(shift),
        _ptr(coeff_pool, ctypes.c_int32),
        _ptr(slots_arr, ctypes.c_int32), ctypes.c_int64(chan_stride),
        _ptr(blocks_out, ctypes.c_int32) if blocks_out is not None else None,
        _ptr(blk_counts, ctypes.c_int32) if blk_counts is not None else None,
    )
    if ret == 4:
        raise InvalidHistogramIndex("invalid histogram index")
    if ret == 3:
        raise InvalidNumNonZeros("invalid number of nonzeros")
    if ret != 0:
        raise NativeDecodeError(f"native hf-groups decode failed (code {ret})")
    return [int(poss[i]) for i in range(n)]


def lane_items_native(tmap, rqmap, qlfmap, gxc, num_groups, gdim_blocks, hshift3, vshift3,
                      bctx_cmap, num_lf_contexts, qf_thr, cbx, cby, shape_lut, key_lut,
                      chan_stride, n_items, items=None) -> int:
    """The lane AC decoder's item table of a whole frame, in one pass over
    its (bh, bw) transform, raw-quant and quant-LF maps (modular_decode.cc
    jxl_lane_items): rows [c, sbx, sby, num_blocks, num_coeffs, bctx,
    key_lut[shape * 3 + c], c * chan_stride + coefficient offset, cx, cy]
    in token order. Without `items` the call counts each group's rows into
    `n_items`, (num_groups,) int32; with `items`, a (num_groups, i_max, 10)
    int32 array, it writes group g's rows into items[g, :n_items[g]] and
    zeros the rest. Returns the largest row count; raises ValueError on
    arrays it cannot take, NativeDecodeError on a transform id or a block
    context index past its table."""
    from ..errors import NativeDecodeError

    bh, bw = tmap.shape
    arrays = [("tmap", tmap, np.uint8, (bh, bw)), ("rqmap", rqmap, np.int32, (bh, bw)),
              ("qlfmap", qlfmap, np.uint8, (bh, bw)), ("hshift3", hshift3, np.int32, (3,)),
              ("vshift3", vshift3, np.int32, (3,)), ("bctx_cmap", bctx_cmap, np.int32, None),
              ("qf_thr", qf_thr, np.int32, None), ("cbx", cbx, np.int32, None),
              ("cby", cby, np.int32, cbx.shape), ("shape_lut", shape_lut, np.int32, cbx.shape),
              ("key_lut", key_lut, np.int32, None), ("n_items", n_items, np.int32, (num_groups,))]
    if items is not None:
        arrays.append(("items", items, np.int32, (num_groups, items.shape[1], 10)))
    for name, a, dtype, shape in arrays:
        if a.dtype != dtype or not a.flags.c_contiguous or (shape is not None and a.shape != shape):
            raise ValueError(f"{name} must be a C-contiguous {np.dtype(dtype).name} array"
                             + (f" of shape {shape}" if shape is not None else ""))
    if len(key_lut) < 13 * 3 or int(shape_lut.max(initial=0)) >= 13:
        raise ValueError("key_lut must cover the 13 block shapes' 3 channels")
    ret = get_lib().jxl_lane_items(
        bw, bh, gxc, num_groups, gdim_blocks, _ptr(hshift3, ctypes.c_int32),
        _ptr(vshift3, ctypes.c_int32), _ptr(tmap, ctypes.c_uint8), _ptr(rqmap, ctypes.c_int32),
        _ptr(qlfmap, ctypes.c_uint8), _ptr(bctx_cmap, ctypes.c_int32), len(bctx_cmap),
        num_lf_contexts, _ptr(qf_thr, ctypes.c_int32), len(qf_thr), _ptr(cbx, ctypes.c_int32),
        _ptr(cby, ctypes.c_int32), _ptr(shape_lut, ctypes.c_int32), len(cbx),
        _ptr(key_lut, ctypes.c_int32), chan_stride, _ptr(n_items, ctypes.c_int32),
        None if items is None else _ptr(items, ctypes.c_int32),
        0 if items is None else items.shape[1],
    )
    if ret == -1:
        raise ValueError("a group holds more item rows than items has room for")
    if ret < 0:
        raise NativeDecodeError("a transform id or block context index lies past its table")
    return ret


def block_tables_native(tmap, group_ids, num_groups, gxc, gdim_blocks, hshift3, vshift3,
                       block_coeffs, group_stride, layout, by0=0, bx0=0, W=0):
    """The render's block tables in one pass over the (bh, bw) uint8
    transform map (modular_decode.cc jxl_block_tables): the blocks placed
    in the groups `group_ids` ((n,) int32, each below num_groups; slot i
    holds group group_ids[i]), gxc groups across of gdim_blocks blocks a
    side. Returns (counts, out): counts (4, 27) int64, row 0 the blocks
    of each transform type, row 1 + c those aligned to channel c's grid
    (hshift3, vshift3: (3,) int32); out the 1-D int64 tables in `layout`
    0 (placed blocks), 1 (4:4:4 columns a type) or 2 (subsampled jobs),
    as the C++ lays them out. block_coeffs: (27,) int64 coefficients a
    type. Raises ValueError on arrays it cannot take and on a negative
    layout-1 column, NativeDecodeError on a transform id past the 27."""
    from ..errors import NativeDecodeError

    arrays = [("tmap", tmap, np.uint8, None), ("group_ids", group_ids, np.int32, None),
              ("hshift3", hshift3, np.int32, (3,)), ("vshift3", vshift3, np.int32, (3,)),
              ("block_coeffs", block_coeffs, np.int64, (27,))]
    for name, a, dtype, shape in arrays:
        if (not isinstance(a, np.ndarray) or a.dtype != dtype or not a.flags.c_contiguous
                or (shape is not None and a.shape != shape)):
            raise ValueError(f"{name} must be a C-contiguous {np.dtype(dtype).name} array"
                             + (f" of shape {shape}" if shape is not None else ""))
    if tmap.ndim != 2:
        raise ValueError(f"tmap must be (bh, bw), got {tmap.shape}")
    if group_ids.ndim != 1 or (group_ids.size and (
            int(group_ids.min()) < 0 or int(group_ids.max()) >= num_groups)):
        raise ValueError(f"group_ids must be a list of groups below {num_groups}")
    if layout not in (0, 1, 2) or gxc <= 0 or gdim_blocks <= 0:
        raise ValueError(f"bad layout {layout}, gxc {gxc} or gdim_blocks {gdim_blocks}")
    # a group's first block lies on every channel's grid
    if any(not 0 <= int(s) <= 3 or gdim_blocks % (1 << int(s)) for s in (*hshift3, *vshift3)):
        raise ValueError(f"shifts {hshift3} {vshift3} must lie in 0..3 and divide the group")
    bh, bw = tmap.shape
    lib = get_lib()
    counts = np.empty((4, 27), np.int64)
    args = [bw, bh, _ptr(tmap, ctypes.c_uint8), _ptr(group_ids, ctypes.c_int32),
            len(group_ids), num_groups, gxc, gdim_blocks, by0, bx0, W,
            _ptr(hshift3, ctypes.c_int32), _ptr(vshift3, ctypes.c_int32),
            _ptr(block_coeffs, ctypes.c_int64), group_stride, layout,
            _ptr(counts, ctypes.c_int64)]
    ret = lib.jxl_block_tables(*args, None)
    if ret == 0:
        blocks = int(counts[1:].sum() if layout == 2 else counts[0].sum())
        out = np.empty((5 if layout == 0 else 4) * blocks, np.int64)
        ret = lib.jxl_block_tables(*args, _ptr(out, ctypes.c_int64))
    if ret == -1:
        raise ValueError("a block column is negative")
    if ret < 0:
        raise NativeDecodeError("a transform id lies past the 27")
    return counts, out


def decode_vardct_ac_native(br, ent, items, orders, coeffs, shift, num_bctx, nzeros_maps,
                            nz_dims) -> None:
    """One pass of one group's VarDCT AC (modular_decode.cc
    jxl_decode_vardct_ac): the tokens of `items`, (n, 11) int32 rows [c,
    sbx, sby, num_blocks, num_coeffs, bctx, context offset, order offset,
    coefficient offset, cx, cy], decoded with the packed entropy `ent`
    into the int32 buffer `coeffs` (offsets absolute into it), then the
    ANS final-state check. nzeros_maps/nz_dims: the per-channel nonzeros
    grids, (w, h, offset) a channel. Leaves br at the bit after the AC;
    raises typed errors on bad streams."""
    from ..errors import InvalidNumNonZeros, NativeDecodeError

    for name, a in (("items", items), ("orders", orders), ("coeffs", coeffs),
                    ("nzeros_maps", nzeros_maps), ("nz_dims", nz_dims)):
        if a.dtype != np.int32 or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be a C-contiguous int32 array")
    if items.ndim != 2 or items.shape[1] != 11 or nz_dims.shape != (3, 3):
        raise ValueError("items must be (n, 11) and nz_dims (3, 3)")
    if len(items) and int((items[:, 8] + items[:, 4]).max()) > coeffs.size:
        raise ValueError("an item's coefficients lie past the coefficient buffer")
    lib = get_lib()
    bit_pos = ctypes.c_uint64(br.pos)
    ret = lib.jxl_decode_vardct_ac(
        _databuf(br), ctypes.c_uint64(len(br.data)), ctypes.byref(bit_pos),
        ctypes.c_int(ent["use_prefix"]),
        _ptr(ent["ans_tables"], ctypes.c_int32),
        ctypes.c_int(ent["table_size"]), ctypes.c_int(ent["log_bucket"]),
        _ptr(ent["huff_offsets"], ctypes.c_int32),
        _ptr(ent["huff_bits"], ctypes.c_int32),
        _ptr(ent["huff_values"], ctypes.c_int32),
        _ptr(ent["context_map"], ctypes.c_uint8),
        ctypes.c_int(len(ent["context_map"])),
        _ptr(ent["uint_configs"], ctypes.c_int32),
        ctypes.c_int(ent["lz77"]), ctypes.c_uint32(ent["min_symbol"]),
        ctypes.c_uint32(ent["min_length"]), _ptr(ent["lz_cfg"], ctypes.c_int32),
        ctypes.c_int(ent["lz_dist_cluster"]), ctypes.c_uint32(0),
        ctypes.c_int(len(items)), _ptr(items, ctypes.c_int32),
        _ptr(orders, ctypes.c_int32), _ptr(coeffs, ctypes.c_int32),
        ctypes.c_int(shift), ctypes.c_int(num_bctx),
        _ptr(nzeros_maps, ctypes.c_int32), _ptr(nz_dims, ctypes.c_int32),
    )
    if ret == 3:
        raise InvalidNumNonZeros("invalid number of nonzeros")
    if ret != 0:
        raise NativeDecodeError(f"native vardct AC decode failed (code {ret})")
    br.pos = bit_pos.value


def noise_field_native(field, up, group_dim, gx_count, gy_count, vfi, nfi) -> None:
    """Fill field, a C-contiguous (3, hu, wu) float32 array, with the
    per-group xorshift128+ noise field in place (filters.cc
    jxl_noise_field)."""
    if field.dtype != np.float32 or field.ndim != 3 or field.shape[0] != 3:
        raise ValueError("noise field must be (3, hu, wu) float32")
    if not field.flags.c_contiguous:
        raise ValueError("noise field must be C-contiguous")
    lib = get_lib()
    _, hu, wu = field.shape
    lib.jxl_noise_field(
        _ptr(field[0], ctypes.c_float), _ptr(field[1], ctypes.c_float),
        _ptr(field[2], ctypes.c_float),
        ctypes.c_int64(hu), ctypes.c_int64(wu),
        ctypes.c_int(int(up)), ctypes.c_int(int(group_dim)),
        ctypes.c_int(int(gx_count)), ctypes.c_int(int(gy_count)),
        ctypes.c_uint32(int(vfi)), ctypes.c_uint32(int(nfi)),
    )


def noise_field_rows_native(field, hu, wu, up, group_dim, gx_count, gy_count, vfi, nfi,
                            y_lo, y_hi) -> None:
    """Fill field, a C-contiguous (3, y_hi - y_lo, wu) float32 array, with
    rows [y_lo, y_hi) of the (3, hu, wu) per-group xorshift128+ noise field
    (filters.cc jxl_noise_field_rows): bit for bit the same rows of the
    field noise_field_native makes."""
    if field.dtype != np.float32 or field.shape != (3, y_hi - y_lo, wu):
        raise ValueError(f"noise rows must be (3, {y_hi - y_lo}, {wu}) float32")
    if not field.flags.c_contiguous:
        raise ValueError("noise rows must be C-contiguous")
    if not 0 <= y_lo <= y_hi <= hu:
        raise ValueError(f"rows [{y_lo}, {y_hi}) outside the field's {hu}")
    get_lib().jxl_noise_field_rows(
        _ptr(field[0], ctypes.c_float), _ptr(field[1], ctypes.c_float),
        _ptr(field[2], ctypes.c_float),
        ctypes.c_int64(hu), ctypes.c_int64(wu),
        ctypes.c_int(int(up)), ctypes.c_int(int(group_dim)),
        ctypes.c_int(int(gx_count)), ctypes.c_int(int(gy_count)),
        ctypes.c_uint32(int(vfi)), ctypes.c_uint32(int(nfi)),
        ctypes.c_int64(int(y_lo)), ctypes.c_int64(int(y_hi)),
    )


def decode_icc_native(histograms, br, length: int) -> bytes:
    """The `length` coded bytes of an embedded ICC profile (modular_decode.cc
    jxl_decode_icc; each byte's context from the two before it, as
    icc/decode.py:_icc_context gives it). Leaves br at the bit after them;
    raises InvalidIccStream on a symbol past 255, OutOfBounds on a
    truncated stream and InvalidBitstream on any other fault."""
    from ..errors import InvalidBitstream, InvalidIccStream, OutOfBounds

    lib = get_lib()
    ent = pack_entropy(histograms)
    out = np.zeros(max(length, 1), dtype=np.uint8)
    bit_pos = ctypes.c_uint64(br.pos)
    ret = lib.jxl_decode_icc(
        _databuf(br), ctypes.c_uint64(len(br.data)), ctypes.byref(bit_pos),
        *_entropy_args(ent), ctypes.c_int64(length), _ptr(out, ctypes.c_uint8),
    )
    if ret == 3:
        raise InvalidIccStream("invalid ICC stream symbol")
    if ret == 2:
        raise OutOfBounds(1)
    if ret != 0:
        raise InvalidBitstream("ICC entropy stream decode failed")
    br.pos = bit_pos.value
    return out.tobytes()[:length]


def spline_splat_native(planes, table) -> None:
    """Add the spline segments of `table`, the (S, 8) float32 draw cache of
    features/splines.py (centre x, y, maximum distance, 1/sigma, intensity
    term, colour X, Y, B), onto three (h, w) float32 planes in place
    (modular_decode.cc jxl_spline_splat): each segment's box, rounded to
    even from its float32 bounds and clipped to the planes."""
    if table.dtype != np.float32 or table.ndim != 2 or table.shape[1] != 8:
        raise ValueError("the segment table must be (S, 8) float32")
    table = np.ascontiguousarray(table)
    h, w = planes[0].shape
    for p in planes[:3]:
        if p.dtype != np.float32 or p.shape != (h, w) or not p.flags.c_contiguous:
            raise ValueError("planes must be three C-contiguous (h, w) float32 arrays")
    lib = get_lib()
    lib.jxl_spline_splat(
        _ptr(planes[0], ctypes.c_float), _ptr(planes[1], ctypes.c_float),
        _ptr(planes[2], ctypes.c_float),
        ctypes.c_int64(h), ctypes.c_int64(w), ctypes.c_int64(w),
        _ptr(table, ctypes.c_float), ctypes.c_int64(len(table)),
    )


def gradient_reconstruct(arr: np.ndarray) -> None:
    """In-place clamped-gradient reconstruction of a channel of raw
    residuals (modular_decode.cc jxl_gradient_reconstruct): row 0 a West
    chain, column 0 a North chain, every other sample the clamped gradient
    of its left, top and top-left neighbours plus its residual. The host
    lane of modular/device_lossless.py for a channel over its overflow
    gate, and the plain host version its tests hold the lanes against.
    `arr` is an int32 (h, w) array whose rows are contiguous (a view of a
    larger plane is fine)."""
    if arr.dtype != np.int32 or arr.ndim != 2 or (arr.shape[1] > 1 and arr.strides[1] != 4):
        raise ValueError("gradient_reconstruct takes an int32 (h, w) array with contiguous rows")
    h, w = arr.shape
    if h == 0 or w == 0:
        return
    if arr.strides[0] % 4:
        raise ValueError("row stride must be a whole number of int32 samples")
    get_lib().jxl_gradient_reconstruct(
        _ptr(arr, ctypes.c_int32), ctypes.c_int64(h), ctypes.c_int64(w),
        ctypes.c_int64(arr.strides[0] // 4),
    )


def fold_span_hit(prev: bytes, prev_key: int, cur: bytes, cur_key: int) -> bool:
    """The animation fold's span-cache decision (modular_decode.cc
    FoldSpanHit through jxl_fold_span_hit) on two equal-length spans: true
    when a frame whose table-section bits are `cur`, decoded under
    `cur_key` (HfGlobal's block-context count), may reuse the decode of
    `prev` under `prev_key`."""
    if len(prev) != len(cur):
        raise ValueError("fold_span_hit compares spans of one length")
    a = np.frombuffer(bytes(prev) or b"\0", np.uint8)
    b = np.frombuffer(bytes(cur) or b"\0", np.uint8)
    fn = get_lib().jxl_fold_span_hit
    fn.restype = ctypes.c_int
    return bool(fn(_ptr(a, ctypes.c_uint8), ctypes.c_int(prev_key), _ptr(b, ctypes.c_uint8),
                   ctypes.c_int(cur_key), ctypes.c_uint64(len(prev))))


def anim_decode_frames_native(
    br, sec_bit_pos, sec_byte_end, bw, bh, tcw, tch, fbw, fbh, hshift3,
    vshift3, is444, smooth_flags, chan_counts, chan_tmpl_off, chan_template,
    chan_frame_elems, tree_size_limit, def_bctx_cmap, invalid_transform,
    has_modular: bool, span_cache: bool = True,
):
    """The whole-animation fold (modular_decode.cc jxl_anim_decode_frames;
    the counterpart of jxl_tpu/native/__init__.py:anim_decode_frames_native):
    every frame's LfGlobal tables, global Modular group header (none when
    has_modular is false: the global image has no channels), section-0
    channels, LF group with its HF metadata (and the adaptive LF smoothing),
    HfGlobal and its one HF group's AC, for F single-section frames, in one
    native call. Returns a dict of (F, ...) arrays ("scal", "dbl", "gh",
    "lf" (3, F, bh, bw), "qlf", "tmap", "rq", "epf", "ytox", "ytob",
    "hfinfo", "pool" (F, 3, 65536) int32 coefficients, "blocks" (F, 1024,
    4) [bx, by, tid, offset], "blk_counts", "chan"), or None when a frame's
    stream is of a shape the fold does not take (then trace counts
    "anim_fold_fallback"). Every array is allocated here, for this call:
    nothing is shared between calls or threads. span_cache=False decodes
    every frame's table sections in full (the caches' test reference).
    Ref: frame/decode.rs:314-583, frame/group.rs:384-618."""
    from ..utils import trace
    from ..vardct.group import _CBX_ARR, _CBY_ARR, _SHAPE_ARR

    lib = get_lib()
    F = len(sec_bit_pos)
    nat, nat_off = _natural_orders_concat()
    out = {
        "scal": np.zeros((F, 24), np.int32),
        "dbl": np.zeros((F, 8), np.float64),
        "lfthr": np.zeros((F, 48), np.int32),
        "qfthr": np.zeros((F, 16), np.int32),
        "bctxmap": np.zeros((F, 2496), np.uint8),
        "gh": np.zeros((F, 96), np.int32),
        "lf": np.zeros((3, F, bh, bw), np.float32),
        "qlf": np.zeros((F, bh, bw), np.uint8),
        "tmap": np.full((F, bh, bw), invalid_transform, np.uint8),
        "rq": np.zeros((F, bh, bw), np.int32),
        "epf": np.zeros((F, bh, bw), np.uint8),
        "ytox": np.zeros((F, tch, tcw), np.int8),
        "ytob": np.zeros((F, tch, tcw), np.int8),
        "hfinfo": np.zeros((F, 2), np.int32),
        "pool": np.zeros((F, 3, 65536), np.int32),
        "blocks": np.zeros((F, 1024, 4), np.int32),
        "blk_counts": np.zeros(F, np.int32),
        "chan": np.zeros((F, max(chan_frame_elems, 1)), np.int32),
    }
    err = np.full(2, -2, np.int32)
    stage_ns = np.zeros(8, np.int64)
    data = _databuf(br)

    def i32(a):
        return _ptr(np.ascontiguousarray(a, dtype=np.int32), ctypes.c_int32)

    ret = lib.jxl_anim_decode_frames(
        data, ctypes.c_uint64(len(data)), ctypes.c_int(F),
        _ptr(np.ascontiguousarray(sec_bit_pos, dtype=np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(sec_byte_end, dtype=np.uint64), ctypes.c_uint64),
        ctypes.c_int(bw), ctypes.c_int(bh), ctypes.c_int(tcw), ctypes.c_int(tch),
        i32(fbw), i32(fbh), i32(hshift3), i32(vshift3), ctypes.c_int(is444),
        _ptr(np.ascontiguousarray(smooth_flags, dtype=np.uint8), ctypes.c_uint8),
        i32(chan_counts),
        _ptr(np.ascontiguousarray(chan_tmpl_off, dtype=np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(chan_template, dtype=np.int64), ctypes.c_int64),
        ctypes.c_int64(chan_frame_elems), _ptr(out["chan"], ctypes.c_int32),
        ctypes.c_int64(tree_size_limit),
        _ptr(nat, ctypes.c_int32), _ptr(nat_off, ctypes.c_int32),
        _ptr(_CBX_ARR, ctypes.c_int32), _ptr(_CBY_ARR, ctypes.c_int32),
        _ptr(_SHAPE_ARR, ctypes.c_int32),
        ctypes.c_int(invalid_transform),
        _ptr(np.ascontiguousarray(def_bctx_cmap, dtype=np.uint8), ctypes.c_uint8),
        ctypes.c_int(15), ctypes.c_int(int(has_modular)), ctypes.c_int(int(span_cache)),
        _ptr(out["scal"], ctypes.c_int32), _ptr(out["dbl"], ctypes.c_double),
        _ptr(out["lfthr"], ctypes.c_int32), _ptr(out["qfthr"], ctypes.c_int32),
        _ptr(out["bctxmap"], ctypes.c_uint8), _ptr(out["gh"], ctypes.c_int32),
        _ptr(out["lf"], ctypes.c_float), _ptr(out["qlf"], ctypes.c_uint8),
        _ptr(out["tmap"], ctypes.c_uint8), _ptr(out["rq"], ctypes.c_int32),
        _ptr(out["epf"], ctypes.c_uint8),
        _ptr(out["ytox"], ctypes.c_int8), _ptr(out["ytob"], ctypes.c_int8),
        _ptr(out["hfinfo"], ctypes.c_int32), _ptr(out["pool"], ctypes.c_int32),
        _ptr(out["blocks"], ctypes.c_int32), _ptr(out["blk_counts"], ctypes.c_int32),
        _ptr(err, ctypes.c_int32), _ptr(stage_ns, ctypes.c_int64),
    )
    if ret != 0:
        trace.metrics.add("anim_fold_fallback", 1)
        return None
    trace.metrics.add("anim_fold_span_hits", int(stage_ns[6]))
    return out


# -- the host render route's C++ (filters.cc, colors.cc, hostops.cc and
# jxl_dct8_fused / jxl_dither_u8 / jxl_scatter_blocks of modular_decode.cc)
#
# Counterparts of jxl_tpu/native/__init__.py:1134-1680, bit for bit on the
# same arrays: the sources are the same and so are their g++ flags. Each
# wrapper takes numpy arrays or CPU tensors (through .numpy(), no copy);
# one that declines a layout returns None (or False), and the caller then
# runs the plain torch stage on the host. A CUDA tensor raises.

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F = ctypes.c_float

_HOST_ROUTE_SIGNATURES = {
    "jxl_filter_chain_strided": (None, [_P] * 3 + [_INT, _INT, _I64, _P, _INT, _P, _INT, _P]
                                 + [_F] * 3),
    "jxl_filter_chain_multi": (None, [_P] * 3 + [_INT, _P, _P, _P, _I64, _P, _P, _P, _INT, _P]
                               + [_F] * 3),
    "jxl_xyb_srgb_u8": (None, [_P] * 4 + [_I64, _I64, _P, _P, _F, _P, _INT, _F, _P]),
    "jxl_xyb_tf_f32": (None, [_P] * 3 + [_I64, _I64, _P, _P, _F, _INT, _F]),
    "jxl_dequant_cfl": (None, [_P] * 4 + [_I64, _INT] + [_P] * 6),
    "jxl_dct8_fused": (_INT, [_P] * 4 + [_I64] + [_P] * 10 + [_I64, _P, _P, _P, _I64]),
    "jxl_dither_u8": (None, [_P, _I64, _I64, _I64, _P, _INT, _INT, _F, _P, _I64, _I64]),
    "jxl_scatter_blocks": (None, [_P, _I64, _P, _I64, _I64, _I64, _P, _P]),
    "jxl_interleave_f32": (None, [_P, _P, _INT, _I64, _I64, _P]),
    "jxl_interleave_u8": (None, [_P, _P, _INT, _I64, _I64, _P]),
    "jxl_interleave_u16": (None, [_P, _P, _INT, _I64, _I64, _P]),
    "jxl_i32_to_f32_scaled": (None, [_P, _I64, _I64, _I64, _F, _P, _I64]),
    "jxl_i32_scaled_interleave": (None, [_P, _P, _INT, _I64, _I64, _F, _P]),
}


def _bind_host_route(lib) -> None:
    for name, (res, args) in _HOST_ROUTE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _host(a):
    """`a` as a numpy array: a CPU tensor's own memory (no copy), a numpy
    array as it is. A CUDA tensor raises: these run on the host."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"the host route's C++ takes host arrays, not a {a.device} tensor")
        return a.detach().numpy()
    return a


def filter_chain_native(planes, inv_sigma_px, gab_weights, epf_iters, rf,
                        sigma_is_block=False, in_place=False):
    """Gaborish + EPF over three (h, w) float32 planes (filters.cc
    jxl_filter_chain_strided; jxl_tpu/native/__init__.py:1294).

    inv_sigma_px: the (h, w) stored 1/sigma, or with sigma_is_block the
    (ceil(h/8), ceil(w/8)) per-block values, expanded in the kernel (None
    without EPF); gab_weights: [w1, w2] a channel (6 values) or None;
    epf_iters: 0-3 (step 0 iff >= 3, step 1 iff >= 1, step 2 iff >= 2);
    rf: the restoration filter's channel scales and sigma multipliers.
    With in_place the planes (row views on one stride are fine) are
    filtered where they lie and returned; else contiguous copies are
    filtered and returned. Returns None for planes under 8x8 (the mirror
    needs 3 samples each side) or, in place, for planes that are not
    writable float32 rows on one stride. Semantics: render/stages/core.py
    gaborish and epf_step_px at (0, 0)."""
    planes = [_host(p) for p in planes]
    h, w = planes[0].shape
    if h < 8 or w < 8:
        return None
    if in_place:
        stride = planes[0].strides[0] // 4
        if any(not isinstance(p, np.ndarray) or p.dtype != np.float32 or p.strides[1] != 4
               or p.strides[0] != stride * 4 or not p.flags.writeable or p.shape != (h, w)
               for p in planes):
            return None
        ps = list(planes)
    else:
        stride = w
        ps = []
        for p in planes:
            q = np.ascontiguousarray(p, dtype=np.float32)
            ps.append(p.copy() if q is p else q)
    sigp = None
    if inv_sigma_px is not None:
        sig = _host(inv_sigma_px)
        if sigma_is_block:
            sig = sig[: -(-h // 8), : -(-w // 8)]
        sig = np.ascontiguousarray(sig, dtype=np.float32)
        sigp = _ptr(sig, ctypes.c_float)
    gwp = None
    if gab_weights is not None:
        gwp = _ptr(np.asarray(gab_weights, dtype=np.float32).reshape(6), ctypes.c_float)
    cs = np.asarray(rf.epf_channel_scale, dtype=np.float32)
    get_lib().jxl_filter_chain_strided(
        _ptr(ps[0], ctypes.c_float), _ptr(ps[1], ctypes.c_float), _ptr(ps[2], ctypes.c_float),
        h, w, stride, sigp, int(bool(sigma_is_block)), gwp, int(epf_iters),
        _ptr(cs, ctypes.c_float), float(rf.epf_pass0_sigma_scale),
        float(rf.epf_pass2_sigma_scale), float(rf.epf_border_sad_mul),
    )
    return ps


def filter_chain_multi_native(stacked, offsets, hs, ws, stride, sigma_flat, sigma_offs,
                              gab_weights, epf_iters, rf) -> bool:
    """filter_chain_native once a frame over a stacked animation, in place
    (filters.cc jxl_filter_chain_multi; jxl_tpu/native/__init__.py:1368):
    stacked is (3, ...) C-contiguous float32, frame i's planes start at
    element offsets[i] of each channel and are (hs[i], ws[i]) on row
    stride `stride`; sigma_flat holds each frame's raveled (ceil(h/8),
    ceil(w/8)) 1/sigma from sigma_offs[i] (None without EPF). Returns
    False when the stack is not C-contiguous float32 or a frame is under
    8x8."""
    stacked = _host(stacked)
    if (stacked.dtype != np.float32 or not stacked.flags.c_contiguous
            or not stacked.flags.writeable):
        return False
    n = len(offsets)
    if n == 0:
        return True
    hs_a = np.ascontiguousarray(hs, dtype=np.int32)
    ws_a = np.ascontiguousarray(ws, dtype=np.int32)
    if int(hs_a.min()) < 8 or int(ws_a.min()) < 8:
        return False
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    sigp = soffp = None
    if sigma_flat is not None:
        sigp = _ptr(np.ascontiguousarray(_host(sigma_flat), dtype=np.float32), ctypes.c_float)
        soffp = _ptr(np.ascontiguousarray(sigma_offs, dtype=np.int64), ctypes.c_int64)
    gwp = None
    if gab_weights is not None:
        gwp = _ptr(np.asarray(gab_weights, dtype=np.float32).reshape(6), ctypes.c_float)
    cs = np.asarray(rf.epf_channel_scale, dtype=np.float32)
    get_lib().jxl_filter_chain_multi(
        _ptr(stacked[0], ctypes.c_float), _ptr(stacked[1], ctypes.c_float),
        _ptr(stacked[2], ctypes.c_float), n, _ptr(offs, ctypes.c_int64),
        _ptr(hs_a, ctypes.c_int32), _ptr(ws_a, ctypes.c_int32), int(stride), sigp, soffp,
        gwp, int(epf_iters), _ptr(cs, ctypes.c_float), float(rf.epf_pass0_sigma_scale),
        float(rf.epf_pass2_sigma_scale), float(rf.epf_border_sad_mul),
    )
    return True


def xyb_srgb_u8_native(planes, mat, biases, intensity_target, dither, tf_kind=0, tf_p0=0.0):
    """XYB -> linear -> display TF -> dithered u8, interleaved, in one pass
    (colors.cc jxl_xyb_srgb_u8; jxl_tpu/native/__init__.py:1457): three
    (h, w) float32 planes (row views pass by their stride), the 9 values of
    the (maybe primaries-adapted) inverse opsin matrix, the 3 opsin
    biases, the 32x32 dither table; tf_kind 0 sRGB, 1 PQ (tf_p0 =
    intensity / 10000), 2 BT.709, 3 gamma (tf_p0 = g), 4 linear. Returns
    the (h, w, 3) uint8 array, the dither at (0, 0)."""
    ps = []
    for p in planes[:3]:
        p = _host(p)
        ps.append(p if p.dtype == np.float32 and p.strides[1] == 4
                  else np.ascontiguousarray(p, dtype=np.float32))
    h, w = ps[0].shape
    strides = np.array([p.strides[0] // 4 for p in ps], dtype=np.int64)
    m = np.ascontiguousarray(mat, dtype=np.float32).reshape(9)
    b = np.ascontiguousarray(biases, dtype=np.float32).reshape(3)
    d = np.ascontiguousarray(dither, dtype=np.float32).reshape(1024)
    out = np.empty((h, w, 3), dtype=np.uint8)
    get_lib().jxl_xyb_srgb_u8(
        _ptr(ps[0], ctypes.c_float), _ptr(ps[1], ctypes.c_float), _ptr(ps[2], ctypes.c_float),
        _ptr(strides, ctypes.c_int64), h, w, _ptr(m, ctypes.c_float),
        _ptr(b, ctypes.c_float), 255.0 / float(intensity_target), _ptr(d, ctypes.c_float),
        int(tf_kind), float(tf_p0), _ptr(out, ctypes.c_uint8),
    )
    return out


def xyb_tf_f32_native(planes, mat, biases, intensity_target, tf_kind, tf_p0) -> bool:
    """XYB -> linear -> display TF on three C-contiguous (h, w) float32
    planes in place (colors.cc jxl_xyb_tf_f32;
    jxl_tpu/native/__init__.py:1496): the caller owns the planes. Returns
    False for planes that are not writable C-contiguous float32."""
    ps = [_host(p) for p in planes[:3]]
    h, w = ps[0].shape
    if any(p.dtype != np.float32 or not p.flags.c_contiguous or not p.flags.writeable
           or p.shape != (h, w) for p in ps):
        return False
    m = np.ascontiguousarray(mat, dtype=np.float32).reshape(9)
    b = np.ascontiguousarray(biases, dtype=np.float32).reshape(3)
    get_lib().jxl_xyb_tf_f32(
        _ptr(ps[0], ctypes.c_float), _ptr(ps[1], ctypes.c_float), _ptr(ps[2], ctypes.c_float),
        h, w, _ptr(m, ctypes.c_float), _ptr(b, ctypes.c_float),
        255.0 / float(intensity_target), int(tf_kind), float(tf_p0),
    )
    return True


def dequant_cfl_native(coeffs3, offs, nc, mats, scales, xcc, bcc, biases):
    """Gather, quant bias, dequant and chroma from luma of n blocks in one
    pass (colors.cc jxl_dequant_cfl; jxl_tpu/native/__init__.py:1416):
    coeffs3, three 1-D int32 channel views (or a (3, total) array) that
    offs (n,) indexes; mats (3, nc) float32; scales (n, 3); xcc, bcc (n,);
    biases (4,). Returns the (n, 3, nc) float32 coefficients."""
    if isinstance(coeffs3, (list, tuple)):
        c = [np.ascontiguousarray(_host(x), dtype=np.int32) for x in coeffs3]
    else:
        a = np.ascontiguousarray(_host(coeffs3), dtype=np.int32)
        c = [a[0], a[1], a[2]]
    n = len(offs)
    offs64 = np.ascontiguousarray(_host(offs), dtype=np.int64)
    out = np.empty((n, 3, nc), dtype=np.float32)
    get_lib().jxl_dequant_cfl(
        _ptr(c[0], ctypes.c_int32), _ptr(c[1], ctypes.c_int32), _ptr(c[2], ctypes.c_int32),
        _ptr(offs64, ctypes.c_int64), n, int(nc),
        _ptr(np.ascontiguousarray(_host(mats), np.float32), ctypes.c_float),
        _ptr(np.ascontiguousarray(_host(scales), np.float32), ctypes.c_float),
        _ptr(np.ascontiguousarray(_host(xcc), np.float32), ctypes.c_float),
        _ptr(np.ascontiguousarray(_host(bcc), np.float32), ctypes.c_float),
        _ptr(np.ascontiguousarray(_host(biases), np.float32), ctypes.c_float),
        _ptr(out, ctypes.c_float),
    )
    return out


def dct8_fused_native(coeffs3, offs, scales, xcc, bcc, mats, biases, lf3, idct8,
                      out_planes, gbx, gby, fidx=None, frame_stride=0) -> bool:
    """Dequant, CfL, the 8x8 IDCT and the scatter of n 4:4:4 DCT8 blocks in
    one pass (modular_decode.cc jxl_dct8_fused;
    jxl_tpu/native/__init__.py:1134): coeffs3, three int32 channel views
    that offs (n,) int64 indexes; scales (n, 3); xcc, bcc (n,); mats (3,
    64); biases (4,); lf3 (3, n) the blocks' LF; idct8 the (8, 8) 1-D
    synthesis matrix; out_planes three C-contiguous float32 planes of one
    width, block (gbx, gby) written at row gby*8, column gbx*8; with fidx,
    each block's planes start fidx[i] * frame_stride floats in (a stacked
    animation). Returns False when an output plane is not writable
    C-contiguous float32."""
    outs = [_host(p) for p in out_planes[:3]]
    if any(p.dtype != np.float32 or not p.flags.c_contiguous or not p.flags.writeable
           for p in outs):
        return False
    n = len(offs)
    if n == 0:
        return True
    c = [np.ascontiguousarray(_host(x), dtype=np.int32) for x in coeffs3[:3]]

    def f32(a):
        return _ptr(np.ascontiguousarray(_host(a), dtype=np.float32), ctypes.c_float)

    def i32(a):
        return _ptr(np.ascontiguousarray(_host(a), dtype=np.int32), ctypes.c_int32)

    get_lib().jxl_dct8_fused(
        _ptr(c[0], ctypes.c_int32), _ptr(c[1], ctypes.c_int32), _ptr(c[2], ctypes.c_int32),
        _ptr(np.ascontiguousarray(_host(offs), dtype=np.int64), ctypes.c_int64), n,
        f32(scales), f32(xcc), f32(bcc), f32(mats), f32(biases), f32(lf3), f32(idct8),
        _ptr(outs[0], ctypes.c_float), _ptr(outs[1], ctypes.c_float),
        _ptr(outs[2], ctypes.c_float), int(frame_stride),
        i32(fidx) if fidx is not None else None, i32(gbx), i32(gby), outs[0].shape[-1],
    )
    return True


def dither_u8_native(plane, dither, yoff: int, xoff: int, maxv: float):
    """Dithered float32 -> uint8 of one (h, w) plane (modular_decode.cc
    jxl_dither_u8; jxl_tpu/native/__init__.py:1169): scale by maxv, add
    the 32x32 table at ((y + yoff) % 32, (x + xoff) % 32), clamp, round
    half to even. Returns the (h, w) uint8 array, or None for a plane that
    is not float32 with contiguous rows."""
    plane = _host(plane)
    if plane.dtype != np.float32 or plane.ndim != 2 or plane.strides[1] != 4:
        return None
    h, w = plane.shape
    d = np.ascontiguousarray(dither, dtype=np.float32)
    out = np.empty((h, w), dtype=np.uint8)
    get_lib().jxl_dither_u8(
        _ptr(plane, ctypes.c_float), h, w, plane.strides[0] // 4, _ptr(d, ctypes.c_float),
        int(yoff), int(xoff), float(maxv), _ptr(out, ctypes.c_uint8), w, 1,
    )
    return out


def scatter_blocks_native(outp, pix, bx, by) -> bool:
    """(n, ph, pw) float32 pixel blocks into the C-contiguous float32 plane
    `outp`, block i at row by[i]*8, column bx[i]*8 (modular_decode.cc
    jxl_scatter_blocks; jxl_tpu/native/__init__.py:1190). Returns False
    when the plane or the blocks are not float32 or the plane is not
    C-contiguous."""
    outp, pix = _host(outp), _host(pix)
    if outp.dtype != np.float32 or not outp.flags.c_contiguous or pix.dtype != np.float32:
        return False
    pixc = np.ascontiguousarray(pix)
    n, ph, pw = pixc.shape
    get_lib().jxl_scatter_blocks(
        _ptr(outp, ctypes.c_float), outp.shape[1], _ptr(pixc, ctypes.c_float), n, ph, pw,
        _ptr(np.ascontiguousarray(_host(bx), dtype=np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(_host(by), dtype=np.int32), ctypes.c_int32),
    )
    return True


def _plane_ptrs(planes, elem):
    ptrs = (ctypes.c_void_p * len(planes))()
    strides = np.empty(len(planes), dtype=np.int64)
    for i, p in enumerate(planes):
        ptrs[i] = p.ctypes.data
        strides[i] = p.strides[0] // elem
    return ptrs, strides


def interleave_native(planes):
    """n (h, w) planes of one dtype (float32, uint8 or uint16; rows
    contiguous) interleaved into (h, w, n) in one pass (hostops.cc
    jxl_interleave_*; jxl_tpu/native/__init__.py:1628). None for another
    dtype, planes of different shapes or dtypes, or strided columns."""
    if not planes:
        return None
    planes = [_host(p) for p in planes]
    dt = planes[0].dtype
    lib = get_lib()
    fn = {np.dtype(np.float32): lib.jxl_interleave_f32, np.dtype(np.uint8): lib.jxl_interleave_u8,
          np.dtype(np.uint16): lib.jxl_interleave_u16}.get(dt)
    if fn is None:
        return None
    h, w = planes[0].shape
    if any(p.shape != (h, w) or p.dtype != dt or (w > 1 and p.strides[1] != dt.itemsize)
           for p in planes):
        return None
    ptrs, strides = _plane_ptrs(planes, dt.itemsize)
    out = np.empty((h, w, len(planes)), dtype=dt)
    fn(ptrs, _ptr(strides, ctypes.c_int64), len(planes), w, h, _ptr(out, None))
    return out


def i32_to_f32_scaled_native(plane, scale: float):
    """An int32 (h, w) plane times float32 `scale` as float32, one multiply
    a sample (hostops.cc jxl_i32_to_f32_scaled;
    jxl_tpu/native/__init__.py:1651; ConvertModularToF32's integer
    path). None for another dtype or strided columns."""
    plane = _host(plane)
    if plane.dtype != np.int32 or plane.ndim != 2 or (plane.shape[1] > 1
                                                      and plane.strides[1] != 4):
        return None
    h, w = plane.shape
    out = np.empty((h, w), dtype=np.float32)
    get_lib().jxl_i32_to_f32_scaled(
        _ptr(plane, ctypes.c_int32), plane.strides[0] // 4, w, h, float(scale),
        _ptr(out, ctypes.c_float), w,
    )
    return out


def i32_scaled_interleave_native(planes, scale: float):
    """n int32 (h, w) planes -> (h, w, n) float32 times `scale`, one pass
    (hostops.cc jxl_i32_scaled_interleave;
    jxl_tpu/native/__init__.py:1666). None for planes of different shapes,
    another dtype or strided columns."""
    if not planes:
        return None
    planes = [_host(p) for p in planes]
    h, w = planes[0].shape
    if any(p.shape != (h, w) or p.dtype != np.int32 or (w > 1 and p.strides[1] != 4)
           for p in planes):
        return None
    ptrs, strides = _plane_ptrs(planes, 4)
    out = np.empty((h, w, len(planes)), dtype=np.float32)
    get_lib().jxl_i32_scaled_interleave(
        ptrs, _ptr(strides, ctypes.c_int64), len(planes), w, h, float(scale),
        _ptr(out, ctypes.c_float),
    )
    return out
