"""The rANS lane kernels of csrc/ans_lanes.cu: K2 (`ans_decode_batch`,
here) and K3 (ops/device_ac.py:decode_ac_sections), built together.

K2 replaces the TPU kernel jxl_tpu/ops/pallas_ans.py:
ans_decode_batch_pallas: `num_tokens` rANS symbols from each of S streams
through one alias table. A stream is a serial chain (a symbol's table slot
depends on the state the symbol before it left), so the steps of one
stream, times one step's dependent latency, bound it; bytes and operations
are far below that. The kernel keeps that chain short (the model and its
numbers are in the note at the top of the .cu file):
- the block expands the alias table into one 16-byte slot a 12-bit state,
  so a step's table work is one shared load, not the cutoff load and the
  loads that depend on it, and a second multiply-add beside the state's
  gives the next slot's byte offset;
- the renorm bits are the 16-bit halfword at the stream's cursor, loaded
  two steps ahead from a ring of its bytes in shared memory: no load of
  stream bytes is on the chain;
- one warp a stream, spread over every SM (`k2_plan`), where one thread a
  stream had put 135 streams on 3 SMs;
- each lane keeps one symbol of 32 steps, and the warp stores them as 128
  contiguous bytes.

The wrapper takes the plain version (ops/device_ans.py:ans_decode_batch)
for a tensor on the CPU and launches the kernel for a CUDA tensor, or
raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from types import MappingProxyType

import torch

from . import _nvcc
from .. import native
from .device_ans import ans_decode_batch as ans_decode_batch_reference

_lock = threading.Lock()
_libs = {}  # probe flag -> loaded library
# what the last build in this process reported (see _nvcc.build); None
# when the library was already built
build_info = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def load(probe: bool = False):
    """Build csrc/ans_lanes.cu with nvcc for sm_90a at first use and load
    it; raises NativeBuildError when the build fails. probe=True gives the
    variant built with -DK3_PROBE, whose K3 also counts cycles and tokens
    per lane (k3_probe_read) and whose K2 counts each stream's cycles
    (k2_probe_read; tools/k3_probe.py)."""
    global build_info
    with _lock:
        if probe in _libs:
            return _libs[probe]
        path, info = _nvcc.build("ans_lanes", ("K3_PROBE",) if probe else ())
        if info is not None and not probe:
            build_info = info
        lib = ctypes.CDLL(str(path))
        lib.ans_decode_lanes_launch.argtypes = [_P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _P]
        lib.ans_decode_lanes_launch.restype = _I
        lib.ac_sections_launch.argtypes = (
            [_P, _I, _I] + [_P] * 9 + [_I, _P, _I, _P, _P, _I, _I, _P, _I]
            + [_I, _I, _I, _P, _P] + [_I] * 2 + [_P]
        )
        lib.ac_sections_launch.restype = _I
        lib.ans_lanes_error_string.argtypes = [_I]
        lib.ans_lanes_error_string.restype = ctypes.c_char_p
        if probe:
            for name in ("k3_probe_read", "k2_probe_read"):
                getattr(lib, name).argtypes = [_P, _I]
                getattr(lib, name).restype = _I
        _libs[probe] = lib
        return lib


def check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {lib.ans_lanes_error_string(err).decode()}"
        )


H100_SMS = 132


@functools.lru_cache(maxsize=64)
def k2_plan(S: int, T: int, L: int, sms: int = H100_SMS) -> dict:
    """K2's launch for S streams of L bytes and T steps on a card of `sms`
    SMs, as csrc/kernel_geometry.h plans it (read through the host
    library): `warps`, the streams (one warp each) a block; `threads` a
    block (1024: all of them build the table and stage the rings, then the
    warps past `warps` exit); `ring_bytes` of each stream
    staged in shared memory (the bytes T steps can read, 4 + 2T at most the
    row, in a power of two of 256 B to 4 KB); `smem_bytes` a block (the
    80 KB table and the rings); `blocks`."""
    p = native.k2_plan(S, T, L, sms)
    return MappingProxyType(dict(p, ring_bytes=4 * p["ring_words"], blocks=-(-S // p["warps"])))


def ans_decode_batch(streams, table, log_bucket_size: int, num_tokens: int):
    """Decode `num_tokens` symbols from each of S streams.

    streams: (S, L) uint8 (each starts with the 32-bit initial state,
    LSB-first, then renorm bits); table: (5, n_buckets) int32, on one
    device. Returns (tokens (S, T) int32, final_states (S,) int64 holding
    the uint32 states)."""
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be an (S, L) uint8 tensor")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != 5:
        raise ValueError("table must be a (5, n_buckets) int32 tensor")
    if table.device != streams.device:
        raise ValueError("streams and table must lie on one device")
    nb = table.shape[1]
    if not 0 <= log_bucket_size <= 12 or nb << log_bucket_size < 4096 or num_tokens < 0:
        raise ValueError(f"bad log_bucket_size {log_bucket_size} for {nb} buckets")
    s, length = streams.shape
    if s and not length:
        raise ValueError("ans_decode_batch needs at least one byte a stream")
    if streams.device.type == "cpu":
        return ans_decode_batch_reference(streams, table, log_bucket_size, num_tokens)
    if streams.device.type != "cuda":
        raise ValueError(f"ans_decode_batch runs on cpu or cuda, not {streams.device}")
    if not (streams.is_contiguous() and table.is_contiguous()):
        raise ValueError("ans_decode_batch takes contiguous tensors")
    lib = load()
    sms = torch.cuda.get_device_properties(streams.device).multi_processor_count
    plan = k2_plan(s, num_tokens, length, sms)
    tokens = torch.empty((s, num_tokens), dtype=torch.int32, device=streams.device)
    final = torch.empty((s,), dtype=torch.int32, device=streams.device)
    with torch.cuda.device(streams.device):
        stream = torch.cuda.current_stream(streams.device).cuda_stream
        err = lib.ans_decode_lanes_launch(
            streams.data_ptr(), s, length, table.data_ptr(), nb, log_bucket_size,
            num_tokens, tokens.data_ptr(), final.data_ptr(), plan["warps"],
            plan["ring_words"], stream,
        )
    check_launch(lib, err, "ans_decode_batch")
    ans_decode_batch.launches += 1
    return tokens, final.to(torch.int64) & 0xFFFFFFFF


ans_decode_batch.launches = 0
