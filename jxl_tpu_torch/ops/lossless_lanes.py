"""The reconstruction lanes of lossless Modular: the West and North cumsum
lanes, and K4, the clamped-gradient wavefront (csrc/lossless_lanes.cu),
with its plain torch version.

Counterparts of jxl_tpu/modular/device_lossless.py:_program (:94): its
cumsum_west and cumsum_north are XLA ops there and stay torch ops here, on
every device; its wavefront (:122), a lax.scan over anti-diagonals, would
be a Python loop of about ten ops a diagonal in eager torch (511
diagonals for a 256x256 channel), so on the card it is the hand kernel K4.

int32 samples wrap. torch's cumsum of an int32 tensor gives int64, so the
cumsum lanes sum in int64 and wrap back to int32 explicitly (wrap_i32):
sums mod 2^32 do not depend on their order, so a lane equals the host's
int32 loop for any residuals. The gradient lane's clamp is computed in its
select form (the larger neighbour when the top-left is below both, the
smaller when above both, else l + t - tl, then between them), which cannot
overflow; only the final add wraps. Inside the overflow gate of
modular/device_lossless.py this equals jxl_tpu's clip form.

`gradient_wavefront` takes the plain version for a tensor on the CPU and
launches K4 for a CUDA tensor, or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import itertools
import threading

import numpy as np
import torch

from . import _nvcc

# the widest lane K4 takes: its eight edge rings of a row each, with the
# warps' tiles, in the 227 KB of shared memory a block may use
MAX_W = 4096
# K4's geometry, as csrc/lossless_lanes.cu's constants (chip_smoke.py holds
# the card's plan to them): warps a block (a lane), rows a strip (a warp),
# columns a staged tile, steps between two hand-offs, tile row pitch in words
GEOMETRY = {"warps": 8, "strip_rows": 32, "chunk_cols": 32, "handoff_cols": 16, "pitch": 66}
# lanes a launch: their (h, w) travel as kernel parameters
LAUNCH_LANES = 480

_lock = threading.Lock()
_lib = None
# what the last build in this process reported (seconds, nvcc's output);
# None when the library was already built
build_info = None


def load():
    """Build csrc/lossless_lanes.cu with nvcc for sm_90a at first use (into
    the package's _build/ directory) and load it; raises NativeBuildError
    when the build fails."""
    global _lib, build_info
    with _lock:
        if _lib is not None:
            return _lib
        path, info = _nvcc.build("lossless_lanes")
        if info is not None:
            build_info = info
        lib = ctypes.CDLL(str(path))
        lib.gradient_wavefront_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.gradient_wavefront_launch.restype = ctypes.c_int
        lib.gradient_wavefront_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.gradient_wavefront_plan.restype = ctypes.c_int
        lib.gradient_wavefront_max_lanes.restype = ctypes.c_int
        if lib.gradient_wavefront_max_lanes() != LAUNCH_LANES:
            raise RuntimeError("csrc/lossless_lanes.cu takes "
                               f"{lib.gradient_wavefront_max_lanes()} lanes a launch, "
                               f"not LAUNCH_LANES = {LAUNCH_LANES}")
        lib.gradient_wavefront_error_string.argtypes = [ctypes.c_int]
        lib.gradient_wavefront_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 mod 2^32 (two's complement)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def cumsum_west(r: torch.Tensor) -> torch.Tensor:
    """(L, H, W) residuals of the West predictor -> int32 samples:
    v[y][x] = v[y][x-1] + r, column 0 a North chain (the left of x = 0 is
    the sample above)."""
    r = r.to(torch.int64)
    col0 = torch.cumsum(r[:, :, 0], dim=1)
    return wrap_i32(col0[:, :, None] + torch.cumsum(r, dim=2) - r[:, :, 0:1])


def cumsum_north(r: torch.Tensor) -> torch.Tensor:
    """(L, H, W) residuals of the North predictor -> int32 samples: row 0 a
    West chain (the top of y = 0 is the sample to the left)."""
    r = r.to(torch.int64)
    row0 = torch.cumsum(r[:, 0, :], dim=1)
    return wrap_i32(row0[:, None, :] + torch.cumsum(r, dim=1) - r[:, 0:1, :])


def wavefront_plain(r: torch.Tensor) -> torch.Tensor:
    """(L, H, W) residuals of the Gradient predictor -> int32 samples, one
    anti-diagonal at a time (jxl_tpu's wavefront on (L, W) carries):
    skewed, S[l, d, x] = r[l, d - x, x], so that a cell's left and
    top-left neighbours are one column over on the previous diagonals."""
    L, H, W = r.shape
    dev = r.device
    r = r.to(torch.int32)
    D = H + W - 1
    x = torch.arange(W, device=dev)
    ys = torch.arange(D, device=dev)[:, None] - x[None, :]  # (D, W)
    sk = r[:, ys.clamp(0, H - 1), x[None, :].expand(D, W)]
    sk = torch.where(((ys >= 0) & (ys < H))[None], sk, 0)  # (L, D, W)
    first_col = x == 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    p1 = torch.zeros((L, W), dtype=torch.int32, device=dev)
    p2 = p1
    out = torch.empty((L, D, W), dtype=torch.int32, device=dev)
    for d in range(D):
        first_row = x == d  # cell (d - x, x) is in row 0
        t = torch.where(first_row, zero, p1)
        left = torch.where(first_col, t, torch.roll(p1, 1, dims=1))
        tl = torch.where(first_col, t, torch.where(first_row, zero, torch.roll(p2, 1, dims=1)))
        mn, mx = torch.minimum(left, t), torch.maximum(left, t)
        pred = torch.where(tl < mn, mx, torch.where(tl > mx, mn, left + t - tl))
        v = pred + sk[:, d]
        out[:, d] = v
        p1, p2 = v, p1
    # unskew: V[l, y, x] = S[l, y + x, x]
    idx = torch.arange(H, device=dev)[:, None] + x[None, :]
    return torch.gather(out, 1, idx[None].expand(L, H, W))


def _checked_dims(dims, n: int) -> tuple:
    """((L, 2) int64 (h, w), (L,) sizes) of lanes of `dims` packed back to
    back in a flat buffer of n samples; raises on dims that do not tile it.
    A list of (h, w) pairs is read with np.fromiter, about half the time of
    np.asarray (the wrapper's host time on a decode's batch)."""
    try:
        dims = np.fromiter(itertools.chain.from_iterable(dims), np.int64)
    except TypeError:  # already flat, or an array
        dims = np.asarray(dims, dtype=np.int64)
    dims = dims.reshape(-1, 2)
    if len(dims) == 0 or (dims < 1).any():
        raise ValueError("gradient_wavefront takes one or more lanes of at least 1x1")
    sizes = dims[:, 0] * dims[:, 1]
    if int(sizes.sum()) != n:
        raise ValueError(f"lanes of {int(sizes.sum())} samples in a buffer of {n}")
    return dims, sizes


def _lane_table(dims, n: int) -> np.ndarray:
    """(L, 3) int64 (offset, h, w) of lanes of `dims` packed back to back
    in a flat buffer of n samples; raises on dims that do not tile it."""
    dims, sizes = _checked_dims(dims, n)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return np.ascontiguousarray(np.column_stack([offsets, dims]))


def gradient_wavefront_plain(res: torch.Tensor, dims) -> torch.Tensor:
    """The plain version of gradient_wavefront: the lanes of each shape
    gathered into one (L, h, w) batch for wavefront_plain."""
    table = _lane_table(dims, res.numel())
    out = torch.empty(res.numel(), dtype=torch.int32, device=res.device)
    shapes: dict = {}
    for i, (_, h, w) in enumerate(table.tolist()):
        shapes.setdefault((h, w), []).append(i)
    for (h, w), lanes in shapes.items():
        idx = torch.from_numpy(table[lanes, 0][:, None] + np.arange(h * w)).to(res.device)
        out[idx] = wavefront_plain(res[idx].view(len(lanes), h, w)).view(len(lanes), h * w)
    return out


def gradient_wavefront(res: torch.Tensor, dims) -> torch.Tensor:
    """Reconstruct lanes of Gradient-predictor residuals: `res` (N,) int16
    or int32 holds the lanes back to back, each row-major, and `dims`
    (host integers, (L, 2)) their (h, w). Returns (N,) int32 samples in the
    same layout. On the card the lanes' (h, w) go to K4 as kernel
    parameters, LAUNCH_LANES lanes a launch: a call uploads nothing and
    does not wait."""
    if res.dtype not in (torch.int16, torch.int32) or res.dim() != 1:
        raise TypeError("gradient_wavefront takes a flat int16 or int32 tensor")
    dims, sizes = _checked_dims(dims, res.numel())
    if res.device.type == "cpu":
        return gradient_wavefront_plain(res, dims)
    if res.device.type != "cuda":
        raise ValueError(f"gradient_wavefront runs on cpu or cuda, not {res.device}")
    max_w = int(dims[:, 1].max())
    if max_w > MAX_W:
        raise ValueError(f"gradient_wavefront takes lanes at most {MAX_W} wide, not {max_w}")
    max_h = int(dims[:, 0].max())
    if max_h >= 1 << 31:
        raise ValueError(f"gradient_wavefront takes lanes under 2^31 tall, not {max_h}")
    if not res.is_contiguous():
        raise ValueError("gradient_wavefront takes a contiguous tensor")
    lib = load()
    hw = dims.astype(np.int32)
    out = torch.empty(res.numel(), dtype=torch.int32, device=res.device)
    esz = res.element_size()
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream(res.device).cuda_stream
        pos = 0
        for a in range(0, len(hw), LAUNCH_LANES):
            part = hw[a : a + LAUNCH_LANES]
            err = lib.gradient_wavefront_launch(
                res.data_ptr() + pos * esz, esz, part.ctypes.data, len(part),
                int(part[:, 1].max()), out.data_ptr() + pos * 4, stream)
            if err != 0:
                raise RuntimeError("gradient_wavefront kernel launch failed: "
                                   f"{lib.gradient_wavefront_error_string(err).decode()}")
            gradient_wavefront.launches += 1
            pos += int(sizes[a : a + LAUNCH_LANES].sum())
    return out


gradient_wavefront.launches = 0


def plan(res_bytes: int, max_w: int) -> dict:
    """K4's launch geometry on the card for lanes at most max_w wide:
    GEOMETRY's numbers as the kernel has them, its shared bytes a block and
    the blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = load()
    keys = (*GEOMETRY, "smem_bytes", "blocks_per_sm")
    out = (ctypes.c_int * len(keys))()
    err = lib.gradient_wavefront_plan(res_bytes, max_w, out)
    if err != 0:
        raise RuntimeError("gradient_wavefront_plan failed: "
                           f"{lib.gradient_wavefront_error_string(err).decode()}")
    return dict(zip(keys, list(out)))
