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
import threading

import numpy as np
import torch

from ..render.stages import core
from . import _nvcc

# the widest lane K4 takes: three rows of int32 in 48 KB of shared memory
MAX_W = 4096

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


def _lane_table(dims, n: int) -> np.ndarray:
    """(L, 3) int64 (offset, h, w) of lanes of `dims` packed back to back
    in a flat buffer of n samples; raises on dims that do not tile it."""
    dims = np.asarray(dims, dtype=np.int64).reshape(-1, 2)
    if len(dims) == 0 or (dims < 1).any():
        raise ValueError("gradient_wavefront takes one or more lanes of at least 1x1")
    sizes = dims[:, 0] * dims[:, 1]
    if int(sizes.sum()) != n:
        raise ValueError(f"lanes of {int(sizes.sum())} samples in a buffer of {n}")
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
    same layout."""
    if res.dtype not in (torch.int16, torch.int32) or res.dim() != 1:
        raise TypeError("gradient_wavefront takes a flat int16 or int32 tensor")
    table = _lane_table(dims, res.numel())
    if res.device.type == "cpu":
        return gradient_wavefront_plain(res, dims)
    if res.device.type != "cuda":
        raise ValueError(f"gradient_wavefront runs on cpu or cuda, not {res.device}")
    max_w = int(table[:, 2].max())
    if max_w > MAX_W:
        raise ValueError(f"gradient_wavefront takes lanes at most {MAX_W} wide, not {max_w}")
    if not res.is_contiguous():
        raise ValueError("gradient_wavefront takes a contiguous tensor")
    lib = load()
    lanes = core.to_device(table, res.device)
    out = torch.empty(res.numel(), dtype=torch.int32, device=res.device)
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream(res.device).cuda_stream
        err = lib.gradient_wavefront_launch(res.data_ptr(), res.element_size(), lanes.data_ptr(),
                                            len(table), max_w, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("gradient_wavefront kernel launch failed: "
                           f"{lib.gradient_wavefront_error_string(err).decode()}")
    gradient_wavefront.launches += 1
    return out


gradient_wavefront.launches = 0
