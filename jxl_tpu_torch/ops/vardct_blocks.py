"""The 4:4:4 VarDCT block render: the hand-written CUDA kernel
csrc/vardct_blocks.cu (K5) and its plain torch version.

For the n blocks of one transform type: gather each block's three
channels' quantized coefficients from the dense (G * 3 * GD * GD,) int32
buffer, dequantize them (the quant bias, the type's dequant weights, the
block's scale), add chroma from luma, put the LF in (DC of the 8x8 types,
the reinterpreting DCT of the LF tile for DCT16 and larger), run the
inverse transform and write the pixels into the planes.

Replaces no TPU kernel: jxl_tpu writes this stage as XLA
(jxl_tpu/vardct/device_frame.py). The plain version, some 30 torch ops
and three chunked transform chains a type (vardct/transforms_batch.py),
is what the port ran on the card before; on an H100 its queueing from
Python cost more than the card's work. The kernel is bound by bytes
(3 x 64 int32 in and 3 x 64 float32 out a block, about 200 MB at 4K): it
runs one launch a type, reads each block's factors and LF from the tables
the render uploads, and keeps every intermediate on chip (see the note at
the top of the .cu file). A block's pixels depend on that block alone, so
the band, tile and batched renders equal the whole frame's bit for bit.

Each block is one row of `cols`, (n, 4) int64: its first coefficient in
`flat` (group slot * 3 * GD * GD + offset), its index in the LF grid (the
first sample of its LF tile in each row of `lf`, whose tile rows are
`lf_stride` apart; the raw quant table `rq` shares that grid), its first
pixel in each row of `planes` (pixel rows `W` apart) and its colour tile
(index into `ytox` and `ytob`). The host builds them: a frame's in one
native pass (vardct/device_frame.py:frame_columns), the batched
animation's from per-block arrays (block_columns).

`vardct_blocks` takes the plain version for tensors on the CPU and
launches the kernel for CUDA tensors, or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..render.stages.core import to_device
from ..utils import trace
from ..vardct._afv_basis import AFV4X4BASIS
from ..vardct.cfl import COLOR_TILE_DIM_IN_BLOCKS
from ..vardct.group import BLOCK_DIM, GROUP_DIM
from ..vardct.transform_map import covered_blocks_x, covered_blocks_y
from ..vardct.transforms import dct_matrix, dct_scales, idct_matrix
from ..vardct.transforms_batch import transform_to_pixels_batch
from . import _nvcc

_CHANNEL = GROUP_DIM * GROUP_DIM  # a group's channel in the coefficient buffer
# the constants' sides (csrc/vardct_blocks.cu): the transforms' and the LF
# tiles'
_SIDES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_LF_SIDES = (1, 2, 4, 8, 16, 32)

_lock = threading.Lock()
_lib = None
# what the last build in this process reported: seconds and nvcc's output
# (ptxas registers, shared memory and spills); None when the library was
# already built
build_info = None
_CONSTS: dict = {}


def load():
    """Build csrc/vardct_blocks.cu with nvcc for sm_90a at first use (into
    the package's _build/ directory) and load it; raises NativeBuildError
    when the build fails."""
    global _lib, build_info
    with _lock:
        if _lib is not None:
            return _lib
        path, info = _nvcc.build("vardct_blocks")
        if info is not None:
            build_info = info
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vardct_blocks_launch.argtypes = [
            i, i, p, p, p, ll, i, p, p, p, p, i, i, p, p, ll, p, ll, i, p, p,
        ]
        lib.vardct_blocks_launch.restype = ctypes.c_int
        lib.vardct_blocks_error_string.argtypes = [ctypes.c_int]
        lib.vardct_blocks_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def constants() -> np.ndarray:
    """The kernel's float32 constants, laid out as csrc/vardct_blocks.cu
    reads them: IDCT(n) (transforms.py:idct_matrix) for n in _SIDES, then
    DCT(n) (dct_matrix) for the same n, then dct_scales(n) for n in
    _LF_SIDES, then the AFV basis (16 x 16), each row-major."""
    parts = ([idct_matrix(n) for n in _SIDES] + [dct_matrix(n) for n in _SIDES]
             + [dct_scales(n) for n in _LF_SIDES] + [np.array(AFV4X4BASIS, np.float32)])
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in parts])


def _constants_on(device) -> torch.Tensor:
    """constants() on `device`, uploaded once a process and device."""
    key = str(device)
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = to_device(constants(), device)
    return c


def block_columns(tids, gbx, gby, base, bw: int, W: int, bx0: int = 0, lf0=0, pix0=0,
                  tile0=0) -> dict:
    """{tid: (n, 4) int64 columns} of the blocks (tids, gbx, gby, base)
    (int64 arrays; base: the first coefficient in the buffer), each type's
    blocks in the order given: base; the LF index gby * bw + gbx (bw: the
    LF grid's width in blocks); the first pixel gby * 8 * W + (gbx - bx0) *
    8 (W: the planes' width in pixels, bx0 their first block column); the
    colour tile (gby // 8) * ceil(bw / 8) + gbx // 8. lf0, pix0 and tile0
    (scalars or per block) add a frame's start in a stack of frames."""
    tw = -(-bw // COLOR_TILE_DIM_IN_BLOCKS)
    cols = np.stack([
        base, lf0 + gby * bw + gbx, pix0 + gby * (BLOCK_DIM * W) + (gbx - bx0) * BLOCK_DIM,
        tile0 + (gby // COLOR_TILE_DIM_IN_BLOCKS) * tw + gbx // COLOR_TILE_DIM_IN_BLOCKS,
    ], axis=1).astype(np.int64).reshape(-1, 4)
    if cols.size and cols.min() < 0:
        raise ValueError("a block column is negative")
    order = np.argsort(tids, kind="stable")
    ordered = np.asarray(tids)[order]
    cuts = np.flatnonzero(np.diff(ordered)) + 1
    return {int(ordered[i]): cols[sel]
            for i, sel in zip(np.r_[0, cuts], np.split(order, cuts)) if len(sel)}


def dequant(qb, bias, b3, mats, scale):
    """Dequantized coefficients of the int32 quantized ones `qb`: the
    quant bias (q * bias where |q| < 2, else q - b3 / q; 0 stays 0) times
    the dequant weights `mats` times the blocks' `scale`, each broadcast
    against qb."""
    q = qb.to(torch.float32)
    adj = torch.where(qb.abs() < 2, q * bias, q - b3 / torch.where(qb == 0, 1.0, q))
    adj = torch.where(qb == 0, 0.0, adj)
    return adj * mats * scale


def block_factors(rq_b, ytox_b, ytob_b, k) -> tuple:
    """(scales (n, 3), x_cc (n,), b_cc (n,)): the blocks' dequant scales
    and chroma-from-luma factors from their raw quant (float32), their
    colour tiles' ytox and ytob (float32) and k, the (6, 1)
    vardct/device_frame.py:frame_factors of their frame or a (6, n) column
    a block. The kernel computes the same in the same float order."""
    x_dm, b_dm, igs, cf, bcx, bcb = k.unbind(0)
    scaled_y = igs / rq_b
    scales = torch.stack([scaled_y * x_dm, scaled_y, scaled_y * b_dm], dim=1)
    return scales, bcx + ytox_b / cf, bcb + ytob_b / cf


def _check(t, flat, cols, lf, lf_stride, rq, ytox, ytob, k, bias, mats, planes, W) -> None:
    """Raise ValueError on what neither version takes."""
    if not 0 <= t < 27:
        raise ValueError(f"transform type {t} is not one of the 27")
    dev = flat.device
    named = {"flat": flat, "cols": cols, "lf": lf, "rq": rq, "ytox": ytox, "ytob": ytob,
             "k": k, "bias": bias, "mats": mats, "planes": planes}
    for name, x in named.items():
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if x.device != dev:
            raise ValueError(f"{name} lies on {x.device}, flat on {dev}")
    for name in ("flat", "rq"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {named[name].dtype}")
    if cols.dtype != torch.int64:
        raise ValueError(f"cols must be int64, got {cols.dtype}")
    for name in ("lf", "ytox", "ytob", "k", "bias", "mats", "planes"):
        if named[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {named[name].dtype}")
    for name in ("flat", "cols", "rq", "ytox", "ytob", "k", "bias", "mats"):
        if not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if flat.dim() != 1:
        raise ValueError(f"flat must be 1-D, got {tuple(flat.shape)}")
    if cols.dim() != 2 or cols.shape[1] != 4:
        raise ValueError(f"cols must be (n, 4), got {tuple(cols.shape)}")
    n = cols.shape[0]
    for name in ("lf", "planes"):
        x = named[name]
        if x.dim() != 2 or x.shape[0] != 3 or x.stride(1) != 1:
            raise ValueError(f"{name} must be (3, m) with rows of stride 1, got "
                             f"{tuple(x.shape)} strides {x.stride()}")
    if tuple(bias.shape) != (4,):
        raise ValueError(f"bias must be (4,), got {tuple(bias.shape)}")
    if k.dim() != 2 or k.shape[0] != 6 or k.shape[1] not in (1, n):
        raise ValueError(f"k must be (6, 1) or (6, {n}), got {tuple(k.shape)}")
    nc = covered_blocks_x(t) * covered_blocks_y(t) * BLOCK_DIM * BLOCK_DIM
    if mats.dim() != 3 or mats.shape[0] not in (1, n) or tuple(mats.shape[1:]) != (3, nc):
        raise ValueError(f"mats must be (1, 3, {nc}) or ({n}, 3, {nc}), got "
                         f"{tuple(mats.shape)}")
    if int(W) <= 0 or int(lf_stride) <= 0:
        raise ValueError(f"W and lf_stride must be positive, got {W} and {lf_stride}")


def vardct_blocks_reference(t, flat, cols, lf, lf_stride, rq, ytox, ytob, k, bias, mats,
                            planes, W) -> None:
    """The plain torch version of vardct_blocks: index gathers, the
    dequant, chroma from luma, transform_to_pixels_batch a channel, and a
    scatter into planes."""
    dev = flat.device
    n = cols.shape[0]
    cx, cy = covered_blocks_x(t), covered_blocks_y(t)
    nc = cx * cy * BLOCK_DIM * BLOCK_DIM
    base, lf0, pix0, tile = cols.unbind(1)
    scales, x_cc, b_cc = block_factors(rq.reshape(-1)[lf0].to(torch.float32),
                                       ytox.reshape(-1)[tile], ytob.reshape(-1)[tile], k)
    gidx = (base[:, None, None] + torch.arange(3, device=dev)[None, :, None] * _CHANNEL
            + torch.arange(nc, device=dev)[None, None, :])
    qb = flat[gidx.reshape(-1)].reshape(n, 3, nc)
    dq = dequant(qb, bias[:3][None, :, None], bias[3], mats, scales[:, :, None])
    # X and B get Y's dequantized value times their correlation
    dq[:, 0] += x_cc[:, None] * dq[:, 1]
    dq[:, 2] += b_cc[:, None] * dq[:, 1]
    iy = torch.arange(cy, device=dev)
    ix = torch.arange(cx, device=dev)
    lf_idx = (lf0[:, None, None] + iy[None, :, None] * lf_stride + ix[None, None, :]).reshape(-1)
    py = torch.arange(cy * BLOCK_DIM, device=dev)
    px = torch.arange(cx * BLOCK_DIM, device=dev)
    pidx = (pix0[:, None, None] + py[None, :, None] * W + px[None, None, :]).reshape(-1)
    for c in (1, 0, 2):
        lf_tiles = lf[c][lf_idx].reshape(n, cy, cx)
        pix = transform_to_pixels_batch(t, lf_tiles, dq[:, c].contiguous())
        planes[c, pidx] = pix.reshape(-1)


def vardct_blocks(t, flat, cols, lf, lf_stride, rq, ytox, ytob, k, bias, mats, planes,
                  W) -> None:
    """Dequant, chroma from luma and the inverse transform of the blocks of
    transform type t whose columns are `cols` ((n, 4) int64, module
    docstring), their pixels written into `planes` ((3, P) float32, pixel
    rows W apart). flat: the dense int32 coefficients; lf: (3, L) float32
    LF samples, tile rows lf_stride apart; rq: int32 raw quant on the LF
    grid; ytox, ytob: float32 colour tiles; k: (6, 1) or (6, n) float32
    frame factors (vardct/device_frame.py:frame_factors, a column a
    block); bias: the (4,) quant biases; mats: (1, 3, nc) or (n, 3, nc)
    float32 dequant weights."""
    t = int(t)
    _check(t, flat, cols, lf, lf_stride, rq, ytox, ytob, k, bias, mats, planes, W)
    n = cols.shape[0]
    if n == 0:
        return
    if flat.device.type == "cpu":
        vardct_blocks_reference(t, flat, cols, lf, lf_stride, rq, ytox, ytob, k, bias, mats,
                                planes, W)
        return
    if flat.device.type != "cuda":
        raise ValueError(f"vardct_blocks runs on cpu or cuda, not {flat.device}")
    if cols.data_ptr() % 16:
        raise ValueError("cols must start on a 16-byte boundary (the kernel loads 16 bytes at once)")
    lib = load()
    consts = _constants_on(flat.device)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.vardct_blocks_launch(
            t, n, flat.data_ptr(), cols.data_ptr(), lf.data_ptr(), lf.stride(0),
            int(lf_stride), rq.data_ptr(), ytox.data_ptr(), ytob.data_ptr(), k.data_ptr(),
            k.shape[1], int(k.shape[1] > 1), bias.data_ptr(), mats.data_ptr(),
            mats.stride(0) if mats.shape[0] > 1 else 0, planes.data_ptr(), planes.stride(0),
            int(W), consts.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"vardct_blocks kernel launch failed: {lib.vardct_blocks_error_string(err).decode()}")
    vardct_blocks.launches += 1
    trace.metrics.add("vardct_blocks_launches")
    trace.metrics.add("vardct_blocks_blocks", n)


vardct_blocks.launches = 0
