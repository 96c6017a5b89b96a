"""Gaborish + EPF restoration-filter chain: the hand-written CUDA kernel
csrc/epf_gab.cu and its plain torch version.

Replaces the TPU kernel jxl_tpu/ops/pallas_epf.py:epf_gab_pallas. On an
H100 the chain is bound by memory: 28 bytes a pixel (3 planes and 1/sigma
read once, 3 planes written once), about 69 us for a 3840x2160 frame at
3.35 TB/s; with EPF step 0 enabled (epf_iters 3) its operations bound it
instead. The kernel reads each input pixel from device memory once (plus
the halo of its tile) and writes each output pixel once, running every
stage on a tile held in shared memory; what limits it in practice is that
tile's shared-memory traffic and instruction count. So the stage set is a
compile-time choice (one instantiation per (gaborish, epf_iters)) whose
halo is just the sum of the borders of the stages that run, stages update
the tile in place through registers (three blocks an SM on the main path),
interior tiles load with 16-byte loads, and EPF steps 1 and 2 share each
neighbour SAD between the two pixels it joins (see the note at the top of
the .cu file). The geometry of each stage set is csrc/kernel_geometry.h's;
`epf_gab_plan` reads it for reports and tests.

`epf_gab` takes the plain version for a tensor on the CPU and launches the
kernel for a CUDA tensor, or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from types import MappingProxyType, SimpleNamespace

import numpy as np
import torch

from .. import native
from ..render.stages import core
from . import _nvcc

_lock = threading.Lock()
_lib = None
# what the last build in this process reported: seconds and nvcc's output
# (ptxas registers, shared memory and spills); None when the library was
# already built
build_info = None


def load():
    """Build csrc/epf_gab.cu with nvcc for sm_90a at first use (into the
    package's _build/ directory) and load it; raises NativeBuildError when
    the build fails."""
    global _lib, build_info
    with _lock:
        if _lib is not None:
            return _lib
        path, info = _nvcc.build("epf_gab")
        if info is not None:
            build_info = info
        lib = ctypes.CDLL(str(path))
        lib.epf_gab_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.epf_gab_launch.restype = ctypes.c_int
        lib.epf_gab_error_string.argtypes = [ctypes.c_int]
        lib.epf_gab_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


TILE = (32, 64)  # output rows, columns of one block (csrc/kernel_geometry.h k1)


@functools.lru_cache(maxsize=16)
def epf_gab_plan(use_gab: bool, epf_iters: int) -> dict:
    """The kernel's tile geometry for one stage set, as
    csrc/kernel_geometry.h defines it (read through the host library): the
    halo is the sum of the borders of the stages that run (gaborish 1, EPF0
    3, EPF1 2, EPF2 1), rounded up to 4 columns horizontally so that tiles
    start 16-byte aligned; shared memory holds the three planes, and with
    EPF also 1/sigma and two SAD planes. `input_bytes_per_px` models the
    traffic of that geometry: the bytes an interior tile reads from device
    memory per output pixel (3 planes, and 1/sigma with EPF, over the tile
    and its halo). It is a model, not a reading."""
    g = native.k1_geometry(bool(use_gab), int(epf_iters))
    th, tw = TILE
    read_planes = 4 if int(epf_iters) > 0 else 3
    cells = g["rows"] * g["cols"] if g["halo"] else th * tw
    return MappingProxyType(dict(
        halo=g["halo"], halo_x=g["halo_x"], tile=TILE, shared_tile=(g["rows"], g["cols"]),
        smem_planes=g["planes"], smem_bytes=g["smem_bytes"],
        input_bytes_per_px=read_planes * 4 * cells / (th * tw)))


def _steps(epf_iters: int) -> list:
    """EPF steps run for `epf_iters`, in order (ref render.rs)."""
    return [s for s, need in ((0, 3), (1, 1), (2, 2)) if epf_iters >= need]


def _rf(pass0_scale, pass2_scale, border_sad_mul, channel_scale):
    return SimpleNamespace(
        epf_pass0_sigma_scale=pass0_scale,
        epf_pass2_sigma_scale=pass2_scale,
        epf_border_sad_mul=border_sad_mul,
        epf_channel_scale=tuple(channel_scale),
    )


def epf_gab_reference(planes, inv_sigma, gab_weights, epf_iters, pass0_scale,
                      pass2_scale, border_sad_mul, channel_scale):
    """The plain torch version: the stage math of render/stages/core.py
    (mirror at the image edge before every stage)."""
    rf = _rf(pass0_scale, pass2_scale, border_sad_mul, channel_scale)
    chans = [planes[0], planes[1], planes[2]]
    if gab_weights is not None:
        chans = [core.gaborish(c, w1, w2) for c, (w1, w2) in zip(chans, gab_weights)]
    for step in _steps(epf_iters):
        chans = core.epf_step_px(chans, inv_sigma, rf, step)
    return torch.stack(chans)


@functools.lru_cache(maxsize=64)
def _kernel_params(gab_weights, pass0_scale, pass2_scale, border_sad_mul,
                   channel_scale) -> np.ndarray:
    """The 18 float32 constants of csrc/epf_gab.cu's Params, rounded as the
    plain version rounds them (cached: hashable arguments, read-only
    result)."""
    rf = _rf(pass0_scale, pass2_scale, border_sad_mul, channel_scale)
    gab = [core.gaborish_weights(w1, w2) for w1, w2 in (gab_weights or ((0.0, 0.0),) * 3)]
    sm, bsm = [], []
    for step in (0, 1, 2):
        _, _, _, s, b = core.epf_step_params(rf, step)
        sm.append(s)
        bsm.append(b)
    vals = [v for g in gab for v in g] + sm + bsm + list(channel_scale)
    out = np.array(vals, dtype=np.float32)
    out.setflags(write=False)
    return out


def epf_gab(planes, inv_sigma, gab_weights, epf_iters, pass0_scale,
            pass2_scale, border_sad_mul, channel_scale):
    """Gaborish (when `gab_weights`, 3 (w1, w2) pairs, is not None), then
    EPF steps as `epf_iters` selects, on (3, H, W) float32 planes with a
    per-pixel (H, W) float32 1/sigma. Returns new (3, H, W) planes."""
    if planes.dtype != torch.float32 or inv_sigma.dtype != torch.float32:
        raise TypeError("epf_gab takes float32 planes and 1/sigma")
    if planes.dim() != 3 or planes.shape[0] != 3:
        raise ValueError(f"planes must be (3, H, W), got {tuple(planes.shape)}")
    h, w = planes.shape[1:]
    if tuple(inv_sigma.shape) != (h, w):
        raise ValueError(f"inv_sigma must be {(h, w)}, got {tuple(inv_sigma.shape)}")
    if planes.device != inv_sigma.device:
        raise ValueError("planes and inv_sigma must lie on one device")
    if not 0 <= int(epf_iters) <= 3:
        raise ValueError(f"epf_iters must be 0..3, got {epf_iters}")
    if h == 0 or w == 0:
        raise ValueError("empty planes")
    if planes.device.type == "cpu":
        return epf_gab_reference(planes, inv_sigma, gab_weights, epf_iters,
                                 pass0_scale, pass2_scale, border_sad_mul,
                                 channel_scale)
    if planes.device.type != "cuda":
        raise ValueError(f"epf_gab runs on cpu or cuda, not {planes.device}")
    if not (planes.is_contiguous() and inv_sigma.is_contiguous()):
        raise ValueError("epf_gab takes contiguous tensors")
    lib = load()
    params = _kernel_params(None if gab_weights is None else tuple(map(tuple, gab_weights)),
                            float(pass0_scale), float(pass2_scale), float(border_sad_mul),
                            tuple(map(float, channel_scale)))
    out = torch.empty_like(planes)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.epf_gab_launch(
            planes.data_ptr(), inv_sigma.data_ptr(), out.data_ptr(), h, w,
            params.ctypes.data, int(gab_weights is not None), int(epf_iters), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"epf_gab kernel launch failed: {lib.epf_gab_error_string(err).decode()}"
        )
    epf_gab.launches += 1
    return out


epf_gab.launches = 0
