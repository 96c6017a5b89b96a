"""Render pipeline stage math on torch tensors (the plain versions).

Every function takes whole planes and is written with shifted-slice
arithmetic only, in the same operation order as the JAX package's stage
math, so the two agree bit for bit on the CPU. The restoration filters
here are also the plain version that the gaborish+EPF kernel
(ops/epf_gab.py) is held against.

Capability reference: jxl/src/render/stages/{gaborish,epf/*,convert}.rs
and features/epf.rs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BLOCK_DIM = 8
MIN_SIGMA = -3.90524291751269967465540850526868
INV_SIGMA_NUM = -1.1715728752538099024


def f32(x: float) -> float:
    """`x` rounded to float32, as a Python float. Scalars enter torch ops
    already rounded, so no op sees a constant wider than the numpy
    reference's np.float32 constants."""
    return float(np.float32(x))


def to_device_all(arrays, device) -> list:
    """Small host arrays (kernel weights, tables) on `device`. On the card
    they go up from one page-locked buffer, in one copy, for each dtype
    among them, without waiting: a copy from pageable memory makes the host
    wait for all the work queued before it, and so can each page-locked
    allocation. Each array comes back as a view of its dtype's buffer,
    starting on a 16-byte boundary."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if torch.device(device).type != "cuda":
        return [torch.from_numpy(a) for a in arrays]
    out = [None] * len(arrays)
    by_dtype = {}
    for i, a in enumerate(arrays):
        by_dtype.setdefault(a.dtype, []).append(i)
    for dt, idx in by_dtype.items():
        align = max(1, 16 // dt.itemsize)
        at = []
        pos = 0
        for i in idx:
            at.append(pos)
            pos += -(-arrays[i].size // align) * align
        host = torch.empty(pos, dtype=torch.from_numpy(np.empty(0, dt)).dtype, pin_memory=True)
        view = host.numpy()
        for i, p in zip(idx, at):
            view[p : p + arrays[i].size] = arrays[i].reshape(-1)
        buf = host.to(device, non_blocking=True)
        for i, p in zip(idx, at):
            out[i] = buf[p : p + arrays[i].size].view(arrays[i].shape)
    return out


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """One small host array on `device`, as to_device_all puts several."""
    return to_device_all([array], device)[0]


def mirror_index(n: int, b: int, device) -> torch.Tensor:
    """Source indices of numpy's mode="symmetric" padding of a length-n
    axis by b on both sides: the edge sample repeats, period 2n."""
    i = torch.arange(-b, n + b, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _pad_mirror(plane, by, bx):
    """Mirror-with-edge-duplication padding of the last two axes (ref
    util/mirror.rs). torch.nn.functional.pad's "reflect" skips the edge
    sample, so the mirror is an index gather."""
    if by == 0 and bx == 0:
        return plane
    h, w = plane.shape[-2:]
    plane = plane.index_select(-2, mirror_index(h, by, plane.device))
    return plane.index_select(-1, mirror_index(w, bx, plane.device))


def gaborish_weights(weight1: float, weight2: float) -> tuple:
    """(center, side, corner) float32 weights, self-normalized."""
    total = 1.0 + weight1 * 4.0 + weight2 * 4.0
    return f32(1.0 / total), f32(weight1 / total), f32(weight2 / total)


def gaborish(plane, weight1: float, weight2: float):
    """3x3 Gabor-like blur, self-normalized (ref stages/gaborish.rs)."""
    w0, w1, w2 = gaborish_weights(weight1, weight2)
    p = _pad_mirror(plane, 1, 1)
    c = p[1:-1, 1:-1]
    side = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    corner = p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]
    return c * w0 + side * w1 + corner * w2


# -- EPF ---------------------------------------------------------------------

_PLUS5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_EPF0_NEIGHBORS = (
    (-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
    (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0),
)
_EPF1_NEIGHBORS = ((-1, 0), (0, -1), (0, 1), (1, 0))


def _sad_mul_mask(h, w, y0, x0, sm, bsm, device):
    """Per-pixel sigma multiplier: bsm on 8x8-block borders (ref epf/common.rs)."""
    ys = (torch.arange(h, device=device) + y0) % BLOCK_DIM
    xs = (torch.arange(w, device=device) + x0) % BLOCK_DIM
    ybord = (ys == 0) | (ys == BLOCK_DIM - 1)
    xbord = (xs == 0) | (xs == BLOCK_DIM - 1)
    border = ybord[:, None] | xbord[None, :]
    return torch.where(
        border,
        torch.tensor(f32(bsm), device=device),
        torch.tensor(f32(sm), device=device),
    )


def _epf_generic(planes, inv_sigma_px, sad_mul, neighbors, sad_pattern, channel_scale, border):
    """Shared EPF machinery: weights from SADs, normalized neighbor blend.

    planes: list of 3 (h, w); inv_sigma_px: per-pixel stored 1/sigma;
    returns filtered planes.
    """
    h, w = planes[0].shape
    padded = [_pad_mirror(p, border, border) for p in planes]

    def at(p, dy, dx):
        return p[border + dy : border + dy + h, border + dx : border + dx + w]

    inv_sigma = inv_sigma_px * sad_mul
    # SAD(n) over a shifted pattern reuses one |I - shift(I, n)| plane per
    # neighbor: the pattern points are shifted views of the same diff
    r = max(max(abs(py), abs(px)) for (py, px) in sad_pattern)
    sads = []
    for (ny, nx) in neighbors:
        sad = None
        for c, p in enumerate(padded):
            a = p[border - r : border + r + h, border - r : border + r + w]
            b = p[
                border - r + ny : border + r + ny + h,
                border - r + nx : border + r + nx + w,
            ]
            diff = (a - b).abs()
            s = None
            for (py, px) in sad_pattern:
                d = diff[r + py : r + py + h, r + px : r + px + w]
                s = d if s is None else s + d
            term = s * f32(channel_scale[c])
            sad = term if sad is None else sad + term
        sads.append(sad)

    weights = [(s * inv_sigma + 1.0).clamp_min(0.0) for s in sads]
    total = weights[0]
    for wgt in weights[1:]:
        total = total + wgt
    wsum = total + 1.0
    out = []
    passthrough = inv_sigma_px < f32(MIN_SIGMA)
    for p in padded:
        acc = at(p, 0, 0)
        for wgt, (ny, nx) in zip(weights, neighbors):
            acc = acc + wgt * at(p, ny, nx)
        filtered = acc / wsum
        out.append(torch.where(passthrough, at(p, 0, 0), filtered))
    return out


def epf_step_params(frame_rf, step: int):
    """(neighbors, sad pattern, border, sm, bsm) of EPF iteration `step`,
    with the sigma multipliers computed in double as the reference does."""
    if step == 0:
        sigma_scale = frame_rf.epf_pass0_sigma_scale
        neighbors, pattern, border = _EPF0_NEIGHBORS, _PLUS5, 3
    elif step == 1:
        sigma_scale = 1.0
        neighbors, pattern, border = _EPF1_NEIGHBORS, _PLUS5, 2
    else:
        sigma_scale = frame_rf.epf_pass2_sigma_scale
        neighbors, pattern, border = _EPF1_NEIGHBORS, ((0, 0),), 1
    sm = sigma_scale * 1.65
    bsm = sm * frame_rf.epf_border_sad_mul
    return neighbors, pattern, border, sm, bsm


def epf_step_px(planes, inv_sigma_px, frame_rf, step: int, pos=(0, 0)):
    """EPF iteration `step` in {0,1,2} with a per-pixel 1/sigma map (ref
    stages/epf/epf{0,1,2}.rs)."""
    h, w = planes[0].shape
    neighbors, pattern, border, sm, bsm = epf_step_params(frame_rf, step)
    sad_mul = _sad_mul_mask(h, w, pos[1], pos[0], sm, bsm, planes[0].device)
    return _epf_generic(
        planes, inv_sigma_px, sad_mul, neighbors, pattern,
        frame_rf.epf_channel_scale, border,
    )


def compute_sigma_image(frame) -> np.ndarray:
    """A VarDCT frame's per-block stored 1/sigma, (bh, bw) float32 numpy
    (ref features/epf.rs SigmaSource)."""
    rf = frame.header.restoration_filter
    hf = frame.hf_meta
    quant_scale = 1.0 / frame.lf_global.quant_params.inv_global_scale
    raw_quant = hf["raw_quant"].astype(np.float32)
    sigma_quant = rf.epf_quant_mul / (quant_scale * raw_quant * INV_SIGMA_NUM)
    sigma = sigma_quant * np.array(rf.epf_sharp_lut, dtype=np.float32)[hf["epf"]]
    sigma = np.minimum(sigma, -1e-4)
    return (1.0 / sigma).astype(np.float32)


def _expand_sigma(sigma_block, h, w, pos):
    x0, y0 = pos
    by0 = y0 // BLOCK_DIM
    bx0 = x0 // BLOCK_DIM
    nby = -(-(y0 + h) // BLOCK_DIM) - by0
    nbx = -(-(x0 + w) // BLOCK_DIM) - bx0
    blk = sigma_block[by0 : by0 + nby, bx0 : bx0 + nbx]
    px = blk.repeat_interleave(BLOCK_DIM, 0).repeat_interleave(BLOCK_DIM, 1)
    oy = y0 - by0 * BLOCK_DIM
    ox = x0 - bx0 * BLOCK_DIM
    return px[oy : oy + h, ox : ox + w]


# -- chroma upsampling ----------------------------------------------------------


def chroma_upsample_h(plane):
    """Horizontal 2x (ref stages/chroma_upsample.rs:9): each sample gives
    the pair (0.25 left + 0.75 cur, 0.75 cur + 0.25 right) of the
    mirror-padded plane."""
    p = _pad_mirror(plane, 0, 1)
    cur = p[:, 1:-1]
    left = p[:, :-2] * f32(0.25) + cur * f32(0.75)
    right = p[:, 2:] * f32(0.25) + cur * f32(0.75)
    h, w = plane.shape
    return torch.stack([left, right], dim=-1).reshape(h, 2 * w)


def chroma_upsample_v(plane):
    """Vertical 2x (ref stages/chroma_upsample.rs:87), the same stencil
    down the columns."""
    p = _pad_mirror(plane, 1, 0)
    cur = p[1:-1, :]
    up = p[:-2, :] * f32(0.25) + cur * f32(0.75)
    down = p[2:, :] * f32(0.25) + cur * f32(0.75)
    h, w = plane.shape
    return torch.stack([up, down], dim=1).reshape(2 * h, w)


# -- N-x upsampling --------------------------------------------------------------


def build_upsample_kernels(weights, n: int) -> np.ndarray:
    """(N, N, 5, 5) kernels from packed triangular weights (ref upsample.rs)."""
    kernel = np.zeros((n, n, 5, 5), dtype=np.float32)
    half = n // 2
    for i in range(5 * half):
        for j in range(5 * half):
            y, x = min(i, j), max(i, j)
            index = 5 * half * y - y * (y - 1) // 2 + x - y
            v = weights[index]
            kernel[j // 5, i // 5, j % 5, i % 5] = v
            kernel[(n - 1) - j // 5, i // 5, 4 - (j % 5), i % 5] = v
            kernel[j // 5, (n - 1) - i // 5, j % 5, 4 - (i % 5)] = v
            kernel[(n - 1) - j // 5, (n - 1) - i // 5, 4 - (j % 5), 4 - (i % 5)] = v
    return kernel


def upsample(plane, kernels: np.ndarray, n: int):
    """N-x upsampling: per-output-phase 5x5 conv of the mirror-padded
    plane, clamped to the local 5x5 min/max (ref upsample.rs). The 25
    shifted views are stacked, (5, 5, h, w) floats, and every phase is one
    contraction with its kernel."""
    h, w = plane.shape
    p = _pad_mirror(plane, 2, 2)
    stack = torch.stack([p[dy : dy + h, dx : dx + w] for dy in range(5) for dx in range(5)])
    stack = stack.reshape(5, 5, h, w)
    mins = stack.amin(dim=(0, 1))
    maxs = stack.amax(dim=(0, 1))
    k = to_device(kernels, plane.device)
    acc = torch.einsum("abij,ijhw->abhw", k, stack)
    acc = torch.minimum(torch.maximum(acc, mins), maxs)
    return acc.permute(2, 0, 3, 1).reshape(h * n, w * n)


# -- output pixel-format conversion ------------------------------------------------

_DITHER = None


def dither_table() -> np.ndarray:
    """32x32 blue-noise dither pattern (public data from
    momentsingraphics.de/BlueNoise.html, as used by ref convert.rs:14-18)."""
    global _DITHER
    if _DITHER is None:
        _DITHER = np.load(os.path.join(os.path.dirname(__file__), "dither_table.npy"))
    return _DITHER


def f32_to_u8(plane, bit_depth: int = 8, channel: int = 0, pos=(0, 0), native: bool = False):
    """ConvertF32ToU8: scale, blue-noise dither, clamp, round
    (ref stages/convert.rs:549-607). torch.round rounds half to even, as
    np.round does. A stack of planes (..., h, w) takes the same dither
    tile on each. native (the host render route): a 2-D float32 plane on
    the CPU goes through the native one-pass dither
    (native/__init__.py:dither_u8_native, ref jxl_tpu/render/stages/
    core.py:262-285), the same values."""
    h, w = plane.shape[-2:]
    dev = plane.device
    maxv = f32((1 << bit_depth) - 1)
    if native and dev.type == "cpu" and plane.ndim == 2 and plane.dtype == torch.float32:
        from ... import native as nat

        out = nat.dither_u8_native(plane, dither_table(), (pos[1] + 13 * channel) % 32,
                                   (pos[0] + 23 * channel) % 32, maxv)
        if out is not None:
            return torch.from_numpy(out)
    tab = to_device(dither_table().reshape(-1), dev)
    ys = (torch.arange(h, device=dev) + (pos[1] + 13 * channel)) % 32
    xs = (torch.arange(w, device=dev) + (pos[0] + 23 * channel)) % 32
    dith = tab[ys[:, None] * 32 + xs[None, :]]
    out = (plane * maxv + dith).clamp(0.0, maxv)
    return torch.round(out).to(torch.uint8)


def f32_to_u16(plane, bit_depth: int = 16):
    """ConvertF32ToU16: clamp to [0,1], scale, round (ref convert.rs:738-760).
    torch has no uint16 arithmetic on every device, so the result is held
    in int32 and then narrowed."""
    maxv = f32((1 << bit_depth) - 1)
    out = plane.clamp(0.0, 1.0) * maxv
    return torch.round(out).to(torch.int32).to(torch.uint16)


def f32_to_f16(plane):
    """ConvertF32ToF16 with clamp to the f16 range (ref convert.rs:790-)."""
    lim = 65504.0
    return plane.clamp(-lim, lim).to(torch.float16)


def convert_output(plane, fmt: str, channel: int = 0, bit_depth: int | None = None,
                   pos=(0, 0), native: bool = False):
    """The plane in output format `fmt`. pos: the (x, y) of the plane's
    first sample in the image, where the u8 dither tile starts (a band of
    the banded decode gives its first row). native: f32_to_u8's."""
    if fmt == "f32":
        return plane
    if fmt == "u8":
        return f32_to_u8(plane, bit_depth or 8, channel, pos, native)
    if fmt == "u16":
        return f32_to_u16(plane, bit_depth or 16)
    if fmt == "f16":
        return f32_to_f16(plane)
    raise ValueError(f"unknown pixel format {fmt!r}")
