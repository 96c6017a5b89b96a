"""Batched inverse VarDCT transforms in torch: (N, ...) blocks of one type
at a time, on the blocks' device.

The torch counterpart of jxl_tpu/vardct/transforms_batch.py: the math of
transforms.py (the per-block numpy oracle) over a leading batch axis, as
float32 matrix products. TF32 stays off (the package sets it at import),
so the products keep full float32 on the card. The 4:4:4 render runs
these only on the CPU, as K5's plain version (ops/vardct_blocks.py); the
chroma-subsampled render runs them on either device, the host render
route on the host.

A block's result must not depend on how many blocks share the call: the
banded decode (vardct/device_band.py) renders a group row's blocks where
the whole-frame render takes the frame's, and both must give the same
pixels. cuBLAS picks its kernel by the product's shape, and a band's 8x8
products then rounded an ulp or two apart from the frame's (measured on
the H100, PERF.md). The CPU's batched products do the same: a call of
one to three blocks of nine types (DCT8X32, DCT16X32, DCT32X64, AFV0-3
among them) rounds apart from the same blocks in a larger call. So
transform_to_pixels_batch runs the blocks in chunks of a fixed count a
type, CHUNK_PIXELS pixels on the card and CPU_CHUNK_PIXELS on the CPU
(or one block), and pads the last chunk with zero blocks: every product
of a type has one shape on a device, whatever the batch. The chunks also
bound the products' temporaries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..render.stages.core import to_device
from ._afv_basis import AFV4X4BASIS
from .transform_map import HfTransformType as T
from .transforms import coeff_storage_shape, dct_matrix, dct_scales, idct_matrix, pixel_shape

_AFV_BASIS = np.array(AFV4X4BASIS, dtype=np.float32).reshape(16, 16)
# pixels a chunk of transform_to_pixels_batch: 4 MB of float32 a product
# on the card; on the CPU, where a small frame's every type pays one
# padded chunk, 64 KB
CHUNK_PIXELS = 1 << 20
CPU_CHUNK_PIXELS = 1 << 14
# the host render route's chunks (padded=False): 1 MB of float32 a product
HOST_CHUNK_PIXELS = 1 << 18
_CONST: dict = {}


def _const(name: str, n: int, device) -> torch.Tensor:
    """A float32 constant matrix of transforms.py on `device`, cached."""
    key = (name, n, str(device))
    m = _CONST.get(key)
    if m is None:
        src = {
            "idct": idct_matrix, "dct": dct_matrix, "scales": dct_scales,
            "afv": lambda _: _AFV_BASIS,
        }[name](n)
        m = to_device(np.ascontiguousarray(src, dtype=np.float32), device)
        _CONST[key] = m
    return m


def idct2d_batch(coeffs, rows: int, cols: int):
    """(N, rows*cols) flat coefficient buffers -> (N, rows, cols) pixels."""
    n = coeffs.shape[0]
    if rows < cols:
        t = coeffs.reshape(n, rows, cols).transpose(1, 2)
    else:
        t = coeffs.reshape(n, cols, rows)
    a1 = _const("idct", t.shape[1], coeffs.device)
    a2 = _const("idct", t.shape[2], coeffs.device)
    s1 = torch.matmul(a1, t)  # (n, d1, d2)
    return torch.matmul(a2, s1.transpose(1, 2))  # (n, d2, d1)


def reinterpreting_dct_batch(lf):
    """(N, a, b) LF tiles -> (N, min, max) scaled DCT coefficients."""
    _, a, b = lf.shape
    dev = lf.device
    d1 = torch.matmul(_const("dct", a, dev), lf)  # (n, a, b)
    d2 = torch.matmul(d1, _const("dct", b, dev).T).transpose(1, 2)  # (n, b, a)
    if a < b:
        return d2.transpose(1, 2) / (
            _const("scales", a, dev)[None, :, None] * _const("scales", b, dev)[None, None, :]
        )
    return d2 / (_const("scales", b, dev)[None, :, None] * _const("scales", a, dev)[None, None, :])


def _idct4_sq_batch(c):
    """(N, 4, 4) coefficients -> (N, 4, 4) pixels (slow_idct2d square)."""
    a = _const("idct", 4, c.device)
    return torch.matmul(a, torch.matmul(a, c).transpose(1, 2))


def _idct2_top_block_batch(s, block):
    out = block.clone()
    n = s // 2
    c00 = block[:, :n, :n]
    c01 = block[:, :n, n : 2 * n]
    c10 = block[:, n : 2 * n, :n]
    c11 = block[:, n : 2 * n, n : 2 * n]
    out[:, 0 : 2 * n : 2, 0 : 2 * n : 2] = c00 + c01 + c10 + c11
    out[:, 0 : 2 * n : 2, 1 : 2 * n : 2] = c00 + c01 - c10 - c11
    out[:, 1 : 2 * n : 2, 0 : 2 * n : 2] = c00 - c01 + c10 - c11
    out[:, 1 : 2 * n : 2, 1 : 2 * n : 2] = c00 - c01 - c10 + c11
    return out


def _with_dc(c, dc):
    """A copy of `c` (N, h, w) with [:, 0, 0] replaced by `dc` (N,)."""
    c = c.clone()
    c[:, 0, 0] = dc
    return c


def transform_to_pixels_batch(t: int, lf, coeffs, padded: bool = True):
    """Batched inverse transform for one type.

    lf: (N, cy, cx) float32; coeffs: (N, num_coeffs) float32 (dequantized),
    both on one device. Returns (N, rows, cols) pixels on that device,
    each block's the same whatever N (module docstring). padded=False (the
    host render route, whose pixels no other render must equal bit for
    bit): chunks of HOST_CHUNK_PIXELS, the last one not padded, so a type
    of a few blocks costs a few blocks' work."""
    n = coeffs.shape[0]
    rows, cols = pixel_shape(t)
    if not padded:
        chunk = HOST_CHUNK_PIXELS
    else:
        chunk = CHUNK_PIXELS if coeffs.device.type == "cuda" else CPU_CHUNK_PIXELS
    size = max(1, chunk // (rows * cols))
    if n == size or (not padded and n <= size):
        return _transform_chunk(t, lf, coeffs)
    out = torch.empty((n, rows, cols), dtype=torch.float32, device=coeffs.device)
    for i in range(0, n, size):
        m = min(size, n - i)
        lf_c, co_c = lf[i : i + m], coeffs[i : i + m]
        if m < size and padded:
            lf_c = torch.nn.functional.pad(lf_c, (0, 0, 0, 0, 0, size - m))
            co_c = torch.nn.functional.pad(co_c, (0, 0, 0, size - m))
        out[i : i + m] = _transform_chunk(t, lf_c, co_c)[:m]
    return out


def _transform_chunk(t: int, lf, coeffs):
    n = coeffs.shape[0]
    rows, cols = pixel_shape(t)

    if t == T.DCT:
        buf = coeffs.clone()
        buf[:, 0] = lf[:, 0, 0]
        return idct2d_batch(buf, 8, 8)

    if t in (T.AFV0, T.AFV1, T.AFV2, T.AFV3):
        return _afv_batch(int(t) - int(T.AFV0), lf, coeffs)

    if t in (T.IDENTITY, T.DCT2X2, T.DCT4X4, T.DCT8X4, T.DCT4X8):
        c = _with_dc(coeffs.reshape(n, 8, 8), lf[:, 0, 0])
        if t == T.DCT2X2:
            c = _idct2_top_block_batch(2, c)
            c = _idct2_top_block_batch(4, c)
            return _idct2_top_block_batch(8, c)
        if t == T.DCT4X4:
            dcs = _corner_dcs4(c)
            quads = [
                [_idct4_sq_batch(_with_dc(c[:, y::2, x::2], dcs[y * 2 + x])) for x in range(2)]
                for y in range(2)
            ]
            top = torch.cat([quads[0][0], quads[0][1]], dim=2)
            bottom = torch.cat([quads[1][0], quads[1][1]], dim=2)
            return torch.cat([top, bottom], dim=1)
        if t in (T.DCT8X4, T.DCT4X8):
            dcs = [c[:, 0, 0] + c[:, 1, 0], c[:, 0, 0] - c[:, 1, 0]]
            outs = []
            for k in range(2):
                blk = _with_dc(c[:, k::2, :], dcs[k]).reshape(n, 32)
                outs.append(idct2d_batch(blk, 8, 4) if t == T.DCT8X4 else idct2d_batch(blk, 4, 8))
            return torch.cat(outs, dim=2 if t == T.DCT8X4 else 1)
        return _identity_batch(c, n)

    # general large DCT with reinterpreting LF
    srows, scols = coeff_storage_shape(t)
    buf = coeffs.reshape(n, srows, scols).clone()
    lfc = reinterpreting_dct_batch(lf.float())
    buf[:, : lfc.shape[1], : lfc.shape[2]] = lfc
    return idct2d_batch(buf.reshape(n, srows * scols), rows, cols)


def _corner_dcs4(c):
    b00, b01, b10, b11 = c[:, 0, 0], c[:, 0, 1], c[:, 1, 0], c[:, 1, 1]
    return [b00 + b01 + b10 + b11, b00 + b01 - b10 - b11,
            b00 - b01 + b10 - b11, b00 - b01 - b10 + b11]


def _identity_batch(c, n):
    """Batched Hornuss (ref transform.rs:528-569)."""
    dcs = _corner_dcs4(c)
    out = torch.zeros((n, 8, 8), dtype=c.dtype, device=c.device)
    for y in range(2):
        for x in range(2):
            block_dc = dcs[y * 2 + x]
            rs = None
            for iy in range(4):
                for ix in range(4):
                    if ix == 0 and iy == 0:
                        continue
                    v = c[:, y + iy * 2, x + ix * 2]
                    rs = v if rs is None else rs + v
            center = block_dc - rs * np.float32(1.0 / 16.0)
            out[:, y * 4 : y * 4 + 4, x * 4 : x * 4 + 4] = c[:, y::2, x::2] + center[:, None, None]
            out[:, 4 * y + 1, 4 * x + 1] = center
            out[:, y * 4, x * 4] = c[:, y + 2, x + 2] + center
    return out


def _afv_batch(afv_kind, lf, coeffs):
    n = coeffs.shape[0]
    c = _with_dc(coeffs.reshape(n, 8, 8), lf[:, 0, 0])
    afv_x = afv_kind & 1
    afv_y = afv_kind // 2
    b00, b01, b10 = c[:, 0, 0], c[:, 0, 1], c[:, 1, 0]
    dcs = [(b00 + b10 + b01) * 4.0, b00 + b10 - b01, b00 - b10]

    pixels = torch.zeros((n, 8, 8), dtype=coeffs.dtype, device=coeffs.device)
    cc = _with_dc(c[:, 0:8:2, 0:8:2], dcs[0])
    block = torch.matmul(cc.reshape(n, 16), _const("afv", 16, c.device)).reshape(n, 4, 4)
    if afv_y == 1:
        block = block.flip(1)
    if afv_x == 1:
        block = block.flip(2)
    pixels[:, afv_y * 4 : afv_y * 4 + 4, afv_x * 4 : afv_x * 4 + 4] = block

    cd = _with_dc(c[:, 0:8:2, 1:8:2], dcs[1])
    x0 = (1 - afv_x) * 4
    pixels[:, afv_y * 4 : afv_y * 4 + 4, x0 : x0 + 4] = _idct4_sq_batch(cd)

    ce = _with_dc(c[:, 1:8:2, :], dcs[2])
    y0 = (1 - afv_y) * 4
    pixels[:, y0 : y0 + 4, :] = idct2d_batch(ce.reshape(n, 32), 4, 8)
    return pixels
