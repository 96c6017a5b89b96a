"""The synthetic per-frame pixel program and the batched 8x8 transforms.

Counterpart of jxl_tpu/ops/device_render.py. There `render_block` is one
jitted XLA program: gaborish and EPF through the stage math with a
block-resolution 1/sigma and a block phase `pos`, then XYB -> linear ->
sRGB. Here the filter chain is kernel K1 (ops/epf_gab.py: the
hand-written CUDA kernel on the card, its plain torch version on the CPU)
and the colour math plain torch ops on the planes' device. K1 reads a
pixel's 8x8 block phase from its place in the planes, so `pos` must lie on
the block grid: a sharded caller (parallel/sharded_render.py) extends its
shard by whole blocks of real neighbour rows instead of shifting the
phase. `jit_render` is a plain function here; `idct8_batch` and
`dequant_cfl_idct8` are float32 matrix products, as XLA computes them
outside any Pallas kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..render.stages import core as st
from .epf_gab import epf_gab


@dataclass(frozen=True)
class RenderParams:
    """Per-frame render configuration (jxl_tpu's defaults)."""

    gab: bool = True
    gab_weights: tuple = ((0.115169525, 0.061248592),) * 3
    epf_iters: int = 2
    epf_sharp_lut: tuple = (0.0, 1 / 7, 2 / 7, 3 / 7, 4 / 7, 5 / 7, 6 / 7, 1.0)
    epf_channel_scale: tuple = (40.0, 5.0, 3.5)
    epf_pass0_sigma_scale: float = 0.9
    epf_pass2_sigma_scale: float = 6.5
    epf_border_sad_mul: float = 2.0 / 3.0
    intensity_target: float = 255.0
    opsin_inverse_matrix: tuple = (
        11.031566901960783, -9.866943921568629, -0.16462299647058826,
        -3.254147380392157, 4.418770392156863, -0.16462299647058826,
        -3.6588512862745097, 2.7129230470588235, 1.9459282392156863,
    )
    opsin_biases: tuple = (-0.0037930732552754493,) * 3

    @property
    def inverse_matrix(self):
        return self.opsin_inverse_matrix


def _linear_to_srgb(v):
    a = v.abs()
    out = torch.where(a <= st.f32(0.0031308), a * st.f32(12.92),
                      st.f32(1.055) * torch.pow(a, st.f32(1.0 / 2.4)) - st.f32(0.055))
    return torch.copysign(out, v)


def _xyb_to_linear(x, y, b, params: RenderParams):
    """jxl_tpu's float32 order: the cube of the bias-shifted LMS, scaled,
    then the opsin inverse matrix."""
    mat = np.asarray(params.opsin_inverse_matrix, dtype=np.float32).tolist()
    biases = np.asarray(params.opsin_biases, dtype=np.float32)
    bias_cbrt = np.cbrt(biases).astype(np.float32).tolist()
    scale = np.float32(255.0 / params.intensity_target)
    scaled = (biases * scale).tolist()
    scale = float(scale)
    l = y + x - bias_cbrt[0]
    m = y - x - bias_cbrt[1]
    s = b - bias_cbrt[2]
    l = l * l * (l * scale) + scaled[0]
    m = m * m * (m * scale) + scaled[1]
    s = s * s * (s * scale) + scaled[2]
    r = mat[0] * l + mat[1] * m + mat[2] * s
    g = mat[3] * l + mat[4] * m + mat[5] * s
    bl = mat[6] * l + mat[7] * m + mat[8] * s
    return r, g, bl


def render_block(planes, inv_sigma_block, params: RenderParams, pos=(0, 0)):
    """The per-frame pixel program: (3, H, W) float32 XYB planes ->
    (3, H, W) sRGB, on the planes' device. `inv_sigma_block` is the
    per-8x8-block 1/sigma map; the planes' first pixel lies at pixel `pos`
    (x, y) of it, a multiple of 8 on both axes. Gaborish + EPF run as one
    launch of K1, which mirrors at the planes' edges."""
    x0, y0 = pos
    if x0 % st.BLOCK_DIM or y0 % st.BLOCK_DIM:
        raise ValueError(f"render_block takes planes on the block grid, not at {pos}")
    h, w = planes.shape[1:]
    return _render_px(planes, st._expand_sigma(inv_sigma_block, h, w, pos), params)


def _render_px(planes, inv_sigma, params: RenderParams):
    """render_block with a per-pixel (H, W) 1/sigma."""
    return _to_srgb(_filter_px(planes, inv_sigma, params), params)


def _filter_px(planes, inv_sigma, params: RenderParams):
    """Gaborish + EPF as `params` asks: one launch of K1."""
    if not (params.gab or params.epf_iters):
        return planes
    return epf_gab(planes.contiguous(), inv_sigma.contiguous(),
                   params.gab_weights if params.gab else None,
                   params.epf_iters, params.epf_pass0_sigma_scale,
                   params.epf_pass2_sigma_scale, params.epf_border_sad_mul,
                   params.epf_channel_scale)


def _to_srgb(planes, params: RenderParams):
    """(3, H, W) XYB -> sRGB."""
    r, g, bl = _xyb_to_linear(planes[0], planes[1], planes[2], params)
    return torch.stack([_linear_to_srgb(r), _linear_to_srgb(g), _linear_to_srgb(bl)])


def jit_render(params: RenderParams):
    """render_block with `params` bound (jxl_tpu jits it)."""
    return lambda planes, sigma: render_block(planes, sigma, params)


# -- batched 8x8 IDCT ------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _idct8(device) -> torch.Tensor:
    from ..vardct.transforms import idct_matrix

    return st.to_device(idct_matrix(8), device)


def idct8_batch(coeffs):
    """(N, 8, 8) coefficient blocks -> (N, 8, 8) pixels: A @ C, then A
    applied along the other axis, two batched float32 products."""
    a = _idct8(coeffs.device)
    t1 = torch.matmul(a, coeffs)
    return torch.matmul(a, t1.transpose(1, 2))


def dequant_cfl_idct8(qblocks, dq_mats, scale_y, x_mul, b_mul, x_cc, b_cc, biases, lf):
    """Dequant + chroma from luma + IDCT of DCT8 blocks: qblocks (N, 3, 64)
    int32, dq_mats (3, 64) float32, scale_y, x_mul and b_mul scalars, x_cc
    and b_cc (N,) the blocks' CfL factors, biases the 4 quant biases, lf
    (N, 3) the LF values; returns (N, 3, 8, 8) float32 pixels."""
    dev = qblocks.device
    q = qblocks.to(torch.float32)
    b = torch.as_tensor(np.asarray(biases, dtype=np.float32), device=dev)
    adj = torch.where(qblocks.abs() < 2, q * b[None, :3, None],
                      q - b[3] / torch.where(q == 0, 1.0, q))
    adj = torch.where(qblocks == 0, 0.0, adj)
    scales = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                          for v in (scale_y * x_mul, scale_y, scale_y * b_mul)])
    dq = adj * dq_mats[None] * scales[None, :, None]
    dq[:, 0] += x_cc[:, None] * dq[:, 1]
    dq[:, 2] += b_cc[:, None] * dq[:, 1]
    dq = dq.reshape(-1, 3, 8, 8)
    dq[:, :, 0, 0] = lf
    return torch.stack([idct8_batch(dq[:, c]) for c in range(3)], dim=1)
