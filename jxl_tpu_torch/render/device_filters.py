"""The restoration filters (gaborish + EPF) on the caller's device.

Counterpart of the filter half of jxl_tpu/render/device_filters.py:
run_filters_and_color. Here the filter chain is the hand-written kernel
of ops/epf_gab.py whenever the planes lie on the card, and its plain
torch version on the CPU. render/span_exec.py runs it for the run of
filter stages of every frame, on the coded-size planes, before the
frame's other stages (upsampling, noise, colour, output conversion).
This differs from jxl_tpu on purpose: there a frame with feature stages
runs gaborish and EPF as plain jnp stage bodies inside the span
(jxl_tpu/render/simple.py:223-234), where the port launches the kernel
for every frame.
"""

from __future__ import annotations

import torch

from ..ops.epf_gab import epf_gab
from .stages import core as st


def _gab_key(rf):
    if not rf.gab:
        return None
    return (
        (float(rf.gab_x_weight1), float(rf.gab_x_weight2)),
        (float(rf.gab_y_weight1), float(rf.gab_y_weight2)),
        (float(rf.gab_b_weight1), float(rf.gab_b_weight2)),
    )


def run_filters(frame, planes, y0: int = 0, sigma=None, x0: int = 0):
    """Gaborish + EPF of the frame on planes, a (3, H, W) float32 tensor
    already cropped to the coded frame's width, holding its rows [y0, y0 +
    H) and columns [x0, x0 + W): the whole frame by default, the halo slab
    of a band of the banded decode (render/device_band_filters.py), or
    the halo slab of a rank's tile of the sharded decode
    (parallel/sharded_render.py). y0 and x0 are multiples of 8, so that
    the slab's 8x8 block grid is the frame's. One launch of the kernel on
    the card, its plain version on the CPU; both mirror at the planes'
    edges. EPF's 1/sigma is a VarDCT frame's per-block image, its rows
    and columns for the planes uploaded and expanded here to one value a
    pixel (ref device_filters.py:110-116), or a Modular frame's constant
    (ref render/simple.py:213-217). sigma: render/pipeline.py:
    sigma_source(frame), when the caller filters the frame more than
    once; else made here. Returns the planes unchanged when the frame has
    no filter."""
    from .pipeline import sigma_source

    rf = frame.header.restoration_filter
    if not rf.gab and int(rf.epf_iters) == 0:
        return planes
    if y0 % st.BLOCK_DIM or x0 % st.BLOCK_DIM:
        raise ValueError(f"filtered planes must start on the block grid, not at {(x0, y0)}")
    h, w = planes.shape[1:]
    sigma_block, constant_sigma = sigma_source(frame) if sigma is None else sigma
    if sigma_block is not None:
        by0, bx0 = y0 // st.BLOCK_DIM, x0 // st.BLOCK_DIM
        sigma_block = st.to_device(
            sigma_block[by0 : -(-(y0 + h) // st.BLOCK_DIM), bx0 : -(-(x0 + w) // st.BLOCK_DIM)],
            planes.device)
        inv_sigma = st._expand_sigma(sigma_block, h, w, (0, 0)).contiguous()
    else:
        inv_sigma = torch.full(
            (h, w), st.f32(constant_sigma if rf.epf_iters > 0 else 0.0),
            dtype=torch.float32, device=planes.device,
        )
    return filter_planes(frame, planes, inv_sigma)


def filter_planes(frame, planes, inv_sigma):
    """Gaborish + EPF of the frame (its restoration filter's weights and
    steps) on (3, H, W) float32 planes with a per-pixel (H, W) 1/sigma:
    one launch of K1 on the card, its plain version on the CPU. Returns
    the planes unchanged when the frame has no filter."""
    rf = frame.header.restoration_filter
    gab_weights = _gab_key(rf)
    epf_iters = int(rf.epf_iters)
    if gab_weights is None and epf_iters == 0:
        return planes
    return epf_gab(
        planes.contiguous(), inv_sigma.contiguous(), gab_weights, epf_iters,
        rf.epf_pass0_sigma_scale, rf.epf_pass2_sigma_scale,
        rf.epf_border_sad_mul, tuple(rf.epf_channel_scale),
    )
