"""Filters + colour transform + output conversion as one pass on the
caller's device.

The JAX package meant its whole-frame route to run this (ref
jxl_tpu/render/device_filters.py:run_filters_and_color): gaborish + EPF,
the XYB/YCbCr -> display colour transform and the ConvertF32To* output
stage with a single upload and a single download per frame. Here the
filter chain is the hand-written kernel of ops/epf_gab.py whenever the
planes lie on the card, and its plain torch version on the CPU.
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


def run_filters_and_color(frame, planes, sigma_block, constant_sigma, out_format: str = "f32"):
    """planes: (3, H, W) float32 on the caller's device, already cropped to
    the visible frame. sigma_block: a VarDCT frame's (bh, bw) per-block
    stored 1/sigma on the same device, expanded here to one value a pixel
    (ref device_filters.py:110-116); else constant_sigma, a Modular
    frame's constant stored 1/sigma (ref render/simple.py:213-217). Both
    None without EPF. Returns (3, H, W) in the output sample type, on the
    same device."""
    rf = frame.header.restoration_filter
    gab_weights = _gab_key(rf)
    epf_iters = int(rf.epf_iters)
    if gab_weights is not None or epf_iters > 0:
        h, w = planes.shape[1:]
        if epf_iters > 0 and sigma_block is not None:
            inv_sigma = st._expand_sigma(sigma_block, h, w, (0, 0)).contiguous()
        else:
            inv_sigma = torch.full(
                (h, w), st.f32(constant_sigma if epf_iters > 0 else 0.0),
                dtype=torch.float32, device=planes.device,
            )
        planes = epf_gab(
            planes.contiguous(), inv_sigma, gab_weights, epf_iters,
            rf.epf_pass0_sigma_scale, rf.epf_pass2_sigma_scale,
            rf.epf_border_sad_mul, tuple(rf.epf_channel_scale),
        )
    from .simple import color_transform

    chans = color_transform(frame, [planes[0], planes[1], planes[2]])
    if out_format != "f32":
        chans = [st.convert_output(c, out_format, channel=i) for i, c in enumerate(chans)]
    return torch.stack(chans)
