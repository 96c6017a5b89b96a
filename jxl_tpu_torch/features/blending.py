"""Blending primitives shared by patches and frame-onto-canvas compositing,
as torch ops on the planes' device.

Counterpart of jxl_tpu/features/blending.py (capability reference:
jxl/src/features/blending.rs perform_blending), in the same operation
order, so that the two agree within float32 rounding. Every mode is
pointwise: the planes may be 2-D rects or the 1-D pixel lists the patch
stage gathers.
"""

from __future__ import annotations

import torch

from ..io.headers import ExtraChannel
from .patches import BlendMode, PatchBlending


def _f32(p):
    return p.to(torch.float32)


def _clamp01(v, clamp):
    return v.clamp(0.0, 1.0) if clamp else v


def _muladd_weight(v):
    """AlphaWeightedAdd weights are clamped to [0, 1] whatever the
    bitstream's clamp flag (jxl_tpu/features/blending.py:_muladd_weight,
    bit-exact against libjxl on blendmodes.jxl)."""
    return v.clamp(0.0, 1.0)


def _safe_recip(new_a):
    return torch.where(new_a > 0.0, 1.0 / torch.where(new_a == 0, 1.0, new_a), 0.0)


def perform_blending(bg, fg, color_blending: PatchBlending, ec_blending, extra_channel_info):
    """Blend fg onto bg (lists of same-shape planes: 3 colour + num_ec
    extra channels) and return the new planes (a list; no input is
    written). ref blending.rs:200-459."""
    num_ec = len(extra_channel_info)
    out = [_f32(p) for p in bg]

    if color_blending.mode == BlendMode.NONE and all(
        b.mode == BlendMode.NONE for b in ec_blending
    ):
        return out

    if color_blending.mode == BlendMode.REPLACE and all(
        b.mode in (BlendMode.REPLACE, BlendMode.NONE) for b in ec_blending
    ):
        for c in range(3):
            out[c] = _f32(fg[c])
        for i, b in enumerate(ec_blending):
            if b.mode == BlendMode.REPLACE:
                out[3 + i] = _f32(fg[3 + i])
        return out

    has_alpha = any(info.ec_type == ExtraChannel.ALPHA for info in extra_channel_info)
    old_ec = [_f32(bg[3 + i]) for i in range(num_ec)]

    # extra channels first (ref order)
    for i, b in enumerate(ec_blending):
        alpha = b.alpha_channel
        clamp = b.clamp
        assoc = extra_channel_info[alpha].alpha_associated if num_ec else False
        eo = out[3 + i]
        fgi = _f32(fg[3 + i])
        if b.mode == BlendMode.ADD:
            out[3 + i] = eo + fgi
        elif b.mode == BlendMode.BLEND_ABOVE:
            if i == alpha:
                ta = _clamp01(fgi, clamp)
                out[3 + i] = 1.0 - (1.0 - ta) * (1.0 - eo)
            elif assoc:
                fa = _clamp01(_f32(fg[3 + alpha]), clamp)
                out[3 + i] = fgi + eo * (1.0 - fa)
            else:
                fa = _clamp01(_f32(fg[3 + alpha]), clamp)
                oa = old_ec[alpha]
                new_a = 1.0 - (1.0 - fa) * (1.0 - oa)
                out[3 + i] = (fgi * fa + eo * oa * (1.0 - fa)) * _safe_recip(new_a)
        elif b.mode == BlendMode.BLEND_BELOW:
            if i == alpha:
                ta = _clamp01(eo, clamp)
                out[3 + i] = 1.0 - (1.0 - ta) * (1.0 - fgi)
            elif assoc:
                ba = _clamp01(old_ec[alpha], clamp)
                out[3 + i] = eo + fgi * (1.0 - ba)
            else:
                ba = _clamp01(old_ec[alpha], clamp)
                fa = _f32(fg[3 + alpha])
                new_a = 1.0 - (1.0 - ba) * (1.0 - fa)
                out[3 + i] = (eo * ba + fgi * fa * (1.0 - ba)) * _safe_recip(new_a)
        elif b.mode == BlendMode.ALPHA_WEIGHTED_ADD_ABOVE:
            if i != alpha:
                out[3 + i] = eo + fgi * _muladd_weight(_f32(fg[3 + alpha]))
        elif b.mode == BlendMode.ALPHA_WEIGHTED_ADD_BELOW:
            if i == alpha:
                out[3 + i] = fgi
            else:
                out[3 + i] = fgi + eo * _muladd_weight(old_ec[alpha])
        elif b.mode == BlendMode.MUL:
            out[3 + i] = eo * _clamp01(fgi, clamp)
        elif b.mode == BlendMode.REPLACE:
            out[3 + i] = fgi

    alpha = color_blending.alpha_channel
    clamp = color_blending.clamp
    mode = color_blending.mode
    if mode == BlendMode.ADD:
        for c in range(3):
            out[c] = out[c] + fg[c]
    elif mode == BlendMode.ALPHA_WEIGHTED_ADD_ABOVE:
        for c in range(3):
            if not has_alpha:
                out[c] = out[c] + fg[c]
            else:
                out[c] = out[c] + fg[c] * _muladd_weight(_f32(fg[3 + alpha]))
    elif mode == BlendMode.ALPHA_WEIGHTED_ADD_BELOW:
        for c in range(3):
            if not has_alpha:
                out[c] = out[c] + fg[c]
            else:
                out[c] = fg[c] + out[c] * _muladd_weight(old_ec[alpha])
    elif mode == BlendMode.BLEND_ABOVE:
        if not has_alpha:
            for c in range(3):
                out[c] = _f32(fg[c])
        else:
            _blend_color(out, fg, old_ec[alpha], clamp,
                         extra_channel_info[alpha].alpha_associated, True, alpha)
    elif mode == BlendMode.BLEND_BELOW:
        if has_alpha:
            _blend_color(out, fg, old_ec[alpha], clamp,
                         extra_channel_info[alpha].alpha_associated, False, alpha)
    elif mode == BlendMode.MUL:
        for c in range(3):
            out[c] = out[c] * _clamp01(_f32(fg[c]), clamp)
    elif mode == BlendMode.REPLACE:
        for c in range(3):
            out[c] = _f32(fg[c])
    return out


def _blend_color(out, fg, bg_alpha_old, clamp, assoc, fg_on_top, alpha):
    """ref blending.rs blend_impl: the top layer's alpha drives the blend;
    also updates the alpha channel itself (out[3 + alpha])."""
    fga = _f32(fg[3 + alpha])
    if fg_on_top:
        top_a = _clamp01(fga, clamp)
        bottom_a = bg_alpha_old
    else:
        top_a = _clamp01(bg_alpha_old, clamp)
        bottom_a = fga
    one_minus = 1.0 - top_a
    new_a = 1.0 - one_minus * (1.0 - bottom_a)
    r = _safe_recip(new_a)
    for c in range(3):
        bgv = out[c]
        fgv = _f32(fg[c])
        top_c, bottom_c = (fgv, bgv) if fg_on_top else (bgv, fgv)
        if assoc:
            out[c] = top_c + bottom_c * one_minus
        else:
            out[c] = (top_c * top_a + bottom_c * bottom_a * one_minus) * r
    out[3 + alpha] = new_a
