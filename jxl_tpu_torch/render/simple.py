"""Whole-frame render: channel planes -> display samples, on the caller's
device.

Counterpart of jxl_tpu/render/simple.py for this package's slice: the
VarDCT planes (vardct/device_frame.py, from the dense AC coefficients;
chroma-subsampled planes at their own sizes) or the Modular-to-float
conversion (with the XYB channel order and scaling), each extra channel at
its own bit depth, the stage assembly of render/pipeline.py, then the
stage list (chroma upsampling, the filters, patches, splines,
upsampling, noise, colour transform, output conversion) run by
render/span_exec.py, and the blend of a cropped or blended frame onto
the image canvas (blend_and_extend). Host planes go to the card through
render/stages/core.py:to_device (pinned, without a wait).

A frame on the host render route (frame.render_host, set by
utils/devhealth.py:host_route) renders instead by
render_frame_channels_host, jxl_tpu's host branches of
render_frame_channels_ex (:143-255): the planes made on the host
(vardct/group.py:render_vardct_frame_host, the Modular conversion through
the native scale), the stages run by render/span_exec.py:run_stages_host
(the native filter chain), and the colour transform and output
conversion in the native C++ (colors.cc), on CPU tensors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..color import tf as tfmod
from ..color.xyb import xyb_to_linear, ycbcr_to_rgb
from ..errors import NotSupported
from ..io.headers import TransferFunction
from ..utils import trace
from .stages import core as st


def _from_linear(channels, tf_spec, intensity_target, luminances=None):
    """FromLinear stage on linear channels. `tf_spec` is ("gamma", g) or
    ("enum", TransferFunction); `luminances` are the per-primary luminances
    of the output space (HLG OOTF, ref xyb.rs OutputColorInfo)."""
    kind, val = tf_spec
    if kind == "gamma":
        return [tfmod.linear_to_gamma(c, val) for c in channels]
    tfv = val
    if tfv == TransferFunction.SRGB:
        return [tfmod.linear_to_srgb(c) for c in channels]
    if tfv == TransferFunction.BT709:
        return [tfmod.linear_to_bt709(c) for c in channels]
    if tfv == TransferFunction.LINEAR:
        return list(channels)
    if tfv == TransferFunction.PQ:
        return [tfmod.linear_to_pq(c, intensity_target) for c in channels]
    if tfv == TransferFunction.DCI:
        return [tfmod.linear_to_gamma(c, 1.0 / 2.6) for c in channels]
    if tfv == TransferFunction.HLG:
        lum = luminances or (0.2126, 0.7152, 0.0722)
        r, g, b = tfmod.hlg_display_to_scene(intensity_target, lum, channels)
        return [tfmod.scene_to_hlg(c) for c in (r, g, b)]
    raise NotSupported(f"transfer function {tfv}")


def _modular_to_f32(plane, bit_depth):
    """ConvertModularToF32 (ref stages/convert.rs:345-) on an int32 tensor:
    integer samples are scaled by 1/(2^bits-1); float samples are
    bit-reinterpreted."""
    if bit_depth.floating_point_sample:
        bits = bit_depth.bits_per_sample
        exp = bit_depth.exponent_bits_per_sample
        if bits == 32 and exp == 8:
            return plane.view(torch.float32).clone()
        u = plane.to(torch.int64) & 0xFFFFFFFF
        if bits == 16 and exp == 5:
            h = u & 0xFFFF
            return (h - ((h & 0x8000) << 1)).to(torch.int16).view(torch.float16).float()
        mant_bits = bits - exp - 1
        sign = (u >> (bits - 1)) & 1
        e = (u >> mant_bits) & ((1 << exp) - 1)
        m = u & ((1 << mant_bits) - 1)
        bias = (1 << (exp - 1)) - 1
        out_e = torch.where(e == 0, torch.zeros_like(e), e - bias + 127)
        out = (sign << 31) | (out_e << 23) | (m << (23 - mant_bits))
        return (out - ((out & 0x80000000) << 1)).to(torch.int32).view(torch.float32)
    bits = bit_depth.bits_per_sample
    return plane.to(torch.float32) * st.f32(1.0 / ((1 << bits) - 1))


def frame_planes(frame, device) -> list:
    """The frame's three colour planes, float32 on `device`, in XYB / YCbCr
    / RGB as coded (ref render/simple.py:116-131): each at its channel's
    size, the frame's unless it is chroma-subsampled."""
    mg = frame.lf_global.modular_global
    return modular_color_planes(
        frame, [st.to_device(mg.output_channel(c), device) for c in range(frame.color_channels)])


def modular_color_planes(frame, channels) -> list:
    """Three float32 colour planes from a Modular frame's decoded int32
    colour channels (tensors, as coded, each at its own size): XYB scaled
    by the LF quant factors, else each converted at the image's bit depth,
    a grey channel three times. The banded decode passes a band's rows."""
    meta = frame.file_header.image_metadata
    if meta.xyb_encoded:
        # modular XYB order is [Y, X, B]; B has Y added (ref convert.rs:278)
        sx_f, sy_f, sb_f = frame.lf_global.lf_quant.quant_factors
        iy, ix, ib = (c.to(torch.float32) for c in channels[:3])
        planes = [ix * st.f32(sx_f), iy * st.f32(sy_f), (ib + iy) * st.f32(sb_f)]
    else:
        planes = [_modular_to_f32(c, meta.bit_depth) for c in channels]
        if len(planes) == 1:
            planes = [planes[0], planes[0], planes[0]]
    return planes


def vardct_planes(frame, device, no_ac_groups=()) -> list:
    """A VarDCT frame's three planes (XYB, or Cb, Y, Cr) on `device`, each
    (bh*8 >> vshift, bw*8 >> hshift): the whole frame's size unless the
    frame is chroma-subsampled. From the lane decoder's coefficients
    (already there) or the host decoder's (one dense upload); the lane
    flags are checked after the render is queued (ref
    render/simple.py:108-115, api/frame.py:_finish_device_render,
    :509-513). The groups of `no_ac_groups` (a progressive flush's groups
    with no AC pass yet) take the LF image upsampled 8x instead
    (vardct/lf.py:upsample_lf_groups); before any AC has been decoded the
    coefficients are zeros."""
    from ..vardct.device_frame import (render_vardct_frame_device,
                                       render_vardct_frame_device_subsampled)
    from ..vardct.device_group import check_device_ac_ok
    from ..vardct.group import GROUP_DIM

    flat = frame.device_ac_flat
    if flat is None and frame.host_ac_flat is not None:
        flat = st.to_device(frame.host_ac_flat, device)
    elif flat is None:
        flat = torch.zeros(frame.header.num_groups * 3 * GROUP_DIM * GROUP_DIM,
                           dtype=torch.int32, device=device)
    flat = flat.to(device)
    if frame.header.is444:
        planes = list(render_vardct_frame_device(frame, flat).unbind(0))
    else:
        planes = render_vardct_frame_device_subsampled(frame, flat)
    with trace.span("render.ac_wait"):
        check_device_ac_ok(frame)
    if no_ac_groups:
        from ..vardct.lf import upsample_lf_groups

        planes = upsample_lf_groups(frame, planes, no_ac_groups)
    return planes


def _extra_channel_planes(frame, device) -> list:
    """The frame's extra channels as float32 planes on `device`, each at
    its own bit depth (ref render/simple.py:133-136). The global modular
    image holds them after the colour channels of a Modular frame and
    alone in a VarDCT frame; either way output_channel finds extra channel
    i by its output index 3 + i."""
    meta = frame.file_header.image_metadata
    mg = frame.lf_global.modular_global
    return [
        _modular_to_f32(st.to_device(mg.output_channel(3 + i), device), info.bit_depth)
        for i, info in enumerate(meta.extra_channel_info)
    ]


def _modular_to_f32_host(plane, bit_depth):
    """_modular_to_f32 of a host int32 plane (numpy) on the host route: an
    integer sample scaled through the native one-pass multiply (ref
    jxl_tpu/render/simple.py:80-86), a float sample reinterpreted by the
    torch version on the CPU. Returns a CPU tensor."""
    from .. import native

    if not bit_depth.floating_point_sample:
        scale = float(np.float32(1.0 / ((1 << bit_depth.bits_per_sample) - 1)))
        out = native.i32_to_f32_scaled_native(plane, scale)
        if out is not None:
            return torch.from_numpy(out)
    return _modular_to_f32(torch.from_numpy(np.ascontiguousarray(plane)), bit_depth)


def _modular_planes_host(frame) -> list:
    """A Modular frame's colour planes and extra channels as float32 CPU
    tensors, each its own buffer (the host stages filter them in place)."""
    meta = frame.file_header.image_metadata
    mg = frame.lf_global.modular_global
    if meta.xyb_encoded:
        planes = modular_color_planes(
            frame, [torch.from_numpy(np.asarray(mg.output_channel(c))) for c in range(3)])
    else:
        planes = [_modular_to_f32_host(mg.output_channel(c), meta.bit_depth)
                  for c in range(frame.color_channels)]
        if len(planes) == 1:
            planes = [planes[0], planes[0].clone(), planes[0].clone()]
    return planes + _extra_channels_host(frame)


def _extra_channels_host(frame) -> list:
    """The frame's extra channels as float32 CPU tensors, each at its own
    bit depth (_extra_channel_planes on the host route)."""
    mg = frame.lf_global.modular_global
    return [_modular_to_f32_host(mg.output_channel(3 + i), info.bit_depth)
            for i, info in enumerate(frame.file_header.image_metadata.extra_channel_info)]


def render_frame_channels_host(frame, out_format: str = "f32", timings=None,
                               no_ac_groups=()):
    """render_frame_channels by the host render route (module docstring):
    (planes, color_done, converted), planes CPU tensors, with the same
    stages, colour and output rules. A VarDCT frame renders from its host
    coefficients (host_ac_flat), the groups of `no_ac_groups` from the
    upsampled LF; u8 output of an XYB frame whose transfer curve the
    native colour code knows comes interleaved from one pass
    (color_convert_u8_native), else the colour transform runs in place
    (color_transform_host) and the output conversion dithers natively."""
    from ..io.headers.frame import Encoding, FrameType
    from .pipeline import build_render_pipeline
    from .span_exec import run_stages_host

    header = frame.header
    num_ec = len(frame.file_header.image_metadata.extra_channel_info)
    stages = build_render_pipeline(frame)
    if header.encoding == Encoding.VARDCT:
        from ..vardct.group import render_vardct_frame_host

        chans = [torch.from_numpy(p) for p in render_vardct_frame_host(frame)]
        if no_ac_groups:
            from ..vardct.lf import upsample_lf_groups

            chans = upsample_lf_groups(frame, chans, no_ac_groups)
        chans += _extra_channels_host(frame)
    else:
        chans = _modular_planes_host(frame)
    ctx = {"frame": frame}
    if header.has_noise:
        from ..features.noise import generate_noise_field

        t0 = time.perf_counter()
        ctx["noise_field"] = generate_noise_field(frame)
        if timings is not None:
            timings["noise_field_s"] = timings.get("noise_field_s", 0.0) + time.perf_counter() - t0
    color_done = not (header.frame_type == FrameType.REFERENCE_ONLY
                      or (header.can_be_referenced and header.save_before_ct)
                      or header.lf_level != 0)
    fmt = out_format
    if header.needs_blending() or header.can_be_referenced or num_ec:
        fmt = "f32"
    chans = run_stages_host(stages, chans, ctx)
    converted = False
    if color_done and fmt == "u8":
        u8 = color_convert_u8_native(frame, chans)
        if u8 is not None:
            chans = list(torch.from_numpy(u8).unbind(-1)) + chans[3:]
            converted = True
    if color_done and not converted:
        chans = color_transform_host(frame, chans)
        if fmt != "f32":
            chans[:3] = [st.convert_output(p, fmt, channel=c, native=True)
                         for c, p in enumerate(chans[:3])]
            converted = True
    return chans, color_done, converted


def planes_to(planes, device) -> list:
    """Host planes on `device`: the same list on the CPU, else one copy
    (the planes of one shape and dtype stacked on the host first)."""
    device = torch.device(device)
    if device.type == "cpu":
        return list(planes)
    if len({(tuple(p.shape), p.dtype) for p in planes}) == 1:
        return list(torch.stack(planes).to(device).unbind(0))
    return [p.to(device) for p in planes]


def render_frame_channels(frame, device, out_format: str = "f32", timings=None,
                          no_ac_groups=()):
    """All stages of one frame on `device` (ref jxl_tpu/render/simple.py:
    render_frame_channels_ex, :153-204): (planes, color_done, converted),
    planes a list of 3 + extra channels tensors at the frame's upsampled
    size. The colour transform runs here unless the frame is
    REFERENCE_ONLY, is saved before it or is an LF frame (then the planes
    stay XYB or YCbCr, for the caller to save); the output conversion
    runs here only for a frame that neither blends nor is referenced and
    has no extra channels: every other frame stays float32, and the
    caller converts the canvas after blending, so that the dither pattern
    sits at the image's (0, 0). timings, a dict, gets "noise_field_s", the host seconds of the
    noise field, when the frame has noise. no_ac_groups: the VarDCT groups
    a progressive flush renders from the upsampled LF (vardct_planes)."""
    from ..io.headers.frame import Encoding, FrameType
    from .pipeline import build_render_pipeline, color_transform_stage, convert_output_stage
    from .span_exec import run_span

    if frame.render_host:
        with trace.span("render.host_route"):
            planes, color_done, converted = render_frame_channels_host(
                frame, out_format, timings, no_ac_groups)
            return planes_to(planes, device), color_done, converted
    header = frame.header
    num_ec = len(frame.file_header.image_metadata.extra_channel_info)
    stages = build_render_pipeline(frame)
    if header.encoding == Encoding.VARDCT:
        chans = vardct_planes(frame, device, no_ac_groups)
    else:
        chans = frame_planes(frame, device)
    if num_ec:
        chans += _extra_channel_planes(frame, device)
    ctx = {"frame": frame}
    if header.has_noise:
        from ..features.noise import generate_noise_field

        t0 = time.perf_counter()
        field = generate_noise_field(frame, pin_memory=device.type == "cuda")
        if timings is not None:
            timings["noise_field_s"] = timings.get("noise_field_s", 0.0) + time.perf_counter() - t0
        ctx["noise_field"] = field.to(device, non_blocking=True)
    # an LF frame keeps its planes as coded for the frames that adopt them
    # (ref jxl_tpu/render/simple.py:163, 198)
    color_done = not (header.frame_type == FrameType.REFERENCE_ONLY
                      or (header.can_be_referenced and header.save_before_ct)
                      or header.lf_level != 0)
    fmt = out_format
    if header.needs_blending() or header.can_be_referenced or num_ec:
        fmt = "f32"
    tail = []
    if color_done:
        tail.append(color_transform_stage(frame))
        if fmt != "f32":
            tail.append(convert_output_stage(fmt, (0, 1, 2)))
    with trace.span("render.stages"):
        chans = run_span(stages + tail, chans, ctx)
    return chans, color_done, color_done and fmt != "f32"


def blend_and_extend(frame, planes) -> list:
    """Blending + ExtendToImageDimensions onto the whole image canvas (ref
    jxl_tpu/render/simple.py:365, stages/{blending,extend}.rs), as torch
    ops on the planes' device: each channel's canvas is a copy of its
    source slot (colour and each extra channel name their own), or zeros;
    the frame rect, whose x0 and y0 may be negative, is intersected with
    the image, and there the frame's pixels (bg) blend with the canvas
    (fg) by the frame's mode. Returns the canvas planes."""
    from ..features.blending import perform_blending
    from ..features.patches import BlendMode, PatchBlending
    from ..io.headers.frame import BlendingMode

    header = frame.header
    fh = frame.file_header
    img_w, img_h = fh.xsize, fh.ysize
    dev = planes[0].device
    refs = frame.decoder_state.reference_frames if frame.decoder_state else [None] * 4
    mode_map = {
        BlendingMode.REPLACE: BlendMode.NONE,
        BlendingMode.ADD: BlendMode.ADD,
        BlendingMode.MUL: BlendMode.MUL,
        BlendingMode.BLEND: BlendMode.BLEND_BELOW,
        BlendingMode.ALPHA_WEIGHTED_ADD: BlendMode.ALPHA_WEIGHTED_ADD_BELOW,
    }
    canvas = []
    for c in range(len(planes)):
        src = header.blending_info.source if c < 3 else header.ec_blending_info[c - 3].source
        ref = refs[src]
        if ref is not None:
            canvas.append(ref["frame"][c].clone())
        else:
            canvas.append(torch.zeros((img_h, img_w), dtype=torch.float32, device=dev))

    x0, y0 = header.x0, header.y0
    fh_px, fw = planes[0].shape
    ix0, iy0 = max(x0, 0), max(y0, 0)
    ix1, iy1 = min(x0 + fw, img_w), min(y0 + fh_px, img_h)
    if ix1 <= ix0 or iy1 <= iy0:
        return canvas
    fx0, fy0 = ix0 - x0, iy0 - y0
    fx1, fy1 = fx0 + (ix1 - ix0), fy0 + (iy1 - iy0)
    bg = [p[fy0:fy1, fx0:fx1] for p in planes]
    fg = [c[iy0:iy1, ix0:ix1] for c in canvas]
    bi = header.blending_info
    out = perform_blending(
        bg, fg, PatchBlending(mode_map[bi.mode], bi.alpha_channel, bi.clamp),
        [PatchBlending(mode_map[b.mode], b.alpha_channel, b.clamp)
         for b in header.ec_blending_info],
        fh.image_metadata.extra_channel_info,
    )
    for c in range(len(planes)):
        canvas[c][iy0:iy1, ix0:ix1] = out[c]
    return canvas


def apply_spot_and_premultiply(frame, canvas, options=None):
    """SpotColorStage + PremultiplyAlphaStage (ref stages/spot.rs:9-68,
    stages/premultiply_alpha.rs:11-; inserted per frame/render.rs:773-846).

    Spot channels mix their linear RGBA color into the color planes; with
    premultiply_output the color planes are multiplied by a straight
    (non-associated) alpha channel. An associated alpha is already
    premultiplied and passes through."""
    from ..io.headers import ExtraChannel

    meta = frame.file_header.image_metadata
    canvas = list(canvas)
    render_spots = options is None or getattr(options, "render_spot_colors", True)
    if render_spots:
        for i, info in enumerate(meta.extra_channel_info):
            if info.ec_type == ExtraChannel.SPOT_COLOR:
                sc = [st.f32(v) for v in info.spot_color]
                mix = sc[3] * canvas[3 + i]
                for c in range(3):
                    canvas[c] = mix * sc[c] + (1.0 - mix) * canvas[c]
    if options is not None and getattr(options, "premultiply_output", False):
        alpha = next(
            (
                3 + i
                for i, info in enumerate(meta.extra_channel_info)
                if info.ec_type == ExtraChannel.ALPHA and not info.alpha_associated
            ),
            None,
        )
        if alpha is not None:
            for c in range(3):
                canvas[c] = canvas[c] * canvas[alpha]
    return canvas


def color_transform(frame, planes):
    """YCbCr|XYB -> linear -> display TF on the first 3 channels.

    XYB frames render into the image's nominal output space: the opsin
    inverse matrix is primaries/grayscale-adjusted and the TF chosen per
    OutputColorInfo (ref xyb.rs:41-146)."""
    header = frame.header
    meta = frame.file_header.image_metadata
    if meta.xyb_encoded:
        from ..color.output import output_color_info

        info = output_color_info(frame.file_header)
        r, g, b = xyb_to_linear(
            planes[0], planes[1], planes[2],
            frame.file_header.transform_data.opsin_inverse_matrix,
            info.intensity_target,
            matrix=info.matrix,
        )
        planes[:3] = _from_linear([r, g, b], info.tf, info.intensity_target, info.luminances)
    elif header.do_ycbcr:
        r, g, b = ycbcr_to_rgb(planes[1], planes[0], planes[2])
        planes[:3] = [r, g, b]
    return planes


def _native_tf_kind(info):
    """(tf_kind, tf_p0) of the native colour code (colors.cc) for an
    OutputColorInfo, or None for a curve it does not know (HLG's
    cross-channel OOTF) (ref jxl_tpu/render/simple.py:289)."""
    kind, val = info.tf
    if kind == "gamma":
        return 3, float(val)
    return {TransferFunction.SRGB: (0, 0.0),
            TransferFunction.PQ: (1, float(info.intensity_target) / 10000.0),
            TransferFunction.BT709: (2, 0.0), TransferFunction.DCI: (3, 1.0 / 2.6),
            TransferFunction.LINEAR: (4, 0.0)}.get(val)


def color_convert_u8_native(frame, planes):
    """XYB -> display -> dithered u8 of an XYB frame's three host planes in
    one native pass (colors.cc jxl_xyb_srgb_u8; ref
    jxl_tpu/render/simple.py:260-288): an (h, w, 3) uint8 numpy array, the
    dither at the planes' (0, 0); None for a frame that is not XYB or is
    YCbCr, or whose transfer curve the native code does not know."""
    meta = frame.file_header.image_metadata
    if not meta.xyb_encoded or frame.header.do_ycbcr:
        return None
    from .. import native
    from ..color.output import output_color_info

    info = output_color_info(frame.file_header)
    nk = _native_tf_kind(info)
    if nk is None:
        return None
    return native.xyb_srgb_u8_native(
        planes[:3], info.matrix,
        frame.file_header.transform_data.opsin_inverse_matrix.opsin_biases,
        info.intensity_target, st.dither_table(), nk[0], nk[1])


def color_transform_host(frame, planes):
    """color_transform on host planes that the caller owns: an XYB frame
    whose transfer curve the native code knows in place through
    jxl_xyb_tf_f32 (ref jxl_tpu/render/simple.py:308-363; a plane that is
    a strided view is copied first), any other frame by the torch version
    on the CPU."""
    meta = frame.file_header.image_metadata
    if meta.xyb_encoded:
        from .. import native
        from ..color.output import output_color_info

        info = output_color_info(frame.file_header)
        nk = _native_tf_kind(info)
        if nk is not None:
            ps = [np.ascontiguousarray(p.numpy(), dtype=np.float32) for p in planes[:3]]
            if native.xyb_tf_f32_native(
                    ps, info.matrix,
                    frame.file_header.transform_data.opsin_inverse_matrix.opsin_biases,
                    info.intensity_target, nk[0], nk[1]):
                planes[:3] = [torch.from_numpy(p) for p in ps]
                return planes
    return color_transform(frame, planes)


def render_frame(frame) -> torch.Tensor:
    """A decoded frame rendered alone by the host route, to (h, w, c)
    display floats on the CPU: its stages, the colour transform, no
    orientation and no blending (ref jxl_tpu/render/simple.py:465,
    kept there for tests and simple files)."""
    from .. import native

    planes, color_done, _ = render_frame_channels_host(frame)
    if not color_done:
        planes = color_transform_host(frame, planes)
    arr = native.interleave_native([p.contiguous() for p in planes])
    return torch.from_numpy(arr) if arr is not None else torch.stack(planes, dim=-1)


def apply_orientation(arr, orientation):
    """EXIF-style orientation of an (h, w, c) tensor."""
    from ..io.headers import Orientation

    o = Orientation(orientation)
    if o == Orientation.IDENTITY:
        return arr
    if o == Orientation.FLIP_HORIZONTAL:
        return arr.flip(1)
    if o == Orientation.ROTATE_180:
        return arr.flip(0, 1)
    if o == Orientation.FLIP_VERTICAL:
        return arr.flip(0)
    if o == Orientation.TRANSPOSE:
        return arr.transpose(0, 1)
    if o == Orientation.ROTATE_90_CW:
        return arr.transpose(0, 1).flip(1)
    if o == Orientation.ANTI_TRANSPOSE:
        return arr.transpose(0, 1).flip(0, 1)
    if o == Orientation.ROTATE_90_CCW:
        return arr.transpose(0, 1).flip(0)
    raise NotSupported(f"orientation {o}")
