"""Per-frame render-stage assembly and the stages' bodies.

Counterpart of jxl_tpu/render/pipeline.py. Capability reference:
jxl/src/render/mod.rs:53-115 (stages with BORDER and SHIFT) and
frame/render.rs:506-885 (the per-frame conditional stage assembly). A
Stage is a function `fn(chans, ctx) -> list` over whole channel planes,
torch tensors on one device, with the halo it reads (`border`), the log2
upsampling it applies (`shift`) and the channels it touches. The filter
stages (gaborish, EPF) have no body of their own: render/span_exec.py runs
a run of them as one launch of the gaborish + EPF kernel
(render/device_filters.py:run_filters). Patches and splines are not in
this package's slice, nor chroma-subsampled Modular frames: frames that
need them raise NotSupported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..errors import NotSupported


@dataclass(frozen=True)
class Stage:
    """One render stage.

    border: input halo (bx, by) needed per output pixel (ref
        RenderPipelineInOutStage::BORDER, render/mod.rs:57).
    shift: log2 upsampling per axis (ref ::SHIFT): the stage consumes
        pixels at 1/2^shift of its output resolution.
    channels: indices of the channels the stage reads and writes.
    fn(chans: list, ctx) -> list: the stage body; returns a new list.
        None for the filter stages (gaborish, EPF).
    """

    name: str
    fn: Callable | None
    border: tuple = (0, 0)
    shift: tuple = (0, 0)
    channels: tuple = (0, 1, 2)

    @property
    def is_filter(self) -> bool:
        return self.fn is None


def total_border(stages) -> tuple:
    """Back-propagate BORDER through SHIFT to the pipeline's input
    resolution: the halo (in input pixels) a tiled executor needs to
    render a tile exactly (ref low_memory_pipeline/mod.rs:184-200).
    Walking from the last stage backwards, a stage with shift s divides
    the downstream border by 2^s (rounded up) and adds its own."""
    bx = by = 0
    for s in reversed(stages):
        sx, sy = s.shift
        bx = -(-bx // (1 << sx)) + s.border[0]
        by = -(-by // (1 << sy)) + s.border[1]
    return (bx, by)


# -- stage constructors ------------------------------------------------------
#
# Each mirrors one reference stage (file:line cited); constants are
# captured when the stage is built.


def gaborish_stage() -> Stage:
    """GaborishStage 3x3 (ref stages/gaborish.rs:11), BORDER (1,1)."""
    return Stage("gaborish", None, border=(1, 1))


def epf_stage(step: int) -> Stage:
    """Epf0/1/2Stage (ref stages/epf/epf{0,1,2}.rs), BORDER 3/2/1."""
    border = {0: 3, 1: 2, 2: 1}[step]
    return Stage(f"epf{step}", None, border=(border, border))


def upsample_stage(frame, n: int, channels) -> Stage:
    """Upsample2x/4x/8x (ref stages/upsample.rs:15-398): 5x5 per-phase
    kernels from CustomTransformData, BORDER (2,2), SHIFT (log2 n)."""
    from .stages import core as st

    kern = st.build_upsample_kernels(
        getattr(frame.file_header.transform_data, f"weights{n}"), n
    )
    s = {2: 1, 4: 2, 8: 3}[n]

    def fn(chans, ctx):
        out = list(chans)
        for c in channels:
            out[c] = st.upsample(out[c], kern, n)
        return out

    return Stage(f"upsample{n}x{list(channels)}", fn, border=(2, 2), shift=(s, s),
                 channels=tuple(channels))


def chroma_upsample_stage(channel: int, horizontal: bool) -> Stage:
    """HorizontalChromaUpsample / VerticalChromaUpsample (ref
    stages/chroma_upsample.rs:9,87): 2x along one axis of one channel,
    BORDER 1 and SHIFT 1 along that axis."""
    from .stages import core as st

    f = st.chroma_upsample_h if horizontal else st.chroma_upsample_v

    def fn(chans, ctx):
        out = list(chans)
        out[channel] = f(out[channel])
        return out

    return Stage(f"chroma_upsample_{'h' if horizontal else 'v'}[{channel}]", fn,
                 border=(1, 0) if horizontal else (0, 1),
                 shift=(1, 0) if horizontal else (0, 1), channels=(channel,))


def crop_stage(w: int, h: int, channels) -> Stage:
    """Restrict channels to the visible rect (spec edge-extension point)."""

    def fn(chans, ctx):
        out = list(chans)
        for c in channels:
            out[c] = out[c][:h, :w]
        return out

    return Stage("crop", fn, channels=tuple(channels))


def noise_convolve_add_stage(frame) -> Stage:
    """ConvolveNoiseStage (BORDER 2) + AddNoiseStage (ref stages/noise.rs).
    The random field enters as ctx["noise_field"], (3, h, w) on the
    planes' device."""
    from ..features.noise import add_noise, convolve_noise

    noise = frame.lf_global.noise
    ccp = frame.lf_global.color_correlation_params

    def fn(chans, ctx):
        conv = [convolve_noise(p) for p in ctx["noise_field"]]
        out = list(chans)
        out[:3] = add_noise(out[:3], conv, noise, ccp)
        return out

    return Stage("noise", fn, border=(2, 2))


def color_transform_stage(frame) -> Stage:
    """XybStage + FromLinearStage (or YCbCr) via render/simple.py."""

    def fn(chans, ctx):
        from .simple import color_transform

        return color_transform(frame, list(chans))

    return Stage("color_transform", fn)


def convert_output_stage(fmt: str, channels) -> Stage:
    """ConvertF32To{U8,U16,F16} (ref stages/convert.rs:549-790)."""
    from .stages import core as st

    def fn(chans, ctx):
        out = list(chans)
        for c in channels:
            out[c] = st.convert_output(out[c], fmt, channel=c)
        return out

    return Stage(f"convert_{fmt}", fn, channels=tuple(channels))


def build_render_pipeline(frame):
    """Per-frame stage assembly in reference order (ref
    frame/render.rs:506-885): chroma upsample (per channel, its
    horizontal steps, then its vertical ones) -> visible crop -> gaborish
    -> EPF0/1/2 -> early EC upsample -> upsample -> upsampled crop ->
    noise. The colour transform and output conversion are appended by the
    caller. Raises NotSupported for a frame whose pipeline needs patches or
    splines, and for a chroma-subsampled Modular frame."""
    from ..io.headers.frame import Encoding

    header = frame.header
    meta = frame.file_header.image_metadata
    num_ec = len(meta.extra_channel_info)
    if not header.is444 and header.encoding != Encoding.VARDCT:
        # no writer of this package's tests codes YCbCr Modular frames
        raise NotSupported("chroma-subsampled Modular frames are not in this package's slice")
    if header.has_patches:
        raise NotSupported("patches are not in this package's slice")
    if header.has_splines:
        raise NotSupported("splines are not in this package's slice")

    stages = []
    for c in range(3):
        stages += [chroma_upsample_stage(c, True)] * header.hshift(c)
        stages += [chroma_upsample_stage(c, False)] * header.vshift(c)
    wc, hc = header.size()
    stages.append(crop_stage(wc, hc, (0, 1, 2)))
    rf = header.restoration_filter
    if rf.gab:
        stages.append(gaborish_stage())
    for step, need in ((0, 3), (1, 1), (2, 2)):
        if rf.epf_iters >= need:
            stages.append(epf_stage(step))

    late_ec_upsample = header.upsampling > 1 and all(
        u == header.upsampling for u in header.ec_upsampling
    )
    if not late_ec_upsample:
        for i, ec_up in enumerate(header.ec_upsampling):
            if ec_up > 1:
                stages.append(upsample_stage(frame, ec_up, (3 + i,)))
    if header.upsampling > 1:
        n_up = 3 + num_ec if late_ec_upsample else 3
        stages.append(upsample_stage(frame, header.upsampling, tuple(range(n_up))))

    wu, hu = header.size_upsampled()
    stages.append(crop_stage(wu, hu, tuple(range(3 + num_ec))))
    if header.has_noise:
        stages.append(noise_convolve_add_stage(frame))
    return stages


def sigma_source(frame):
    """(sigma_block, constant_sigma) of the EPF stages (ref
    render/pipeline.py:678-680): a VarDCT frame's per-block 1/sigma image
    ((bh, bw) float32 numpy), or a Modular frame's constant stored 1/sigma;
    (None, None) without EPF."""
    from ..io.headers.frame import Encoding
    from .stages import core as st

    rf = frame.header.restoration_filter
    if rf.epf_iters == 0:
        return None, None
    if frame.header.encoding == Encoding.VARDCT:
        return st.compute_sigma_image(frame), None
    return None, st.INV_SIGMA_NUM / rf.epf_sigma_for_modular
