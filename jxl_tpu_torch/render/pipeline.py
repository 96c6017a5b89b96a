"""Per-frame render-stage assembly, as far as crop, gaborish and EPF.

Capability reference: jxl/src/frame/render.rs:506-885 (the per-frame
conditional stage assembly). The JAX package's assembly
(jxl_tpu/render/pipeline.py:build_render_pipeline) also assembles chroma
upsampling, patches, splines, upsampling and noise; frames that need any
of those raise NotSupported here. The executor (render/simple.py) treats
the crops as slicing around one fused filter + colour program and does
not run stages one by one, so a Stage here is a description only.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import NotSupported


@dataclass(frozen=True)
class Stage:
    """One render stage: `border` is the input halo (bx, by) it needs per
    output pixel (ref RenderPipelineInOutStage::BORDER, render/mod.rs:57);
    `size` is the (w, h) a crop restricts the planes to."""

    name: str
    border: tuple = (0, 0)
    size: tuple | None = None


def build_render_pipeline(frame) -> list:
    """Stages of a frame in reference order: visible crop -> gaborish ->
    EPF0/1/2 -> upsampled crop. Raises NotSupported for a frame whose
    pipeline needs any other stage."""
    header = frame.header
    meta = frame.file_header.image_metadata
    if not header.is444:
        raise NotSupported("chroma-subsampled frames are not in this package's slice")
    if meta.extra_channel_info:
        raise NotSupported("extra channels are not in this package's slice")
    if header.has_patches or header.has_splines or header.has_noise:
        raise NotSupported("patches, splines and noise are not in this package's slice")
    if header.upsampling > 1:
        raise NotSupported("upsampling is not in this package's slice")

    rf = header.restoration_filter
    stages = [Stage("crop", size=header.size())]
    if rf.gab:
        stages.append(Stage("gaborish", border=(1, 1)))
    for step, need, border in ((0, 3, 3), (1, 1, 2), (2, 2, 1)):
        if rf.epf_iters >= need:
            stages.append(Stage(f"epf{step}", border=(border, border)))
    stages.append(Stage("crop", size=header.size_upsampled()))
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
