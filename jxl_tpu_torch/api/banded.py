"""Bounded-memory (banded) decode: the card holds O(group row), not O(image).

Counterpart of jxl_tpu/api/banded.py:decode_banded (:136). Capability
reference: jxl/src/render/low_memory_pipeline/ (row rings per stage, per-
group halos, 3x3 readiness scheduling, group_scheduler.rs:100-180). Here
the last frame decodes one GROUP ROW at a time in raster order: its
sections' entropy decode (kernel K3 over the band's lanes into a
band-sized buffer, or the host decoder), the band's VarDCT render
(vardct/device_band.py) or Modular planes, then the filters on the slab
[tail of band k-1 | band k | head of band k+1] (kernel K1,
render/device_band_filters.py; the one-band lookahead stands in for the
readiness mask), the patches and splines clipped to the band's rows, the
photon noise from the band's rows of the random field, the colour
transform and the output conversion, and the band goes to the caller's
sink. The whole image is never on the card. The filters mirror where the
whole-frame pipeline mirrors, so a band's rows are decode_image's rows.

Leading invisible frames (patch sources, LF frames) decode whole, through
decode_image's own per-frame work (api/simple.py:finish_frame), into the
decoder state's slots, as the reference's low-memory pipeline keeps its
reference frames in the frame store. The last frame streams in bands if
it is eligible: a REGULAR frame, no upsampling, no blending or crop, not
referenced, not an LF frame; a 4:4:4 Modular frame (a chroma-subsampled
one raises NotSupported) of one pass with three colour channels and no
global transform (a squeeze couples distant rows);
a VarDCT frame 4:4:4 whose global Modular transforms, if any, are
zero-predictor palettes without deltas on a group-gridded index channel
(a per-pixel lookup), whatever its count of extra channels (the JAX
package vets them only when there are extra channels, and a frame that
has them and no extra channel raises KeyError there); extra channels at
full resolution, group-gridded. Anything else raises NotSupported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import NotSupported
from ..io.bit_reader import BitReader
from ..io.headers import FileHeader
from ..io.headers.frame import Encoding, FrameType
from ..render.device_band_filters import HALO, color_and_convert, filter_band
from ..render.stages import core as st
from .frame import run_parallel
from .simple import PIXEL_FORMATS


def eligible_header(frame) -> bool:
    """The checks of eligible() that need only the frame header."""
    h = frame.header
    meta = frame.file_header.image_metadata
    if h.frame_type != FrameType.REGULAR or not h.is_last:
        return False
    if h.upsampling != 1 or any(u != 1 for u in h.ec_upsampling):
        return False
    if h.num_extra_channels and any(i.dim_shift != 0 for i in meta.extra_channel_info):
        return False
    if h.needs_blending() or h.can_be_referenced or h.lf_level != 0:
        return False
    if h.num_toc_entries == 1:
        return False  # a frame of one section is small by definition
    if not h.is444:
        return False  # the band source holds 4:4:4 Modular channels only
    if h.encoding == Encoding.MODULAR:
        return h.passes.num_passes == 1 and frame.color_channels == 3
    return True


def _palette_band_ok(mg, step) -> bool:
    """A zero-predictor palette without deltas whose index channel the
    groups code (eligible() holds those group-gridded at full size): a
    per-pixel lookup within a band."""
    from ..modular.transforms import PaletteStep
    from ..modular.predict import Predictor

    coded = {b for s in mg.section_buffer_indices[2:] for b in s}
    return (isinstance(step, PaletteStep) and step.num_deltas == 0
            and step.predictor == Predictor.ZERO and step.buf_in in coded)


def eligible(frame) -> bool:
    """Whether the last frame, its LfGlobal decoded, streams in bands (ref
    jxl_tpu/api/banded.py:41-100, less its fault: the VarDCT transform
    steps are vetted whatever the count of extra channels)."""
    if not eligible_header(frame):
        return False
    h = frame.header
    mg = frame.lf_global.modular_global
    if mg.section_buffer_indices and mg.section_buffer_indices[1]:
        return False  # LF-gridded channels would need whole-frame storage
    for p in range(h.passes.num_passes):
        for b in mg.section_buffer_indices[2 + p] if mg.section_buffer_indices else ():
            if mg.grid_kind[b] != "hf" or tuple(mg.buffer_infos[b].shift) != (0, 0):
                return False
    if h.encoding == Encoding.MODULAR:
        return not mg.transform_steps and mg.global_header is not None
    return all(_palette_band_ok(mg, s) for s in mg.transform_steps)


class BandSource:
    """The decoded planes of the last frame, one group row at a time, on
    `device`: decode(gy) -> ((3, rows, wv) float32 colour planes in XYB or
    as coded, [(rows, wv) float32 extra channels]), rows the band's
    visible rows. `reader(logical section index)` gives a section's
    BitReader. A VarDCT frame on the lane route launches K3 once a band
    over the band's (group, pass) lanes into a band-sized buffer; the lane
    flags wait in `pending` until check() reads them (a sync)."""

    def __init__(self, frame, reader, device):
        from ..vardct.device_band import BandRenderer

        self.frame = frame
        self.reader = reader
        self.device = torch.device(device)
        header = frame.header
        self.wv, self.hv = header.size()
        self.gdim = header.group_dim
        self.gx_count = header.size_groups()[0]
        self.vardct = header.encoding == Encoding.VARDCT
        self.lanes = self.vardct and frame.takes_lanes()
        self.renderer = BandRenderer(frame) if self.vardct else None
        self.pending = []
        self.launches = 0

    def rows(self, gy: int) -> int:
        return min(self.gdim, self.hv - gy * self.gdim)

    def _hf_readers(self, g: int) -> list:
        frame = self.frame
        return [(p, self.reader(frame.section_index("hf", group=g, pass_idx=p)))
                for p in range(frame.header.passes.num_passes)]

    def _read_modular_hf(self, gy: int, gx: int, pass_idx: int, br, dec: dict) -> None:
        """Group (gx, gy)'s modular HF stream of one pass into the band
        buffers `dec` ({buffer: (rows, w) int32}), in place of the
        whole-frame storage views (modular/image.py:read_hf_stream)."""
        from ..modular.channel import ModularChannel
        from ..modular.decode import ModularStreamId, decode_modular_subbitstream

        frame = self.frame
        mg = frame.lf_global.modular_global
        bufs, targets = [], []
        for b in mg.section_buffer_indices[2 + pass_idx]:
            info = mg.buffer_infos[b]
            x0 = gx * self.gdim
            w = max(min(info.size[0] - x0, self.gdim), 0)
            h = max(min(info.size[1] - gy * self.gdim, self.gdim), 0)
            if w and h:
                bufs.append(ModularChannel((w, h), (0, 0), info.bit_depth_bits))
                targets.append((b, x0, w, h))
        if not bufs:
            return
        g = gy * self.gx_count + gx
        decode_modular_subbitstream(bufs, ModularStreamId.modular_hf(frame.header, pass_idx, g),
                                    None, frame.lf_global.tree, br)
        for mc, (b, x0, w, h) in zip(bufs, targets):
            dec[b][:h, x0 : x0 + w] = mc.data

    def _band_buffers(self, gy: int) -> dict:
        mg = self.frame.lf_global.modular_global
        return {b: np.zeros((self.rows(gy), mg.buffer_infos[b].size[0]), np.int32)
                for p in range(self.frame.header.passes.num_passes)
                for b in (mg.section_buffer_indices[2 + p] if mg.section_buffer_indices else ())}

    def _outputs(self, dec: dict) -> dict:
        """{output channel: (rows, w) int32} of the band buffers, through
        the frame's palette steps (eligible(): zero-predictor, no deltas,
        so per pixel) with the whole-frame code on band storage."""
        from ..modular.channel import ModularChannel
        from ..modular.transforms import apply_palette

        mg = self.frame.lf_global.modular_global
        storage = {b: ModularChannel(a.shape[::-1], (0, 0), mg.buffer_infos[b].bit_depth_bits,
                                     data=a) for b, a in dec.items()}
        for step in mg.transform_steps:
            storage[step.buf_pal] = mg.storage[step.buf_pal]
            shape = storage[step.buf_in].data.shape
            for b in step.buf_out:
                storage[b] = ModularChannel(shape[::-1], (0, 0), mg.buffer_infos[b].bit_depth_bits)
            apply_palette(storage, step)
        return {mg.buffer_infos[b].output_channel_idx: mc.data for b, mc in storage.items()
                if mg.buffer_infos[b].output_channel_idx is not None}

    def _ec_planes(self, outs: dict) -> list:
        from ..render.simple import _modular_to_f32

        eci = self.frame.file_header.image_metadata.extra_channel_info
        if not eci:
            return []
        ec = st.to_device(np.stack([outs[3 + i] for i in range(len(eci))]), self.device)
        return [_modular_to_f32(ec[i], info.bit_depth) for i, info in enumerate(eci)]

    def _modular_band(self, gy: int):
        from ..render.simple import modular_color_planes

        frame = self.frame
        dec = self._band_buffers(gy)
        run_parallel(lambda gx: self._read_modular_hf(
            gy, gx, 0, self.reader(frame.section_index("hf", group=gy * self.gx_count + gx)),
            dec), list(range(self.gx_count)))
        outs = self._outputs(dec)
        col = st.to_device(np.stack([outs[c] for c in range(3)]), self.device)
        return torch.stack(modular_color_planes(frame, col.unbind(0))), self._ec_planes(outs)

    def coefficients(self, groups: list, gy: int | None = None):
        """The dense coefficient buffer of `groups` on the device (slot i
        group groups[i]) and, for the band of group row gy, its band
        buffers of modular HF channels (a frame without them needs no
        gy: the sharded decode's rectangles of groups)."""
        from ..vardct.device_group import lane_inputs, run_lanes
        from ..vardct.group import GROUP_DIM, decode_vardct_group

        frame = self.frame
        if self.lanes:
            readers = {(g, p): br for g in groups for p, br in self._hf_readers(g)}
            coeffs, ok = run_lanes(lane_inputs(frame, readers, band=groups), self.device)
            self.pending.append(ok)
            self.launches += 1
            return coeffs, {}
        n = len(groups) * 3 * GROUP_DIM * GROUP_DIM
        pool = torch.zeros(n, dtype=torch.int32, pin_memory=self.device.type == "cuda")
        slots = pool.numpy().reshape(len(groups), 3, GROUP_DIM * GROUP_DIM)
        dec = self._band_buffers(gy)

        def job(i):
            readers = self._hf_readers(groups[i])
            decode_vardct_group(frame, groups[i], readers, slots[i])
            for p, br in readers:  # each pass's modular HF stream follows its AC
                self._read_modular_hf(gy, i, p, br, dec)

        run_parallel(job, list(range(len(groups))))
        return pool.to(self.device, non_blocking=True), dec

    def decode(self, gy: int):
        if not self.vardct:
            return self._modular_band(gy)
        from ..vardct.device_band import band_groups

        coeffs, dec = self.coefficients(band_groups(self.frame, gy), gy)
        planes = self.renderer.render(gy, coeffs)[:, : self.rows(gy), : self.wv]
        return planes, self._ec_planes(self._outputs(dec)) if dec else []

    def check(self) -> None:
        """Read the pending lane flags (a sync) and raise on a corrupt lane
        (vardct/device_group.py:check_device_ac_ok)."""
        from ..vardct.device_group import check_device_ac_ok

        if self.pending:
            self.frame.device_ac_ok = torch.cat(self.pending)
            self.pending = []
            check_device_ac_ok(self.frame)


def band_slabs(source):
    """decode_banded's band loop: for each group row gy in order, (gy,
    tail, planes, head, extra channels), yielded once band gy + 1 is
    decoded (the one-band lookahead): `planes` the band's (3, rows, wv)
    planes, `tail` the previous band's last HALO rows and `head` the next
    band's first HALO rows, each None at the frame's edge. The caller
    filters and emits the band; when it reads the lane flags
    (BandSource.check) is its own choice."""
    prev = tail = None
    for gy in range(source.frame.header.size_groups()[1]):
        cur, ec = source.decode(gy)
        if prev is not None:
            yield prev[0], tail, prev[1], cur[:, :HALO], prev[2]
            tail = prev[1][:, -HALO:]
        prev = (gy, cur, ec)
    yield prev[0], tail, prev[1], None, prev[2]


def decode_lf_sections(frame, reader) -> None:
    """LfGlobal (no whole-frame Modular planes), the LF groups and
    HfGlobal of the last frame, then the LF smoothing; raises
    NotSupported when the frame does not stream in bands."""
    header = frame.header
    frame.decode_lf_global(reader(frame.section_index("lf_global")), allocate_modular=False)
    if not eligible(frame):
        raise NotSupported("stream not eligible for banded decode")
    for g in range(header.num_lf_groups):
        frame.decode_lf_group(g, reader(frame.section_index("lf", group=g)))
    frame.decode_hf_global(reader(frame.section_index("hf_global")))
    frame.finalize_lf()


def _leading_frames(data: bytes, device):
    """The file's header, the decoder state with every leading invisible
    frame decoded whole into its slots, the codestream and the last
    frame, its TOC read (the reader at its first section)."""
    from .decoder import _BoxParser
    from .simple import finish_frame, parse_frame
    from .state import DecoderState

    boxes = _BoxParser()
    boxes.feed(data)
    boxes.finish()
    codestream = bytes(boxes.codestream)
    br = BitReader(codestream)
    fh = FileHeader.read(br)
    meta = fh.image_metadata
    if meta.color_encoding.want_icc:
        from ..icc.decode import read_icc

        read_icc(br)
    if meta.preview is not None:
        pframe = parse_frame(br, fh, None, preview=True)
        br.jump_to_byte_boundary()
        br.skip_bits(pframe.toc.total_size * 8)
    state = DecoderState(fh)
    while True:
        br.jump_to_byte_boundary()
        frame = parse_frame(br, fh, state)
        header = frame.header
        if header.frame_type == FrameType.REGULAR and header.is_last:
            break
        if header.is_visible or header.is_last:
            raise NotSupported("leading visible frames not banded")
        frame.decode_all_sections(br, device)
        finish_frame(frame, state, device)
    br.jump_to_byte_boundary()
    return codestream, br, frame


def decode_banded(data: bytes, emit, pixel_format: str = "f32", device="cuda") -> dict:
    """Decode `data`, calling emit(y0, band) once a group row, in order:
    band is a fresh (rows, W, 3 + extra channels) tensor on `device` in
    `pixel_format`, the image's rows [y0, y0 + rows) as coded (no
    orientation). The card holds O(band): a band's coefficients, the
    planes of two or three bands, the filter slab and its output. Returns
    {"width", "height", "bands", "k3_launches"}. Raises NotSupported for a
    stream that does not stream in bands (module docstring). device: "cuda"
    (the default) raises where no card is present; pass "cpu" to run the
    plain torch versions on the host. JXL_TPU_AC=host decodes the VarDCT
    AC with the native host decoder, as decode_image does. A band is
    emitted once the lane flags of its coefficients and of the next band's
    (its halo) have been read: a corrupt lane raises before its rows
    leave."""
    from ..render.pipeline import patches_stage, sigma_source, splines_stage

    if pixel_format not in PIXEL_FORMATS:
        raise ValueError(f"unknown pixel format {pixel_format!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode_banded: no CUDA device is available; pass "
                           "device='cpu' to decode on the host")
    codestream, br, frame = _leading_frames(data, device)
    header = frame.header
    if not eligible_header(frame):
        raise NotSupported("stream not eligible for banded decode")
    toc_end = br.pos // 8
    frame.begin_sections(device)

    def reader(logical):
        return frame._section_reader(logical, codestream, toc_end)

    decode_lf_sections(frame, reader)
    source = BandSource(frame, reader, device)
    wv, hv = source.wv, source.hv
    gy_count = header.size_groups()[1]
    rf = header.restoration_filter
    sigma = sigma_source(frame) if rf.gab or rf.epf_iters else None
    noise = frame.lf_global.noise if header.has_noise else None

    def noisy(chans, y0, rows):
        """ConvolveNoise + AddNoise on the band's rows: the field's rows
        with the convolution's 2-row margin, real rows of the neighbour
        groups (the generator is seeded a subregion), so the band's rows
        are the whole-frame noise stage's."""
        from ..features.noise import add_noise, convolve_noise, generate_noise_field_rows

        lo, hi = max(0, y0 - 2), min(hv, y0 + rows + 2)
        field = generate_noise_field_rows(frame, lo, hi, pin_memory=device.type == "cuda")
        field = field.to(device, non_blocking=True)
        conv = [convolve_noise(p)[y0 - lo : y0 - lo + rows] for p in field]
        return add_noise(chans, conv, noise, frame.lf_global.color_correlation_params)

    def finalize(gy, tail, cur, head, ec):
        y0 = gy * source.gdim
        rows = cur.shape[1]
        out = filter_band(frame, tail, cur, head, y0, sigma)
        chans = list((out.clone() if out is cur else out).unbind(0)) + list(ec)
        if header.has_patches:
            chans = patches_stage(frame, y0, rows).fn(chans, None)
        if header.has_splines:
            chans = splines_stage(frame, y0, rows).fn(chans, None)
        if noise is not None:
            chans[:3] = noisy(chans[:3], y0, rows)
        band = torch.stack(color_and_convert(frame, chans, y0, pixel_format), dim=-1)
        source.check()
        emit(y0, band)

    for band in band_slabs(source):
        finalize(*band)
    return {"width": wv, "height": hv, "bands": gy_count, "k3_launches": source.launches}
