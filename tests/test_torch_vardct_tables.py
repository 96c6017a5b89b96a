"""A real encoder's VarDCT coding tables through the port, against
jxl_tpu and against the writer (tests/test_torch_vardct_streams.py).

The writer codes what an encoder's frames carry and the default streams
never did: custom dequant matrices (every parametric mode and RAW tables,
as a recompressed JPEG codes its quant tables), coded coefficient orders
(rANS- or prefix-coded permutations, one set a pass), a custom
block-context map over 16 block contexts, several AC histogram sets over
64 clusters at log alphabet size 8, and custom LF quantization.

- Each option stream's coefficients: jxl_tpu's decode, the port's host AC
  decoder (JXL_TPU_AC=host) and, on three streams, the lane decoder's
  plain version (K3's counterpart on the CPU) all equal the writer's, bit
  for bit; the pixels of the port's CPU decode are jxl_tpu's within 1e-4.
- DequantMatrices.decode per mode 0-7, the block-context map (the native
  LfGlobal read and BlockContextMap.read) and the coefficient orders (the
  native permutation read, the Python loop it replaced and jxl_tpu's)
  equal jxl_tpu's exactly.
- An animation whose frames alternate two sets of dequant tables: the fold
  declines it, and the batched routes equal the per-frame loop bit for
  bit, which equals jxl_tpu's per-frame loop (jxl_tpu's batched render
  dequantizes every frame with frame 0's matrices: ROADMAP section 3).
- On a card (the `cuda` marker; skips here): a 512x512 and a 1024x1024
  table stream under JXL_TPU_DEVICE=on and auto against the CPU decode.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from test_torch_layouts import as_jxl_tpu_edges
from test_torch_vardct_streams import (BitList, BlockContextSpec, DEQUANT_MODES,
                                       encode_xyb_vardct, encode_ycbcr_vardct,
                                       write_coeff_orders)

LF_QUANT = (1 / 2048, 1 / 1024, 1 / 128)
TABLES = dict(dequant="mixed", orders=True, bctx="custom", histograms=4, clusters=64,
              log_alpha=8, lf_quant=LF_QUANT)
STREAMS = {
    "raw": lambda: encode_xyb_vardct(264, 264, seed=71, density=0.05, dequant="raw"),
    "params": lambda: encode_xyb_vardct(264, 264, seed=72, density=0.05, dequant="params"),
    "mixed": lambda: encode_xyb_vardct(264, 264, seed=73, density=0.05, dequant="mixed"),
    "orders": lambda: encode_xyb_vardct(264, 264, seed=74, density=0.05, orders=True),
    "orders_prefix": lambda: encode_xyb_vardct(264, 264, seed=75, density=0.05, orders=True,
                                               order_codes="prefix"),
    "orders_2pass": lambda: encode_xyb_vardct(264, 264, seed=76, density=0.05, orders=True,
                                              passes=2),
    "bctx": lambda: encode_xyb_vardct(264, 264, seed=77, density=0.05, bctx="custom"),
    "histograms": lambda: encode_xyb_vardct(264, 264, seed=78, density=0.05, histograms=4,
                                            clusters=64, log_alpha=8),
    "lf_quant": lambda: encode_xyb_vardct(264, 264, seed=79, density=0.05, lf_quant=LF_QUANT),
    "tables": lambda: encode_xyb_vardct(264, 264, seed=80, density=0.05, **TABLES),
    "tables_2pass": lambda: encode_xyb_vardct(264, 264, seed=81, density=0.05, passes=2,
                                              order_codes="prefix", **TABLES),
    "jpeg_420": lambda: encode_ycbcr_vardct(264, 264, seed=82, subsampling="420", density=0.05,
                                            dequant="raw", orders=True),
}
# the streams whose lanes run through K3's plain version (it steps in Python)
LANE_STREAMS = ("tables", "tables_2pass", "jpeg_420")
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_frame(data, through_ac: bool):
    """The port's frame of `data`, its sections decoded up to HfGlobal, or
    with through_ac every section on the CPU (the AC by the route
    JXL_TPU_AC picks)."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    if through_ac:
        frame.decode_all_sections(br, "cpu")
        return frame
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(frame.header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    frame.decode_hf_global(sections[frame.section_index("hf_global")])
    return frame


def _ref_frame(data):
    from jxl_tpu.api.simple import decode_first_frame

    return decode_first_frame(data).frame


# -- coefficients and pixels ------------------------------------------------------------


@pytest.mark.parametrize("name", list(STREAMS))
def test_jxl_tpu_decodes_the_writer_coefficients(name):
    from test_device_ac import _decode_frame_coeffs

    data, coeffs = _stream(name)
    np.testing.assert_array_equal(_decode_frame_coeffs(data, force_device=False), coeffs)
    assert np.count_nonzero(coeffs) > 100


@pytest.mark.parametrize("name", list(STREAMS))
def test_host_ac_gives_the_writer_coefficients(name, monkeypatch):
    data, coeffs = _stream(name)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    frame = _port_frame(data, through_ac=True)
    assert frame.device_ac_flat is None
    np.testing.assert_array_equal(frame.host_ac_flat, coeffs)


@pytest.mark.parametrize("name", LANE_STREAMS)
def test_lane_decoder_gives_the_writer_coefficients(name, monkeypatch):
    """The lanes on the CPU run K3's plain version: 16 block contexts, four
    histogram sets (each lane's context offset its group's set), 64
    clusters of 256 buckets, coded orders of one or two passes."""
    data, coeffs = _stream(name)
    monkeypatch.delenv("JXL_TPU_AC", raising=False)
    frame = _port_frame(data, through_ac=True)
    assert frame.host_ac_flat is None and bool(frame.device_ac_ok.all())
    np.testing.assert_array_equal(frame.device_ac_flat.numpy(), coeffs)


@pytest.mark.parametrize("name", list(STREAMS))
def test_pixels_match_jxl_tpu(name, monkeypatch):
    from jxl_tpu.api.simple import decode_image as ref_decode

    data, _ = _stream(name)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    for fmt, limit in (("f32", 1e-4), ("u8", 1.0)):
        def decode():
            return jxl_tpu_torch.decode_image(data, pixel_format=fmt,
                                              device="cpu").frames[0].numpy()

        # a subsampled frame under jxl_tpu's chroma edges (test_torch_layouts)
        got = as_jxl_tpu_edges(decode, monkeypatch) if name == "jpeg_420" else decode()
        want = np.asarray(ref_decode(data, pixel_format=fmt).frames[0])
        assert got.shape == want.shape
        assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= limit


# -- the tables against jxl_tpu's -------------------------------------------------------


# mode -> (stream, the table kinds that stream codes in that mode)
MODE_KINDS = {0: ("params", [k for k in range(17) if k not in DEQUANT_MODES["params"]])}
for _opt in ("params", "raw", "mixed"):
    for _kind, _mode in DEQUANT_MODES[_opt].items():
        MODE_KINDS.setdefault(_mode, (_opt, []))
        if MODE_KINDS[_mode][0] == _opt:
            MODE_KINDS[_mode][1].append(_kind)


@pytest.mark.parametrize("mode", range(8))
def test_dequant_matrices_match_jxl_tpu(mode):
    """DequantMatrices.decode of the port against jxl_tpu's, exactly, on
    the table kinds coded in `mode`; a custom table is not the library's."""
    from jxl_tpu_torch.vardct.quant_weights import library_table

    name, kinds = MODE_KINDS[mode]
    data, _ = _stream(name)
    got = _port_frame(data, through_ac=False).hf_global.dequant_matrices.tables
    want = _ref_frame(data).hf_global.dequant_matrices.tables
    assert len(got) == len(want) == 17 and kinds
    for k in range(17):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in kinds:
        assert (mode == 0) == np.array_equal(got[k], library_table(k)), k


def test_block_context_map_matches_jxl_tpu():
    """The native LfGlobal read of a custom block-context map and the
    Python BlockContextMap.read against jxl_tpu's reader and the writer's
    map; the quant_lf bucket map of the LF groups against jxl_tpu's."""
    from jxl_tpu.io.bit_reader import BitReader as RefReader
    from jxl_tpu.vardct.block_context import BlockContextMap as RefMap
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.vardct.block_context import BlockContextMap

    data, _ = _stream("tables")
    got = _port_frame(data, through_ac=False)
    ref = _ref_frame(data)
    spec = BlockContextSpec(np.random.default_rng([80, 3]), 256)
    w = BitList()
    spec.write(w)
    bits = w.finish() + bytes(8)
    for m in (got.lf_global.block_context_map, ref.lf_global.block_context_map,
              BlockContextMap.read(BitReader(bits)), RefMap.read(RefReader(bits))):
        assert [list(t) for t in m.lf_thresholds] == [list(t) for t in spec.lf_thresholds]
        assert list(m.qf_thresholds) == spec.qf_thresholds
        assert list(m.context_map) == spec.context_map.tolist()
        assert (m.num_lf_contexts, m.num_contexts) == (12, 16)
    assert got.lf_global.block_context_map.num_ac_contexts == 16 * 495
    np.testing.assert_array_equal(got.hf_meta["quant_lf"], np.asarray(ref.hf_meta["quant_lf"]))
    assert len(np.unique(got.hf_meta["quant_lf"])) > 4


def _orders_bits(prefix: bool, passes: int):
    """The writer's coefficient orders for `passes` passes back to back
    (each its selector, mask, histograms and permutations), zero-padded,
    and each pass's dense orders."""
    rng = np.random.default_rng(90 + passes + prefix)
    w = BitList()
    want = [write_coeff_orders(w, rng, (0, 1, 2), prefix) for _ in range(passes)]
    return w.finish() + bytes(16), want


def _read_orders(bits, passes, reader_cls, decode):
    br = reader_cls(bits)
    out = []
    for _ in range(passes):
        assert br.read(2) == 3
        out.append(decode(br.read(13), br))
    return out, br.pos


@pytest.mark.parametrize("prefix,passes", [(False, 1), (True, 1), (False, 2)],
                         ids=["ans", "prefix", "two_pass"])
def test_coeff_orders_three_ways(prefix, passes):
    """decode_coeff_orders (the native permutation read), the Python loop
    it replaced (decode_coeff_orders_plain) and jxl_tpu's reader give the
    writer's orders, bit for bit, and stop at the same bit."""
    from jxl_tpu.io.bit_reader import BitReader as RefReader
    from jxl_tpu.vardct.coeff_order import decode_coeff_orders as ref_decode
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.vardct import coeff_order
    from jxl_tpu_torch.vardct.coeff_order import TRANSFORM_TYPE_LUT, natural_order_array

    bits, want = _orders_bits(prefix, passes)
    native, pos = _read_orders(bits, passes, BitReader, coeff_order.decode_coeff_orders)
    plain, pos_plain = _read_orders(bits, passes, BitReader, coeff_order.decode_coeff_orders_plain)
    ref, pos_ref = _read_orders(bits, passes, RefReader, ref_decode)
    assert pos == pos_plain == pos_ref
    coded = 0
    for p in range(passes):
        for idx in range(39):
            o, c = divmod(idx, 3)
            expect = want[p].get((o, c), natural_order_array(TRANSFORM_TYPE_LUT[o]))
            for got in (native[p][idx], plain[p][idx], np.asarray(ref[p][idx])):
                np.testing.assert_array_equal(got, expect)
            coded += (o, c) in want[p] and not np.array_equal(
                expect, natural_order_array(TRANSFORM_TYPE_LUT[o]))
    assert coded >= 6 * passes  # of orders 0-2 and one larger, three channels each


def test_permutation_read_raises_typed_errors():
    """read_permutations_native: a stream cut short raises OutOfBounds, an
    end past a permutation's size less its skip InvalidPermutation."""
    from jxl_tpu_torch import native
    from jxl_tpu_torch.entropy import Histograms
    from jxl_tpu_torch.errors import InvalidPermutation, OutOfBounds
    from jxl_tpu_torch.io.bit_reader import BitReader

    bits, _ = _orders_bits(False, 1)
    br = BitReader(bits)
    br.read(15)
    hist = Histograms.decode(8, br, allow_lz77=True)
    start = br.pos
    sizes, skips = [64] * 3 + [256] * 3 + [256] * 3, [1] * 3 + [4] * 3 + [4] * 3
    codes = native.read_permutations_native(hist, br, sizes, skips, False)
    assert len(codes) == 9 and br.pos > start and len(codes[0]) > 0
    with pytest.raises(InvalidPermutation):  # the first end, read with nothing to permute
        native.read_permutations_native(hist, _at(bits, start), [64], [64], False)
    with pytest.raises(OutOfBounds):
        native.read_permutations_native(hist, _at(bits[: start // 8 + 2], start),
                                        sizes * 40, skips * 40, True)


def _at(bits, pos):
    from jxl_tpu_torch.io.bit_reader import BitReader

    br = BitReader(bits)
    br.pos = pos
    return br


@pytest.mark.parametrize("name", ["orders", "orders_prefix", "orders_2pass", "tables_2pass"])
def test_hf_global_orders_match_jxl_tpu(name):
    """Each pass's orders as HfGlobal reads them (the native single-pass
    read for "orders"; the Python HfGlobal with the native permutation
    read for the others) against jxl_tpu's, and the histogram count."""
    data, _ = _stream(name)
    got = _port_frame(data, through_ac=False).hf_global
    ref = _ref_frame(data).hf_global
    assert got.num_histograms == ref.num_histograms
    assert len(got.passes) == len(ref.passes)
    for gp, rp in zip(got.passes, ref.passes):
        for idx in range(39):
            np.testing.assert_array_equal(gp.coeff_orders[idx], np.asarray(rp.coeff_orders[idx]))


@pytest.mark.parametrize("name", ["tables", "tables_2pass"])
def test_banded_and_streaming_decodes_equal_decode_image(name, monkeypatch):
    """decode_banded (each band's sections and matrices from the frame's
    tables) and JxlDecoder fed in 600-byte pieces give decode_image's
    frame bit for bit."""
    from test_torch_decoder import P, run

    data, _ = _stream(name)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    whole = jxl_tpu_torch.decode_image(data, pixel_format="f32", device="cpu").frames[0]
    rows = []
    jxl_tpu_torch.decode_banded(data, lambda y0, band: rows.append(band), pixel_format="f32",
                                device="cpu")
    assert len(rows) > 1 and torch.equal(torch.cat(rows), whole)
    d, _, _ = run(P, data, 600)
    assert len(d.frames) == 1 and torch.equal(d.frames[0], whole)


# -- an animation of two dequant sets ---------------------------------------------------


def _two_table_animation():
    from test_torch_frame_streams import anim_replace_stream

    return anim_replace_stream(192, 128, 4, seed=83, density=0.1,
                               frame_kw=lambda k: {"dequant": "mixed", "tables_seed": 84 + k % 2})


@pytest.mark.parametrize("device_route", ["on", "off"])
def test_batched_animation_keeps_each_frames_matrices(device_route, monkeypatch):
    """Frames that alternate two sets of dequant tables: the fold declines
    them (anim_fold_fallback), the batched routes "0" and "1" equal the
    per-frame loop bit for bit, on the plain route and on the host render
    route (JXL_TPU_DEVICE=off, render/batch_anim.py:
    render_frames_batched_host), and the loop equals jxl_tpu's loop within
    1e-4."""
    from jxl_tpu.api.simple import decode_image as ref_decode
    from jxl_tpu_torch.utils import trace

    data = _two_table_animation()
    monkeypatch.setenv("JXL_TPU_AC", "host")
    monkeypatch.setenv("JXL_TPU_DEVICE", device_route)
    out = {}
    trace.enable()
    try:
        for route in ("0", "1", "off"):
            monkeypatch.setenv("JXL_TPU_BATCH_ANIM", route)
            trace.reset()
            out[route] = jxl_tpu_torch.decode_image(data, pixel_format="f32",
                                                    device="cpu").frames
            if route == "0":
                assert trace.metrics.get("anim_fold_fallback") == 1
    finally:
        trace.enable(False)
    assert len(out["off"]) == 4
    for route in ("0", "1"):
        assert all(torch.equal(a, b) for a, b in zip(out[route], out["off"])), route
    ref = ref_decode(data, pixel_format="f32").frames  # still JXL_TPU_BATCH_ANIM=off
    for a, b in zip(out["off"], ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-4
    # the two sets do differ: frame 1 with frame 0's matrices is another image
    assert np.abs(out["off"][1].numpy() - out["off"][3].numpy()).max() > 0


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: chip_smoke.py's tables phase runs this on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(512, 512), (1024, 1024)])
def test_tables_on_the_card(size, cuda_device, monkeypatch):
    from jxl_tpu_torch.ops import device_ac

    data, _ = encode_xyb_vardct(*size, seed=85, density=0.1, **TABLES)
    monkeypatch.setenv("JXL_TPU_AC", "host")
    want = jxl_tpu_torch.decode_image(data, pixel_format="f32", device="cpu").frames[0]
    monkeypatch.delenv("JXL_TPU_AC")
    for route in ("on", "auto"):
        monkeypatch.setenv("JXL_TPU_DEVICE", route)
        k3 = device_ac.decode_ac_sections.launches
        got = jxl_tpu_torch.decode_image(data, pixel_format="f32", device=cuda_device).frames[0]
        launched = device_ac.decode_ac_sections.launches - k3
        assert got.device.type == "cuda"
        assert float((got.cpu() - want).abs().max()) <= 1e-4
        # auto sends the 512x512 still to the host, the larger one to the card
        assert (launched == 0) == (route == "auto" and size == (512, 512)), route
