"""The port's lane AC decoder (ops/device_ac.py, vardct/device_group.py)
against jxl_tpu's XLA version (jxl_tpu/ops/device_ac.py) on the same
numpy inputs: coefficients and per-lane ok flags bit for bit, on writer
streams, on random lanes with valid packed tables, and on a stream with a
corrupted section; and the lanes' item table, which one native pass over
the frame builds, against the per-group numpy route it replaced and
against every lane array of jxl_tpu's planner. Cases stay at a few groups
with sparse content: the plain versions run one lockstep step per token.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jxl_tpu.ops.device_ac import decode_ac_sections as jax_decode_ac_sections

from jxl_tpu_torch.ops import device_ac
from jxl_tpu_torch.vardct import device_group
from test_device_ac import _decode_frame_coeffs
from test_device_ans import FINAL_STATE
from test_torch_vardct_streams import encode_xyb_vardct
from test_torch_vardct_streams import random_lanes as _random_lanes



def _port_frame_and_readers(data):
    """The port's parse of a writer stream up to its HF sections, and the
    {(group, pass): BitReader} of those sections."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(frame.header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    frame.decode_hf_global(sections[frame.section_index("hf_global")])
    readers = {(g, p): sections[frame.section_index("hf", group=g, pass_idx=p)]
               for g in range(frame.header.num_groups)
               for p in range(frame.header.passes.num_passes)}
    return frame, readers


def _both(inputs):
    """(coeffs, ok) of jxl_tpu's XLA decoder and of the port's plain
    version on the same numpy inputs."""
    arrays = {k: v for k, v in inputs.items() if k not in device_group.LANE_KEYWORDS}
    kw = {k: inputs[k] for k in device_group.LANE_KEYWORDS}
    ref_c, ref_ok = jax_decode_ac_sections(*(jnp.asarray(v) for v in arrays.values()), **kw)
    before = device_ac.decode_ac_sections.launches
    got_c, got_ok = device_group.run_lanes(inputs, torch.device("cpu"))
    assert device_ac.decode_ac_sections.launches == before  # no kernel on the CPU
    return (np.asarray(ref_c), np.asarray(ref_ok)), (got_c.numpy(), got_ok.numpy())


@pytest.mark.parametrize("size,transforms,seed", [((520, 136), "mixed", 21),
                                                   ((300, 200), "dct8", 22),
                                                   ((264, 1040), "large", 23)])
def test_plain_lanes_match_jxl_tpu_on_writer_streams(size, transforms, seed):
    data, coeffs = encode_xyb_vardct(*size, seed=seed, transforms=transforms, density=0.15)
    frame, readers = _port_frame_and_readers(data)
    inputs = device_group.lane_inputs(frame, readers)
    (ref_c, ref_ok), (got_c, got_ok) = _both(inputs)
    stride = 3 * 256 * 256
    for g in range(len(got_ok)):  # lane by lane (one pass: a lane is a group)
        np.testing.assert_array_equal(got_c[g * stride : (g + 1) * stride],
                                      ref_c[g * stride : (g + 1) * stride])
    np.testing.assert_array_equal(got_ok, ref_ok)
    assert got_ok.all()
    np.testing.assert_array_equal(got_c, coeffs)
    # and jxl_tpu's own planner routes its lanes to the same coefficients
    np.testing.assert_array_equal(_decode_frame_coeffs(data, force_device=True), coeffs)


def test_corrupted_section_flags_the_same_lanes():
    data, _ = encode_xyb_vardct(520, 136, seed=23, density=0.15)
    frame, readers = _port_frame_and_readers(data)
    bad = readers[(1, 0)]
    buf = bytearray(bad.data)
    for i in range(len(buf) // 3, len(buf) // 3 + 6):
        buf[i] ^= 0x5A
    bad.data = bytes(buf)
    inputs = device_group.lane_inputs(frame, readers)
    (ref_c, ref_ok), (got_c, got_ok) = _both(inputs)
    np.testing.assert_array_equal(got_ok, ref_ok)
    np.testing.assert_array_equal(got_c, ref_c)
    assert not got_ok[1] and got_ok[0] and got_ok[2]


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_plain_lanes_match_jxl_tpu_on_random_lanes(seed):
    inputs = _random_lanes(seed)
    (ref_c, ref_ok), (got_c, got_ok) = _both(inputs)
    np.testing.assert_array_equal(got_ok, ref_ok)
    np.testing.assert_array_equal(got_c, ref_c)
    assert np.count_nonzero(got_c) > 0


def test_plain_lanes_match_jxl_tpu_on_random_lanes_of_many_clusters():
    """160 clusters of 64 buckets: on the card K3 reads these tables from
    global memory (tests/test_torch_kernel_plans.py)."""
    inputs = _random_lanes(34, log_alpha=6, clusters=160)
    (ref_c, ref_ok), (got_c, got_ok) = _both(inputs)
    np.testing.assert_array_equal(got_ok, ref_ok)
    np.testing.assert_array_equal(got_c, ref_c)
    assert np.count_nonzero(got_c) > 0


def test_lane_inputs_clip_and_pad_like_jxl_tpu():
    data, _ = encode_xyb_vardct(300, 200, seed=24, density=0.1)
    frame, readers = _port_frame_and_readers(data)
    inputs = device_group.lane_inputs(frame, readers)
    S, L = inputs["streams"].shape
    assert L >= max(len(r.data) for r in readers.values()) + 8 and L & (L - 1) == 0
    assert (inputs["lane_end_bits"] == [8 * len(readers[(g, 0)].data) for g in range(S)]).all()
    assert inputs["items"].shape[1] & (inputs["items"].shape[1] - 1) == 0
    assert inputs["tables"].dtype == np.int32 and inputs["tables"].shape[1] == 5


def _numpy_lane_items(frame):
    """The frame's item table by the per-group numpy route that the
    native pass replaced, rebuilt from what stays in the tree: the port's
    _BlockList and _build_pass_items a group, the order keys rewritten to
    offsets into pass 0's orders, the rows padded to a power of two of at
    least 16. Returns (items, n_items, orders)."""
    from jxl_tpu_torch.vardct.group import _BlockList, _build_pass_items

    bctx = frame.lf_global.block_context_map
    blists = [_BlockList(frame, g) for g in range(frame.header.num_groups)]
    used = sorted({int(s) * 3 + c for bl in blists for s in np.unique(bl.shape_ids)
                   for c in range(3)})
    key_lut = np.zeros(40, np.int32)
    orders = []
    pos = 0
    for p, pstate in enumerate(frame.hf_global.passes):
        for k in used:
            if p == 0:
                key_lut[k] = pos
            orders.append(np.asarray(pstate.coeff_orders[k], np.int32))
            pos += len(orders[-1])
    rows = []
    for bl in blists:
        items11, keys, _ = _build_pass_items(frame, bl, bctx)
        rows.append(np.concatenate([items11[:, :6], key_lut[keys][:, None], items11[:, 8:]], 1))
    i_max = device_group._next_pow2(max(len(r) for r in rows), 16)
    items = np.zeros((len(rows), i_max, 10), np.int32)
    for g, r in enumerate(rows):
        items[g, : len(r)] = r
    return items, np.array([len(r) for r in rows]), np.concatenate(orders)


def _jxl_tpu_lane_arrays(data, names, monkeypatch):
    """{name: array} of the lanes jxl_tpu's planner builds over the port's
    parse of `data`: the positional arrays (named by `names`, the port's
    order) and keywords its decode_ac_sections_device hands the lane
    decoder, caught before the decoder runs."""
    import jxl_tpu.ops.device_ac as jax_device_ac
    from jxl_tpu.vardct import device_group as jax_device_group

    class Caught(Exception):
        pass

    caught = {}

    def catch(*arrays, **kw):
        caught.update(zip(names, map(np.asarray, arrays)), **kw)
        raise Caught

    monkeypatch.setattr(jax_device_ac, "decode_ac_sections", catch)
    frame, readers = _port_frame_and_readers(data)
    frame._device_vardct = True
    with pytest.raises(Caught):
        jax_device_group.decode_ac_sections_device(frame, readers)
    return caught


@pytest.mark.parametrize("kw", [
    dict(width=520, height=300, transforms="mixed", seed=41),  # 4:4:4, DCT16 cells
    dict(width=264, height=1040, transforms="large", seed=42),
    dict(width=1000, height=700, transforms="mixed", seed=43),  # partial edge groups
    dict(width=520, height=300, seed=44, orders=True, bctx="custom", clusters=64,
         log_alpha=8),  # vardct_d1's tables: QF thresholds, a custom block-context map
    dict(width=520, height=300, seed=45, passes=2),
    dict(width=520, height=300, transforms="dct8", seed=46, subsampling="420"),
    dict(width=520, height=300, transforms="dct8", seed=47, subsampling="422"),
], ids=["mixed_444", "large", "edges_1000x700", "vardct_d1_tables", "two_pass", "ycbcr_420",
        "ycbcr_422"])
def test_native_item_table_matches_numpy_route_and_jxl_tpu(kw, monkeypatch):
    """The item table of lane_tables' one native pass over the frame, bit
    for bit and shape for shape: against the per-group numpy route it
    replaced, against jxl_tpu's planner (every lane array), and through
    lane_inputs(band=) on the last group row."""
    data, _ = encode_xyb_vardct(density=0.05, **kw)
    frame, readers = _port_frame_and_readers(data)
    tabs = device_group.lane_tables(frame)
    items, n_items, orders = _numpy_lane_items(frame)
    assert tabs["items"].shape == items.shape and tabs["items"].dtype == np.int32
    np.testing.assert_array_equal(tabs["items"], items)
    np.testing.assert_array_equal(tabs["n_items"], n_items)
    np.testing.assert_array_equal(tabs["orders"], orders)

    inputs = device_group.lane_inputs(frame, readers)
    names = [k for k in inputs if k not in device_group.LANE_KEYWORDS]
    ref = _jxl_tpu_lane_arrays(data, names, monkeypatch)
    assert set(ref) == set(inputs)
    for k, v in inputs.items():
        assert np.shape(v) == np.shape(ref[k]), k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)

    gx = frame.header.size_groups()[0]
    band = list(range(frame.header.num_groups - gx, frame.header.num_groups))
    frame, readers = _port_frame_and_readers(data)
    band_inputs = device_group.lane_inputs(
        frame, {k: r for k, r in readers.items() if k[0] in band}, band=band)
    assert band_inputs["items"].shape == (len(band),) + items.shape[1:]
    np.testing.assert_array_equal(band_inputs["items"], items[band])
    np.testing.assert_array_equal(band_inputs["lane_n_items"],
                                  np.repeat(n_items[band], frame.header.passes.num_passes))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(cuda_device):
    data, coeffs = encode_xyb_vardct(1024, 1024, seed=25, density=0.2)
    frame, readers = _port_frame_and_readers(data)
    inputs = device_group.lane_inputs(frame, readers)
    before = device_ac.decode_ac_sections.launches
    got_c, got_ok = device_group.run_lanes(inputs, cuda_device)
    torch.cuda.synchronize()
    assert device_ac.decode_ac_sections.launches == before + 1
    kw = {k: inputs[k] for k in device_group.LANE_KEYWORDS}
    arrays = {k: torch.from_numpy(v).to(cuda_device) for k, v in inputs.items() if k not in kw}
    want_c, want_ok = device_ac.decode_ac_sections_reference(
        *arrays.values(), **kw)
    assert torch.equal(got_c, want_c) and torch.equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_c.cpu().numpy(), coeffs)
    assert FINAL_STATE == 0x130000 and bool(got_ok.all())
