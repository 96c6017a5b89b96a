"""The port's lane AC decoder (ops/device_ac.py, vardct/device_group.py)
against jxl_tpu's XLA version (jxl_tpu/ops/device_ac.py) on the same
numpy inputs: coefficients and per-lane ok flags bit for bit, on writer
streams, on random lanes with valid packed tables, and on a stream with a
corrupted section. Cases stay at a few groups with sparse content: the
plain versions run one lockstep step per token.
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
