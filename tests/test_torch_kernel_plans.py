"""What the kernels K1, K2 and K3 take from the host, checked on the CPU:
their plans (from csrc/kernel_geometry.h, which the kernels compile in and
the host library exports), K3's packed alias buckets and the tables it
refuses, and K1's stage-set geometry. The kernels themselves run only
on a card (chip_smoke.py holds them against their plain versions there);
these tests hold the host side to what the kernels assume.
"""

import numpy as np
import pytest
import torch

from jxl_tpu_torch.ops import device_ac
from jxl_tpu_torch.ops import epf_gab as K
from jxl_tpu_torch.ops.device_ans import ans_step
from jxl_tpu_torch.vardct import device_group
from test_torch_vardct_streams import encode_xyb_vardct, long_section_stream, random_lanes

SMEM_LIMIT = 227 * 1024


def _port_lane_inputs(data):
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
    readers = {(g, 0): sections[frame.section_index("hf", group=g)]
               for g in range(frame.header.num_groups)}
    return device_group.lane_inputs(frame, readers)


def _plan_of(inputs):
    return device_ac.ac_smem_plan(C=inputs["tables"].shape[0], NB=inputs["n_buckets"],
                                  num_bctx=inputs["num_bctx"], NC=len(inputs["context_map"]))


def _check_plan(plan):
    regions = plan["regions"]
    assert plan["smem_bytes"] == regions["total"] <= SMEM_LIMIT
    assert plan["smem_bytes"] <= device_ac.BLOCK_BUDGET  # two blocks an SM
    assert regions["total"] == sum(v for k, v in regions.items() if k != "total")
    # the rings are restaged as a lane goes: fixed sizes, whatever its length
    assert regions["stream"] == 8 * plan["ring_half"] == 8 * 1024
    assert regions["items"] == 2 * plan["item_half"] * plan["item_slot_bytes"] == 2 * 64 * 64
    assert regions["context_slice"] >= plan["ctx_entry_bytes"] * plan["ctx_slice"]
    starts = np.cumsum([0] + [regions[k] for k in device_ac._REGIONS])[:-1]
    assert (starts % 16 == 0).all()  # every region starts 16-byte aligned


def test_k3_plan_of_the_4k_writer_stream():
    data, _ = encode_xyb_vardct(3840, 2160, seed=7)
    inputs = _port_lane_inputs(data)
    plan = _plan_of(inputs)
    _check_plan(plan)
    # everything a lane's chain reads is in shared memory: the whole
    # context slice (16-bit cluster ids) and the tables
    assert plan["tab_shared"] and plan["ctx_entry_bytes"] == 2
    assert plan["ctx_slice"] == 15 * 495 + 16 and len(inputs["context_map"]) == 7425
    # 4K sections (7 KB at most here) fit the 8 KB stream ring at once
    assert int(inputs["lane_end_bits"].max()) // 8 < plan["regions"]["stream"]


def test_k3_plan_of_a_long_section_and_a_full_group():
    """A 400 KB section (a 256x256 group at high quality) and a group of
    3072 items (32x32 blocks, 3 channels): the plan does not grow with
    either, and the staged stream and items are a small part of them."""
    inputs = random_lanes(42, S=2, G=1, I=3072)
    inputs["streams"] = np.zeros((2, 400 * 1024), np.uint8)
    plan = _plan_of(inputs)
    _check_plan(plan)
    assert plan == _plan_of(random_lanes(42))
    assert plan["regions"]["stream"] * 40 < inputs["streams"].shape[1]
    assert plan["regions"]["items"] * 20 < inputs["items"].shape[1] * plan["item_slot_bytes"]


def test_k3_plan_of_the_long_section_stream():
    """The writer stream chip_smoke.py holds K3 to for long sections: each
    section wraps the 8 KB stream ring more than twice over real bytes."""
    data, _ = long_section_stream()
    inputs = _port_lane_inputs(data)
    plan = _plan_of(inputs)
    _check_plan(plan)
    sections = (inputs["lane_end_bits"] - inputs["start_bits"]) // 8
    assert sections.min() > 2 * plan["regions"]["stream"]
    assert (inputs["lane_n_items"] == 3 * 32 * 32).all()  # DCT8 only: full groups


def test_k3_plan_of_many_clusters_leaves_the_tables_in_global_memory():
    """The random lanes chip_smoke.py holds K3 to with tables in global
    memory (the kernel's other instantiation)."""
    inputs = random_lanes(34, log_alpha=6, clusters=160)
    plan = _plan_of(inputs)
    _check_plan(plan)
    assert not plan["tab_shared"] and plan["ctx_slice"] == 15 * 495 + 16
    assert plan["regions"]["tables"] == 0


def test_k3_plan_of_a_real_encoders_tables():
    """A writer stream with an encoder's tables (chip_smoke.py's tables
    phase at 4K): 16 block contexts, four histogram sets picked by group,
    64 clusters of 256 buckets. The packed tables (64 x 256 x 8 bytes,
    128 KiB) exceed the block budget, so they stay in global memory; the
    lane's context slice is one set's 16 * 495 + 16 contexts, and each
    lane starts at its group's set."""
    data, _ = encode_xyb_vardct(1040, 520, seed=51, density=0.05, dequant="mixed", orders=True,
                                bctx="custom", histograms=4, clusters=64, log_alpha=8,
                                lf_quant=(1 / 2048, 1 / 1024, 1 / 128))
    inputs = _port_lane_inputs(data)
    plan = _plan_of(inputs)
    _check_plan(plan)
    assert inputs["tables"].shape == (64, 5, 256) and inputs["num_bctx"] == 16
    assert len(inputs["context_map"]) == 4 * 16 * 495
    assert not plan["tab_shared"] and plan["regions"]["tables"] == 0
    assert plan["ctx_slice"] == 16 * 495 + 16
    groups = inputs["lane_group"]
    np.testing.assert_array_equal(inputs["lane_ctx_off"], (groups % 4) * 16 * 495)


@pytest.mark.parametrize("case", ["stacked_passes", "huge_tables", "tiny"])
def test_k3_plan_stays_within_shared_memory(case):
    kw = dict(C=3, NB=64, num_bctx=15, NC=7425)
    if case == "stacked_passes":
        # 11 passes of 30 clusters each, every pass's map offset
        kw.update(C=330, NC=11 * 7425)
    elif case == "huge_tables":
        kw.update(C=2000, NB=256, num_bctx=16, NC=11 * 7936)
    else:
        kw.update(C=1, NB=1, num_bctx=1, NC=1)
    plan = device_ac.ac_smem_plan(**kw)
    _check_plan(plan)
    if case == "stacked_passes":
        # cluster ids past 255 need wider entries than a byte
        assert plan["ctx_entry_bytes"] == 2 and plan["ctx_slice"] == 15 * 495 + 16
        assert not plan["tab_shared"]  # 330 x 64 buckets: 169 KB
    if case == "huge_tables":
        # 4 MB of buckets stay in global memory; the slice still fits
        assert not plan["tab_shared"] and plan["ctx_slice"] == 16 * 495 + 16
    if case == "tiny":
        assert plan["ctx_slice"] == 495 + 16 and plan["tab_shared"]


@pytest.mark.parametrize("C", [40000, 70000])
def test_k3_plan_refuses_what_cannot_fit(C):
    with pytest.raises(ValueError):
        device_ac.ac_smem_plan(C=C, NB=64, num_bctx=15, NC=7425)


def _valid_tables(rng, C=4, NB=32):
    t = np.stack([
        rng.integers(0, 4097, (C, NB)),  # dist
        rng.integers(0, 4096, (C, NB)),  # alias symbol
        rng.integers(-4096, 4096, (C, NB)),  # alias offset
        rng.integers(0, 4097, (C, NB)),  # alias cutoff
        rng.integers(0, 4097, (C, NB)),  # alias dist
    ], axis=1).astype(np.int32)
    t[:, :, :2] = [[4096, 0], [4095, 0], [-4096, 4095], [4096, 0], [4096, 0]]  # the ends
    return t


def _unpack(packed):
    w = np.ascontiguousarray(packed).view(np.int64)[..., 0]
    return np.stack([(w >> 13) & 0x1FFF, (w >> 39) & 0xFFF, w >> 51, w & 0x1FFF,
                     (w >> 26) & 0x1FFF], axis=1)


def test_packed_buckets_hold_every_field():
    t = _valid_tables(np.random.default_rng(5))
    packed = device_ac.pack_buckets(t)
    assert packed.dtype == np.int32 and packed.shape == (4, 32, 2)
    np.testing.assert_array_equal(_unpack(packed), t)


def test_packed_bucket_step_matches_the_plain_step():
    """The kernel's step reads one packed word: alias cutoff, then symbol,
    signed offset and distribution from it. Modelled in numpy on the packed
    words of a writer's tables against ops/device_ans.py:ans_step."""
    inputs = random_lanes(40)
    tables = inputs["tables"]
    log_bucket = inputs["log_bucket"]
    packed = np.ascontiguousarray(device_ac.pack_buckets(tables))
    words = packed.view(np.int64)[..., 0]  # the fields below mask off the sign
    rng = np.random.default_rng(6)
    n = 4000
    state = rng.integers(1 << 16, 1 << 32, n, dtype=np.int64)
    cluster = rng.integers(0, tables.shape[0], n)
    i = (state & 0xFFF) >> log_bucket
    pos = (state & 0xFFF) & ((1 << log_bucket) - 1)
    w = words[cluster, i]
    use_alias = pos >= (w & 0x1FFF)
    sym = np.where(use_alias, (w >> 39) & 0xFFF, i)
    off = np.where(use_alias, (w >> 51) + pos, pos)
    d = np.where(use_alias, (w >> 26) & 0x1FFF, (w >> 13) & 0x1FFF)
    nstate = ((state >> 12) * d + off) & 0xFFFFFFFF
    t64 = torch.from_numpy(tables.astype(np.int64))
    cl = torch.from_numpy(cluster)
    streams = torch.zeros((n, 8), dtype=torch.uint8)
    want_sym, want_state, _ = ans_step(torch.from_numpy(state), torch.zeros(n, dtype=torch.int64),
                                       streams, lambda r, b: t64[cl, r, b], log_bucket)
    np.testing.assert_array_equal(sym, want_sym.numpy())
    renorm = nstate < (1 << 16)
    np.testing.assert_array_equal(np.where(renorm, nstate << 16, nstate) & 0xFFFFFFFF,
                                  want_state.numpy())


_BAD_TABLES = {
    "dist": lambda t, c, m: t[0, 0].__setitem__(3, 4097),
    "alias_symbol": lambda t, c, m: t[1, 1].__setitem__(0, 4096),
    "alias_offset_low": lambda t, c, m: t[2, 2].__setitem__(5, -4097),
    "alias_offset_high": lambda t, c, m: t[0, 2].__setitem__(5, 4096),
    "alias_cutoff": lambda t, c, m: t[0, 3].__setitem__(1, -1),
    "alias_dist": lambda t, c, m: t[2, 4].__setitem__(7, 8192),
    "uint_split_exponent": lambda t, c, m: c[0].__setitem__(0, 32),
    "uint_msb_lsb": lambda t, c, m: c[1].__setitem__(slice(None), [2, 2, 1]),
    "uint_negative": lambda t, c, m: c[2].__setitem__(2, -1),
    "context_map_high": lambda t, c, m: m.__setitem__(17, 3),
    "context_map_negative": lambda t, c, m: m.__setitem__(0, -1),
}


def test_pack_tables_checks_then_packs():
    inputs = random_lanes(43)
    buckets, cfgs = device_ac.pack_tables(inputs["tables"], inputs["uint_cfgs"],
                                          inputs["context_map"])
    np.testing.assert_array_equal(buckets, device_ac.pack_buckets(inputs["tables"]))
    np.testing.assert_array_equal(cfgs, device_ac.pack_hybrid_configs(inputs["uint_cfgs"]))
    bad = inputs["context_map"].copy()
    bad[3] = inputs["tables"].shape[0]
    with pytest.raises(ValueError):
        device_ac.pack_tables(inputs["tables"], inputs["uint_cfgs"], bad)


@pytest.mark.parametrize("which", ["buckets_only", "cfgs_only", "bucket_shape", "cfg_dtype"])
def test_k3_wrapper_refuses_packed_tables_that_do_not_fit(which):
    inputs = random_lanes(44)
    arrays = {k: torch.from_numpy(v) for k, v in inputs.items()
              if k not in device_group.LANE_KEYWORDS}
    kw = {k: inputs[k] for k in device_group.LANE_KEYWORDS}
    b, c = (torch.from_numpy(x) for x in device_ac.pack_tables(
        inputs["tables"], inputs["uint_cfgs"], inputs["context_map"]))
    packs = {"buckets_only": dict(packed_buckets=b),
             "cfgs_only": dict(packed_cfgs=c),
             "bucket_shape": dict(packed_buckets=b[:, :-1], packed_cfgs=c),
             "cfg_dtype": dict(packed_buckets=b, packed_cfgs=c.long())}[which]
    with pytest.raises(ValueError):
        device_ac.decode_ac_sections(**arrays, **kw, **packs)


@pytest.mark.parametrize("what", sorted(_BAD_TABLES))
def test_k3_wrapper_refuses_tables_it_cannot_pack(what):
    inputs = random_lanes(41)
    tables = inputs["tables"].copy()
    cfgs = inputs["uint_cfgs"].copy()
    cmap = inputs["context_map"].copy()
    _BAD_TABLES[what](tables, cfgs, cmap)
    inputs = dict(inputs, tables=tables, uint_cfgs=cfgs, context_map=cmap)
    with pytest.raises(ValueError):
        device_group.run_lanes(inputs, torch.device("cpu"))


def test_k3_wrapper_takes_the_extreme_valid_tables():
    t = _valid_tables(np.random.default_rng(7), C=3, NB=32)
    device_ac.check_table_ranges(t, np.array([[31, 0, 0], [4, 2, 2], [0, 0, 0]], np.int32),
                                 np.array([0, 1, 2], np.int32))
    np.testing.assert_array_equal(
        device_ac.pack_hybrid_configs(np.array([[31, 0, 0], [4, 2, 2]], np.int32)),
        [31, 4 | 2 << 8 | 2 << 16])


def _ring_read(row, start, reads, ring_half):
    """The kernel's bit reader, modelled: words of the virtual byte
    sequence row[clip(b)] staged half a ring at a time, each read taken
    from a window of three ring words at the cursor."""
    L = len(row)
    q0 = start >> 5

    def word(w):  # ring word w: virtual bytes 4 * (q0 + w) ..
        b = 4 * (q0 + w) + np.arange(4)
        return int(sum(int(row[x]) << (8 * t) for t, x in enumerate(np.clip(b, 0, L - 1))))

    ring = [word(w) for w in range(2 * ring_half)]
    stage_at = ring_half
    pos = start
    out = []
    for n in reads:
        wrel = (pos >> 5) - q0
        if wrel >= stage_at:
            h = stage_at // ring_half
            for w in range(ring_half):
                ring[((h + 1) % 2) * ring_half + w] = word((h + 1) * ring_half + w)
            stage_at += ring_half
        m = 2 * ring_half
        win = ring[wrel % m] | (ring[(wrel + 1) % m] << 32) | (ring[(wrel + 2) % m] << 64)
        out.append((win >> (pos & 31)) & ((1 << n) - 1))
        pos += n
    return out


@pytest.mark.parametrize("L,start", [(37, 0), (37, 13), (64, 29), (5, 3), (1, 0)])
def test_k3_bit_ring_rereads_the_last_byte_past_the_row(L, start):
    from jxl_tpu_torch.ops.device_ans import read_bits

    rng = np.random.default_rng(L + start)
    row = rng.integers(0, 256, L, dtype=np.uint8)
    reads = [32] + rng.integers(0, 33, 60).tolist()  # runs far past the row's end
    got = _ring_read(row, start, reads, ring_half=4)
    pos = start
    streams = torch.from_numpy(row[None, :])
    for n, g in zip(reads, got):
        want = read_bits(streams, torch.tensor([pos]), torch.tensor([n]))
        assert g == int(want[0]), (pos, n)
        pos += n


@pytest.mark.parametrize("S,T,L,sms", [
    (135, 4096, 2776, 132),  # the S=135 writer case chip_smoke.py times
    (4224, 1024, 712, 132),  # 32 streams an SM
    (1, 0, 3, 132),          # T = 0, a row shorter than the state
    (37, 4096, 400 * 1024, 132),  # rows longer than the ring: restaged
    (10 ** 6, 31, 69, 114),  # capped at 32 streams a block; another card
])
def test_k2_plan_from_the_geometry_header(S, T, L, sms):
    """K2's plan as the host library reads csrc/kernel_geometry.h, against
    the rule it states: streams spread over every SM first (one warp each,
    at most 32 a block); a ring of a power of two of 64 to 1024 words holds
    every word T steps read (bytes [0, 4 + 2T), at most the row and the
    all-last-byte word past it); the 80 KB table and the rings fit a block."""
    from jxl_tpu_torch.ops.ans_lanes import k2_plan

    plan = k2_plan(S, T, L, sms)
    warps = min(32, max(1, -(-S // sms)))
    words = min((2 * T + 7) // 4, (L + 3) // 4 + 1)
    ring = 64
    while ring < 1024 and ring < words:
        ring *= 2
    assert (plan["warps"], plan["ring_words"], plan["ring_bytes"]) == (warps, ring, 4 * ring)
    assert plan["threads"] == 1024
    assert plan["table_bytes"] == 4096 * (16 + 4)
    assert plan["smem_bytes"] == plan["table_bytes"] + warps * 4 * ring <= SMEM_LIMIT
    assert plan["blocks"] * warps >= S > (plan["blocks"] - 1) * warps
    # the ring is restaged only between chunks: a chunk's steps read at most
    # chunk / 2 + 1 words past the cursor's, less than half a ring
    assert plan["chunk"] == 32 and plan["chunk"] // 2 + 1 < ring // 2
    if S == 135:
        assert plan["blocks"] == 68  # 135 streams on 68 SMs
    if S == 37:
        assert ring == 1024 and 4 * ring < L


@pytest.mark.parametrize("use_gab", [False, True])
@pytest.mark.parametrize("epf_iters", [0, 1, 2, 3])
def test_k1_plan_halo_is_the_sum_of_the_stage_borders(use_gab, epf_iters):
    plan = K.epf_gab_plan(use_gab, epf_iters)
    want = int(use_gab) + 3 * (epf_iters >= 3) + 2 * (epf_iters >= 1) + (epf_iters >= 2)
    assert plan["halo"] == want
    assert plan["halo_x"] % 4 == 0 and want <= plan["halo_x"] < want + 4
    rows, cols = plan["shared_tile"]
    assert (rows, cols) == (32 + 2 * want, 64 + 2 * plan["halo_x"])
    assert plan["smem_bytes"] <= SMEM_LIMIT
    if use_gab and epf_iters == 2:  # the main path: three blocks an SM
        assert want == 4 and 3 * (plan["smem_bytes"] + 1024) <= 228 * 1024
        assert plan["input_bytes_per_px"] == 16 * 40 * 72 / (32 * 64)


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (3, 4097)])
@pytest.mark.parametrize("iters", [1, 2, 3])
def test_plain_epf_gab_matches_jxl_tpu_core_on_thin_images(size, iters):
    from test_torch_epf import GAB, _args, _inputs, _numpy_chain

    planes, sigma = _inputs(*size, seed=size[1] + iters)
    want = _numpy_chain(planes, sigma, GAB, iters)
    got = K.epf_gab_reference(*_args(planes, sigma, GAB, iters)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
