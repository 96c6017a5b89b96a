"""The multi-process decode of jxl_tpu_torch on the CPU: the group-sharded
render with halo exchange (parallel/sharded_render.py), the lossless
lanes split across ranks (modular/device_lossless.py:split_lanes) and the
frame-parallel animation decode (parallel/multihost.py), at 1, 2 and 4
ranks.

Each world size is spawned once (a module fixture): its ranks join a
gloo group through a FileStore in a temporary directory and run every
case of tests/torch_sharded_cases.py, which imports no JAX; the test
process compares what they return.

Tolerances: against one rank and against the port's own whole-image
functions (render_block, filter_planes + colour, decode_image), bit for
bit: a shard's pixels come from the whole image's per-pixel math on real
neighbour pixels, and K1's plain version mirrors where the whole image
mirrors. The ranks run torch with one CPU thread, as
tests/test_torch_banded.py explains (torch's CPU pow). Against jxl_tpu:
sharded_vardct_frame on a (1, 2) mesh f32 1e-4 and u8 1 LSB (the port's
VarDCT tolerance, tests/test_torch_vardct.py); the halo exchange bit for
bit; the lanes bit for bit; the animation against jxl_tpu's decode_image
f32 1e-4 (tests/test_torch_frames.py). jxl_tpu's own multihost decode
needs jax.distributed processes and is not run here.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
import jxl_tpu_torch.parallel as P
import torch_sharded_cases as cases

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inp():
    return cases.inputs()


@pytest.fixture(scope="module")
def worlds(inp, tmp_path_factory):
    """{world size: [each rank's results]}: one spawn a world size."""
    out = {}
    for n in WORLDS:
        store = tmp_path_factory.mktemp(f"world{n}") / "store"
        out[n] = P.run_local_world(cases.run, n, str(store), (inp,), device="cpu", threads=1,
                                   timeout=300)
    return out


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), np.abs(a.astype(np.float64) - b).max()


KEYS = ["vardct_f32", "vardct_u8", "vardct_lanes_f32", "filters_f32", "filters_u8", "render",
        "lanes_5", "lanes_1", "lanes_2", "jax_lanes", "anim_f32", "anim_u8"]


@pytest.mark.parametrize("n", WORLDS[1:])
@pytest.mark.parametrize("key", KEYS)
def test_every_rank_equals_one_rank(worlds, n, key):
    for rank in worlds[n]:
        _same(rank[key], worlds[1][0][key])


@pytest.mark.parametrize("fmt", cases.FORMATS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_vardct_frame_equals_decode_image(worlds, inp, one_thread, n, fmt, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    want = jxl_tpu_torch.decode_image(inp["vardct"], pixel_format=fmt, device="cpu").frames[0]
    for rank in worlds[n]:
        _same(rank[f"vardct_{fmt}"], want.numpy())


@pytest.fixture(scope="module")
def lanes_frame(inp, one_thread):
    """decode_image of the lane-route stream (the plain lane decoder)."""
    import os

    ac = os.environ.pop("JXL_TPU_AC", None)
    try:
        return jxl_tpu_torch.decode_image(inp["vardct_lanes"], device="cpu").frames[0].numpy()
    finally:
        if ac is not None:
            os.environ["JXL_TPU_AC"] = ac


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_frame_on_the_lane_route_equals_decode_image(worlds, lanes_frame, n):
    for rank in worlds[n]:
        _same(rank["vardct_lanes_f32"], lanes_frame)


def test_tiles_cut_at_the_visible_edge(inp):
    """The 520x516 frame on a 2x2 grid: 3x3 groups padded to 4x4, the
    bottom tiles 4 rows high and the right ones 8 columns wide."""
    from types import SimpleNamespace

    from jxl_tpu_torch.parallel.sharded_render import ShardGrid, frame_tiles

    grid = ShardGrid(SimpleNamespace(size=4, rank=0), 2, 2)
    tiles = frame_tiles(grid, cases.frame_of(inp["vardct"]))
    assert [t.pixels for t in tiles] == [(0, 512, 0, 512), (0, 512, 512, 520),
                                         (512, 516, 0, 512), (512, 516, 512, 520)]
    assert [t.groups for t in tiles] == [(0, 1, 3, 4), (2, 5), (6, 7), (8,)]
    assert [t.blocks for t in tiles] == [(0, 64, 0, 64), (0, 64, 64, 65),
                                         (64, 65, 0, 64), (64, 65, 64, 65)]


@pytest.mark.parametrize("fmt", cases.FORMATS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_filters_equal_the_whole_image(worlds, inp, one_thread, n, fmt):
    from jxl_tpu_torch.render.device_band_filters import color_and_convert
    from jxl_tpu_torch.render.device_filters import filter_planes

    frame = cases.frame_of(inp["vardct"])
    out = filter_planes(frame, torch.from_numpy(inp["planes"]), torch.from_numpy(inp["sigma_px"]))
    want = torch.stack(color_and_convert(frame, out.unbind(0), 0, fmt))
    for rank in worlds[n]:
        _same(rank[f"filters_{fmt}"], want.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_render_equals_render_block(worlds, inp, one_thread, n):
    from jxl_tpu_torch.ops.device_render import RenderParams, render_block

    want = render_block(torch.from_numpy(inp["planes"]), torch.from_numpy(inp["sigma_block"]),
                        RenderParams())
    for rank in worlds[n]:
        _same(rank["render"], want.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_lanes_split_equals_one_rank_lanes(worlds, inp, n):
    from jxl_tpu_torch.modular.device_lossless import reconstruct_lanes

    for pred, res, dims in inp["lanes"]:
        want = reconstruct_lanes(pred, torch.from_numpy(res), dims).numpy()
        for rank in worlds[n]:
            _same(rank[f"lanes_{pred}"], want)


@pytest.mark.parametrize("n", WORLDS[1:])
def test_lanes_split_matches_jxl_tpu_sharded_program(worlds, inp, n):
    """jxl_tpu's gradient lanes sharded over an n-device mesh (its dry
    run's lane case, __graft_entry__.py:203-225)."""
    import jax
    from jax.sharding import Mesh

    from jxl_tpu.modular import device_lossless as ref_dl

    res = inp["jax_lanes"]
    mesh = Mesh(np.array(jax.devices()[:n]), ("lanes",))
    want = np.asarray(ref_dl._program(ref_dl._PRED_GRADIENT, len(res), 64, 64, "int32",
                                      mesh=mesh)(res))
    for rank in worlds[n]:
        _same(rank["jax_lanes"], want)


def _jax_halo(x, n, axis):
    import jax
    from jax.sharding import PartitionSpec as PS

    from jxl_tpu.parallel import sharded_render as ref_sr

    mesh = ref_sr.make_mesh(n)
    fn = ref_sr.exchange_halo_rows if axis == 0 else ref_sr.exchange_halo_cols
    spec = PS("groups", None) if axis == 0 else PS(None, "groups")
    sm = jax.shard_map(lambda s: fn(s, cases.HALO_ROWS, "groups"), mesh=mesh, in_specs=(spec,),
                   out_specs=spec)
    return np.asarray(jax.jit(sm)(x))


@pytest.mark.parametrize("n", WORLDS)
def test_halo_exchange_matches_jxl_tpu(worlds, inp, n):
    x = inp["halo_x"]
    want_rows = _jax_halo(x, n, 0)
    want_cols = _jax_halo(np.ascontiguousarray(x.T), n, 1)
    for rank in worlds[n]:
        _same(rank["halo_rows"], want_rows)
        _same(rank["halo_cols"], want_cols)


@pytest.mark.parametrize("n", WORLDS)
def test_halo_counts_the_bytes_it_sends(worlds, n):
    for rank in worlds[n]:
        assert (rank["exchange_bytes"] > 0) == (n > 1)


@pytest.mark.parametrize("fmt", cases.FORMATS)
def test_sharded_vardct_frame_matches_jxl_tpu(worlds, inp, fmt):
    """jxl_tpu's sharded_vardct_frame on a (1, 2) mesh against the port's
    at 2 ranks."""
    import jax
    from jax.sharding import Mesh

    from jxl_tpu.parallel.sharded_render import sharded_vardct_frame
    from test_torch_vardct import _ref_frame

    frame, _ = _ref_frame(inp["vardct"])
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("gy", "gx"))
    ref = np.asarray(sharded_vardct_frame(mesh, frame, frame.hf_global.hf_coefficients, fmt))
    got = worlds[2][0][f"vardct_{fmt}"]
    ref = ref[:, : got.shape[0], : got.shape[1]].transpose(1, 2, 0)
    diff = np.abs(got.astype(np.float64) - ref).max()
    assert diff <= (1e-4 if fmt == "f32" else 1), diff


@pytest.mark.parametrize("fmt", cases.FORMATS)
@pytest.mark.parametrize("n", WORLDS)
def test_multihost_animation_equals_decode_image(worlds, inp, one_thread, n, fmt, monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")
    want = jxl_tpu_torch.decode_image(inp["anim"], pixel_format=fmt, device="cpu").frames
    for rank in worlds[n]:
        got = rank[f"anim_{fmt}"]
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            _same(g, w.numpy())


def test_multihost_animation_matches_jxl_tpu(worlds, inp, monkeypatch):
    """Against jxl_tpu's decode_image (its per-frame loop), f32 1e-4."""
    from jxl_tpu.api.simple import decode_image as ref_decode

    monkeypatch.setenv("JXL_TPU_BATCH_ANIM", "off")
    monkeypatch.setenv("JXL_TPU_AC", "host")
    want = ref_decode(inp["anim"]).frames
    got = worlds[2][1]["anim_f32"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert np.abs(g - np.asarray(w)).max() <= 1e-4


@pytest.mark.parametrize("n", WORLDS)
def test_multihost_refuses_an_ineligible_animation(worlds, n):
    for rank in worlds[n]:
        assert rank["anim_ineligible"] == ("raises", "NotSupported")


def test_the_writer_codes_negative_offsets(inp):
    """The animation's cropped frames include a negative x0 and y0 (what
    decode_image crops and jxl_tpu's multihost decode clamps)."""
    from jxl_tpu_torch.parallel.multihost import _pipeline_eligible, _scan_frames

    fh, _, frames = _scan_frames(inp["anim"])
    assert _pipeline_eligible(fh, frames)
    assert min(h.x0 for h, *_ in frames) < 0 and min(h.y0 for h, *_ in frames) < 0


def test_grids_factor_as_jxl_tpu_meshes():
    from types import SimpleNamespace

    from jxl_tpu_torch.parallel.sharded_render import make_grid, make_grid_2d

    shapes = {n: (make_grid_2d(SimpleNamespace(size=n, rank=0)).ny,
                  make_grid_2d(SimpleNamespace(size=n, rank=0)).nx) for n in (1, 2, 3, 4, 6, 8)}
    assert shapes == {1: (1, 1), 2: (1, 2), 3: (1, 3), 4: (2, 2), 6: (2, 3), 8: (2, 4)}
    g = make_grid(SimpleNamespace(size=4, rank=3))
    assert (g.ny, g.nx, g.sy, g.sx) == (4, 1, 3, 0)


def test_init_distributed_names_its_backend():
    with pytest.raises(ValueError):
        P.init_distributed("file:///nonexistent", 1, 0, backend="mpi", device="cpu")
    with pytest.raises(ValueError):
        P.init_distributed("file:///nonexistent", 1, 0, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            P.init_distributed("file:///nonexistent", 1, 0)


def test_a_failing_rank_raises_in_the_caller(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1"):
        P.run_local_world(cases.fail_on_rank_one, 2, str(tmp_path / "store"), device="cpu",
                          timeout=120)


def test_row_spans_split_into_whole_blocks():
    from jxl_tpu_torch.parallel.sharded_render import row_spans

    assert row_spans(2160, 4) == [(0, 544), (544, 1088), (1088, 1632), (1632, 2160)]
    assert row_spans(120, 4) == [(0, 32), (32, 64), (64, 96), (96, 120)]
    assert row_spans(2160, 1) == [(0, 2160)]
    assert row_spans(16, 4) == [(0, 8), (8, 16), (16, 16), (16, 16)]


@pytest.mark.parametrize("stream", ["anim", "modular"])
def test_decode_sharded_refuses_other_files(inp, stream):
    """An animation, or a Modular frame: NotSupported, before any section
    is decoded (no collective runs, so a World needs no group here)."""
    from jxl_tpu_torch.errors import NotSupported
    from jxl_tpu_torch.parallel.sharded_render import decode_sharded, make_grid_2d
    from test_torch_streams import encode_xyb_modular

    data = inp["anim"] if stream == "anim" else encode_xyb_modular(264, 40, seed=5)[0]
    with pytest.raises(NotSupported):
        decode_sharded(data, make_grid_2d(P.World("gloo", "cpu", 0, 1)))
