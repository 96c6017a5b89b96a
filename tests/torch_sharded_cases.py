"""The cases every rank of tests/test_torch_sharded.py runs, in spawned
processes on the CPU (gloo, a FileStore in the test's temporary
directory): parallel/sharded_render.py, the lanes split of
modular/device_lossless.py and parallel/multihost.py.

This module imports no JAX and nothing of jxl_tpu: a spawned rank
imports it by name, and the ranks run the port alone. The inputs are made
in the test process (seeded numpy, the writers' streams) and passed in;
each rank returns numpy arrays, and the test compares them with one rank,
with the port's whole-image functions and with jxl_tpu.
"""

from __future__ import annotations

import os

import numpy as np
import torch

FORMATS = ("f32", "u8")
HALO_ROWS = 4  # the halo of the exchange cases (jxl_tpu's test uses 4)


def inputs(seed: int = 0) -> dict:
    """The seeded inputs of every case (made once, in the test process)."""
    from test_torch_frame_streams import anim_crop_replace_stream, anim_vardct_stream
    from test_torch_vardct_streams import encode_xyb_vardct

    rng = np.random.default_rng(seed)
    rows, cols = 120, 96  # at 4 ranks 32, 32, 32 and 24 rows (row_spans)
    planes = np.stack([rng.uniform(-0.02, 0.02, (rows, cols)), rng.uniform(0.0, 0.8, (rows, cols)),
                       rng.uniform(0.0, 0.8, (rows, cols))]).astype(np.float32)
    sigma_block = rng.uniform(0.05, 0.6, (rows // 8, cols // 8)).astype(np.float32)
    sigma_block[::3, ::4] = 0.0  # passthrough blocks (1/sigma below MIN_SIGMA)
    lanes = []
    for pred in (5, 1, 2):  # Gradient, West, North (device_lossless._PRED_*)
        dims = [(16, 24)] * 3 + [(8, 40)] * 2 + [(33, 17)]
        n = sum(h * w for h, w in dims)
        lanes.append((pred, rng.integers(-200, 201, n).astype(np.int32), dims))
    return {
        # 3x3 groups, the last group row 4 rows and the last column 8
        # columns high and wide: on a 2x2 grid the visible edge falls
        # inside the halo of the shard boundary at 512
        "vardct": encode_xyb_vardct(520, 516, seed=3, density=0.1)[0],
        # two groups side by side, decoded by the lane decoder (its plain
        # version here): on a 2x2 grid the bottom row of tiles is empty
        "vardct_lanes": encode_xyb_vardct(264, 40, seed=4, density=0.05)[0],
        "planes": planes,
        "sigma_block": sigma_block,
        "sigma_px": np.repeat(np.repeat(sigma_block, 8, 0), 8, 1),
        "halo_x": np.arange(128 * 32, dtype=np.float32).reshape(128, 32),
        "lanes": lanes,
        "jax_lanes": rng.integers(-(1 << 17), 1 << 17, (8, 64, 64)).astype(np.int32),
        "anim": anim_crop_replace_stream(320, 200, (288, 96), num_frames=7, seed=11,
                                         density=0.1),
        "anim_ineligible": anim_vardct_stream(320, 200, (288, 96), num_frames=3, seed=12),
    }


def frame_of(data: bytes):
    """The port's parsed frame of a one-frame stream (headers only): what
    the filters and the colour transform read."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    return parse_frame(br, fh)


def _row_shard(x: np.ndarray, grid, block: int = 1) -> torch.Tensor:
    """This rank's rows of x (..., rows, cols) by row_spans (in units of
    `block` rows: 8 for a map of 8x8 blocks)."""
    from jxl_tpu_torch.parallel.sharded_render import row_spans

    a, b = row_spans(x.shape[-2] * block, grid.ny)[grid.sy]
    return torch.from_numpy(np.ascontiguousarray(x[..., a // block : -(-b // block), :]))


def run(world, inp: dict) -> dict:
    """Every case on this rank; {case: numpy result or ("raises", class
    name)}."""
    from jxl_tpu_torch.errors import NotSupported
    from jxl_tpu_torch.modular.device_lossless import split_lanes
    from jxl_tpu_torch.ops.device_render import RenderParams
    from jxl_tpu_torch.parallel import multihost
    from jxl_tpu_torch.parallel import sharded_render as SR

    out = {}
    g2 = SR.make_grid_2d(world)
    g1 = SR.make_grid(world)
    out["vardct_lanes_f32"] = SR.decode_sharded(inp["vardct_lanes"], g2, "f32").numpy()
    # the rest decode their AC on the native host decoder: the lane
    # decoder's plain version steps one token at a time in Python
    os.environ["JXL_TPU_AC"] = "host"
    for fmt in FORMATS:
        out[f"vardct_{fmt}"] = SR.decode_sharded(inp["vardct"], g2, fmt).numpy()

    frame = frame_of(inp["vardct"])
    rows = inp["planes"].shape[1]
    planes = _row_shard(inp["planes"], g1)
    sigma_px = _row_shard(inp["sigma_px"], g1)
    for fmt in FORMATS:
        shard = SR.sharded_filters_and_color(g1, frame, planes, sigma_px, rows, fmt)
        out[f"filters_{fmt}"] = SR.gather_rows(g1, shard).numpy()
    shard = SR.sharded_render(g1, RenderParams(), planes, _row_shard(inp["sigma_block"], g1, 8),
                              rows)
    out["render"] = SR.gather_rows(g1, shard).numpy()

    x = _row_shard(inp["halo_x"], g1)
    out["halo_rows"] = torch.cat(world.all_gather(
        SR.exchange_halo_rows(x, HALO_ROWS, g1))).numpy()
    cols = SR.ShardGrid(world, 1, world.size)
    xt = torch.from_numpy(np.ascontiguousarray(inp["halo_x"].T))  # (32, rows): split by columns
    n = xt.shape[1] // world.size
    xc = xt[:, world.rank * n : (world.rank + 1) * n].contiguous()
    out["halo_cols"] = torch.cat(world.all_gather(
        SR.exchange_halo_cols(xc, HALO_ROWS, cols)), dim=1).numpy()

    for pred, res, dims in inp["lanes"]:
        out[f"lanes_{pred}"] = split_lanes(world, pred, torch.from_numpy(res), dims).numpy()
    jl = inp["jax_lanes"]
    out["jax_lanes"] = split_lanes(world, 5, torch.from_numpy(jl.reshape(-1)),
                                   [jl.shape[1:]] * len(jl)).numpy().reshape(jl.shape)

    for fmt in FORMATS:
        frames = multihost.decode_animation_multihost(inp["anim"], world, fmt)
        out[f"anim_{fmt}"] = np.stack([f.numpy() for f in frames])
    try:
        multihost.decode_animation_multihost(inp["anim_ineligible"], world)
        out["anim_ineligible"] = ("returned", None)
    except NotSupported as e:
        out["anim_ineligible"] = ("raises", type(e).__name__)
    out["exchange_bytes"] = world.exchange_bytes
    return out


def fail_on_rank_one(world):
    """A rank function whose rank 1 raises."""
    if world.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return world.rank
