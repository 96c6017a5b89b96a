"""The lossless Modular lanes of jxl_tpu_torch (modular/device_lossless.py,
ops/lossless_lanes.py) on the CPU, against jxl_tpu's lanes
(modular/device_lossless.py:_program, JAX on the CPU) and the native host
reconstruction, and whole decodes of the writer's lane streams
(tests/test_torch_streams.py, predictors=) against jxl_tpu's decode and
the writer's planes.

Tolerance: bit for bit everywhere but the rendered pixels, which go
through the colour path (f32 within 1e-4, u8 within 1 LSB, as the port's
other Modular decode tests state). The corpus-free cases mirror
tests/test_device_lossless.py:51-121. K4 itself runs only on the card:
test_k4_matches_plain_version skips here (chip_smoke.py holds it there);
on the CPU, _k4_model replays the kernel's schedule (its tile words, edge
rings and flags, warps interleaved at random) against the native loop.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu import native as ref_native
from jxl_tpu.modular import device_lossless as ref_dl
from jxl_tpu.utils import trace as ref_trace
from jxl_tpu_torch import native
from jxl_tpu_torch.modular import device_lossless as DL
from jxl_tpu_torch.ops import lossless_lanes as LL
from jxl_tpu_torch.utils import trace
from test_torch_streams import GRADIENT, NORTH, WEST, ZERO, encode_xyb_modular

G, W_, N_ = ref_dl._PRED_GRADIENT, ref_dl._PRED_WEST, ref_dl._PRED_NORTH


def _ref_lane(kind, res):
    """jxl_tpu's lane program on one (h, w) channel, padded as it pads."""
    h, w = res.shape
    H, W = ref_dl._pow2ceil(h), ref_dl._pow2ceil(w)
    batch = np.zeros((8, H, W), np.int32)
    batch[0, :h, :w] = res
    return np.asarray(ref_dl._program(kind, 8, H, W, "int32")(batch))[0, :h, :w]


def _native_gradient(res):
    out = res.copy()
    native.gradient_reconstruct(out)
    return out


@pytest.fixture(scope="module")
def ref_native_lib():
    """jxl_tpu's native library, loaded: its lanes take a stream only when
    it is there. Test workers race to build it and a loser's call finds
    no library; a later call loads the one the winner built."""
    import time

    for _ in range(20):
        if ref_native.get_lib() is not None:
            return
        time.sleep(0.5)
    raise RuntimeError("jxl_tpu's native library did not build")


def _oracle_west_north(res, pred):
    """Scalar oracle of the West and North predictors (int32 wrap at
    every step), as tests/test_device_lossless.py writes it."""
    h, w = res.shape
    v = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            left = v[y, x - 1] if x > 0 else (v[y - 1, 0] if y > 0 else 0)
            top = v[y - 1, x] if y > 0 else left
            g = int(left) if pred == W_ else int(top)
            v[y, x] = ((g + int(res[y, x]) + (1 << 31)) % (1 << 32)) - (1 << 31)
    return v.astype(np.int32)


# -- the plain versions ------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(1, 1), (1, 7), (5, 1), (3, 3), (13, 29), (64, 64),
                                 (128, 37), (256, 256)])
def test_wavefront_matches_native(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    res = rng.integers(-(1 << 18), 1 << 18, size=(h, w), dtype=np.int32)
    want = _native_gradient(res)
    got = LL.wavefront_plain(torch.from_numpy(res)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    if (h, w) in ((13, 29), (256, 256)):
        np.testing.assert_array_equal(_ref_lane(G, res), want)


@pytest.mark.parametrize("pred", [W_, N_])
@pytest.mark.parametrize("h,w", [(1, 5), (5, 1), (7, 13), (32, 32)])
def test_cumsum_lanes_match_oracle(pred, h, w):
    rng = np.random.default_rng(pred * 100 + h * 10 + w)
    res = rng.integers(-(1 << 20), 1 << 20, size=(h, w), dtype=np.int32)
    want = _oracle_west_north(res, pred)
    lane = LL.cumsum_west if pred == W_ else LL.cumsum_north
    for wire in (np.int32, np.int16):
        r = np.clip(res, -32768, 32767) if wire is np.int16 else res
        exp = want if wire is np.int32 else _oracle_west_north(r, pred)
        got = lane(torch.from_numpy(r.astype(wire))[None])[0].numpy()
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(_ref_lane(pred, res), want)
    host = res.copy()
    DL._reconstruct_host(host, pred)
    np.testing.assert_array_equal(host, want)


@pytest.mark.parametrize("pred", [W_, N_])
def test_cumsum_lanes_wraparound_exact(pred):
    """int32 overflow wraps alike in the torch lanes (summed in int64, then
    wrapped back), jxl_tpu's, numpy's host lane and the scalar oracle."""
    rng = np.random.default_rng(pred)
    res = rng.choice([-(1 << 30), 1 << 30, 1 << 29], size=(3, 16, 16)).astype(np.int32)
    lane = LL.cumsum_west if pred == W_ else LL.cumsum_north
    got = lane(torch.from_numpy(res)).numpy()
    want = np.asarray(ref_dl._program(pred, 3, 16, 16, "int32")(res))
    np.testing.assert_array_equal(got, want)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _oracle_west_north(res[i], pred))
        host = res[i].copy()
        DL._reconstruct_host(host, pred)
        np.testing.assert_array_equal(host, got[i])


def test_wrap_i32():
    x = torch.tensor([0, 1, -1, (1 << 31) - 1, 1 << 31, -(1 << 31) - 1, (1 << 33) + 5],
                     dtype=torch.int64)
    assert LL.wrap_i32(x).tolist() == [0, 1, -1, (1 << 31) - 1, -(1 << 31), (1 << 31) - 1, 5]


def test_wavefront_extreme_residuals_at_gate():
    """Residuals just inside the overflow gate stay int32-exact."""
    rng = np.random.default_rng(7)
    lim = (1 << 31) // (3 * (64 + 64 - 1)) - 1
    res = rng.choice([-lim, lim], size=(64, 64)).astype(np.int32)
    want = _native_gradient(res)
    np.testing.assert_array_equal(LL.wavefront_plain(torch.from_numpy(res)[None])[0].numpy(),
                                  want)
    out = np.asarray(ref_dl._program(G, 1, 64, 64, "int32")(res[None]))
    np.testing.assert_array_equal(out[0], want)


def test_large_dim_lane():
    """A 1024x640 lane (channels up to MAX_DIM take the lanes)."""
    rng = np.random.default_rng(11)
    res = rng.integers(-255, 256, size=(1024, 640), dtype=np.int32)
    want = _native_gradient(res)
    got = LL.gradient_wavefront(torch.from_numpy(res.astype(np.int16)).reshape(-1),
                                [(1024, 640)])
    np.testing.assert_array_equal(got.numpy().reshape(1024, 640), want)


def test_gradient_reconstruct_row_slice_stride():
    """The native binding honours row strides (views into larger planes)."""
    rng = np.random.default_rng(3)
    plane = rng.integers(-100, 100, size=(16, 32), dtype=np.int32)
    before = plane.copy()
    view = plane[:, 4:20]
    compact = np.ascontiguousarray(view)
    native.gradient_reconstruct(view)
    native.gradient_reconstruct(compact)
    np.testing.assert_array_equal(view, compact)
    np.testing.assert_array_equal(plane[:, 20:], before[:, 20:])
    np.testing.assert_array_equal(plane[:, :4], before[:, :4])
    with pytest.raises(ValueError):
        native.gradient_reconstruct(plane[:, ::2])
    with pytest.raises(ValueError):
        native.gradient_reconstruct(plane.astype(np.int64))


@pytest.mark.parametrize("wire", [np.int16, np.int32])
def test_packed_lanes_of_mixed_shapes(wire):
    """gradient_wavefront over lanes of their own (h, w), back to back in
    one flat buffer: each lane as the native loop reconstructs it alone."""
    rng = np.random.default_rng(21)
    dims = [(5, 7), (256, 256), (5, 7), (112, 256), (1, 1), (3, 300)]
    lanes = [rng.integers(-300, 300, size=d, dtype=np.int32) for d in dims]
    flat = torch.from_numpy(np.concatenate([x.reshape(-1) for x in lanes]).astype(wire))
    got = LL.gradient_wavefront(flat, dims).numpy()
    pos = 0
    for x in lanes:
        np.testing.assert_array_equal(got[pos : pos + x.size].reshape(x.shape),
                                      _native_gradient(x))
        pos += x.size
    assert LL.gradient_wavefront_plain(flat, dims).equal(torch.from_numpy(got))


def test_wrapper_checks_its_inputs():
    flat = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes of 10 samples"):
        LL.gradient_wavefront(flat, [(2, 5)])
    with pytest.raises(ValueError):
        LL.gradient_wavefront(flat, [(0, 12)])
    with pytest.raises(TypeError):
        LL.gradient_wavefront(flat.to(torch.int64), [(3, 4)])
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        LL.gradient_wavefront(flat.to("meta"), [(3, 4)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("K4 runs only on a CUDA card (chip_smoke.py holds it on the H100)")
    return torch.device("cuda")


# K4's edge cases, as chip_smoke.py's lossless phase (c) has them: heights
# about a strip (32 rows), widths of 1, 2 and 2048, a lane taller than a
# block's eight strips; each set but the last after a 1x1 lane, so that its
# lanes start at odd offsets of the packed buffer (K4's scalar path)
K4_EDGE_SETS = {
    "h_w1": [(1, 1), (1, 1), (31, 1), (32, 1), (33, 1), (257, 1)],
    "h_w2": [(1, 1), (1, 2), (31, 2), (32, 2), (33, 2), (257, 2)],
    "h_w2048": [(1, 1), (1, 2048), (31, 2048), (32, 2048), (33, 2048), (257, 2048)],
    "tall_2048x64": [(1, 1), (2048, 64)],
    "mixed": [(1, 1), (3, 5), (33, 31), (31, 33), (1, 7), (257, 40), (32, 32)],
    # every lane's rows on 16 bytes (widths of 8, sizes of 8): K4's vector path
    "aligned": [(33, 64), (31, 32), (257, 40), (1, 8), (17, 8), (32, 2048), (2048, 64)],
}


def _k4_edge_case(name, wire, seed):
    """(flat residuals, dims) of an edge set: int16 or int32 at random,
    "gate": int32 at the overflow gate's edge of its largest lane, or
    "wrap": int32 past it (sums wrap)."""
    dims = K4_EDGE_SETS[name]
    rng = np.random.default_rng(seed)
    n = sum(h * w for h, w in dims)
    if wire == "gate":
        lim = (1 << 31) // (3 * max(h + w - 1 for h, w in dims)) - 1
        return rng.choice([-lim, lim], n).astype(np.int32), dims
    if wire == "wrap":
        return rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32), dims
    hi = 2000 if wire == "int16" else 1 << 20
    return rng.integers(-hi, hi, n).astype(wire), dims


def _wrap(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _k4_model(res, h, w, rng=None):
    """csrc/lossless_lanes.cu's block on one (h, w) lane, on the CPU: the
    same tile words (row k holds column x at (x + k) mod 64, pitch 66), the
    same staging, write-back, edge rings and flags, each warp's 32 lanes as
    numpy vectors. Warps run as generators that yield where the kernel
    waits or publishes; `rng` interleaves them at random (None: in turn).
    Raises on a deadlock."""
    g = LL.GEOMETRY
    NW, R, C, HF, P = g["warps"], g["strip_rows"], g["chunk_cols"], g["handoff_cols"], g["pitch"]
    span = 2 * C  # a tile row's columns: two chunks
    nstrips, nch = -(-h // R), -(-w // C)
    tiles = np.zeros((NW, R * P), np.int64)
    rings = np.zeros((NW, nch * C), np.int64)
    ready = [0] * NW
    r = np.asarray(res, np.int64).reshape(-1)
    v = np.zeros(h * w, np.int64)
    lane = np.arange(R)

    def strip(warp, q):
        y0, rows = q * R, min(R, h - q * R)
        up_i, dn_i = (q + NW - 1) % NW, q % NW
        up_base, dn_base = (q - 1) // NW * w, q // NW * w
        feeds = q + 1 < nstrips
        tile = tiles[warp]

        def load(i, col):
            ok = (i < rows) & (col < w)
            return np.where(ok, r[(y0 + min(i, rows - 1)) * w + np.minimum(col, w - 1)], 0)

        def word(y, col):  # tile word of row y, column col
            return y * P + ((col + y) & (span - 1))

        tile[lane[:, None] * P + np.arange(C)[None, :]] = 0
        for i in range(HF):
            tile[word(i, lane)] = load(i, lane)
        l = tp = val = np.zeros(R, np.int64)
        seen = 0
        for c in range(nch + 1):
            for half in range(2):
                s0 = c * C + half * HF
                g0 = HF if half == 0 else 0
                dcol = ((c - 2) if half == 0 else (c - 1)) * C + lane
                scol = (c if half == 0 else c + 1) * C + lane
                drain = (dcol >= 0) & (dcol < w)
                stage = scol[0] < nch * C
                n = rows - g0
                if q == 0 or s0 >= w:
                    e = np.zeros(HF, np.int64)
                else:
                    need = up_base + min(s0 + HF, w)
                    while seen < need:
                        seen = ready[up_i]
                        if seen < need:
                            yield "wait"
                    e = rings[up_i, s0 : s0 + HF].copy()
                pf = [load(g0 + i, scol) if stage and i < n else 0 for i in range(HF)]
                o = [tile[word(g0 + i, dcol)] for i in range(HF)]
                at = lane * P + (s0 & (span - 1))
                for u in range(HF):
                    t = np.roll(val, 1)
                    t[0] = e[u]
                    # the kernel's branch-free form: l + t + r - median(l, tl, t)
                    m = np.maximum(np.minimum(l, tp), np.minimum(np.maximum(l, tp), t))
                    val = _wrap(l + tile[at + u] + t - m)
                    tile[at + u] = val
                    tp, l = t, val
                    if u < n:
                        v[((y0 + g0 + u) * w + dcol)[drain]] = o[u][drain]
                yield "steps"
                if feeds:
                    x = s0 - (R - 1) + lane[:HF]
                    ok = (x >= 0) & (x < w)
                    rings[dn_i, x[ok]] = tile[(R - 1) * P + (s0 & (span - 1)) + lane[:HF][ok]]
                    ready[dn_i] = dn_base + min(max(s0 + HF - (R - 1), 0), w)
                    yield "published"
                if stage:
                    for i in range(HF):
                        tile[word(g0 + i, scol)] = pf[i]
        dcol = (nch - 1) * C + lane
        ok = dcol < w
        for i in range(HF, min(R, rows)):
            v[((y0 + i) * w + dcol)[ok]] = tile[word(i, dcol)][ok]

    def warp_run(warp):
        for q in range(warp, nstrips, NW):
            yield from strip(warp, q)

    live = {i: warp_run(i) for i in range(NW)}
    stalled = 0
    while live:
        keys = sorted(live)
        k = keys[rng.integers(len(keys))] if rng is not None else keys[stalled % len(keys)]
        try:
            what = next(live[k])
        except StopIteration:
            del live[k]
            stalled = 0
            continue
        stalled = stalled + 1 if what == "wait" else 0
        if stalled > 50 * NW:
            raise RuntimeError(f"the K4 schedule deadlocked on a {h}x{w} lane")
    return _wrap(v).astype(np.int32).reshape(h, w)


@pytest.mark.parametrize("wire", ["int16", "int32", "gate", "wrap"])
@pytest.mark.parametrize("name", list(K4_EDGE_SETS))
def test_k4_schedule_matches_native(name, wire):
    """The kernel's schedule on every lane of an edge set equals the native
    loop, warps in turn for int16 and at random for the others."""
    res, dims = _k4_edge_case(name, wire, seed=len(name))
    rng = None if wire == "int16" else np.random.default_rng(len(name) * 7 + len(wire))
    pos = 0
    for h, w in dims:
        lane = res[pos : pos + h * w].astype(np.int32).reshape(h, w)
        np.testing.assert_array_equal(_k4_model(lane, h, w, rng), _native_gradient(lane))
        pos += h * w


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k4_schedule_any_interleaving(seed):
    """Two rounds of strips (300 rows on eight warps) under four random
    interleavings of the warps: the edge rings need no back-pressure."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-5000, 5000, size=(300, 70), dtype=np.int32)
    np.testing.assert_array_equal(_k4_model(res, 300, 70, rng), _native_gradient(res))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int16", "int32", "gate", "wrap"])
@pytest.mark.parametrize("name", list(K4_EDGE_SETS) + ["decode_shapes"])
def test_k4_matches_plain_version(card, name, wire):
    if name == "decode_shapes":  # the 4K decode's lane shapes and a tall lane
        rng = np.random.default_rng(5)
        dims = [(256, 256), (112, 256), (7, 3), (1, 1), (2048, 64)]
        hi = {"int16": 2000, "wrap": 1 << 30}.get(wire, 1 << 20)
        n = sum(h * w for h, w in dims)
        res = rng.integers(-hi, hi, n).astype(np.int32 if wire != "int16" else np.int16)
    else:
        res, dims = _k4_edge_case(name, wire, seed=len(name))
    res = torch.from_numpy(res).to(card)
    before = LL.gradient_wavefront.launches
    got = LL.gradient_wavefront(res, dims)
    assert LL.gradient_wavefront.launches == before + 1
    assert torch.equal(got, LL.gradient_wavefront_plain(res, dims))


# -- whole decodes -----------------------------------------------------------------

# 266x270: four groups, the last one 10x14 (3 channels, 420 samples: under
# MIN_STREAM_PX, decoded on the host); "big": channel 1's residuals of
# 2^21 put its 256x256 tiles over the gradient gate (host lanes) and its
# 10x256 and 256x14 tiles under it
STREAMS = {
    "mixed": dict(predictors=(GRADIENT, WEST, NORTH)),
    "alpha": dict(predictors=(NORTH, GRADIENT, ZERO, GRADIENT), num_ec=1),
    "big": dict(predictors=(GRADIENT, GRADIENT, WEST), big=(1, 21)),
    "single": dict(predictors=(GRADIENT, NORTH, WEST)),  # one group, 200x150
}
_CACHE = {}


def _stream(name):
    if name not in _CACHE:
        size = (200, 150) if name == "single" else (266, 270)
        _CACHE[name] = encode_xyb_modular(*size, seed=31, filters=False, **STREAMS[name])
    return _CACHE[name]


def _lossless_counters(metrics):
    return {k: v for k, v in metrics.counters.items()
            if k.startswith("lossless_") and not k.endswith(("_bytes", "_calls"))}


def _port_channels(data, mode, monkeypatch):
    """The port's decoded Modular channels (before any transform) and its
    lane counters, sections decoded on the CPU under JXL_TPU_DEV_LOSSLESS."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", mode)
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    trace.enable()
    trace.reset()
    try:
        frame.decode_all_sections(br, "cpu")
        counters = _lossless_counters(trace.metrics)
    finally:
        trace.enable(False)
    n = 3 + len(fh.image_metadata.extra_channel_info)
    return [frame.modular_channel(c) for c in range(n)], counters


def _ref_channels(data, monkeypatch):
    from jxl_tpu.api.simple import decode_first_frame

    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", "1")
    was = ref_trace.enabled()
    ref_trace.enable()
    ref_trace.reset()
    try:
        dec = decode_first_frame(data)
        counters = _lossless_counters(ref_trace.metrics)
    finally:
        ref_trace.enable(was)
    return [np.asarray(c) for c in dec.channels], counters


@pytest.mark.parametrize("name", list(STREAMS))
def test_lane_decode_matches_jxl_tpu_and_the_writer(name, monkeypatch, ref_native_lib):
    data, planes = _stream(name)
    want, ref_counters = _ref_channels(data, monkeypatch)
    lanes, counters = _port_channels(data, "1", monkeypatch)
    host, host_counters = _port_channels(data, "0", monkeypatch)
    assert len(lanes) == len(planes) == len(want)
    for c in range(len(planes)):
        np.testing.assert_array_equal(lanes[c], planes[c])
        np.testing.assert_array_equal(lanes[c], want[c])
        np.testing.assert_array_equal(host[c], planes[c])
    # the same lanes took the same routes in both packages
    assert counters == ref_counters
    assert counters["lossless_device_lanes"] > 0 and host_counters == {}
    if name == "big":
        assert counters["lossless_host_lanes"] == 1  # the 256x256 tile of channel 1
    if name != "single":
        assert counters["lossless_px_ineligible"] == 10 * 14 * (4 if name == "alpha" else 3)


@pytest.mark.parametrize("fmt", ["f32", "u8"])
@pytest.mark.parametrize("name", ["mixed", "alpha"])
def test_lane_decode_image_matches(name, fmt, monkeypatch, ref_native_lib):
    """decode_image under JXL_TPU_DEV_LOSSLESS=1 equals =0 bit for bit, and
    jxl_tpu's decode within the colour path's bound."""
    from jxl_tpu.api.simple import decode_image as ref_decode

    data, _ = _stream(name)
    out = {}
    for mode in "10":
        monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", mode)
        out[mode] = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0]
    assert torch.equal(out["1"], out["0"])
    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", "1")
    want = ref_decode(data, pixel_format=fmt).frames[0]
    got = out["1"].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert diff <= (1.0 if fmt == "u8" else 1e-4)


def _truncated(pkg, data, cut, monkeypatch):
    """Decode the single-group lane stream's global section, cut `cut`
    bytes short, through `pkg`'s lanes with a partial_out: (the channels,
    the count of channels decoded before the error)."""
    import importlib

    simple = importlib.import_module(f"{pkg}.api.simple")
    image = importlib.import_module(f"{pkg}.modular.image")
    decode = importlib.import_module(f"{pkg}.modular.decode")
    dl = importlib.import_module(f"{pkg}.modular.device_lossless")
    errors = importlib.import_module(f"{pkg}.errors")
    BitReader = importlib.import_module(f"{pkg}.io.bit_reader").BitReader
    FileHeader = importlib.import_module(f"{pkg}.io.headers").FileHeader

    d = data[: len(data) - cut]
    br = BitReader(d)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = simple.parse_frame(br, fh)
    got = {}

    def read_section0(self, frame_header, tree, br, allow_partial=False):
        bufs = [self.storage[b] for b in self.section_buffer_indices[0]]
        partial = [0]
        ctx = dl.BatchContext("cpu") if pkg == "jxl_tpu_torch" else dl.BatchContext()
        with dl.activate(ctx), pytest.raises(errors.JxlError):
            decode.decode_modular_subbitstream(bufs, 0, self.global_header, tree, br,
                                               partial_out=partial)
        got["bufs"], got["n"] = [np.asarray(b.data) for b in bufs], partial[0]

    monkeypatch.setattr(image.FullModularImage, "read_section0", read_section0)
    frame.decode_lf_global(BitReader(d[br.pos // 8 :]))
    return got["bufs"], got["n"]


@pytest.mark.parametrize("cut", [3000, 9000])
def test_truncated_stream_keeps_pixels(cut, monkeypatch, ref_native_lib):
    """A stream cut short raises; the channels decoded before the cut hold
    pixels (the writer's planes), not residuals, as in jxl_tpu."""
    data, planes = _stream("single")
    got, n = _truncated("jxl_tpu_torch", data, cut, monkeypatch)
    want, n_ref = _truncated("jxl_tpu", data, cut, monkeypatch)
    assert n == n_ref == (2 if cut == 3000 else 1)
    for c in range(n):
        np.testing.assert_array_equal(got[c], planes[c])
        np.testing.assert_array_equal(want[c], planes[c])


def test_auto_is_off_on_the_cpu(monkeypatch):
    """auto (the default) never takes the lanes: they lost on the card
    (PERF.md), and the CPU runs their plain versions."""
    monkeypatch.delenv("JXL_TPU_DEV_LOSSLESS", raising=False)
    assert not DL.enabled("cpu") and not DL.enabled("cuda")
    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", "auto")
    assert not DL.enabled("cpu") and not DL.enabled("cuda")
    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", "1")
    assert DL.enabled("cpu") and DL.enabled("cuda")
    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", "0")
    assert not DL.enabled("cpu") and not DL.enabled("cuda")


def test_only_the_whole_frame_decode_takes_the_lanes(monkeypatch):
    """The streaming decoder's section-by-section path decodes the lane
    stream on the host: no BatchContext is active outside
    decode_all_sections."""
    from jxl_tpu_torch.api.decoder import Event, JxlDecoder

    data, planes = _stream("mixed")
    monkeypatch.setenv("JXL_TPU_DEV_LOSSLESS", "1")
    calls = []
    real = DL.BatchContext.submit
    monkeypatch.setattr(DL.BatchContext, "submit",
                        lambda self, *a: calls.append(1) or real(self, *a))
    dec = JxlDecoder(device="cpu")
    dec.feed(data)
    dec.end_input()
    while dec.process() is not Event.COMPLETE:
        pass
    assert calls == []
    want = jxl_tpu_torch.decode_image(data, device="cpu").frames[0]
    assert calls and torch.equal(dec.frames[0], want)
