"""The port's command line (jxl_tpu_torch/cli.py), its tracing
(utils/trace.py) and colour management (color/cms.py) against jxl_tpu's
on the same writer streams, on the CPU (--device cpu):

- each image writer, given the same array, writes jxl_tpu's bytes;
- each output format of a decode, read back, within 1 LSB (8-bit) or
  f32 1e-4 of jxl_tpu.cli's file, an animation as APNG and as numbered
  PNGs, the --info text equal, --to_srgb pixels within f32 1e-4;
- --render_interval's partial renders and --preview through the
  streaming decoder, --speedtest, --print_timings and --profile_dir;
- the card is the default and a decode raises without one;
- lcms2's sRGB profile and transforms equal jxl_tpu's, and a missing
  liblcms2 raises.

The decodes take the host AC route (JXL_TPU_AC=host).
"""

import io
import zlib
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from jxl_tpu import cli as R
from jxl_tpu_torch import cli as P
from jxl_tpu_torch.utils import trace
from test_torch_frame_streams import anim_vardct_stream, lf_frame_stream
from test_torch_icc import PROFILES
from test_torch_layouts import as_jxl_tpu_edges
from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

_CACHE = {}
STREAMS = {
    "vardct": lambda: encode_xyb_vardct(264, 136, seed=101, density=0.05)[0],
    "rgba": lambda: encode_xyb_vardct(264, 136, seed=102, density=0.05, num_ec=1)[0],
    "anim": lambda: anim_vardct_stream(320, 200, (288, 96), num_frames=3, seed=103,
                                       preview=True),
    "lf_frame": lambda: lf_frame_stream(320, 200, passes=2, seed=104, density=0.1),
    "p3_jpeg": lambda: encode_ycbcr_vardct(264, 64, seed=105, density=0.05, filters=False,
                                           icc=PROFILES["display_p3"]())[0],
}


@pytest.fixture(autouse=True)
def host_ac(monkeypatch):
    monkeypatch.setenv("JXL_TPU_AC", "host")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small renders run many short torch ops,
    which, beside other test workers' threads, wait on each other's cores
    far longer than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jxl(tmp_path):
    def path(name):
        if name not in _CACHE:
            _CACHE[name] = STREAMS[name]()
        p = tmp_path / f"{name}.jxl"
        p.write_bytes(_CACHE[name])
        return str(p)
    return path


def cli(mod, *argv):
    """Run a package's CLI in this process: (exit code, stdout)."""
    out = io.StringIO()
    args = list(argv) + (["--device", "cpu"] if mod is P else [])
    with redirect_stdout(out):
        rc = mod.main(args)
    return rc, out.getvalue()


# -- writers -----------------------------------------------------------------------------


def _arrays():
    rng = np.random.default_rng(7)
    f = rng.uniform(-0.1, 1.1, size=(9, 13, 4)).astype(np.float32)
    return {
        "f32": f,
        "u8": (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8),
        "u16": (np.clip(f, 0, 1) * 65535 + 0.5).astype(np.uint16),
    }


WRITER_CASES = [("write_png", "u8", 4), ("write_png", "u16", 3), ("write_png", "f32", 2),
                ("write_png", "f32", 1), ("write_ppm", "u8", 3), ("write_ppm", "f32", 3),
                ("write_pgm", "u8", 1), ("write_pgm", "f32", 3), ("write_pfm", "f32", 3),
                ("write_npy", "f32", 4), ("write_exr", "f32", 3), ("write_exr", "f32", 4)]


@pytest.mark.parametrize("writer,dtype,channels", WRITER_CASES)
def test_writers_write_jxl_tpus_bytes(writer, dtype, channels, tmp_path):
    arr = _arrays()[dtype][..., :channels]
    ext = ".npy" if writer == "write_npy" else ".out"
    getattr(P, writer)(str(tmp_path / f"p{ext}"), arr)
    getattr(R, writer)(str(tmp_path / f"r{ext}"), arr)
    assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"r{ext}").read_bytes()


def test_apng_writer_writes_jxl_tpus_bytes(tmp_path):
    a = _arrays()
    frames = [a["u8"][..., :3], a["f32"][..., :3]]
    P.write_apng(str(tmp_path / "p.apng"), frames, [40.0, 12.5])
    R.write_apng(str(tmp_path / "r.apng"), frames, [40.0, 12.5])
    assert (tmp_path / "p.apng").read_bytes() == (tmp_path / "r.apng").read_bytes()


# -- readers for the comparisons --------------------------------------------------------------


def read_png(path) -> np.ndarray:
    """8- or 16-bit PNG (filter 0 rows, as the writers write) as (h, w, c)."""
    b = open(path, "rb").read()
    pos, idat, ihdr = 8, b"", None
    while pos < len(b):
        n = int.from_bytes(b[pos : pos + 4], "big")
        tag, payload = b[pos + 4 : pos + 8], b[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            ihdr = payload
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + n
    w, h = int.from_bytes(ihdr[:4], "big"), int.from_bytes(ihdr[4:8], "big")
    depth, c = ihdr[8], {0: 1, 4: 2, 2: 3, 6: 4}[ihdr[9]]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 1:]
    if depth == 16:
        return raw.copy().view(">u2").astype(np.uint16).reshape(h, w, c)
    return raw.reshape(h, w, c)


def read_pnm(path) -> np.ndarray:
    b = open(path, "rb").read()
    magic, dims, _, rest = b.split(b"\n", 3)
    w, h = map(int, dims.split())
    if magic == b"PF":
        return np.frombuffer(rest, "<f4").reshape(h, w, 3)[::-1]
    return np.frombuffer(rest, np.uint8).reshape(h, w, -1)


def read_exr(path, channels) -> np.ndarray:
    b = open(path, "rb").read()
    # the last attribute, then the header's terminating zero byte
    pos = b.index(b"screenWindowWidth\0float\0") + len(b"screenWindowWidth\0float\0") + 9
    first = int.from_bytes(b[pos : pos + 8], "little")
    h = (first - pos) // 8
    rows = np.frombuffer(b[first:], np.uint8).reshape(h, -1)[:, 8:]
    return rows.copy().view(np.float16).reshape(h, channels, -1).transpose(0, 2, 1)


def close(a, b, fmt):
    a, b = np.asarray(a).astype(np.float64), np.asarray(b).astype(np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= (1.0 if fmt == "int" else 1e-4 if fmt == "f32" else 2e-3)


# -- decodes ----------------------------------------------------------------------------------


@pytest.mark.parametrize("ext,reader,fmt", [
    (".png", read_png, "int"), (".ppm", read_pnm, "int"), (".pgm", read_pnm, "int"),
    (".pfm", read_pnm, "f32"), (".npy", np.load, "f32"), (".exr", None, "f16")])
@pytest.mark.parametrize("name", ["vardct", "rgba"])
def test_outputs_match_jxl_tpu(name, ext, reader, fmt, jxl, tmp_path):
    src = jxl(name)
    outs = []
    for mod, tag in ((P, "p"), (R, "r")):
        path = str(tmp_path / f"{tag}{ext}")
        rc, text = cli(mod, src, path)
        assert rc == 0 and "wrote" in text
        outs.append(read_exr(path, 4 if name == "rgba" else 3) if ext == ".exr"
                    else reader(path))
    close(*outs, fmt)
    assert outs[0].shape[:2] == (136, 264)


def test_sixteen_bit_png_matches_jxl_tpu(jxl, tmp_path):
    src = jxl("vardct")
    for mod, tag in ((P, "p"), (R, "r")):
        assert cli(mod, src, str(tmp_path / f"{tag}.png"), "--bits_per_sample", "16")[0] == 0
    a, b = read_png(tmp_path / "p.png"), read_png(tmp_path / "r.png")
    assert a.dtype == np.uint16
    close(a, b, "int")


@pytest.mark.parametrize("ext", [".apng", ".png"])
def test_animation_outputs_match_jxl_tpu(ext, jxl, tmp_path):
    src = jxl("anim")
    for mod, tag in ((P, "p"), (R, "r")):
        assert cli(mod, src, str(tmp_path / f"{tag}{ext}"))[0] == 0
    if ext == ".apng":
        a, b = (tmp_path / "p.apng").read_bytes(), (tmp_path / "r.apng").read_bytes()
        assert len(a) > 1000 and a.count(b"fcTL") == b.count(b"fcTL") == 3
        assert read_png(tmp_path / "p.apng").shape == (200, 320, 3)
        close(read_png(tmp_path / "p.apng"), read_png(tmp_path / "r.apng"), "int")
    else:
        for i in range(3):
            close(read_png(tmp_path / f"p_{i:03d}.png"), read_png(tmp_path / f"r_{i:03d}.png"),
                  "int")


@pytest.mark.parametrize("name", ["vardct", "rgba", "anim", "p3_jpeg"])
def test_info_text_matches_jxl_tpu(name, jxl):
    src = jxl(name)
    got, want = cli(P, src, "--info"), cli(R, src, "--info")
    assert got == want and got[1].startswith("dimensions:")


def test_info_needs_no_card(jxl):
    """--info reads headers only, with the default --device."""
    out = io.StringIO()
    with redirect_stdout(out):
        assert P.main([jxl("vardct"), "--info"]) == 0
    assert out.getvalue().startswith("dimensions: 264x136")


def test_decode_defaults_to_the_card(jxl, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main([jxl("vardct"), str(tmp_path / "o.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main([jxl("vardct"), str(tmp_path / "o.png"), "--render_interval", "100"])


def test_to_srgb_matches_jxl_tpu(jxl, tmp_path, monkeypatch):
    """A Display P3 JPEG-style frame converted to sRGB through lcms2, and
    its ICC profile written with --icc_out."""
    src = jxl("p3_jpeg")
    for mod, tag in ((P, "p"), (R, "r")):
        rc, _ = cli(mod, src, str(tmp_path / f"{tag}.npy"), "--to_srgb",
                    "--icc_out", str(tmp_path / f"{tag}.icc"))
        assert rc == 0

    def port_cli():
        assert cli(P, src, str(tmp_path / "e.npy"), "--to_srgb")[0] == 0
        return np.load(tmp_path / "e.npy")

    # the port's pixels under jxl_tpu's chroma edges (test_torch_layouts)
    a, b = as_jxl_tpu_edges(port_cli, monkeypatch), np.load(tmp_path / "r.npy")
    close(a, b, "f32")
    plain = np.load(tmp_path / "p.npy")
    assert (tmp_path / "p.icc").read_bytes() == (tmp_path / "r.icc").read_bytes()
    cli(P, src, str(tmp_path / "plain.npy"))
    assert np.abs(np.load(tmp_path / "plain.npy") - plain).max() > 1e-3  # it did convert


@pytest.mark.parametrize("name,interval", [("vardct", 500), ("lf_frame", 1200)])
def test_render_interval_matches_jxl_tpu(name, interval, jxl, tmp_path):
    """--render_interval feeds the streaming decoder and flushes after each
    piece: as many partial renders as jxl_tpu, each within 1 LSB, and the
    final image."""
    src = jxl(name)
    texts = []
    for mod, tag in ((P, "p"), (R, "r")):
        rc, text = cli(mod, src, str(tmp_path / f"{tag}.png"), "--render_interval",
                       str(interval))
        assert rc == 0
        texts.append(text.replace(f"{tag}.png", "X"))
    assert texts[0] == texts[1] and "progressive renders" in texts[0]
    n = int(texts[0].split("(+")[1].split()[0])
    assert n >= 2
    for i in range(n):
        close(read_png(tmp_path / f"p_p{i:03d}.png"), read_png(tmp_path / f"r_p{i:03d}.png"),
              "int")
    close(read_png(tmp_path / "p.png"), read_png(tmp_path / "r.png"), "int")


def test_preview_matches_jxl_tpu(jxl, tmp_path):
    src = jxl("anim")
    for mod, tag in ((P, "p"), (R, "r")):
        rc, _ = cli(mod, src, str(tmp_path / f"{tag}.png"), "--preview")
        assert rc == 0
    a = read_png(tmp_path / "p.png")
    assert a.shape == (40, 320, 3)
    close(a, read_png(tmp_path / "r.png"), "int")
    assert cli(P, jxl("vardct"), str(tmp_path / "none.png"), "--preview")[0] == 1


def test_speedtest_prints_the_rate(jxl):
    rc, text = cli(P, jxl("vardct"), "--speedtest", "--num_reps", "2", "--warmup_reps", "0")
    assert rc == 0 and "MP/s" in text and "best of 2" in text


def test_print_timings_and_profile_dir(jxl, tmp_path):
    try:
        rc, text = cli(P, jxl("vardct"), str(tmp_path / "o.png"), "--print_timings",
                       "--profile_dir", str(tmp_path / "prof"))
    finally:
        trace.enable(False)
        trace.reset()
    assert rc == 0
    assert "frame.render" in text and "decode_image.sections" in text and "MP/s" in text
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# -- tracing ----------------------------------------------------------------------------------


def test_trace_is_a_no_op_when_off():
    trace.enable(False)
    trace.reset()
    with trace.span("x"):
        pass
    trace.metrics.add("n", 3)
    trace.instrument(lambda: 1)()
    assert trace.report().count("\n") == 0 and trace.metrics.get("n") == 0


def test_trace_records_spans_and_counters_when_on():
    @trace.instrument(name="f")
    def f():
        return 5

    trace.enable(True)
    trace.reset()
    try:
        with trace.span("x"):
            pass
        with trace.span("x"):
            pass
        assert f() == 5
        trace.metrics.add("megapixels_decoded", 2.0)
        trace.metrics.add("decode_seconds", 0.5)
        trace.metrics.add("k3_lanes", 7)
        text = trace.report()
    finally:
        trace.enable(False)
        trace.reset()
    lines = {ln.split()[0]: ln.split() for ln in text.splitlines()[1:]}
    assert lines["x"][1] == "2" and lines["f"][1] == "1"
    assert "4.000 MP/s" in text and "counter k3_lanes: 7" in text
    assert trace.device_ms() == {}


def test_streaming_decode_records_its_stages(jxl):
    from jxl_tpu_torch.api.decoder import Event, JxlDecoder

    data = open(jxl("vardct"), "rb").read()
    trace.enable(True)
    trace.reset()
    try:
        d = JxlDecoder(device="cpu")
        d.feed(data)
        d.end_input()
        while d.process() is not Event.COMPLETE:
            pass
        text = trace.report()
    finally:
        trace.enable(False)
        trace.reset()
    for stage in ("decoder.header", "decoder.sections", "frame.render"):
        assert stage in text


# -- colour management --------------------------------------------------------------------------


def test_srgb_profile_and_transform_match_jxl_tpu():
    from jxl_tpu.color import cms as RC
    from jxl_tpu_torch.color import cms as PC

    assert PC.srgb_profile() == RC.srgb_profile()
    p3 = PROFILES["display_p3"]()
    x = np.random.default_rng(3).random((5, 7, 3)).astype(np.float32)
    a = PC.JxlCms.begin_transforms(p3, PC.srgb_profile(), 2)
    b = RC.JxlCms.begin_transforms(p3, RC.srgb_profile(), 1)[0]
    assert len(a) == 2 and a[0].in_channels == 3
    np.testing.assert_array_equal(a[1].run(x), b.run(x))


def test_missing_lcms_raises(monkeypatch):
    from jxl_tpu_torch.color import cms as PC

    monkeypatch.setattr(PC, "_lib", None)
    monkeypatch.setattr(PC, "_candidates", lambda: [])
    with pytest.raises(PC.CmsUnavailable):
        PC.srgb_profile()
    with pytest.raises(PC.CmsUnavailable):
        PC.JxlCms.begin_transforms(b"x", b"y")
