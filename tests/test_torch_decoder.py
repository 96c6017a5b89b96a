"""The port's streaming decoder (jxl_tpu_torch/api/decoder.py) against
jxl_tpu's on the same writer streams, on the CPU:

- byte-at-a-time input (and the `bytes_needed` hints) equal to the port's
  decode_image bit for bit, and to jxl_tpu's JxlDecoder within f32 1e-4;
- jxlc and jxlp containers, an out-of-order jxlp part that a frame starts
  in (InvalidBox), IMAGE_INFO and the sample limit;
- the progressive modes' event counts, and every flush_pixels() against
  jxl_tpu's at the same byte count (f32 <= 1e-4, u8 <= 1 LSB), with the
  frame after the flushes equal to a decode without any (a render that
  wrote into the decode's state would show there);
- the LF preview and the LF frame's flush, the preview frame, the four
  pixel formats, the frame scan and seek;
- the lane decoder launched over sections split across calls, equal to
  one launch, and a streaming decode that launches it once a frame
  without a flush.

The decodes take the host AC route (JXL_TPU_AC=host) unless they test the
lanes: the lanes' plain version steps in Python.
"""

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu_torch.api import decoder as P
from jxl_tpu.api import decoder as R
from test_torch_frame_streams import (CONTAINER_SIGNATURE, anim_rgba_stream,
                                      anim_vardct_stream, box, jxlp_container, lf_frame_stream)
from test_torch_progressive import check_format
from test_torch_streams import encode_xyb_modular
from test_torch_vardct_streams import encode_xyb_vardct

_CACHE = {}

STREAMS = {
    "vardct": lambda: encode_xyb_vardct(264, 136, seed=81, density=0.05)[0],
    "modular": lambda: encode_xyb_modular(264, 136, seed=82)[0],
    "two_pass": lambda: encode_xyb_vardct(264, 136, seed=83, density=0.05, passes=2)[0],
    "vardct_2lf": lambda: encode_xyb_vardct(520, 300, seed=84, density=0.05)[0],
    "modular_big": lambda: encode_xyb_modular(300, 264, seed=85)[0],
    "rgba_two_pass": lambda: encode_xyb_vardct(264, 136, seed=86, density=0.05, passes=2,
                                               num_ec=1)[0],
    "lf_frame": lambda: lf_frame_stream(320, 200, passes=2, seed=87, density=0.1),
    "anim": lambda: anim_vardct_stream(320, 200, (288, 96), num_frames=8, seed=88),
    "anim_rgba": lambda: anim_rgba_stream(320, 200, (288, 96), num_frames=3, seed=92),
    "anim_preview": lambda: anim_vardct_stream(320, 200, (288, 96), num_frames=3, seed=89,
                                               preview=True),
}


def stream(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


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


def run(mod, data, chunk=1, flush=None, hints=False, **kw):
    """Feed `data` `chunk` bytes at a time (the hinted amount with
    hints=True) and process to COMPLETE. flush: None, "progression"
    (flush at each FRAME_PROGRESSION) or "every" (also at each
    NEED_MORE_INPUT, as the CLI's --render_interval does). Returns (the
    decoder, [event names], [(bytes fed, flush as numpy or None)])."""
    dev = {"device": "cpu"} if mod is P else {}
    d = mod.JxlDecoder(mod.JxlDecoderOptions(**kw), **dev)
    pos, events, flushes = 0, [], []

    def do_flush():
        f = d.flush_pixels()
        flushes.append((pos, None if f is None else np.asarray(f)))

    while True:
        ev = d.process()
        events.append(ev.name)
        if ev.name == "NEED_MORE_INPUT":
            if pos >= len(data):
                d.end_input()
                continue
            if flush == "every" and pos:
                do_flush()
            n = (d.bytes_needed or 1) if hints else chunk
            d.feed(data[pos : pos + n])
            pos += n
        elif ev.name == "FRAME_PROGRESSION" and flush:
            do_flush()
        elif ev.name == "COMPLETE":
            return d, events, flushes
        assert len(events) < 200_000


def frames_np(d):
    return [np.asarray(f) for f in d.frames]


def close(got, want, fmt="f32"):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        check_format(a, b, fmt)


# -- whole decodes ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["vardct", "modular", "two_pass"])
def test_byte_at_a_time_matches_decode_image_and_jxl_tpu(name):
    data = stream(name)
    got, events, _ = run(P, data, 1)
    assert events.count("NEED_MORE_INPUT") >= len(data)
    one_shot = jxl_tpu_torch.decode_image(data, device="cpu")
    assert len(got.frames) == len(one_shot.frames) == 1
    assert torch.equal(got.frames[0], one_shot.frames[0])
    ref, ref_events, _ = run(R, data, 1)
    assert events == ref_events
    close(frames_np(got), ref.frames)


@pytest.mark.parametrize("name", ["vardct", "modular", "two_pass", "lf_frame", "anim"])
def test_size_hints_reach_completion(name):
    """Feeding exactly the hinted bytes each time finishes the decode (the
    pattern of tests/test_streaming.py:74-96), with the frames of a whole
    decode."""
    data = stream(name)
    got, events, _ = run(P, data, hints=True)
    assert events.count("NEED_MORE_INPUT") < len(data)
    one_shot = jxl_tpu_torch.decode_image(data, device="cpu")
    assert len(got.frames) == len(one_shot.frames)
    for a, b in zip(got.frames, one_shot.frames):
        assert torch.equal(a, b)
    assert got.durations == one_shot.durations


@pytest.mark.parametrize("chunk", [7, 4096])
def test_animation_frames_and_durations(chunk):
    data = stream("anim")
    got, _, _ = run(P, data, chunk)
    one_shot = jxl_tpu_torch.decode_image(data, device="cpu")
    assert len(got.frames) == 8
    assert all(torch.equal(a, b) for a, b in zip(got.frames, one_shot.frames))
    ref, _, _ = run(R, data, 4096)
    assert got.durations == ref.durations == one_shot.durations
    close(frames_np(got), ref.frames)


@pytest.mark.parametrize("fmt", ["f32", "u8", "u16", "f16"])
@pytest.mark.parametrize("name", ["two_pass", "rgba_two_pass"])
def test_pixel_formats(name, fmt):
    """All four output formats: bit for bit the port's decode_image, and
    jxl_tpu's JxlDecoder within each format's tolerance."""
    data = stream(name)
    got, _, _ = run(P, data, 512, pixel_format=fmt)
    one_shot = jxl_tpu_torch.decode_image(data, device="cpu", pixel_format=fmt)
    assert got.frames[0].dtype == one_shot.frames[0].dtype
    assert torch.equal(got.frames[0], one_shot.frames[0])
    ref, _, _ = run(R, data, 512, pixel_format=fmt)
    close(frames_np(got), ref.frames, fmt)


def test_unknown_pixel_format_raises():
    with pytest.raises(ValueError):
        P.JxlDecoder(P.JxlDecoderOptions(pixel_format="u32"), device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.JxlDecoder()


# -- containers, image info, limits ---------------------------------------------------------


def frame_offsets(data):
    d, _, _ = run(P, data, len(data), scan_frames_only=True)
    return [f.codestream_offset for f in d.scanned_frames]


def containers(data):
    offs = frame_offsets(data)
    cuts = [offs[2], offs[5]]
    head = CONTAINER_SIGNATURE + box(b"ftyp", b"jxl \0\0\0\0jxl ")
    jxlp = jxlp_container(data, cuts)
    return {
        "jxlc": head + box(b"jxlc", data),
        "jxlc_unbounded": head + (0).to_bytes(4, "big") + b"jxlc" + data,
        # a box the decoder skips between the ftyp and the first part
        "jxlp": head + box(b"junk", b"x" * 5) + jxlp[len(head):],
        # part 2 (where frame 5 starts) before part 1
        "jxlp_ooo": jxlp_container(data, cuts, order=(0, 2, 1)),
    }


@pytest.mark.parametrize("kind", ["jxlc", "jxlc_unbounded", "jxlp"])
@pytest.mark.parametrize("chunk", [1, 1000])
def test_containers_decode_like_the_bare_codestream(kind, chunk):
    data = stream("anim")
    wrapped = containers(data)[kind]
    got, _, _ = run(P, wrapped, chunk)
    want = jxl_tpu_torch.decode_image(data, device="cpu")
    assert len(got.frames) == 8
    assert all(torch.equal(a, b) for a, b in zip(got.frames, want.frames))


def test_out_of_order_jxlp_raises_invalid_box_like_jxl_tpu():
    from jxl_tpu.errors import InvalidBox as RefInvalidBox
    from jxl_tpu_torch.errors import InvalidBox

    wrapped = containers(stream("anim"))["jxlp_ooo"]
    with pytest.raises(InvalidBox):
        run(P, wrapped, 512)
    with pytest.raises(RefInvalidBox):
        run(R, wrapped, 512)
    with pytest.raises(InvalidBox):
        jxl_tpu_torch.decode_image(wrapped, device="cpu")


def test_bad_signature_raises():
    from jxl_tpu_torch.errors import InvalidSignature

    d = P.JxlDecoder(device="cpu")
    with pytest.raises(InvalidSignature):
        d.feed(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("name", ["vardct", "anim", "anim_preview", "rgba_two_pass"])
def test_image_info_matches_jxl_tpu(name):
    data = stream(name)
    infos = []
    for mod in (P, R):
        d = mod.JxlDecoder(**({"device": "cpu"} if mod is P else {}))
        d.feed(data)
        assert d.process().name == "IMAGE_INFO"
        infos.append(d.image_info.__dict__)
    assert infos[0] == infos[1]


@pytest.mark.parametrize("limit,raises", [(1000, True), (264 * 136 * 3, True),
                                          (264 * 136 * 3 + 1, False)])
def test_sample_limit(limit, raises):
    from jxl_tpu_torch.errors import LimitExceeded

    data = stream("vardct")
    if raises:
        with pytest.raises(LimitExceeded):
            run(P, data, 4096, sample_limit=limit)
    else:
        d, _, _ = run(P, data, 4096, sample_limit=limit)
        assert len(d.frames) == 1


def test_truncated_input_raises():
    from jxl_tpu_torch.errors import InvalidBitstream

    data = stream("two_pass")
    d = P.JxlDecoder(device="cpu")
    d.feed(data[: len(data) - 10])
    d.end_input()
    with pytest.raises(InvalidBitstream):
        while d.process().name != "COMPLETE":
            pass


# -- progressive events and flushes -------------------------------------------------------------


@pytest.mark.parametrize("name", ["two_pass", "vardct_2lf", "lf_frame", "modular_big"])
def test_progressive_mode_event_counts_match_jxl_tpu(name):
    data = stream(name)
    counts = {}
    for mode in ("EAGER", "PASSES", "FULL_FRAME"):
        got = run(P, data, 700, progressive_mode=P.ProgressiveMode[mode])[1]
        want = run(R, data, 700, progressive_mode=R.ProgressiveMode[mode])[1]
        assert got == want
        counts[mode] = got.count("FRAME_PROGRESSION")
    assert counts["FULL_FRAME"] == 0
    assert counts["EAGER"] >= counts["PASSES"]


FLUSH_CASES = [("vardct_2lf", "progression", 900), ("two_pass", "progression", 600),
               ("two_pass", "every", 600), ("rgba_two_pass", "every", 700),
               ("lf_frame", "every", 500), ("modular_big", "every", 3000),
               ("anim", "every", 2500), ("anim_rgba", "every", 4000)]


@pytest.mark.parametrize("name,flush,chunk", FLUSH_CASES)
def test_flushes_match_jxl_tpu_at_the_same_bytes(name, flush, chunk):
    """Every flush against jxl_tpu's at the same byte count: f32 within
    1e-4, and within 1 LSB as 8-bit samples."""
    from jxl_tpu_torch.cli import _u8

    data = stream(name)
    mode = P.ProgressiveMode.EAGER
    got, _, got_fl = run(P, data, chunk, flush=flush, progressive_mode=mode)
    ref, _, ref_fl = run(R, data, chunk, flush=flush, progressive_mode=R.ProgressiveMode.EAGER)
    assert [p for p, _ in got_fl] == [p for p, _ in ref_fl]
    assert [f is None for _, f in got_fl] == [f is None for _, f in ref_fl]
    rendered = [(a, b) for (_, a), (_, b) in zip(got_fl, ref_fl) if a is not None]
    assert rendered
    for a, b in rendered:
        check_format(a, b.astype(np.float32), "f32")
        check_format(_u8(a), _u8(b), "u8")
    close(frames_np(got), ref.frames)


@pytest.mark.parametrize("name,flush,chunk", FLUSH_CASES)
def test_final_frame_after_flushes_equals_no_flush(name, flush, chunk):
    """A flush is a pure re-render: the frames after N flushes are bit for
    bit those of a decode that made none, and of decode_image."""
    data = stream(name)
    got, _, fl = run(P, data, chunk, flush=flush, progressive_mode=P.ProgressiveMode.EAGER)
    assert any(f is not None for _, f in fl)
    plain, _, _ = run(P, data, chunk)
    one_shot = jxl_tpu_torch.decode_image(data, device="cpu")
    assert len(got.frames) == len(plain.frames) == len(one_shot.frames)
    for a, b, c in zip(got.frames, plain.frames, one_shot.frames):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_flush_before_anything_renders_is_none():
    data = stream("vardct")
    d = P.JxlDecoder(device="cpu")
    assert d.flush_pixels() is None
    d.feed(data[:40])
    while d.process().name != "NEED_MORE_INPUT":
        pass
    assert d.flush_pixels() is None


def test_flush_fills_groups_without_ac_from_the_lf():
    """Before any HF section arrives, the flush is the LF upsampled 8x (no
    pixel is left at zero), and it matches jxl_tpu's."""
    data = stream("vardct_2lf")
    outs = []
    for mod in (P, R):
        d = mod.JxlDecoder(**({"device": "cpu"} if mod is P else {}))
        fed = 0
        frame = None
        while frame is None or not frame._lf_finalized:
            d.feed(data[fed : fed + 64])
            fed += 64
            while d.process().name not in ("NEED_MORE_INPUT",):
                pass
            frame = d.frame
        assert sum(frame._passes_done) == 0
        outs.append(np.asarray(d.flush_pixels()))
    check_format(outs[0], outs[1].astype(np.float32), "f32")
    assert np.abs(outs[0]).max() > 0


def test_lf_preview_and_the_lf_frame_flush():
    """The 1/8 preview of the LF frame, and the main frame's flush before
    its own LF groups arrive (the LF frame upsampled 8x), against
    jxl_tpu's."""
    data = stream("lf_frame")
    outs = {}
    for mod in (P, R):
        d = mod.JxlDecoder(**({"device": "cpu"} if mod is P else {}))
        fed = 0
        while d.frame is None or not d.frame.header.has_lf_frame:
            d.feed(data[fed : fed + 16])
            fed += 16
            while d.process().name not in ("NEED_MORE_INPUT",):
                pass
        assert d.lf_preview() is not None and not d.frame._lf_finalized
        outs[mod] = (np.asarray(d.lf_preview()), np.asarray(d.flush_pixels()))
    (pv, fl), (rpv, rfl) = outs[P], outs[R]
    assert pv.shape == rpv.shape == (25, 40, 3)
    assert fl.shape == rfl.shape == (200, 320, 3)
    check_format(pv, rpv.astype(np.float32), "f32")
    check_format(fl, rfl.astype(np.float32), "f32")


# -- preview frame, scan and seek ------------------------------------------------------------------


def test_preview_frame_matches_jxl_tpu():
    data = stream("anim_preview")
    got, _, _ = run(P, data, 1000, skip_preview=False)
    ref, _, _ = run(R, data, 1000, skip_preview=False)
    assert got.preview.shape == ref.preview.shape == (40, 320, 3)
    check_format(np.asarray(got.preview), ref.preview.astype(np.float32), "f32")
    skipped, _, _ = run(P, data, 1000)
    assert skipped.preview is None
    assert all(torch.equal(a, b) for a, b in zip(got.frames, skipped.frames))


@pytest.mark.parametrize("chunk", [1, 333, None])
def test_scan_frames_only_matches_jxl_tpu(chunk):
    """The scan's frames at any chunk size equal jxl_tpu's scan of the
    whole file. jxl_tpu's own scan fails when a frame's sections have not
    all arrived (it moves its cursor past the frame header first and
    rereads from there: ROADMAP.md queue 3), so it is fed whole."""
    data = stream("anim")
    got, ev, _ = run(P, data, chunk or len(data), scan_frames_only=True)
    ref, rev, _ = run(R, data, len(data), scan_frames_only=True)
    assert got.frames == [] and [e for e in ev if e != "NEED_MORE_INPUT"] == [
        e for e in rev if e != "NEED_MORE_INPUT"]
    assert len(got.scanned_frames) == 8
    assert [f.__dict__ for f in got.scanned_frames] == [
        {**f.__dict__, "seek_target": P.VisibleFrameSeekTarget(**f.seek_target.__dict__)}
        for f in ref.scanned_frames]
    assert got.frame_infos == ref.frame_infos


@pytest.mark.parametrize("target", [0, 3, 5, 7])
def test_seek_to_a_visible_frame(target):
    """scan_frames_only, then start_new_frame to a visible frame: its
    frame is decode_image's (every frame saves slot 1, so the seek starts
    from the first frame and decodes its way there)."""
    data = stream("anim")
    d, _, _ = run(P, data, len(data), scan_frames_only=True)
    info = d.scanned_frames[target]
    d.start_new_frame(info.seek_target)
    while d.process().name != "COMPLETE":
        pass
    want = jxl_tpu_torch.decode_image(data, device="cpu")
    assert len(d.frames) == 8 - target
    assert torch.equal(d.frames[0], want.frames[target])
    assert d.durations == want.durations[target:]


# -- the lane decoder on arriving sections -------------------------------------------------------


def test_lanes_split_across_launches_equal_one_launch():
    """decode_ac_sections_device over the sections in two calls (pass 1
    before pass 0, groups split) adds into one buffer bit for bit equal to
    one call over all of them (the plain version of K3)."""
    from jxl_tpu_torch.vardct import device_group
    from test_torch_device_ac import _port_frame_and_readers

    data, coeffs = encode_xyb_vardct(520, 136, seed=90, density=0.05, passes=2)
    one, readers = _port_frame_and_readers(data)
    device_group.decode_ac_sections_device(one, readers, "cpu")
    split, readers = _port_frame_and_readers(data)
    keys = sorted(readers)
    first = [k for k in keys if k[1] == 1 or k[0] == 0]
    device_group.decode_ac_sections_device(split, {k: readers[k] for k in first}, "cpu")
    device_group.decode_ac_sections_device(
        split, {k: readers[k] for k in keys if k not in first}, "cpu")
    assert split.device_ac_ok.shape == (len(keys),) and bool(split.device_ac_ok.all())
    assert torch.equal(split.device_ac_flat, one.device_ac_flat)
    np.testing.assert_array_equal(one.device_ac_flat.numpy(), coeffs)


@pytest.mark.parametrize("flush", [None, "progression"])
def test_streaming_lanes_launch_once_a_frame_without_a_flush(flush, monkeypatch):
    """On the lanes route a streaming decode queues the sections and runs
    the lane decoder once at the end of the frame; each flush runs it at
    most once, over the sections queued since. The frame equals
    decode_image's either way."""
    from jxl_tpu_torch.vardct import device_group

    monkeypatch.delenv("JXL_TPU_AC")
    data = _CACHE.setdefault("lanes_small", encode_xyb_vardct(264, 64, seed=91, density=0.03,
                                                              passes=2)[0])
    lanes = []
    real = device_group.run_lanes

    def spy(inputs, device, out=None):
        lanes.append(int(inputs["start_bits"].shape[0]))
        return real(inputs, device, out=out)

    monkeypatch.setattr(device_group, "run_lanes", spy)
    got, _, fl = run(P, data, 300, flush=flush, progressive_mode=P.ProgressiveMode.EAGER)
    total = 2 * 2  # two groups, two passes
    if flush is None:
        assert lanes == [total]
    else:
        assert sum(lanes) == total and len(lanes) <= len(fl) + 1 and len(fl) >= 2
    streamed = lanes.copy()
    one_shot = jxl_tpu_torch.decode_image(data, device="cpu")
    assert lanes[len(streamed):] == [total]
    assert torch.equal(got.frames[0], one_shot.frames[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
def test_streaming_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """On the card, with K3 on the lane route (JXL_TPU_DEVICE=on, so no
    frame takes the host render route): the streaming frame equals
    decode_image's bit for bit, and each flush is within f32 1e-4 of the
    CPU decoder's at the same bytes."""
    from jxl_tpu_torch.ops import device_ac

    monkeypatch.delenv("JXL_TPU_AC")
    monkeypatch.setenv("JXL_TPU_DEVICE", "on")
    k3 = device_ac.decode_ac_sections.launches
    data = stream("lf_frame")
    d = P.JxlDecoder(P.JxlDecoderOptions(progressive_mode=P.ProgressiveMode.EAGER))
    flushes = []
    pos = 0
    while (ev := d.process()) is not P.Event.COMPLETE:
        if ev is P.Event.NEED_MORE_INPUT:
            if pos >= len(data):
                d.end_input()
                continue
            d.feed(data[pos : pos + 500])
            pos += 500
        elif ev is P.Event.FRAME_PROGRESSION:
            f = d.flush_pixels()
            flushes.append((pos, None if f is None else f.cpu().numpy()))
    k3_stream = device_ac.decode_ac_sections.launches - k3
    assert torch.equal(d.frames[0], jxl_tpu_torch.decode_image(data).frames[0])
    assert k3_stream > 0 and device_ac.decode_ac_sections.launches - k3 > k3_stream
    monkeypatch.setenv("JXL_TPU_AC", "host")
    _, _, cpu = run(P, data, 500, flush="progression", progressive_mode=P.ProgressiveMode.EAGER)
    assert [p for p, _ in flushes] == [p for p, _ in cpu]
    for (_, a), (_, b) in zip(flushes, cpu):
        assert (a is None) == (b is None)
        if a is not None:
            check_format(a, b, "f32")
