"""djxl-style command line: decode .jxl to PNG/APNG/PPM/PGM/PFM/NPY/EXR,
--info, --speedtest, --preview and progressive renders.

Counterpart of jxl_tpu/cli.py (capability reference: jxl_cli/src/
{main.rs,dec,enc}: the decode tool, its speed test, jxlinspect), with
--device: the decode runs on the card ("cuda", the default, which raises
without one) or, asked for, on the CPU. Frames stay on the device until
the writer, which copies each to the host once. Usage:

    python -m jxl_tpu_torch.cli input.jxl output.png
    python -m jxl_tpu_torch.cli input.jxl --info
    python -m jxl_tpu_torch.cli input.jxl --speedtest --num_reps 5
    python -m jxl_tpu_torch.cli input.jxl out.png --render_interval 65536 --device cpu
"""

from __future__ import annotations

import argparse
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np


def write_png(path: str, arr: np.ndarray, bit_depth: int = 8) -> None:
    """Minimal PNG writer (8/16-bit gray, gray+alpha, RGB, RGBA)."""
    h, w, c = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if arr.dtype == np.uint8:
        raw, stride, depth = arr.tobytes(), w * c, 8
    elif arr.dtype == np.uint16:
        raw, stride, depth = arr.astype(">u2").tobytes(), w * c * 2, 16
    elif bit_depth <= 8:
        raw = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).tobytes()
        stride, depth = w * c, 8
    else:
        raw = (np.clip(arr, 0.0, 1.0) * 65535.0 + 0.5).astype(">u2").tobytes()
        stride, depth = w * c * 2, 16
    lines = bytearray()
    for y in range(h):
        lines.append(0)
        lines.extend(raw[y * stride : (y + 1) * stride])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    png = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
    png += _png_chunk(b"IDAT", zlib.compress(bytes(lines), 6))
    png += _png_chunk(b"IEND", b"")
    Path(path).write_bytes(png)


def _u8(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr, 0, 1) * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path: str, arr: np.ndarray) -> None:
    h, w, _ = arr.shape
    data = np.ascontiguousarray(_u8(arr[..., :3]))
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(data.tobytes())


def write_pgm(path: str, arr: np.ndarray) -> None:
    h, w, _ = arr.shape
    data = np.ascontiguousarray(_u8(arr[..., 0]))
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(data.tobytes())


def write_pfm(path: str, arr: np.ndarray) -> None:
    h, w, _ = arr.shape
    data = arr[..., :3].astype(np.float32).astype("<f4")[::-1]  # PFM is bottom-up
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        f.write(data.tobytes())


def write_npy(path: str, arr: np.ndarray) -> None:
    np.save(path, arr)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_apng(path: str, frames: list, durations_ms: list, num_loops: int = 0) -> None:
    """Animated PNG writer (acTL/fcTL/fdAT), 8-bit (capability ref:
    jxl_cli/src/enc/png.rs, its animation path)."""
    h, w, c = frames[0].shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def raw(fr):
        b = _u8(fr).tobytes()
        stride = w * c
        lines = bytearray()
        for y in range(h):
            lines.append(0)
            lines.extend(b[y * stride : (y + 1) * stride])
        return zlib.compress(bytes(lines), 6)

    png = b"\x89PNG\r\n\x1a\n"
    png += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    png += _png_chunk(b"acTL", struct.pack(">II", len(frames), num_loops))
    seq = 0
    for i, fr in enumerate(frames):
        dur = max(int(round(durations_ms[i] if i < len(durations_ms) else 100)), 1)
        png += _png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, dur, 1000, 0, 0))
        seq += 1
        data = raw(fr)
        if i == 0:
            png += _png_chunk(b"IDAT", data)
        else:
            png += _png_chunk(b"fdAT", struct.pack(">I", seq) + data)
            seq += 1
    png += _png_chunk(b"IEND", b"")
    Path(path).write_bytes(png)


def write_exr(path: str, arr: np.ndarray, half: bool = True) -> None:
    """Minimal OpenEXR v2 writer: one part, scanlines, no compression,
    R/G/B(/A) half or float channels (capability ref:
    jxl_cli/src/enc/exr.rs). EXR holds linear data; callers pass the f32
    decode."""
    h, w, c = arr.shape
    arr = arr.astype(np.float32)
    names = ["R", "G", "B", "A"][:c] if c >= 3 else ["Y", "A"][:c]
    order = sorted(range(len(names)), key=lambda i: names[i])  # stored alphabetically
    ptype = 1 if half else 2  # 1=HALF, 2=FLOAT
    psize = 2 if half else 4

    def attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
        return name + b"\0" + typ + b"\0" + struct.pack("<I", len(payload)) + payload

    chan = b""
    for i in order:
        chan += names[i].encode() + b"\0" + struct.pack("<IIII", ptype, 0, 1, 1)
    chan += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr(b"channels", b"chlist", chan)
        + attr(b"compression", b"compression", b"\0")
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\0")
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"
    )
    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    data_start = len(magic) + len(header) + 8 * h
    scan_size = 8 + len(order) * w * psize
    offsets = b"".join(struct.pack("<Q", data_start + y * scan_size) for y in range(h))
    dt = np.float16 if half else np.float32
    out = bytearray(magic + header + offsets)
    for y in range(h):
        out += struct.pack("<iI", y, len(order) * w * psize)
        for i in order:
            out += np.ascontiguousarray(arr[y, :, i]).astype(dt).tobytes()
    Path(path).write_bytes(bytes(out))


_WRITERS = {
    ".png": write_png,
    ".ppm": write_ppm,
    ".pgm": write_pgm,
    ".pfm": write_pfm,
    ".npy": write_npy,
    ".exr": write_exr,
}


def _host(t) -> np.ndarray:
    """A frame tensor on the host, as numpy: the one copy a frame makes."""
    return t.cpu().numpy()


def cmd_info(data: bytes) -> int:
    from .io.bit_reader import BitReader
    from .io.container import extract_codestream
    from .io.headers import FileHeader

    fh = FileHeader.read(BitReader(extract_codestream(data)))
    m = fh.image_metadata
    print(f"dimensions: {fh.xsize}x{fh.ysize}")
    bd = m.bit_depth
    kind = "float" if bd.floating_point_sample else "uint"
    print(f"bit depth: {bd.bits_per_sample}-bit {kind}")
    print(f"xyb encoded: {m.xyb_encoded}")
    print(f"orientation: {m.orientation.name}")
    cs = m.color_encoding
    tf = (cs.tf.transfer_function.name if not cs.tf.have_gamma
          else f"gamma {cs.tf.gamma_value():.4f}")
    print(f"color space: {cs.color_space.name}, tf: {tf}, want_icc: {cs.want_icc}")
    if m.animation:
        print(f"animation: {m.animation.tps_numerator}/{m.animation.tps_denominator} tps, "
              f"loops: {m.animation.num_loops}")
    for i, ec in enumerate(m.extra_channel_info):
        print(f"extra channel {i}: {ec.ec_type.name} ({ec.bit_depth.bits_per_sample}-bit) "
              f"{ec.name!r}")
    if m.preview:
        print(f"preview: {m.preview.xsize}x{m.preview.ysize}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="jxl_tpu_torch",
                                 description="JPEG XL decoder on PyTorch and CUDA")
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--device", default="cuda",
                    help="where the decode runs: cuda (the default; raises without a card) "
                    "or cpu")
    ap.add_argument("--info", action="store_true", help="print file metadata (jxlinspect)")
    ap.add_argument("--speedtest", action="store_true")
    ap.add_argument("--num_reps", type=int, default=5)
    ap.add_argument("--warmup_reps", type=int, default=1)
    ap.add_argument("--icc_out", help="write the embedded or synthesized ICC profile")
    ap.add_argument("--to_srgb", action="store_true",
                    help="convert the pixels to sRGB from the output profile through lcms2")
    ap.add_argument("--bits_per_sample", type=int, default=0)
    ap.add_argument("--preview", action="store_true",
                    help="extract the preview frame instead of the main image")
    ap.add_argument("--render_interval", type=int,
                    help="render the partial image (a progressive flush) every N input bytes;"
                    " writes <output>_p000.., <output>_p001.. beside the final output")
    ap.add_argument("--print_timings", action="store_true",
                    help="print each stage's host seconds and card ms, and the MP/s")
    ap.add_argument("--profile_dir",
                    help="write a torch.profiler Chrome trace of the run into this directory")
    args = ap.parse_args(argv)

    data = Path(args.input).read_bytes()

    from .utils import trace

    if args.print_timings:
        trace.enable(device_events=True)
    profile_cm = trace.device_trace(args.profile_dir) if args.profile_dir else None
    if profile_cm is not None:
        profile_cm.__enter__()
    try:
        return _dispatch(args, data)
    finally:
        # every exit path ends the profiler session and prints the timings
        if profile_cm is not None:
            profile_cm.__exit__(None, None, None)
        if args.print_timings:
            print(trace.report())


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dispatch(args, data):
    if args.info:
        return cmd_info(data)

    from .api.simple import decode_image

    if args.speedtest:
        for _ in range(args.warmup_reps):
            decode_image(data, pixel_format="u8", device=args.device)
        _sync(args.device)
        times = []
        mp = None
        for _ in range(args.num_reps):
            t0 = time.perf_counter()
            img = decode_image(data, pixel_format="u8", device=args.device)
            _sync(args.device)
            times.append(time.perf_counter() - t0)
            mp = sum(f.shape[0] * f.shape[1] for f in img.frames) / 1e6
        best = min(times)
        print(f"decoded {mp:.3f} MP in {best * 1000:.2f} ms (best of {args.num_reps}): "
              f"{mp / best:.3f} MP/s")
        return 0

    if args.preview or args.render_interval:
        return _progressive(args, data)

    ext = Path(args.output).suffix.lower() if args.output else ""
    if ext in (".png", ".apng", ".ppm", ".pgm") and args.bits_per_sample in (0, 8):
        fmt = "u8"
    elif ext == ".png" and args.bits_per_sample > 8:
        fmt = "u16"
    else:
        fmt = "f32"
    if args.to_srgb:
        fmt = "f32"  # CMS transforms run on f32 rows (ref dec/mod.rs:431 apply_cms)
    img = decode_image(data, pixel_format=fmt, device=args.device)
    frames = [_host(f) for f in img.frames]
    if args.to_srgb:
        from .color.cms import JxlCms, srgb_profile

        t = JxlCms.begin_transforms(img.output_icc(), srgb_profile(), 1)[0]
        for i, fr in enumerate(frames):
            # frames carry 3 colour channels (grey triplicated) and the extra channels
            color = t.run(fr[..., : t.in_channels])
            if fr.shape[-1] > 3:
                color = np.concatenate([color, fr[..., 3:]], axis=-1)
            frames[i] = color
    if args.icc_out:
        Path(args.icc_out).write_bytes(img.output_icc())
    if not args.output:
        print(f"decoded {len(frames)} frame(s), {frames[0].shape}")
        return 0
    writer = _WRITERS.get(ext)
    if writer is None and ext != ".apng":
        print(f"unsupported output format {ext}", file=sys.stderr)
        return 1
    if ext == ".apng":
        write_apng(args.output, frames, img.durations)
    elif len(frames) == 1 or ext != ".png":
        writer(args.output, frames[0])
    else:
        base = Path(args.output)
        for i, fr in enumerate(frames):
            writer(str(base.with_stem(base.stem + f"_{i:03d}")), fr)
    print(f"wrote {args.output}")
    return 0


def _progressive(args, data) -> int:
    """--preview and --render_interval, through the streaming decoder:
    feed the file render_interval bytes at a time (or whole), and after
    each feed that leaves the decoder wanting more, flush the partial
    image."""
    from .api.decoder import Event, JxlDecoder, JxlDecoderOptions

    d = JxlDecoder(JxlDecoderOptions(skip_preview=not args.preview), device=args.device)
    flushes = []
    pos = 0
    step = args.render_interval or len(data)
    while pos < len(data) or pos == 0:
        upto = min(pos + step, len(data))
        d.feed(data[pos:upto])
        pos = upto
        if pos >= len(data):
            d.end_input()
        ev = d.process()
        while ev not in (Event.NEED_MORE_INPUT, Event.COMPLETE):
            ev = d.process()
        if args.render_interval and ev is Event.NEED_MORE_INPUT:
            fl = d.flush_pixels()
            if fl is not None:
                flushes.append(fl)
        if ev is Event.COMPLETE:
            break
    if args.preview:
        if d.preview is None:
            print("no preview frame in this file", file=sys.stderr)
            return 1
        out = args.output or "preview.png"
        write_png(out, _u8(_host(d.preview)))
        print(f"wrote {out}")
        return 0
    base = Path(args.output) if args.output else Path("out.png")
    for i, fl in enumerate(flushes):
        write_png(str(base.with_stem(base.stem + f"_p{i:03d}")), _u8(_host(fl)))
    writer = _WRITERS.get(base.suffix.lower(), write_png)
    writer(str(base), _host(d.frames[0]))
    print(f"wrote {base} (+{len(flushes)} progressive renders)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
