#!/usr/bin/env python3
"""The VarDCT inverse transforms of the checkout at --root on the card:
whether a block's pixels depend on how many blocks share the batched
call, and what the whole-frame and banded decodes of frames full of large
transforms cost. Run it once for each of two checkouts (this one and an
unpacked parent commit) in one machine call, in the order parent, change,
change, parent, to compare them.

    python3 tools/transforms_ab.py --root DIR --streams DIR2

Imports jxl_tpu_torch from DIR, and the stream writer
(tests/test_torch_vardct_streams.py) from this checkout, so that every
checkout decodes the same bytes: DIR2 keeps the streams, written by the
first run and read by the later ones. Prints JSON lines:
- "products": for each of the 27 transform types, 3000 random blocks
  (300 of the types of 32 blocks and more) through the decode's per-type
  render in one call and in calls of 1, 7, 256 and 1000 blocks: bit for
  bit or the max abs difference. The render is ops/vardct_blocks.py:
  vardct_blocks (K5: random quantized coefficients, dequantized in the
  call) where the checkout has it, else vardct/transforms_batch.py:
  transform_to_pixels_batch (random dequantized coefficients), what that
  checkout's decode runs;
- one line a stream (a 3840x2160 and a 7680x4320 frame of the DCT32 to
  DCT256 transforms, transforms="large", and the 3840x2160 frame of
  chip_smoke.py's vardct phase): f32 decode_image by the whole-frame route
  (three walls, peak card memory above what was allocated before, host_s)
  and decode_banded into a pinned host array (a wall and a peak, against
  the whole frame), where the checkout has it.
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPS = 3
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, writer arguments): width, height, seed, transforms
STREAMS = [("large_3840x2160", (3840, 2160, 19, "large")),
           ("large_7680x4320", (7680, 4320, 20, "large")),
           ("mixed_3840x2160", (3840, 2160, 7, "mixed"))]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def measured(fn):
    """fn() synchronised: (result, wall s, peak card bytes above what was
    allocated before it)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def diff(a, b) -> dict:
    import torch

    d = (a.double() - b.double()).abs()
    return {"bit_for_bit": bool(torch.equal(a, b)), "max_abs_diff": float(d.max()),
            "samples_differ": int((d != 0).sum())}


def products() -> dict:
    """{type: diff of the blocks in one call against in calls of 1, 7, 256
    and 1000 blocks}, through the checkout's per-type render."""
    import numpy as np
    import torch

    from jxl_tpu_torch.vardct.transform_map import covered_blocks_x, covered_blocks_y

    try:
        from jxl_tpu_torch.ops.vardct_blocks import vardct_blocks
    except ImportError:  # a checkout before K5
        vardct_blocks = None
    rng = np.random.default_rng(3)
    out = {}
    for t in range(27):
        cx, cy = covered_blocks_x(t), covered_blocks_y(t)
        n = 3000 if cx * cy <= 16 else 300
        nc = cx * cy * 64
        if vardct_blocks is None:
            from jxl_tpu_torch.vardct.transforms_batch import transform_to_pixels_batch

            lf = torch.from_numpy(rng.normal(0, 1, (n, cy, cx)).astype(np.float32)).cuda()
            co = torch.from_numpy(rng.normal(0, 1, (n, nc)).astype(np.float32)).cuda()

            def render(i, j):
                return transform_to_pixels_batch(t, lf[i:j], co[i:j])

            whole = render(0, n)
        else:
            # n blocks side by side in one row of blocks
            W = n * cx * 8
            cuda = {name: torch.from_numpy(np.ascontiguousarray(a)).cuda() for name, a in dict(
                flat=rng.integers(-6, 7, n * nc + 3 * 65536).astype(np.int32),
                cols=np.stack([np.arange(n) * nc, np.arange(n) * cx, np.arange(n) * cx * 8,
                               np.arange(n) % 4], 1).astype(np.int64),
                lf=rng.normal(0, 0.5, (3, cy * n * cx)).astype(np.float32),
                rq=rng.integers(1, 60, cy * n * cx).astype(np.int32),
                yx=rng.normal(0, 3, 4).astype(np.float32),
                yb=rng.normal(0, 3, 4).astype(np.float32),
                k=np.array([1.1, 0.9, 1 / 512, 84, 0, 1], np.float32).reshape(6, 1),
                bias=np.array([-0.05, -0.06, -0.07, 0.145], np.float32),
                mats=rng.uniform(0.01, 2.0, (1, 3, nc)).astype(np.float32)).items()}
            planes = torch.zeros((3, cy * 8 * W), dtype=torch.float32, device="cuda")

            def render(i, j):
                vardct_blocks(t, cuda["flat"], cuda["cols"][i:j], cuda["lf"], n * cx, cuda["rq"],
                              cuda["yx"], cuda["yb"], cuda["k"], cuda["bias"], cuda["mats"],
                              planes, W)
                # block b's pixels: rows of planes, columns [b * cx * 8, (b + 1) * cx * 8)
                return planes.reshape(3, cy * 8, n, cx * 8)[:, :, i:j].clone()

            whole = render(0, n).transpose(0, 2)
        worst = None
        for size in (1, 7, 256, 1000):
            parts = torch.cat([render(i, i + size) if vardct_blocks is None
                               else render(i, i + size).transpose(0, 2)
                               for i in range(0, min(n, 3 * size), size)])
            d = diff(parts, whole[: parts.shape[0]])
            if worst is None or d["max_abs_diff"] > worst["max_abs_diff"]:
                worst = d
        out[t] = worst
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--streams", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("transforms_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(HERE, "tests")]
    import jxl_tpu_torch
    from test_torch_vardct_streams import encode_xyb_vardct

    if not jxl_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"jxl_tpu_torch came from {jxl_tpu_torch.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"root": args.root, "card": smi, "torch": torch.__version__})
    prods = products()
    emit({"root": args.root, "products": prods,
          "all_bit_for_bit": all(d["bit_for_bit"] for d in prods.values())})
    os.makedirs(args.streams, exist_ok=True)
    for name, (w, h, seed, transforms) in STREAMS:
        path = os.path.join(args.streams, name + ".jxl")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(encode_xyb_vardct(w, h, seed=seed, transforms=transforms)[0])
        with open(path, "rb") as f:
            data = f.read()
        rec = {"root": args.root, "stream": name, "bytes": len(data), "card": smi}
        jxl_tpu_torch.decode_image(data)  # warm: builds, caches
        walls, peaks, hosts = [], [], []
        for _ in range(REPS):
            img, wall, peak = measured(lambda: jxl_tpu_torch.decode_image(data))
            walls.append(wall)
            peaks.append(peak)
            hosts.append(img.timings["host_s"])
        whole = img.frames[0]
        rec["decode_image"] = {"wall_s": walls, "peak_card_bytes": peaks, "host_s": hosts}
        if not hasattr(jxl_tpu_torch, "decode_banded"):  # a checkout before the banded decode
            emit(rec)
            continue
        del img
        host = torch.empty(tuple(whole.shape), dtype=torch.float32, pin_memory=True)

        def sink(y0, band):
            host[y0 : y0 + band.shape[0]].copy_(band, non_blocking=True)

        _, wall, peak = measured(lambda: jxl_tpu_torch.decode_banded(data, sink))
        rec["decode_banded"] = {"wall_s": wall, "peak_card_bytes": peak,
                                "vs_whole": diff(host.to("cuda"), whole)}
        del whole, host
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
