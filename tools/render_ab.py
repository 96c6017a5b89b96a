#!/usr/bin/env python3
"""Timing of the port's VarDCT decode and of its render's steps on the
card, for the checkout at --root: run it once for each of two checkouts
(this one and an unpacked parent commit) in one machine call, in the order
parent, change, change, parent, to compare them.

    python3 tools/render_ab.py --root DIR

Imports jxl_tpu_torch and the test writers from DIR, and chip_smoke.py
from this checkout. For each of chip_smoke.py's two VarDCT streams (the
1920x1080 frame upsampled 2x with noise, and the 3840x2160 frame) it
prints chip_smoke.py's breakdown of the render (phase_render_breakdown:
each step's host queueing time, then its card time), then one JSON line:
the walls and host_s of five u8 decodes, each place where the VarDCT
planes step made the host wait for the card
(torch.cuda.set_sync_debug_mode("warn")), and the host-to-card copies of
one u8 decode under torch.profiler, pageable and pinned apart.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import warnings

REPS = 5
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("render_ab: no CUDA device", file=sys.stderr)
        return 1
    # chip_smoke from this checkout first: it imports the package lazily,
    # so its phases then run the checkout at --root
    sys.path.insert(0, HERE)
    import chip_smoke

    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import numpy as np

    import jxl_tpu_torch
    from jxl_tpu_torch.render.simple import vardct_planes
    from test_torch_vardct_streams import encode_xyb_vardct
    from torch.profiler import ProfilerActivity, profile

    if not jxl_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"jxl_tpu_torch came from {jxl_tpu_torch.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lut = np.random.default_rng(7).integers(64, 512, 8).tolist()
    streams = [
        ("vardct_up2_noise", encode_xyb_vardct(1920, 1080, seed=7, upsampling=2, noise=lut)[0]),
        ("vardct", encode_xyb_vardct(3840, 2160, seed=7)[0]),
    ]
    dev = torch.device("cuda")
    for name, data in streams:
        jxl_tpu_torch.decode_image(data, pixel_format="u8")  # warm: builds, caches
        walls, hosts = [], []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = jxl_tpu_torch.decode_image(data, pixel_format="u8")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            hosts.append(img.timings["host_s"])
        steps = chip_smoke.phase_render_breakdown(data, name, "render_ab_breakdown")
        planes = next(r for r in steps if r["step"] == "vardct_planes")

        frame = chip_smoke._vardct_frame(data, dev)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                vardct_planes(frame, dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = {}
        for w in caught:
            key = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            syncs[key] = syncs.get(key, 0) + 1

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            jxl_tpu_torch.decode_image(data, pixel_format="u8")
            torch.cuda.synchronize()
        copies = {e.key: {"calls": e.count, "ms": e.device_time_total / 1e3}
                  for e in prof.key_averages() if e.key.startswith("Memcpy HtoD")}
        chip_smoke.emit({"root": args.root, "stream": name, "card": smi, "reps": REPS,
                         "wall_s": walls, "host_s": hosts,
                         "planes_host_queue_ms": planes["host_queue_ms"],
                         "planes_device_ms": planes["device_ms"], "planes_syncs": syncs,
                         "profile_htod": copies})
    return 0


if __name__ == "__main__":
    sys.exit(main())
