#!/usr/bin/env python3
"""On-card smoke test of jxl_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a), nvcc and
g++. Phases, each printing one JSON line, and any failure ends the run
with a non-zero exit:

1. build   - nvcc builds the gaborish+EPF kernel (csrc/epf_gab.cu) and g++
             the host decoder library, in parallel, from the checkout.
2. kernels - the kernel against its plain torch version on the card, at
             3840x2160 and ragged sizes, for gaborish on/off and
             epf_iters 1-3, with 1/sigma that includes passthrough pixels;
             max abs difference <= 1e-5, and <= 1e-6 more than 8 px from
             the edge. Times are medians of CUDA-event-timed repeats.
3. decode  - jxl_tpu_torch.decode_image of a 3840x2160 XYB Modular stream
             (gaborish on, EPF 2 steps) on the card in u8 and f32, held
             against the port's own device="cpu" decode of the same bytes
             (f32 <= 1e-4, u8 <= 1 LSB); the kernel's launch counter must
             rise during it.
4. profile - one more u8 decode under torch.profiler: device time by
             operation and the card's idle share of the decode.

Then one line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Prints no result without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
WIDTH, HEIGHT = 3840, 2160


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def epf_gab_ops_per_px(gab: bool, epf_iters: int) -> int:
    """fp32 operations per pixel of gaborish + EPF as the stage math
    counts them (adds, muls, abs, max, div; selects not counted)."""
    ops = 33 if gab else 0  # per channel 6 adds + 3 muls + 2 adds
    for step, need in ((0, 3), (1, 1), (2, 2)):
        if epf_iters < need:
            continue
        nn, npat = (12, 5) if step == 0 else (4, 5 if step == 1 else 1)
        # per neighbor: 3 channels x (npat sub + npat abs + (npat-1) add
        # + 1 mul), 2 adds over channels, weight mul+add+max, 1 sum add;
        # per pixel: 1/sigma x multiplier, wsum add, per channel nn
        # mul+add and a divide
        ops += nn * (9 * npat + 6) + 2 + 3 * (2 * nn + 1)
    return ops


def epf_gab_bound_ms(h: int, w: int, gab: bool, epf_iters: int) -> tuple:
    """(bound_ms, bound_by): 28 B/px moved once (3 planes + 1/sigma in,
    3 planes out) against the operations at the fp32 peak."""
    t_bytes = 28 * h * w / HBM_BYTES_PER_S
    t_ops = epf_gab_ops_per_px(gab, epf_iters) * h * w / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event-timed calls after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    from jxl_tpu_torch import native
    from jxl_tpu_torch.ops import epf_gab as K

    errors = []
    secs = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported below; the phase fails
            errors.append(f"{name}: {e}")
        secs[name] = time.perf_counter() - t0

    threads = [
        threading.Thread(target=run, args=("nvcc_epf_gab", K.load)),
        threading.Thread(target=run, args=("gxx_host_decoder", native.get_lib)),
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, "build failed: " + "; ".join(errors))
    info = K.build_info or {}
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines() if "ptxas" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "parts": secs,
          "ptxas": ptxas})


def _kernel_inputs(h, w, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    planes = rng.normal(0.5, 0.2, size=(3, h, w)).astype(np.float32)
    sigma = rng.uniform(-3.0, -0.5, size=(h, w)).astype(np.float32)
    sigma[rng.random((h, w)) < 0.05] = -5.0  # below MIN_SIGMA: passthrough
    return (torch.from_numpy(planes).to(device), torch.from_numpy(sigma).to(device))


RF = dict(pass0_scale=0.9, pass2_scale=6.5, border_sad_mul=2.0 / 3.0,
          channel_scale=(40.0, 5.0, 3.5))
GAB = ((0.115169525, 0.061248592),) * 3


def phase_kernels():
    import torch

    from jxl_tpu_torch.ops import epf_gab as K

    dev = torch.device("cuda")
    results = []
    cases = [((HEIGHT, WIDTH), g, it) for g in (True, False) for it in (1, 2, 3)]
    cases += [((777, 1001), True, 3), ((777, 1001), False, 2), ((33, 65), True, 3),
              ((45, 67), True, 3), ((5, 7), True, 3)]
    for i, ((h, w), gab, iters) in enumerate(cases):
        planes, sigma = _kernel_inputs(h, w, 10 + i, dev)
        args = (planes, sigma, GAB if gab else None, iters, RF["pass0_scale"],
                RF["pass2_scale"], RF["border_sad_mul"], RF["channel_scale"])
        before = K.epf_gab.launches
        got = K.epf_gab(*args)
        launches = K.epf_gab.launches - before
        want = K.epf_gab_reference(*args)
        torch.cuda.synchronize()
        d = (got - want).abs()
        err = float(d.max())
        inner = float(d[:, 8:-8, 8:-8].max()) if h > 16 and w > 16 else 0.0
        rec = {"name": "epf_gab", "shape": [3, h, w], "gab": gab, "epf_iters": iters,
               "launches": launches, "max_abs_diff": err, "max_abs_diff_inner": inner}
        if (h, w) == (HEIGHT, WIDTH) and gab and iters == 2:
            # the main path's configuration: time it
            rec["kernel_ms"] = time_ms(lambda: K.epf_gab(*args))
            rec["plain_ms"] = time_ms(lambda: K.epf_gab_reference(*args), reps=5)
            rec["bound_ms"], rec["bound_by"] = epf_gab_bound_ms(h, w, gab, iters)
            rec["library_ms"] = None  # no single torch call computes gaborish+EPF
        emit({"phase": "kernels", **rec})
        check(launches == 1 and err <= 1e-5 and inner <= 1e-6,
              f"epf_gab disagrees with its plain version at {h}x{w} gab={gab} "
              f"iters={iters}: {err} (inner {inner})")
        results.append(rec)
    main_rec = next(r for r in results if "kernel_ms" in r)
    return main_rec, max(r["max_abs_diff"] for r in results)


def phase_decode():
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import epf_gab as K
    from test_torch_streams import encode_xyb_modular

    t0 = time.perf_counter()
    data, _ = encode_xyb_modular(WIDTH, HEIGHT, seed=7)
    emit({"phase": "decode", "step": "write_stream", "bytes": len(data),
          "seconds": time.perf_counter() - t0})
    mp = WIDTH * HEIGHT / 1e6
    runs = []
    K.epf_gab.launches = 0
    for fmt in ("u8", "f32"):
        for rep in range(3):
            t0 = time.perf_counter()
            img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            out = img.frames[0]
            host = img.timings["host_s"]
            runs.append((fmt, out))
            emit({"phase": "decode", "format": fmt, "rep": rep, "megapixels": mp,
                  "seconds": total, "mp_per_s": mp / total,
                  "host_parse_entropy_s": host, "device_render_s": total - host})
    launches = K.epf_gab.launches
    check(launches > 0, "decode_image did not launch the epf_gab kernel")

    for fmt in ("u8", "f32"):
        got = next(o for f, o in runs if f == fmt)
        check(got.device.type == "cuda", "frames must stay on the card")
        check(tuple(got.shape) == (HEIGHT, WIDTH, 3), f"bad shape {tuple(got.shape)}")
        t0 = time.perf_counter()
        ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0]
        cpu_s = time.perf_counter() - t0
        a = got.cpu().numpy().astype(np.float64)
        b = ref.numpy().astype(np.float64)
        check(np.isfinite(a).all(), "non-finite output")
        diff = float(np.abs(a - b).max())
        limit = 1.0 if fmt == "u8" else 1e-4
        emit({"phase": "decode", "format": fmt, "vs_cpu_max_abs_diff": diff,
              "limit": limit, "cpu_decode_s": cpu_s, "min": float(a.min()),
              "max": float(a.max())})
        check(diff <= limit, f"{fmt} decode on the card differs from the CPU decode: {diff}")
    return launches, data


def phase_profile(data) -> None:
    """One u8 decode under torch.profiler: device time by operation, and
    the share of the decode's wall time the card was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import jxl_tpu_torch

    jxl_tpu_torch.decode_image(data, pixel_format="u8")  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img = jxl_tpu_torch.decode_image(data, pixel_format="u8")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernels and copies as the card ran them (the operators that launched
    # them would count the same time again); CUPTI's own buffer request is
    # the profiler's cost, not the decode's
    ops = sorted(((ev.key, ev.device_time_total, ev.count) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and ev.key != "Activity Buffer Request"),
                 key=lambda t: -t[1])
    busy_ms = sum(t[1] for t in ops) / 1e3
    emit({"phase": "profile", "format": "u8", "wall_ms": wall * 1e3,
          "host_parse_entropy_ms": img.timings["host_s"] * 1e3,
          "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "top_device_ops": [{"op": k[:80], "ms": us / 1e3, "calls": n} for k, us, n in ops[:10]]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    # fail before any output when the package or the stream writer is missing
    import jxl_tpu_torch  # noqa: F401
    import test_torch_streams  # noqa: F401

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a", flush=True)
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})

    phase_build()
    k, max_err = phase_kernels()
    launches, data = phase_decode()
    phase_profile(data)
    emit({"kernels": [{
        "name": "epf_gab", "route": "cuda", "source": "jxl_tpu_torch/csrc/epf_gab.cu",
        "replaces": "jxl_tpu/ops/pallas_epf.py:228", "launches": launches,
        "max_abs_err": max_err, "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
