#!/usr/bin/env python3
"""Where K3's and K2's time goes on the card: cycles a step of each lane.

    python3 tools/k3_probe.py [--sass PATH]

Needs one CUDA card, nvcc and the package beside it, as chip_smoke.py
does. It writes the 3840x2160 VarDCT test stream and decodes its lanes
through the K3 wrapper (ops/device_ac.py:decode_ac_sections) twice: with
the normal build, timed by CUDA events around its launch
(chip_smoke.device_times), and with the build of the same
source with -DK3_PROBE, whose kernel counts each lane's cycles, tokens and
cycles in the coefficient loop (clock64). Then it decodes chip_smoke.py's
main K2 case (135 writer streams, 4096 steps each) through the K2 wrapper
(ops/ans_lanes.py:ans_decode_batch) the same two ways; the probe build
counts each stream's cycles in its token loop and before it, and the
loop's nanoseconds (so the SM clock). It prints one JSON line:
the K3 device time, and for the lane with the most cycles its tokens,
items, cycles a token and the share of its cycles spent in the
coefficient loop; then K2's device time and its cycles a step (the
slowest stream, and over all streams). With --sass it also writes the
normal build's SASS (cuobjdump) to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", help="write the kernel's SASS here")
    args = ap.parse_args()
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from jxl_tpu_torch.ops import _nvcc, device_ac
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS
    from test_torch_vardct_streams import encode_xyb_vardct

    AL.load()
    if args.sass:
        so, _ = _nvcc.build("ans_lanes")
        cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        res = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", str(so)],
                             capture_output=True, text=True, timeout=300)
        with open(args.sass, "w") as f:
            f.write(res.stdout + res.stderr)
    probe = AL.load(probe=True)

    data, written = encode_xyb_vardct(chip_smoke.WIDTH, chip_smoke.HEIGHT, seed=7)
    inp = chip_smoke._lane_inputs(data)
    dev = torch.device("cuda")
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in inp.items() if k not in LANE_KEYWORDS}
    kw = {k: inp[k] for k in LANE_KEYWORDS}
    b, c = device_ac.pack_tables(inp["tables"], inp["uint_cfgs"], inp["context_map"])
    kw.update(packed_buckets=torch.from_numpy(b).to(dev), packed_cfgs=torch.from_numpy(c).to(dev))
    kernel_ms = chip_smoke.device_times(
        [(0, lambda: device_ac.decode_ac_sections(**arrays, **kw), AL.load(),
          "ac_sections_launch")], reps=5)[0]

    with mock.patch.object(device_ac, "load", lambda: probe):
        coeffs, ok = device_ac.decode_ac_sections(**arrays, **kw)
    torch.cuda.synchronize()
    S = len(inp["start_bits"])
    counts = np.zeros(3 * S, np.int64)
    err = probe.k3_probe_read(counts.ctypes.data, S)
    if err != 0:
        raise RuntimeError(f"reading the counters failed: {probe.ans_lanes_error_string(err)}")
    cycles, tokens, loop = counts[0::3], counts[1::3], counts[2::3]
    m = int(np.argmax(cycles))

    streams, table, k2_tokens, _ = chip_smoke._k2_streams(135, 4096, 1)
    st, tb = torch.from_numpy(streams).to(dev), torch.from_numpy(table).to(dev)
    T = k2_tokens.shape[1]
    k2_ms = chip_smoke.device_times(
        [(0, lambda: AL.ans_decode_batch(st, tb, 6, T), AL.load(), "ans_decode_lanes_launch")])[0]
    with mock.patch.object(AL, "load", lambda: probe):
        k2_got, _ = AL.ans_decode_batch(st, tb, 6, T)
    torch.cuda.synchronize()
    k2_counts = np.zeros(3 * len(streams), np.int64)
    err = probe.k2_probe_read(k2_counts.ctypes.data, len(streams))
    if err != 0:
        raise RuntimeError(f"reading K2's counters failed: {probe.ans_lanes_error_string(err)}")
    k2_cycles, k2_before, k2_ns = k2_counts[0::3], k2_counts[1::3], k2_counts[2::3]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({
        "card": smi.stdout.strip(), "k3_kernel_ms": kernel_ms,
        "coefficients_equal_the_writers": bool(np.array_equal(coeffs.cpu().numpy(), written)),
        "longest_lane": m, "tokens": int(tokens[m]), "items": int(inp["lane_n_items"][m]),
        "cycles": int(cycles[m]), "cycles_per_token": float(cycles[m] / tokens[m]),
        "coefficient_loop_share": float(loop[m] / cycles[m]),
        "cycles_per_token_all_lanes": float(cycles.sum() / tokens.sum()),
        "ok_lanes": int(ok.sum()),
        "k2": {"streams": len(streams), "steps": T, "kernel_ms": k2_ms,
               "ns_per_step": k2_ms * 1e6 / T,
               "tokens_equal_the_writers": bool(np.array_equal(k2_got.cpu().numpy(), k2_tokens)),
               "cycles_per_step_slowest": float(k2_cycles.max() / T),
               "cycles_per_step_mean": float(k2_cycles.mean() / T),
               "cycles_before_the_loop": int(k2_before.max()),
               "sm_clock_ghz": float(k2_cycles.sum() / k2_ns.sum())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
