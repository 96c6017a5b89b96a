"""The benchmark of jxl_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (BENCHMARK.json's "workloads") names a configuration
(portbench/configs/<config>.json: the writer, its options and the plain
reference) and a traffic mix (portbench/workloads/<cell>.json: the
sizes, the pool and the limits of the comparison). A run

1. writes the cell's pool of files from --seed with the configuration's
   writer (portbench/writers/), timed apart from the set-up;
2. sets the port up and decodes the first file of each size in the pool
   WARM_DECODES times (setup_s: the imports, the card, the native and
   CUDA builds, the warm decodes);
3. decodes for --seconds in a closed loop of one client: the pool in a
   seeded order, each call jxl_tpu_torch.decode_image(data,
   pixel_format="u8", device="cuda") ending in torch.cuda.synchronize();
   with --trace 1 the window runs under torch.profiler;
4. compares a seeded sample of the window's frames, the first decode of
   each file among them, with the configuration's plain reference
   (portbench/reference/), rendered on the card after the window, from
   what the writer put in;
5. prints the cell's end-to-end metrics (--trace 0) or per-layer metrics
   (--trace 1, each read by portbench/metrics/<name>.py) as the last line
   of standard output, one JSON object, its "check" last; and the numbers
   compared, each beside its limit, as the last lines of standard error.

It exits non-zero without a printed result where no card is found, where
the port is absent, or where a module of JAX or of the JAX package is
loaded. The environment's JXL_TPU_* variables are cleared: every cell
measures the routes a user gets by default.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "jxl_tpu")
# the warm decodes of each distinct size before the window
WARM_DECODES = 2


@dataclass
class PoolFile:
    width: int
    height: int
    data: bytes
    coded: dict


@dataclass
class Decode:
    index: int  # the pool file
    latency_s: float
    host_s: float | None


@dataclass
class Run:
    """What a run saw, for the per-layer readers (metrics/*.py)."""

    pool: list
    decodes: list = field(default_factory=list)
    trace: object = None


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def pool_seed(seed: int, i: int) -> int:
    """The writer's seed of pool file i of a run seeded `seed`."""
    import numpy as np

    return int(np.random.SeedSequence([seed, i]).generate_state(2, np.uint32).view(np.uint64)[0])


def write_pool(config: dict, cell: dict, seed: int) -> list:
    writer = importlib.import_module(f"portbench.writers.{config['writer']}")
    sizes = cell["sizes"]
    out = []
    for i in range(cell["pool"]):
        w, h = sizes[i % len(sizes)]
        data, coded = writer.write(w, h, pool_seed(seed, i), **config["writer_options"])
        out.append(PoolFile(w, h, data, coded))
    return out


def cell_metrics(bench: dict, key: str, cell_name: str) -> list:
    """The metrics of BENCHMARK.json's list `key` that this cell reports."""
    return [m for m in bench[key] if cell_name in m.get("workloads", [cell_name])]


def load_reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Card:
    """Synchronisation and memory readings of the device the run decodes
    on: the card, or the CPU where the tests drive a run without one."""

    def __init__(self, torch, device: str):
        self.torch, self.device = torch, device
        self.cuda = device == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def allocated(self) -> int:
        return self.torch.cuda.memory_allocated() if self.cuda else 0

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def free(self):
        if self.cuda:
            self.torch.cuda.empty_cache()


def decode_window(jxl, card, pool, order_rng, seconds: float, sample_rng, share: float,
                  profiler=None):
    """The closed loop: (decodes, failures, kept frames [(pool index, u8
    frames on the host)], window seconds, peak bytes above the window's
    start)."""
    card.sync()
    card.reset_peak()
    base = card.allocated()
    from portbench.trace import DECODE_SPAN, WINDOW_SPAN

    decodes, failures, kept, seen, order = [], [], [], set(), []

    def span(name):
        if profiler is None:
            return contextlib.nullcontext()
        return card.torch.profiler.record_function(name)

    with profiler if profiler is not None else contextlib.nullcontext():
        with span(WINDOW_SPAN):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                if not order:
                    order = order_rng.permutation(len(pool)).tolist()
                i = order.pop()
                ts = time.perf_counter()
                try:
                    with span(DECODE_SPAN):
                        img = jxl.decode_image(pool[i].data, pixel_format="u8",
                                               device=card.device)
                        card.sync()
                except Exception as exc:  # a failed decode counts; the loop goes on
                    card.sync()
                    failures.append(f"{type(exc).__name__}: {exc}"[:300])
                    continue
                lat = time.perf_counter() - ts
                decodes.append(Decode(i, lat, img.timings.get("host_s")))
                if i not in seen or sample_rng.random() < share:
                    seen.add(i)
                    kept.append((i, [f.cpu() for f in img.frames]))
                del img
            window = time.perf_counter() - t0
    return decodes, failures, kept, window, card.peak() - base


def compare(torch, out, ref) -> tuple:
    """(the largest distance of a uint8 sample `out` from the reference's
    8-bit output before its rounding, `ref`, beyond the half step that
    rounding allows, in 8-bit steps; the samples that round apart)."""
    d = (out.to(torch.float32) - ref).abs()
    return float((d - 0.5).clamp_min(0.0).max()), int((out != torch.round(ref).to(out.dtype)).sum())


def check(torch, pool, kept, config, device) -> dict:
    """The comparison of the kept frames with the plain reference, each
    file's reference rendered once: the numbers compared (limits in the
    cell) and what was compared."""
    ref_mod = importlib.import_module(f"portbench.reference.{config['reference']}")
    by_file = {}
    for i, frames in kept:
        by_file.setdefault(i, []).append(frames)
    worst, off, total, shape_bad = 0.0, 0, 0, 0
    for i, got in sorted(by_file.items()):
        f = pool[i]
        ref = ref_mod.render(f.coded, f.width, f.height, device).cpu()
        for frames in got:
            if len(frames) != 1 or tuple(frames[0].shape) != tuple(ref.shape):
                shape_bad += 1
                continue
            m, k = compare(torch, frames[0], ref)
            worst, off, total = max(worst, m), off + k, total + ref.numel()
        del ref
    return {"excess_lsb": worst, "off_share_pct": 100.0 * off / total if total else 100.0,
            "frames_compared": len(kept), "frames_misshapen": shape_bad}


def run_cell(bench: dict, cell_name: str, cell: dict, config: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda", setup_s: float = 0.0) -> dict:
    """One run of a cell on `device` (the card; the CPU only in the
    tests): the result line's object."""
    import numpy as np
    import torch

    entry = {w["name"]: w for w in bench["workloads"]}[cell_name]
    card = Card(torch, device)
    t0 = time.perf_counter()
    pool = write_pool(config, cell, seed)
    print(f"portbench: wrote {len(pool)} files ({sum(len(f.data) for f in pool)} bytes) "
          f"in {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    try:
        import jxl_tpu_torch as jxl
    except ImportError as exc:
        fail(f"the port does not import: {exc}")
    if card.cuda:
        torch.cuda.init()
    warm = []
    for f in {(f.width, f.height): f for f in reversed(pool)}.values():
        for _ in range(WARM_DECODES):  # every size the window uses
            ts = time.perf_counter()
            jxl.decode_image(f.data, pixel_format="u8", device=device)
            card.sync()
            warm.append(time.perf_counter() - ts)
    setup_s += time.perf_counter() - t0
    print("portbench: warm decodes " + " ".join(f"{s:.4f}" for s in warm) + " s",
          file=sys.stderr, flush=True)
    setup_peak = card.peak()
    # what set-up left behind stays out of the window's garbage collections
    gc.collect()
    gc.freeze()

    order_rng = np.random.default_rng([seed, 1 << 20])
    sample_rng = np.random.default_rng([seed, 1 << 21])
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if card.cuda else []))
    decodes, failures, kept, window, peak = decode_window(
        jxl, card, pool, order_rng, seconds, sample_rng, cell["check"]["sample_share"], prof)
    memory_peak = max(setup_peak, card.peak())
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")

    run = Run(pool, decodes)
    metrics = {}
    if trace:
        from portbench import trace as trace_mod

        run.trace = trace_mod.from_profiler(prof)
        del prof
        for m in cell_metrics(bench, "per_layer", cell_name):
            v = load_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat = [d.latency_s for d in decodes]
        e2e = {
            "mp_per_s": sum(pool[d.index].width * pool[d.index].height for d in decodes)
            / 1e6 / window,
            "decode_p90_ms": 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[-1]
            if len(lat) >= 2 else None,
            "peak_card_mb": peak / 1e6,
            "setup_s": setup_s,
        }
        for m in cell_metrics(bench, "end_to_end", cell_name):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the comparison, once the window's state is freed
    card.free()
    got = check(torch, pool, kept, config, device)
    limits = cell["check"]["limits"]
    correct = (not failures and got["frames_misshapen"] == 0 and got["frames_compared"] > 0
               and all(got[k] <= lim for k, lim in limits.items()))
    checked = {k: {"value": got[k], "limit": lim} for k, lim in limits.items()}
    checked["frames_misshapen"] = {"value": got["frames_misshapen"], "limit": 0}
    checked["failed_decodes"] = {"value": len(failures), "limit": 0}
    checked["frames_compared"] = got["frames_compared"]

    result = {
        "correct": bool(correct),
        "attempted": len(decodes) + len(failures),
        "failed": len(failures),
        "metrics": metrics,
        "device": {"platform": "gpu" if card.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if card.cuda else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": int(memory_peak)},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["check"] = checked
    for msg in failures[:5]:
        print(f"portbench: decode failed: {msg}", file=sys.stderr)
    print(f"portbench: {len(decodes)} decodes in {window:.3f} s", file=sys.stderr)
    for k, v in checked.items():
        if isinstance(v, dict):
            print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
        else:
            print(f"check {k} {v}", file=sys.stderr)
    sys.stderr.flush()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    for k in [k for k in os.environ if k.startswith("JXL_TPU_")]:
        del os.environ[k]
    os.environ["USE_FLAX"] = "0"

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = load_json(os.path.join(BENCH, "workloads", f"{args.workload}.json"))
    config = load_json(os.path.join(BENCH, "configs", f"{cells[args.workload]['config']}.json"))

    t0 = time.perf_counter()
    import torch

    import_s = time.perf_counter() - t0
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    result = run_cell(bench, args.workload, cell, config, args.seed, args.seconds,
                      bool(args.trace), "cuda", import_s)
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
