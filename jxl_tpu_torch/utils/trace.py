"""Tracing and metrics, off unless asked for.

Counterpart of jxl_tpu/utils/trace.py (capability reference: the
reference's optional `tracing` integration, util/tracing_wrappers.rs:8-26,
whose spans are no-ops when it is off; the CLI enables a subscriber,
jxl_cli/src/main.rs:99-106):

- `span(name)` and `@instrument` add a stage's host seconds to a global
  registry when tracing is on, and are no-ops otherwise. With
  `enable(device_events=True)` (the CLI's --print_timings) a span also
  records CUDA events on the current stream around its body, and
  report() adds each stage's card milliseconds from them.
- tracing is on with `JXL_TPU_TRACE=1` in the environment, or `enable()`.
- `metrics` counts what the decode did (megapixels, K3 lanes).
- `device_trace(dir)` is a torch.profiler session around a block that
  writes a Chrome trace into `dir` (it takes the JAX profiler's place).
- `report()` renders the stage totals and the MP/s.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

_enabled = os.environ.get("JXL_TPU_TRACE", "0") not in ("", "0")
_device_events = False

_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_events: dict[str, list] = defaultdict(list)  # name -> [(start, end) CUDA events]


class _Metrics:
    """Counter registry (megapixels decoded, sections, K3 lanes)."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        if _enabled:
            self.counters[name] += value

    def get(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def reset(self) -> None:
        self.counters.clear()


metrics = _Metrics()


def enable(on: bool = True, device_events: bool = False) -> None:
    """Turn tracing on or off; device_events adds CUDA events to spans."""
    global _enabled, _device_events
    _enabled = on
    _device_events = on and device_events


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _times.clear()
    _counts.clear()
    _events.clear()
    metrics.reset()


def _event_pair():
    """(start, end) CUDA events with timing, or None when spans record no
    device time (off, or no card initialised in this process)."""
    if not _device_events:
        return None
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))


@contextlib.contextmanager
def span(name: str):
    """Timed span; about free when tracing is off."""
    if not _enabled:
        yield
        return
    ev = _event_pair()
    if ev is not None:
        ev[0].record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _times[name] += time.perf_counter() - t0
        _counts[name] += 1
        if ev is not None:
            ev[1].record()
            _events[name].append(ev)


def instrument(fn=None, *, name: str | None = None):
    """Decorator form of span (the reference's #[instrument])."""

    def deco(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*a, **kw):
            if not _enabled:
                return f(*a, **kw)
            with span(label):
                return f(*a, **kw)

        return wrapper

    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler session (host and, where there is a card, CUDA
    activity) around a block; writes `log_dir`/trace.json, a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def host_seconds() -> dict:
    """{span name: host seconds} summed since the last reset (spans on
    worker threads add up)."""
    return dict(_times)


def device_ms() -> dict:
    """{span name: card milliseconds summed over its calls}, from the CUDA
    events recorded with enable(device_events=True); waits for the card."""
    if not _events:
        return {}
    import torch

    torch.cuda.synchronize()
    return {name: sum(a.elapsed_time(b) for a, b in evs) for name, evs in _events.items()}


def report() -> str:
    """Per-stage host seconds (and card ms where recorded) and the MP/s."""
    dev = device_ms()
    lines = ["stage                                   calls   total_s    avg_ms  device_ms"]
    for name in sorted(_times, key=lambda n: -_times[n]):
        t, c = _times[name], _counts[name]
        d = f"{dev[name]:>11.3f}" if name in dev else f"{'-':>11}"
        lines.append(f"{name:<40}{c:>5}{t:>10.3f}{t / c * 1e3:>10.2f}{d}")
    mp = metrics.get("megapixels_decoded")
    total = metrics.get("decode_seconds")
    if mp and total:
        lines.append(f"decode throughput: {mp / total:.3f} MP/s ({mp:.2f} MP in {total:.3f}s)")
    for k, v in sorted(metrics.counters.items()):
        if k not in ("megapixels_decoded", "decode_seconds"):
            lines.append(f"counter {k}: {v:g}")
    return "\n".join(lines)
