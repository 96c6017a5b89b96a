"""Tracing and metrics, off unless asked for.

Counterpart of jxl_tpu/utils/trace.py (capability reference: the
reference's optional `tracing` integration, util/tracing_wrappers.rs:8-26,
whose spans are no-ops when it is off; the CLI enables a subscriber,
jxl_cli/src/main.rs:99-106).

`span(name)` and `@instrument` mark a phase of the decode. A span does
one of three things:

- off (neither `enable()` nor a collecting torch.profiler): nothing but
  one flag read and one check of the profiler's state; it records no
  event and never waits for the card;
- a torch.profiler session is collecting (the CLI's --profile_dir, a
  benchmark's traced run): a host range under the span's name on the
  profiler's timeline, on the clock of the card's activity. The range is
  recorded at function scope, not as a user annotation, so the profiler
  derives no device event from it and the card's timeline holds only the
  card's own work. Where the installed torch lacks the fast range class,
  a span gives the profiler nothing;
- tracing is on (`JXL_TPU_TRACE=1` in the environment, or `enable()`):
  the span's host seconds and calls add to a registry that `report()`
  prints; with `enable(device_events=True)` (the CLI's --print_timings)
  it also records CUDA events on the current stream around its body, and
  report() adds each stage's card milliseconds from them.

The spans of a decode, by owner module (README's table names each one):

- api/simple.py: `decode_image` (the whole call), `decode_image.headers`
  (container, file header, ICC, preview skip; each frame's header and
  TOC), `decode_image.sections`, `frame.render`;
- api/frame.py: `frame.lf_global`, `frame.lf_groups` (all LF groups of a
  frame), `frame.hf_global` (HfGlobal and the LF smoothing),
  `frame.modular_groups` (a Modular frame's group sections: their
  entropy decode, prediction and inverse transforms, on the host pool
  or, on the card, by K6 up to the read of its lanes' status);
- vardct/device_group.py: `frame.lane_plan` (the lanes' host tables),
  `frame.k3_launch` (packing, upload and the K3 launch);
- render/simple.py: `render.host_route` (a frame rendered on the host),
  `render.modular_planes` (a Modular frame's integer planes uploaded,
  unless K6 decoded them on the card, and converted to float),
  `render.ac_wait` (the host blocked on the lane flags, so on the card),
  `render.stages` (K1, colour and output queued);
- vardct/device_frame.py: `render.blocks` (the block tables on the host),
  `render.transforms` (their upload and the transforms queued), in the
  4:4:4 render and the chroma-subsampled one;
- render/pipeline.py: `render.chroma_upsample` (one chroma upsampling
  pass of one channel, inside `render.stages`).

`metrics` counts what the decode did (megapixels, K3 lanes, the frames
whose lane tables were built, the chroma upsampling passes, K5's launches
and blocks: `vardct_blocks_launches`, `vardct_blocks_blocks`; the Modular
sub-bitstreams the native decoder decoded, `modular_group_streams`, and
the samples its general tree loop decoded, `modular_tree_samples`; the
group streams K6 decoded on the card, `modular_card_streams`, counted by
modular/group_lanes.py: 135 a 4K frame when the route engages, and then
none of them in the first two), only while tracing is on.
`device_trace(dir)` is a torch.profiler session around a block that
writes a Chrome trace into `dir` (it takes the JAX profiler's place).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

from torch.autograd import _profiler_enabled

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # an older torch: spans give the profiler nothing
    _RecordFunctionFast = None

_enabled = os.environ.get("JXL_TPU_TRACE", "0") not in ("", "0")
_device_events = False
_OFF = contextlib.nullcontext()

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


def _profiler_range(name: str):
    """The span's host range on a collecting profiler's timeline."""
    if _RecordFunctionFast is None or not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


def span(name: str):
    """A phase of the decode, as a context manager: about free when
    tracing is off and no profiler is collecting (module docstring)."""
    if _enabled:
        return _timed(name)
    return _profiler_range(name)


@contextlib.contextmanager
def _timed(name: str):
    ev = _event_pair()
    with _profiler_range(name):
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
            with span(label):
                return f(*a, **kw)

        return wrapper

    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler session (host and, where there is a card, CUDA
    activity) around a block; writes `log_dir`/trace.json, a Chrome trace
    in which the decode's spans mark its phases."""
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
