"""The traced window of a `--trace 1` run: the device's activity and the
host's spans from torch.profiler, reduced to what the per-layer readers
(metrics/*.py) and the result's breakdown need.

The program's device activity is what starts inside a DECODE_SPAN: each
decode ends in a synchronise inside its span, so what starts between
two decodes is the benchmark's own (the copies of the frames kept for
the comparison) and counts neither as the program's work nor as busy."""

from __future__ import annotations

from dataclasses import dataclass, field

WINDOW_SPAN = "portbench.window"
DECODE_SPAN = "portbench.decode"
# labels of the idle gaps where the host ran no torch operation
GAP_LABELS = {DECODE_SPAN: "decode_image outside torch ops (host parse, entropy, Python)",
              None: "between decodes (the benchmark's loop and sample copies)"}
# the profiler's own buffer requests, not the program's work
_NOT_WORK = ("Activity Buffer Request",)


@dataclass
class Trace:
    """Device activity (kernels, copies, sets) and host spans of the
    window, in ns of the profiler's clock, each (name, start, end)."""

    window: tuple  # (start, end)
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def device_seconds(self, match) -> float:
        """Seconds of device activity whose name `match` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9

    def busy_intervals(self) -> list:
        """The union of device activity inside the window, merged."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device if e > w0 and s < w1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        tot = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        return [[k[:120], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The window's idle time by what the host was doing at each gap's
        middle (the innermost host span then; outside every decode, the
        benchmark's own), summed a label, the largest n labels."""
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        host = sorted(self.host, key=lambda t: t[1])
        decodes = sorted((s, e) for n, s, e in host if n == DECODE_SPAN)
        tot, stack, j = {}, [], 0
        # a sweep over the gaps' middles: the stack holds the host spans
        # open there, the innermost on top
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (g0 + g1) // 2
            while j < len(host) and host[j][1] <= mid:
                while stack and stack[-1][2] < host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            label = stack[-1][0] if stack and inside(decodes, mid) else None
            label = GAP_LABELS.get(label, label)
            tot[label] = tot.get(label, 0) + (g1 - g0)
        return [[k[:120], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def inside(spans: list, t: int) -> bool:
    """Whether t lies in one of the sorted, disjoint (start, end) spans."""
    import bisect

    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def from_profiler(prof) -> Trace:
    """The Trace of a finished torch.profiler.profile run whose window is
    the one WINDOW_SPAN host span; device activity outside every
    DECODE_SPAN is left out."""
    events = prof.profiler.kineto_results.events()
    window, device, host = None, [], []
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type().name == "CUDA":
            # the benchmark's own spans show on the device's timeline too
            if name not in _NOT_WORK and not name.startswith("portbench."):
                device.append((name, s, e))
        elif name == WINDOW_SPAN:
            window = (s, e)
        else:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace lost its {WINDOW_SPAN} span")
    decodes = sorted((s, e) for n, s, e in host if n == DECODE_SPAN)
    return Trace(window, [d for d in device if inside(decodes, d[1])], host)
