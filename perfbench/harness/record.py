"""What a run records: host spans, units of work, and the device trace.

A span is the benchmark's own host-clock interval around one call into a
layer of the program (`Recorder.span`); each is also a named
`torch.profiler.record_function` range, so that a traced run can tell
which call the device's work and idle gaps belong to. A unit is one
request, or one step of a fit, with its wall time and facts about it.

`Tracer` runs `torch.profiler` over the first `units` units of a
`--trace 1` window and reduces the trace in memory: the device's
intervals (kernels, copies, sets) and the spans' intervals on the
profiler's clock. The traced window runs from the first traced span's
start to the last one's end. Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Recorder:
    """Host spans and units of one window, on `time.perf_counter`."""

    def __init__(self):
        self.spans: list[Span] = []
        self.units: list[dict] = []
        self.counters: dict = {}
        self.window_s = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.append(Span(name, t0, time.perf_counter()))

    def spans_named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


@dataclasses.dataclass
class Trace:
    """A traced window: device intervals [(name, start_us, end_us)], the
    benchmark's spans [(name, start_us, end_us)] and the host's other
    ranges (for labelling idle gaps), all on the profiler's clock."""

    device: list
    spans: list
    host: list
    window_s: float
    start_us: float
    end_us: float

    def busy_us(self, t0: float | None = None, t1: float | None = None) -> float:
        """Union of the device intervals, clipped to [t0, t1] (us)."""
        t0 = self.start_us if t0 is None else t0
        t1 = self.end_us if t1 is None else t1
        return union_us([(max(s, t0), min(e, t1)) for _, s, e in self.device
                         if e > t0 and s < t1])

    def kernels_in(self, t0: float, t1: float) -> list:
        return [(n, s, e) for n, s, e in self.device if s >= t0 and e <= t1]

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == SPAN_PREFIX + name]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur = 0.0, None
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (cur[1] - cur[0] if cur else 0.0)


class Tracer:
    """`torch.profiler` over the first `units` units of a window; off
    unless `enabled`."""

    def __init__(self, enabled: bool, units: int):
        self.enabled = enabled
        self.units = max(1, int(units))
        self.done = 0
        self.prof = None
        self.trace: Trace | None = None

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()

    def unit_done(self):
        """Call after each unit (its work synchronized)."""
        self.done += 1
        if self.prof is not None and self.done >= self.units:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        self.prof.stop()
        prof, self.prof = self.prof, None
        self.trace = _reduce(prof)


def _reduce(prof) -> Trace:
    device, spans, host = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.name.startswith(SPAN_PREFIX):
            # A named range shows on the host and, as an annotation, on
            # the device's timeline too; only the host's is a span.
            if ev.device_type != cuda:
                spans.append((ev.name, s, e))
        elif ev.device_type == cuda:
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
    # The traced window: from the first traced unit's span to the last's.
    t0 = min((s for _, s, _ in spans), default=0.0)
    t1 = max((e for _, _, e in spans), default=t0)
    device = [d for d in device if d[2] > t0 and d[1] < t1]
    return Trace(device=device, spans=spans, host=host, window_s=(t1 - t0) * 1e-6,
                 start_us=t0, end_us=t1)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each gap named by the benchmark span and the outermost other
    host range that were open at its middle: [[name, seconds], ...]."""
    by_name: dict = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, cur = [], trace.start_us
    for _, s, e in sorted(trace.device, key=lambda d: d[1]):
        if s > cur:
            gaps.append((s - cur, cur, s))
        cur = max(cur, e)
    if trace.end_us > cur:
        gaps.append((trace.end_us - cur, cur, trace.end_us))
    named = []
    for length, a, b in sorted(gaps, reverse=True)[:top]:
        mid = (a + b) / 2
        span = _innermost(trace.spans, mid)
        host = _outermost(trace.host, mid)
        label = "/".join(x for x in (span[len(SPAN_PREFIX):] if span else "outside spans",
                                     host) if x)
        named.append([label[:200], length * 1e-6])
    return {"device_ops": [[n[:200], t] for n, t in ops], "idle_gaps": named}


def _innermost(ranges, t):
    best = None
    for name, s, e in ranges:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def _outermost(ranges, t):
    best = None
    for name, s, e in ranges:
        if s <= t <= e and (best is None or e - s > best[1]):
            best = (name, e - s)
    return best[0] if best else None
