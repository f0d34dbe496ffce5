"""The program's own spans, as the metric readers see them.

`voxtpu_torch.utils.trace` keeps a record of each of the port's phase
spans (`vox.plan.*`, `soft.plan`, `soft.engine_plan`, `jfa.*`) while a
`torch.profiler` profile runs, which in a run of the benchmark is the
traced part of a `--trace 1` window. A record holds its name, its start
and end on `time.perf_counter` (the clock of the benchmark's own spans,
`record.Recorder`), its counts, and, for a span on a CUDA device, the
device time between two CUDA events. A reader keeps only the records
that lie inside one of the window's benchmark spans, so that set-up and
warm-up never count. A program without the store gives no records.
"""

from __future__ import annotations

import bisect


def records(name: str) -> list:
    """The program's stored records named `name`, oldest first."""
    try:
        from voxtpu_torch.utils.trace import recorded
    except ImportError:  # a program without spans of its own
        return []
    return [r for r in recorded() if r.name == name]


def inside(ctx, span: str, name: str) -> list[list]:
    """The records named `name` inside each of the window's benchmark
    spans `span` that holds any, one list a span, in the window's order."""
    spans = sorted(ctx.spans(span), key=lambda s: s.t0)
    starts = [s.t0 for s in spans]
    held: dict = {}
    for r in records(name):
        i = bisect.bisect_right(starts, r.t0) - 1
        if i >= 0 and r.t1 <= spans[i].t1:
            held.setdefault(i, []).append(r)
    return [held[i] for i in sorted(held)]


def mean_ms(ctx, span: str, name: str) -> float | None:
    """The host time of the records `name` a benchmark span `span` that
    holds any, in ms (host clock)."""
    groups = inside(ctx, span, name)
    if not groups:
        return None
    return sum(r.seconds for g in groups for r in g) / len(groups) * 1e3


def mean_device_ms(ctx, span: str, name: str) -> float | None:
    """The CUDA events' time of the records `name` a benchmark span
    `span` that holds any, in ms; None where a record has no device time
    (a span off the card)."""
    groups = inside(ctx, span, name)
    times = [r.device_ms for g in groups for r in g]
    if not groups or any(t is None for t in times):
        return None
    return sum(times) / len(groups)


def job_ms(ctx, span: str, name: str) -> float | None:
    """The host time of the records `name` inside benchmark spans `span`
    (`fit.plan`: the build; `fit.step`: the refreshes) a traced fit job,
    in ms; 0 where the traced jobs held none. A job is traced where its
    `fit.plan` span holds a `soft.plan` record."""
    jobs = len(inside(ctx, "fit.plan", "soft.plan"))
    if not jobs:
        return None
    return sum(r.seconds for g in inside(ctx, span, name) for r in g) / jobs * 1e3
