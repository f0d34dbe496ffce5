"""Arithmetic that the metric readers (`perfbench/metrics/*.py`) share."""

from __future__ import annotations

import math


def per_unit_ms(ctx) -> float | None:
    """The window's length over the units it completed, in ms."""
    return ctx.window_s / len(ctx.units) * 1e3 if ctx.units else None


def quantile(values, q: float) -> float | None:
    """The q-quantile by nearest rank: the least value with at least a
    share q of the values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def mean_span_ms(ctx, name: str) -> float | None:
    spans = ctx.spans(name)
    return sum(s.seconds for s in spans) / len(spans) * 1e3 if spans else None


def idle_share(ctx) -> float | None:
    """100 x (1 - the device's busy time / the traced window)."""
    trace = ctx.trace
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us() * 1e-6 / trace.window_s)


def span_busy_us(ctx, name: str) -> list[float]:
    """The device's busy time inside each traced span `name`, in us."""
    trace = ctx.trace
    if trace is None:
        return []
    return [trace.busy_us(s, e) for s, e in trace.spans_named(name)]
