"""sdf_p95_ms: the 95th percentile (nearest rank) of every SDF request's
latency in the window, each the host's wall time from the call to the
synchronize that ends it, in ms (host clock)."""

from harness.readings import quantile


def read(ctx):
    p95 = quantile([u["s"] for u in ctx.units], 0.95)
    return None if p95 is None else p95 * 1e3
