"""vox_call_ms: the mean time of a request's `words()` call, closed by a
synchronize: the emit, B1 and B2 (span vox.call, host clock)."""

from harness.readings import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "vox.call")
