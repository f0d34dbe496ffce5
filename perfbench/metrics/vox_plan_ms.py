"""vox_plan_ms: the mean host time of a request's plan, `GridSpec.fit`
and `BandedSlotVoxPipeline(...)` (span vox.plan, host clock)."""

from harness.readings import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "vox.plan")
