"""vox_plan_batches_ms: the host time of the serving plan's phase
`vox.plan.batches` (the sort, the greedy batch cut, the PACK padding and
the slot index, of the narrow and of the wide batches) a traced request, in ms;
the program's span inside the benchmark's span vox.plan (host
clock, `--trace 1` only)."""

from harness.port_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "vox.plan", "vox.plan.batches")
