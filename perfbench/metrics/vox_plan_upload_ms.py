"""vox_plan_upload_ms: the host time of the serving plan's phase
`vox.plan.upload` (the slot rows, the batch tables, the fill layouts and
the grid's geometry put on the card) a traced request, in ms;
the program's span inside the benchmark's span vox.plan (host
clock, `--trace 1` only)."""

from harness.port_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "vox.plan", "vox.plan.upload")
