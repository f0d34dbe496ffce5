"""vox_plan_fit_ms: the host time of the grid fit `grid.fit`
(`GridSpec.fit`, the bounding box of the request's mesh) a traced
request, in ms; the program's span inside the benchmark's span
vox.plan (host clock, `--trace 1` only)."""

from harness.port_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "vox.plan", "grid.fit")
