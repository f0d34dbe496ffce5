"""vox_plan_candidates_ms: the host time of the serving plan's phase
`vox.plan.candidates` (`_exact_candidates`) a traced request, in ms;
the program's span inside the benchmark's span vox.plan (host
clock, `--trace 1` only)."""

from harness.port_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "vox.plan", "vox.plan.candidates")
