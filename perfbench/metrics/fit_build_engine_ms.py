"""fit_build_engine_ms: the host time of the engine's plan
(`soft.engine_plan`, `FusedSoftPlan` in `VoxelFit._rebuild_engine`) built at
a fit job's start a traced job, in ms;
the program's spans inside the benchmark's spans fit.plan (host
clock, `--trace 1` only), over the jobs whose build was traced."""

from harness.port_spans import job_ms


def read(ctx):
    return job_ms(ctx, "fit.plan", "soft.engine_plan")
