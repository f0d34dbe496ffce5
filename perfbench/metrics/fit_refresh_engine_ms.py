"""fit_refresh_engine_ms: the host time of the engine's plan
(`soft.engine_plan`) rebuilt by the drift refreshes a traced job, 0 in a
job without one, in ms;
the program's spans inside the benchmark's spans fit.step (host
clock, `--trace 1` only), over the jobs whose build was traced."""

from harness.port_spans import job_ms


def read(ctx):
    return job_ms(ctx, "fit.step", "soft.engine_plan")
