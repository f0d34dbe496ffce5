"""fit_build_plan_ms: the host time of the soft plan (`soft.plan`,
`make_soft_plan`) built at a fit job's start a traced job, in ms;
the program's spans inside the benchmark's spans fit.plan (host
clock, `--trace 1` only), over the jobs whose build was traced."""

from harness.port_spans import job_ms


def read(ctx):
    return job_ms(ctx, "fit.plan", "soft.plan")
