"""fit_job_step_ms: the measured window over the Adam steps of the fit
jobs it completed, each job's plan build and refreshes included, in ms
(host clock)."""

from harness.readings import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx)
