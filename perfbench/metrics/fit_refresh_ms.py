"""fit_refresh_ms: the training host plan's time a job, in ms (host
clock): the plan build at the job's start (span fit.plan), plus, for
each step in which `VoxelFit.refresh_count` rose, that step's wall time
less the mean wall time of the steps without a refresh; the mean over
the window's jobs."""


def read(ctx):
    plans = ctx.spans("fit.plan")
    steps = ctx.units
    plain = [u["s"] for u in steps if not u["refreshed"]]
    jobs = {u["job"] for u in steps}
    if not steps or not plain or not jobs:
        return None
    base = sum(plain) / len(plain)
    extra = sum(u["s"] - base for u in steps if u["refreshed"])
    return (sum(s.seconds for s in plans) + extra) / len(jobs) * 1e3
