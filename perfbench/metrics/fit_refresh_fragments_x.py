"""fit_refresh_fragments_x: the fragments of the soft plan a drift refresh
rebuilds (`soft.plan` inside the benchmark's spans fit.step) over those of
the plan built at the same job's start (`soft.plan` inside fit.plan), the
mean over the traced jobs that refreshed: above 1, the refresh builds more
plan than the build did (the program's span counts, `--trace 1` only)."""

from harness.port_spans import inside


def read(ctx):
    builds = [(r.t0, r.counts["fragments"]) for g in inside(ctx, "fit.plan", "soft.plan")
              for r in g]
    by_job: dict = {}
    for g in inside(ctx, "fit.step", "soft.plan"):
        for r in g:
            earlier = [f for t0, f in builds if t0 < r.t0]
            if earlier and earlier[-1]:
                by_job.setdefault(len(earlier), []).append(r.counts["fragments"] / earlier[-1])
    if not by_job:
        return None
    return sum(sum(v) / len(v) for v in by_job.values()) / len(by_job)
