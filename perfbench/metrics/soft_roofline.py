"""soft_roofline: the least time of a step's soft forward and backward
over the step's device time, in %. The least time counts the plan's live
fragments and the (fragment, column) pairs inside their transition
windows (`harness/peaks.py::soft_ops`, from the plain reference's
fragments at the start), the occupancy written and its cotangent read,
the coordinates read and their gradient written; the device time is the
union of the device's intervals inside each traced step (span
fit.step), averaged over the traced steps (device trace)."""

from harness.readings import span_busy_us


def read(ctx):
    least = ctx.work.get("soft_least_s")
    busy = span_busy_us(ctx, "fit.step")
    if not least or not busy or sum(busy) <= 0:
        return None
    return 100.0 * least / (sum(busy) / len(busy) * 1e-6)
