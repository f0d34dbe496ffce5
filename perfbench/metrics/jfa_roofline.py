"""jfa_roofline: the least time of the traced SDF requests' `jfa()` calls
over their device time, in %. The least time of a call counts the
packed grid read once and the float32 field written once at the HBM
rate, against the flood's operations (`harness/peaks.py::flood_ops`,
from the seeds each step reads in the plain reference's flood) at the
uncontracted float32 and compare rates; the device time is the union of
the device's intervals inside each request's span (device trace)."""

from harness.readings import span_busy_us


def read(ctx):
    least = ctx.work.get("jfa_least_s")
    busy = span_busy_us(ctx, "sdf.request")
    if not least or not busy or sum(busy) <= 0:
        return None
    grids = [u["input"] for u in ctx.units[:len(busy)]]
    return 100.0 * sum(least[g] for g in grids) / (sum(busy) * 1e-6)
