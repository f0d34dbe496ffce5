"""sdf_ms: the measured window over the SDF requests it completed, in ms (host clock)."""

from harness.readings import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx)
