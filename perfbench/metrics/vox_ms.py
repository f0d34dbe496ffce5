"""vox_ms: the measured window over the requests (new meshes to packed grids) it completed, in ms (host clock)."""

from harness.readings import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx)
