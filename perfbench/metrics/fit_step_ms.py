"""fit_step_ms: the measured window over the Adam steps it completed, in
ms (host clock); any plan refresh inside the window is included."""

from harness.readings import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx)
