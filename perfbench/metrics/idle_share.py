"""idle_share.<cell family>: the share of the traced window in which no
kernel, copy or set ran on the device (device trace), in %."""

from harness.readings import idle_share


def read(ctx):
    return idle_share(ctx)
