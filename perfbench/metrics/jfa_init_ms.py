"""jfa_init_ms: the device time of a traced SDF request's seed init
(`jfa.seed_init`: `jfa_init_seed`, its boundary mask and packing), in ms;
on the card's clock: CUDA events on the stream at the span's
entry and exit, recorded inside the benchmark's span sdf.request
(`--trace 1` only; device_trace)."""

from harness.port_spans import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, "sdf.request", "jfa.seed_init")
