"""jfa_seed_init_ms: the device time, a traced SDF request, of the
kernels of its `jfa()` call other than the flood steps (B3, B4, B6) and
the signed distance pass (B5): the unpack of the packed grid and the seed
init's torch ops (device trace). `jfa()` gives the benchmark no seam
around its seed init, so the kernels are told apart by name."""

FLOOD = ("flood_step_kernel", "flood_step_rows_kernel", "flood_sdf_kernel",
         "sdf_from_seed_kernel")


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device:
        return None
    spans = trace.spans_named("sdf.request")
    if not spans:
        return None
    total = 0.0
    for s, e in spans:
        total += sum(k_e - k_s for name, k_s, k_e in trace.kernels_in(s, e)
                     if not any(f in name for f in FLOOD)
                     and not name.startswith(("Memcpy", "Memset")))
    return total / len(spans) * 1e-3
