"""One run of one cell: set-up, the measured window, the check, the
metrics and the result line.

Set-up (`setup_s`) runs from the process's start to the first timed
unit: the program's import and build, the inputs made from the seed,
and the warm-up of the cell's own shapes. The window then runs units for
`seconds` (each closed by a synchronize). Once it has closed, the peak
device memory is read, the program's state is let go, and the plain
reference checks what the timed path produced.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from harness import manifest as manifest_mod
from harness.record import Recorder, Trace, Tracer, breakdown


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    setup_s: float
    window_s: float
    units: list
    recorder: Recorder
    trace: Trace | None
    work: dict

    def spans(self, name: str):
        return self.recorder.spans_named(name)


def run(cell, manifest, *, seed: int, seconds: float, trace: bool, device, t0: float,
        control=None) -> dict:
    """Run `cell` once; `t0` is the process's start on `time.perf_counter`.
    `control`, a dtype, puts the plain reference computed in it in the
    program's place for the check (`perfbench/controls.py`)."""
    case = manifest_mod.generator(cell.traffic["op"]).Case(cell.config, cell.traffic, seed,
                                                          device)
    case.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    rec = Recorder()
    tracer = Tracer(trace, cell.traffic.get("trace_units", 1))
    setup_s = time.perf_counter() - t0
    case.window(seconds, rec, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    case.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = case.check(control=control)
    ctx = Context(setup_s=setup_s, window_s=rec.window_s, units=rec.units, recorder=rec,
                  trace=tracer.trace, work=case.work)
    metrics = {}
    for m in manifest.metrics_for(cell.name, trace):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = getattr(case, "compared", 0) > 0 and all(
        c["value"] <= c["limit"] for c in checks)
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(rec.units), "failed": 0,
              "metrics": metrics, "device": info}
    if trace and tracer.trace is not None:
        info["busy_s"] = tracer.trace.busy_us() * 1e-6
        info["window_s"] = tracer.trace.window_s
        result["breakdown"] = breakdown(tracer.trace)
    result["counters"] = dict(rec.counters, compared=getattr(case, "compared", 0))
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result
