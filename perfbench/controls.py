#!/usr/bin/env python3
"""The readings that set each compared number's limit, on the card at a
cell's own size; the benchmark's runs never run this.

    python3 perfbench/controls.py --workload torus1348k_512.refine \\
        --seeds 11,12,13 --what program,control,half_batch

For each seed it makes a whole run of the cell (`harness/runner.py`)
whose window holds one unit (a request or a job), and prints one JSON
line for each reading asked for:

- ``program``: the sound program against the plain reference (the
  lower readings);
- ``control``: the plain reference computed in bfloat16, the precision
  below the configuration's float32, put in the program's place;
- the faults, planted in the program underneath the timed path:
  ``unchanged`` (a fit step that returns its state unchanged),
  ``half_batch`` (the fit's loss taken over half of the grid's z-planes,
  the rest left out), ``altered`` (one answer altered where it is
  produced: a bit of a grid word, or a voxel of a field).

`perfbench/tests/test_perfbench_controls.py` runs the same at a size the
CPU holds and sees each control and fault come out as not correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import manifest as manifest_mod  # noqa: E402
from harness import runner  # noqa: E402

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted in it for the scope."""
    if fault is None:
        yield
        return
    from voxtpu_torch.models.fit import VoxelFit, soft_iou_loss
    from voxtpu_torch.ops import jfa as jfa_mod
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "unchanged":
        step = VoxelFit.step

        def unchanged(self, state):
            _, metrics = step(self, state)
            return state, metrics

        patch(VoxelFit, "step", unchanged)
    elif fault == "half_batch":
        init = VoxelFit.__init__

        def half(self, *args, **kwargs):
            init(self, *args, **kwargs)
            keep = self.plan.spec.n // 2
            self._loss_fn = lambda pred, target: soft_iou_loss(pred[:keep], target[:keep])

        patch(VoxelFit, "__init__", half)
    elif fault == "altered":
        words = BandedSlotVoxPipeline.words
        jfa = jfa_mod.jfa

        def altered_words(self):
            w, overflow = words(self)
            w.view(-1)[w.numel() // 2] ^= 1 << 7
            return w, overflow

        def altered_field(*args, **kwargs):
            field = jfa(*args, **kwargs)
            field.view(-1)[field.numel() // 2] += 1.0
            return field

        patch(BandedSlotVoxPipeline, "words", altered_words)
        patch(jfa_mod, "jfa", altered_field)
    else:
        raise ValueError(f"unknown fault {fault!r} (expected one of {FAULTS})")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def reading(cell, manifest, seed: int, what: str, device) -> dict:
    """A whole run of `cell` on one unit of its window (a request or a
    job) with `what` in the program's place: the compared numbers and
    whether the run came out correct."""
    control = torch.bfloat16 if what == "control" else None
    with planted(what if what in FAULTS else None):
        result = runner.run(cell, manifest, seed=seed, seconds=0.0, trace=False, device=device,
                            t0=time.perf_counter(), control=control)
    return {"workload": cell.name, "seed": seed, "what": what, "correct": result["correct"],
            "checks": {k: c["value"] for k, c in result["checks"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--what", default="program,control",
                   help="comma-separated: program, control, " + ", ".join(FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA card is available", file=sys.stderr)
        return 2
    manifest = manifest_mod.Manifest.load()
    cell = manifest.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in args.what.split(","):
            t0 = time.perf_counter()
            out = reading(cell, manifest, seed, what, torch.device("cuda", 0))
            out["s"] = round(time.perf_counter() - t0, 1)
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
