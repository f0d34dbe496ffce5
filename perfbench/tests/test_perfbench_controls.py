"""Each cell's control, and each fault its cell can have, come out as not
correct (`perfbench/controls.py`, at a size the CPU holds): a whole run
(the harness's look for a card skipped) with the timed path broken
underneath, or with the reference in bfloat16 in the program's place;
the sound program comes out as correct. Each is the one path that the
card's readings take: a whole run whose window holds one unit."""

from __future__ import annotations

import json
import time

import pytest
import torch

import controls
from harness import manifest as manifest_mod
from harness import runner
from tiny import tiny

CELLS = {w["name"]: w["traffic"] for w in json.loads(
    (manifest_mod.ROOT / "BENCHMARK.json").read_text())["workloads"]}
# The faults a cell can have: a fit step that returns its state
# unchanged, half of the grid left out of the loss, an answer altered
# where it is produced. One card: no exchange between cards to leave out.
FAULTS = {"new_mesh": ["altered"], "sdf": ["altered"],
          "fit_fused": ["unchanged", "half_batch"], "refine_fused": ["unchanged", "half_batch"]}
CASES = [(name, what) for name, traffic in CELLS.items()
         for what in ["program", "control", *FAULTS[traffic]]]


@pytest.mark.parametrize("name,what", CASES)
def test_controls_and_faults_fail_and_the_program_passes(name, what):
    manifest = manifest_mod.Manifest.load()
    out = controls.reading(tiny(manifest.cell(name)), manifest, 2**35 + 11, what,
                           torch.device("cpu"))
    assert out["correct"] == (what == "program"), out["checks"]


@pytest.mark.parametrize("name", list(CELLS))
def test_a_fault_in_the_window_alone_is_caught(name, monkeypatch):
    """What is compared is what the window produced: a fault planted only
    while the window runs, after a sound set-up, fails the run."""
    manifest = manifest_mod.Manifest.load()
    cell = tiny(manifest.cell(name))
    case = manifest_mod.generator(cell.traffic["op"]).Case
    window = case.window

    def broken(self, *args):
        with controls.planted(FAULTS[CELLS[name]][0]):
            window(self, *args)

    monkeypatch.setattr(case, "window", broken)
    result = runner.run(cell, manifest, seed=2**36 + 5, seconds=0.0, trace=False,
                        device=torch.device("cpu"), t0=time.perf_counter())
    assert result["correct"] is False, result["checks"]
