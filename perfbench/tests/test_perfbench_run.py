"""Whole runs of each cell at a size the CPU holds (the harness's own
look for a card skipped), and the refusal to run without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from harness import manifest as manifest_mod
from harness import runner
from tiny import tiny

ROOT = manifest_mod.ROOT
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run_py(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run_py(ROOT)
    assert out.returncode == 2, out.stderr
    assert "{" not in out.stdout and "no CUDA card" in out.stderr


def test_a_run_in_a_directory_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_at_a_small_size(name, trace):
    manifest = manifest_mod.Manifest.load()
    cell = tiny(manifest.cell(name))
    result = runner.run(cell, manifest, seed=2**40 + 3, seconds=0.5, trace=bool(trace),
                        device=torch.device("cpu"), t0=time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    wanted = {m["name"] for m in manifest.metrics_for(name, bool(trace))}
    host = {m["name"] for m in manifest.metrics if m["source"] == "host_clock"}
    assert wanted & host <= set(result["metrics"]) <= wanted
    json.dumps(result, allow_nan=False)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT / 'perfbench')!r}, {str(ROOT)!r}, {os.path.dirname(__file__)!r}]
import torch
from harness import guard, manifest, runner
from tiny import tiny
m = manifest.Manifest.load()
for name in {CELLS!r}:
    runner.run(tiny(m.cell(name)), m, seed=5, seconds=0.2, trace=False,
               device=torch.device("cpu"), t0=time.perf_counter())
print(guard.forbidden_loaded(), 'voxtpu_torch' in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.cuda
def test_the_first_cell_runs_correct_on_the_card(card):
    """The first cell at its own size, a short window, on the card."""
    manifest = manifest_mod.Manifest.load()
    cell = manifest.cell(CELLS[0])
    result = runner.run(cell, manifest, seed=2**34 + 9, seconds=2.0, trace=False, device=card,
                        t0=time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
