#!/usr/bin/env python3
"""Flood-step cost attribution on one CUDA card (P1).

    python3 tools/probe_jfa_micro.py      # from the repository root

The port's runner of the probe kernel (`voxtpu_torch/ops/jfa_probe.py`,
`csrc/jfa_probe.cu`), after voxtpu's `scripts/probe_jfa_micro.py`. It
times ONE flood step at a fixed (n, k) across variants that isolate
each part of its cost:

  legacy   B3, the production step (baseline)
  hoist    B3 with the address work out of the candidate loop
  hoistv   hoist with validity folded into one +inf select on d2
  rolls    the 26 candidate reads alone, fold = integer min
  alu      the 26 distance folds alone, on the voxel's own column

`hoist` and `hoistv` must be bitwise equal to `legacy` (checked on the
card before timing). Seeds: the boundary of a ball of radius 0.3 n
(`jfa_init_seed`), most voxels empty. Times are CUDA events: one
warm-up call, then `repeats` runs of `iters` back-to-back calls, the
median per call.

Env: JFA_MICRO_N (512), JFA_MICRO_K (comma list, default "4,128"),
JFA_MICRO_ITERS (5).
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxtpu_torch.grids.voxel_grid import GridSpec  # noqa: E402
from voxtpu_torch.ops.jfa import jfa_init_seed  # noqa: E402
from voxtpu_torch.ops.jfa_cuda import org_tensor  # noqa: E402
from voxtpu_torch.ops.jfa_probe import VARIANTS, flood_probe  # noqa: E402


def shell_seeds(n: int, dev):
    """(seed, org): ball-shell seeds on an n^3 grid of the unit cube."""
    ax = torch.arange(n, dtype=torch.float32, device=dev) - n / 2
    r2 = ax.view(-1, 1, 1) ** 2 + ax.view(1, -1, 1) ** 2 + ax.view(1, 1, -1) ** 2
    spec = GridSpec(n=n, origin=(0.0, 0.0, 0.0), voxel_size=1.0 / n)
    return jfa_init_seed(r2 <= (0.3 * n) ** 2), org_tensor(spec, dev)


def time_ms(fn, iters: int, repeats: int = 3) -> float:
    """Median per-call device time of fn() in ms (CUDA events)."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def probe(n: int, ks, iters: int, dev) -> dict:
    """{k: {variant: ms}} of one flood step on ball-shell seeds; raises
    AssertionError if hoist or hoistv differs from legacy."""
    seed, org = shell_seeds(n, dev)
    out = {}
    for k in ks:
        ref = flood_probe(seed, org, k, "legacy")
        out[k] = {}
        for variant in VARIANTS:
            if variant in ("hoist", "hoistv"):
                diff = int((flood_probe(seed, org, k, variant) != ref).sum())
                assert diff == 0, f"{variant} k={k}: {diff} mismatches"
            out[k][variant] = time_ms(lambda v=variant: flood_probe(seed, org, k, v),
                                      iters)
            print(f"n={n} k={k:4d} {variant:7s}: {out[k][variant]:8.3f} ms", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_jfa_micro: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    n = int(os.environ.get("JFA_MICRO_N", "512"))
    ks = [int(s) for s in os.environ.get("JFA_MICRO_K", "4,128").split(",")]
    iters = int(os.environ.get("JFA_MICRO_ITERS", "5"))
    probe(n, ks, iters, torch.device("cuda", 0))
    print("probe_jfa_micro done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
