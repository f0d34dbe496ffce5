#!/usr/bin/env python3
"""Where the time of one VoxelFit step goes, on one CUDA card.

    python3 tools/profile_train_step.py [fused] [seg]   # from the repository root

The training path of `chip_smoke.py` (phase 6): a torus brought to
1,348,128 faces and rotated, its hard grid at 512^3 as the target, the
start shifted by half a voxel along x plus 0.1 voxel of jitter,
`make_soft_plan(pad_window=2)`, `VoxelFit(engine=...)` with Adam at a
quarter of a voxel, for each engine named (default: fused, then seg).
Prints the card's name, power limit and clocks; per engine the host
time of its plan build (`FusedSoftPlan` or `SegSoftPlan`); the wall
time of 5 warm steps (host clock around a synchronize); the peak device
memory of a step; a `torch.profiler` table of one step; and the
device's busy time and idle share of that step's wall time.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TRAIN_LR_VOX, rotated_torus  # noqa: E402
from tools.profile_main_path import busy_us  # noqa: E402
from voxtpu_torch.grids.voxel_grid import GridSpec  # noqa: E402
from voxtpu_torch.mesh.mesh import Mesh  # noqa: E402
from voxtpu_torch.models.fit import VoxelFit  # noqa: E402
from voxtpu_torch.ops.soft_vox import make_soft_plan  # noqa: E402
from voxtpu_torch.ops.vox import voxelize  # noqa: E402

N = 512
FACES = 1_348_128


def main(engines) -> int:
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    mesh = rotated_torus(FACES)
    spec = GridSpec.fit(mesh.coords, N)
    vs = spec.voxel_size
    rng = np.random.default_rng(0)
    start = (mesh.coords + np.float32([0.5 * vs, 0.0, 0.0])
             + rng.normal(0, 0.1 * vs, mesh.coords.shape)).astype(np.float32)
    target = voxelize(mesh, spec, "cuda", device=dev).to_dense().float()

    t0 = time.perf_counter()
    plan = make_soft_plan(Mesh(name="start", coords=start, faces=mesh.faces,
                               faces_normals=mesh.faces), spec, pad_window=2)
    print(f"host plan: make_soft_plan {time.perf_counter() - t0:.3f} s; "
          f"{len(mesh.coords)} vertices")
    for engine in engines:
        profile_engine(engine, plan, target, start, vs)
        torch.cuda.empty_cache()
    return 0


def profile_engine(engine: str, plan, target, start, vs) -> None:
    t0 = time.perf_counter()
    fit = VoxelFit(plan, target, learning_rate=TRAIN_LR_VOX * vs, engine=engine,
                   refresh_every=0)
    ep = fit.engine_plan
    print(f"\n== engine {engine}: {type(ep).__name__} {time.perf_counter() - t0:.3f} s "
          f"(with its device copies); {ep.num_fragments} slots in {ep.num_batches} "
          f"batches, {ep.num_pairs} table rows")
    state = fit.init(start)

    def step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = fit.step(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    first = step()  # the first torch.optim step also imports torch._dynamo
    step()
    walls = [step() for _ in range(5)]
    print(f"first step {first:.3f} ms; warm steps wall ms: {[round(w, 3) for w in walls]}"
          f", median {sorted(walls)[2]:.3f}")

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = step()
    print(f"peak device memory of a step GiB {torch.cuda.max_memory_allocated() / 2**30:.3f}")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=30))
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(events) / 1e3
    print(f"device events {len(events)}; profiled step wall {wall:.3f} ms; device busy "
          f"{busy:.3f} ms; idle share of wall {1 - busy / wall:.4f}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["fused", "seg"]))
