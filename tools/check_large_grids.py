#!/usr/bin/env python3
"""The banded pipeline at voxtpu's largest grids and face counts, on one CUDA card.

    python3 tools/check_large_grids.py                 # from the repository root
    python3 tools/check_large_grids.py --parts torus   # chosen parts

Each mesh goes through `chip_smoke.large_grid` (`chip_smoke.py`'s phase
4e checks, grids kept packed): `BandedSlotVoxPipeline.words()` (B1, B2
in place; overflow 0, the launches counted) against
`DeviceVoxPipeline.words()` (B12; xor popcount 0 and the same
`grid_digest`), and against a witness; B1, B2 and B12 timed (a single
call, a launch in a run, the bound), the per-call totals of both
pipelines (`utils/timing.py::time_device_fn`), the plan builds and the
peak device memory printed.

Parts:

- ``torus``: phase 6's rotated torus (`chip_smoke.rotated_torus`,
  1,348,128 faces, no face x-parallel) at 4096^3, against the plane
  oracle (`voxelize_ref_planes`) on 8 z-planes spread over the occupied
  ones; at voxtpu's band of 256 columns, then at NARROW_BAND. Its widest
  x window at 4096^3 (71 cells either side of the entry) fits a band of
  256, so there it has no wide candidate (printed, not required); at
  NARROW_BAND the windows wider than 16 cells either side (4,676 faces)
  go wide, and they are live (their faces cover cell centres): B2 fills
  live slots at 4096^3 (`num_wide` and the live wide slots must be
  nonzero).
- ``big``: a washer (phase 4's) and the torus, each brought to
  10,785,024 faces with `procedural.subdivide_to`, at 256^3 and 512^3,
  against the native library's grid (`voxtpu_torch/native`, bitwise the
  NumPy oracle in the CPU tests).

Prints the card's name and power limit first. Exits non-zero if a check
fails; a device out of memory is raised, not caught.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LARGE_N = 4096
BIG_FACES = 10_785_024   # ROADMAP A7's mesh: 8 x the smoke's 1,348,128
BIG_SIZES = (256, 512)
NARROW_BAND = 64         # the torus's band where its widest x windows go wide
PARTS = ("torus", "big")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def big_meshes():
    """A washer and the torus at BIG_FACES faces."""
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh

    c, f = procedural.washer(0.85, 1.0, 0.16, nu=64)
    c, f = procedural.subdivide_to(c, f, BIG_FACES)
    smoke.require(len(f) == BIG_FACES, "washer face count")
    return [Mesh(name="washer", coords=c, faces=f, faces_normals=f),
            smoke.rotated_torus(BIG_FACES)]


def native_words(mesh, spec) -> torch.Tensor:
    """The native library's grid of `mesh`, packed (on the host)."""
    from voxtpu_torch.grids.voxel_grid import pack_bits
    from voxtpu_torch.native import native_voxelize

    return pack_bits(torch.from_numpy(native_voxelize(mesh, spec)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_large_grids: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from voxtpu_torch import _build
    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.ops.vox_slots_banded import BAND

    built = _build.build()
    _build.library()
    print(f"built the kernels in {built.seconds:.2f} s", flush=True)
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    try:
        if "torus" in args.parts:
            torus = smoke.rotated_torus(smoke.MAIN_FACES)
            spec = GridSpec.fit(torus.coords, LARGE_N)
            res = smoke.large_grid(dev, torus, spec)
            print(f"torus at {LARGE_N}^3, band {BAND}: num_wide {res['num_wide']} (its x "
                  "windows fit the band)", flush=True)
            res = smoke.large_grid(dev, torus, spec, band=NARROW_BAND)
            smoke.require(res["num_wide"] > 0 and res["live_wide"] > 0,
                          f"the torus at {LARGE_N}^3, band {NARROW_BAND}: {res['num_wide']} "
                          f"wide candidates, {res['live_wide']} live wide slots")
            smoke.require(res["launches"]["B2"] == 1, "B2 did not launch on the torus")
            del torus
        if "big" in args.parts:
            t0 = time.perf_counter()
            meshes = big_meshes()
            print(f"{BIG_FACES:,}-face meshes built in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            for n in BIG_SIZES:
                for mesh in meshes:
                    smoke.large_grid(dev, mesh, GridSpec.fit(mesh.coords, n), planes=0,
                                     witness=native_words)
    except smoke.SmokeFailure as e:
        print(f"check_large_grids: FAILED: {e} ({card})", file=sys.stderr)
        return 1
    print(f"check_large_grids: every check passed in {time.perf_counter() - t_all:.1f} s "
          f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
