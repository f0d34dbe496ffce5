"""Command-line pipeline: import -> voxelize -> CSG -> SDF -> export.

Port of `voxtpu/cli.py`, same flags and scope labels:

    python -m voxtpu_torch.cli mesh1.obj [mesh2.obj ...] -n 128 -t 2 -p 1 -e -s

==========  ======================================================
flag         meaning
==========  ======================================================
filenames    input meshes (positional or -i)
-n           voxels per side (default 32)
-t           backend 0=reference (NumPy oracle) 1=plain (voxtpu's xla:
             FragmentPlan + resolve, and the JFA flood's plain torch
             versions) 2=cuda (the banded voxelizer and the JFA flood
             on the hand-written kernels; default). 3 (native) is not
             ported yet.
-o           output filename (default out.obj)
-p           CSG op 0=void 1=union 2=intersection 3=difference
-e           export phase OBJs into --out-dir
-s           compute SDF (JFA) on the folded grid
-b           banded vox tile rows (TILE_CELLS; default 128)
-m           benchmark iterations (>1: only mesh[0] is voxelized each
             iteration and CSG-folded into a scratch grid)
--device     torch device (default cuda). `cpu` runs the kernels'
             plain torch versions; `cuda` without a CUDA device exits
             with an error, it never falls back to the CPU.
==========  ======================================================

Profiling scopes print ``[Label]: X ms`` lines (``CudaVox(mesh.obj)``,
``CudaVox::planning``, ``CudaVox::processing``, ``CudaCSG``,
``CudaJFA``; ``Plain*`` for -t 1, ``Ref*`` for -t 0). Exports are
named after the backend (``cuda_``, ``plain_``, ``reference_``).
voxtpu's ``--trace`` is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid

BACKENDS = {0: "reference", 1: "plain", 2: "cuda", 3: "native"}
PORTED = (0, 1, 2)
BACKEND_LABEL = {0: "RefVox", 1: "PlainVox", 2: "CudaVox"}
CSG_OPS = {0: "void", 1: "union", 2: "intersection", 3: "difference"}


class UsageError(Exception):
    """A request the CLI refuses (bad flags, unported backend, no device)."""


@dataclasses.dataclass
class PipelineResult:
    spec: GridSpec            # the shared grid
    grids: list[VoxelGrid]    # one per mesh; grids[0] is the folded grid
    sdf: torch.Tensor | None  # signed squared distances (with -s)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="voxtpu_torch",
        description="Mesh voxelization / CSG / SDF on PyTorch and CUDA")
    p.add_argument("filenames", nargs="*", help="input .obj meshes")
    p.add_argument("-i", dest="extra_filenames", action="append", default=[])
    p.add_argument("-n", "--num-voxels", type=int, default=32)
    p.add_argument("-t", "--type", type=int, default=2, choices=list(BACKENDS))
    p.add_argument("-o", "--output", default="out.obj")
    p.add_argument("-p", "--operation", type=int, default=0, choices=list(CSG_OPS))
    p.add_argument("-e", "--export", action="store_true")
    p.add_argument("-s", "--sdf", action="store_true")
    p.add_argument("-b", "--block-size", type=int, default=None,
                   help="banded vox tile rows (TILE_CELLS; multiple of 16, "
                        "must divide N^2; default 128)")
    p.add_argument("-m", "--benchmark", type=int, default=1,
                   help="iterations; >1 enables benchmark mode")
    p.add_argument("--out-dir", default="out")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    try:
        run(argv)
    except UsageError as e:
        print(f"voxtpu_torch: {e}", file=sys.stderr)
        return 1
    return 0


def run(argv=None) -> PipelineResult:
    """Parse `argv` and run the pipeline (what `main` does, returning
    the grids and the SDF instead of an exit code)."""
    args = build_parser().parse_args(argv)
    filenames = list(args.filenames) + list(args.extra_filenames)
    if not filenames:
        raise UsageError("Need [input file]")
    if args.block_size is not None and args.block_size % 16 != 0:
        raise UsageError("Thread per voxel must be a multiple of 16")
    if args.type not in PORTED:
        raise UsageError(f"-t {args.type} ({BACKENDS[args.type]}) is not "
                         "ported yet; use -t 0 (reference), -t 1 (plain) or "
                         "-t 2 (cuda)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise UsageError("--device cuda: no CUDA device is available "
                         "(--device cpu runs the plain torch versions)")
    if device.type not in ("cuda", "cpu"):
        raise UsageError(f"--device {args.device}: expected cuda or cpu")
    return _run_pipeline(args, filenames, device)


def _run_pipeline(args, filenames, device) -> PipelineResult:
    from voxtpu_torch.mesh.grid_to_mesh import (
        voxels_grid_to_mesh,
        voxels_grid_to_mesh_compressed,
        voxels_grid_to_point_cloud,
    )
    from voxtpu_torch.mesh.obj_io import export_mesh, import_mesh
    from voxtpu_torch.ops.csg import csg
    from voxtpu_torch.ops.jfa import jfa
    from voxtpu_torch.ops.vox import FragmentPlan, voxelize
    from voxtpu_torch.ops.vox_cuda import TILE_CELLS
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline
    from voxtpu_torch.utils.profiling import ProfilingScope

    backend = BACKENDS[args.type]
    vox_label = BACKEND_LABEL[args.type]
    op = CSG_OPS[args.operation]
    iterations = max(1, args.benchmark)
    benchmark = iterations > 1
    do_export = args.export and not benchmark

    meshes = [import_mesh(f) for f in filenames]

    # Shared grid fit over all meshes (`apps/cli/main.cpp:65-87`).
    all_coords = np.concatenate([m.coords for m in meshes], axis=0)
    spec = GridSpec.fit(all_coords, args.num_voxels)

    grids = [None] * len(meshes)
    bm_grid = VoxelGrid.zeros(spec, device)
    sdf = None

    # The plan (banded, or the plain route's triangle buckets) is
    # rebuilt every iteration inside the profiled scope, mirroring the
    # reference's per-call work-queue build (`vox/tiled.cu:504-547`).
    def _vox_profiled(mesh):
        if backend in ("cuda", "plain"):
            with ProfilingScope(f"{vox_label}::planning"):
                if backend == "cuda":
                    plan = BandedSlotVoxPipeline(mesh, spec, device,
                                                 tc=args.block_size or TILE_CELLS)
                else:
                    plan = FragmentPlan(mesh, spec, device)
            with ProfilingScope(f"{vox_label}::processing") as pp:
                grid = voxelize(mesh, spec, backend, device=device, plan=plan)
                pp.observe(grid.words)
            return grid
        return voxelize(mesh, spec, backend, device=device)

    def _export(name, mesh):
        export_mesh(os.path.join(args.out_dir, name), mesh)

    for _ in range(iterations):
        for i, mesh in enumerate(meshes):
            with ProfilingScope(f"{vox_label}({os.path.basename(mesh.name)})") as ps:
                grids[i] = _vox_profiled(mesh)
                ps.observe(grids[i].words)

            if do_export:
                occ = grids[i].to_dense().cpu().numpy()
                _export(f"{backend}_{os.path.basename(filenames[i])}",
                        voxels_grid_to_mesh_compressed(occ, spec))

            if (i > 0 or benchmark) and op != "void":
                other = grids[i] if not benchmark else bm_grid
                with ProfilingScope(vox_label.replace("Vox", "CSG")) as ps:
                    grids[0] = csg(grids[0], other, op)
                    ps.observe(grids[0].words)

            if benchmark:
                break

        if do_export and op != "void":
            occ = grids[0].to_dense().cpu().numpy()
            _export(f"csg_vox_{backend}_{args.output}",
                    voxels_grid_to_mesh_compressed(occ, spec))

        if args.sdf:
            with ProfilingScope(vox_label.replace("Vox", "JFA")) as ps:
                sdf = jfa(grids[0], spec, backend=backend)
                ps.observe(sdf)

            if do_export:
                occ = grids[0].to_dense().cpu().numpy()
                sdf_np = sdf.cpu().numpy()
                _export(f"sdf_{backend}_{args.output}",
                        voxels_grid_to_mesh(occ, sdf_np, spec))
                _export(f"sdf_point_cloud_{backend}_{args.output}",
                        voxels_grid_to_point_cloud(occ, sdf_np, spec))

    return PipelineResult(spec=spec, grids=grids, sdf=sdf)


if __name__ == "__main__":
    sys.exit(main())
