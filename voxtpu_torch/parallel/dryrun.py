"""The port's multi-card gate: voxtpu's `dryrun_multichip`.

Port of `__graft_entry__.py:49-143` on `torch.distributed`: on a (d, z)
mesh over every rank (z the largest of 8, 4 and 2 that divides both the
rank count and the grid's 32, voxtpu's rule), one sharded training step
on each of the four engines (plain, cuda, fused at n = 32; seg at n =
256 with the mesh in a 48-voxel corner and voxtpu's ball target), then
`voxelize_sharded` and `jfa_sharded`; rank 0 prints voxtpu's line,
field for field (the engines are voxtpu's xla / pallas / fused / seg
under the port's names)::

    python -m voxtpu_torch.parallel.dryrun 4               # 4 ranks, one a card
    python -m voxtpu_torch.parallel.dryrun 2 --device cpu  # 2 gloo CPU processes

Two differences from voxtpu: the mesh is the port's procedural
icosphere (voxtpu reads its `sphere.obj` asset, `__graft_entry__.py:25`,
which the repository does not hold), and the command starts its N
ranks itself (each on its own card under NCCL, or as gloo processes on
the CPU), meeting through a file rendezvous in a temporary directory;
any rank's failure or the timeout fails it.
`dryrun_multichip` alone is what a rank runs inside a started process
group.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

N_GRID = 32
SEG_N = 256
SEG_CORNER = 48.0  # voxels the seg engine's mesh spans
ICOSPHERE_LEVEL = 3
TIMEOUT = 900.0
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def z_axis(n_devices: int, n_grid: int = N_GRID) -> int:
    """voxtpu's z rule: the largest of 8, 4 and 2 that divides both the
    device count and the grid, else 1."""
    return next((c for c in (8, 4, 2) if n_devices % c == 0 and n_grid % c == 0), 1)


def flagship_mesh():
    """The gate's mesh: the port's icosphere (voxtpu's sphere.obj is not
    in the repository)."""
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh

    coords, faces = procedural.icosphere(ICOSPHERE_LEVEL)
    return Mesh(name="icosphere", coords=coords, faces=faces, faces_normals=faces)


def seg_case(mesh):
    """voxtpu's seg case: a SEG_N^3 grid whose origin is the mesh's
    minimum corner and whose voxel makes the mesh SEG_CORNER voxels
    wide, and a ball of radius 0.35 x the mesh's extent about the middle
    of that corner as the target, (n, n, n) float32 NumPy."""
    from voxtpu_torch.grids.voxel_grid import GridSpec

    side, mins = np.ptp(mesh.coords, axis=0).max(), mesh.coords.min(axis=0)
    spec = GridSpec(n=SEG_N, origin=tuple(float(v) for v in mins),
                    voxel_size=float(side) / SEG_CORNER)
    ax = np.arange(SEG_N, dtype=np.float32) * spec.voxel_size
    ctr, rad = float(side) / 2.0, float(side) * 0.35
    target = (((ax[:, None, None] - ctr) ** 2 + (ax[None, :, None] - ctr) ** 2
               + (ax[None, None, :] - ctr) ** 2) < rad * rad).astype(np.float32)
    return spec, target


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """One sharded step of each engine, then the sharded voxelizer and
    JFA, on a mesh over the started process group's `n_devices` ranks
    (every rank calls it). Returns the losses (``plain``, ``cuda``,
    ``fused``, ``seg``), the global occupancy count ``occ``, the count
    of finite SDF voxels ``sdf_finite``, the mesh shape and voxtpu's
    ``line``; rank 0 prints the line. Raises on a non-finite loss."""
    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.ops.soft_vox import make_soft_plan
    from voxtpu_torch.ops.vox import voxelize
    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel.distributed import global_mesh
    from voxtpu_torch.parallel.mesh_utils import local_slab, mesh_device
    from voxtpu_torch.parallel.sharded_fit import make_sharded_fit
    from voxtpu_torch.parallel.sharded_jfa import jfa_sharded
    from voxtpu_torch.parallel.sharded_soft_fused import make_sharded_fit_fused
    from voxtpu_torch.parallel.sharded_soft_pallas import make_sharded_fit_pallas
    from voxtpu_torch.parallel.sharded_soft_seg import make_sharded_fit_seg
    from voxtpu_torch.parallel.sharded_vox import voxelize_sharded

    if n_devices != dist.get_world_size():
        raise ValueError(f"n_devices={n_devices}: the mesh spans the world of "
                         f"{dist.get_world_size()} ranks, one device each")
    dz = z_axis(n_devices)
    dd = n_devices // dz
    dmesh = global_mesh(("d", "z"), (dd, dz), device_type)
    dev = mesh_device(dmesh)
    tri_mesh = flagship_mesh()
    spec = GridSpec.fit(tri_mesh.coords, N_GRID)
    plan = make_soft_plan(tri_mesh, spec)
    target = voxelize(tri_mesh, spec, "plain", device=dev).to_dense().float()
    target_slab = local_slab(target, dmesh).contiguous()

    def one_step(init_fn, step_fn, slab, what):
        coords, opt_state = init_fn(tri_mesh.coords)
        _, _, loss = step_fn(coords, opt_state, slab)
        loss = float(loss)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite {what}-engine loss {loss}")
        return loss

    losses = {"plain": one_step(*make_sharded_fit(plan, dmesh, learning_rate=1e-3)[:2],
                                target_slab, "plain")}
    for name, make in (("cuda", make_sharded_fit_pallas), ("fused", make_sharded_fit_fused)):
        losses[name] = one_step(*make(plan, dmesh)[:2], target_slab, name)

    seg_spec, seg_target = seg_case(tri_mesh)
    seg_plan = make_soft_plan(tri_mesh, seg_spec)
    seg_slab = local_slab(torch.from_numpy(seg_target).to(dev), dmesh).contiguous()
    sinit, sstep, _, _ = make_sharded_fit_seg(seg_plan, tri_mesh.coords, dmesh)
    losses["seg"] = one_step(sinit, sstep, seg_slab, "seg")

    grid = voxelize_sharded(tri_mesh, spec, dmesh)
    sdf = jfa_sharded(grid.to_dense(), spec, dmesh)
    # Each d row holds the whole grid in z slabs: count over one row.
    zgroup = dmesh.get_group("z")
    occ = int(C.all_reduce(torch.tensor(grid.count(), device=dev), zgroup))
    finite = int(C.all_reduce(torch.isfinite(sdf).sum(), zgroup))
    line = (f"dryrun_multichip({n_devices}): mesh=({dd}x{dz}) loss={losses['plain']:.4f} "
            f"engines=plain/cuda/fused/seg seg_loss={losses['seg']:.4f} "
            f"occ={occ} sdf_finite={finite}")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return {**losses, "occ": occ, "sdf_finite": finite, "mesh": (dd, dz), "line": line}


def _rank_main(n: int, rank: int, device: str, directory: str) -> int:
    from voxtpu_torch.parallel.distributed import init_distributed, shutdown_distributed

    backend = "nccl" if device == "cuda" else "gloo"
    init_distributed(f"file://{directory}/rendezvous", n, rank, backend=backend)
    try:
        dryrun_multichip(n, device)
    finally:
        shutdown_distributed()
    return 0


def launch(n: int, device: str = "cuda", timeout: float = TIMEOUT) -> int:
    """Start `n` ranks of this module (one a card on CUDA, gloo CPU
    processes on the CPU), wait within `timeout` seconds; returns 0 when
    every rank exits 0. Rank 0 prints the gate's line."""
    if device == "cuda" and torch.cuda.device_count() < n:
        print(f"dryrun: {n} ranks need {n} CUDA cards; this host has "
              f"{torch.cuda.device_count()} (--device cpu runs gloo CPU ranks)",
              file=sys.stderr)
        return 2
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    env.pop("LOCAL_RANK", None)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_dryrun_") as tmp:
        procs = [subprocess.Popen([sys.executable, "-m", "voxtpu_torch.parallel.dryrun",
                                   str(n), "--device", device, "--rank", str(r),
                                   "--rendezvous", tmp], env=env)
                 for r in range(n)]
        t0 = time.monotonic()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            print(f"dryrun: timed out after {timeout} s", file=sys.stderr)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"dryrun: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m voxtpu_torch.parallel.dryrun",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.n_devices, args.rank, args.device, args.rendezvous)
    return launch(args.n_devices, args.device)


if __name__ == "__main__":
    sys.exit(main())
