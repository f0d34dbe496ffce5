"""Worlds of gloo ranks on the CPU for the sharded-path tests.

Not a test module: the tests start a world with `World`, each rank
a process running this file (``python -m tests.torch_parallel_worker
JOB RANK WORLD DIR``), which imports only torch, numpy and
voxtpu_torch. The ranks meet through a file rendezvous in DIR (no
port, so parallel test workers cannot collide), read the job's cases
from ``DIR/cases.pkl`` and write their results to ``DIR/out{rank}.pkl``.
Each world has a timeout of its own, so a hung rendezvous fails its
tests and does not hold up the run.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240.0


class World:
    """A started world: `results()` waits for its ranks and returns
    each rank's output (raising with the ranks' logs on a failure or a
    timeout)."""

    def __init__(self, job: str, size: int, cases, directory: Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        with open(self.directory / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        env.pop("LOCAL_RANK", None)
        self.logs = [open(self.directory / f"log{r}.txt", "w") for r in range(size)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", job, str(r), str(size),
             str(self.directory)], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]
        self.started = time.monotonic()
        self._results = None

    def results(self) -> list:
        if self._results is not None:
            return self._results
        try:
            for p in self.procs:
                left = WORLD_TIMEOUT - (time.monotonic() - self.started)
                p.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            logs = "\n".join(f"--- rank {r} (exit {c}):\n"
                             + (self.directory / f"log{r}.txt").read_text()[-3000:]
                             for r, c in enumerate(codes))
            raise AssertionError(f"world failed or timed out after {WORLD_TIMEOUT} s:\n{logs}")
        out = []
        for r in range(len(self.procs)):
            with open(self.directory / f"out{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        self._results = out
        return out


# ---------------------------------------------------------------------------
# The ranks' jobs (run in the worker processes)
# ---------------------------------------------------------------------------


def _mesh(shape):
    from voxtpu_torch.parallel.distributed import global_mesh

    return global_mesh(("d", "z"), tuple(shape), device_type="cpu")


def job_bootstrap(rank, world, directory, cases):
    import torch

    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel import distributed as D
    from voxtpu_torch.parallel.mesh_utils import grid_sharding, make_mesh

    again = D.init_distributed(f"file://{directory}/rendezvous2", world, rank,
                               backend="gloo")
    mesh = make_mesh(device_type="cpu")
    local = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4) + 100 * rank
    dt = D.global_from_local(local, mesh, grid_sharding(mesh))
    refused = None
    try:
        make_mesh(n_devices=world + 1, device_type="cpu")
    except ValueError as e:
        refused = str(e)
    # voxtpu's transposes: the reduce-scatter's backward all-gathers the
    # cotangent, the replicated sum's is the identity.
    x = (torch.arange(4.0 * world) + 10 * rank).requires_grad_(True)
    w = torch.arange(4.0) + rank
    total = C.SumReplicated.apply((C.ReduceScatter.apply(x, mesh.get_group("z")) * w).sum(),
                                  mesh.get_group("z"))
    total.backward()
    return {"again": again, "mesh_shape": tuple(mesh.shape), "global_shape": tuple(dt.shape),
            "local": local.numpy(), "pairs": D.local_from_global(dt), "refused": refused,
            "total": float(total), "x_grad": x.grad.numpy(), "staged": C.staged_bytes()}


def job_vox(rank, world, directory, cases):
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.parallel.sharded_vox import voxelize_sharded

    out = {}
    for shape in cases["shapes"]:
        mesh = _mesh(shape)
        for key, (coords, faces, spec) in cases["meshes"].items():
            m = Mesh(name=key, coords=coords, faces=faces, faces_normals=faces)
            for exchange in ("ring", "gather"):
                grid = voxelize_sharded(m, GridSpec(*spec), mesh, exchange=exchange)
                out[key, tuple(shape), exchange] = grid.words.numpy()
    return out


def job_jfa(rank, world, directory, cases):
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.parallel.mesh_utils import local_slab
    from voxtpu_torch.parallel.sharded_jfa import jfa_sharded

    out = {}
    for shape in cases["shapes"]:
        mesh = _mesh(shape)
        for key, (occ, spec) in cases["grids"].items():
            slab = local_slab(torch.from_numpy(occ), mesh).contiguous()
            for encoding in ("packed", "wide"):
                out[key, tuple(shape), encoding] = jfa_sharded(
                    slab, GridSpec(*spec), mesh, encoding=encoding).numpy()
            for name, budget in cases.get("budgets", {}).items():
                out[key, tuple(shape), "wide", name] = jfa_sharded(
                    slab, GridSpec(*spec), mesh, encoding="wide", budget=budget).numpy()
    return out


def _engine(name, soft_plan, coords, mesh):
    from voxtpu_torch.parallel.sharded_fit import make_sharded_fit
    from voxtpu_torch.parallel.sharded_soft_fused import make_sharded_fit_fused
    from voxtpu_torch.parallel.sharded_soft_pallas import make_sharded_fit_pallas
    from voxtpu_torch.parallel.sharded_soft_seg import make_sharded_fit_seg

    if name == "seg":
        return make_sharded_fit_seg(soft_plan, coords, mesh, learning_rate=1e-3)[:3]
    make = {"plain": make_sharded_fit, "cuda": make_sharded_fit_pallas,
            "fused": make_sharded_fit_fused}[name]
    return make(soft_plan, mesh, learning_rate=1e-3)


def job_fit(rank, world, directory, cases):
    """Per case and engine: the loss and coordinate gradient at the
    start, then (unless ``step`` is False) one Adam step: its loss, the
    loss after it, the new coordinates and Adam state. A case's
    ``state`` (coords, count, mu, nu), voxtpu's, replaces `init_fn`'s."""
    import torch

    from voxtpu_torch import interop
    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.ops.soft_vox import make_soft_plan
    from voxtpu_torch.parallel.mesh_utils import local_slab
    from voxtpu_torch.parallel.sharded_fit import value_and_grad

    out = {}
    for case in cases:
        mesh = _mesh(case["shape"])
        m = Mesh(name="case", coords=case["coords"], faces=case["faces"],
                 faces_normals=case["faces"])
        plan = make_soft_plan(m, GridSpec(*case["spec"]), pad_window=case["pad"])
        target = local_slab(torch.from_numpy(case["target"]), mesh).contiguous()
        start = torch.from_numpy(case["start"])
        for name in case["engines"]:
            init_fn, step_fn, loss_fn = _engine(name, plan, start, mesh)
            coords, opt_state = init_fn(start)
            if "state" in case:
                coords, opt_state = interop.sharded_fit_state_from_voxtpu(
                    *case["state"], device="cpu")
            loss, grad = value_and_grad(loss_fn, coords, target, mesh)
            res = {"loss": float(loss), "grad": grad.numpy()}
            if case.get("step", True):
                coords, opt_state, loss0 = step_fn(coords, opt_state, target)
                with torch.no_grad():
                    loss1 = loss_fn(coords, target)
                res.update(step_loss=float(loss0), loss_after=float(loss1),
                           coords=coords.numpy(), count=float(opt_state["step"]),
                           mu=opt_state["exp_avg"].numpy(), nu=opt_state["exp_avg_sq"].numpy())
            out[name, tuple(case["shape"]), case.get("tag")] = res
    return out


def job_dryrun(rank, world, directory, cases):
    """The port's `dryrun_multichip` over the world (gloo, CPU)."""
    from voxtpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(world, device_type="cpu")


JOBS = {"bootstrap": job_bootstrap, "vox": job_vox, "jfa": job_jfa, "fit": job_fit,
        "dryrun": job_dryrun}


def main(job: str, rank: int, world: int, directory: str) -> None:
    from voxtpu_torch.parallel.distributed import init_distributed, shutdown_distributed

    import torch

    torch.set_num_threads(1)
    init_distributed(f"file://{directory}/rendezvous", world, rank, backend="gloo")
    try:
        with open(Path(directory) / "cases.pkl", "rb") as f:
            cases = pickle.load(f)
        result = JOBS[job](rank, world, directory, cases)
        with open(Path(directory) / f"out{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
