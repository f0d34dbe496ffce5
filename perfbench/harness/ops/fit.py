"""Traffic of fit jobs: Adam steps of `VoxelFit` on the configuration's
mesh against its hard grid.

Set-up voxelizes the mesh (`BandedSlotVoxPipeline`) into the target and
draws the run's start from the seed (the mesh moved by ``shift_vox``
voxels plus N(0, ``jitter_vox``) voxels a coordinate). A job is
``steps_per_job`` steps (span ``fit.step`` each, closed by a
synchronize) from the start with a fresh Adam state (`fit.init`), the
drift checks and plan refreshes inside them. With ``new_plan_per_job``
each job is a user's fit: a plan and a `VoxelFit` of its own (span
``fit.plan``: `make_soft_plan` and `VoxelFit(plan, target,
learning_rate=lr_vox * voxel, ...)`) before its steps. Without it,
set-up builds that one fit and every job restarts it. Set-up runs one
whole job through the window's own call, which warms every shape. The
window ends at the first job boundary at or after its length, so that
it holds whole jobs of the same work. `trace_units` counts jobs.

Each job keeps, on the device, each step's loss, the first gradient's
norm as Adam holds it after one step, the coordinates at its end and
the steps at which it refreshed its plan. The check takes one job,
drawn from the seed among the window's, and follows it with the plain
reference from the same start, which rebuilds its plan at the same
steps: the loss of every step, the first gradient's norm, and the norm
of the coordinates' change over the job.
"""

from __future__ import annotations

import time

import torch

from harness import common, meshes, peaks
from harness.record import Recorder
from reference import soft as ref_soft
from reference import vox as ref_vox

BETA1 = 0.9


class Case:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.n = int(config["n"])
        self.work: dict = {}

    def setup(self) -> None:
        from voxtpu_torch.grids.voxel_grid import GridSpec
        from voxtpu_torch.mesh.mesh import Mesh
        from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

        t = self.traffic
        self.coords, self.faces = meshes.make_mesh(self.config["mesh"])
        mesh = Mesh(coords=self.coords, faces=self.faces, faces_normals=self.faces)
        self.spec = GridSpec.fit(self.coords, self.n)
        grid = BandedSlotVoxPipeline(mesh, self.spec, self.device,
                                     **self.config.get("vox", {}))()
        self.target_words = grid.words
        self.target = grid.to_dense().float()
        self.start = meshes.seeded_start(self.coords, common.rng(self.seed, 2),
                                         self.spec.voxel_size, t["shift_vox"], t["jitter_vox"])
        self.fit = None if t["new_plan_per_job"] else self._new_fit(Recorder())
        self.sample = common.Sample(self.seed, 1)
        self._job(Recorder())

    def _new_fit(self, rec):
        from voxtpu_torch.mesh.mesh import Mesh
        from voxtpu_torch.models.fit import VoxelFit
        from voxtpu_torch.ops.soft_vox import make_soft_plan

        t = self.traffic
        with rec.span("fit.plan"):
            plan = make_soft_plan(
                Mesh(coords=self.start, faces=self.faces, faces_normals=self.faces), self.spec)
            fit = VoxelFit(plan, self.target, learning_rate=t["lr_vox"] * self.spec.voxel_size,
                           tau_edge_frac=t["tau"][0], tau_x_frac=t["tau"][1],
                           refresh_every=t["refresh_every"],
                           drift_limit_frac=t["drift_limit_frac"], engine=t["engine"])
            common.sync(self.device)
        return fit

    def _job(self, rec, job: int = -1) -> dict:
        """One job; its steps' units go to `rec`, and what the check reads
        stays on the device."""
        fit = self.fit if self.fit is not None else self._new_fit(rec)
        state = fit.init(self.start)
        kept = {"losses": [], "refreshed": []}
        for s in range(int(self.traffic["steps_per_job"])):
            before = fit.refresh_count
            t0 = time.perf_counter()
            with rec.span("fit.step"):
                state, m = fit.step(state)
                common.sync(self.device)
            refreshed = fit.refresh_count > before
            rec.units.append({"s": time.perf_counter() - t0, "job": job, "step": s,
                              "refreshed": refreshed})
            kept["losses"].append(m["loss"])
            if s == 0:  # Adam's first moment after one step is (1 - b1) g
                kept["grad_norm"] = torch.linalg.vector_norm(
                    state.opt_state["exp_avg"]) / (1 - BETA1)
            if refreshed:
                kept["refreshed"].append(s + 1)
        kept["end"] = state.coords
        return kept

    def window(self, seconds: float, rec, tracer) -> None:
        tracer.start()
        t_start = time.perf_counter()
        job = 0
        while True:
            self.sample.offer((job, self._job(rec, job)))
            tracer.unit_done()
            job += 1
            if time.perf_counter() - t_start >= seconds:
                break
        rec.window_s = time.perf_counter() - t_start
        tracer.stop()
        rec.counters = {"jobs": job,
                        "refreshes_per_job": sum(u["refreshed"] for u in rec.units) / job}

    def release(self) -> None:
        self.fit = None
        self.target = None

    def check(self, control=None) -> list:
        """The sampled job against the plain reference's fit from the same
        start, with its plan rebuilt at the job's refreshes; `control`, a
        lower precision, puts the plain reference computed in it in the
        program's place. Records the soft pass's least time in `work`."""
        t = self.traffic
        n, dev = self.n, self.device
        origin, voxel = common.fit_grid(self.coords, n)
        faces = torch.from_numpy(self.faces).long().to(dev)
        dense = ref_vox.voxelize_dense(torch.from_numpy(self.coords).to(dev), faces, n,
                                       origin, voxel)
        target_bits = ref_vox.differing_voxels(self.target_words, ref_vox.pack(dense))
        target = dense.float()
        del dense
        start = torch.from_numpy(self.start).to(dev)
        tau = tuple(t["tau"])
        (_, job), = self.sample.kept
        kw = dict(steps=int(t["steps_per_job"]), lr=t["lr_vox"] * voxel, tau=tau,
                  replan_at=job["refreshed"])
        want = ref_soft.fit(start, faces, target, n, origin, voxel, **kw)
        if control is None:
            got = {"losses": [float(x) for x in job["losses"]],
                   "grad_norm": float(job["grad_norm"]),
                   "change_norm": float(torch.linalg.vector_norm(job["end"] - start))}
        else:
            got = ref_soft.fit(start, faces, target, n, origin, voxel, dtype=control, **kw)
        self.sample.kept = []
        checks = [
            ("target_bits", target_bits),
            ("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                                  want["losses"]))),
            ("grad_norm_gap", abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]),
            ("change_norm_gap",
             abs(got["change_norm"] - want["change_norm"]) / want["change_norm"]),
        ]
        self.work["soft_least_s"] = soft_least(start, faces, n, origin, voxel, tau)
        self.compared = 1
        return [{"name": k, "value": v, "limit": common.limit(t, k)} for k, v in checks]


def soft_least(coords, faces, n: int, origin, voxel: float, tau) -> float:
    """The least time of one soft forward and backward on a plan built
    from `coords`: its live fragments, the (fragment, column) pairs
    inside their transition windows, the occupancy written and its
    cotangent read, the coordinates read and their gradient written."""
    vs, tau_e, tau_x = ref_soft.temperatures(voxel, *tau)
    with torch.no_grad():
        windows = ref_soft.plan(coords, faces, n, origin, voxel)
        rows, w, xh = ref_soft.fragments(coords, faces, windows, n, origin, voxel, tau_e)
        live = rows < n * n
        ok = (w.abs() <= 1) & torch.isfinite(xh)
        u = (xh.double() - ref_soft.f32(origin[0])) / vs - 0.5
        r = tau_x / vs
        hi = torch.ceil(u - peaks.SAT_LO * r).clamp(0, n)
        lo = (torch.floor(u - peaks.SAT_HI * r) + 1).clamp(0, n)
        width = torch.where(ok, (hi - lo).clamp(min=0), torch.full_like(u, n))
        fragments, pairs = int(live.sum()), int(width[live].sum())
    flops, sfu = peaks.soft_ops(fragments, pairs)
    nbytes = 8 * n ** 3 + 24 * coords.shape[0]
    return peaks.least_seconds(nbytes, flops=flops, sfu=sfu)
