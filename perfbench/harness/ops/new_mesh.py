"""Traffic of new meshes: each request voxelizes a mesh the system has
not seen, as the CLI's per-mesh vox does without the file I/O.

A request is `GridSpec.fit(coords, n)`, `BandedSlotVoxPipeline(...)`
(the host plan, span ``vox.plan``), then `.words()` and a synchronize
(span ``vox.call``). The meshes are the configuration's mesh under
rigid motions drawn from the seed, made at set-up; requests cycle
through them. One client waits for each grid (a closed loop).

Traffic keys: ``distinct`` meshes, ``max_deg`` and ``max_shift_vox``
of the motion, ``warm`` requests at set-up, ``compare`` requests sampled
for the check, ``trace_units``, ``limits.vox_bits``.
"""

from __future__ import annotations

import time

import torch

from harness import common, meshes
from harness.record import Recorder
from reference import vox as ref_vox


class Case:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.n = int(config["n"])
        self.work: dict = {}

    def setup(self) -> None:
        from voxtpu_torch.mesh.mesh import Mesh

        coords, faces = meshes.make_mesh(self.config["mesh"])
        _, voxel = common.fit_grid(coords, self.n)
        draws = common.rng(self.seed, 1)
        t = self.traffic
        self.coords = [meshes.rigid_motion(coords, draws, t["max_deg"],
                                           t["max_shift_vox"] * voxel)
                       for _ in range(int(t["distinct"]))]
        self.faces = faces
        self.meshes = [Mesh(name=f"request{i}", coords=c, faces=faces, faces_normals=faces)
                       for i, c in enumerate(self.coords)]
        self.sample = common.Sample(self.seed, int(t["compare"]))
        for i in range(int(t["warm"])):
            self._request(i, Recorder())

    def _request(self, i: int, rec):
        from voxtpu_torch.grids.voxel_grid import GridSpec
        from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

        k = i % len(self.meshes)
        vox = self.config.get("vox", {})
        t0 = time.perf_counter()
        with rec.span("vox.plan"):
            spec = GridSpec.fit(self.meshes[k].coords, self.n)
            pipe = BandedSlotVoxPipeline(self.meshes[k], spec, self.device, **vox)
        with rec.span("vox.call"):
            words, _ = pipe.words()
            common.sync(self.device)
        return words, {"s": time.perf_counter() - t0, "input": k,
                       "candidates": pipe.num_candidates, "slots": pipe.num_slots,
                       "batches": pipe.num_batches, "wide": pipe.num_wide}

    def window(self, seconds: float, rec, tracer) -> None:
        common.request_window(seconds, rec, tracer, self._request, self.sample)
        rec.counters = {k: sum(u[k] for u in rec.units) / len(rec.units)
                        for k in ("candidates", "slots", "batches", "wide")}

    def release(self) -> None:
        self.meshes = None

    def check(self, control=None) -> list:
        """The sampled requests' grids against the plain voxelizer's at the
        same sizes; `control`, a lower precision, puts the plain voxelizer
        computed in it in the program's place."""
        worst = 0
        faces = torch.from_numpy(self.faces).to(self.device)
        for k, words in self.sample.kept:
            coords = torch.from_numpy(self.coords[k]).to(self.device)
            origin, voxel = common.fit_grid(self.coords[k], self.n)
            want = ref_vox.voxelize(coords, faces, self.n, origin, voxel)
            if control is not None:
                words = ref_vox.voxelize(coords, faces, self.n, origin, voxel, dtype=control)
            worst = max(worst, ref_vox.differing_voxels(words, want))
            del want
        self.compared = len(self.sample.kept)
        return [{"name": "vox_bits", "value": worst,
                 "limit": common.limit(self.traffic, "vox_bits")}]

