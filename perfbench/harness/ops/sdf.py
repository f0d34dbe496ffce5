"""Traffic of SDF requests on grids made once: the serving plan is
bypassed, so the JFA's seed init and its kernels do the work.

Set-up voxelizes the configuration's mesh and its twin on one grid
fitted over both (as the CLI does: `GridSpec.fit`, one
`BandedSlotVoxPipeline` a mesh) and folds their union with `csg`.
Requests cycle through the three grids (mesh, twin, union); each is
`jfa(grid, spec, backend="cuda")` and a synchronize (span
``sdf.request``), its latency the host's wall time around both. One
client waits for each field (a closed loop).

Traffic keys: ``warm`` requests at set-up, ``compare`` requests sampled
for the check, ``trace_units``, ``limits.grid_bits`` and
``limits.sdf_values``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import common, meshes, peaks
from harness.record import Recorder
from reference import jfa as ref_jfa
from reference import vox as ref_vox

class Case:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.n = int(config["n"])
        self.work: dict = {}

    def setup(self) -> None:
        from voxtpu_torch.grids.voxel_grid import GridSpec
        from voxtpu_torch.mesh.mesh import Mesh
        from voxtpu_torch.ops.csg import csg
        from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

        coords, faces = meshes.make_mesh(self.config["mesh"])
        twin = (coords + np.asarray(self.config["twin"]["shift"], np.float64)).astype(np.float32)
        self.coords, self.faces = (coords, twin), faces
        self.spec = GridSpec.fit(np.concatenate(self.coords), self.n)
        vox = self.config.get("vox", {})
        grids = [BandedSlotVoxPipeline(Mesh(coords=c, faces=faces, faces_normals=faces),
                                       self.spec, self.device, **vox)() for c in self.coords]
        grids.append(csg(grids[0], grids[1], "union"))
        self.grids = grids
        self.sample = common.Sample(self.seed, int(self.traffic["compare"]))
        held = [self._request(i, Recorder())[0]
                for i in range(max(int(self.traffic["warm"]), self.sample.size + 1))]
        del held

    def _request(self, i: int, rec):
        from voxtpu_torch.ops.jfa import jfa

        grid = self.grids[i % len(self.grids)]
        t0 = time.perf_counter()
        with rec.span("sdf.request"):
            field = jfa(grid, self.spec, backend="cuda")
            common.sync(self.device)
        return field, {"s": time.perf_counter() - t0, "input": i % len(self.grids)}

    def window(self, seconds: float, rec, tracer) -> None:
        common.request_window(seconds, rec, tracer, self._request, self.sample)

    def release(self) -> None:
        """Nothing to free: the grids and the sampled fields are what the
        check reads."""

    def check(self, control=None) -> list:
        """The three grids against the plain voxelizer's, and the sampled
        requests' fields against the plain JFA of the plain grids at the
        same size; `control`, a lower precision, puts the plain JFA
        computed in it in the program's place. Records each grid's least
        flood time in `work`."""
        n = self.n
        origin, voxel = common.fit_grid(np.concatenate(self.coords), n)
        faces = torch.from_numpy(self.faces).to(self.device)
        dense = [ref_vox.voxelize_dense(torch.from_numpy(c).to(self.device), faces, n, origin,
                                        voxel) for c in self.coords]
        dense.append(dense[0] | dense[1])
        grid_bits = max(ref_vox.differing_voxels(g.words, ref_vox.pack(d))
                        for g, d in zip(self.grids, dense))
        fields, least, lower = {}, {}, {}
        for g in range(len(dense)):
            fields[g], steps = ref_jfa.sdf(dense[g], origin, voxel)
            unfused = cmp = 0
            for seeded, pairs, candidates in steps:
                u, c = peaks.flood_ops(seeded, pairs, candidates, n)
                unfused, cmp = unfused + u, cmp + c
            least[g] = peaks.least_seconds(n ** 3 // 8 + 4 * n ** 3, unfused=unfused, cmp=cmp)
        self.work["jfa_least_s"] = least
        worst = 0
        for g, field in self.sample.kept:
            if control is not None:
                if g not in lower:
                    lower[g] = ref_jfa.sdf(dense[g], origin, voxel, dtype=control)[0]
                field = lower[g]
            worst = max(worst, ref_jfa.differing_values(field, fields[g]))
        self.compared = len(self.sample.kept)
        return [{"name": "grid_bits", "value": grid_bits,
                 "limit": common.limit(self.traffic, "grid_bits")},
                {"name": "sdf_values", "value": worst,
                 "limit": common.limit(self.traffic, "sdf_values")}]

