"""The plain references against the port's plain versions and the NumPy
oracle at sizes the CPU holds (the references themselves import nothing
of the port; this test does, to hold them to it)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from harness import common, meshes
from reference import jfa as ref_jfa
from reference import soft as ref_soft
from reference import vox as ref_vox

WASHER = dict(shape="washer", inner=0.85, outer=1.0, height=0.16, nu=64, faces=20000)
TORUS = dict(shape="torus", major=1.0, minor=0.35, nu=48, nv=24, faces=9216,
             rotate=[0.3, 0.5, 0.7])


def _moved(spec, seed):
    c, f = meshes.make_mesh(spec)
    return meshes.rigid_motion(c, common.rng(seed, 1), 5.0, 0.01), f


@pytest.mark.parametrize("shape,n,seed", [(WASHER, 64, 1), (WASHER, 96, 2), (TORUS, 64, 3)])
def test_vox_equals_the_oracle_and_the_banded_pipeline(shape, n, seed):
    from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.ops.reference import voxelize_ref
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

    c, f = _moved(shape, seed)
    spec = GridSpec.fit(c, n)
    origin, voxel = common.fit_grid(c, n)
    assert (origin, voxel) == (spec.origin, spec.voxel_size)
    got = ref_vox.voxelize(torch.from_numpy(c), torch.from_numpy(f), n, origin, voxel)
    mesh = Mesh(coords=c, faces=f, faces_normals=f)
    want = pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))
    assert ref_vox.popcount(want) > 0
    assert ref_vox.differing_voxels(got, want) == 0
    band = BandedSlotVoxPipeline(mesh, spec, "cpu", band=64).words()[0]
    assert ref_vox.differing_voxels(got, band) == 0


@pytest.mark.parametrize("n", [32, 64])
def test_jfa_equals_the_oracle_and_the_port(n):
    from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid
    from voxtpu_torch.ops.jfa import jfa
    from voxtpu_torch.ops.reference import jfa_ref

    c, f = meshes.make_mesh(WASHER)
    twin = (c + np.array([0.9, 0.0, 0.05])).astype(np.float32)
    spec = GridSpec.fit(np.concatenate([c, twin]), n)
    occ = torch.zeros((n, n, n), dtype=torch.bool)
    for coords in (c, twin):
        occ |= ref_vox.voxelize_dense(torch.from_numpy(coords), torch.from_numpy(f), n,
                                      spec.origin, spec.voxel_size)
    got, work = ref_jfa.sdf(occ, spec.origin, spec.voxel_size)
    assert len(work) == int(np.log2(n))
    assert ref_jfa.differing_values(got, torch.from_numpy(jfa_ref(occ.numpy(), spec))) == 0
    port = jfa(VoxelGrid.from_dense(occ, spec), backend="plain")
    assert ref_jfa.differing_values(got, port) == 0


def test_soft_fit_follows_the_port_plain_engine():
    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.models.fit import VoxelFit
    from voxtpu_torch.ops.soft_vox import make_soft_plan

    n = 64
    c, f = meshes.make_mesh(TORUS)
    spec = GridSpec.fit(c, n)
    faces = torch.from_numpy(f).long()
    target = ref_vox.voxelize_dense(torch.from_numpy(c), faces, n, spec.origin,
                                    spec.voxel_size).float()
    start = meshes.seeded_start(c, common.rng(5, 2, 0), spec.voxel_size, [0.5, 0, 0], 0.1)
    lr = 0.25 * spec.voxel_size
    fit = VoxelFit(make_soft_plan(Mesh(coords=start, faces=f, faces_normals=f), spec),
                   target, learning_rate=lr, engine="plain")
    state = fit.init(start)
    losses = []
    for i in range(3):
        state, m = fit.step(state)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = float(torch.linalg.vector_norm(state.opt_state["exp_avg"])) / 0.1
    want = ref_soft.fit(torch.from_numpy(start), faces, target, n, spec.origin,
                        spec.voxel_size, steps=3, lr=lr)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    assert abs(grad - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    change = float(torch.linalg.vector_norm(state.coords - torch.from_numpy(start)))
    assert abs(change - want["change_norm"]) <= 1e-4 * want["change_norm"]
    with torch.no_grad():
        assert abs(float(fit.loss(start)) - want["losses"][0]) <= 1e-5


def test_soft_plan_windows_match_the_port_plan():
    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.ops.soft_vox import make_soft_plan

    n = 64
    c, f = _moved(TORUS, 7)
    spec = GridSpec.fit(c, n)
    plan = make_soft_plan(Mesh(coords=c, faces=f, faces_normals=f), spec)
    sy, sz, w = ref_soft.plan(torch.from_numpy(c), torch.from_numpy(f).long(), n,
                              spec.origin, spec.voxel_size)
    for size, _, _, _, by, bz, idx in plan.buckets:
        real = by < n  # pad rows start at n
        rows = torch.from_numpy(idx[real].astype(np.int64))
        assert bool((w[rows] == size).all())
        assert bool((sy[rows] == torch.from_numpy(by[real].astype(np.int64))).all())
        assert bool((sz[rows] == torch.from_numpy(bz[real].astype(np.int64))).all())
