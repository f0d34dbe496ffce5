"""The port's `dryrun_multichip` (voxtpu's multi-chip gate,
`__graft_entry__.py:49-143`) in a gloo world of 2 CPU processes
(`tests/torch_parallel_worker.py`): its line's occupancy count and
finite SDF count equal the single-device port's on the same mesh, and
each engine's loss is finite and within the sharded-fit tests' 1e-5
relative of the single-device engine's on the same plan."""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from tests.torch_parallel_worker import World
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.models.fit import soft_iou_loss
from voxtpu_torch.ops.jfa import jfa
from voxtpu_torch.ops.soft_vox import make_soft_plan, soft_voxelize
from voxtpu_torch.ops.soft_vox_cuda import SoftCudaPlan, soft_voxelize_cuda
from voxtpu_torch.ops.soft_vox_fused import FusedSoftPlan, soft_voxelize_fused
from voxtpu_torch.ops.soft_vox_seg import SegSoftPlan, soft_voxelize_seg
from voxtpu_torch.ops.vox import voxelize
from voxtpu_torch.parallel import dryrun as D

LOSS_RTOL = 1e-5  # tests/test_torch_sharded_fit.py's


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return World("dryrun", 2, None, tmp_path_factory.mktemp("dryrun")).results()


@pytest.fixture(scope="module")
def single():
    """The same gate's quantities on one device: each engine's loss at
    the start coordinates on the whole plan, the occupancy count and the
    finite SDF count."""
    mesh = D.flagship_mesh()
    spec = GridSpec.fit(mesh.coords, D.N_GRID)
    plan = make_soft_plan(mesh, spec)
    grid = voxelize(mesh, spec, "plain", device="cpu")
    target = grid.to_dense().float()
    x = torch.from_numpy(mesh.coords)
    occ = {"plain": soft_voxelize(x, plan),
           "cuda": soft_voxelize_cuda(x, SoftCudaPlan(plan, "cpu")),
           "fused": soft_voxelize_fused(x, FusedSoftPlan(plan, "cpu"))}
    out = {k: float(soft_iou_loss(v, target)) for k, v in occ.items()}
    seg_spec, seg_target = D.seg_case(mesh)
    seg_plan = SegSoftPlan(make_soft_plan(mesh, seg_spec), mesh.coords, "cpu")
    out["seg"] = float(soft_iou_loss(soft_voxelize_seg(x, seg_plan),
                                     torch.from_numpy(seg_target)))
    out["occ"] = grid.count()
    out["sdf_finite"] = int(torch.isfinite(jfa(grid, spec, backend="plain")).sum())
    return out


def test_z_axis_is_voxtpus_rule():
    assert [D.z_axis(n) for n in (1, 2, 3, 4, 6, 8, 16)] == [1, 2, 1, 4, 2, 8, 8]


def test_dryrun_line_is_the_single_devices(world2, single):
    for r in world2:
        assert r["mesh"] == (1, 2)
        assert r["occ"] == single["occ"] > 0
        assert r["sdf_finite"] == single["sdf_finite"] == D.N_GRID ** 3
        assert r["line"] == world2[0]["line"]
    line = world2[0]["line"]
    assert line.startswith("dryrun_multichip(2): mesh=(1x2) loss=")
    assert f"occ={single['occ']} sdf_finite={single['sdf_finite']}" in line


@pytest.mark.parametrize("engine", ["plain", "cuda", "fused", "seg"])
def test_dryrun_losses_are_the_single_devices(world2, single, engine):
    for r in world2:
        assert np.isfinite(r[engine])
        assert r[engine] == world2[0][engine]
    assert abs(world2[0][engine] - single[engine]) <= LOSS_RTOL * single[engine], (
        world2[0][engine], single[engine])
