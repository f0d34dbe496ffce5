"""Sharded soft-voxelization training step on the fused engine (kernels
B7, B8).

Port of `voxtpu/parallel/sharded_soft_fused.py`: the structure of
`sharded_fit` with each rank's partial summed by B7 and its table
cotangents by B8 (`ops/soft_vox_fused.py`). voxtpu computes the
coefficient tables replicated, over every shard's padded layout at
once, and pads each shard to a common batch count with pad batches on
an `extra_tiles` dummy tile (`sharded_soft_fused.py:52-115`,
`voxtpu/ops/soft_vox_fused.py:390-402`). Each rank here builds its own
`FusedSoftPlan` on its triangle slice and computes its own tables
(`tables_of`), whose backward carries its triangles' share of the
coordinate gradient; the share is summed over the ranks before Adam.
voxtpu's ``mode`` (its MXU emulations) is TPU-only and not carried.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from voxtpu_torch.ops.soft_vox_fused import FusedSoftPlan, soft_voxelize_fused
from voxtpu_torch.parallel.mesh_utils import mesh_device
from voxtpu_torch.parallel.sharded_fit import rank_plan, sharded_trainer


def make_sharded_fit_fused(soft_plan, device_mesh: DeviceMesh,
                           learning_rate: float = 1e-2, tau_edge_frac: float = 0.25,
                           tau_x_frac: float = 0.5, tc: int = 128, tb_sub: int = 4,
                           tbl: int = 128):
    """(init_fn, step_fn, loss_fn) like `sharded_fit.make_sharded_fit`,
    each rank's partial through B7 / B8 (`sharded_soft_fused.py:117-216`).
    The rank's `FusedSoftPlan` is ``step_fn.plan``."""
    n = soft_plan.spec.n
    if n % device_mesh.shape[1] != 0:
        raise ValueError(f"N={n} must divide z axis {device_mesh.shape[1]}")
    plan = FusedSoftPlan(rank_plan(soft_plan, device_mesh), mesh_device(device_mesh),
                         tc=tc, tb_sub=tb_sub, tbl=tbl)
    return sharded_trainer(
        lambda c: soft_voxelize_fused(c, plan, tau_edge_frac=tau_edge_frac,
                                      tau_x_frac=tau_x_frac, clip=False),
        device_mesh, learning_rate, plan)
