"""Sharded soft-voxelization training step on the seg engine (kernels
B9, B10, B11).

Port of `voxtpu/parallel/sharded_soft_seg.py`: the structure of
`sharded_fit` with each rank's partial through B9 and B10 and its table
cotangents through B11 (`ops/soft_vox_seg.py`). A `SegSoftPlan` places
its panels from host-evaluated x-hits, so the maker takes the
coordinates the plans are built against, and each plan's
`xhit_drift_vox` is its refresh guard, as for `VoxelFit(engine="seg")`.
The split is by triangle, so a rank's panels cover only the (tile,
panel) runs its own triangles touch.

voxtpu pads every shard's layout to a common batch count with pad
batches on an `extra_tiles` dummy tile row (`sharded_soft_seg.py:47-119`,
`voxtpu/ops/soft_vox_seg.py:300-310`); each rank here builds its own
`SegSoftPlan` on its triangle slice and runs the single-device
kernels at its own shapes.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from voxtpu_torch.ops.soft_vox_seg import MARGIN, SegSoftPlan, soft_voxelize_seg
from voxtpu_torch.parallel.mesh_utils import mesh_device
from voxtpu_torch.parallel.sharded_fit import rank_plan, sharded_trainer


def make_sharded_fit_seg(soft_plan, coords0, device_mesh: DeviceMesh,
                         learning_rate: float = 1e-2, tau_edge_frac: float = 0.25,
                         tau_x_frac: float = 0.5, tc: int = 128, tb_sub: int = 4,
                         tbl: int = 128, tz: int = 8):
    """(init_fn, step_fn, loss_fn, plans) like
    `sharded_soft_fused.make_sharded_fit_fused`, each rank's partial
    through B9-B11 (`sharded_soft_seg.py:121-228`). `coords0` are the
    coordinates the panels are placed from; `plans` holds this rank's
    `SegSoftPlan` (voxtpu's holds every shard's: a rank here builds only
    its own), whose `xhit_drift_vox` guards refreshes."""
    if tau_x_frac * 17.0 > MARGIN:
        raise ValueError(
            f"tau_x_frac={tau_x_frac} too wide for the segmented engine "
            f"(needs tau_x_frac <= {MARGIN / 17.0:.2f}); use "
            f"make_sharded_fit_fused for wider profiles")
    n = soft_plan.spec.n
    if n % device_mesh.shape[1] != 0:
        raise ValueError(f"N={n} must divide z axis {device_mesh.shape[1]}")
    plan = SegSoftPlan(rank_plan(soft_plan, device_mesh), coords0, mesh_device(device_mesh),
                       tc=tc, tb_sub=tb_sub, tbl=tbl, tz=tz)
    fns = sharded_trainer(
        lambda c: soft_voxelize_seg(c, plan, tau_edge_frac=tau_edge_frac,
                                    tau_x_frac=tau_x_frac, clip=False),
        device_mesh, learning_rate, plan)
    return (*fns, [plan])
