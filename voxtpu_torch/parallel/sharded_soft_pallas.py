"""Sharded soft-voxelization training step on the per-fragment engine
(kernels B13).

Port of `voxtpu/parallel/sharded_soft_pallas.py`: the structure of
`sharded_fit` (triangle shards -> partial occupancy -> reduce-scatter
into Z slabs -> soft IoU -> the coordinate gradient summed over the
ranks), with each rank's partial summed by B13 (`ops/soft_vox_cuda.py`:
`vt_fragment_fwd`, and `vt_fragment_bwd` in the backward). These are
voxtpu's sharded B13 sites (`sharded_soft_pallas.py:91`, `:127`).

voxtpu's `shard_map` traces one program for every shard, so it pads
each shard's layout to a common batch count, sends the pad batches to a
masked dummy tile (`num_tiles + 1` output tiles) and pads the rank
arrays of its sort-based permutation (`build_sharded_layouts`,
`sharded_soft_pallas.py:173-251`). Each rank here builds its own
`SoftCudaPlan` on its triangle slice (`sharded_fit.ShardPlan`) and
launches B13 at its own shapes: no pad batch, no dummy tile, and the
kernels and wrappers are the single-device engine's.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from voxtpu_torch.ops.soft_vox_cuda import SoftCudaPlan, soft_voxelize_cuda
from voxtpu_torch.parallel.mesh_utils import mesh_device
from voxtpu_torch.parallel.sharded_fit import rank_plan, sharded_trainer


def make_sharded_fit_pallas(soft_plan, device_mesh: DeviceMesh,
                            learning_rate: float = 1e-2, tau_edge_frac: float = 0.25,
                            tau_x_frac: float = 0.5, tc: int = 128, tb_sub: int = 4):
    """(init_fn, step_fn, loss_fn) like `sharded_fit.make_sharded_fit`,
    each rank's partial through B13 (`sharded_soft_pallas.py:254-348`).
    The rank's `SoftCudaPlan` is ``step_fn.plan``."""
    n = soft_plan.spec.n
    if n % device_mesh.shape[1] != 0:
        raise ValueError(f"N={n} must divide z axis {device_mesh.shape[1]}")
    plan = SoftCudaPlan(rank_plan(soft_plan, device_mesh), mesh_device(device_mesh),
                        tc=tc, tb_sub=tb_sub)
    return sharded_trainer(
        lambda c: soft_voxelize_cuda(c, plan, tau_edge_frac=tau_edge_frac,
                                     tau_x_frac=tau_x_frac, clip=False),
        device_mesh, learning_rate, plan)
