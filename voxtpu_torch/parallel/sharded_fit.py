"""Sharded differentiable voxelization: the training step over a (d, z)
mesh of ranks.

Port of `voxtpu/parallel/sharded_fit.py` on the plain engine
(`ops/soft_vox.py`), and the structure the three kernel engines share
(`sharded_soft_pallas`, `sharded_soft_fused`, `sharded_soft_seg`):

- Triangles: `_split_soft_buckets` gives every rank an equal padded
  slice of each bucket's rows; a rank builds its own plan on its slice
  (`ShardPlan`) and sums its triangles' soft occupancy over the whole
  grid (a partial).
- Grid: `ReduceScatter` over "z" sums the partials into Z slabs, then
  `SumReplicated` over "d" finishes the triangle sum; the soft IoU is
  summed per slab and over "z" (`sharded_iou_loss`), so every rank
  holds the same loss.
- Backward: the reduce-scatter's transpose is an all-gather over "z";
  the replicated sums take the identity. Every rank then holds its own
  triangles' share of the coordinate gradient, and one all-reduce over
  the world sums them (`value_and_grad`) before Adam, so the
  coordinates stay equal on every rank.

voxtpu pads every shard's kernel layout to a common batch count because
`shard_map` traces one program for all shards; here each rank runs its
own shapes, so no layout is padded and no output has a dummy tile.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from voxtpu_torch.models.fit import adam_state, adam_step
from voxtpu_torch.ops.soft_vox import clip01, soft_voxelize
from voxtpu_torch.parallel import collectives as C
from voxtpu_torch.parallel.mesh_utils import mesh_device, world_group


def _split_soft_buckets(plan, n_shards: int):
    """Every bucket's (window, start_y, start_z, face_index) rows in
    n_shards equal slices, stacked on a leading shard axis
    (`sharded_fit.py:30-56`): [(window, syp, szp, fip)], each (n_shards,
    per). Pad rows start at n (no cell of the grid: weight 0)."""
    out = []
    n = plan.spec.n
    for bucket in plan.buckets:
        window, sy, sz, fi = bucket[0], *(np.asarray(bucket[i]) for i in (4, 5, 6))
        per = -(-sy.shape[0] // n_shards)
        pad_to = per * n_shards

        def pad(a, fill):
            if a.shape[0] == pad_to:
                return a
            return np.concatenate([a, np.full((pad_to - a.shape[0],), fill, a.dtype)])

        out.append((window, pad(sy, n).reshape(n_shards, per),
                    pad(sz, n).reshape(n_shards, per), pad(fi, 0).reshape(n_shards, per)))
    return out


class ShardPlan:
    """One shard's soft plan: the soft plan's spec and faces with the
    shard's bucket rows `rows`, [(window, start_y, start_z, face_index)]
    (voxtpu's `_ShardBuckets`, `sharded_soft_pallas.py:164-170`), and
    their candidate count, which `SoftCudaPlan` reads too. Every engine
    plan takes it where it takes a soft plan."""

    def __init__(self, soft_plan, rows):
        self.spec = soft_plan.spec
        self.faces_array = soft_plan.faces_array
        self.buckets = [(window, None, None, None, np.asarray(sy), np.asarray(sz),
                         np.asarray(fi)) for window, sy, sz, fi in rows]
        self.num_fragments = sum(b[4].shape[0] * b[0] ** 2 for b in self.buckets)


def rank_plan(soft_plan, device_mesh: DeviceMesh) -> ShardPlan:
    """This rank's shard of `soft_plan` (the shard index is the rank)."""
    rank = device_mesh.get_rank()
    return ShardPlan(soft_plan, [(window, syp[rank], szp[rank], fip[rank]) for
                                 window, syp, szp, fip in
                                 _split_soft_buckets(soft_plan, device_mesh.size())])


def sharded_iou_loss(partial: torch.Tensor, target_slab: torch.Tensor,
                     device_mesh: DeviceMesh) -> torch.Tensor:
    """1 - soft IoU of the summed partial occupancies against the target,
    on every rank (`sharded_fit.py:103-115`): `partial` is this rank's
    unclipped (n, n, n) sum, `target_slab` its (n / dz, n, n) Z slab."""
    slab = C.ReduceScatter.apply(partial, device_mesh.get_group("z"))
    slab = clip01(C.SumReplicated.apply(slab, device_mesh.get_group("d")))
    inter = torch.sum(slab * target_slab)
    tot = torch.sum(slab) + torch.sum(target_slab)
    inter, tot = C.SumReplicated.apply(torch.stack([inter, tot]),
                                       device_mesh.get_group("z")).unbind()
    return 1.0 - inter / (tot - inter + 1e-8)


def reduce_grad(grad: torch.Tensor, device_mesh: DeviceMesh) -> torch.Tensor:
    """The coordinate gradient summed over every rank (each holds its
    own triangles' share)."""
    return C.all_reduce(grad, world_group(device_mesh))


def value_and_grad(loss_fn: Callable, coords: torch.Tensor, target_slab: torch.Tensor,
                   device_mesh: DeviceMesh):
    """(loss, coordinate gradient) of a sharded `loss_fn`, the gradient
    summed over the world: the same on every rank."""
    leaf = coords.detach().clone().requires_grad_(True)
    loss = loss_fn(leaf, target_slab)
    loss.backward()
    return loss.detach(), reduce_grad(leaf.grad, device_mesh)


def sharded_trainer(occupancy: Callable, device_mesh: DeviceMesh,
                    learning_rate: float, plan):
    """(init_fn, step_fn, loss_fn) around `occupancy(coords)`, this rank's
    unclipped partial occupancy through its engine plan `plan` (kept as
    ``step_fn.plan``):

    - ``init_fn(coords) -> (coords, opt_state)`` on the rank's device;
    - ``step_fn(coords, opt_state, target_slab) -> (coords, opt_state,
      loss)``, one Adam step (`models/fit.py::adam_step`);
    - ``loss_fn(coords, target_slab) -> loss``, differentiable."""
    device = mesh_device(device_mesh)

    def loss_fn(coords, target_slab):
        return sharded_iou_loss(occupancy(coords), target_slab, device_mesh)

    def step_fn(coords, opt_state, target_slab):
        (coords,), (opt_state,), m = adam_step(
            lambda p: loss_fn(p[0], target_slab), [coords], [opt_state], learning_rate,
            reduce_grad=lambda g: reduce_grad(g, device_mesh))
        return coords, opt_state, m["loss"]

    step_fn.plan = plan

    def init_fn(coords):
        coords = torch.as_tensor(coords, dtype=torch.float32).to(device)
        return coords, adam_state(coords)

    return init_fn, step_fn, loss_fn


def make_sharded_fit(plan, device_mesh: DeviceMesh, learning_rate: float = 1e-2,
                     tau_edge_frac: float = 0.25, tau_x_frac: float = 0.5):
    """(init_fn, step_fn, loss_fn) for vertex fitting on a mesh of ranks,
    the plain engine on each (`sharded_fit.py:59-146`). `target_slab`
    is this rank's Z slab of the target (`mesh_utils.local_slab`); the
    rank's `ShardPlan` is ``step_fn.plan``."""
    n = plan.spec.n
    dz = device_mesh.shape[1]
    if n % dz != 0:
        raise ValueError(f"N={n} must divide z axis {dz}")
    shard = rank_plan(plan, device_mesh)
    return sharded_trainer(
        lambda c: soft_voxelize(c, shard, tau_edge_frac=tau_edge_frac,
                                tau_x_frac=tau_x_frac, clip=False),
        device_mesh, learning_rate, shard)

