"""Vertex optimization through CSG compositions — gradients through booleans.

Port of `voxtpu/models/csg_fit.py`. Each part mesh is soft-voxelized
with the plain engine (differentiable in its vertex coordinates, as in
voxtpu), the parts are folded with soft CSG (min / max: the gradient
flows through the active branch) and a loss on the composed occupancy
is descended with Adam in every part's vertices at once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from voxtpu_torch.models.fit import (adam_state, adam_step, max_drift_vox,
                                     soft_iou_loss)
from voxtpu_torch.ops.csg import soft_csg
from voxtpu_torch.ops.soft_vox import refresh_soft_plan, soft_voxelize


@dataclasses.dataclass
class CSGPart:
    """One operand of the composition: a soft plan and its op into the fold."""

    plan: object               # FragmentPlan from make_soft_plan
    op: str = "union"          # op folding this part into the running grid


def compose(coords_list: Sequence[torch.Tensor], parts: Sequence[CSGPart],
            tau_edge_frac: float = 0.5, tau_x_frac: float = 0.5) -> torch.Tensor:
    """Soft-voxelize every part and fold them left to right with soft
    CSG (the reference CLI's fold order, `apps/cli/main.cpp:126-186`)."""
    if len(coords_list) != len(parts):
        raise ValueError(
            f"{len(coords_list)} coordinate arrays for {len(parts)} parts")
    occ = soft_voxelize(coords_list[0], parts[0].plan,
                        tau_edge_frac=tau_edge_frac, tau_x_frac=tau_x_frac)
    for coords, part in zip(coords_list[1:], parts[1:]):
        o = soft_voxelize(coords, part.plan, tau_edge_frac=tau_edge_frac,
                          tau_x_frac=tau_x_frac)
        occ = soft_csg(occ, o, part.op)
    return occ


class CSGFit:
    """Adam fitting of several meshes so that their CSG composition
    matches a target occupancy grid (on the target's device).

    Plan staleness guard as in `VoxelFit`: every `refresh_every` steps,
    each part whose vertices drifted past its pad window gets its plan
    rebuilt; ``refresh_every=0`` leaves that to
    :meth:`maybe_refresh_plans`.
    """

    def __init__(self, parts: Sequence[CSGPart], target_occ: torch.Tensor,
                 learning_rate: float = 1e-2, loss_fn: Callable = soft_iou_loss,
                 tau_edge_frac: float = 0.5, tau_x_frac: float = 0.5,
                 refresh_every: int = 8, drift_limit_frac: float = 0.5):
        self.parts = list(parts)
        self.target = torch.as_tensor(target_occ).float()
        self.device = self.target.device
        self.learning_rate = learning_rate
        self._loss_fn = loss_fn
        self._tau = (tau_edge_frac, tau_x_frac)
        self.refresh_every = refresh_every
        self.refresh_count = 0
        self._steps_seen = 0
        self._drift_limits = [drift_limit_frac * p.plan.pad_window
                              for p in self.parts]
        self._plan_coords = [torch.as_tensor(p.plan.plan_coords).to(self.device)
                             for p in self.parts]

    def _coords(self, coords_list):
        if len(coords_list) != len(self.parts):
            raise ValueError(f"{len(coords_list)} coordinate arrays for "
                             f"{len(self.parts)} parts")
        return [torch.as_tensor(c, dtype=torch.float32).to(self.device)
                for c in coords_list]

    def loss(self, coords_list) -> torch.Tensor:
        te, tx = self._tau
        occ = compose(self._coords(coords_list), self.parts,
                      tau_edge_frac=te, tau_x_frac=tx)
        return self._loss_fn(occ, self.target)

    def maybe_refresh_plans(self, coords_list) -> int:
        """Rebuild every part plan whose vertices drifted past its pad
        window; returns the number of plans rebuilt."""
        refreshed = 0
        for i, part in enumerate(self.parts):
            drift = max_drift_vox(coords_list[i], self._plan_coords[i],
                                  part.plan.spec.voxel_size)
            if float(drift) > self._drift_limits[i]:
                part.plan = refresh_soft_plan(part.plan, coords_list[i])
                self._plan_coords[i] = coords_list[i].detach().clone()
                refreshed += 1
        self.refresh_count += refreshed
        return refreshed

    def init(self, coords_list: Sequence):
        coords_list = self._coords(coords_list)
        return coords_list, [adam_state(c) for c in coords_list]

    def step(self, coords_list, opt_state):
        """One Adam step: (coords_list, opt_state, {loss, grad_norm})."""
        self._steps_seen += 1
        if self.refresh_every and self._steps_seen % self.refresh_every == 0:
            self.maybe_refresh_plans(coords_list)
        return adam_step(self.loss, list(coords_list), opt_state,
                         self.learning_rate)
