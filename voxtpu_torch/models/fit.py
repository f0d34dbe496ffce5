"""Vertex-position optimization against a target occupancy grid.

Port of `voxtpu/models/fit.py`: soft voxelization forward, a soft-IoU
loss against a target occupancy, and Adam on the mesh's vertex
coordinates. `torch.optim.Adam` takes optax's place; its per-parameter
state (``step``, ``exp_avg``, ``exp_avg_sq``) is optax's (count, mu,
nu), so `save_checkpoint` writes voxtpu's ``.npz`` layout and
`load_checkpoint` reads voxtpu's checkpoints.

Usage::

    plan = make_soft_plan(mesh, spec)
    fit = VoxelFit(plan, target_occ)          # target on the fit's device
    state = fit.init(mesh.coords)
    for _ in range(steps):
        state, metrics = fit.step(state)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from voxtpu_torch.ops.soft_vox import refresh_soft_plan, soft_voxelize
from voxtpu_torch.utils.trace import span

ENGINES = ("plain", "cuda", "fused", "seg")


def auto_engine(n: int, device) -> str:
    """The port's engine choice: on a CUDA device the seg engine for
    256 <= n <= 512 where its panels tile the grid (n % 128 == 0), else
    the fused engine; the plain engine on the CPU.

    It follows voxtpu's (`voxtpu/models/fit.py:108-123`) with two
    differences. voxtpu takes seg on a TPU for 256 <= n <= 512 and
    fused above 512, and its xla (plain) engine for n < 256 and on any
    other backend. Here a card takes fused for n < 256, because the
    fused kernels (B7/B8) run there; that choice is not measured on the
    card below 256. And seg also needs n % 128 == 0: the seg plan,
    here and in voxtpu (`voxtpu/ops/soft_vox_seg.py:606`), refuses
    other n, so voxtpu's choice raises there (n = 320 on a TPU)."""
    if torch.device(device).type != "cuda":
        return "plain"
    return "seg" if 256 <= n <= 512 and n % 128 == 0 else "fused"


def soft_iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU; robust to class imbalance in mostly-empty grids."""
    inter = torch.sum(pred * target)
    union = torch.sum(pred) + torch.sum(target) - inter
    return 1.0 - inter / (union + 1e-8)


def adam_state(coords: torch.Tensor) -> dict:
    """A fresh `torch.optim.Adam` state for one parameter."""
    return {"step": torch.tensor(0.0),
            "exp_avg": torch.zeros_like(coords),
            "exp_avg_sq": torch.zeros_like(coords)}


def adam_step(loss_fn: Callable, params: list, opt_states: list, lr: float,
              reduce_grad: Callable | None = None):
    """One Adam step on `params` from `opt_states` (one state dict each,
    left untouched): (new params, new states, {loss, grad_norm}), with
    the global L2 norm of the gradients. `reduce_grad`, where given,
    maps each gradient before the norm and the update (the sharded
    trainers sum it over their ranks)."""
    params = [p.detach().clone().requires_grad_(True) for p in params]
    opt = torch.optim.Adam(params, lr=lr)
    for p, st in zip(params, opt_states):
        opt.state[p] = {k: v.clone() for k, v in st.items()}
    loss = loss_fn(params)
    loss.backward()
    if reduce_grad is not None:
        for p in params:
            p.grad = reduce_grad(p.grad)
    grad_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
    opt.step()
    return ([p.detach() for p in params], [opt.state[p] for p in params],
            {"loss": loss.detach(), "grad_norm": grad_norm.detach()})


def max_drift_vox(coords: torch.Tensor, plan_coords: torch.Tensor,
                  voxel_size: float) -> torch.Tensor:
    return (coords - plan_coords).abs().max() / voxel_size


@dataclasses.dataclass
class FitState:
    coords: torch.Tensor   # (V, 3) float32
    opt_state: dict        # torch.optim.Adam state of `coords`
    step: int


class VoxelFit:
    """Adam-based vertex fitting of a template mesh to a target grid.

    Engines: ``"plain"`` (`ops/soft_vox.py`, torch ops), ``"cuda"``
    (`ops/soft_vox_cuda.py`, kernels B13), ``"fused"``
    (`ops/soft_vox_fused.py`, kernels B7/B8) and ``"seg"``
    (`ops/soft_vox_seg.py`, kernels B9-B11; n >= 256, n % 128 == 0) —
    voxtpu's ``xla``, ``pallas``, ``fused`` and ``seg``. ``"auto"``
    follows voxtpu's rule for a target on a CUDA device: ``"seg"`` for
    256 <= n <= 512 (n % 128 == 0), else ``"fused"``; ``"plain"`` on
    the CPU. Each engine runs on the target's device: its kernels on
    CUDA tensors, their plain versions on CPU tensors.

    Plan staleness guard: the soft plan's raster windows cover vertex
    motion up to its pad window. `step()` checks the drift every
    `refresh_every` steps (one scalar read from the device) and rebuilds
    the plan from the current coordinates when the largest displacement
    exceeds ``drift_limit_frac * pad_window`` voxels, or, for the seg
    engine, when an x_hit moved toward its panel's edge (`SegSoftPlan.
    xhit_drift_vox`, read on the host); ``refresh_every=0`` leaves
    refreshes to :meth:`maybe_refresh_plan`.
    """

    def __init__(self, plan, target_occ: torch.Tensor,
                 learning_rate: float = 1e-2, tau_edge_frac: float = 0.5,
                 tau_x_frac: float = 0.5, loss_fn: Callable = soft_iou_loss,
                 refresh_every: int = 8, drift_limit_frac: float = 0.5,
                 engine: str = "auto"):
        self.plan = plan
        self.target = torch.as_tensor(target_occ).float()
        self.device = self.target.device
        self.learning_rate = learning_rate
        self._tau = (tau_edge_frac, tau_x_frac)
        self._loss_fn = loss_fn
        if engine == "auto":
            engine = auto_engine(plan.spec.n, self.device)
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (expected one of "
                             f"{ENGINES + ('auto',)})")
        self.engine = engine
        self.refresh_every = refresh_every
        self.drift_limit_vox = drift_limit_frac * plan.pad_window
        self.refresh_count = 0
        self._steps_seen = 0
        self._plan_coords = torch.as_tensor(plan.plan_coords).to(self.device)
        self._rebuild_engine()

    def _rebuild_engine(self):
        te, tx = self._tau
        if self.engine == "plain":
            plan = self.plan
            self._fwd = lambda c: soft_voxelize(c, plan, tau_edge_frac=te,
                                                tau_x_frac=tx)
            self.engine_plan = None
            return
        with span("soft.engine_plan") as sp:
            if self.engine == "fused":
                from voxtpu_torch.ops.soft_vox_fused import (FusedSoftPlan,
                                                             soft_voxelize_fused)

                eplan = FusedSoftPlan(self.plan, self.device)
                self._fwd = lambda c: soft_voxelize_fused(
                    c, eplan, tau_edge_frac=te, tau_x_frac=tx)
            elif self.engine == "cuda":
                from voxtpu_torch.ops.soft_vox_cuda import (SoftCudaPlan,
                                                            soft_voxelize_cuda)

                eplan = SoftCudaPlan(self.plan, self.device)
                self._fwd = lambda c: soft_voxelize_cuda(
                    c, eplan, tau_edge_frac=te, tau_x_frac=tx)
            else:
                from voxtpu_torch.ops.soft_vox_seg import SegSoftPlan, soft_voxelize_seg

                eplan = SegSoftPlan(self.plan, self._plan_coords, self.device)
                self._fwd = lambda c: soft_voxelize_seg(
                    c, eplan, tau_edge_frac=te, tau_x_frac=tx)
            for key in ("fragments", "pairs"):
                if hasattr(eplan, "num_" + key):
                    sp.count(key, getattr(eplan, "num_" + key))
        self.engine_plan = eplan

    def _coords(self, coords) -> torch.Tensor:
        return torch.as_tensor(coords, dtype=torch.float32).to(self.device)

    def loss(self, coords) -> torch.Tensor:
        return self._loss_fn(self._fwd(self._coords(coords)), self.target)

    def forward(self, coords) -> torch.Tensor:
        """The soft occupancy through the plain engine, as voxtpu's
        `forward` uses its xla engine."""
        te, tx = self._tau
        return soft_voxelize(self._coords(coords), self.plan,
                             tau_edge_frac=te, tau_x_frac=tx)

    def drift_voxels(self, coords) -> torch.Tensor:
        """Max vertex displacement since the plan was built, in voxels."""
        return max_drift_vox(self._coords(coords), self._plan_coords,
                             self.plan.spec.voxel_size)

    def maybe_refresh_plan(self, state: FitState, force: bool = False) -> bool:
        """Rebuild the soft plan if the vertices drifted past the pad
        window, or, for engine="seg", if an x_hit drifted toward its
        panel's edge (or when forced); True if it was rebuilt."""
        if not force and float(self.drift_voxels(state.coords)) <= self.drift_limit_vox:
            if self.engine != "seg":
                return False
            from voxtpu_torch.ops.soft_vox_seg import MARGIN

            # No floor (`voxtpu/models/fit.py:199-206`): near the engine's
            # tau_x limit the slack reaches 0 and any x_hit drift refreshes.
            limit = max(MARGIN - 17.0 * self._tau[1] - 4.0, 0.0)
            if self.engine_plan.xhit_drift_vox(state.coords) <= limit:
                return False
        self.plan = refresh_soft_plan(self.plan, state.coords)
        self._plan_coords = self._coords(state.coords).clone()
        self.refresh_count += 1
        self._rebuild_engine()
        return True

    def init(self, coords) -> FitState:
        coords = self._coords(coords)
        return FitState(coords=coords, opt_state=adam_state(coords), step=0)

    def step(self, state: FitState):
        """One Adam step: (new state, {loss, grad_norm, max_drift_vox}),
        the metrics as 0-d tensors."""
        self._steps_seen += 1
        if self.refresh_every and self._steps_seen % self.refresh_every == 0:
            self.maybe_refresh_plan(state)
        (coords,), (opt_state,), metrics = adam_step(
            lambda p: self._loss_fn(self._fwd(p[0]), self.target),
            [state.coords], [state.opt_state], self.learning_rate)
        metrics["max_drift_vox"] = self.drift_voxels(coords)
        return FitState(coords=coords, opt_state=opt_state,
                        step=state.step + 1), metrics

    # -- checkpoint / resume, voxtpu's .npz layout ---------------------------

    def save_checkpoint(self, path, state: FitState) -> None:
        """(coords, Adam state, step, plan fingerprint) to one .npz:
        leaf_0 coords, leaf_1 count, leaf_2 mu, leaf_3 nu, leaf_4 step
        (voxtpu's `tree_leaves((coords, optax.adam state, step))`),
        plan_coords and bookkeeping (steps seen, refreshes). Loading it
        into a VoxelFit with the same settings resumes bit-identically."""
        st = state.opt_state

        def host(t):
            return t.detach().cpu().numpy()

        np.savez(path,
                 leaf_0=host(state.coords),
                 leaf_1=np.asarray(int(st["step"]), np.int32),
                 leaf_2=host(st["exp_avg"]),
                 leaf_3=host(st["exp_avg_sq"]),
                 leaf_4=np.asarray(state.step, np.int32),
                 plan_coords=host(self._plan_coords),
                 bookkeeping=np.asarray([self._steps_seen, self.refresh_count],
                                        np.int64))

    def load_checkpoint(self, path) -> FitState:
        """A FitState from a checkpoint of this port or of voxtpu. If it
        was taken under another plan, or the restored coordinates have
        drifted past this plan's coverage, the plan is refreshed."""
        from voxtpu_torch.interop import fit_state_from_voxtpu

        with np.load(path) as data:
            state = fit_state_from_voxtpu(
                *(data[f"leaf_{i}"] for i in range(5)), device=self.device)
            saved_pc = self._coords(data["plan_coords"])
            self._steps_seen, self.refresh_count = (
                int(x) for x in data["bookkeeping"])
        same_plan = (self._plan_coords.shape == saved_pc.shape
                     and bool(torch.equal(self._plan_coords, saved_pc)))
        if (not same_plan
                or float(self.drift_voxels(state.coords)) > self.drift_limit_vox):
            self.maybe_refresh_plan(state, force=True)
        return state
