"""State carried across from voxtpu, through NumPy only.

The port never imports jax. These conversions take NumPy arrays (what
`np.asarray` makes of voxtpu's device arrays) and build the port's
tensors, so that the tests can run the port's per-call path on exactly
voxtpu's slot layout, and compare the plans the port builds itself
against voxtpu's.

- packed words: voxtpu's ``uint32`` <-> the port's ``int32``,
  bit-identical (a `view`, no arithmetic);
- the banded pipeline's per-call state: the nine slot coordinate rows,
  `local`, `batch_tile`, `batch_basew` and the `wide` tuple of
  `voxtpu.ops.vox_slots_banded.BandedSlotVoxPipeline`;
- the word-event plan's event panels (`voxtpu.ops.vox_pallas_we.
  WordEventVoxPlan`), the suffix route's batches (`voxtpu.ops.
  vox_pallas.PallasVoxPlan`) and the work-queue plan's lanes and runs
  (`voxtpu.ops.vox_pallas_wq.WorkQueueVoxPlan`);
- the wide JFA's (hi, lo) seed state (`voxtpu.ops.jfa.
  jfa_init_seed_wide`, `_flood_step_seed_wide`);
- the soft engines' slot layouts (`voxtpu.ops.soft_vox_fused.
  FusedSoftPlan`, `voxtpu.ops.soft_vox_pallas.SoftPallasPlan`,
  `voxtpu.ops.soft_vox_seg.SegSoftPlan`);
- a `VoxelFit` state: coordinates, optax's Adam (count, mu, nu) and the
  step, the leaves of voxtpu's checkpoints;
- the sharded paths' shard splits (`voxtpu.parallel.sharded_vox.
  _split_buckets`, `voxtpu.parallel.sharded_fit._split_soft_buckets`)
  and a sharded fit's (coords, opt_state).
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.models.fit import FitState
from voxtpu_torch.ops.soft_vox_cuda import SoftCudaPlan
from voxtpu_torch.ops.soft_vox_fused import FusedSoftPlan
from voxtpu_torch.ops.soft_vox_seg import SegSoftPlan
from voxtpu_torch.ops.vox_slots_banded import BandedState
from voxtpu_torch.ops.vox_cuda import PallasVoxPlan
from voxtpu_torch.ops.vox_word_event import WordEventVoxPlan
from voxtpu_torch.ops.vox_work_queue import WorkQueueVoxPlan
from voxtpu_torch.parallel.sharded_fit import ShardPlan


def words_to_torch(words: np.ndarray, *, device) -> torch.Tensor:
    """uint32 words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(words)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32 words, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 words with the same bits."""
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {words.dtype}")
    return words.detach().cpu().numpy().view(np.uint32)


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32)).to(device)  # a copy


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def banded_state(rows, local, batch_tile, batch_basew, wide, *,
                 device) -> BandedState:
    """The port's banded per-call state from voxtpu's pipeline arrays.

    `rows` are its nine (B, tb_sub, 128) float32 arrays, `local`,
    `batch_tile`, `batch_basew` its int32 arrays, and `wide` None or its
    7-tuple (w_rows, w_local, w_rtile, w_ctile, w_flags, w_xseg,
    w_uidx). The flags and x-segment ids drive voxtpu's sequential TPU
    grid and have no counterpart in the port."""
    port_wide = None
    if wide is not None:
        w_rows, w_local, w_rtile, w_ctile, _flags, _xseg, w_uidx = wide
        port_wide = (tuple(_f32(r, device) for r in w_rows),
                     _i32(w_local, device), _i32(w_rtile, device),
                     _i32(w_ctile, device), _i32(w_uidx, device))
    return BandedState(rows=tuple(_f32(r, device) for r in rows),
                       local=_i32(local, device),
                       batch_tile=_i32(batch_tile, device),
                       batch_basew=_i32(batch_basew, device),
                       wide=port_wide)


def word_event_plan_from_voxtpu(plan_arrays, *, device) -> WordEventVoxPlan:
    """The port's word-event plan on voxtpu's event panels.

    `plan_arrays` is voxtpu's `WordEventVoxPlan`, or any object with its
    attribute names: `spec` (n, origin, voxel_size), `tc`, `num_events`,
    `num_fragments`, the (B, tb_sub, 128) panels `cells`, `ws`, `his`,
    `masks`, `cnts`, and `batch_tile`, `flags`, `tile_mask`. The masks'
    32 bits become an int32 view, with no arithmetic."""
    p = plan_arrays
    spec = GridSpec(n=int(p.spec.n), origin=tuple(float(v) for v in p.spec.origin),
                    voxel_size=float(p.spec.voxel_size))
    masks = np.ascontiguousarray(np.asarray(p.masks)).view(np.int32)
    cells, ws, his, cnts, batch_tile, flags, tile_mask = (
        np.asarray(getattr(p, k)) for k in ("cells", "ws", "his", "cnts", "batch_tile",
                                            "flags", "tile_mask"))
    return WordEventVoxPlan.from_layout(
        spec, device, cells, ws, his, masks, cnts, batch_tile, flags, tile_mask,
        tc=int(p.tc), num_events=int(p.num_events), num_fragments=int(p.num_fragments))


def pallas_plan_from_voxtpu(plan, *, device) -> PallasVoxPlan:
    """The port's suffix-route plan on voxtpu's batches.

    `plan` is voxtpu's `PallasVoxPlan`, or any object with its attribute
    names: `spec`, `tc`, `seg`, `num_fragments`, the (B, tb_sub, 128)
    panels `local_cells`, `xs`, and `batch_tile`, `flags`, `batch_xseg`,
    `tile_mask`."""
    spec = GridSpec(n=int(plan.spec.n), origin=tuple(float(v) for v in plan.spec.origin),
                    voxel_size=float(plan.spec.voxel_size))
    arrays = (np.asarray(getattr(plan, k)) for k in (
        "local_cells", "xs", "batch_tile", "flags", "batch_xseg", "tile_mask"))
    return PallasVoxPlan.from_layout(spec, device, *arrays, tc=int(plan.tc),
                                     seg=int(plan.seg),
                                     num_fragments=int(plan.num_fragments))


def wide_seed_from_voxtpu(hi, lo, *, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The wide JFA's (hi, lo) state as int32 tensors on `device` (copies
    of voxtpu's int32 arrays, the same values)."""
    return _i32(hi, device), _i32(lo, device)


def wq_plan_from_voxtpu(plan, *, device) -> WorkQueueVoxPlan:
    """The port's work-queue plan on voxtpu's layout.

    `plan` is voxtpu's `WorkQueueVoxPlan`, or any object with its
    attribute names: `spec`, `tc`, `seg`, `num_fragments`, the (rows,
    128) lanes `cells2d`, `xs2d`, per run `row_start`, `num_chunks`,
    `tile_id`, and `tile_mask`."""
    spec = GridSpec(n=int(plan.spec.n), origin=tuple(float(v) for v in plan.spec.origin),
                    voxel_size=float(plan.spec.voxel_size))
    arrays = (np.asarray(getattr(plan, k)) for k in (
        "cells2d", "xs2d", "row_start", "num_chunks", "tile_id", "tile_mask"))
    return WorkQueueVoxPlan.from_layout(spec, device, *arrays, tc=int(plan.tc),
                                        seg=int(plan.seg),
                                        num_fragments=int(plan.num_fragments))


def fused_plan_from_voxtpu(soft_plan, cells_b, tblidx_b, batch_tile,
                           table_face_flat, *, device) -> FusedSoftPlan:
    """The port's fused plan on voxtpu's `FusedSoftPlan` layout: its
    `cells_b`, `tblidx_b`, `batch_tile` and `table_face_flat`, over the
    port's soft plan of the same mesh. voxtpu's FIRST/LAST flags and
    tile mask drive its sequential TPU grid and are not needed."""
    return FusedSoftPlan.from_layout(soft_plan, device, cells_b, tblidx_b,
                                     batch_tile, table_face_flat)


def seg_plan_from_voxtpu(soft_plan, batch_tile, batch_panel, cells_b, tblidx_b,
                         table_face_flat, *, device) -> SegSoftPlan:
    """The port's seg plan on voxtpu's `SegSoftPlan` layout: its
    `batch_tile`, `batch_panel`, `cells_b`, `tblidx_b` and
    `table_face_flat`, over the port's soft plan of the same mesh (whose
    build coordinates give the x-hit drift snapshot). voxtpu's FIRST/LAST
    flags and visited-block masks drive its sequential TPU grid and are
    not needed."""
    return SegSoftPlan.from_layout(soft_plan, device, batch_tile, batch_panel,
                                   cells_b, tblidx_b, table_face_flat)


def soft_cuda_plan_from_voxtpu(soft_plan, cells_b, batch_tile, perm_fwd, *,
                               device) -> SoftCudaPlan:
    """The port's per-fragment plan on voxtpu's `SoftPallasPlan` layout.

    `perm_fwd[j]` is the source of slot j in voxtpu's sort of the
    fragments followed by pads; a source past the fragments is a pad,
    which the port's gather takes from the appended zero."""
    total = np.asarray(batch_tile).size * np.asarray(cells_b)[0].size
    src = np.array(perm_fwd, np.int64)[:total]
    nfrag = soft_plan.num_fragments
    src[src >= nfrag] = nfrag
    return SoftCudaPlan.from_layout(soft_plan, device, cells_b, batch_tile, src)


def fit_state_from_voxtpu(coords, count, mu, nu, step, *, device) -> FitState:
    """The port's FitState from voxtpu's `VoxelFit` state leaves: (V, 3)
    float32 coordinates, optax Adam's count (int32), mu and nu, and the
    int32 step. `torch.optim.Adam`'s state holds the same three values."""
    return FitState(coords=_f32(coords, device),
                    opt_state={"step": torch.tensor(float(np.asarray(count))),
                               "exp_avg": _f32(mu, device),
                               "exp_avg_sq": _f32(nu, device)},
                    step=int(np.asarray(step)))


def vox_shard_from_voxtpu(shards, shard: int) -> list:
    """One shard of voxtpu's `_split_buckets` split ([shard][bucket] =
    (window, v0, v1, v2, start_y, start_z)) as the port's NumPy bucket
    rows, what `parallel.sharded_vox.local_fragments` emits."""
    return [(int(window), *(np.array(a) for a in arrays))
            for window, *arrays in shards[shard]]


def soft_shard_from_voxtpu(soft_plan, split, shard: int) -> ShardPlan:
    """One shard of voxtpu's `_split_soft_buckets` split ([(window, syp,
    szp, fip)], each (n_shards, per)) as the port's `ShardPlan` over the
    port's soft plan of the same mesh: what every sharded engine builds
    its rank's plan on."""
    return ShardPlan(soft_plan, [(int(window), np.array(syp[shard]), np.array(szp[shard]),
                                  np.array(fip[shard])) for window, syp, szp, fip in split])


def sharded_fit_state_from_voxtpu(coords, count, mu, nu, *, device):
    """(coords, opt_state) of the port's sharded trainers from voxtpu's
    `init_fn` / `step_fn` state: the replicated coordinates and optax
    Adam's count, mu and nu (through `fit_state_from_voxtpu`)."""
    state = fit_state_from_voxtpu(coords, count, mu, nu, 0, device=device)
    return state.coords, state.opt_state
