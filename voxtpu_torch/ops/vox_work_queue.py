"""Streamed work-queue voxelizer (kernel B14).

Port of `voxtpu/ops/vox_pallas_wq.py`, voxtpu's experimental large-N
path, reached through its own entry point `voxelize_wq` (neither
package's `voxelize()` dispatches to it). The plan lays each active YZ
tile's fragments out as one run of (rows, 128) lanes, its start
128-aligned and its length a whole number of chunks of 8 x 128 lanes,
with no per-batch padding; pad lanes hold cell -1.

- `WorkQueueVoxPlan`: the layout, arrays equal to voxtpu's (`cells2d`,
  `xs2d`, `row_start`, `num_chunks`, `tile_id`, `tile_mask`,
  `num_fragments`, `num_active`), on a device. Fragments are sorted by
  the same int32 key with a stable sort (voxtpu's `jax.lax.sort` is
  stable); the runs are built by vectorised gathers, not voxtpu's loop
  over the active tiles (tens of thousands of them at 2048^3).
- B14 `wq_fill` replaces `_wq_kernel` (`csrc/vox_wq.cu::vt_wq_fill`);
  its plain torch version `wq_fill_plain` computes the same words by
  definition: the XOR of the fragments' suffix masks per (cell, word).
  `seg` shapes only voxtpu's TPU loop; the function does not depend on
  it.
- `voxelize_wq(mesh, spec, device, plan=None)`.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import WORD_BITS, GridSpec, VoxelGrid, pack_bits
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox import (FragmentPlan, _check_plan, fragments_from_plan,
                                  suffix_masks)
from voxtpu_torch.ops.vox_cuda import _SMEM_MAX

LANE = 128
CH_SUB = 8          # chunk = CH_SUB x 128 fragments
CH = CH_SUB * LANE


def _check_geometry(n: int, tc: int) -> None:
    if n % WORD_BITS != 0:
        raise ValueError("requires N % 32 == 0")
    if tc <= 0 or (n * n) % tc != 0:
        raise ValueError(f"tc={tc} must divide N^2={n * n}")


class WorkQueueVoxPlan:
    """Tile-aligned fragment stream layout, no per-batch padding
    (`vox_pallas_wq.py:173-238`), on `device`: the fragments of
    `fragments` (cells, x entries) or of a new `FragmentPlan`."""

    def __init__(self, mesh: Mesh, spec: GridSpec, device, fragments=None,
                 tc: int = 128, seg: int = 512):
        n = spec.n
        _check_geometry(n, tc)
        seg = min(seg, n)
        if n % seg != 0:
            raise ValueError(f"seg={seg} must divide N={n}")
        self.spec, self.tc, self.seg = spec, tc, seg
        self.device = torch.empty(0, device=device).device
        if fragments is None:
            fragments = fragments_from_plan(FragmentPlan(mesh, spec, self.device))
        cells, xs = (a.to(device=self.device, dtype=torch.int32) for a in fragments)
        dev = self.device
        num_tiles = n * n // tc
        self.num_tiles = num_tiles
        # Sort by (tile, x) so each tile's run is x-ordered.
        key = torch.where(cells < n * n, (cells // tc) * n + xs,
                          torch.full_like(cells, num_tiles * n))
        key_sorted, order = torch.sort(key, stable=True)
        local = (cells % tc)[order]
        xs = xs[order]

        probes = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) * n
        bounds = torch.searchsorted(key_sorted, probes).cpu().numpy()
        valid = int(bounds[-1])
        counts = np.diff(bounds)
        active = np.nonzero(counts)[0]

        # Each active tile's run starts at a 128-aligned row of the
        # padded stream and holds a whole number of chunks.
        padded = -(-counts[active] // CH) * CH
        first = np.concatenate([[0], np.cumsum(padded)])[:-1]
        total = int(padded.sum()) if active.size else CH
        pos = torch.arange(total, dtype=torch.int64, device=dev)
        if active.size:
            run = torch.repeat_interleave(
                torch.arange(active.size, device=dev),
                torch.from_numpy(padded).to(dev), output_size=total)
            off = pos - torch.from_numpy(first).to(dev)[run]
            ok = off < torch.from_numpy(counts[active]).to(dev)[run]
            src = torch.from_numpy(bounds[active]).to(dev)[run] + off
        else:
            ok = torch.zeros(total, dtype=torch.bool, device=dev)
            src = torch.zeros(total, dtype=torch.int64, device=dev)
        src = src.clamp(0, max(valid - 1, 0))
        self.cells2d = torch.where(ok, local[:max(valid, 1)][src], -1).view(-1, LANE)
        self.xs2d = torch.where(ok, xs[:max(valid, 1)][src], 0).view(-1, LANE)

        if active.size:
            row_start, num_chunks, tile_id = first // LANE, padded // CH, active
        else:
            row_start, num_chunks, tile_id = [0], [1], [0]
        self.row_start, self.num_chunks, self.tile_id = (
            torch.tensor(np.asarray(a, np.int64), dtype=torch.int32, device=dev)
            for a in (row_start, num_chunks, tile_id))
        tile_mask = np.zeros((num_tiles,), bool)
        tile_mask[active] = True
        self.tile_mask = torch.from_numpy(tile_mask).to(dev)
        self.num_fragments = valid
        self.num_active = int(self.tile_id.shape[0])

    @classmethod
    def from_layout(cls, spec: GridSpec, device, cells2d, xs2d, row_start, num_chunks,
                    tile_id, tile_mask, *, tc: int, seg: int,
                    num_fragments: int) -> "WorkQueueVoxPlan":
        """A plan on a given layout (see `interop.wq_plan_from_voxtpu`)."""
        _check_geometry(spec.n, tc)
        plan = cls.__new__(cls)
        plan.spec, plan.tc, plan.seg = spec, tc, seg
        plan.device = torch.empty(0, device=device).device
        plan.num_tiles = spec.n * spec.n // tc

        def dev(a, dtype):
            a = torch.from_numpy(np.array(a))  # a copy: the source may be read-only
            return a.to(device=plan.device, dtype=dtype).contiguous()

        plan.cells2d, plan.xs2d, plan.row_start, plan.num_chunks, plan.tile_id = (
            dev(a, torch.int32) for a in (cells2d, xs2d, row_start, num_chunks, tile_id))
        plan.tile_mask = dev(tile_mask, torch.bool)
        plan.num_fragments = int(num_fragments)
        plan.num_active = int(plan.tile_id.shape[0])
        return plan

    def args(self):
        """B14's six array arguments, in order."""
        return (self.cells2d, self.xs2d, self.row_start, self.num_chunks, self.tile_id,
                self.tile_mask)


def _run_rows(row_start, num_chunks, num_rows: int):
    """(row index, run index) of every lane row that a run covers, rows
    past `num_rows` dropped."""
    lens = num_chunks.long() * CH_SUB
    runs = torch.arange(lens.shape[0], device=lens.device)
    run = torch.repeat_interleave(runs, lens)
    first = torch.cumsum(lens, 0) - lens
    rows = row_start.long()[run] + torch.arange(run.shape[0], device=lens.device) - first[run]
    keep = rows < num_rows
    return rows[keep], run[keep]


def _xor_fill(cell: torch.Tensor, x: torch.Tensor, *, n: int) -> torch.Tensor:
    """(n*n, n/32) int32 words: per (cell, word) the XOR of the suffix
    masks of `cell`'s fragments at x (entries in [0, n)). The in-word
    XOR is a per-bit count mod 2 over the touched words; the carry a
    cumulative count of toggles at word (x >> 5) + 1, mod 2."""
    nw = n // WORD_BITS
    dev = cell.device
    w = x >> 5
    touched, inv = torch.unique(cell * nw + w, return_inverse=True)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=dev)
    bits = (suffix_masks(x).view(-1, 1) >> shifts) & 1
    count = torch.zeros((touched.shape[0], WORD_BITS), dtype=torch.int32, device=dev)
    count.index_add_(0, inv, bits)
    words = torch.zeros(n * n * nw, dtype=torch.int32, device=dev)
    words[touched] = pack_bits((count & 1).bool()).view(-1)
    toggles = torch.zeros(n * n * (nw + 1), dtype=torch.int32, device=dev)
    toggles.index_add_(0, cell * (nw + 1) + w + 1,
                       torch.ones(cell.shape[0], dtype=torch.int32, device=dev))
    carry = torch.cumsum(toggles.view(n * n, nw + 1), 1, dtype=torch.int32)[:, :nw]
    return words.view(n * n, nw) ^ -(carry & 1)


def wq_fill_plain(cells2d, xs2d, row_start, num_chunks, tile_id, tile_mask, *, n: int,
                  tc: int) -> torch.Tensor:
    """Plain torch version of B14 (any device), by its definition: run
    a (rows row_start[a] ... + num_chunks[a] * 8) fills YZ tile
    tile_id[a]; a lane with local cell c in [0, tc) and x in [0, n) is
    a fragment of cell tile * tc + c; words outside `tile_mask` are 0."""
    nw, num_tiles = n // WORD_BITS, n * n // tc
    rows, run = _run_rows(row_start, num_chunks, cells2d.shape[0])
    tile = tile_id.long()[run].view(-1, 1)
    c, x = cells2d[rows].long(), xs2d[rows].long()
    live = (c >= 0) & (c < tc) & (x >= 0) & (x < n) & (tile >= 0) & (tile < num_tiles)
    words = _xor_fill((tile * tc + c)[live], x[live], n=n)
    words.view(num_tiles, tc * nw)[~tile_mask] = 0
    return words.view(n, n, nw)


def wq_fill(cells2d, xs2d, row_start, num_chunks, tile_id, tile_mask, *, n: int,
            tc: int) -> torch.Tensor:
    """B14: the packed (n, n, n/32) int32 grid of a work-queue layout:
    `cells2d`, `xs2d` (rows, 128) int32 lanes (local cell -1 = pad),
    per run `row_start`, `num_chunks`, `tile_id` (num_active,) int32,
    `tile_mask` (num_tiles,) bool.

    `tile_id` must be strictly ascending, as the plans make it: the
    kernel finds a tile's run by binary search.

    Replaces voxtpu/ops/vox_pallas_wq.py::_wq_kernel. A CPU tensor takes
    the plain version, a CUDA tensor launches the kernel."""
    _check_geometry(n, tc)
    nw, num_tiles = n // WORD_BITS, n * n // tc
    _build.expect(cells2d, "cells2d", torch.int32, (None, LANE))
    _build.expect(xs2d, "xs2d", torch.int32, tuple(cells2d.shape))
    _build.expect(row_start, "row_start", torch.int32, (None,))
    for name, a in (("num_chunks", num_chunks), ("tile_id", tile_id)):
        _build.expect(a, name, torch.int32, tuple(row_start.shape))
    _build.expect(tile_mask, "tile_mask", torch.bool, (num_tiles,))
    tensors = (cells2d, xs2d, row_start, num_chunks, tile_id, tile_mask)
    if not _build.on_cuda(*tensors):
        return wq_fill_plain(*tensors, n=n, tc=tc)
    if 2 * tc * (nw + 1) * 4 > _SMEM_MAX:
        raise ValueError(f"tc={tc} x {nw} words exceeds one block's shared memory "
                         f"({_SMEM_MAX} bytes)")
    out = torch.empty((n, n, nw), dtype=torch.int32, device=cells2d.device)
    _build.launch("vt_wq_fill", *(t.data_ptr() for t in tensors), row_start.shape[0],
                  cells2d.shape[0], n, tc, num_tiles, out.data_ptr(),
                  _build.stream_of(out))
    wq_fill.launches += 1
    return out


wq_fill.launches = 0


def voxelize_wq(mesh: Mesh, spec: GridSpec, device,
                plan: WorkQueueVoxPlan | None = None) -> VoxelGrid:
    """Solid voxelization through B14 (`vox_pallas_wq.py:241-255`)."""
    device = torch.empty(0, device=device).device
    if plan is None:
        plan = WorkQueueVoxPlan(mesh, spec, device)
    _check_plan(plan, (WorkQueueVoxPlan,), "work queue", spec, device)
    words = wq_fill(*plan.args(), n=spec.n, tc=plan.tc)
    return VoxelGrid(words, spec.origin_tensor(device), spec.voxel_size_tensor(device))
