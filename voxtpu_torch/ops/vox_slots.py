"""Static slot layout: candidates, batch gathers, slot rows, the emit,
and voxtpu's whole-axis slot pipeline.

Port of `voxtpu/ops/vox_slots.py`. The candidate -> cell mapping of a
fixed topology is static, so a plan builds it once, on the plan's
device: every triangle's exact y/z bounding-box rectangle of candidate
cells (`_candidate_counts`, `_expand_candidates`), cut into batches of
slots. Per call, `_slot_emit` evaluates each slot's plane intersection
and edge tests (the value-dependent part) on the device. The banded
pipeline (`ops/vox_slots_banded.py`) uses these pieces;
`SlotVoxPipeline`, voxtpu's cross-check of it, fills each tile's
batches over the whole x axis with kernel B2.

`_candidate_counts` and `_slot_emit` are torch ops (voxtpu runs them as
NumPy and XLA, not Pallas). Their arithmetic matches voxtpu's term for
term (`vox_slots.py:154-179` for the emit), and eager torch rounds each
operation on its own, which is what the oracle bit-parity needs; origin
and voxel size stay float32 tensors, never Python floats, inside the
arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch.grids.voxel_grid import WORD_BITS, GridSpec, VoxelGrid
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox import _edge_zy
from voxtpu_torch.ops.vox_cuda import (TB_LANE, TB_SUB, TILE_CELLS, _gather_batches,
                                       fill_layout, tile_batches, tile_flags, wide_fill)


def _candidate_counts(tri3: torch.Tensor, origin: torch.Tensor, vs: torch.Tensor, n: int):
    """Every triangle's exact y/z bounding-box rectangle of candidate
    cells (voxtpu's, `vox_slots.py:73-108`, on `vox._triangle_windows`'
    starts, term for term in float32): (start (F, 2) int64 first y, z
    cell, w (F, 2) int64 its widths, counts (F,) int64 = wy * wz).
    `tri3` is (F, 3, 3) float32 vertex rows, `origin` (3,) and `vs` ()
    float32 on its device. A cell center outside the y/z bbox can never
    pass the inclusive edge tests."""
    yz = tri3[:, :, 1:]
    o = origin[1:]
    start = torch.floor((yz.amin(1) - o) / vs).to(torch.int32).clamp(0, n).long()
    end = torch.ceil((yz.amax(1) - o) / vs).to(torch.int64).clamp(0, n)
    w = (end - start).clamp(min=0)
    return start, w, w[:, 0] * w[:, 1]


def _expand_candidates(start, w, counts, total: int, n: int):
    """The candidates of `_candidate_counts`' rectangles, triangle by
    triangle, each rectangle y fastest: (face (total,) int64 the owning
    triangle, cell (total,) int64 = z * n + y)."""
    face = torch.repeat_interleave(counts, output_size=total)
    offs = torch.arange(total, device=counts.device) - (torch.cumsum(counts, 0) - counts)[face]
    wy = w[face, 0]
    cell = (start[face, 1] + offs // wy) * n + start[face, 0] + offs % wy
    return face, cell


def _vertex_rows(tri3: torch.Tensor) -> torch.Tensor:
    """(F, 9) float32 vertex rows a0 a1 a2 b0 b1 b2 c0 c1 c2 of (F, 3, 3)
    triangle vertices, on their device; one zero row for an empty mesh
    (its pad slots gather it)."""
    if tri3.shape[0] == 0:
        return torch.zeros((1, 9), dtype=torch.float32, device=tri3.device)
    return tri3.reshape(-1, 9)


def _slot_rows(tri_b: torch.Tensor, local_b: torch.Tensor, tri9: torch.Tensor,
               tb_sub: int):
    """Per-slot triangle coordinates, gathered on the device.

    `tri_b`/`local_b` are (bcount, tb) layouts (-1 local = pad) and
    `tri9` the `_vertex_rows`, on one device. Returns (rows, local):
    nine contiguous (B, tb_sub, 128) float32 tensors (a0 a1 a2 b0 b1 b2
    c0 c1 c2) and the int32 local-cell tensor."""
    bcount = tri_b.shape[0]
    slot = tri9[tri_b.reshape(-1).long()]  # (B * tb, 9)
    rows = tuple(slot[:, i].reshape(bcount, tb_sub, TB_LANE).contiguous()
                 for i in range(9))
    return rows, local_b.to(torch.int32).reshape(bcount, tb_sub, TB_LANE).contiguous()


def _slot_emit(rows, local: torch.Tensor, batch_tile: torch.Tensor,
               origin: torch.Tensor, vs: torch.Tensor, *, n: int, tc: int):
    """Per-slot x entry and validity (`vox_slots.py:145-179`, term for
    term). `rows` is a 9-tuple of (B, TB_SUB, 128) float32 tensors;
    `local` carries -1 for pad slots; `origin` (3,) and `vs` () are
    float32 tensors on the slots' device. Returns (xs, local_k) with
    local_k == -1 for invalid slots (and xs 0 there)."""
    a0, a1, a2, b0, b1, b2, c0, c1, c2 = rows
    cell = batch_tile[:, None, None] * tc + local
    ys = cell % n
    zs = cell // n
    cy = origin[1] + (ys.to(torch.float32) * vs + vs / 2)
    cz = origin[2] + (zs.to(torch.float32) * vs + vs / 2)

    u0, u1, u2 = b0 - a0, b1 - a1, b2 - a2
    t0, t1, t2 = c0 - a0, c1 - a1, c2 - a2
    normal_x = u1 * (c2 - b2) - u2 * (c1 - b1)
    one = torch.ones((), dtype=torch.float32, device=normal_x.device)
    sign = torch.where(normal_x >= 0, one, -one)
    A = u1 * t2 - u2 * t1
    B = u2 * t0 - u0 * t2
    C = u0 * t1 - u1 * t0
    D = A * a0 + B * a1 + C * a2

    e0 = _edge_zy(a1, a2, b1, b2, cy, cz) * sign
    e1 = _edge_zy(b1, b2, c1, c2, cy, cz) * sign
    e2 = _edge_zy(c1, c2, a1, a2, cy, cz) * sign
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)

    intersection = (D - B * cy - C * cz) / A
    xf = (intersection - origin[0]) / vs
    valid = inside & torch.isfinite(xf) & (xf < n) & (local >= 0)
    # Truncation toward zero, clipped to [0, n - 1]. Clamping to
    # [-1, n] first keeps the float -> int conversion in range; it
    # changes no clipped result.
    xf = torch.where(valid, xf, torch.zeros_like(xf)).clamp(-1.0, float(n))
    x = xf.to(torch.int32).clamp(0, n - 1)
    return (torch.where(valid, x, torch.zeros_like(x)),
            torch.where(valid, local, torch.full_like(local, -1)))


class SlotVoxPipeline:
    """Whole-pipeline voxelizer with a static slot layout
    (`vox_slots.py:195-281`), built once on `device` for one (mesh,
    grid) pair: every candidate of `_candidate_counts` owns a slot,
    slots are sorted by YZ tile (stable) and cut into batches of tb =
    tb_sub * 128 per tile. The mesh goes up once and the candidates,
    their sort and the slot gathers are torch ops there; one host read
    of the (num_tiles + 1) tile bounds gives the batches
    (`tile_batches`, `tile_flags`) and the `FillLayout`. Each call is
    `_slot_emit` and B2 over the whole x axis of every tile
    (`wide_fill`). The arrays equal voxtpu's: `rows` (nine (B, tb_sub,
    128) float32), `local` (int32, -1 = pad), `batch_tile`, `flags`,
    `batch_xseg` (zeros) (B,) int32, `tile_mask` (num_tiles,) bool.

    No overflow state: validity is decided per call, but vertex motion
    beyond the built windows leaves the result silently stale; rebuild
    on drift. Only the whole-axis fill: `seg` other than None or N is
    refused, as in voxtpu (its slots are grouped by tile only, so a
    segmented fill would drop every fragment entering at x >= seg)."""

    def __init__(self, mesh: Mesh, spec: GridSpec, device, tc: int = TILE_CELLS,
                 tb_sub: int = TB_SUB, seg: int | None = None):
        n = spec.n
        if n % WORD_BITS != 0:
            raise ValueError("the slot pipeline requires N % 32 == 0")
        if tc <= 0 or (n * n) % tc != 0:
            raise ValueError(f"tc={tc} must divide N^2={n * n}")
        if seg is not None and seg != n:
            raise ValueError(f"SlotVoxPipeline supports only whole-axis fill "
                             f"(seg=None or seg == n, got seg={seg})")
        tb = tb_sub * TB_LANE
        self.spec, self.tc, self.tb_sub, self.seg = spec, tc, tb_sub, n
        num_tiles = (n * n) // tc
        self.num_tiles = num_tiles
        dev = self.device = torch.empty(0, device=device).device
        # Made once: a tensor made from host values waits for the card.
        self._origin = spec.origin_tensor(dev)
        self._voxel_size = spec.voxel_size_tensor(dev)

        tri3 = torch.from_numpy(mesh.coords).to(dev)[torch.from_numpy(mesh.faces).to(dev).long()]
        start, w, counts = _candidate_counts(tri3, self._origin, self._voxel_size, n)
        total = int(counts.sum())
        face, cell = _expand_candidates(start, w, counts, total, n)
        self.num_candidates = total
        tile, order = torch.sort(cell // tc, stable=True)
        local = (cell[order] % tc).int()
        tri = face[order].int()
        bounds = torch.searchsorted(tile, torch.arange(num_tiles + 1, device=dev)).cpu().numpy()
        batch_tiles, starts, ends = tile_batches(bounds, tb)
        flags, tile_mask = tile_flags(bounds, batch_tiles)
        self.num_batches = len(batch_tiles)
        self.num_slots = self.num_batches * tb

        def dev32(a):
            return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)

        starts, ends = dev32(starts), dev32(ends)
        self.rows, self.local = _slot_rows(
            _gather_batches(tri, starts, ends, tb=tb, fill=0),
            _gather_batches(local, starts, ends, tb=tb, fill=-1), _vertex_rows(tri3), tb_sub)
        self.batch_tile = dev32(batch_tiles)
        self.flags = dev32(flags)
        self.batch_xseg = torch.zeros(self.num_batches, dtype=torch.int32, device=dev)
        self.tile_mask = torch.from_numpy(tile_mask).to(dev)
        self.layout = fill_layout(batch_tiles, num_tiles, dev, nw=n // WORD_BITS, tc=tc)

    def words(self) -> torch.Tensor:
        """One call: the emit, then B2 -> (n, n, n/32) int32 words."""
        n = self.spec.n
        xs, local_k = _slot_emit(self.rows, self.local, self.batch_tile, self._origin,
                                 self._voxel_size, n=n, tc=self.tc)
        words = wide_fill(local_k, xs, self.batch_tile, n=n, tc=self.tc,
                          num_tiles=self.num_tiles, layout=self.layout)
        return words.view(n, n, n // WORD_BITS)

    def __call__(self) -> VoxelGrid:
        return VoxelGrid(words=self.words(), origin=self._origin.clone(),
                         voxel_size=self._voxel_size.clone())
