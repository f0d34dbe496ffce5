"""Fused (tile, triangle) soft voxelizer — the ``"fused"`` engine.

Port of `voxtpu/ops/soft_vox_fused.py`. Per call only T per-triangle
coefficient rows are computed in torch ops (`triangle_coeffs`: the
three edge planes, the x-hit plane and the facing sign, 16 values); no
per-fragment data goes through device memory. Each batch of slots
carries a table of its triangles' rows (at most `tbl`), and

- B7 (`fused_fwd`, `csrc/soft_vox.cu::vt_fused_fwd`, replaces
  `_fused_fwd_kernel`) rebuilds every slot's fragment from its static
  cell and its table row and sums its sigmoid x profile into the grid;
- B8 (`fused_bwd`, `vt_fused_bwd`, replaces `_fused_bwd_kernel`) takes
  the occupancy cotangent to per-slot (dw, dx_hit), chain-rules them to
  the 13 coefficient cotangents and sums those per table row, one
  (tbl, 16) block per batch.

Both kernels evaluate a slot's sigmoid only in its transition window
of columns and take the saturated columns without it (the note in
`csrc/soft_vox.cu`): B7's output is bitwise the full-row sum's, B8 reads
the saturated columns' cotangent sum from a float64 row prefix.

Two gather-only "classed" reductions (`_ClassedLayout`,
`_classed_reduce`) carry the table cotangents back to the triangles and
the triangles' to the vertices: a deterministic, atomic-free segment
sum in voxtpu's own summation order (`index_add_` on CUDA would sum
with atomics, in an order that changes from run to run).

voxtpu's TPU-only parts have no counterpart here: the ``mode`` switch
(bf16_3x MXU emulation, int8 byte-plane gathers), the FIRST/LAST
accumulator flags of its sequential grid and the tile-mask re-zeroing.
The kernels read the f32 tables directly and B7 writes each tile once.

Beside each kernel is its plain torch version (`fused_fwd_plain`,
`fused_bwd_plain`), in chunks of batches; a wrapper takes it for CPU
tensors and launches the kernel for CUDA tensors.

The plan (`FusedSoftPlan`) is built on the plan's device, not on the
host: the soft plan's bucket rows and the faces go up once, and the slot
keys, their sort, the pairs, the slot scatters and both classed layouts
are torch ops there. The greedy batch cut, the one sequential step, is
kernel C2 (`csrc/soft_plan.cu`, `pair_cut_counts`, `pair_cut`), which
replaces voxtpu's host loop. Four host reads a plan (the slot and pair
totals; the batch total; the layouts' largest counts with the plan's
range checks; their histograms), counted on the spans
``soft.engine_plan.cells``, ``.cut`` and ``.tables``. The seg engine's
plan (`ops/soft_vox_seg.py`) cuts and sets up its tables with the same
`cut_pairs` and `TablePlan`, on its own run keys. Every array is
voxtpu's value for value; a CPU device runs the same code with C2's
plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.ops.soft_vox import (CHUNK_ELEMS, clip01, f32, profile_add,
                                       profile_grid, profile_out, profile_sums,
                                       temperatures, x_centers)
from voxtpu_torch.ops.vox_cuda import TB_LANE, TILE_CELLS, _check_range
from voxtpu_torch.utils.trace import NULL_SPAN, _read, _upload, span

NATTR = 16
NGRAD = 13  # coefficient cotangents per slot (rows 13..15 stay zero)
_SMEM_MAX = 232448  # shared memory a block may use on an H100
_XC = 64            # columns per B7 block (csrc/soft_vox.cu kXC)


def triangle_coeffs(tri: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) vertex coords -> (T, 16) fragment-reconstruction
    coefficients, differentiable (`soft_vox_fused.py:162-201`):
    0..8 (u, v, w) of the edges e0, e1, e2 (sign-folded), 9..11 the
    x-hit plane (P, Q, R) = (D, B, C) / A, 12 the weight multiplier
    (facing sign, 0 if x-degenerate)."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    nx = (b[:, 1] - a[:, 1]) * (c[:, 2] - b[:, 2]) - (
        b[:, 2] - a[:, 2]) * (c[:, 1] - b[:, 1])
    one = tri.new_ones(())
    sign = torch.where(nx >= 0, one, -one)

    def edge(v0, v1):
        u = v1[:, 1] - v0[:, 1]
        v = -(v1[:, 2] - v0[:, 2])
        w = v0[:, 1] * (v1[:, 2] - v0[:, 2]) - v0[:, 2] * (v1[:, 1] - v0[:, 1])
        return u * sign, v * sign, w * sign

    u0, v0_, w0 = edge(a, b)
    u1, v1_, w1 = edge(b, c)
    u2, v2_, w2 = edge(c, a)
    cr = torch.linalg.cross(b - a, c - a, dim=1)  # as soft_vox._soft_fragments
    A, B, C = cr[:, 0], cr[:, 1], cr[:, 2]
    D = A * a[:, 0] + B * a[:, 1] + C * a[:, 2]
    degenerate = A.abs() < 1e-20
    safe_A = torch.where(degenerate, A.new_full((), 1e-20), A)
    P = D / safe_A
    Q = B / safe_A
    R = C / safe_A
    wmul = torch.where(degenerate, A.new_zeros(()), sign)
    zeros = torch.zeros_like(A)
    return torch.stack([u0, v0_, w0, u1, v1_, w1, u2, v2_, w2, P, Q, R, wmul,
                        zeros, zeros, zeros], dim=1)


# ---------------------------------------------------------------------------
# Plain versions and kernel wrappers
# ---------------------------------------------------------------------------


def _batch_chunks(num_batches: int, tb: int, n: int):
    step = max(1, CHUNK_ELEMS // (tb * n))
    for b0 in range(0, num_batches, step):
        yield b0, min(num_batches, b0 + step)


def slot_rows(tables, cells_b, tblidx_b, b0, b1, *, tc):
    """The slots of batches [b0, b1): (valid (nb, tb) bool, local cells
    (nb, tb) int64, their table rows as 16 (nb, tb) tensors)."""
    nb = b1 - b0
    cells = cells_b[b0:b1].reshape(nb, -1).long()
    idx = tblidx_b[b0:b1].reshape(nb, -1).long()
    tbl = tables.shape[1]
    valid = (cells >= 0) & (cells < tc) & (idx >= 0) & (idx < tbl)
    at = torch.gather(tables[b0:b1], 1,
                      idx.clamp(0, tbl - 1)[..., None].expand(-1, -1, NATTR))
    return valid, cells, at.unbind(-1)


def slot_fragment(at, cy, cz, tau_e):
    """A slot's fragment from its table row and cell centre
    (`_fused_fwd_kernel` lines 257-261): (s0, s1, s2, cov, w, xh)."""
    s0 = torch.sigmoid((at[0] * cz + at[1] * cy + at[2]) / tau_e)
    s1 = torch.sigmoid((at[3] * cz + at[4] * cy + at[5]) / tau_e)
    s2 = torch.sigmoid((at[6] * cz + at[7] * cy + at[8]) / tau_e)
    cov = s0 * s1 * s2
    return s0, s1, s2, cov, at[12] * cov, at[9] - at[10] * cy - at[11] * cz


def chain_rule(dw, dxh, at, cy, cz, s0, s1, s2, cov, tau_e):
    """Per-slot (dw, dx_hit) -> the 13 coefficient cotangents (..., 13)
    (`_fused_bwd_kernel` lines 348-360)."""
    dcov = dw * at[12]
    de = [dcov * cov * (1.0 - s) / tau_e for s in (s0, s1, s2)]
    return torch.stack([de[0] * cz, de[0] * cy, de[0],
                        de[1] * cz, de[1] * cy, de[1],
                        de[2] * cz, de[2] * cy, de[2],
                        dxh, -dxh * cy, -dxh * cz, dw * cov], dim=-1)


def _fused_slots(tables, cells_b, tblidx_b, batch_tile, b0, b1, *, n, tc, prm):
    """Per-slot values of batches [b0, b1) (`_fused_fwd_kernel` lines
    240-261): (valid (nb, tb) bool, gcell, cy, cz, s0, s1, s2, cov, at,
    w, xh)."""
    _, oy, oz, vs, tau_e, _ = prm
    valid, cells, at = slot_rows(tables, cells_b, tblidx_b, b0, b1, tc=tc)
    gcell = batch_tile[b0:b1].long()[:, None] * tc + cells
    cy = oy + ((gcell % n).float() * vs + vs * 0.5)
    cz = oz + ((gcell // n).float() * vs + vs * 0.5)
    s0, s1, s2, cov, w, xh = slot_fragment(at, cy, cz, tau_e)
    return valid, gcell, cy, cz, s0, s1, s2, cov, at, w, xh


def fused_fwd_plain(tables, cells_b, tblidx_b, batch_tile, *, n: int,
                    tc: int, prm) -> torch.Tensor:
    """Plain torch version of B7 (any device), in chunks of batches."""
    num_batches, tb = cells_b.shape[0], cells_b[0].numel()
    out = profile_out(n, tables.device)
    cx = x_centers(n, prm[0], prm[3], tables.device)
    for b0, b1 in _batch_chunks(num_batches, tb, n):
        valid, gcell, *_, w, xh = _fused_slots(
            tables, cells_b, tblidx_b, batch_tile, b0, b1, n=n, tc=tc, prm=prm)
        rows = torch.where(valid, gcell, n * n).reshape(-1)
        profile_add(out, rows, w.reshape(-1), xh.reshape(-1), cx, prm[5])
    return profile_grid(out, n)


def fused_bwd_plain(tables, cells_b, tblidx_b, batch_tile, g, *, n: int,
                    tc: int, prm) -> torch.Tensor:
    """Plain torch version of B8 (any device): (B, tbl, 16) table
    cotangents, in chunks of batches (`_fused_bwd_kernel` 336-366)."""
    num_batches, tbl = tables.shape[0], tables.shape[1]
    tb = cells_b[0].numel()
    tau_e, tau_x = prm[4], prm[5]
    cx = x_centers(n, prm[0], prm[3], tables.device)
    g_ext = torch.cat([g.reshape(n * n, n), g.new_zeros((1, n))])
    dtab = torch.zeros((num_batches * tbl + 1, NGRAD), dtype=tables.dtype,
                       device=tables.device)
    for b0, b1 in _batch_chunks(num_batches, tb, n):
        valid, gcell, cy, cz, s0, s1, s2, cov, at, w, xh = _fused_slots(
            tables, cells_b, tblidx_b, batch_tile, b0, b1, n=n, tc=tc, prm=prm)
        rows = torch.where(valid, gcell, n * n).reshape(-1)
        sa, sb = profile_sums(g_ext, rows, xh.reshape(-1), cx, tau_x)
        dw = sa.view_as(w)
        dxh = (w / tau_x) * sb.view_as(w)
        d = chain_rule(dw, dxh, at, cy, cz, s0, s1, s2, cov, tau_e)
        table_add(dtab, d, valid, tblidx_b, b0, b1)
    return table_grid(dtab, num_batches, tbl)


def table_add(dtab, d, valid, tblidx_b, b0, b1) -> None:
    """Add the slots' (nb, tb, 13) cotangents `d` of batches [b0, b1)
    into their table rows of `dtab` ((B * tbl + 1, 13), the last row a
    dump for pad slots)."""
    tbl = (dtab.shape[0] - 1) // tblidx_b.shape[0]
    bidx = torch.arange(b0, b1, device=dtab.device)[:, None]
    target = torch.where(valid, bidx * tbl + tblidx_b[b0:b1].reshape(
        b1 - b0, -1).long(), dtab.shape[0] - 1)
    dtab.index_add_(0, target.reshape(-1), d.reshape(-1, NGRAD))


def table_grid(dtab, num_batches: int, tbl: int) -> torch.Tensor:
    """A `table_add` accumulator as (B, tbl, 16) table cotangents."""
    dtab = dtab[:-1].view(num_batches, tbl, NGRAD)
    return torch.cat([dtab, dtab.new_zeros((num_batches, tbl, NATTR - NGRAD))], -1)


def _check_fused(tables, cells_b, tblidx_b, batch_tile):
    _build.expect(tables, "tables", torch.float32, (None, None, NATTR))
    _build.expect(cells_b, "cells_b", torch.int32, (tables.shape[0], None, TB_LANE))
    _build.expect(tblidx_b, "tblidx_b", torch.int32, tuple(cells_b.shape))
    _build.expect(batch_tile, "batch_tile", torch.int32, (tables.shape[0],))


def fused_fwd_smem_bytes(tc: int, tb: int) -> int:
    """Shared memory of the windowed accumulation of B7, B9 and B13 fwd
    (`csrc/soft_common.cuh::acc_smem_bytes`): the (tc, 64) 64-bit
    fixed-point accumulator and a 64-bit base per cell, a 16-byte work
    item per slot, a bit per (cell, column) and a carry bit per cell for
    non-finite terms, and two counters."""
    words = (tc + 31) // 32
    return tc * (_XC + 1) * 8 + tb * 16 + words * (_XC + 1) * 4 + 8


def _check_fwd_smem(tc: int, tb: int) -> None:
    if fused_fwd_smem_bytes(tc, tb) > _SMEM_MAX:
        raise ValueError(f"tc={tc}, tb={tb} exceed one block's shared memory")


def fused_fwd(tables, cells_b, tblidx_b, batch_tile, run_start, *, n: int,
              tc: int, prm) -> torch.Tensor:
    """B7: (B, tbl, 16) tables -> (n, n, n) occupancy, unclipped.

    Slots are (B, tb_sub, 128): local cell (-1 = pad) and table row;
    `batch_tile` (B,) the tile of each batch, whose batches must form
    contiguous runs, `run_start` (R + 1,) int32 their bounds (the plan's
    `run_start_d`). `prm` = (ox, oy, oz, vs, tau_e, tau_x) float32
    values. A CPU tensor takes the plain version, a CUDA tensor launches
    the kernel (`csrc/soft_vox.cu::vt_fused_fwd`)."""
    _check_fused(tables, cells_b, tblidx_b, batch_tile)
    if not _build.on_cuda(tables, cells_b, tblidx_b, batch_tile, run_start):
        return fused_fwd_plain(tables, cells_b, tblidx_b, batch_tile, n=n,
                               tc=tc, prm=prm)
    _build.expect(run_start, "run_start", torch.int32)
    tb = cells_b[0].numel()
    _check_fwd_smem(tc, tb)
    out = torch.zeros((n, n, n), dtype=torch.float32, device=tables.device)
    num_runs = run_start.numel() - 1
    if num_runs > 0:
        # one int4 record per slot: local cell, w, x_hit, window
        work = torch.empty((cells_b.numel(), 4), dtype=torch.int32, device=out.device)
        _build.launch("vt_fused_fwd", tables.data_ptr(), cells_b.data_ptr(),
                      tblidx_b.data_ptr(), batch_tile.data_ptr(),
                      run_start.data_ptr(), tables.shape[0], num_runs, tb,
                      tables.shape[1], n, tc, (n * n) // tc, *prm,
                      work.data_ptr(), out.data_ptr(), _build.stream_of(out))
        fused_fwd.launches += 1
    return out


fused_fwd.launches = 0


def fused_bwd(tables, cells_b, tblidx_b, batch_tile, g, *, n: int, tc: int,
              prm) -> torch.Tensor:
    """B8: occupancy cotangent g (n, n, n) -> (B, tbl, 16) table
    cotangents (rows 13..15 zero). A CPU tensor takes the plain version,
    a CUDA tensor launches the kernel (`vt_fused_bwd`)."""
    _check_fused(tables, cells_b, tblidx_b, batch_tile)
    _build.expect(g, "g", torch.float32, (n, n, n))
    if not _build.on_cuda(tables, cells_b, tblidx_b, batch_tile, g):
        return fused_bwd_plain(tables, cells_b, tblidx_b, batch_tile, g, n=n,
                               tc=tc, prm=prm)
    num_batches, tbl = tables.shape[0], tables.shape[1]
    dtab = torch.zeros_like(tables)
    if num_batches:
        pre = torch.empty((n * n, n), dtype=torch.float64, device=g.device)  # row prefix
        _build.launch("vt_fused_bwd", tables.data_ptr(), cells_b.data_ptr(),
                      tblidx_b.data_ptr(), batch_tile.data_ptr(), g.data_ptr(),
                      num_batches, cells_b[0].numel(), tbl, n, tc,
                      (n * n) // tc, *prm, pre.data_ptr(), dtab.data_ptr(),
                      _build.stream_of(dtab))
        fused_bwd.launches += 1
    return dtab


fused_bwd.launches = 0


# ---------------------------------------------------------------------------
# Gather-only reductions and the autograd Functions
# ---------------------------------------------------------------------------


def _classed_reduce(g: torch.Tensor, cls_pos, inv: torch.Tensor) -> torch.Tensor:
    """Sum source rows of `g` per target (`soft_vox_fused.py:527-537`):
    exact row counts, short sums in source order, one reassembly gather.
    `cls_pos` and `inv` are the int64 device tensors of the layout."""
    parts = []
    for pos in cls_pos:
        acc = g.index_select(0, pos[0])
        for j in range(1, pos.shape[0]):
            acc = acc + g.index_select(0, pos[j])
        parts.append(acc)
    parts.append(g.new_zeros((1, g.shape[1])))
    return torch.cat(parts).index_select(0, inv)


class _GatherTri(torch.autograd.Function):
    """coords (V, 3) -> (T, 3, 3); the backward sums each vertex's
    (face, corner) rows with the classed reduction. Vertices no face
    references get zero rows."""

    @staticmethod
    def forward(ctx, coords, plan):
        ctx.plan = plan
        ctx.num_coords = coords.shape[0]
        return coords[plan.faces_d]

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        acc = _classed_reduce(g.reshape(-1, 3), plan.vert_cls_d, plan.vert_inv_d)
        extra = ctx.num_coords - acc.shape[0]
        if extra > 0:
            acc = torch.cat([acc, acc.new_zeros((extra, 3))])
        return acc, None


class _ExpandRows(torch.autograd.Function):
    """(T + 1, 16) coefficient rows (the last one zero) -> (B * tbl, 16)
    table slots; the backward is the classed slot -> face reduction."""

    @staticmethod
    def forward(ctx, coeffs_ext, plan):
        ctx.plan = plan
        return coeffs_ext.index_select(0, plan.fidx_d)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        acc = _classed_reduce(g, plan.expand_cls_d, plan.expand_inv_d)
        return torch.cat([acc, acc.new_zeros((1, NATTR))]), None


class _FusedAccumulate(torch.autograd.Function):
    """(B, tbl, 16) tables -> (n, n, n) occupancy: forward B7, backward
    B8."""

    @staticmethod
    def forward(ctx, tables, plan, prm):
        ctx.plan, ctx.prm = plan, prm
        ctx.save_for_backward(tables)
        return fused_fwd(tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d,
                         plan.run_start_d, n=plan.spec.n, tc=plan.tc, prm=prm)

    @staticmethod
    def backward(ctx, g):
        (tables,) = ctx.saved_tensors
        plan = ctx.plan
        dtab = fused_bwd(tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d,
                         g.contiguous(), n=plan.spec.n, tc=plan.tc, prm=ctx.prm)
        return dtab, None, None


# ---------------------------------------------------------------------------
# Plan helpers on the host: run bounds, the soft plan's candidate cells
# ---------------------------------------------------------------------------


def tile_runs(batch_tile: np.ndarray) -> np.ndarray:
    """(R + 1,) int32 bounds of the runs of equal tiles in `batch_tile`.
    Each tile must form one run (the forward kernels give a run one
    block per column chunk, which writes the tile's rows whole)."""
    bt = np.asarray(batch_tile)
    if bt.size and (np.diff(bt) < 0).any():
        raise ValueError("batches are not grouped by tile")
    starts = np.flatnonzero(np.concatenate([[True], bt[1:] != bt[:-1]]))
    return np.append(starts, bt.size).astype(np.int32)


def slot_cells(soft_plan, n: int):
    """Candidate cells of every bucket, in `soft_voxelize`'s fragment
    order (bucket, triangle, dz, dy): (cells (F,) int64 with -1 for
    out-of-grid, faces (F,) int64)."""
    cells_l, faces_l = [], []
    for bucket in soft_plan.buckets:
        window = bucket[0]
        sy = np.asarray(bucket[4])
        sz = np.asarray(bucket[5])
        fi = np.asarray(bucket[6])
        ys = sy[:, None, None] + np.arange(window)[None, None, :]
        zs = sz[:, None, None] + np.arange(window)[None, :, None]
        ok = (ys >= 0) & (ys < n) & (zs >= 0) & (zs < n)
        cells_l.append(np.where(ok, zs.astype(np.int64) * n + ys, -1).reshape(-1))
        faces_l.append(np.repeat(fi.astype(np.int64), window * window))
    if not cells_l:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    return np.concatenate(cells_l), np.concatenate(faces_l)


# ---------------------------------------------------------------------------
# The plan on the device: slot keys, the pair cut (C2), the classed layouts
# ---------------------------------------------------------------------------

# The key of an out-of-grid cell: it sorts after every slot.
_NO_SLOT = torch.iinfo(torch.int64).max


def slot_keys(soft_plan, run_of, *, tc: int, sp, device) -> torch.Tensor:
    """`slot_cells`' candidate cells as sorted int64 keys, built on
    `device`: (run * num_faces + face) * tc + cell % tc, where
    `run_of(cell, face)` (int64 tensors) gives a slot's run (its tile, in
    the fused plan), and `_NO_SLOT` for each out-of-grid cell, at the end.
    The sort gives `np.lexsort((cells, faces, run))`'s order (equal keys
    are equal slots). The bucket rows go up once, counted on the span
    `sp`."""
    n = soft_plan.spec.n
    num_faces = len(soft_plan.faces_array)
    buckets = soft_plan.buckets
    if not buckets:
        return torch.zeros(0, dtype=torch.int64, device=device)
    rows = _upload(sp, np.concatenate([np.stack(b[4:7]) for b in buckets], 1), device,
                   np.int32)
    keys, r0 = [], 0
    for b in buckets:
        window, r1 = b[0], r0 + len(b[4])
        sy, sz, face = (a[:, None, None] for a in rows[:, r0:r1].long())
        d = torch.arange(window, device=device)
        ys = sy + d[None, None, :]
        zs = sz + d[None, :, None]
        cell = zs * n + ys  # (rows, dz, dy), slot_cells' order
        key = (run_of(cell, face) * num_faces + face) * tc + cell % tc
        out = (ys < 0) | (ys >= n) | (zs < 0) | (zs >= n)
        keys.append(key.masked_fill_(out, _NO_SLOT).view(-1))
        r0 = r1
    key = torch.cat(keys)
    del keys
    return torch.sort(key, stable=True).values


def _cut_rounds(csum: np.ndarray, pbounds: np.ndarray, *, tb: int, tbl: int):
    """voxtpu's greedy batch loop (`soft_vox_fused.py:633-661`) on every
    run at once (host arrays):
    yields each round's (runs, first pairs, end pairs). A run whose next
    pair alone exceeds `tb` slots gets end == first and closes."""
    runs = np.flatnonzero(np.diff(pbounds))
    cur, end = pbounds[runs].astype(np.int64), pbounds[runs + 1]
    while runs.size:
        j = np.searchsorted(csum, csum[cur] + tb, side="right") - 1
        j = np.minimum(np.minimum(j, cur + tbl), end)
        yield runs, cur, j
        live = (j > cur) & (j < end)
        runs, cur, end = runs[live], j[live], end[live]


def pair_cut_counts_plain(csum, pbounds, *, tb: int, tbl: int) -> torch.Tensor:
    """Plain version of C2's first pass (CPU tensors): voxtpu's loop,
    counting each run's batches (-1 where a pair exceeds `tb`)."""
    cs, pb = csum.numpy(), pbounds.numpy()
    counts = np.zeros(len(pb) - 1, np.int32)
    for runs, c, j in _cut_rounds(cs, pb, tb=tb, tbl=tbl):
        counts[runs] = np.where(j > c, counts[runs] + 1, -1)
    return torch.from_numpy(counts)


def pair_cut_plain(csum, pbounds, off, *, total: int, tb: int, tbl: int):
    """Plain version of C2's second pass (CPU tensors): voxtpu's loop,
    writing each batch's (run, first pair, end pair) at its run's
    offset."""
    out = np.zeros((3, total), np.int32)
    k = off.numpy().astype(np.int64)
    for runs, c, j in _cut_rounds(csum.numpy(), pbounds.numpy(), tb=tb, tbl=tbl):
        out[:, k[runs]] = (runs, c, j)
        k[runs] += 1
    return tuple(torch.from_numpy(a) for a in out)


def _check_pair_cut(csum, pbounds, *, tb: int, tbl: int) -> int:
    _build.expect(csum, "csum", torch.int32, (None,))
    _build.expect(pbounds, "pbounds", torch.int32, (None,))
    if pbounds.shape[0] < 1 or tb < 1 or tbl < 1:
        raise ValueError(f"need run bounds, tb >= 1 and tbl >= 1 (tb={tb}, tbl={tbl})")
    return pbounds.shape[0] - 1


def pair_cut_counts(csum: torch.Tensor, pbounds: torch.Tensor, *, tb: int,
                    tbl: int) -> torch.Tensor:
    """C2's first pass -> (num_runs,) int32 batches a run, -1 where a
    pair exceeds `tb` slots. Pairs are (P + 1,) int32 prefix slots
    `csum` (pair p's slots [csum[p], csum[p + 1])), sorted by run; run
    t's are [pbounds[t], pbounds[t + 1]) ((num_runs + 1,) int32). A batch
    holds at most `tb` slots and `tbl` pairs of one run.

    Replaces no TPU kernel: voxtpu's host cut (`soft_vox_fused.py:
    596-696`). A CPU tensor takes the plain version, a CUDA tensor
    launches `csrc/soft_plan.cu::vt_pair_cut_counts`."""
    num_runs = _check_pair_cut(csum, pbounds, tb=tb, tbl=tbl)
    if not _build.on_cuda(csum, pbounds):
        return pair_cut_counts_plain(csum, pbounds, tb=tb, tbl=tbl)
    counts = torch.empty(num_runs, dtype=torch.int32, device=csum.device)
    _build.launch("vt_pair_cut_counts", csum.data_ptr(), pbounds.data_ptr(),
                  counts.data_ptr(), num_runs, tb, tbl, _build.stream_of(counts))
    pair_cut_counts.launches += 1
    return counts


pair_cut_counts.launches = 0


def pair_cut(csum: torch.Tensor, pbounds: torch.Tensor, off: torch.Tensor, *,
             total: int, tb: int, tbl: int):
    """C2's second pass -> (batch_run, p0, p1), each (total,) int32: run
    t's batches from `off[t]` on ((num_runs,) int32), each its run and
    its pairs [p0, p1). Pairs as in `pair_cut_counts`, none exceeding
    `tb`.

    A CPU tensor takes the plain version, a CUDA tensor launches
    `csrc/soft_plan.cu::vt_pair_cut`."""
    num_runs = _check_pair_cut(csum, pbounds, tb=tb, tbl=tbl)
    _build.expect(off, "off", torch.int32, (num_runs,))
    if not _build.on_cuda(csum, pbounds, off):
        return pair_cut_plain(csum, pbounds, off, total=total, tb=tb, tbl=tbl)
    out = torch.empty((3, total), dtype=torch.int32, device=csum.device)
    _build.launch("vt_pair_cut", csum.data_ptr(), pbounds.data_ptr(), off.data_ptr(),
                  *(r.data_ptr() for r in out), num_runs, tb, tbl, _build.stream_of(out))
    pair_cut.launches += 1
    return tuple(out)


pair_cut.launches = 0


def cut_pairs(key: torch.Tensor, *, num_runs: int, num_faces: int, tc: int,
              tb_sub: int, tbl: int, sp) -> dict:
    """voxtpu's greedy batch layout (`soft_vox_fused.py:596-696`) on the
    device, from sorted slot keys (`slot_keys`' or the seg plan's; runs
    in [0, num_runs)): dict(num_fragments, num_pairs, counts (num_runs,)
    int32 batches a run, cells_b and tblidx_b (B, tb_sub, 128) int32,
    batch_run (B,) int32, table_face (B * tbl,) int32, run_start (R + 1,)
    int32 the bounds of the runs of batches). Two host reads, counted on
    the span `sp`: the slot and pair totals; the batch total with the
    least count (a pair over the slot budget raises) and the busy runs."""
    dev = key.device
    tb = tb_sub * TB_LANE
    live = key != _NO_SLOT
    pk = key // tc  # the slot's pair: run * num_faces + face
    newpair = live.clone()
    newpair[1:] &= pk[1:] != pk[:-1]
    num_fragments, num_pairs = (int(v) for v in _read(sp, torch.stack(
        [live.sum(), newpair.sum()])))
    del live
    if num_fragments + tb >= 2 ** 31:
        raise ValueError(f"{num_fragments} slots: the cut indexes them in 32 bits")
    out = dict(num_fragments=num_fragments, num_pairs=num_pairs)
    if not num_pairs:  # one empty batch on run 0
        return dict(out, counts=torch.zeros(num_runs, dtype=torch.int32, device=dev),
                    cells_b=torch.full((1, tb_sub, TB_LANE), -1, dtype=torch.int32,
                                       device=dev),
                    tblidx_b=torch.zeros((1, tb_sub, TB_LANE), dtype=torch.int32, device=dev),
                    batch_run=torch.zeros(1, dtype=torch.int32, device=dev),
                    table_face=torch.full((tbl,), -1, dtype=torch.int32, device=dev),
                    run_start=torch.arange(2, dtype=torch.int32, device=dev))
    local = (key[:num_fragments] % tc).int()
    pk, newpair = pk[:num_fragments], newpair[:num_fragments]
    pidx = torch.cumsum(newpair, 0) - 1  # each slot's pair
    del newpair
    start = torch.searchsorted(pidx, torch.arange(num_pairs, device=dev))  # each pair's first slot
    csum = torch.cat([start, start.new_full((1,), num_fragments)]).int()
    ppk = pk[start]
    del pk
    pbounds = torch.searchsorted(ppk // num_faces, torch.arange(num_runs + 1, device=dev),
                                 out_int32=True)
    counts = pair_cut_counts(csum, pbounds, tb=tb, tbl=tbl)
    busy = counts > 0
    num_batches, least, num_busy = (int(v) for v in _read(sp, torch.stack(
        [counts.sum(), counts.min().long(), busy.sum()])))
    if least < 0:
        raise AssertionError("pair exceeds batch capacity")
    off = (torch.cumsum(counts, 0) - counts).int()
    batch_run, p0, _ = pair_cut(csum, pbounds, off, total=num_batches, tb=tb, tbl=tbl)
    p0 = p0.long()
    b_of_pair = torch.zeros(num_pairs, dtype=torch.int64, device=dev).scatter_(0, p0, 1)
    b_of_pair = torch.cumsum(b_of_pair, 0) - 1
    first = p0[b_of_pair[pidx]]  # each slot's batch's first pair
    flat = b_of_pair[pidx] * tb + torch.arange(num_fragments, device=dev) - start[first]
    cells_b = torch.full((num_batches * tb,), -1, dtype=torch.int32, device=dev)
    cells_b.scatter_(0, flat, local)
    tblidx_b = torch.zeros(num_batches * tb, dtype=torch.int32, device=dev)
    tblidx_b.scatter_(0, flat, (pidx - first).int())
    del flat, first, pidx, local
    tslot = b_of_pair * tbl + torch.arange(num_pairs, device=dev) - p0[b_of_pair]
    table_face = torch.full((num_batches * tbl,), -1, dtype=torch.int32, device=dev)
    table_face.scatter_(0, tslot, (ppk % num_faces).int())
    # The busy runs' first batches, then the batch total (a dump slot past it).
    at = torch.where(busy, torch.cumsum(busy, 0) - 1, num_busy + 1)
    run_start = torch.empty(num_busy + 2, dtype=torch.int32, device=dev).scatter_(0, at, off)
    run_start[num_busy] = num_batches
    return dict(out, counts=counts,
                cells_b=cells_b.view(num_batches, tb_sub, TB_LANE),
                tblidx_b=tblidx_b.view(num_batches, tb_sub, TB_LANE), batch_run=batch_run,
                table_face=table_face, run_start=run_start[:num_busy + 1])


class _ClassedLayout:
    """The static layout of an exact gather-based segment reduction
    (voxtpu's, `soft_vox_fused.py:495-524`) on the device, in the steps
    between its two host reads, which the caller makes (a plan's two
    layouts share them): the sources sorted by target (stable), each
    target's first source and count, and the largest count (`most`);
    the histogram of the counts; then the class tables (one gather a
    class) and `inv`. `tables` gives (cls_pos, inv): `cls_pos` a (c, Tc)
    table for the Tc targets with exactly c sources, listing their
    source rows; `inv` maps each target to its row in the concatenated
    per-class output (targets with no source to the appended zero row).
    Targets stay ascending within a class and sources in their stable
    order, so the tables are voxtpu's value for value (int64)."""

    def __init__(self, ids: torch.Tensor, num_targets: int):
        ids_sorted, self.order = torch.sort(ids, stable=True)
        self.starts = torch.searchsorted(
            ids_sorted, torch.arange(num_targets + 1, dtype=ids.dtype, device=ids.device))
        self.counts = self.starts.diff()
        self.most = torch.cat([self.counts, self.counts.new_zeros(1)]).amax().view(1)

    def histogram(self, most: int) -> torch.Tensor:
        """(most + 1,) int64 targets of each count."""
        return self.counts.new_zeros(most + 1).scatter_add_(
            0, self.counts, torch.ones_like(self.counts))

    def tables(self, hist: np.ndarray):
        """(cls_pos, inv) from the host copy of `histogram`."""
        num_targets = self.counts.shape[0]
        dev = self.counts.device
        by_count = torch.sort(self.counts, stable=True).indices
        zero = int(hist[0])
        cls_pos, at = [], zero
        for c in np.flatnonzero(hist[1:]) + 1:
            targets = by_count[at:at + int(hist[c])]
            cls_pos.append(self.order[self.starts[targets][None, :]
                                      + torch.arange(c, device=dev)[:, None]])
            at += int(hist[c])
        rank = torch.empty_like(by_count).scatter_(
            0, by_count, torch.arange(num_targets, device=dev) - zero)
        return tuple(cls_pos), torch.where(self.counts > 0, rank, num_targets - zero)


class TablePlan:
    """A slot layout (`cells_d`, `tblidx_d`, `batch_tile_d`) with its
    per-batch triangle tables (`fidx_d`) and the classed reductions
    behind `tables_of`, on `device`: what the fused and seg plans share,
    set up once, on the device, by `_setup_tables_d`.

    The host arrays keep voxtpu's names (`cells_b`, `tblidx_b`,
    `batch_tile`, `table_face_flat`, `tile_mask`, the classed tables
    `expand_cls`, `expand_inv`, `vert_cls`, `vert_inv`, and the seg
    plan's `batch_panel` and `run_start`): each is read from the device
    on first use (`_HOST_COPIES`)."""

    def _setup_tables_d(self, soft_plan, faces_d, cells_d, tblidx_d, batch_tile_d,
                        table_face_d, *, tc: int, tbl: int, sp):
        """The tables of a slot layout on the device: `cells_d`, `tblidx_d`
        (B, tb_sub, 128) int32, `batch_tile_d` (B,) int32, `table_face_d`
        (B * tbl,) int32 (-1 = no triangle) and the faces (T, 3) on the
        plan's device. Two host reads, counted on the span `sp`: both
        classed layouts' largest counts with the range checks' least and
        largest values and the batches out of tile order; the layouts'
        histograms."""
        spec = soft_plan.spec
        _check_fwd_smem(tc, cells_d[0].numel())
        self.spec = spec
        self.soft_plan = soft_plan
        self.tc, self.tbl = tc, tbl
        self.device = faces_d.device
        self.cells_d, self.tblidx_d, self.batch_tile_d = cells_d, tblidx_d, batch_tile_d
        self.tb_sub = cells_d.shape[1]
        self.num_batches = batch_tile_d.shape[0]
        self.num_faces = int(faces_d.shape[0])
        self.num_vertices = int(np.asarray(soft_plan.faces_array).max(initial=-1)) + 1
        self.fidx_d = torch.where(table_face_d < 0, self.num_faces, table_face_d).long()
        self.faces_d = faces_d.long()
        expand = _ClassedLayout(table_face_d, self.num_faces)
        vert = _ClassedLayout(self.faces_d.view(-1), self.num_vertices)
        checked = (("batch_tile", batch_tile_d, 0, (spec.n * spec.n) // tc),
                   ("tblidx_b", tblidx_d, 0, tbl), ("cells_b", cells_d, -1, tc))
        got = _read(sp, torch.cat([expand.most, vert.most] + [
            torch.stack(torch.aminmax(t)).long() for _, t, _, _ in checked] + [
            (batch_tile_d.diff() < 0).sum().view(1)]))
        for i, (name, _, lo, hi) in enumerate(checked):
            _check_range(got[2 + 2 * i:4 + 2 * i], name, lo, hi)
        if got[-1]:  # `tile_runs`' check: the forward kernels take one run a tile
            raise ValueError("batches are not grouped by tile")
        most_e, most_v = int(got[0]), int(got[1])
        hist = _read(sp, torch.cat([expand.histogram(most_e), vert.histogram(most_v)]))
        self.expand_cls_d, self.expand_inv_d = expand.tables(hist[:most_e + 1])
        self.vert_cls_d, self.vert_inv_d = vert.tables(hist[most_e + 1:])

    @classmethod
    def _on_layout(cls, soft_plan, device, cells_b, tblidx_b, batch_tile, table_face_flat,
                   tc: int):
        """A plan of `cls` on a given host slot layout, uploaded and set up
        as a built plan's tables are; the caller adds its runs."""
        plan = object.__new__(cls)
        dev = torch.empty(0, device=device).device
        cells_b = np.asarray(cells_b, np.int32)
        table_face = np.asarray(table_face_flat, np.int32).reshape(-1)
        up = [_upload(NULL_SPAN, a, dev, np.int32)
              for a in (soft_plan.faces_array, cells_b, tblidx_b, batch_tile, table_face)]
        plan._setup_tables_d(soft_plan, *up, tc=tc,
                             tbl=table_face.size // max(cells_b.shape[0], 1), sp=NULL_SPAN)
        plan.num_pairs = int((table_face >= 0).sum())
        plan.num_fragments = int((cells_b >= 0).sum())
        return plan

    def __getattr__(self, name):
        read = _HOST_COPIES.get(name)
        if read is None:
            raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")
        value = self.__dict__[name] = read(self)
        return value

    def prm(self, tau_edge_frac: float, tau_x_frac: float):
        """The kernels' float32 parameters (ox, oy, oz, vs, tau_e, tau_x)."""
        vs, tau_e, tau_x = temperatures(self.spec, tau_edge_frac, tau_x_frac)
        return tuple(f32(o) for o in self.spec.origin) + (vs, tau_e, tau_x)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# A plan's host arrays under voxtpu's names, each read from its device
# tensor on first use.
_HOST_COPIES = {
    "cells_b": lambda p: _host(p.cells_d),
    "tblidx_b": lambda p: _host(p.tblidx_d),
    "batch_tile": lambda p: _host(p.batch_tile_d),
    "table_face_flat": lambda p: np.where(_host(p.fidx_d) == p.num_faces, -1,
                                          _host(p.fidx_d)).astype(np.int32),
    "tile_mask": lambda p: _host(p.tile_mask_d),
    "expand_cls": lambda p: tuple(_host(c).astype(np.int32) for c in p.expand_cls_d),
    "expand_inv": lambda p: _host(p.expand_inv_d).astype(np.int32),
    "vert_cls": lambda p: tuple(_host(c).astype(np.int32) for c in p.vert_cls_d),
    "vert_inv": lambda p: _host(p.vert_inv_d).astype(np.int32),
    "batch_panel": lambda p: _host(p.batch_panel_d),
    "run_start": lambda p: _host(p.run_start_d),
}


class FusedSoftPlan(TablePlan):
    """Static (tile, triangle) batch layout and per-batch triangle
    tables of one soft plan, on `device` (`soft_vox_fused.py:699-796`).

    Fragments (candidate cells) are ordered by (tile, face, cell);
    batches are greedy cuts within the slot budget (tb_sub * 128) and
    the triangle budget (tbl). The tensors the per-call path reads end
    in ``_d``. The plan is built on `device` (the module's note): the
    phases are the spans ``soft.engine_plan.cells`` (the upload, the
    slot keys and their sort), ``.cut`` (the pairs, C2, the slot
    scatters; counts `batches`) and ``.tables`` (the classed layouts),
    each counting its `host_bytes` and `syncs`."""

    def __init__(self, soft_plan, device, tc: int = TILE_CELLS,
                 tb_sub: int = 4, tbl: int = 128):
        n = soft_plan.spec.n
        if (n * n) % tc != 0:
            raise ValueError("n*n must divide tile cells")
        _check_fwd_smem(tc, tb_sub * TB_LANE)
        dev = torch.empty(0, device=device).device
        with span("soft.engine_plan.cells", dev) as sp:
            faces_d = _upload(sp, soft_plan.faces_array, dev, np.int32)
            key = slot_keys(soft_plan, lambda cell, face: cell // tc, tc=tc, sp=sp,
                            device=dev)
        with span("soft.engine_plan.cut", dev) as sp:
            cut = cut_pairs(key, num_runs=(n * n) // tc, num_faces=faces_d.shape[0],
                            tc=tc, tb_sub=tb_sub, tbl=tbl, sp=sp)
            del key
            sp.count("batches", cut["batch_run"].shape[0])
        with span("soft.engine_plan.tables", dev) as sp:
            self._setup_tables_d(soft_plan, faces_d, cut["cells_b"], cut["tblidx_b"],
                                 cut["batch_run"], cut["table_face"], tc=tc, tbl=tbl, sp=sp)
        self.tile_mask_d = cut["counts"] > 0
        self.run_start_d = cut["run_start"]
        self.num_pairs = cut["num_pairs"]
        self.num_fragments = cut["num_fragments"]

    @classmethod
    def from_layout(cls, soft_plan, device, cells_b, tblidx_b, batch_tile,
                    table_face_flat, tc: int = TILE_CELLS):
        """A plan on a given slot layout (voxtpu's, in the tests)."""
        plan = cls._on_layout(soft_plan, device, cells_b, tblidx_b, batch_tile,
                              table_face_flat, tc)
        n = soft_plan.spec.n
        live = (plan.cells_d >= 0).flatten(1).any(1)
        plan.tile_mask_d = torch.zeros((n * n) // tc, dtype=torch.int32,
                                       device=plan.device).index_add_(
            0, plan.batch_tile_d.long(), live.int()) > 0
        plan.run_start_d = _upload(NULL_SPAN, tile_runs(batch_tile), plan.device)
        return plan


def tables_of(coords: torch.Tensor, plan: TablePlan) -> torch.Tensor:
    """(B, tbl, 16) coefficient tables of `coords`, differentiable."""
    tri = _GatherTri.apply(coords, plan)                     # (T, 3, 3)
    coeffs = triangle_coeffs(tri)                            # (T, 16)
    coeffs = torch.cat([coeffs, coeffs.new_zeros((1, NATTR))])
    tables = _ExpandRows.apply(coeffs, plan)
    return tables.view(plan.num_batches, plan.tbl, NATTR)


def soft_voxelize_fused(coords: torch.Tensor, plan: FusedSoftPlan, *,
                        tau_edge_frac: float = 0.25, tau_x_frac: float = 0.5,
                        clip: bool = True) -> torch.Tensor:
    """Differentiable occupancy through the fused engine
    (`soft_vox_fused.py:823-869`). Same semantics as
    `soft_vox.soft_voxelize`; x_hit distributes the 1/A division, so the
    two agree to float32 rounding, not bit for bit."""
    tables = tables_of(coords, plan)
    occ = _FusedAccumulate.apply(tables, plan,
                                 plan.prm(tau_edge_frac, tau_x_frac))
    return clip01(occ) if clip else occ
