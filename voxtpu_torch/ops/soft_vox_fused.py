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

Two gather-only "classed" reductions (`_build_classed_reduction`,
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
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.ops.soft_vox import (CHUNK_ELEMS, clip01, f32, profile_add,
                                       profile_grid, profile_out, profile_sums,
                                       temperatures, x_centers)
from voxtpu_torch.ops.vox_cuda import TB_LANE, TILE_CELLS, _check_range

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
    dtab = torch.zeros((num_batches * tbl + 1, NGRAD), dtype=torch.float32,
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


def fwd_smem_bytes(tc: int, tb: int) -> int:
    """B7 / B13 fwd shared memory: the (tc, 64) 64-bit fixed-point
    accumulator, three staged 4-byte values per slot and a bit per
    (cell, column) for non-finite terms."""
    return tc * _XC * 8 + 3 * tb * 4 + (tc + 31) // 32 * _XC * 4


def _check_fwd_smem(tc: int, tb: int) -> None:
    if fwd_smem_bytes(tc, tb) > _SMEM_MAX:
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
        _build.launch("vt_fused_fwd", tables.data_ptr(), cells_b.data_ptr(),
                      tblidx_b.data_ptr(), batch_tile.data_ptr(),
                      run_start.data_ptr(), num_runs, tb, tables.shape[1], n,
                      tc, (n * n) // tc, *prm, out.data_ptr(),
                      _build.stream_of(out))
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
        _build.launch("vt_fused_bwd", tables.data_ptr(), cells_b.data_ptr(),
                      tblidx_b.data_ptr(), batch_tile.data_ptr(), g.data_ptr(),
                      num_batches, cells_b[0].numel(), tbl, n, tc,
                      (n * n) // tc, *prm, dtab.data_ptr(),
                      _build.stream_of(dtab))
        fused_bwd.launches += 1
    return dtab


fused_bwd.launches = 0


# ---------------------------------------------------------------------------
# Gather-only reductions and the autograd Functions
# ---------------------------------------------------------------------------


def _build_classed_reduction(item_ids: np.ndarray, num_targets: int):
    """Static layout for an exact gather-based segment reduction
    (`soft_vox_fused.py:495-524`).

    item_ids (S,): target id per source row (< 0 = contributes nowhere).
    Returns (cls_pos, inv): `cls_pos` a tuple of (c, Tc) int32 position
    tables — the Tc targets with exactly c sources, listing their source
    rows; `inv` (num_targets,) int32 maps each target to its row in the
    concatenated per-class output (targets with no source map to the
    appended zero row)."""
    item_ids = np.asarray(item_ids)
    order = np.argsort(item_ids, kind="stable")
    ids_sorted = item_ids[order]
    v0 = int(np.searchsorted(ids_sorted, 0))
    vo = order[v0:].astype(np.int64)
    vi = ids_sorted[v0:]
    starts = np.searchsorted(vi, np.arange(num_targets + 1))
    counts = np.diff(starts)
    cls_pos, targ_order = [], []
    for c in sorted(set(counts[counts > 0].tolist())):
        t_c = np.nonzero(counts == c)[0]
        pos = np.empty((c, t_c.size), np.int32)
        for j in range(c):
            pos[j] = vo[starts[t_c] + j]
        cls_pos.append(pos)
        targ_order.append(t_c)
    nonzero = (np.concatenate(targ_order) if targ_order
               else np.zeros(0, np.int64))
    inv = np.full(num_targets, nonzero.size, np.int32)  # -> zero row
    inv[nonzero] = np.arange(nonzero.size, dtype=np.int32)
    return tuple(cls_pos), inv


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
# Plan (static host layout) and entry point
# ---------------------------------------------------------------------------


def _cut_batches(run_key, faces, local, *, tb_sub: int, tbl: int):
    """Greedy batch layout (`soft_vox_fused.py:596-696`, without the
    FIRST/LAST flags of the TPU's sequential grid).

    Per-slot inputs are pre-sorted by (run_key, faces): batches never
    span two keys and hold <= tb_sub * 128 slots and <= tbl unique
    triangles (pairs = unique (run_key, face) runs = table rows).
    Returns dict(batch_key, nonempty, cells_b, tblidx_b, table_face,
    num_pairs)."""
    tb = tb_sub * TB_LANE
    f_total = run_key.shape[0]
    if f_total:
        newpair = np.empty(f_total, bool)
        newpair[0] = True
        newpair[1:] = (run_key[1:] != run_key[:-1]) | (faces[1:] != faces[:-1])
        pair_start = np.nonzero(newpair)[0]
        pair_end = np.append(pair_start[1:], f_total)
        pair_run = run_key[pair_start]
        pair_face = faces[pair_start]
        pair_size = pair_end - pair_start
    else:
        newpair = np.zeros((0,), bool)
        pair_start = pair_end = pair_run = pair_face = pair_size = (
            np.zeros((0,), np.int64))
    num_pairs = pair_start.size

    if num_pairs:
        run_starts = np.nonzero(
            np.concatenate([[True], pair_run[1:] != pair_run[:-1]]))[0]
        run_ends = np.append(run_starts[1:], num_pairs)
        run_k = pair_run[run_starts]
        csum = np.concatenate([[0], np.cumsum(pair_size)])
        cur = run_starts.copy()
        bk_l, p0_l, p1_l = [], [], []
        open_m = cur < run_ends
        while open_m.any():
            c = cur[open_m]
            j_slots = np.searchsorted(csum, csum[c] + tb, side="right") - 1
            j = np.minimum(np.minimum(j_slots, c + tbl), run_ends[open_m])
            if not (j > c).all():
                raise AssertionError("pair exceeds batch capacity")
            bk_l.append(run_k[open_m])
            p0_l.append(c)
            p1_l.append(j)
            cur[open_m] = j
            open_m = cur < run_ends
        batch_p0 = np.concatenate(p0_l)
        batch_p1 = np.concatenate(p1_l)
        batch_key = np.concatenate(bk_l)
        order_b = np.argsort(batch_p0, kind="stable")
        batch_p0 = batch_p0[order_b]
        batch_p1 = batch_p1[order_b]
        batch_key = batch_key[order_b]
    else:
        batch_p0 = batch_p1 = np.zeros((1,), np.int64)
        batch_key = np.zeros((1,), run_key.dtype)
    bcount = batch_p0.size

    cells_b = np.full((bcount, tb), -1, np.int32)
    tblidx_b = np.zeros((bcount, tb), np.int32)
    table_face = np.full((bcount, tbl), -1, np.int32)
    if f_total:
        pidx = np.cumsum(newpair, dtype=np.int32) - 1  # pair id per slot
        b_of_pair = np.searchsorted(batch_p0, np.arange(num_pairs),
                                    side="right") - 1
        fb = b_of_pair[pidx]
        fstart_b = pair_start[batch_p0]
        slot = np.arange(f_total) - fstart_b[fb]
        cells_b[fb, slot] = local
        tblidx_b[fb, slot] = (pidx - batch_p0[fb]).astype(np.int32)
        tslot = np.arange(num_pairs) - batch_p0[b_of_pair]
        table_face[b_of_pair, tslot] = pair_face
    return dict(
        batch_key=batch_key,
        nonempty=batch_p1 > batch_p0,
        cells_b=cells_b.reshape(bcount, tb_sub, TB_LANE),
        tblidx_b=tblidx_b.reshape(bcount, tb_sub, TB_LANE),
        table_face=table_face,
        num_pairs=int(num_pairs),
    )


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


class TablePlan:
    """A slot layout (`cells_b`, `tblidx_b`, `batch_tile`) with its
    per-batch triangle tables (`table_face_flat`) and the classed
    reductions behind `tables_of`, on `device`: what the fused and seg
    plans share."""

    def _setup_tables(self, soft_plan, device, tc, tbl, cells_b, tblidx_b,
                      batch_tile, table_face_flat):
        spec = soft_plan.spec
        self.spec = spec
        self.soft_plan = soft_plan
        self.tc, self.tbl = tc, tbl
        self.cells_b = np.asarray(cells_b, np.int32)
        self.tb_sub = self.cells_b.shape[1]
        self.tblidx_b = np.asarray(tblidx_b, np.int32)
        self.batch_tile = np.asarray(batch_tile, np.int32)
        self.num_batches = self.batch_tile.shape[0]
        self.table_face_flat = np.asarray(table_face_flat, np.int32)
        faces = np.asarray(soft_plan.faces_array)
        self.num_faces = int(faces.shape[0])
        _check_range(self.batch_tile, "batch_tile", 0, (spec.n * spec.n) // tc)
        _check_range(self.tblidx_b, "tblidx_b", 0, tbl)
        _check_range(self.cells_b, "cells_b", -1, tc)
        _check_fwd_smem(tc, self.cells_b[0].size)

        # Classed slot -> face reduction (expand backward) and classed
        # (face, corner) -> vertex reduction (coords backward).
        self.expand_cls, self.expand_inv = _build_classed_reduction(
            self.table_face_flat, self.num_faces)
        faces_flat = faces.reshape(-1)
        self.num_vertices = int(faces_flat.max(initial=-1)) + 1
        self.vert_cls, self.vert_inv = _build_classed_reduction(
            faces_flat, self.num_vertices)

        dev = torch.empty(0, device=device).device
        self.device = dev
        fidx = np.where(self.table_face_flat < 0, self.num_faces,
                        self.table_face_flat)
        self.cells_d = self._to_device(self.cells_b, torch.int32)
        self.tblidx_d = self._to_device(self.tblidx_b, torch.int32)
        self.batch_tile_d = self._to_device(self.batch_tile, torch.int32)
        self.fidx_d = self._to_device(fidx, torch.int64)
        self.faces_d = self._to_device(faces, torch.int64)
        self.expand_cls_d = tuple(self._to_device(p, torch.int64)
                                  for p in self.expand_cls)
        self.expand_inv_d = self._to_device(self.expand_inv, torch.int64)
        self.vert_cls_d = tuple(self._to_device(p, torch.int64) for p in self.vert_cls)
        self.vert_inv_d = self._to_device(self.vert_inv, torch.int64)

    def _to_device(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    def prm(self, tau_edge_frac: float, tau_x_frac: float):
        """The kernels' float32 parameters (ox, oy, oz, vs, tau_e, tau_x)."""
        vs, tau_e, tau_x = temperatures(self.spec, tau_edge_frac, tau_x_frac)
        return tuple(f32(o) for o in self.spec.origin) + (vs, tau_e, tau_x)


class FusedSoftPlan(TablePlan):
    """Static (tile, triangle) batch layout and per-batch triangle
    tables of one soft plan, on `device` (`soft_vox_fused.py:699-796`).

    Fragments (candidate cells) are ordered by (tile, face, cell);
    batches are greedy cuts within the slot budget (tb_sub * 128) and
    the triangle budget (tbl). Host arrays keep voxtpu's names
    (`cells_b`, `tblidx_b`, `batch_tile`, `tile_mask`,
    `table_face_flat`, the classed-reduction tables); the tensors the
    per-call path reads end in ``_d``."""

    def __init__(self, soft_plan, device, tc: int = TILE_CELLS,
                 tb_sub: int = 4, tbl: int = 128):
        n = soft_plan.spec.n
        if (n * n) % tc != 0:
            raise ValueError("n*n must divide tile cells")
        cells, faces = slot_cells(soft_plan, n)
        keep = cells >= 0
        cells = cells[keep]
        faces = faces[keep].astype(np.int32)
        tile = cells // tc
        order = np.lexsort((cells, faces, tile))
        cells, faces, tile = cells[order], faces[order], tile[order]
        cut = _cut_batches(tile, faces, (cells % tc).astype(np.int32),
                           tb_sub=tb_sub, tbl=tbl)
        batch_tile = cut["batch_key"].astype(np.int32)
        tile_mask = np.zeros((n * n) // tc, bool)
        if cells.size:
            tile_mask[batch_tile[cut["nonempty"]]] = True
        self._setup(soft_plan, device, tc, tbl, cut["cells_b"], cut["tblidx_b"],
                    batch_tile, cut["table_face"].reshape(-1), tile_mask)
        self.num_pairs = cut["num_pairs"]
        self.num_fragments = int(cells.size)

    @classmethod
    def from_layout(cls, soft_plan, device, cells_b, tblidx_b, batch_tile,
                    table_face_flat, tc: int = TILE_CELLS):
        """A plan on a given slot layout (voxtpu's, in the tests)."""
        plan = object.__new__(cls)
        cells_b = np.asarray(cells_b, np.int32)
        tbl = np.asarray(table_face_flat).size // max(cells_b.shape[0], 1)
        n = soft_plan.spec.n
        tile_mask = np.zeros((n * n) // tc, bool)
        live = (cells_b >= 0).reshape(cells_b.shape[0], -1).any(1)
        tile_mask[np.asarray(batch_tile)[live]] = True
        plan._setup(soft_plan, device, tc, tbl, cells_b, tblidx_b, batch_tile,
                    table_face_flat, tile_mask)
        plan.num_pairs = int((np.asarray(table_face_flat) >= 0).sum())
        plan.num_fragments = int((cells_b >= 0).sum())
        return plan

    def _setup(self, soft_plan, device, tc, tbl, cells_b, tblidx_b,
               batch_tile, table_face_flat, tile_mask):
        self._setup_tables(soft_plan, device, tc, tbl, cells_b, tblidx_b,
                           batch_tile, table_face_flat)
        self.tile_mask = tile_mask
        self.run_start_d = self._to_device(tile_runs(self.batch_tile), torch.int32)


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
