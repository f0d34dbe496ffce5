"""Per-fragment soft voxelizer — the ``"cuda"`` engine (kernels B13).

Port of `voxtpu/ops/soft_vox_pallas.py`. Per call, `soft_fragments`
(the plain engine's torch ops) computes every candidate cell's weight w
and x-hit; a static permutation lays them out in tile batches of
(tb_sub, 128) slots, and

- B13 fwd (`fragment_fwd`, `csrc/soft_vox.cu::vt_fragment_fwd`,
  replaces `_fwd_kernel`) sums w * sigmoid((x_hit - cx) / tau_x) per
  cell: a record pass writes each slot's (cell, w, x_hit) and its
  transition window, the columns where the sigmoid is neither exactly 1
  nor a term that rounds to 0, and B7's windowed accumulation adds the
  saturated columns as exact carries and the window's terms in 64-bit
  fixed point, bitwise the full row's sums;
- B13 bwd (`fragment_bwd`, `vt_fragment_bwd`, replaces `_bwd_kernel`)
  takes the occupancy cotangent to per-slot (dw, dx_hit): B8's float64
  row prefix of g gives the saturated columns' sum, and 8 lanes a slot
  sum its window (B8's window sums, without the chain rule).

Both evaluate ~23 sigmoids a slot at tau_x of half a voxel, not n: the
window pairs and their shared-memory adds bound them, with the record
pass and the prefix's bytes beside (`chip_smoke.py` prints the bound).
The wrappers allocate the kernels' scratch: 16 bytes of record a slot
for the forward, the (n*n, n) float64 prefix for the backward.

voxtpu writes the permutation as two sorts (TPU sorts beat its gathers
and scatters); here it is one index gather each way (`_Permute`): the
forward by each slot's source fragment, the backward by each fragment's
slot. Beside each kernel is its plain torch version
(`fragment_fwd_plain`, `fragment_bwd_plain`); a wrapper takes it for
CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.ops.soft_vox import (clip01, f32, profile_add, profile_grid,
                                       profile_out, profile_sums, soft_fragments,
                                       temperatures, x_centers)
from voxtpu_torch.ops.soft_vox_fused import (_check_fwd_smem, slot_cells,
                                             tile_runs)
from voxtpu_torch.ops.vox_cuda import (TB_LANE, TILE_CELLS, _check_range,
                                       tile_batches)


def _slot_rows(cells_b, batch_tile, *, n: int, tc: int) -> torch.Tensor:
    """Flat output row of every slot, n*n for a pad slot."""
    cells = cells_b.reshape(cells_b.shape[0], -1).long()
    valid = (cells >= 0) & (cells < tc)
    rows = batch_tile.long()[:, None] * tc + cells
    return torch.where(valid, rows, n * n).reshape(-1)


def fragment_fwd_plain(wb, xb, cells_b, batch_tile, *, n: int, tc: int,
                       prm) -> torch.Tensor:
    """Plain torch version of B13 fwd (any device), in chunks."""
    ox, vs, tau_x = prm
    out = profile_out(n, wb.device)
    profile_add(out, _slot_rows(cells_b, batch_tile, n=n, tc=tc),
                wb.reshape(-1), xb.reshape(-1), x_centers(n, ox, vs, wb.device),
                tau_x)
    return profile_grid(out, n)


def fragment_bwd_plain(wb, xb, cells_b, batch_tile, g, *, n: int, tc: int,
                       prm):
    """Plain torch version of B13 bwd (any device): (dw, dx_hit), each
    shaped like `wb`."""
    ox, vs, tau_x = prm
    g_ext = torch.cat([g.reshape(n * n, n), g.new_zeros((1, n))])
    sa, sb = profile_sums(g_ext, _slot_rows(cells_b, batch_tile, n=n, tc=tc),
                          xb.reshape(-1), x_centers(n, ox, vs, wb.device), tau_x)
    return sa.view_as(wb), ((wb.reshape(-1) / tau_x) * sb).view_as(wb)


def _check_slots(wb, xb, cells_b, batch_tile):
    _build.expect(cells_b, "cells_b", torch.int32, (None, None, TB_LANE))
    _build.expect(wb, "wb", torch.float32, tuple(cells_b.shape))
    _build.expect(xb, "xb", torch.float32, tuple(cells_b.shape))
    _build.expect(batch_tile, "batch_tile", torch.int32, (cells_b.shape[0],))


def fragment_fwd(wb, xb, cells_b, batch_tile, run_start, *, n: int, tc: int,
                 prm) -> torch.Tensor:
    """B13 fwd: per-slot weights and x-hits (B, tb_sub, 128) -> (n, n, n)
    occupancy, unclipped. `cells_b` local cells (-1 = pad), batches of a
    tile in one run, `run_start` (R + 1,) int32 the runs' bounds; `prm`
    = (ox, vs, tau_x) float32 values. A CPU tensor takes the plain
    version, a CUDA tensor launches `vt_fragment_fwd`."""
    _check_slots(wb, xb, cells_b, batch_tile)
    if not _build.on_cuda(wb, xb, cells_b, batch_tile, run_start):
        return fragment_fwd_plain(wb, xb, cells_b, batch_tile, n=n, tc=tc,
                                  prm=prm)
    _build.expect(run_start, "run_start", torch.int32)
    tb = cells_b[0].numel()
    _check_fwd_smem(tc, tb)
    out = torch.zeros((n, n, n), dtype=torch.float32, device=wb.device)
    num_runs = run_start.numel() - 1
    if num_runs > 0:
        # one int4 record per slot: local cell, w, x_hit, window
        work = torch.empty((cells_b.numel(), 4), dtype=torch.int32, device=out.device)
        _build.launch("vt_fragment_fwd", wb.data_ptr(), xb.data_ptr(),
                      cells_b.data_ptr(), batch_tile.data_ptr(),
                      run_start.data_ptr(), cells_b.shape[0], num_runs, tb, n, tc,
                      (n * n) // tc, *prm, work.data_ptr(), out.data_ptr(),
                      _build.stream_of(out))
        fragment_fwd.launches += 1
    return out


fragment_fwd.launches = 0


def fragment_bwd(wb, xb, cells_b, batch_tile, g, *, n: int, tc: int, prm):
    """B13 bwd: occupancy cotangent g (n, n, n) -> (dw, dx_hit), each
    (B, tb_sub, 128). A CPU tensor takes the plain version, a CUDA
    tensor launches `vt_fragment_bwd`."""
    _check_slots(wb, xb, cells_b, batch_tile)
    _build.expect(g, "g", torch.float32, (n, n, n))
    if not _build.on_cuda(wb, xb, cells_b, batch_tile, g):
        return fragment_bwd_plain(wb, xb, cells_b, batch_tile, g, n=n, tc=tc,
                                  prm=prm)
    dw = torch.zeros_like(wb)
    dx = torch.zeros_like(xb)
    if cells_b.shape[0]:
        pre = torch.empty((n * n, n), dtype=torch.float64, device=g.device)  # row prefix
        _build.launch("vt_fragment_bwd", wb.data_ptr(), xb.data_ptr(),
                      cells_b.data_ptr(), batch_tile.data_ptr(), g.data_ptr(),
                      cells_b.shape[0], cells_b[0].numel(), n, tc,
                      (n * n) // tc, *prm, pre.data_ptr(), dw.data_ptr(),
                      dx.data_ptr(), _build.stream_of(dw))
        fragment_bwd.launches += 1
    return dw, dx


fragment_bwd.launches = 0


class _Permute(torch.autograd.Function):
    """(F,) fragment w and x_hit -> (B, tb_sub, 128) slots: a gather by
    each slot's source fragment (F = the appended zero for a pad slot);
    the backward gathers by each fragment's slot (nslots = the appended
    zero for a fragment outside the grid)."""

    @staticmethod
    def forward(ctx, w, x, plan):
        ctx.plan = plan
        shape = plan.cells_d.shape

        def gather(v):
            return torch.cat([v, v.new_zeros(1)])[plan.slot_src_d].view(shape)

        return gather(w), gather(x)

    @staticmethod
    def backward(ctx, dwb, dxb):
        rank = ctx.plan.rank_d

        def gather(d):
            return torch.cat([d.reshape(-1), d.new_zeros(1)])[rank]

        return gather(dwb), gather(dxb), None


class _FragmentAccumulate(torch.autograd.Function):
    """(B, tb_sub, 128) slot (w, x_hit) -> (n, n, n) occupancy: forward
    B13 fwd, backward B13 bwd."""

    @staticmethod
    def forward(ctx, wb, xb, plan, prm):
        ctx.plan, ctx.prm = plan, prm
        ctx.save_for_backward(wb, xb)
        return fragment_fwd(wb, xb, plan.cells_d, plan.batch_tile_d,
                            plan.run_start_d, n=plan.spec.n, tc=plan.tc, prm=prm)

    @staticmethod
    def backward(ctx, g):
        wb, xb = ctx.saved_tensors
        plan = ctx.plan
        dw, dx = fragment_bwd(wb, xb, plan.cells_d, plan.batch_tile_d,
                              g.contiguous(), n=plan.spec.n, tc=plan.tc,
                              prm=ctx.prm)
        return dw, dx, None, None


class SoftCudaPlan:
    """Static batch layout of one soft plan for the per-fragment engine,
    on `device` (`soft_vox_pallas.py:278-389`).

    Fragment cells are a function of the integer raster windows, so the
    sort by cell, the tile batches and the slot <-> fragment maps are
    built once on the host: `cells_b` (B, tb_sub, 128) local cells,
    `batch_tile` (B,), `slot_src` (B * tb,) the source fragment of every
    slot (F = pad), `rank` (F,) the slot of every fragment (B * tb =
    outside the grid)."""

    def __init__(self, soft_plan, device, tc: int = TILE_CELLS,
                 tb_sub: int = 4):
        n = soft_plan.spec.n
        if (n * n) % tc != 0:
            raise ValueError("n*n must divide tile cells")
        tb = tb_sub * TB_LANE
        cells, _ = slot_cells(soft_plan, n)
        total = cells.size
        cells = np.where(cells < 0, n * n, cells)
        order = np.argsort(cells, kind="stable")
        cells_sorted = cells[order]
        valid = int(np.searchsorted(cells_sorted, n * n))
        order, cells_sorted = order[:valid], cells_sorted[:valid]
        num_tiles = (n * n) // tc
        bounds = np.searchsorted(cells_sorted // tc, np.arange(num_tiles + 1))
        batch_tiles, starts, ends = tile_batches(bounds, tb)
        idx = starts[:, None] + np.arange(tb)
        live = idx < ends[:, None]
        idx_c = np.clip(idx, 0, max(valid - 1, 0))
        cells_b = np.where(live, cells_sorted[idx_c] % tc if valid else 0, -1)
        slot_src = np.where(live, order[idx_c] if valid else 0, total)
        self._setup(soft_plan, device, tc, cells_b.reshape(-1, tb_sub, TB_LANE),
                    batch_tiles, slot_src.reshape(-1))

    @classmethod
    def from_layout(cls, soft_plan, device, cells_b, batch_tile, slot_src,
                    tc: int = TILE_CELLS):
        """A plan on a given slot layout (voxtpu's, in the tests)."""
        plan = object.__new__(cls)
        plan._setup(soft_plan, device, tc, cells_b, batch_tile, slot_src)
        return plan

    def _setup(self, soft_plan, device, tc, cells_b, batch_tile, slot_src):
        spec = soft_plan.spec
        self.spec = spec
        self.soft_plan = soft_plan
        self.tc = tc
        self.cells_b = np.asarray(cells_b, np.int32)
        self.tb_sub = self.cells_b.shape[1]
        self.batch_tile = np.asarray(batch_tile, np.int32)
        self.num_batches = self.batch_tile.shape[0]
        self.slot_src = np.asarray(slot_src, np.int64)
        total = soft_plan.num_fragments  # every bucket's rows x window^2
        self.num_fragments_total = total
        _check_range(self.batch_tile, "batch_tile", 0, (spec.n * spec.n) // tc)
        _check_range(self.cells_b, "cells_b", -1, tc)
        _check_range(self.slot_src, "slot_src", 0, total + 1)
        _check_fwd_smem(tc, self.cells_b[0].size)
        real = self.slot_src < total
        self.num_fragments = int(real.sum())
        rank = np.full(total, self.slot_src.size, np.int64)
        rank[self.slot_src[real]] = np.nonzero(real)[0]

        dev = torch.empty(0, device=device).device
        self.device = dev

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.cells_d = t(self.cells_b, torch.int32)
        self.batch_tile_d = t(self.batch_tile, torch.int32)
        self.run_start_d = t(tile_runs(self.batch_tile), torch.int32)
        self.slot_src_d = t(self.slot_src, torch.int64)
        self.rank_d = t(rank, torch.int64)


def soft_voxelize_cuda(coords: torch.Tensor, plan: SoftCudaPlan, *,
                       tau_edge_frac: float = 0.25, tau_x_frac: float = 0.5,
                       clip: bool = True) -> torch.Tensor:
    """Differentiable occupancy through the per-fragment engine
    (`soft_vox_pallas.py:392-430`): the plain engine's fragments, summed
    by B13. Same semantics as `soft_vox.soft_voxelize`."""
    spec = plan.spec
    vs, _, tau_x = temperatures(spec, tau_edge_frac, tau_x_frac)
    _, w, x = soft_fragments(coords, plan.soft_plan, tau_edge_frac=tau_edge_frac,
                             tau_x_frac=tau_x_frac)
    if w.numel() != plan.num_fragments_total:  # the zero-face sentinel
        w, x = w[:0], x[:0]
    wb, xb = _Permute.apply(w, x, plan)
    occ = _FragmentAccumulate.apply(wb, xb, plan, (f32(spec.origin[0]), vs, tau_x))
    return clip01(occ) if clip else occ
