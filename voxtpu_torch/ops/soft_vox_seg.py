"""Segmented soft voxelizer — the ``"seg"`` engine: x-panels instead of
full x-rows.

Port of `voxtpu/ops/soft_vox_seg.py`. The fused engine
(`ops/soft_vox_fused.py`) evaluates every slot's x profile
``w * sigmoid((x_hit - cx) / tau_x)`` over all n columns. At tau_x up to
MARGIN / 17 voxels the sigmoid is exactly 1.0 in float32 more than
MARGIN columns left of x_hit and below 1e-28 more than MARGIN columns
right of it. So each slot gets, from its x_hit at plan time, a
PANEL-column panel on a LATTICE-column lattice with x_hit at least
MARGIN columns inside both edges; the profile is evaluated on the panel
only, the columns left of it receive the slot's weight whole (a carry)
and those right of it nothing:

- B9 (`seg_fwd`, `csrc/soft_vox_seg.cu::vt_seg_fwd`, replaces
  `_seg_fwd_kernel`) sums each (tile, panel) run's profiles into one
  PANEL-column block and its weights into a carry per (tile, 64-column
  group, cell). Panels starting at 128k (family A) and at 128k + 64
  (family B) go to two arrays of 128-column blocks.
- B10 (`seg_combine`, `vt_seg_combine`, replaces `_seg_combine_kernel`)
  folds A, B shifted by 64 columns and the carries' reverse-exclusive
  prefix into the dense grid.
- B11 (`seg_bwd`, `vt_seg_bwd`, replaces `_seg_bwd_kernel`) takes the
  cotangent over each slot's panel plus the exclusive prefix of the
  cotangent left of it (`seg_gpre`) to the 13 coefficient cotangents and
  sums them per table row, as B8 does.

Tiles are square tz x ty YZ patches (default 8 x 16), not the fused
engine's 1 x 128 strips: tile t holds the cells (z, y) with t =
(z // tz) * (n // ty) + y // ty, local cell (z % tz) * ty + y % ty.
The tables are the fused engine's (`tables_of`, the same classed
reductions). voxtpu's TPU-only parts have no counterpart: bf16_3x and
int8 byte-plane MXU dots, the FIRST/LAST flags of its sequential grid,
the visited-block masks (its own comment calls them redundant) and the
16-major table transposes. The panel arrays drop voxtpu's trash block.

The panel decomposition holds while every x_hit stays MARGIN - 17 *
tau_x_frac voxels inside its panel: `soft_voxelize_seg` refuses wider
profiles and `VoxelFit` rebuilds the plan when `xhit_drift_vox` says an
x_hit moved too far.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.ops.soft_vox import CHUNK_ELEMS, clip01
from voxtpu_torch.ops.soft_vox_fused import (_SMEM_MAX, TablePlan, _check_fused,
                                             _cut_batches, chain_rule, fwd_smem_bytes,
                                             slot_cells, slot_fragment, slot_rows,
                                             table_add, table_grid, tables_of,
                                             tile_runs)
from voxtpu_torch.ops.vox_cuda import _check_range

PANEL = 128          # sigmoid panel width (columns)
LATTICE = 64         # panel placement granularity
MARGIN = 32          # least distance of x_hit to a panel edge (voxels)


def _xplane(coords_np: np.ndarray, faces_np: np.ndarray):
    """Per-face x-hit plane (P, Q, R) and raw A = cross()[0] — the host
    mirror of `triangle_coeffs` rows 9..11 (`soft_vox_seg.py:580-589`)."""
    tri = coords_np[faces_np]
    a, b3, c3 = tri[:, 0], tri[:, 1], tri[:, 2]
    cr = np.cross(b3 - a, c3 - a).astype(np.float32)
    ca, cb, cc = cr[:, 0], cr[:, 1], cr[:, 2]
    cd = ca * a[:, 0] + cb * a[:, 1] + cc * a[:, 2]
    safe = np.where(np.abs(ca) < 1e-20, np.float32(1e-20), ca)
    return cd / safe, cb / safe, cc / safe, ca


def _host(coords) -> np.ndarray:
    if isinstance(coords, torch.Tensor):
        coords = coords.detach().cpu().numpy()
    return np.asarray(coords, np.float32)


def _decode_yz(tile, cells, *, n: int, tc: int, tz: int):
    """Square-tile decode: (tile, local cell) -> global (y, z)."""
    ty = tc // tz
    tyn = n // ty
    return (tile % tyn) * ty + cells % ty, (tile // tyn) * tz + cells // ty


def _check_geometry(n: int, tc: int, tz: int) -> None:
    if n < 2 * PANEL or n % PANEL:
        raise ValueError(
            f"segmented engine needs n >= {2 * PANEL} and n % {PANEL} == 0 "
            f"(got {n}); use soft_voxelize_fused below that")
    if n > 4096:
        raise ValueError(
            f"segmented engine caps at n = 4096 (got {n}): the int32 "
            f"(tile, panel) run key tile*n + p0 < n^3/tc reaches 2^32 at 8192")
    if tc % tz or n % tz or n % (tc // tz):
        raise ValueError(f"tz={tz} must divide tc={tc} and n={n}")


# ---------------------------------------------------------------------------
# Plain versions and kernel wrappers
# ---------------------------------------------------------------------------


def _seg_chunks(num_batches: int, tb: int):
    step = max(1, CHUNK_ELEMS // (tb * PANEL))
    for b0 in range(0, num_batches, step):
        yield b0, min(num_batches, b0 + step)


def _seg_slots(tables, cells_b, tblidx_b, batch_tile, batch_panel, b0, b1, *,
               n, tc, tz, prm):
    """Per-slot values of batches [b0, b1) with square-tile cells
    (`_seg_fwd_kernel` lines 120-133): (valid, gy, gz, p0 (nb, 1), cx
    (nb, 1, PANEL), cy, cz, s0, s1, s2, cov, at, w, xh)."""
    ox, oy, oz, vs, tau_e, _ = prm
    valid, cells, at = slot_rows(tables, cells_b, tblidx_b, b0, b1, tc=tc)
    gy, gz = _decode_yz(batch_tile[b0:b1].long()[:, None], cells, n=n, tc=tc, tz=tz)
    cy = oy + (gy.float() * vs + vs * 0.5)
    cz = oz + (gz.float() * vs + vs * 0.5)
    p0 = batch_panel[b0:b1].long()[:, None]
    cols = p0[:, :, None] + torch.arange(PANEL, device=tables.device)
    cx = ox + (cols.float() * vs + vs * 0.5)
    s0, s1, s2, cov, w, xh = slot_fragment(at, cy, cz, tau_e)
    return valid, gy, gz, p0, cols, cx, cy, cz, s0, s1, s2, cov, at, w, xh


def seg_fwd_plain(tables, cells_b, tblidx_b, batch_tile, batch_panel, *, n: int,
                  tc: int, tz: int, prm):
    """Plain torch version of B9 (any device): (out_a, out_b) (nt, n/128,
    tc, 128) and carry (nt, n/64, tc), float32, nt = n*n / tc. The terms
    are summed in float64 and rounded once, as in `profile_out`."""
    num_batches, tb = cells_b.shape[0], cells_b[0].numel()
    nt, nblk, ng = (n * n) // tc, n // PANEL, n // LATTICE
    dev = tables.device
    acc = torch.zeros((2 * nt * nblk * tc + 1, PANEL), dtype=torch.float64,
                      device=dev)
    cacc = torch.zeros(nt * ng * tc + 1, dtype=torch.float64, device=dev)
    for b0, b1 in _seg_chunks(num_batches, tb):
        (valid, _, _, p0, _, cx, *_, w, xh) = _seg_slots(
            tables, cells_b, tblidx_b, batch_tile, batch_panel, b0, b1, n=n,
            tc=tc, tz=tz, prm=prm)
        cells = cells_b[b0:b1].reshape(b1 - b0, -1).long()
        tile = batch_tile[b0:b1].long()[:, None]
        fam = (p0 // LATTICE) % 2  # 0: out_a block p0 / 128, 1: out_b (p0 - 64) / 128
        blk = (p0 - fam * LATTICE) // PANEL
        rows = torch.where(valid, ((fam * nt + tile) * nblk + blk) * tc + cells,
                           acc.shape[0] - 1)
        sig = torch.sigmoid((xh[..., None] - cx) / prm[5])
        acc.index_add_(0, rows.reshape(-1), (w[..., None] * sig).reshape(-1, PANEL)
                       .to(torch.float64))
        crows = torch.where(valid, (tile * ng + p0 // LATTICE) * tc + cells,
                            cacc.shape[0] - 1)
        cacc.index_add_(0, crows.reshape(-1), w.reshape(-1).to(torch.float64))
    out = acc[:-1].view(2, nt, nblk, tc, PANEL).float()
    return out[0], out[1], cacc[:-1].view(nt, ng, tc).float()


def _check_seg(tables, cells_b, tblidx_b, batch_tile, batch_panel):
    _check_fused(tables, cells_b, tblidx_b, batch_tile)
    _build.expect(batch_panel, "batch_panel", torch.int32, (tables.shape[0],))


def seg_fwd_smem_bytes(tc: int, tb: int) -> int:
    """B9's shared memory: B7's, plus the carry's fixed-point sums and
    their non-finite bits."""
    return fwd_smem_bytes(tc, tb) + tc * 8 + (tc + 31) // 32 * 4


def seg_fwd(tables, cells_b, tblidx_b, batch_tile, batch_panel, run_start, *,
            n: int, tc: int, tz: int, prm):
    """B9: (B, tbl, 16) tables -> (out_a, out_b, carry) as
    `seg_fwd_plain`. Batches of one (tile, panel) key must form one
    contiguous run; `run_start` (R + 1,) int32 holds the runs' bounds
    (the plan's `run_start_d`). A CPU tensor takes the plain version, a
    CUDA tensor launches the kernel (`csrc/soft_vox_seg.cu::vt_seg_fwd`)."""
    _check_geometry(n, tc, tz)
    _check_seg(tables, cells_b, tblidx_b, batch_tile, batch_panel)
    if not _build.on_cuda(tables, cells_b, tblidx_b, batch_tile, batch_panel,
                          run_start):
        return seg_fwd_plain(tables, cells_b, tblidx_b, batch_tile, batch_panel,
                             n=n, tc=tc, tz=tz, prm=prm)
    _build.expect(run_start, "run_start", torch.int32)
    tb = cells_b[0].numel()
    if seg_fwd_smem_bytes(tc, tb) > _SMEM_MAX:
        raise ValueError(f"tc={tc}, tb={tb} exceed one block's shared memory")
    nt = (n * n) // tc
    out_a = torch.zeros((nt, n // PANEL, tc, PANEL), dtype=torch.float32,
                        device=tables.device)
    out_b = torch.zeros_like(out_a)
    carry = torch.zeros((nt, n // LATTICE, tc), dtype=torch.float32,
                        device=tables.device)
    num_runs = run_start.numel() - 1
    if num_runs > 0:
        _build.launch("vt_seg_fwd", tables.data_ptr(), cells_b.data_ptr(),
                      tblidx_b.data_ptr(), batch_tile.data_ptr(),
                      batch_panel.data_ptr(), run_start.data_ptr(), num_runs, tb,
                      tables.shape[1], n, tc, tz, nt, *prm, out_a.data_ptr(),
                      out_b.data_ptr(), carry.data_ptr(), _build.stream_of(out_a))
        seg_fwd.launches += 1
    return out_a, out_b, carry


seg_fwd.launches = 0


def carry_prefix(carry: torch.Tensor) -> torch.Tensor:
    """(nt, n/64, tc) carries -> pre, pre[:, j] the sum of the carries of
    the groups > j: every column left of a panel gets the panel's
    weights. voxtpu's `flip(cumsum(flip(c))) - c` (`:423-424`), its
    suffix sums added one group at a time in float32 from the right, as
    jnp.cumsum adds on XLA:CPU (bit for bit at n = 256)."""
    ng = carry.shape[1]
    sums = [carry[:, ng - 1]]
    for j in range(ng - 2, -1, -1):
        sums.append(sums[-1] + carry[:, j])
    return torch.stack(sums[::-1], 1) - carry


def seg_combine_plain(out_a, out_b, carry, *, n: int, tc: int, tz: int):
    """Plain torch version of B10 (any device): voxtpu's XLA combine
    (`_seg_combine`, `:454-470`) with its per-element association
    (a + shifted b) + carry prefix, in the square-tile layout."""
    nt, ty = (n * n) // tc, tc // tz
    a_t = out_a.permute(0, 2, 1, 3).reshape(nt, tc, n)
    b_t = out_b.permute(0, 2, 1, 3).reshape(nt, tc, n)
    occ_t = a_t + torch.cat([b_t.new_zeros((nt, tc, LATTICE)),
                             b_t[:, :, :n - LATTICE]], 2)
    pre_t = carry_prefix(carry).permute(0, 2, 1)             # (nt, tc, n/64)
    occ_t = occ_t + pre_t[..., None].expand(nt, tc, n // LATTICE, LATTICE
                                            ).reshape(nt, tc, n)
    occ = occ_t.reshape(n // tz, n // ty, tz, ty, n)
    return occ.permute(0, 2, 1, 3, 4).reshape(n, n, n)


def seg_combine(out_a, out_b, carry, *, n: int, tc: int, tz: int):
    """B10: (out_a, out_b, carry) of B9 -> the dense (n, n, n) grid,
    bitwise equal to `seg_combine_plain`. A CPU tensor takes the plain
    version, a CUDA tensor launches the kernel (`vt_seg_combine`) on the
    carry prefix, which both compute in torch ops."""
    _check_geometry(n, tc, tz)
    nt = (n * n) // tc
    _build.expect(out_a, "out_a", torch.float32, (nt, n // PANEL, tc, PANEL))
    _build.expect(out_b, "out_b", torch.float32, (nt, n // PANEL, tc, PANEL))
    _build.expect(carry, "carry", torch.float32, (nt, n // LATTICE, tc))
    if not _build.on_cuda(out_a, out_b, carry):
        return seg_combine_plain(out_a, out_b, carry, n=n, tc=tc, tz=tz)
    pre = carry_prefix(carry).contiguous()
    out = torch.empty((n, n, n), dtype=torch.float32, device=out_a.device)
    _build.launch("vt_seg_combine", out_a.data_ptr(), out_b.data_ptr(),
                  pre.data_ptr(), n, tc, tz, out.data_ptr(), _build.stream_of(out))
    seg_combine.launches += 1
    return out


seg_combine.launches = 0


def seg_gpre(g: torch.Tensor) -> torch.Tensor:
    """(n, n, n) cotangent -> (n, n, n/64) gpre, gpre[z, y, j] the sum of
    g[z, y] over the columns left of 64-column group j (`:528-532`)."""
    n = g.shape[0]
    gs = g.reshape(n, n, n // LATTICE, LATTICE).sum(-1)
    return torch.cat([gs.new_zeros((n, n, 1)), torch.cumsum(gs, -1)[..., :-1]],
                     -1).contiguous()


def seg_bwd_plain(tables, cells_b, tblidx_b, batch_tile, batch_panel, g, gpre, *,
                  n: int, tc: int, tz: int, prm) -> torch.Tensor:
    """Plain torch version of B11 (any device): (B, tbl, 16) table
    cotangents (`_seg_bwd_kernel` 241-261), in chunks of batches."""
    num_batches, tbl = tables.shape[0], tables.shape[1]
    tb = cells_b[0].numel()
    tau_e, tau_x = prm[4], prm[5]
    ng = n // LATTICE
    g_ext = torch.cat([g.reshape(n * n, n), g.new_zeros((1, n))])
    gp_ext = torch.cat([gpre.reshape(n * n, ng), gpre.new_zeros((1, ng))])
    dtab = torch.zeros((num_batches * tbl + 1, 13), dtype=torch.float32,
                       device=tables.device)
    for b0, b1 in _seg_chunks(num_batches, tb):
        (valid, gy, gz, p0, cols, cx, cy, cz, s0, s1, s2, cov, at, w, xh) = _seg_slots(
            tables, cells_b, tblidx_b, batch_tile, batch_panel, b0, b1, n=n,
            tc=tc, tz=tz, prm=prm)
        rows = torch.where(valid, gz * n + gy, n * n)
        pg = g_ext[rows[..., None], cols]                     # (nb, tb, PANEL)
        sig = torch.sigmoid((xh[..., None] - cx) / tau_x)
        ps = pg * sig
        dw = ps.sum(-1) + gp_ext[rows, p0 // LATTICE]
        dxh = (w / tau_x) * (ps * (1.0 - sig)).sum(-1)
        d = chain_rule(dw, dxh, at, cy, cz, s0, s1, s2, cov, tau_e)
        table_add(dtab, d, valid, tblidx_b, b0, b1)
    return table_grid(dtab, num_batches, tbl)


def seg_bwd(tables, cells_b, tblidx_b, batch_tile, batch_panel, g, gpre, *,
            n: int, tc: int, tz: int, prm) -> torch.Tensor:
    """B11: occupancy cotangent g (n, n, n) and its `seg_gpre` -> (B,
    tbl, 16) table cotangents (rows 13..15 zero). A CPU tensor takes the
    plain version, a CUDA tensor launches the kernel (`vt_seg_bwd`)."""
    _check_geometry(n, tc, tz)
    _check_seg(tables, cells_b, tblidx_b, batch_tile, batch_panel)
    _build.expect(g, "g", torch.float32, (n, n, n))
    _build.expect(gpre, "gpre", torch.float32, (n, n, n // LATTICE))
    if not _build.on_cuda(tables, cells_b, tblidx_b, batch_tile, batch_panel, g,
                          gpre):
        return seg_bwd_plain(tables, cells_b, tblidx_b, batch_tile, batch_panel, g,
                             gpre, n=n, tc=tc, tz=tz, prm=prm)
    num_batches, tbl = tables.shape[0], tables.shape[1]
    dtab = torch.zeros_like(tables)
    if num_batches:
        _build.launch("vt_seg_bwd", tables.data_ptr(), cells_b.data_ptr(),
                      tblidx_b.data_ptr(), batch_tile.data_ptr(),
                      batch_panel.data_ptr(), g.data_ptr(), gpre.data_ptr(),
                      num_batches, cells_b[0].numel(), tbl, n, tc, tz,
                      (n * n) // tc, *prm, dtab.data_ptr(), _build.stream_of(dtab))
        seg_bwd.launches += 1
    return dtab


seg_bwd.launches = 0


class _SegAccumulate(torch.autograd.Function):
    """(B, tbl, 16) tables -> (n, n, n) occupancy: forward B9 then B10,
    backward B11. The family arrays live only inside the forward."""

    @staticmethod
    def forward(ctx, tables, plan, prm):
        ctx.plan, ctx.prm = plan, prm
        ctx.save_for_backward(tables)
        kw = dict(n=plan.spec.n, tc=plan.tc, tz=plan.tz)
        parts = seg_fwd(tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d,
                        plan.batch_panel_d, plan.run_start_d, prm=prm, **kw)
        return seg_combine(*parts, **kw)

    @staticmethod
    def backward(ctx, g):
        (tables,) = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        dtab = seg_bwd(tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d,
                       plan.batch_panel_d, g, seg_gpre(g), n=plan.spec.n,
                       tc=plan.tc, tz=plan.tz, prm=ctx.prm)
        return dtab, None, None


# ---------------------------------------------------------------------------
# Plan (static host layout) and entry point
# ---------------------------------------------------------------------------


class SegSoftPlan(TablePlan):
    """Static (tile, panel, triangle) batch layout and per-batch triangle
    tables of one soft plan, on `device` (`soft_vox_seg.py:592-797`).

    Built from a soft plan and the coordinates it was built against:
    each in-grid candidate's x_hit, evaluated here on the host in
    float32, assigns its panel. Slots are sorted by (tile * n + p0,
    face), stably, so a (run, face) pair keeps `slot_cells`' order, and
    cut into batches by the fused engine's `_cut_batches`. The host
    arrays keep voxtpu's names (`batch_tile`, `batch_panel`, `cells_b`,
    `tblidx_b`, `table_face_flat`); the tensors the per-call path reads
    end in ``_d``, and `run_start_d` bounds the runs of equal (tile,
    panel) keys. `tables_of` and `prm` are the fused plan's."""

    def __init__(self, soft_plan, coords, device, tc: int = 128, tb_sub: int = 4,
                 tbl: int = 128, tz: int = 8):
        n = soft_plan.spec.n
        _check_geometry(n, tc, tz)
        ty = tc // tz
        spec = soft_plan.spec
        vs = np.float32(spec.voxel_size)
        org = np.asarray(spec.origin, np.float32)
        fp, fq, fr, _ = _xplane(_host(coords), np.asarray(soft_plan.faces_array))

        cells, faces = slot_cells(soft_plan, n)
        keep = cells >= 0
        # int32 throughout: tile * n + p0 < n^3 / tc < 2^31 for n <= 4096.
        ys = (cells[keep] % n).astype(np.int32)
        zs = (cells[keep] // n).astype(np.int32)
        faces = faces[keep].astype(np.int32)
        cy = org[1] + (ys.astype(np.float32) * vs + vs * 0.5)
        cz = org[2] + (zs.astype(np.float32) * vs + vs * 0.5)
        xh = fp[faces] - fq[faces] * cy - fr[faces] * cz
        xv = (xh - org[0]) / vs
        # Near-edge-on faces have finite Q, R ~ 1e18: clip to a castable
        # range; any x_hit beyond the grid saturates either way.
        xv = np.clip(np.nan_to_num(xv, nan=0.0), -1e9, 1e9)
        p0 = np.clip(
            np.floor((xv - np.float32(MARGIN)) / np.float32(LATTICE))
            .astype(np.int32) * LATTICE, 0, n - PANEL).astype(np.int32)
        tile = (zs // tz) * (n // ty) + ys // ty
        local = ((zs % tz) * ty + ys % ty).astype(np.int32)
        runkey = tile * np.int32(n) + p0
        order = np.lexsort((faces, runkey))
        cut = _cut_batches(runkey[order], faces[order], local[order],
                           tb_sub=tb_sub, tbl=tbl)
        key = cut["batch_key"]
        self._setup_seg(soft_plan, coords, device, tc, tz, tbl,
                        (key // n).astype(np.int32), (key % n).astype(np.int32),
                        cut["cells_b"], cut["tblidx_b"], cut["table_face"].reshape(-1))
        self.num_pairs = cut["num_pairs"]
        self.num_fragments = int(ys.size)

    @classmethod
    def from_layout(cls, soft_plan, device, batch_tile, batch_panel, cells_b,
                    tblidx_b, table_face_flat, tc: int = 128, tz: int = 8):
        """A plan on a given slot layout (voxtpu's, in the tests); the
        x_hit snapshot is taken at the soft plan's build coordinates."""
        plan = object.__new__(cls)
        cells_b = np.asarray(cells_b, np.int32)
        tbl = np.asarray(table_face_flat).size // max(cells_b.shape[0], 1)
        plan._setup_seg(soft_plan, soft_plan.plan_coords, device, tc, tz, tbl,
                        batch_tile, batch_panel, cells_b, tblidx_b, table_face_flat)
        plan.num_pairs = int((np.asarray(table_face_flat) >= 0).sum())
        plan.num_fragments = int((cells_b >= 0).sum())
        return plan

    def _setup_seg(self, soft_plan, coords, device, tc, tz, tbl, batch_tile,
                   batch_panel, cells_b, tblidx_b, table_face_flat):
        n = soft_plan.spec.n
        _check_geometry(n, tc, tz)
        self.tz = tz
        self.batch_panel = np.asarray(batch_panel, np.int32)
        _check_range(self.batch_panel, "batch_panel", 0, n - PANEL + 1)
        if (self.batch_panel % LATTICE).any():
            raise ValueError(f"batch_panel: panels start on multiples of {LATTICE}")
        self._setup_tables(soft_plan, device, tc, tbl, cells_b, tblidx_b,
                           batch_tile, table_face_flat)
        key = self.batch_tile.astype(np.int64) * n + self.batch_panel
        self.run_start = tile_runs(key)  # runs of equal (tile, panel) keys
        self.num_runs = self.run_start.size - 1
        self.batch_panel_d = self._to_device(self.batch_panel, torch.int32)
        self.run_start_d = self._to_device(self.run_start, torch.int32)
        self._snapshot(soft_plan, coords)

    def _snapshot(self, soft_plan, coords) -> None:
        """Build-time x-hit planes and each face's window centre and
        radius, for `xhit_drift_vox` (`soft_vox_seg.py:633-653`)."""
        spec = soft_plan.spec
        n, vs = spec.n, np.float32(spec.voxel_size)
        org = np.asarray(spec.origin, np.float32)
        self._faces_np = np.asarray(soft_plan.faces_array)
        num_faces = self._faces_np.shape[0]
        self._cy0 = np.zeros(num_faces, np.float32)
        self._cz0 = np.zeros(num_faces, np.float32)
        self._rad = np.zeros(num_faces, np.float32)
        for bucket in soft_plan.buckets:
            window = bucket[0]
            sy, sz, fi = (np.asarray(bucket[k]) for k in (4, 5, 6))
            real = (sy < n) & (sz < n)  # padded rows carry sy = sz = n
            self._cy0[fi[real]] = org[1] + ((sy[real] + window * 0.5)
                                            .astype(np.float32) * vs)
            self._cz0[fi[real]] = org[2] + ((sz[real] + window * 0.5)
                                            .astype(np.float32) * vs)
            self._rad[fi[real]] = (window * 0.5 + 0.5) * vs
        self._fp0, self._fq0, self._fr0, self._fa0 = _xplane(_host(coords),
                                                             self._faces_np)

    def xhit_drift_vox(self, coords) -> float:
        """Conservative max x_hit drift (voxels) of any active face since
        the plan was built (`soft_vox_seg.py:764-797`, on the host).

        Vertex drift does not bound x_hit drift (x_hit amplifies vertex
        motion by ~|Q|, |R|), so `VoxelFit(engine="seg")` refreshes on
        this too. The bound per face is the centre delta plus a Lipschitz
        term over the raster window; faces whose x-plane lies far outside
        the grid's x range in both configurations are ignored, as are
        exactly degenerate faces (their weight is 0)."""
        spec = self.spec
        n, vs = spec.n, spec.voxel_size
        p, q, r, a = _xplane(_host(coords), self._faces_np)
        dp, dq, dr = p - self._fp0, q - self._fq0, r - self._fr0
        d = (np.abs(dp - dq * self._cy0 - dr * self._cz0)
             + (np.abs(dq) + np.abs(dr)) * self._rad)
        xo = (self._fp0 - self._fq0 * self._cy0 - self._fr0 * self._cz0
              - spec.origin[0]) / vs
        xn = (p - q * self._cy0 - r * self._cz0 - spec.origin[0]) / vs
        band = 2.0 * MARGIN + self._rad / vs
        active = (((xo > -band) & (xo < n + band))
                  | ((xn > -band) & (xn < n + band)))
        active &= (np.abs(self._fa0) > 1e-20) & (np.abs(a) > 1e-20)
        if not active.any():
            return 0.0
        return float(np.nan_to_num(d[active], nan=np.inf).max() / vs)


def soft_voxelize_seg(coords: torch.Tensor, plan: SegSoftPlan, *,
                      tau_edge_frac: float = 0.25, tau_x_frac: float = 0.5,
                      clip: bool = True) -> torch.Tensor:
    """Differentiable occupancy through the seg engine
    (`soft_vox_seg.py:823-872`). The fused engine's formula with its sums
    reordered (panel + carry instead of the whole row), so the two agree
    to float32 rounding.

    Exact only while the x sigmoid saturates inside the MARGIN-voxel
    panel edge: tau_x_frac must satisfy 17 * tau_x_frac <= MARGIN
    (raises otherwise; the fused engine takes wider profiles)."""
    if tau_x_frac * 17.0 > MARGIN:
        raise ValueError(
            f"tau_x_frac={tau_x_frac} too wide for the segmented engine: the "
            f"X sigmoid must saturate within the {MARGIN}-voxel panel margin "
            f"(tau_x_frac <= {MARGIN / 17.0:.2f}); use soft_voxelize_fused for "
            f"wider profiles")
    tables = tables_of(coords, plan)
    occ = _SegAccumulate.apply(tables, plan, plan.prm(tau_edge_frac, tau_x_frac))
    return clip01(occ) if clip else occ
