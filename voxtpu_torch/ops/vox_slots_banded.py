"""Banded static-slot voxelizer — the main path (mesh -> packed grid).

Port of `voxtpu/ops/vox_slots_banded.py`, the pipeline voxtpu's
benchmark headlines (`bench.py:499-552`). The host plan is the same:
each candidate cell's x entry is one point (the plane intersection at
the cell's center), evaluated in f64 and widened by the f32 error
bound into a window a few cells wide; slots sort by (YZ tile, window
start), greedy cuts pack up to TB consecutive slots whose windows fit
one BAND-column window from a 32-aligned base, and candidates whose
window does not fit (x-degenerate planes) go to a whole-axis fallback.
The slot/batch layout is identical to voxtpu's, defaults included
(tc=128, tb_sub=4, band=256, pack=2), so the tests compare the plan
arrays one to one.

Per call (`banded_total`): the elementwise `_slot_emit` (torch ops),
kernel B1 over the banded batches into the full grid, and, for the
wide candidates, kernel B2 into a compact per-touched-tile buffer that
is XOR-merged into the grid (in place: the grid is a fresh tensor with
no other owner). Fragments that left their baked bands (vertex drift)
are dropped and counted in `overflow`; nonzero means rebuild.

B1 replaces the Pallas `_banded_kernel`. The TPU mechanisms around
it — the step/flag scalars, byte-packed lane offsets for SMEM, the
MXU pack tables and the 128-lane supertile output panels — are not
needed: the CUDA kernel takes per-slot (local cell, x) and per-batch
(tile, base word) directly (`csrc/vox_fill.cu::vt_banded_fill`). The
supertile group size survives only as the unit of the PACK padding,
so that the batch layout stays voxtpu's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import WORD_BITS, GridSpec, VoxelGrid
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox_cuda import (TB_LANE, TB_SUB, TILE_CELLS,
                                       _check_range, _check_slots,
                                       _check_window, _group_factor,
                                       suffix_parity_words, tile_batches,
                                       wide_fill)
from voxtpu_torch.ops.vox_slots import (_batch_index, _exact_candidates,
                                        _slot_emit, _slot_rows)

# Fill window columns (multiple of 32; >= 32 + 2*ceil(err) + 1).
BAND = 256
# Each supertile group's batch run is padded to a multiple of PACK.
PACK = 2


@dataclasses.dataclass
class BandedState:
    """Per-call state of the banded pipeline, on one device.

    rows: nine (B, tb_sub, 128) float32 slot coordinate tensors;
    local: (B, tb_sub, 128) int32 local cells (-1 = pad slot);
    batch_tile, batch_basew: (B,) int32 tile and 32-aligned base word;
    wide: None, or (w_rows, w_local, w_rtile, w_ctile, w_uidx) — the
    whole-axis batches' rows and locals, their real and compact tiles,
    and the compact -> real tile map."""

    rows: tuple
    local: torch.Tensor
    batch_tile: torch.Tensor
    batch_basew: torch.Tensor
    wide: tuple | None


def banded_fill_plain(local: torch.Tensor, xs: torch.Tensor,
                      batch_tile: torch.Tensor, batch_basew: torch.Tensor,
                      *, n: int, tc: int, band: int) -> torch.Tensor:
    """Plain torch version of B1 (any device)."""
    base = batch_basew[:, None, None] * WORD_BITS
    live = (local >= 0) & (local < tc) & (xs >= base) & (xs < base + band)
    cells = batch_tile[:, None, None] * tc + local
    words = suffix_parity_words(cells[live], xs[live], n * n, n)
    return words.view(n, n, n // WORD_BITS)


def banded_fill(local: torch.Tensor, xs: torch.Tensor,
                batch_tile: torch.Tensor, batch_basew: torch.Tensor, *,
                n: int, tc: int, band: int) -> torch.Tensor:
    """B1: banded suffix fill -> (n, n, n/32) int32 words.

    Slots are (B, tb_sub, 128) (local cell, x entry); batch b fills the
    rows of tile `batch_tile[b]` from its slots whose x lies in the
    band [32 * batch_basew[b], 32 * batch_basew[b] + band) — every
    later word is flipped by the per-cell carry. Other slots are inert.

    `batch_tile` must lie in [0, N^2/tc) and `batch_basew` in
    [0, (N - band)/32]; they are not checked here (a pipeline checks its
    plan once, when it is built). The kernel skips a batch outside them.

    Replaces voxtpu/ops/vox_slots_banded.py::_banded_kernel. A CPU
    tensor takes the plain version, a CUDA tensor launches the kernel."""
    num_batches, tb = _check_slots(local, xs, batch_tile)
    _build.expect(batch_basew, "batch_basew", torch.int32, (num_batches,))
    if n % WORD_BITS or band % WORD_BITS or not 0 < band <= n:
        raise ValueError(f"need N and band multiples of 32, band <= N "
                         f"(n={n}, band={band})")
    if (n * n) % tc:
        raise ValueError(f"tc={tc} must divide N^2={n * n}")
    if not _build.on_cuda(local, xs, batch_tile, batch_basew):
        return banded_fill_plain(local, xs, batch_tile, batch_basew, n=n,
                                 tc=tc, band=band)
    nw, bwords = n // WORD_BITS, band // WORD_BITS
    _check_window(tc, bwords)
    out = torch.zeros((n, n, nw), dtype=torch.int32, device=local.device)
    if num_batches:
        _build.launch("vt_banded_fill", local.data_ptr(), xs.data_ptr(),
                      batch_tile.data_ptr(), batch_basew.data_ptr(),
                      num_batches, tb, tc, nw, bwords, (n * n) // tc,
                      out.data_ptr(), _build.stream_of(out))
        banded_fill.launches += 1
    return out


banded_fill.launches = 0


def emit_slots(state: BandedState, origin: torch.Tensor, vs: torch.Tensor,
               *, n: int, tc: int, band: int):
    """The per-call inputs of B1 and B2: ((local_k, xs) of the banded
    batches, with slots outside their band dropped to -1; (w_k, w_xs)
    of the wide batches or None; the overflow count)."""
    xs, local_k = _slot_emit(state.rows, state.local, state.batch_tile,
                             origin, vs, n=n, tc=tc)
    base = state.batch_basew[:, None, None] * WORD_BITS
    inband = (xs >= base) & (xs < base + band)
    overflow = ((local_k >= 0) & ~inband).sum()
    local_k = torch.where(inband, local_k, torch.full_like(local_k, -1))
    wide = None
    if state.wide is not None:
        w_rows, w_local, w_rtile, _, _ = state.wide
        w_xs, w_k = _slot_emit(w_rows, w_local, w_rtile, origin, vs, n=n, tc=tc)
        wide = (w_k, w_xs)
    return (local_k, xs), wide, overflow


def banded_total(state: BandedState, origin: torch.Tensor, vs: torch.Tensor,
                 *, n: int, tc: int, band: int):
    """One call of the pipeline (`vox_slots_banded.py:241-270`):
    returns (words (n, n, n/32) int32, overflow () int64)."""
    (local_k, xs), wide, overflow = emit_slots(state, origin, vs, n=n, tc=tc,
                                               band=band)
    words = banded_fill(local_k, xs, state.batch_tile, state.batch_basew,
                        n=n, tc=tc, band=band)
    if wide is not None:
        w_ctile, w_uidx = state.wide[3], state.wide[4]
        w_words = wide_fill(*wide, w_ctile, n=n, tc=tc,
                            num_tiles=w_uidx.shape[0])
        words.view(-1, tc, n // WORD_BITS)[w_uidx] ^= w_words
    return words, overflow


def _candidate_x_windows(tri, cell, v0, v1, v2, spec: GridSpec):
    """Per-candidate x-entry cell windows [xlo, xhi] (inclusive)
    (`vox_slots_banded.py:273-329`).

    The host evaluates each candidate's plane intersection in f64 and
    widens it by max(1, ceil(err)) cells, err the per-triangle f32
    evaluation error bound, ~eps * (|D| + |B cy| + |C cz|) / |A| cells
    with a 4x safety. Only x-degenerate planes (A ~ 0) get windows too
    wide for a band; A == 0 gives err = inf (wide; invalid at emit)."""
    n = spec.n
    ox = np.float64(spec.origin[0])
    oy = np.float64(spec.origin[1])
    oz = np.float64(spec.origin[2])
    vs = np.float64(spec.voxel_size)
    f0, f1, f2 = (np.asarray(v, np.float64) for v in (v0, v1, v2))
    u = f1 - f0
    t = f2 - f0
    A = u[:, 1] * t[:, 2] - u[:, 2] * t[:, 1]
    B = u[:, 2] * t[:, 0] - u[:, 0] * t[:, 2]
    C = u[:, 0] * t[:, 1] - u[:, 1] * t[:, 0]
    D = A * f0[:, 0] + B * f0[:, 1] + C * f0[:, 2]
    cyb = max(abs(oy), abs(oy + n * vs))
    czb = max(abs(oz), abs(oz + n * vs))
    num = np.abs(D) + np.abs(B) * cyb + np.abs(C) * czb
    with np.errstate(divide="ignore", invalid="ignore"):
        err_cells = np.where(
            A == 0.0, np.inf,
            8e-7 * num / np.maximum(np.abs(A), 1e-300) / vs)
    margin = np.maximum(
        1, np.ceil(np.minimum(err_cells, n)).astype(np.int64))

    ys = (cell % n).astype(np.float64)
    zs = (cell // n).astype(np.float64)
    cy = oy + (ys * vs + vs / 2)
    cz = oz + (zs * vs + vs / 2)
    At, Bt, Ct, Dt = A[tri], B[tri], C[tri], D[tri]
    with np.errstate(divide="ignore", invalid="ignore"):
        xf = ((Dt - Bt * cy - Ct * cz) / At - ox) / vs
    xcell = np.where(np.isfinite(xf),
                     np.floor(np.clip(xf, -1.0, float(n))), 0.0)
    xcell = xcell.astype(np.int64)
    mt = margin[tri]
    xlo = np.clip(xcell - mt, 0, n - 1)
    xhi = np.clip(xcell + mt, 0, n - 1)
    return xlo, xhi


class BandedSlotVoxPipeline:
    """Whole-pipeline voxelizer with a static (tile, x-band) slot layout,
    built once on the host for one (mesh, grid) pair; each call is the
    emit plus the fill kernels on `device`. `overflow` > 0 from a call
    means fragments left their baked bands (vertex drift); rebuild."""

    tb_sub = TB_SUB  # voxtpu's slot layout, read by the tests
    pack = PACK

    def __init__(self, mesh: Mesh, spec: GridSpec, device,
                 tc: int = TILE_CELLS, band: int = BAND):
        n = spec.n
        if n % WORD_BITS != 0:
            raise ValueError("banded vox requires N % 32 == 0")
        if tc <= 0 or (n * n) % tc != 0:
            raise ValueError(f"tc={tc} must divide N^2={n * n}")
        band = min(band, n)
        if band % WORD_BITS != 0:
            raise ValueError(f"band={band} must be a multiple of 32")
        tb = TB_SUB * TB_LANE
        self.spec = spec
        self.tc = tc
        self.band = band
        nw = n // WORD_BITS
        num_tiles = (n * n) // tc
        self.num_tiles = num_tiles
        g = _group_factor(nw, num_tiles)  # voxtpu pads each group to PACK

        tri, cell, v0, v1, v2 = _exact_candidates(mesh, spec)
        self.num_candidates = cell.shape[0]
        xlo_c, xhi_c = _candidate_x_windows(tri, cell, v0, v1, v2, spec)
        # A batch's band starts at its first slot's 32-aligned window
        # base, so a candidate is narrow iff its window fits a band
        # from that base.
        base_c = np.minimum((xlo_c // WORD_BITS) * WORD_BITS, n - band)
        narrow = xhi_c < base_c + band
        c_n, t_n = cell[narrow], tri[narrow]
        c_w, t_w = cell[~narrow], tri[~narrow]
        self.num_wide = c_w.shape[0]

        # Narrow layout: slots sorted by (tile, window start), then
        # greedy batch cuts of up to tb consecutive slots whose windows
        # fit one band from the first slot's aligned base.
        xlo_n, xhi_n = xlo_c[narrow], xhi_c[narrow]
        order = np.lexsort((xlo_n, c_n // tc)) if len(t_n) else \
            np.zeros((0,), np.int64)
        c_n, t_n = c_n[order], t_n[order]
        local_n = (c_n % tc).astype(np.int32)
        xlo_s = xlo_n[order]
        xhi_s = xhi_n[order]
        tile_s = (c_n // tc).astype(np.int64)
        tbounds = np.searchsorted(tile_s,
                                  np.arange(num_tiles + 1, dtype=np.int64))
        batch_tile, batch_base, starts, ends = [], [], [], []
        for t in np.nonzero(np.diff(tbounds))[0]:
            i, b1 = int(tbounds[t]), int(tbounds[t + 1])
            while i < b1:
                base = min((int(xlo_s[i]) // WORD_BITS) * WORD_BITS, n - band)
                w_end = min(i + tb, b1)
                viol = xhi_s[i:w_end] >= base + band
                k0 = i + int(np.argmax(viol)) if viol.any() else w_end
                batch_tile.append(int(t))
                batch_base.append(base)
                starts.append(i)
                ends.append(k0)
                i = k0
        if not batch_tile:  # empty narrow set: one inert batch on tile 0
            batch_tile, batch_base, starts, ends = [0], [0], [0], [0]

        # Pad every group's batch run to a multiple of PACK with inert
        # batches (start == end), voxtpu's layout.
        bt2, bb2, st2, en2 = [], [], [], []
        i = 0
        while i < len(batch_tile):
            j = i
            while j < len(batch_tile) and batch_tile[j] // g == \
                    batch_tile[i] // g:
                j += 1
            bt2 += batch_tile[i:j]
            bb2 += batch_base[i:j]
            st2 += starts[i:j]
            en2 += ends[i:j]
            for _ in range((-(j - i)) % PACK):
                bt2.append(batch_tile[j - 1])
                bb2.append(batch_base[j - 1])
                st2.append(0)
                en2.append(0)
            i = j
        batch_tile = np.asarray(bt2, np.int64)
        batch_base = np.asarray(bb2, np.int64)
        starts = np.asarray(st2, np.int64)
        ends = np.asarray(en2, np.int64)
        local_b = _batch_index(starts, ends, local_n, tb, -1)
        tri_b = _batch_index(starts, ends, t_n, tb, 0)
        self.num_batches = len(batch_tile)
        self.num_slots = self.num_batches * tb

        _check_range(batch_tile, "batch_tile", 0, num_tiles)
        _check_range(batch_base // WORD_BITS, "batch_basew", 0,
                     (n - band) // WORD_BITS + 1)
        rows, local = _slot_rows(tri_b, local_b, v0, v1, v2, TB_SUB, device)
        self.device = local.device

        def dev32(a):
            return torch.from_numpy(np.asarray(a).astype(np.int32)).to(self.device)

        # Wide fallback: whole-axis batches over a compact tile set (the
        # wide candidates touch k << num_tiles tiles).
        wide = None
        if self.num_wide:
            orderw = np.argsort(c_w // tc, kind="stable")
            c_w, t_w = c_w[orderw], t_w[orderw]
            local_w = (c_w % tc).astype(np.int32)
            tiles_w = c_w // tc
            uidx = np.unique(tiles_w)
            k = len(uidx)
            compact_w = np.searchsorted(uidx, tiles_w)
            bw = np.searchsorted(compact_w, np.arange(k + 1, dtype=np.int64))
            w_ctiles, w_starts, w_ends = tile_batches(bw, tb)
            w_local_b = _batch_index(w_starts, w_ends, local_w, tb, -1)
            w_tri_b = _batch_index(w_starts, w_ends, t_w, tb, 0)
            _check_range(w_ctiles, "w_ctile", 0, k)
            w_rows, w_local = _slot_rows(w_tri_b, w_local_b, v0, v1, v2,
                                         TB_SUB, device)
            wide = (w_rows, w_local, dev32(uidx[w_ctiles]), dev32(w_ctiles),
                    torch.from_numpy(uidx.astype(np.int64)).to(self.device))
            self.num_batches += len(w_ctiles)

        self.state = BandedState(rows=rows, local=local,
                                 batch_tile=dev32(batch_tile),
                                 batch_basew=dev32(batch_base // WORD_BITS),
                                 wide=wide)

    def words(self):
        """One call: (words (n, n, n/32) int32, overflow () int64)."""
        return banded_total(self.state,
                            self.spec.origin_tensor(self.device),
                            self.spec.voxel_size_tensor(self.device),
                            n=self.spec.n, tc=self.tc, band=self.band)

    def __call__(self) -> VoxelGrid:
        words, overflow = self.words()
        if int(overflow) != 0:
            raise RuntimeError(
                f"{int(overflow)} fragments left their baked x-bands "
                "(coords drifted); rebuild the pipeline")
        return VoxelGrid(words=words,
                         origin=self.spec.origin_tensor(self.device),
                         voxel_size=self.spec.voxel_size_tensor(self.device))
