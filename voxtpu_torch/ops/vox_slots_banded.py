"""Banded static-slot voxelizer — the main path (mesh -> packed grid).

Port of `voxtpu/ops/vox_slots_banded.py`, the pipeline voxtpu's
benchmark headlines (`bench.py:499-552`). The plan is voxtpu's:
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
kernel B1 over the banded batches into the full grid (every word
written once, no zero fill), and, for the wide candidates, kernel B2
XORed straight into the grid's touched tiles through the compact ->
grid tile map (`wide_fill_into`; voxtpu fills a compact buffer and
merges it with a gather, XOR and scatter). Fragments that left their
baked bands (vertex drift) are dropped and counted in `overflow`;
nonzero means rebuild.

B1 replaces the Pallas `_banded_kernel`. The TPU mechanisms around
it — the step/flag scalars, byte-packed lane offsets for SMEM, the
MXU pack tables and the 128-lane supertile output panels — are not
needed: the CUDA kernel takes per-slot (local cell, x) and per-batch
(tile, base word) directly (`csrc/vox_fill.cu::vt_banded_fill`), and
each tile's batch range and cluster size (`FillLayout`), which the plan
builds once. The supertile group size survives only as the unit of the
PACK padding, so that the batch layout stays voxtpu's.

The plan is built on the plan's device, not on the host: the mesh goes
up once, and the candidates, their x windows, the (tile, window start)
sort and the slot gathers are torch ops there, with the float32 and
float64 terms of voxtpu's NumPy plan one op each (no fused op, every
divisor a device tensor), so the arrays are voxtpu's bit for bit. The
greedy cut, the one sequential step, is kernel `csrc/vox_plan.cu`
(`band_cut_counts`, `band_cut`), which replaces voxtpu's host loop.
What crosses between host and device is the mesh, three scalars, the
candidate and batch totals, the per-tile wide counts and the per-batch
arrays (the `vox.plan.*` spans count `host_bytes` and `syncs`); a CPU
device runs the same code with the cut's plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import WORD_BITS, GridSpec, VoxelGrid
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox_cuda import (TB_LANE, TB_SUB, TILE_CELLS,
                                       FillLayout, _check_range, fill_rows,
                                       _check_slots, _gather_batches, _group_factor,
                                       _layout, fill_layout, suffix_parity_words,
                                       tile_batches, wide_fill_into)
from voxtpu_torch.ops.vox_slots import (_candidate_counts, _expand_candidates, _slot_emit,
                                        _slot_rows, _vertex_rows)
from voxtpu_torch.utils.trace import _read, _upload, span

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
    and the compact -> real tile map (int32); layout, wide_layout: the
    plan's `FillLayout`s of B1 and B2 (None: the wrappers build them
    from host copies of the batch tiles, every call)."""

    rows: tuple
    local: torch.Tensor
    batch_tile: torch.Tensor
    batch_basew: torch.Tensor
    wide: tuple | None
    layout: FillLayout | None = None
    wide_layout: FillLayout | None = None


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
                n: int, tc: int, band: int,
                layout: FillLayout | None = None) -> torch.Tensor:
    """B1: banded suffix fill -> (n, n, n/32) int32 words.

    Slots are (B, tb_sub, 128) (local cell, x entry); batch b fills the
    rows of tile `batch_tile[b]` from its slots whose x lies in the
    band [32 * batch_basew[b], 32 * batch_basew[b] + band) — every
    later word is flipped by the per-cell carry. Other slots are inert.

    `batch_tile` must be non-decreasing and lie in [0, N^2/tc), and
    `batch_basew` in [0, (N - band)/32]; they are not checked here (a
    pipeline checks its plan once, when it is built, and keeps its
    `FillLayout`; without one it is built from a host copy of
    `batch_tile`, which waits for the card). The kernel
    skips a batch outside them. Every word of the grid is written
    (tiles without a batch as zeros), so it is allocated empty.

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
    nw, num_tiles = n // WORD_BITS, (n * n) // tc
    fill_rows(nw, tc)  # raises where one row does not fit a block
    layout = _layout(layout, batch_tile, num_tiles, nw=nw, tc=tc)
    out = torch.empty((n, n, nw), dtype=torch.int32, device=local.device)
    _build.launch("vt_banded_fill", local.data_ptr(), xs.data_ptr(),
                  batch_basew.data_ptr(), layout.start.data_ptr(), layout.order.data_ptr(),
                  num_batches, tb, tc, nw, band // WORD_BITS, num_tiles, layout.nbusy,
                  layout.cluster, out.data_ptr(), _build.stream_of(out))
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
    returns (words (n, n, n/32) int32, overflow () int64). B2 XORs into
    B1's grid in place (the grid is a fresh tensor with no other owner)."""
    (local_k, xs), wide, overflow = emit_slots(state, origin, vs, n=n, tc=tc,
                                               band=band)
    words = banded_fill(local_k, xs, state.batch_tile, state.batch_basew,
                        n=n, tc=tc, band=band, layout=state.layout)
    if wide is not None:
        wide_fill_into(words, *wide, state.wide[3], state.wide[4], n=n, tc=tc,
                       layout=state.wide_layout)
    return words, overflow


def _x_windows(tri3: torch.Tensor, face, cell, vs64: torch.Tensor, spec: GridSpec):
    """Per-candidate x-entry cell windows [xlo, xhi] (inclusive) (int64;
    `vox_slots_banded.py:273-329`, voxtpu's NumPy float64 in the same
    order of operations, one torch op each).

    Each candidate's plane intersection at its cell's center, widened by
    max(1, ceil(err)) cells, err the per-triangle f32 evaluation error
    bound, ~eps * (|D| + |B cy| + |C cz|) / |A| cells with a 4x safety.
    Only x-degenerate planes (A ~ 0) get windows too wide for a band;
    A == 0 gives err = inf (wide; invalid at emit). `vs64` is the voxel
    size as a float64 tensor on the device: PyTorch divides by a host
    scalar as a product with its reciprocal, which rounds otherwise."""
    n = spec.n
    ox, oy, oz = (float(v) for v in spec.origin)
    vs = float(spec.voxel_size)
    f = tri3.double()
    f0 = f[:, 0]
    u = f[:, 1] - f0
    t = f[:, 2] - f0
    A = u[:, 1] * t[:, 2] - u[:, 2] * t[:, 1]
    B = u[:, 2] * t[:, 0] - u[:, 0] * t[:, 2]
    C = u[:, 0] * t[:, 1] - u[:, 1] * t[:, 0]
    D = A * f0[:, 0] + B * f0[:, 1] + C * f0[:, 2]
    del f, f0, u, t
    cyb = max(abs(oy), abs(oy + n * vs))
    czb = max(abs(oz), abs(oz + n * vs))
    num = D.abs() + B.abs() * cyb + C.abs() * czb
    err = torch.where(A == 0.0, float("inf"), 8e-7 * num / A.abs().clamp(min=1e-300) / vs64)
    margin = torch.ceil(err.clamp(max=float(n))).to(torch.int64).clamp(min=1)
    del num, err

    cy = (cell % n).double() * vs + vs / 2 + oy
    cz = (cell // n).double() * vs + vs / 2 + oz
    xf = D[face]
    xf -= B[face] * cy
    del cy
    xf -= C[face] * cz
    del cz
    xf /= A[face]
    xf -= ox
    xf /= vs64
    xcell = torch.where(torch.isfinite(xf), torch.floor(xf.clamp(-1.0, float(n))), 0.0)
    del xf
    xcell = xcell.to(torch.int64)
    mt = margin[face]
    return (xcell - mt).clamp(0, n - 1), (xcell + mt).clamp(0, n - 1)


def _cut_tile(xlo, xhi, i: int, b1: int, *, n: int, band: int, tb: int):
    """The greedy cut of one tile's sorted slots [i, b1) (host arrays):
    yields each batch's (base, start, end) (`vox_slots_banded.py:
    389-448`). A batch takes up to `tb` consecutive slots whose windows
    fit one band from its first slot's 32-aligned base; the first slot
    always fits (a narrow candidate's window fits the band from its own
    base), so the search for the first that does not starts after it."""
    while i < b1:
        base = min((int(xlo[i]) // WORD_BITS) * WORD_BITS, n - band)
        w_end = min(i + tb, b1)
        viol = np.flatnonzero(xhi[i + 1:w_end] >= base + band)
        end = i + 1 + int(viol[0]) if len(viol) else w_end
        yield base, i, end
        i = end


def band_cut_counts_plain(xlo, xhi, tbounds, *, n: int, band: int, tb: int) -> torch.Tensor:
    """Plain version of the cut's first pass (CPU tensors): voxtpu's
    per-tile loop, counting each tile's batches."""
    xl, xh, bounds = (a.numpy() for a in (xlo, xhi, tbounds))
    counts = np.zeros(len(bounds) - 1, np.int32)
    for t in np.flatnonzero(np.diff(bounds)):
        counts[t] = sum(1 for _ in _cut_tile(xl, xh, int(bounds[t]), int(bounds[t + 1]),
                                             n=n, band=band, tb=tb))
    return torch.from_numpy(counts)


def band_cut_plain(xlo, xhi, tbounds, off, pads, *, total: int, n: int, band: int,
                   tb: int):
    """Plain version of the cut's second pass (CPU tensors): voxtpu's
    per-tile loop, writing each batch at its tile's offset and the
    tile's pad batches after it."""
    xl, xh, bounds, off, pads = (a.numpy() for a in (xlo, xhi, tbounds, off, pads))
    out = np.zeros((4, total), np.int32)
    for t in np.flatnonzero(np.diff(bounds)):
        k = int(off[t])
        for base, i, end in _cut_tile(xl, xh, int(bounds[t]), int(bounds[t + 1]), n=n,
                                      band=band, tb=tb):
            out[:, k] = (t, base, i, end)
            k += 1
        out[:2, k:k + pads[t]] = np.array([[t], [base]])
    return tuple(torch.from_numpy(a) for a in out)


def _check_cut(xlo, xhi, tbounds, *, n: int, band: int, tb: int) -> int:
    _build.expect(xlo, "xlo", torch.int32, (None,))
    _build.expect(xhi, "xhi", torch.int32, tuple(xlo.shape))
    _build.expect(tbounds, "tbounds", torch.int32, (None,))
    if tbounds.shape[0] < 1 or tb < 1 or band % WORD_BITS or not 0 < band <= n:
        raise ValueError(f"need tile bounds, tb >= 1 and a band of 32-multiples up to N "
                         f"(n={n}, band={band}, tb={tb})")
    if xlo.shape[0] + max(tb, 1024) >= 2 ** 31:
        raise ValueError(f"{xlo.shape[0]} slots: the cut indexes them in 32 bits")
    return tbounds.shape[0] - 1


def band_cut_counts(xlo: torch.Tensor, xhi: torch.Tensor, tbounds: torch.Tensor, *,
                    n: int, band: int, tb: int) -> torch.Tensor:
    """The greedy band cut's first pass -> (num_tiles,) int32 batches a
    tile. Slots are (C,) int32 x windows [xlo, xhi] sorted by (tile,
    xlo); tile t's are [tbounds[t], tbounds[t + 1]) ((num_tiles + 1,)
    int32), each narrow (its window fits the band from its own base).

    Replaces no TPU kernel: voxtpu's host cut (`vox_slots_banded.py:
    389-448`). A CPU tensor takes the plain version, a CUDA tensor
    launches `csrc/vox_plan.cu::vt_band_cut_counts`."""
    num_tiles = _check_cut(xlo, xhi, tbounds, n=n, band=band, tb=tb)
    if not _build.on_cuda(xlo, xhi, tbounds):
        return band_cut_counts_plain(xlo, xhi, tbounds, n=n, band=band, tb=tb)
    counts = torch.empty(num_tiles, dtype=torch.int32, device=xlo.device)
    _build.launch("vt_band_cut_counts", xlo.data_ptr(), xhi.data_ptr(), tbounds.data_ptr(),
                  counts.data_ptr(), num_tiles, n, band, tb, _build.stream_of(counts))
    band_cut_counts.launches += 1
    return counts


band_cut_counts.launches = 0


def band_cut(xlo: torch.Tensor, xhi: torch.Tensor, tbounds: torch.Tensor,
             off: torch.Tensor, pads: torch.Tensor, *, total: int, n: int, band: int,
             tb: int):
    """The greedy band cut's second pass -> (batch_tile, batch_base,
    start, end), each (total,) int32: tile t's batches from `off[t]` on,
    then `pads[t]` inert batches (tile t, its last base, start == end ==
    0) ((num_tiles,) int32 each, `_pack_runs`). Slots as in
    `band_cut_counts`.

    A CPU tensor takes the plain version, a CUDA tensor launches
    `csrc/vox_plan.cu::vt_band_cut`."""
    num_tiles = _check_cut(xlo, xhi, tbounds, n=n, band=band, tb=tb)
    _build.expect(off, "off", torch.int32, (num_tiles,))
    _build.expect(pads, "pads", torch.int32, (num_tiles,))
    if not _build.on_cuda(xlo, xhi, tbounds, off, pads):
        return band_cut_plain(xlo, xhi, tbounds, off, pads, total=total, n=n, band=band,
                              tb=tb)
    out = torch.empty((4, total), dtype=torch.int32, device=xlo.device)
    _build.launch("vt_band_cut", xlo.data_ptr(), xhi.data_ptr(), tbounds.data_ptr(),
                  off.data_ptr(), pads.data_ptr(), *(r.data_ptr() for r in out), num_tiles,
                  n, band, tb, _build.stream_of(out))
    band_cut.launches += 1
    return tuple(out)


band_cut.launches = 0


def _pack_runs(counts: torch.Tensor, g: int, pack: int):
    """Where each tile's batches go (`vox_slots_banded.py:404-425`):
    every group of `g` tiles' run of batches padded to a multiple of
    `pack` by inert batches after the group's last busy tile -> (off
    (num_tiles,) int32 each tile's first batch, pads (num_tiles,) int32
    the pad batches after it, total () int64)."""
    c = counts.long().view(-1, g)
    pad = torch.remainder(-c.sum(1), pack)
    col = torch.arange(g, device=c.device)
    last = torch.where(c > 0, col, -1).amax(1).clamp(min=0)
    pads = torch.zeros_like(c).scatter_(1, last[:, None], pad[:, None])
    per = (c + pads).view(-1)
    return (torch.cumsum(per, 0) - per).int(), pads.view(-1).int(), per.sum()


class BandedSlotVoxPipeline:
    """Whole-pipeline voxelizer with a static (tile, x-band) slot layout,
    built once on `device` for one (mesh, grid) pair; each call is the
    emit plus the fill kernels there. `overflow` > 0 from a call means
    fragments left their baked bands (vertex drift); rebuild.

    The plan's phases are the spans `vox.plan.candidates`, `.windows`,
    `.batches` and `.upload` (`utils/trace.py`), each with its CUDA
    events on a card and its `host_bytes` and `syncs` counted: three host
    reads a plan (the candidate total; the batch total with the per-tile
    wide counts; the batch tiles and bases, for the checks and the
    `FillLayout`s). The device work queued in a phase shows on the host
    clock in the first phase that reads."""

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
        dev = self.device = torch.empty(0, device=device).device

        with span("vox.plan.candidates", dev) as sp:
            coords = _upload(sp, mesh.coords, dev, np.float32)
            faces = _upload(sp, mesh.faces, dev, np.int32)
            # The grid's geometry on the device, made once: a tensor made
            # from host values copies them synchronously, which waits for
            # the card.
            self._origin = spec.origin_tensor(dev)
            self._voxel_size = spec.voxel_size_tensor(dev)
            vs64 = torch.tensor(spec.voxel_size, dtype=torch.float64, device=dev)
            sp.count("host_bytes", 3 * 4 + 4 + 8)
            tri3 = coords[faces.long()]  # (F, 3, 3)
            start, w, counts = _candidate_counts(tri3, self._origin, self._voxel_size, n)
            total = int(_read(sp, counts.sum()))
            face, cell = _expand_candidates(start, w, counts, total, n)
            self.num_candidates = total
            sp.count("candidates", total)

        with span("vox.plan.windows", dev):
            xlo, xhi = _x_windows(tri3, face, cell, vs64, spec)
            # A batch's band starts at its first slot's 32-aligned window
            # base, so a candidate is narrow iff its window fits a band
            # from that base. One key sorts the narrow candidates by
            # (tile, window start) and the wide ones after them by tile.
            narrow = xhi < ((xlo // WORD_BITS) * WORD_BITS).clamp(max=n - band) + band
            tile = cell // tc
            key = torch.where(narrow, tile * n + xlo, tile + num_tiles * n)
            del narrow, tile

        with span("vox.plan.batches", dev) as sp:
            key, order = torch.sort(key, stable=True)
            xlo, xhi = xlo[order].int(), xhi[order].int()
            local = (cell[order] % tc).int()
            tri = face[order].int()
            del order, cell, face
            probes = torch.arange(num_tiles + 1, dtype=key.dtype, device=dev)
            tbounds = torch.searchsorted(key, probes * n, out_int32=True)
            wbounds = torch.searchsorted(key, probes + num_tiles * n)
            counts = band_cut_counts(xlo, xhi, tbounds, n=n, band=band, tb=tb)
            off, pads, nb = _pack_runs(counts, g, PACK)
            got = _read(sp, torch.cat([nb.view(1), wbounds.diff()]))
            nb, w_counts = int(got[0]), got[1:]
            if nb:
                batch_tile, batch_base, starts, ends = band_cut(
                    xlo, xhi, tbounds, off, pads, total=nb, n=n, band=band, tb=tb)
            else:  # empty narrow set: one inert batch on tile 0, padded
                nb = 1 + (-1) % PACK
                batch_tile, batch_base, starts, ends = torch.zeros(
                    (4, nb), dtype=torch.int32, device=dev)
            bt_host, base_host = _read(sp, torch.stack([batch_tile, batch_base]))
            self.num_batches = nb
            self.num_slots = nb * tb
            _check_range(bt_host, "batch_tile", 0, num_tiles)
            _check_range(base_host // WORD_BITS, "batch_basew", 0,
                         (n - band) // WORD_BITS + 1)
            # Wide fallback: whole-axis batches over a compact tile set
            # (the wide candidates touch k << num_tiles tiles).
            self.num_wide = int(w_counts.sum())
            if self.num_wide:
                uidx = np.flatnonzero(w_counts)
                k = len(uidx)
                bw = np.concatenate([[0], np.cumsum(w_counts[uidx])])
                w_ctiles, w_starts, w_ends = tile_batches(bw, tb)
                _check_range(w_ctiles, "w_ctile", 0, k)
                self.num_batches += len(w_ctiles)
            sp.count("batches", self.num_batches)
            sp.count("wide", self.num_wide)

        with span("vox.plan.upload", dev) as sp:
            # The uploads first, while nothing is queued; then the slot
            # gathers on the device.
            layout = fill_layout(bt_host, num_tiles, dev, nw=nw, tc=tc)
            sp.count("host_bytes", layout.start.nbytes + layout.order.nbytes)
            wide, wide_layout = None, None
            if self.num_wide:
                ws, we = (_upload(sp, a, dev, np.int64) for a in (w_starts, w_ends))
                w_maps = [_upload(sp, a, dev, np.int32) for a in (uidx[w_ctiles], w_ctiles,
                                                                  uidx)]
                wide_layout = fill_layout(w_ctiles, k, dev, nw=nw, tc=tc, name="w_ctile")
                sp.count("host_bytes", wide_layout.start.nbytes + wide_layout.order.nbytes)
            tri9 = _vertex_rows(tri3)
            rows, local_b = _slot_rows(_gather_batches(tri, starts, ends, tb=tb, fill=0),
                                       _gather_batches(local, starts, ends, tb=tb, fill=-1),
                                       tri9, TB_SUB)
            if self.num_wide:
                nn = total - self.num_wide
                w_rows, w_local = _slot_rows(
                    _gather_batches(tri[nn:], ws, we, tb=tb, fill=0),
                    _gather_batches(local[nn:], ws, we, tb=tb, fill=-1), tri9, TB_SUB)
                wide = (w_rows, w_local, *w_maps)
            self.state = BandedState(rows=rows, local=local_b, batch_tile=batch_tile,
                                     batch_basew=batch_base // WORD_BITS, wide=wide,
                                     layout=layout, wide_layout=wide_layout)

    def words(self):
        """One call: (words (n, n, n/32) int32, overflow () int64)."""
        return banded_total(self.state, self._origin, self._voxel_size,
                            n=self.spec.n, tc=self.tc, band=self.band)

    def __call__(self) -> VoxelGrid:
        words, overflow = self.words()
        if int(overflow) != 0:
            raise RuntimeError(
                f"{int(overflow)} fragments left their baked x-bands "
                "(coords drifted); rebuild the pipeline")
        return VoxelGrid(words=words, origin=self._origin.clone(),
                         voxel_size=self._voxel_size.clone())
