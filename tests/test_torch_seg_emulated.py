"""The seg soft kernels' CUDA source (B9, B10, B11), run on the CPU.

Without a card the wrappers run the plain versions, so the CPU tests
never reach `csrc/soft_vox_seg.cu`: B9's record pass, its transition
windows clipped to the panel, the saturated panel columns as per-cell
differences and their scan, the carry taken from the half-0 block's
base; B10's whole-panel blocks, float4 lanes and cell offsets; B11's
windows, its in-panel prefix, its finite-panel flags and ranged row
sums. Here the source is compiled with the host C++ compiler
against `tests/cuda_emulation.h` (blocks one after another, a block's
threads as host threads with real barriers, shuffles and atomics) and
launched through its C entry points.

- B9 is held bitwise (out_a, out_b, carry) against a whole-panel
  evaluation written here in C++ through the same device functions
  (`tile_cell`, `frag_at`, `sigmoid`, `fix_add`, `fix_value`): every
  (slot, panel column) pair, as the kernel computed before it took
  windows. Slots put x_hit at every eighth of a voxel from 40 voxels
  left of their panel to 40 right of it (so windows that lie partly or
  wholly outside the panel: stale panels), in panels of both families
  (p0 % 128 == 0: p0 = 0 and the row's last, 128; p0 % 128 == 64: 64),
  with w = 0, +-1, fractions, |w| > 1, NaN and inf, and x_hit NaN, inf
  and far outside the grid; at tau_x of half a voxel, one voxel and the
  seg guard's 32/17 voxels.
- B9 is held against `seg_fwd_plain` within 1e-4 where every input is
  finite and |w| <= 1 (torch's sigmoid is not the host's expf), and B11
  against `seg_bwd_plain` within 1e-3 x max|plain|, on the same slots
  and on a seg plan of a small icosphere at n = 256 (the engine's
  floor).
- B10 is held bitwise against `seg_combine_plain` on seeded random
  out_a, out_b and carries at n = 256 and 384 (the engine's floor, and
  three panels) with square tiles of 128 and 64 cells; a NaN carry must
  put NaN where the plain version does. Its C entry must refuse a
  geometry it cannot take.
- `chip_smoke.seg_window_widths` and `chip_smoke.seg_windows`, the
  counts behind B9's and B11's bounds, equal the windows of B9's own
  slot records.

Skips where no C++20 compiler is installed.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import soft_vox_fused as F
from voxtpu_torch.ops import soft_vox_seg as S
from voxtpu_torch.ops.soft_vox import f32, make_soft_plan

from tests.emulation import build_host_library

OCC_TOL = 1e-4
GRAD_TOL = 1e-3
N, TC, TZ, TB = 256, 128, 8, 128
NT = N * N // TC
PANELS = (0, 64, 128)  # family A, family B, family A and the row's last panel
ORIGIN, VS = (0.1, -0.23, 0.37), 0.0731

# The whole-panel B9: every (slot, panel column) pair through the
# kernel's own device functions, summed into fixed-point accumulators
# laid out as out_a, out_b and the carry.
REFERENCE = r"""
#include "soft_vox_seg.cu"
#include <vector>

extern "C" int ref_seg_fwd(const float* tables, const int* cells, const int* tblidx,
                           const int* batch_tile, const int* batch_panel, int num_batches,
                           int tb, int tbl, int n, int tc, int tz, int num_tiles, float ox,
                           float oy, float oz, float vs, float tau_e, float tau_x,
                           float* out_a, float* out_b, float* carry) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc, tz};
  const int nblk = n / kPanel, ng = n / kLattice;
  const size_t fam = (size_t)num_tiles * nblk * tc * kPanel;
  std::vector<u64> acc(2 * fam, 0ull), cacc((size_t)num_tiles * ng * tc, 0ull);
  std::vector<unsigned> bad(acc.size(), 0u), cbad(cacc.size(), 0u);
  for (int b = 0; b < num_batches; ++b) {
    const int tile = batch_tile[b];
    const int p0 = batch_panel[b];
    if (tile < 0 || tile >= num_tiles || !panel_ok(p0, n)) continue;
    const int fam_b = (p0 / kLattice) % 2;
    const int blk = (p0 - fam_b * kLattice) / kPanel;
    for (int s = 0; s < tb; ++s) {
      const long long k = (long long)b * tb + s;
      const int c = cells[k];
      if (c < 0 || c >= tc) continue;
      const float* at = table_row(tables, tblidx, k, b, tbl);
      if (!at) continue;
      int gy, gz;
      tile_cell(tile, c, g, &gy, &gz);
      const Frag f = frag_at(at, center(g.oy, gy, g.vs), center(g.oz, gz, g.vs), g);
      const size_t ci = ((size_t)tile * ng + p0 / kLattice) * tc + c;
      fix_add(&cacc[ci], &cbad[ci], 1u, f.w);
      const size_t row = fam_b * fam + (((size_t)tile * nblk + blk) * tc + c) * kPanel;
      for (int l = 0; l < kPanel; ++l) {
        const float v = f.w * sigmoid((f.xh - center(g.ox, p0 + l, g.vs)) / g.tau_x);
        fix_add(&acc[row + l], &bad[row + l], 1u, v);
      }
    }
  }
  for (size_t i = 0; i < fam; ++i) {
    out_a[i] = fix_value(acc[i], bad[i] & 1u);
    out_b[i] = fix_value(acc[fam + i], bad[fam + i] & 1u);
  }
  for (size_t i = 0; i < cacc.size(); ++i) carry[i] = fix_value(cacc[i], cbad[i] & 1u);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    files = {name: (_build.CSRC / name).read_text()
             for name in ("soft_vox_seg.cu", "soft_common.cuh")}
    files["reference.cc"] = REFERENCE
    so = build_host_library(tmp_path_factory.mktemp("seg_emulated"), files,
                            ["reference.cc"], "seg_emulated")
    library = ctypes.CDLL(str(so))
    for entry in ("vt_seg_fwd", "vt_seg_combine", "vt_seg_bwd"):
        getattr(library, entry).argtypes = _build.SIGNATURES[entry]
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    library.ref_seg_fwd.argtypes = [P] * 5 + [I] * 7 + [Fl] * 6 + [P] * 3
    return library


def _prm(tau_x_vox: float):
    return tuple(f32(o) for o in ORIGIN) + (f32(VS), f32(0.5 * VS * VS),
                                            f32(tau_x_vox * VS))


def _sweep(special: bool):
    """(tables, cells_b, tblidx_b, batch_tile, batch_panel): one slot a
    table row, x_hit = the plane's P (Q = R = 0) at every eighth of a
    voxel from 40 voxels left of the slot's panel to 40 right of it, in
    each panel of PANELS; w = the facing multiplier times a coverage that
    is 1 for some slots and a fraction for others; with `special`,
    x_hit far outside and NaN / inf, w NaN / inf and |w| > 1. A batch's
    slots share a tile and a panel, some of them pads or out-of-table
    rows; the batches are sorted by (tile, panel), so each key is one
    run."""
    rng = np.random.default_rng(7)
    ox = ORIGIN[0]
    steps = np.arange(-40 * 8, (S.PANEL + 40) * 8) / 8.0
    xh = np.concatenate([ox + (p0 + steps) * VS for p0 in PANELS])
    panel = np.repeat(np.int32(PANELS), steps.size)
    wm = rng.choice([1.0, -1.0, 0.7, -0.3, 0.0], size=xh.size)
    if special:
        far = np.array([1e30, -1e30, 3e38, -3e38, np.nan, np.inf, -np.inf, ox, ox])
        extra = np.concatenate([far, ox + (64 + rng.uniform(0, 128, 12)) * VS])
        xh = np.concatenate([xh, extra, extra])
        panel = np.concatenate([panel, np.full(2 * extra.size, 64, np.int32)])
        wm = np.concatenate([wm, rng.choice([1.0, -0.7], far.size),
                             [np.nan, np.inf, -np.inf, 1.5, -2.0, 1e30] * 2,
                             rng.choice([np.nan, np.inf, 1.5, -1.0], extra.size)])
    count = xh.size
    full = rng.random(count) < 0.5  # edges far inside: coverage exactly 1
    edge = np.where(full, 40.0, rng.uniform(-3, 3, count)) * (0.5 * VS * VS)
    rows, tiles, panels = [], [], []
    for p0 in PANELS:
        idx = np.flatnonzero(panel == p0)
        for i, chunk in enumerate(np.array_split(idx, -(-idx.size // TB))):
            rows.append(chunk)
            tiles.append((3, 200, NT - 1)[i % 3])
            panels.append(p0)
    order = np.lexsort((panels, tiles))
    nb = len(rows)
    tables = np.zeros((nb, TB, F.NATTR), np.float32)
    cells = np.full((nb, TB), -1, np.int32)
    for b, j in enumerate(order):
        r = rows[j]
        tables[b, :r.size, 2] = tables[b, :r.size, 5] = tables[b, :r.size, 8] = edge[r]
        tables[b, :r.size, 9] = xh[r]
        tables[b, :r.size, 12] = wm[r]
        cells[b, :r.size] = rng.integers(0, TC, r.size)
    cells[0, 5] = -1                              # a pad among live slots
    tblidx = np.tile(np.arange(TB, dtype=np.int32), (nb, 1))
    tblidx[1, 9] = TB                             # outside the table: inert
    return (torch.from_numpy(tables), torch.from_numpy(cells.reshape(nb, 1, TB)),
            torch.from_numpy(tblidx.reshape(nb, 1, TB)),
            torch.from_numpy(np.int32(tiles)[order]),
            torch.from_numpy(np.int32(panels)[order]))


def _outputs(n: int, tc: int):
    nt = n * n // tc
    out_a = torch.zeros((nt, n // S.PANEL, tc, S.PANEL), dtype=torch.float32)
    return out_a, torch.zeros_like(out_a), torch.zeros((nt, n // S.LATTICE, tc))


def _b9(lib, tables, cells, tblidx, tiles, panels, n, tc, tz, prm, work=None):
    key = tiles.numpy().astype(np.int64) * n + panels.numpy()
    run_start = torch.from_numpy(F.tile_runs(key))
    out_a, out_b, carry = _outputs(n, tc)
    if work is None:
        work = torch.empty((cells.numel(), 4), dtype=torch.int32)
    err = lib.vt_seg_fwd(tables.data_ptr(), cells.data_ptr(), tblidx.data_ptr(),
                         tiles.data_ptr(), panels.data_ptr(), run_start.data_ptr(),
                         tables.shape[0], run_start.numel() - 1, cells[0].numel(),
                         tables.shape[1], n, tc, tz, n * n // tc, *prm, work.data_ptr(),
                         out_a.data_ptr(), out_b.data_ptr(), carry.data_ptr(), None)
    assert err == 0, f"launch error {err}"
    return out_a, out_b, carry


def _b11(lib, tables, cells, tblidx, tiles, panels, g, n, tc, tz, prm):
    dtab = torch.zeros_like(tables)
    gpre = S.seg_gpre(g)
    err = lib.vt_seg_bwd(tables.data_ptr(), cells.data_ptr(), tblidx.data_ptr(),
                         tiles.data_ptr(), panels.data_ptr(), g.data_ptr(), gpre.data_ptr(),
                         tables.shape[0], cells[0].numel(), tables.shape[1], n, tc, tz,
                         n * n // tc, *prm, dtab.data_ptr(), None)
    assert err == 0, f"launch error {err}"
    return dtab, gpre


def _b10(lib, out_a, out_b, carry, n, tc, tz, out=None):
    pre = S.carry_prefix(carry).contiguous()
    if out is None:
        out = torch.full((n, n, n), -7.0)
    return lib.vt_seg_combine(out_a.data_ptr(), out_b.data_ptr(), pre.data_ptr(), n, tc, tz,
                              out.data_ptr(), None), out


def _whole_panel(lib, tables, cells, tblidx, tiles, panels, prm):
    out_a, out_b, carry = _outputs(N, TC)
    lib.ref_seg_fwd(tables.data_ptr(), cells.data_ptr(), tblidx.data_ptr(), tiles.data_ptr(),
                    panels.data_ptr(), tables.shape[0], TB, tables.shape[1], N, TC, TZ, NT,
                    *prm, out_a.data_ptr(), out_b.data_ptr(), carry.data_ptr())
    return out_a, out_b, carry


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("tau_x_vox", [0.5, 1.0, S.MARGIN / 17.0])
def test_windowed_b9_is_bitwise_the_whole_panel(lib, tau_x_vox):
    args = _sweep(special=True)
    prm = _prm(tau_x_vox)
    got = _b9(lib, *args, N, TC, TZ, prm)
    want = _whole_panel(lib, *args, prm)
    for name, x, y in zip(("out_a", "out_b", "carry"), got, want):
        assert torch.equal(_bits(x), _bits(y)), name
    out_a, out_b, carry = want
    assert bool(torch.isnan(out_b).any()) and bool(torch.isnan(carry).any())
    assert float(out_a.abs().max()) > 0.5 and float(out_b.nan_to_num().abs().max()) > 0.5


@pytest.mark.parametrize("tau_x_vox", [0.5, S.MARGIN / 17.0])
def test_windowed_b9_matches_plain(lib, tau_x_vox):
    args = _sweep(special=False)
    prm = _prm(tau_x_vox)
    want = S.seg_fwd_plain(*args, n=N, tc=TC, tz=TZ, prm=prm)
    got = _b9(lib, *args, N, TC, TZ, prm)
    assert float(want[0].abs().max()) > 0.5 and float(want[2].abs().max()) > 0.5
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= OCC_TOL


def _icosphere_plan():
    """A seg plan of an icosphere(2) spanning ~40 voxels of a 256^3 grid."""
    c, f = procedural.icosphere(2, center=(0.1, -0.2, 0.3))
    c = (c + np.random.default_rng(5).normal(0, 1e-3, c.shape)).astype(np.float32)
    side = float(np.ptp(c, axis=0).max())
    lo = c.min(axis=0) - 100.0 * side / 40.0
    spec = GridSpec(n=N, origin=tuple(float(v) for v in lo), voxel_size=side / 40.0)
    mesh = Mesh(name="icosphere", coords=c, faces=f, faces_normals=f)
    plan = S.SegSoftPlan(make_soft_plan(mesh, spec, pad_window=2), c, "cpu")
    with torch.no_grad():
        tables = F.tables_of(torch.from_numpy(c), plan)
    return plan, tables


@pytest.fixture(scope="module")
def icosphere():
    return _icosphere_plan()


def _plan_args(plan, tables):
    return (tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d, plan.batch_panel_d)


def test_windowed_b9_matches_plain_on_a_plan(lib, icosphere):
    plan, tables = icosphere
    args = _plan_args(plan, tables)
    prm = plan.prm(0.5, 0.5)
    want = S.seg_fwd_plain(*args, n=N, tc=plan.tc, tz=plan.tz, prm=prm)
    got = _b9(lib, *args, N, plan.tc, plan.tz, prm)
    assert float(S.seg_combine_plain(*want, n=N, tc=plan.tc, tz=plan.tz).max()) > 0.5
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= OCC_TOL


@pytest.mark.parametrize("case", ["sweep", "icosphere"])
def test_windowed_b11_matches_plain(lib, icosphere, case):
    if case == "sweep":
        args, tc, tz, prm = _sweep(special=False), TC, TZ, _prm(0.5)
    else:
        plan, tables = icosphere
        args, tc, tz, prm = _plan_args(plan, tables), plan.tc, plan.tz, plan.prm(0.5, 0.5)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((N, N, N)).astype(
        np.float32))
    got, gpre = _b11(lib, *args, g, N, tc, tz, prm)
    want = S.seg_bwd_plain(*args, g, gpre, n=N, tc=tc, tz=tz, prm=prm)
    top = float(want.abs().max())
    assert top > 0
    assert float((got - want).abs().max()) <= GRAD_TOL * top


def test_b11_takes_the_whole_panel_where_the_cotangent_is_not_finite(lib):
    """An inf in a panel's dropped columns (right of every window) reaches
    dw as the whole panel carries it: the plain version's non-finite table
    rows are the kernel's, its finite rows within the limit. One inf in
    the row's last panel (read from g), one in a middle panel (read from
    gpre)."""
    args = _sweep(special=False)
    tables, cells, tblidx, tiles, panels = args
    prm = _prm(0.5)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((N, N, N)).astype(
        np.float32))
    for b in (int(np.flatnonzero(panels.numpy() == 128)[0]),
              int(np.flatnonzero(panels.numpy() == 64)[0])):
        c = int(cells[b, 0, 0])
        ty = TC // TZ
        tile = int(tiles[b])
        y = (tile % (N // ty)) * ty + c % ty
        z = (tile // (N // ty)) * TZ + c // ty
        g[z, y, int(panels[b]) + S.PANEL - 1] = float("inf")
    got, gpre = _b11(lib, *args, g, N, TC, TZ, prm)
    want = S.seg_bwd_plain(*args, g, gpre, n=N, tc=TC, tz=TZ, prm=prm)
    bad = ~torch.isfinite(want)
    assert int(bad.any(-1).sum()) >= 2
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    top = float(want[~bad].abs().max())
    assert float((got[~bad] - want[~bad]).abs().max()) <= GRAD_TOL * top


@pytest.mark.parametrize("n", [256, 384])
@pytest.mark.parametrize("tc,tz", [(128, 8), (64, 8)])
def test_b10_source_is_bitwise_plain(lib, n, tc, tz):
    """B10 on seeded random family arrays and carries (some zero, as
    unvisited blocks are) against `seg_combine_plain`, bitwise; panel
    j = 0 takes no B' for its first 64 columns. A carry holding NaN (B9
    marks |w| > 1 so) puts NaN where the plain version does, every
    other value bitwise."""
    rng = np.random.default_rng(n + tc)
    nt = n * n // tc
    shape = (nt, n // S.PANEL, tc, S.PANEL)
    out_a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    out_b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    out_a[rng.random(nt) < 0.3] = 0.0
    carry = torch.from_numpy(rng.uniform(-1, 1, (nt, n // S.LATTICE, tc)).astype(np.float32))
    carry[rng.random(carry.shape) < 0.5] = 0.0
    err, got = _b10(lib, out_a, out_b, carry, n, tc, tz)
    assert err == 0, f"launch error {err}"
    want = S.seg_combine_plain(out_a, out_b, carry, n=n, tc=tc, tz=tz)
    assert torch.equal(_bits(got), _bits(want))
    carry[nt // 2, 1, tc // 3] = float("nan")
    carry[nt - 1, n // S.LATTICE - 1, tc - 1] = float("nan")
    err, got = _b10(lib, out_a, out_b, carry, n, tc, tz)
    assert err == 0
    want = S.seg_combine_plain(out_a, out_b, carry, n=n, tc=tc, tz=tz)
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got[~nan]), _bits(want[~nan]))


def test_b10_entry_refuses_a_geometry_it_cannot_take(lib):
    """n not a multiple of 128, tz not dividing tc, tc / tz not dividing
    n, or a misaligned array: an error, and the grid untouched."""
    n, tc, tz = 256, 128, 8
    out_a, out_b, carry = _outputs(n, tc)
    out = torch.full((n, n, n), -7.0)
    assert _b10(lib, out_a, out_b, carry, n, tc, tz, out)[0] == 0
    assert bool((out == 0).all())
    out.fill_(-7.0)
    flat = torch.zeros(out_a.numel() + 1)
    for n_, tc_, tz_, a in ((320, tc, tz, out_a), (n, tc, 6, out_a), (n, 96, 8, out_a),
                            (n, 0, tz, out_a), (n, tc, tz, flat[1:])):
        assert _b10(lib, a, out_b, carry, n_, tc_, tz_, out)[0] != 0, (n_, tc_, tz_)
    assert bool((out == -7.0).all())


def _record_widths(work, valid):
    rec = work.reshape(-1, 4)[valid.reshape(-1)]
    return ((rec[:, 3] >> 16) - (rec[:, 3] & 0xFFFF)).long()


@pytest.mark.parametrize("tau_x_vox", [0.5, 1.0, S.MARGIN / 17.0])
def test_smoke_seg_window_count_is_the_kernels(lib, tau_x_vox):
    """`chip_smoke.seg_window_widths`, which counts B9's and B11's bound,
    gives every live slot the clipped window that B9's record pass gives
    it; and `seg_windows` totals them over a plan's batches."""
    args = _sweep(special=True)
    tables, cells, tblidx, tiles, panels = args
    prm = _prm(tau_x_vox)
    work = torch.empty((cells.numel(), 4), dtype=torch.int32)
    _b9(lib, *args, N, TC, TZ, prm, work)
    valid, _, _, p0, *_, w, xh = S._seg_slots(tables, cells, tblidx, tiles, panels, 0,
                                              tables.shape[0], n=N, tc=TC, tz=TZ, prm=prm)
    p0 = p0.expand_as(w)
    ok = (w.abs() <= 1) & torch.isfinite(xh)
    got = chip_smoke.seg_window_widths(xh[valid], ok[valid], p0[valid], N, prm[0], prm[3],
                                       prm[5])
    flat = work.reshape(-1, 4)
    assert bool((flat[~valid.reshape(-1), 0] == -1).all())
    assert bool((flat[valid.reshape(-1), 0] >= 0).all())
    widths = _record_widths(work, valid)
    assert torch.equal(got, widths)
    assert int(got.min()) == 0 and int(got.max()) == S.PANEL
    assert bool(((got > 0) & (got < S.PANEL)).any())
    plan = SimpleNamespace(cells_d=cells, tblidx_d=tblidx, batch_tile_d=tiles,
                           batch_panel_d=panels, num_batches=tables.shape[0], tc=TC, tz=TZ,
                           spec=SimpleNamespace(n=N))
    assert chip_smoke.seg_windows(plan, tables, prm) == (int(valid.sum()), int(widths.sum()))


def test_smoke_seg_windows_on_a_plan(lib, icosphere):
    plan, tables = icosphere
    args = _plan_args(plan, tables)
    prm = plan.prm(0.5, 0.5)
    work = torch.empty((plan.cells_d.numel(), 4), dtype=torch.int32)
    _b9(lib, *args, N, plan.tc, plan.tz, prm, work)
    valid = work[:, 0] >= 0
    slots, pairs = chip_smoke.seg_windows(plan, tables, prm)
    assert slots == int(valid.sum()) == chip_smoke.live_slots(plan.cells_d)
    assert pairs == int(_record_widths(work, valid).sum())
    assert 10 < pairs / slots < 40


def test_smoke_seg_byte_counts_on_a_plan(icosphere):
    """`chip_smoke.table_bytes` and `seg_cotangent_bytes`, which count
    the reads of B9's and B11's bounds, against a count slot by slot:
    each distinct (batch, table row) of a live slot, and each distinct
    (cell row, 64-column half) of a live slot's panel."""
    plan, tables = icosphere
    nb, tbl = tables.shape[0], tables.shape[1]
    ty = plan.tc // plan.tz
    cells = plan.cells_d.reshape(nb, -1).numpy()
    idx = plan.tblidx_d.reshape(nb, -1).numpy()
    rows, halves = set(), set()
    for b in range(nb):
        t, p0 = int(plan.batch_tile_d[b]), int(plan.batch_panel_d[b])
        for c, i in zip(cells[b], idx[b]):
            if not (0 <= c < plan.tc and 0 <= i < tbl):
                continue
            rows.add((b, int(i)))
            y = (t % (N // ty)) * ty + c % ty
            z = (t // (N // ty)) * plan.tz + c // ty
            halves.update({(z, y, p0), (z, y, p0 + 64)})
    assert len(rows) < nb * tbl
    assert chip_smoke.table_bytes(tables, plan.cells_d, plan.tblidx_d, plan.tc) == \
        len(rows) * 16 * 4
    assert chip_smoke.seg_cotangent_bytes(plan, tables) == len(halves) * 64 * 4
