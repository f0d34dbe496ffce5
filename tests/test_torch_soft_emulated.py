"""The soft kernels' CUDA source (B7, B8, B13 fwd / bwd), run on the CPU.

Without a card the wrappers run the plain versions, so the CPU tests
never reach `csrc/soft_vox.cu`: the record passes of B7 and B13, their
transition windows, the shared accumulation's saturated-column
differences and their scan, its per-batch work lists; the row prefix
and the window sums that B8 and B13 bwd share, B8's ranged row sums.
Here the source is compiled with the host C++ compiler against
`tests/cuda_emulation.h` (blocks one after another, a block's threads as
host threads with real barriers, shuffles and atomics) and launched
through its C entry points.

- B7 is held bitwise against a full-row evaluation written here in C++
  through the same device functions (`fused_frag`, `sigmoid`,
  `fix_add`, `fix_value`): every (slot, column) pair, as the kernel
  computed before it took windows. Slots put x_hit at every eighth of a
  voxel from 40 voxels left of the grid to 40 right of it (so at every
  offset around a window's ends and the 64-column chunk edges), far
  outside the grid on both sides, with w = 0, +-1, fractions, |w| > 1,
  and NaN and inf in w and in x_hit; at tau_x of half a voxel, two
  voxels, and 40 voxels (a window wider than the row).
- B7 is held against `fused_fwd_plain` within 1e-4 where every input is
  finite and |w| <= 1 (torch's sigmoid is not the host's expf).
- B8 is held against `fused_bwd_plain` within 1e-3 x max|plain| on the
  same slots (finite) and on a fused plan of an icosphere.
- B13 fwd is held bitwise against the full-row B13 it replaced, written
  out here (every pair of a slot's read (w, x_hit) through `fix_add`),
  on the same slots' fragments, and within 1e-4 of
  `fragment_fwd_plain` where they are finite with |w| <= 1 and on a
  `SoftCudaPlan` of the icosphere.
- B13 bwd is held against `fragment_bwd_plain` within 1e-3 x max|plain|
  on those slots and that plan, and a cotangent row with a NaN or an
  inf puts NaN and inf into (dw, dx_hit) where the plain version does.
- `chip_smoke.window_widths`, the count behind the soft kernels' bound,
  equals the windows of B7's slot records.

Skips where no C++20 compiler is installed.
"""

import ctypes

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import soft_vox_cuda as C
from voxtpu_torch.ops import soft_vox_fused as F
from voxtpu_torch.ops.soft_vox import f32, make_soft_plan, soft_fragments, temperatures

from tests.emulation import build_host_library

OCC_TOL = 1e-4
GRAD_TOL = 1e-3
N, TC, TB = 160, 128, 128  # three 64-column chunks, the last one partial
ORIGIN, VS = (0.1, -0.23, 0.37), 0.0731

# The full-row B7: every (slot, column) pair through the kernel's own
# device functions, summed into its own fixed-point accumulator.
REFERENCE = r"""
#include "soft_vox.cu"
#include <vector>

extern "C" int ref_fused_fwd(const float* tables, const int* cells, const int* tblidx,
                             const int* batch_tile, int num_batches, int tb, int tbl,
                             int n, int tc, int num_tiles, float ox, float oy, float oz,
                             float vs, float tau_e, float tau_x, float* out) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc, 0};
  std::vector<u64> acc((size_t)num_tiles * tc * n, 0ull);
  std::vector<unsigned> bad(acc.size(), 0u);
  for (int b = 0; b < num_batches; ++b) {
    const int tile = batch_tile[b];
    if (tile < 0 || tile >= num_tiles) continue;
    for (int s = 0; s < tb; ++s) {
      const long long k = (long long)b * tb + s;
      const int c = cells[k];
      if (c < 0 || c >= tc) continue;
      const float* at = table_row(tables, tblidx, k, b, tbl);
      if (!at) continue;
      const int row = tile * tc + c;
      const Frag f = fused_frag(at, row, g);
      for (int x = 0; x < n; ++x) {
        const float v = f.w * sigmoid((f.xh - center(g.ox, x, g.vs)) / g.tau_x);
        fix_add(&acc[(size_t)row * n + x], &bad[(size_t)row * n + x], 1u, v);
      }
    }
  }
  for (size_t i = 0; i < acc.size(); ++i) out[i] = fix_value(acc[i], bad[i] & 1u);
  return 0;
}

// The full-row B13 fwd: every pair of a slot's read (w, xh).
extern "C" int ref_fragment_fwd(const float* wb, const float* xb, const int* cells,
                                const int* batch_tile, int num_batches, int tb, int n,
                                int tc, int num_tiles, float ox, float vs, float tau_x,
                                float* out) {
  std::vector<u64> acc((size_t)num_tiles * tc * n, 0ull);
  std::vector<unsigned> bad(acc.size(), 0u);
  for (int b = 0; b < num_batches; ++b) {
    const int tile = batch_tile[b];
    if (tile < 0 || tile >= num_tiles) continue;
    for (int s = 0; s < tb; ++s) {
      const long long k = (long long)b * tb + s;
      const int c = cells[k];
      if (c < 0 || c >= tc) continue;
      const size_t row = (size_t)tile * tc + c;
      for (int x = 0; x < n; ++x) {
        const float v = wb[k] * sigmoid((xb[k] - center(ox, x, vs)) / tau_x);
        fix_add(&acc[row * n + x], &bad[row * n + x], 1u, v);
      }
    }
  }
  for (size_t i = 0; i < acc.size(); ++i) out[i] = fix_value(acc[i], bad[i] & 1u);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    files = {name: (_build.CSRC / name).read_text()
             for name in ("soft_vox.cu", "soft_common.cuh")}
    files["reference.cc"] = REFERENCE
    so = build_host_library(tmp_path_factory.mktemp("soft_emulated"), files,
                            ["reference.cc"], "soft_emulated")
    library = ctypes.CDLL(str(so))
    for entry in ("vt_fused_fwd", "vt_fused_bwd", "vt_fragment_fwd", "vt_fragment_bwd"):
        getattr(library, entry).argtypes = _build.SIGNATURES[entry]
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    library.ref_fused_fwd.argtypes = [P] * 4 + [I] * 6 + [Fl] * 6 + [P]
    library.ref_fragment_fwd.argtypes = [P] * 4 + [I] * 5 + [Fl] * 3 + [P]
    return library


def _prm(tau_x_vox: float):
    return tuple(f32(o) for o in ORIGIN) + (f32(VS), f32(0.5 * VS * VS),
                                            f32(tau_x_vox * VS))


def _slots(special: bool):
    """(tables, cells_b, tblidx_b, batch_tile): one slot a table row,
    x_hit = the plane's P (Q = R = 0) at every eighth of a voxel from 40
    voxels left of the grid to 40 right of it, w = the facing multiplier
    times a coverage that is 1 for some slots and a fraction for others;
    with `special`, x_hit far outside and NaN / inf, w NaN / inf and
    |w| > 1. Each batch's slots lie in one tile, some of them pads or
    out-of-table rows."""
    rng = np.random.default_rng(7)
    ox = ORIGIN[0]
    xh = ox + np.arange(-40 * 8, (N + 40) * 8) * (VS / 8)
    wm = rng.choice([1.0, -1.0, 0.7, -0.3, 0.0], size=xh.size)
    if special:
        far = np.array([1e30, -1e30, 3e38, -3e38, np.nan, np.inf, -np.inf, ox, ox])
        xh = np.concatenate([xh, far, rng.uniform(ox, ox + N * VS, 12)])
        wm = np.concatenate([wm, rng.choice([1.0, -0.7], far.size),
                             [np.nan, np.inf, -np.inf, 1.5, -2.0, 1e30] * 2])
    count = xh.size
    nb = -(-count // TB)
    tables = np.zeros((nb, TB, F.NATTR), np.float32)
    flat = tables.reshape(-1, F.NATTR)
    full = rng.random(count) < 0.5  # edges far inside: coverage exactly 1
    edge = np.where(full, 40.0, rng.uniform(-3, 3, count)) * (0.5 * VS * VS)
    flat[:count, 2] = flat[:count, 5] = flat[:count, 8] = edge
    flat[:count, 9] = xh
    flat[:count, 12] = wm
    cells = np.full((nb * TB,), -1, np.int32)
    cells[:count] = rng.integers(0, TC, count)
    cells[5] = -1                                # a pad among live slots
    tblidx = np.tile(np.arange(TB, dtype=np.int32), nb)
    tblidx[9] = TB                               # outside the table: inert
    tiles = np.sort(rng.choice(np.array([3, 17, 60, N * N // TC - 1], np.int32), nb))
    return (torch.from_numpy(tables), torch.from_numpy(cells.reshape(nb, 1, TB)),
            torch.from_numpy(tblidx.reshape(nb, 1, TB)), torch.from_numpy(tiles))


def _b7(lib, tables, cells, tblidx, tiles, prm, work=None):
    run_start = torch.from_numpy(F.tile_runs(tiles.numpy()))
    out = torch.zeros((N, N, N), dtype=torch.float32)
    if work is None:
        work = torch.empty((cells.numel(), 4), dtype=torch.int32)
    err = lib.vt_fused_fwd(tables.data_ptr(), cells.data_ptr(), tblidx.data_ptr(),
                           tiles.data_ptr(), run_start.data_ptr(), tables.shape[0],
                           run_start.numel() - 1, TB, tables.shape[1], N, TC,
                           N * N // TC, *prm, work.data_ptr(), out.data_ptr(), None)
    assert err == 0, f"launch error {err}"
    return out


def _b8(lib, tables, cells, tblidx, tiles, g, n, tc, prm):
    dtab = torch.zeros_like(tables)
    pre = torch.empty((n * n, n), dtype=torch.float64)
    err = lib.vt_fused_bwd(tables.data_ptr(), cells.data_ptr(), tblidx.data_ptr(),
                           tiles.data_ptr(), g.data_ptr(), tables.shape[0],
                           cells[0].numel(), tables.shape[1], n, tc, n * n // tc, *prm,
                           pre.data_ptr(), dtab.data_ptr(), None)
    assert err == 0, f"launch error {err}"
    return dtab


def _full_row(lib, tables, cells, tblidx, tiles, prm):
    out = torch.zeros((N, N, N), dtype=torch.float32)
    lib.ref_fused_fwd(tables.data_ptr(), cells.data_ptr(), tblidx.data_ptr(),
                      tiles.data_ptr(), tables.shape[0], TB, tables.shape[1], N, TC,
                      N * N // TC, *prm, out.data_ptr())
    return out


@pytest.mark.parametrize("tau_x_vox", [0.5, 2.0, 40.0])
def test_windowed_b7_is_bitwise_the_full_row(lib, tau_x_vox):
    args = _slots(special=True)
    prm = _prm(tau_x_vox)
    got = _b7(lib, *args, prm)
    want = _full_row(lib, *args, prm)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(want).any()) and float(want.nan_to_num().abs().max()) > 0.5


@pytest.mark.parametrize("tau_x_vox", [0.5, 40.0])
def test_windowed_b7_matches_plain(lib, tau_x_vox):
    args = _slots(special=False)
    prm = _prm(tau_x_vox)
    want = F.fused_fwd_plain(*args, n=N, tc=TC, prm=prm)
    got = _b7(lib, *args, prm)
    assert float(want.abs().max()) > 0.5
    assert float((got - want).abs().max()) <= OCC_TOL


def _icosphere(n: int):
    """A jittered icosphere(3) and its soft plan at n, pad 2."""
    c, f = procedural.icosphere(3, center=(0.1, -0.2, 0.3))
    c = (c + np.random.default_rng(n).normal(0, 1e-3, c.shape)).astype(np.float32)
    mesh = Mesh(name="icosphere", coords=c, faces=f, faces_normals=f)
    return c, make_soft_plan(mesh, GridSpec.fit(c, n), pad_window=2)


def _icosphere_plan(n: int):
    c, sp = _icosphere(n)
    plan = F.FusedSoftPlan(sp, "cpu", tb_sub=1, tbl=64)
    with torch.no_grad():
        tables = F.tables_of(torch.from_numpy(c), plan)
    return plan, tables


@pytest.mark.parametrize("case", ["slots", "icosphere"])
def test_windowed_b8_matches_plain(lib, case):
    if case == "slots":
        tables, cells, tblidx, tiles = _slots(special=False)
        n, tc, prm = N, TC, _prm(0.5)
    else:
        plan, tables = _icosphere_plan(48)
        cells, tblidx, tiles = plan.cells_d, plan.tblidx_d, plan.batch_tile_d
        n, tc, prm = plan.spec.n, plan.tc, plan.prm(0.5, 0.5)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((n, n, n)).astype(
        np.float32))
    want = F.fused_bwd_plain(tables, cells, tblidx, tiles, g, n=n, tc=tc, prm=prm)
    got = _b8(lib, tables, cells, tblidx, tiles, g, n, tc, prm)
    top = float(want.abs().max())
    assert top > 0
    assert float((got - want).abs().max()) <= GRAD_TOL * top


@pytest.mark.parametrize("tau_x_vox", [0.5, 2.0, 40.0])
def test_smoke_window_count_is_the_kernels(lib, tau_x_vox):
    """`chip_smoke.window_widths`, which counts the soft kernels' bound,
    gives every live slot the window that B7's record pass gives it."""
    import chip_smoke

    tables, cells, tblidx, tiles = _slots(special=True)
    prm = _prm(tau_x_vox)
    run_start = torch.from_numpy(F.tile_runs(tiles.numpy()))
    work = torch.empty((cells.numel(), 4), dtype=torch.int32)
    _b7(lib, tables, cells, tblidx, tiles, prm, work)
    valid, *_, w, xh = F._fused_slots(tables, cells, tblidx, tiles, 0, tables.shape[0],
                                      n=N, tc=TC, prm=prm)
    valid, w, xh = valid.reshape(-1), w.reshape(-1), xh.reshape(-1)
    ok = (w.abs() <= 1) & torch.isfinite(xh)
    got = chip_smoke.window_widths(xh[valid], ok[valid], N, prm[0], prm[3], prm[5])
    rec = work[valid, 3]
    assert bool((work[~valid, 0] == -1).all()) and bool((work[valid, 0] >= 0).all())
    assert torch.equal(got, ((rec >> 16) - (rec & 0xFFFF)).long())
    assert int(got.min()) < N and run_start.numel() > 1


@pytest.mark.parametrize("variant", ["b7_cas", "b8_row_sums"])
def test_exact_ablation_variants_are_bitwise_as_is(lib, tmp_path, variant):
    """`tools/ablate_soft_kernels.py`'s exact variants (B7's 64-bit adds
    as one 64-bit atomic, B8's table rows summed by `row_sums` over every
    slot) give B7 and B8 bit for bit; every variant's substitutions
    still apply to the source."""
    from tools import ablate_soft_kernels as A

    for name in A.VARIANTS:
        A.variant_sources(name)
    files = A.variant_sources(variant)
    other = ctypes.CDLL(str(build_host_library(tmp_path, files, ["soft_vox.cu"], variant)))
    for entry in ("vt_fused_fwd", "vt_fused_bwd"):
        getattr(other, entry).argtypes = _build.SIGNATURES[entry]
    plan, tables = _icosphere_plan(48)
    args = (tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d)
    n, tc, prm = plan.spec.n, plan.tc, plan.prm(0.5, 0.5)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((n, n, n)).astype(
        np.float32))
    outs = []
    for library in (lib, other):
        out = torch.zeros((n, n, n), dtype=torch.float32)
        work = torch.empty((plan.cells_d.numel(), 4), dtype=torch.int32)
        assert library.vt_fused_fwd(
            *(t.data_ptr() for t in args), plan.run_start_d.data_ptr(), tables.shape[0],
            plan.run_start_d.numel() - 1, plan.cells_d[0].numel(), tables.shape[1], n, tc,
            n * n // tc, *prm, work.data_ptr(), out.data_ptr(), None) == 0
        outs.append((out, _b8(library, *args, g, n, tc, prm)))
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# B13: the same slots as B7's, their fragments (w, x_hit) read.

def _fragment_slots(special: bool, prm):
    """(wb, xb, cells_b, batch_tile) of `_slots`: each slot's w and
    x_hit as the plain fused version rebuilds them from its table row;
    the pad and the out-of-table slot are pads here, with w = 0.5 so
    that reading them would show."""
    tables, cells, tblidx, tiles = _slots(special)
    nb = tables.shape[0]
    valid, *_, w, xh = F._fused_slots(tables, cells, tblidx, tiles, 0, nb, n=N, tc=TC,
                                      prm=prm)
    shape = cells.shape
    cells = torch.where(valid, cells.view(nb, -1), -1).view(shape).contiguous()
    wb = torch.where(valid, w, 0.5).view(shape).contiguous()
    xb = torch.where(valid, xh, 0.0).view(shape).contiguous()
    return wb, xb, cells, tiles


def _fragment_plan(n: int, tau_x_vox: float = 0.5):
    """(wb, xb, cells_b, batch_tile, run_start) of a SoftCudaPlan of the
    jittered icosphere at n, and its (ox, vs, tau_x)."""
    c, sp = _icosphere(n)
    cp = C.SoftCudaPlan(sp, "cpu")
    vs, _, tau_x = temperatures(sp.spec, 0.5, tau_x_vox)
    with torch.no_grad():
        _, w, x = soft_fragments(torch.from_numpy(c), sp, tau_edge_frac=0.5,
                                 tau_x_frac=tau_x_vox)
        wb, xb = C._Permute.apply(w, x, cp)
    return (wb, xb, cp.cells_d, cp.batch_tile_d, cp.run_start_d), (f32(sp.spec.origin[0]),
                                                                    vs, tau_x)


def _b13_prm(prm):
    return prm[0], prm[3], prm[5]


def _b13f(lib, wb, xb, cells, tiles, n, tc, prm, run_start=None):
    if run_start is None:
        run_start = torch.from_numpy(F.tile_runs(tiles.numpy()))
    out = torch.zeros((n, n, n), dtype=torch.float32)
    work = torch.empty((cells.numel(), 4), dtype=torch.int32)
    err = lib.vt_fragment_fwd(wb.data_ptr(), xb.data_ptr(), cells.data_ptr(),
                              tiles.data_ptr(), run_start.data_ptr(), cells.shape[0],
                              run_start.numel() - 1, cells[0].numel(), n, tc, n * n // tc,
                              *prm, work.data_ptr(), out.data_ptr(), None)
    assert err == 0, f"launch error {err}"
    return out


def _b13b(lib, wb, xb, cells, tiles, g, n, tc, prm):
    dw, dx = torch.full_like(wb, 7.0), torch.full_like(xb, 7.0)  # every slot is written
    pre = torch.empty((n * n, n), dtype=torch.float64)
    err = lib.vt_fragment_bwd(wb.data_ptr(), xb.data_ptr(), cells.data_ptr(),
                              tiles.data_ptr(), g.data_ptr(), cells.shape[0],
                              cells[0].numel(), n, tc, n * n // tc, *prm, pre.data_ptr(),
                              dw.data_ptr(), dx.data_ptr(), None)
    assert err == 0, f"launch error {err}"
    return dw, dx


def _cotangent(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, n, n)).astype(
        np.float32))


@pytest.mark.parametrize("tau_x_vox", [0.5, 2.0, 40.0])
def test_windowed_b13_fwd_is_bitwise_the_full_row(lib, tau_x_vox):
    prm = _prm(tau_x_vox)
    wb, xb, cells, tiles = _fragment_slots(True, prm)
    prm = _b13_prm(prm)
    got = _b13f(lib, wb, xb, cells, tiles, N, TC, prm)
    want = torch.zeros((N, N, N), dtype=torch.float32)
    lib.ref_fragment_fwd(wb.data_ptr(), xb.data_ptr(), cells.data_ptr(), tiles.data_ptr(),
                         cells.shape[0], TB, N, TC, N * N // TC, *prm, want.data_ptr())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(want).any()) and float(want.nan_to_num().abs().max()) > 0.5
    assert not bool(torch.isfinite(wb).all()) and bool((wb.abs() > 1).any())


@pytest.mark.parametrize("case", ["slots-0.5", "slots-40", "icosphere"])
def test_windowed_b13_fwd_matches_plain(lib, case):
    if case == "icosphere":
        (wb, xb, cells, tiles, run_start), prm = _fragment_plan(48)
        n, tc = 48, C.TILE_CELLS
    else:
        prm = _prm(float(case.split("-")[1]))
        wb, xb, cells, tiles = _fragment_slots(False, prm)
        prm, n, tc, run_start = _b13_prm(prm), N, TC, None
    want = C.fragment_fwd_plain(wb, xb, cells, tiles, n=n, tc=tc, prm=prm)
    got = _b13f(lib, wb, xb, cells, tiles, n, tc, prm, run_start)
    assert float(want.abs().max()) > 0.5
    assert float((got - want).abs().max()) <= OCC_TOL


@pytest.mark.parametrize("case", ["slots-0.5", "icosphere-0.5", "icosphere-40"])
def test_windowed_b13_bwd_matches_plain(lib, case):
    """On the slot sweep (at N = 160, where the emulated row prefix is
    the test's cost) and on the icosphere's plan, its windows ~23
    columns or (tau_x of 40 voxels) the whole row."""
    where, tau_x_vox = case.split("-")
    if where == "icosphere":
        (wb, xb, cells, tiles, _), prm = _fragment_plan(48, float(tau_x_vox))
        n, tc = 48, C.TILE_CELLS
    else:
        prm = _prm(float(tau_x_vox))
        wb, xb, cells, tiles = _fragment_slots(False, prm)
        prm, n, tc = _b13_prm(prm), N, TC
    g = _cotangent(n, 3)
    want = C.fragment_bwd_plain(wb, xb, cells, tiles, g, n=n, tc=tc, prm=prm)
    got = _b13b(lib, wb, xb, cells, tiles, g, n, tc, prm)
    for got_d, want_d in zip(got, want):
        top = float(want_d.abs().max())
        assert top > 0
        assert float((got_d - want_d).abs().max()) <= GRAD_TOL * top
    assert bool((got[0][cells < 0] == 0).all()) and bool((got[1][cells < 0] == 0).all())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_windowed_b13_bwd_non_finite_row_as_plain(lib, bad):
    """One cotangent value that is not finite, on the icosphere's plan:
    the slots of its row take the whole row (the prefix's row total is
    not finite) and get NaN and inf where the plain version puts them;
    every other slot stays finite and within the tolerance."""
    (wb, xb, cells, tiles, _), prm = _fragment_plan(48)
    n, tc = 48, C.TILE_CELLS
    rows = C._slot_rows(cells, tiles, n=n, tc=tc).view(cells.shape)
    row = int(torch.mode(rows[cells >= 0]).values)  # a row of many slots
    g = _cotangent(n, 4)
    g.view(n * n, n)[row, 37] = bad
    want = C.fragment_bwd_plain(wb, xb, cells, tiles, g, n=n, tc=tc, prm=prm)
    got = _b13b(lib, wb, xb, cells, tiles, g, n, tc, prm)
    hit = rows == row
    for got_d, want_d in zip(got, want):
        if bad != bad:  # NaN times anything is NaN: the positions are exact
            assert torch.equal(torch.isnan(got_d), torch.isnan(want_d))
            assert torch.equal(torch.isinf(got_d), torch.isinf(want_d))
        else:  # inf * sig is inf, or NaN where a sigmoid underflows to 0
            assert torch.equal(~torch.isfinite(got_d), ~torch.isfinite(want_d))
        assert bool((~torch.isfinite(got_d[hit])).all()) and int(hit.sum()) > 1
        assert bool(torch.isfinite(got_d[~hit]).all())
        top = float(want_d[~hit].abs().max())
        assert float((got_d[~hit] - want_d[~hit]).abs().max()) <= GRAD_TOL * top
