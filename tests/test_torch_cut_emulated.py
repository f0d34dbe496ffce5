"""The serving plan's band cut's CUDA source, run on the CPU against its plain version.

Without a card the plan runs `band_cut_counts_plain` and
`band_cut_plain`, so the CPU tests never reach `csrc/vox_plan.cu`: a
warp a tile, 32 slots tested a vote (`__ballot_sync`), the first set bit
ending the batch, the count and write passes and the pad batches. Here
the source is compiled with the host C++ compiler against
`tests/cuda_emulation.h` and launched through its C entry points.
Tolerance: bitwise, against the plain versions and against voxtpu's own
form of the cut (its host loop, `vox_slots_banded.py:389-448`, written
out below), on hand-made sorted slots (a tile of exactly tb slots and
one of tb + 1, violations at a batch's first and last slot, windows on
a 32-boundary, a base clamped to n - band, empty tiles, groups that
need no pad and one, no narrow slot at all) and on the slots of the
icosphere's and the torus's plans. The outputs start as a pattern, so
an entry the kernel does not write shows. Skips where no C++20 compiler
is installed.
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
from voxtpu_torch.ops import vox_slots_banded as vsb

from tests.emulation import build_host_library

UNWRITTEN = 0x5A5A5A5A


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = build_host_library(tmp_path_factory.mktemp("cut_emulated"),
                            {"vox_plan.cu": (_build.CSRC / "vox_plan.cu").read_text()},
                            ["vox_plan.cu"], "cut_emulated")
    library = ctypes.CDLL(str(so))
    for name in ("vt_band_cut_counts", "vt_band_cut"):
        getattr(library, name).argtypes = _build.SIGNATURES[name]
    return library


def _cut(lib, xlo, xhi, tbounds, *, n, band, tb, g, pack=vsb.PACK):
    """Both passes through the C entries, the runs packed between them as
    the plan packs them -> (counts, (batch_tile, batch_base, start, end))."""
    num_tiles = tbounds.shape[0] - 1
    counts = torch.full((num_tiles,), UNWRITTEN, dtype=torch.int32)
    assert lib.vt_band_cut_counts(xlo.data_ptr(), xhi.data_ptr(), tbounds.data_ptr(),
                                  counts.data_ptr(), num_tiles, n, band, tb, None) == 0
    off, pads, total = vsb._pack_runs(counts, g, pack)
    out = torch.full((4, int(total)), UNWRITTEN, dtype=torch.int32)
    assert lib.vt_band_cut(xlo.data_ptr(), xhi.data_ptr(), tbounds.data_ptr(),
                           off.data_ptr(), pads.data_ptr(), *(r.data_ptr() for r in out),
                           num_tiles, n, band, tb, None) == 0
    return counts, tuple(out)


def _voxtpu_cut(xlo, xhi, tbounds, *, n, band, tb, g, pack=vsb.PACK):
    """voxtpu's host cut and PACK padding (`vox_slots_banded.py:389-425`),
    as it is written there, on the same sorted slots -> four int32 arrays
    (no inert batch for an empty set: the plan adds that)."""
    xlo_s, xhi_s, tbounds = xlo.numpy(), xhi.numpy(), tbounds.numpy()
    batch_tile, batch_base, starts, ends = [], [], [], []
    for t in np.nonzero(np.diff(tbounds))[0]:
        i, b1 = int(tbounds[t]), int(tbounds[t + 1])
        while i < b1:
            base = min((int(xlo_s[i]) // 32) * 32, n - band)
            w_end = min(i + tb, b1)
            viol = xhi_s[i:w_end] >= base + band
            k0 = i + int(np.argmax(viol)) if viol.any() else w_end
            batch_tile.append(int(t))
            batch_base.append(base)
            starts.append(i)
            ends.append(k0)
            i = k0
    bt2, bb2, st2, en2 = [], [], [], []
    i = 0
    while i < len(batch_tile):
        j = i
        while j < len(batch_tile) and batch_tile[j] // g == batch_tile[i] // g:
            j += 1
        bt2 += batch_tile[i:j]
        bb2 += batch_base[i:j]
        st2 += starts[i:j]
        en2 += ends[i:j]
        for _ in range((-(j - i)) % pack):
            bt2.append(batch_tile[j - 1])
            bb2.append(batch_base[j - 1])
            st2.append(0)
            en2.append(0)
        i = j
    return tuple(np.asarray(a, np.int32) for a in (bt2, bb2, st2, en2))


def _check(lib, xlo, xhi, tbounds, *, n, band, tb, g):
    """The kernel's passes bitwise its plain versions and voxtpu's cut;
    returns the batches."""
    counts, got = _cut(lib, xlo, xhi, tbounds, n=n, band=band, tb=tb, g=g)
    assert torch.equal(counts, vsb.band_cut_counts_plain(xlo, xhi, tbounds, n=n, band=band,
                                                         tb=tb))
    off, pads, total = vsb._pack_runs(counts, g, vsb.PACK)
    plain = vsb.band_cut_plain(xlo, xhi, tbounds, off, pads, total=int(total), n=n,
                               band=band, tb=tb)
    want = _voxtpu_cut(xlo, xhi, tbounds, n=n, band=band, tb=tb, g=g)
    for a, b, c in zip(got, plain, want):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), c)
    return got


def _slots(tiles, n, band, seed):
    """Sorted narrow slots on `len(tiles)` tiles, tile t holding
    `tiles[t]` (count, or a list of (xlo, xhi) windows): random windows a
    few cells wide where only a count is given."""
    rng = np.random.default_rng(seed)
    xlo, xhi, bounds = [], [], [0]
    for spec in tiles:
        if isinstance(spec, int):
            lo = np.sort(rng.integers(0, n, spec))
            hi = lo + rng.integers(0, 6, spec)
            base = np.minimum(lo // 32 * 32, n - band)
            hi = np.minimum(np.minimum(hi, base + band - 1), n - 1)
            spec = list(zip(lo, hi))
        for lo, hi in spec:
            assert hi < min(lo // 32 * 32, n - band) + band, "a slot must be narrow"
        xlo += [lo for lo, _ in spec]
        xhi += [hi for _, hi in spec]
        bounds.append(bounds[-1] + len(spec))

    def t(a):
        return torch.tensor(a, dtype=torch.int32)

    return t(xlo), t(xhi), t(bounds)


def test_cut_source_on_tiles_of_tb_and_tb_plus_one_slots(lib):
    """A tile of exactly tb slots is one batch (padded to two), tb + 1
    two, the last a slot of its own on its own base, at the plan's tb
    (one load round of 512 slots a batch), at 40 (a round whose slots
    past tb are not read), at 1100 (three rounds, the last of 76 slots)
    and at 513 (the next batch's first slot just past the second round)."""
    n, band = 256, 64
    for tb in (512, 40, 1100, 513):
        one = [(5, 9)] * tb
        xlo, xhi, tbounds = _slots([one, one + [(40, 50)]], n, band, seed=tb)
        got = _check(lib, xlo, xhi, tbounds, n=n, band=band, tb=tb, g=1)
        assert list(zip(*(a.tolist() for a in got))) == [
            (0, 0, 0, tb), (0, 0, 0, 0), (1, 0, tb, 2 * tb), (1, 32, 2 * tb, 2 * tb + 1)]


def test_cut_source_ends_batches_at_their_first_and_last_slot(lib):
    """A violation right after a batch's first slot (a one-slot batch)
    and at the tb-th slot, a batch starting on a 32-boundary (its base
    the window's start) after one just before it, and bases clamped to
    n - band (96 -> 64)."""
    n, band, tb = 128, 64, 40
    tile0 = [(0, 3), (40, 70)]
    tile1 = [(32, 33)] + [(33, 60)] * (tb - 2) + [(64, 100), (96, 99)]
    tile2 = [(31, 34), (32, 70), (33, 95)]
    tile3 = [(100, 101), (127, 127)]
    xlo, xhi, tbounds = _slots([tile0, tile1, tile2, tile3], n, band, seed=1)
    got = _check(lib, xlo, xhi, tbounds, n=n, band=band, tb=tb, g=1)
    t2 = 2 + tb + 1
    t3 = t2 + 3
    assert list(zip(*(a.tolist() for a in got))) == [
        (0, 0, 0, 1), (0, 32, 1, 2),
        (1, 32, 2, 2 + tb - 1), (1, 64, 2 + tb - 1, 2 + tb + 1),
        (2, 0, t2, t2 + 1), (2, 32, t2 + 1, t2 + 3),
        (3, 64, t3, t3 + 2), (3, 64, 0, 0)]


@pytest.mark.parametrize("g", [1, 2, 4])
def test_cut_source_pads_groups_and_skips_empty_tiles(lib, g):
    """Random sorted slots on 16 tiles, some empty, some with several
    batches: every group of g tiles padded to an even run after its last
    busy tile (groups needing no pad and one), empty groups none."""
    n, band, tb = 256, 64, 40
    tiles = [0, 7, 0, 0, 120, 3, 0, 1, 0, 0, 0, 0, 45, 0, 81, 2]
    xlo, xhi, tbounds = _slots(tiles, n, band, seed=g)
    bt, _, st, en = _check(lib, xlo, xhi, tbounds, n=n, band=band, tb=tb, g=g)
    runs = np.bincount(bt.numpy() // g, minlength=16 // g)
    assert (runs % 2 == 0).all() and (runs[[t // g for t in range(16) if tiles[t]]] > 0).all()
    assert int((en - st).sum()) == sum(tiles)


def test_cut_source_on_no_narrow_slot(lib):
    """Every tile empty: no batch, nothing written; the plan then makes
    its one inert batch on tile 0."""
    xlo, xhi, tbounds = _slots([0, 0, 0, 0], 64, 32, seed=0)
    counts, got = _cut(lib, xlo, xhi, tbounds, n=64, band=32, tb=512, g=2)
    assert counts.tolist() == [0, 0, 0, 0] and all(a.numel() == 0 for a in got)


@pytest.mark.parametrize("name,n,band", [("icosphere", 64, 32), ("torus", 128, 64),
                                         ("torus", 64, 256)])
def test_cut_source_is_bitwise_plain_on_plans(lib, monkeypatch, name, n, band):
    """The sorted slots the plan hands its cut, caught on the CPU."""
    make = {"icosphere": lambda: procedural.icosphere(3, center=(0.1, -0.2, 0.3)),
            "torus": lambda: procedural.torus(1.0, 0.35, 48, 24)}[name]
    coords, faces = make()
    mesh = Mesh(name=name, coords=coords, faces=faces, faces_normals=faces)
    seen = {}
    counts = vsb.band_cut_counts

    def catch(xlo, xhi, tbounds, **kw):
        seen.update(xlo=xlo.clone(), xhi=xhi.clone(), tbounds=tbounds.clone(), **kw)
        return counts(xlo, xhi, tbounds, **kw)

    monkeypatch.setattr(vsb, "band_cut_counts", catch)
    pipe = vsb.BandedSlotVoxPipeline(mesh, GridSpec.fit(coords, n), "cpu", band=band)
    g = vsb._group_factor(n // 32, pipe.num_tiles)
    bt, bb, st, en = _check(lib, seen["xlo"], seen["xhi"], seen["tbounds"], n=n,
                            band=seen["band"], tb=seen["tb"], g=g)
    assert torch.equal(bt, pipe.state.batch_tile)
    assert torch.equal(bb // 32, pipe.state.batch_basew)


def test_cut_entries_refuse_bad_arguments(lib):
    """A band outside [32, n] or tb < 1 is refused before anything runs."""
    xlo, xhi, tbounds = _slots([3], 64, 32, seed=2)
    counts = torch.full((1,), UNWRITTEN, dtype=torch.int32)
    for band, tb in ((16, 512), (96, 512), (32, 0)):
        err = lib.vt_band_cut_counts(xlo.data_ptr(), xhi.data_ptr(), tbounds.data_ptr(),
                                     counts.data_ptr(), 1, 64, band, tb, None)
        assert err != 0 and counts.tolist() == [UNWRITTEN]
