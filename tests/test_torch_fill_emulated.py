"""The fill kernels B1 and B2's CUDA source, run on the CPU against their plain versions.

Without a card the wrappers run `banded_fill_plain` and
`wide_fill_plain`, so the CPU tests never reach `csrc/vox_fill.cu`: its
per-tile batch ranges, the cluster's shared batches and distributed
shared-memory reduction, the marker-bit carries, the cell groups where a
tile's rows do not fit one block, and the write-out in uint4 units
(nw % 4 == 0 on a 16-byte output) or words. Here the source is compiled
with the host C++ compiler against `tests/cuda_emulation.h` (a cluster's
blocks together, each with its own shared memory; a block's threads as
host threads with real barriers; atomics as `std::atomic_ref`) and
launched through its C entry points. Tolerance: bitwise, against the
plain versions, on icosphere and icosahedron plans and on hand-made
slots: inert slots, duplicates, x = 0, 31, n - 1 and both band edges,
odd carries, batches outside the tile range or the row, a tile with
more batches than its cluster's blocks, and tiles with none. The output
starts as a pattern, so a word the kernel does not write shows; the
in-place B2 starts from a random grid, whose untouched tiles must stay.
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
from voxtpu_torch.ops.vox_cuda import TB_LANE, fill_layout, wide_fill_plain
from voxtpu_torch.ops.vox_slots_banded import (BandedSlotVoxPipeline, banded_fill_plain,
                                               emit_slots)

from tests.emulation import build_host_library

UNWRITTEN = 0x5A5A5A5A


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = build_host_library(tmp_path_factory.mktemp("fill_emulated"),
                            {"vox_fill.cu": (_build.CSRC / "vox_fill.cu").read_text()},
                            ["vox_fill.cu"], "fill_emulated")
    library = ctypes.CDLL(str(so))
    for name in ("vt_banded_fill", "vt_wide_fill"):
        getattr(library, name).argtypes = _build.SIGNATURES[name]
    return library


def _b1(lib, local, xs, tiles, basew, *, n, tc, band, cluster):
    """B1 through its C entry, on the plan's layout of `tiles` ->
    (error code, the (n, n, n/32) words)."""
    num_tiles = n * n // tc
    lay = fill_layout(tiles.numpy(), num_tiles, "cpu", nw=n // 32, tc=tc)
    out = torch.full((n, n, n // 32), UNWRITTEN, dtype=torch.int32)
    err = lib.vt_banded_fill(local.data_ptr(), xs.data_ptr(), basew.data_ptr(),
                             lay.start.data_ptr(), lay.order.data_ptr(), local.shape[0],
                             local.shape[1] * local.shape[2], tc, n // 32, band // 32,
                             num_tiles, lay.nbusy, cluster, out.data_ptr(), None)
    return err, out


def _b2(lib, local, xs, tiles, *, n, tc, num_tiles, cluster, into=None, tile_map=None,
        offset=0):
    """B2 through its C entry, on the plan's layout of `tiles`: into a
    fresh (num_tiles, tc, n/32) buffer (whose words start `offset` words
    into its storage), or in place into the grid `into` through
    `tile_map` -> (error code, the words)."""
    nw = n // 32
    lay = fill_layout(tiles.numpy(), num_tiles, "cpu", nw=nw, tc=tc)
    if into is None:
        store = torch.full((num_tiles * tc * nw + offset,), UNWRITTEN, dtype=torch.int32)
        out = store[offset:].view(num_tiles, tc, nw)
        out_tiles, ptr, mp = num_tiles, out.data_ptr(), None
    else:
        out, out_tiles = into, n * n // tc
        ptr, mp = into.data_ptr(), tile_map.data_ptr()
    err = lib.vt_wide_fill(local.data_ptr(), xs.data_ptr(), lay.start.data_ptr(),
                           lay.order.data_ptr(), mp, local.shape[0],
                           local.shape[1] * local.shape[2], tc, nw, num_tiles, lay.nbusy,
                           out_tiles, cluster, ptr, None)
    return err, out


def _pipe(name, n, band):
    make = {"icosphere": lambda: procedural.icosphere(3, center=(0.1, -0.2, 0.3)),
            "icosahedron": procedural.icosahedron}[name]
    coords, faces = make()
    mesh = Mesh(name=name, coords=coords, faces=faces, faces_normals=faces)
    spec = GridSpec.fit(coords, n)
    pipe = BandedSlotVoxPipeline(mesh, spec, "cpu", band=band)
    banded, wide, _ = emit_slots(pipe.state, spec.origin_tensor("cpu"),
                                 spec.voxel_size_tensor("cpu"), n=n, tc=pipe.tc,
                                 band=pipe.band)
    return pipe, banded, wide


# n = 64: nw = 2, words; n = 128: nw = 4, uint4; n = 96: nw = 3, words;
# clusters of 2 and the plan's own cluster size (1: every tile of these
# plans is busy; the hand-made cases below take 1-4, a cluster of 3
# splitting 32 cells 11 / 11 / 10). Every busy tile runs a block of 512
# host threads a cluster rank, so the plans stay small. B2 in place
# only at n = 128 (its compact form is the same kernel, checked on
# every plan at n = 64 and 96 and on the hand-made slots).
@pytest.mark.parametrize("name,n,band,cluster", [("icosphere", 64, 32, 2),
                                                 ("icosphere", 128, 64, None),
                                                 ("icosahedron", 96, 32, None)])
def test_fill_source_is_bitwise_plain_on_plans(lib, name, n, band, cluster):
    pipe, (lk, xs), wide = _pipe(name, n, band)
    st = pipe.state
    err, got = _b1(lib, lk, xs, st.batch_tile, st.batch_basew, n=n, tc=pipe.tc, band=band,
                   cluster=cluster or st.layout.cluster)
    assert err == 0
    want = banded_fill_plain(lk, xs, st.batch_tile, st.batch_basew, n=n, tc=pipe.tc,
                             band=band)
    assert torch.equal(got, want) and bool((got != 0).any())
    if wide is None:
        return
    w_ctile, w_uidx = st.wide[3], st.wide[4]
    k = w_uidx.shape[0]
    w_want = wide_fill_plain(*wide, w_ctile, n=n, tc=pipe.tc, num_tiles=k)
    if n != 128:
        err, compact = _b2(lib, *wide, w_ctile, n=n, tc=pipe.tc, num_tiles=k,
                           cluster=cluster or st.wide_layout.cluster)
        assert err == 0 and torch.equal(compact, w_want)
    grid = got.clone()
    err, _ = _b2(lib, *wide, w_ctile, n=n, tc=pipe.tc, num_tiles=k,
                 cluster=cluster or st.wide_layout.cluster, into=grid, tile_map=w_uidx)
    assert err == 0
    want.view(-1, pipe.tc, n // 32)[w_uidx.long()] ^= w_want
    assert torch.equal(grid, want)


def _hand_made(n, tc, band, tiles, seed):
    """Slots of every kind on batches of `tiles` (sorted; entries outside
    [0, n*n/tc) are skipped): random slots (inert cells, x anywhere,
    duplicates by chance) and, in each batch, x = 0, 31, n - 1, the band's
    first and last column and the columns just outside it, duplicates at
    one (cell, x) (an even count: no carry) and an odd count at another."""
    rng = np.random.default_rng(seed)
    nw, bwords = n // 32, band // 32
    shape = (len(tiles), 1, TB_LANE)
    basew = rng.integers(0, nw - bwords + 1, len(tiles))
    local = rng.integers(-1, tc + 1, shape)
    xs = rng.integers(-2, n + 2, shape)
    for b, bw in enumerate(basew):
        lo, hi = 32 * bw, 32 * bw + band
        made = [(1, 0), (2, 31), (3, n - 1), (4, lo), (5, hi - 1), (6, lo - 1), (7, hi),
                (8, lo + 5), (8, lo + 5), (9, lo + 40 % band), (9, lo + 40 % band),
                (9, lo + 40 % band), (tc - 1, lo + 33 % band), (0, hi - 32)]
        for i, (c, x) in enumerate(made):
            local[b, 0, i], xs[b, 0, i] = c, x
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    return t(local), t(xs), t(np.asarray(tiles)), t(basew)


def _kept(tiles, num_tiles, basew=None, nw=0, bwords=0):
    keep = (tiles >= 0) & (tiles < num_tiles)
    if basew is not None:
        keep &= (basew >= 0) & (basew + bwords <= nw)
    return keep


# A tile with 9 batches on clusters of 1, 2 and 4 blocks (9, 5 and 3
# batches a block), the tiles between without a batch (written by zero
# writers), batches on tiles -1 and num_tiles, and bands off the row's
# ends (skipped; tile 0's one batch is, so its cluster finds no slot and
# writes zeros). At n = 128, tc = 32: 32 KB of zero writes a block is 64
# tiles.
@pytest.mark.parametrize("n,tc,band,cluster", [
    (64, 128, 32, 1), (64, 64, 64, 2), (128, 128, 64, 4), (96, 32, 64, 3),
    (128, 32, 64, 2)])
def test_b1_source_is_bitwise_plain_on_hand_made_slots(lib, n, tc, band, cluster):
    num_tiles = n * n // tc
    tiles = [-1, 0] + [3] * 9 + [4, num_tiles - 1, num_tiles]
    local, xs, tiles, basew = _hand_made(n, tc, band, tiles, seed=n + tc)
    basew[1] = -1                                 # band before the row: skipped
    basew[5] = n // 32 - band // 32 + 1           # band past the row's end: skipped
    err, got = _b1(lib, local, xs, tiles, basew, n=n, tc=tc, band=band, cluster=cluster)
    assert err == 0
    keep = _kept(tiles, num_tiles, basew, n // 32, band // 32)
    want = banded_fill_plain(local[keep], xs[keep], tiles[keep], basew[keep], n=n, tc=tc,
                             band=band)
    assert torch.equal(got, want)
    assert bool((want.view(num_tiles, -1)[3] != 0).any())


# Whole rows: nw = 2 (words), 4 (uint4), 3 (words), 128 (uint4, four
# marker words a cell); and 512 (n = 16384: a tile's rows exceed one
# block, so two cell groups of 64).
@pytest.mark.parametrize("n,tc,num_tiles,cluster", [
    (64, 128, 3, 2), (128, 64, 4, 4), (96, 128, 2, 1), (4096, 128, 2, 3),
    (16384, 128, 1, 2)])
def test_b2_source_is_bitwise_plain_on_hand_made_slots(lib, n, tc, num_tiles, cluster):
    tiles = [-1] + [0] * 2 + [num_tiles - 1] * 7 + [num_tiles]
    local, xs, tiles, _ = _hand_made(n, tc, n, tiles, seed=n)
    keep = _kept(tiles, num_tiles)
    want = wide_fill_plain(local[keep], xs[keep], tiles[keep], n=n, tc=tc,
                           num_tiles=num_tiles)
    err, got = _b2(lib, local, xs, tiles, n=n, tc=tc, num_tiles=num_tiles, cluster=cluster)
    assert err == 0
    assert torch.equal(got, want) and bool((want != 0).any())


def test_b2_source_in_place_and_off_16_bytes(lib):
    """In place: the mapped tiles take the XOR, the others stay as they
    were; out of place on an output one word past a 16-byte boundary
    (nw % 4 == 0): word stores."""
    n, tc, num_tiles = 128, 128, 3
    tiles = [0] * 5 + [2] * 2
    local, xs, tiles, _ = _hand_made(n, tc, n, tiles, seed=3)
    want = wide_fill_plain(local, xs, tiles, n=n, tc=tc, num_tiles=num_tiles)
    err, got = _b2(lib, local, xs, tiles, n=n, tc=tc, num_tiles=num_tiles, cluster=2,
                   offset=1)
    assert err == 0 and torch.equal(got, want)
    grid = torch.from_numpy(np.random.default_rng(5).integers(
        -2 ** 31, 2 ** 31, (n, n, n // 32), dtype=np.int64).astype(np.int32))
    tile_map = torch.tensor([100, 7, 64], dtype=torch.int32)
    expect = grid.clone()
    expect.view(-1, tc, n // 32)[tile_map.long()] ^= want
    for cluster in (3, 1):  # compact tile 1 holds no batch: left as it is
        err, got = _b2(lib, local, xs, tiles, n=n, tc=tc, num_tiles=num_tiles,
                       cluster=cluster, into=grid, tile_map=tile_map)
        assert err == 0 and torch.equal(got, expect)
        expect.view(-1, tc, n // 32)[tile_map.long()] ^= want  # applied again next


def test_fill_entries_refuse_bad_geometry(lib):
    """A cluster outside 1-16 or a band wider than the row is refused
    before anything is written."""
    local, xs, tiles, basew = _hand_made(64, 128, 32, [0, 1], seed=1)
    for cluster in (0, 17):
        err, got = _b1(lib, local, xs, tiles, basew, n=64, tc=128, band=32, cluster=cluster)
        assert err != 0 and bool((got == UNWRITTEN).all())
        err, got = _b2(lib, local, xs, tiles, n=64, tc=128, num_tiles=2, cluster=cluster)
        assert err != 0 and bool((got == UNWRITTEN).all())
    err, got = _b1(lib, local, xs, tiles, basew, n=64, tc=128, band=96, cluster=1)
    assert err != 0 and bool((got == UNWRITTEN).all())
