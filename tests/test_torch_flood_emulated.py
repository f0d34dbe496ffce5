"""The flood kernels' CUDA source, run on the CPU against the plain versions.

Without a card the wrappers run the plain versions, so the CPU tests
never reach `csrc/jfa.cu`'s index arithmetic: B3/B4's lattice walk
(its residue classes, column lattice, window, cp.async ring, source
plane order and skips), B6 and P1's `legacy`. Here the sources are
compiled with the host C++ compiler against `tests/cuda_emulation.h`
(blocks one after another, a block's threads as host threads with real
barriers, cp.async copies landing only when waited for) and launched
through their C entry points with the wrappers' own launch geometry
(`jfa_cuda._walk_geometry`). Tolerance: bitwise, against
`flood_step_plain` (and `flood_step_rows_plain` for the bands) at every
stride; B6's fused k = 1 step (emit_sdf) against `sdf_from_seed_plain`
after `flood_step_plain`, float32 bitwise. The dyadic grids make many seeds exactly equidistant,
so the candidate order and the own seed's precedence on ties are
tested. B5 (`vt_sdf_from_seed`, 4 voxels a thread as 16-byte vectors,
the unaligned ends of rows one by one) against `sdf_from_seed_plain`,
float32 bits compared (so -0 and +0 differ), at n = 32, 36 (9 vectors a
row), 35 and 66 (rows that start off a 16-byte boundary). Skips where
no C++20 compiler is installed.
"""

import ctypes

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.ops import jfa_cuda as J
from voxtpu_torch.ops.jfa import jfa_init_seed

from tests.emulation import build_host_library

OTHER = dict(origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
DYADIC = dict(origin=(0.5, -2.0, 1.25), voxel_size=0.0625)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    names = ("jfa.cu", "jfa_probe.cu", "jfa_common.cuh")
    so = build_host_library(tmp_path_factory.mktemp("flood_emulated"),
                            {name: (_build.CSRC / name).read_text() for name in names},
                            ["jfa.cu", "jfa_probe.cu"], "flood_emulated")
    library = ctypes.CDLL(str(so))
    for entry in ("vt_flood_step", "vt_flood_step_rows", "vt_flood_step_pipe",
                  "vt_flood_probe", "vt_sdf_from_seed"):
        getattr(library, entry).argtypes = _build.SIGNATURES[entry]
    return library


def _check(err: int) -> None:
    assert err == 0, f"launch error {err}"


def _b3(lib, seed, org, k):
    n = seed.shape[0]
    out = torch.full_like(seed, -2)
    _check(lib.vt_flood_step(seed.data_ptr(), out.data_ptr(), org.data_ptr(), n, k,
                             *J._walk_geometry(n, k, n).args(), None))
    return out


def _b4(lib, seed, org, k, band):
    n = seed.shape[0]
    band = min(band, n)
    out = torch.full_like(seed, -2)
    _check(lib.vt_flood_step_rows(seed.data_ptr(), out.data_ptr(), org.data_ptr(), n, k,
                                  band, *J._walk_geometry(n, k, band).args(), None))
    return out


def _b6(lib, seed, org, k, occ=None):
    """B6 through its C entry: int32 seeds, or with `occ` the float32
    signed distance (emit_sdf)."""
    n = seed.shape[0]
    if occ is None:
        out = torch.full_like(seed, -2)
    else:
        out = torch.full(seed.shape, float("nan"), dtype=torch.float32)
    _check(lib.vt_flood_step_pipe(seed.data_ptr(), 0 if occ is None else occ.data_ptr(),
                                  org.data_ptr(), out.data_ptr(), n, k, int(occ is not None),
                                  *J._walk_geometry(n, k, n).args(), None))
    return out


def _legacy(lib, seed, org, k):
    out = torch.full_like(seed, -2)
    _check(lib.vt_flood_probe(seed.data_ptr(), out.data_ptr(), org.data_ptr(),
                              seed.shape[0], k, 0, None))
    return out


def _occupancy(kind, n):
    rng = np.random.default_rng(n)
    occ = np.zeros((n, n, n), bool)
    if kind == "single":
        occ[n // 3, n // 2, n // 5] = True
    elif kind != "empty":
        occ = rng.random((n, n, n)) < {"sparse": 0.01, "dense": 0.3, "ties": 0.05}[kind]
    spec = GridSpec(n=n, **(DYADIC if kind == "ties" else OTHER))
    return torch.from_numpy(occ), J.org_tensor(spec, "cpu")


def _flood(kind, n):
    occ, org = _occupancy(kind, n)
    return jfa_init_seed(occ), org


# n = 32: strides below the 32-column tile (contiguous columns); n = 40
# and 66: strides from 32 up that do not divide n or 32 (a column lattice
# with idle lanes), bands that do not divide n.
@pytest.mark.parametrize("n,kind,bands", [
    (32, "sparse", (8, 5)), (32, "dense", (8,)), (32, "empty", (5,)),
    (32, "single", (8,)), (40, "ties", (7, 16)), (66, "dense", (33,)),
])
def test_walk_source_matches_plain_at_every_stride(lib, n, kind, bands):
    """B3 and B4 (several bands) from `csrc/jfa.cu` against their plain
    versions; B6 (the walk's third entry) where k divides n and P1's
    `legacy` against B3's."""
    seed, org = _flood(kind, n)
    k = n // 2
    while k >= 1:
        want = J.flood_step_plain(seed, org, k)
        assert torch.equal(_b3(lib, seed, org, k), want), k
        for band in bands:
            assert torch.equal(_b4(lib, seed, org, k, band), want), (k, band)
            assert torch.equal(J.flood_step_rows_plain(seed, org, k, band), want), (k, band)
        if n % k == 0:
            assert torch.equal(_b6(lib, seed, org, k), want), k
        assert torch.equal(_legacy(lib, seed, org, k), want), k
        seed = want
        k //= 2
    assert bool((seed < 0).all()) == (kind == "empty")


# The same grids; n = 40 and 66 as well, whose walks run a column lattice
# at the large strides before the fused k = 1 step.
@pytest.mark.parametrize("n,kind", [
    (32, "sparse"), (32, "dense"), (32, "empty"), (32, "single"), (40, "ties"),
    (66, "dense"),
])
def test_fused_sdf_step_source_is_b5_after_b3(lib, n, kind):
    """B6 with emit_sdf at k = 1, after the plain flood down to k = 2:
    bitwise B5 after B3 and bitwise its plain version; on the empty grid
    every value +-inf by the occupancy's sign."""
    occ, org = _occupancy(kind, n)
    seed = jfa_init_seed(occ)
    k = n // 2
    while k >= 2:
        seed = J.flood_step_plain(seed, org, k)
        k //= 2
    got = _b6(lib, seed, org, 1, occ)
    want = J.sdf_from_seed_plain(J.flood_step_plain(seed, org, 1), occ, org)
    assert torch.equal(got, want)
    assert torch.equal(got, J.flood_step_pipe_plain(seed, org, 1, occ))
    if kind == "empty":
        assert torch.equal(got, torch.full_like(got, -float("inf")))
    else:
        assert bool(torch.isfinite(got).all())


def _b5(lib, seed, occ, org, shift=0):
    """B5 through its C entry -> (error code, float32 out); `shift`
    offsets the seed pointer by that many bytes."""
    out = torch.full(seed.shape, float("nan"), dtype=torch.float32)
    err = lib.vt_sdf_from_seed(seed.data_ptr() + shift, occ.data_ptr(), org.data_ptr(),
                               out.data_ptr(), seed.shape[0], None)
    return err, out


def _sdf_case(kind, n):
    """(seed, occ, org): the plain flood's seeds of the grid kinds above;
    "random": packed seeds with random fields, a fifth -1, on random
    occupancy (seeds at their own voxel give +-0); "full": every voxel
    occupied and no seed (+inf everywhere)."""
    if kind == "full":
        return (torch.full((n, n, n), -1, dtype=torch.int32), torch.ones((n, n, n), dtype=torch.bool),
                J.org_tensor(GridSpec(n=n, **OTHER), "cpu"))
    if kind == "random":
        rng = np.random.default_rng(n + 1)
        f = rng.integers(0, n, (3, n, n, n))
        seed = np.where(rng.random((n, n, n)) < 0.2, -1, f[2] << 20 | f[1] << 10 | f[0])
        own = np.arange(n ** 3).reshape(n, n, n)
        pick = rng.random((n, n, n)) < 0.1  # a voxel's own seed: d2 = 0
        own_seed = (own // (n * n)) << 20 | (own // n % n) << 10 | own % n
        seed = np.where(pick, own_seed, seed).astype(np.int32)
        occ = torch.from_numpy(rng.random((n, n, n)) < 0.5)
        return torch.from_numpy(seed), occ, J.org_tensor(GridSpec(n=n, **DYADIC), "cpu")
    occ, org = _occupancy(kind, n)
    seed = jfa_init_seed(occ)
    k = n // 2
    while k >= 1:
        seed = J.flood_step_plain(seed, org, k)
        k //= 2
    return seed, occ, org


@pytest.mark.parametrize("n,kind", [
    (32, "sparse"), (32, "dense"), (32, "empty"), (32, "ties"), (36, "ties"), (36, "full"),
    (35, "random"), (66, "sparse"), (66, "random"),
])
def test_sdf_source_is_bitwise_plain(lib, n, kind):
    """B5 from `csrc/jfa.cu` against `sdf_from_seed_plain`, float32 bits;
    every voxel written (the output starts as NaN)."""
    seed, occ, org = _sdf_case(kind, n)
    err, got = _b5(lib, seed, occ, org)
    assert err == 0
    want = J.sdf_from_seed_plain(seed, occ, org)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if kind == "empty":
        assert torch.equal(got, torch.full_like(got, -float("inf")))
    if kind == "full":
        assert torch.equal(got, torch.full_like(got, float("inf")))
    if kind == "random":
        zeros = got == 0
        assert bool(torch.signbit(got[zeros]).any()) and bool((~torch.signbit(got[zeros])).any())


def test_sdf_entry_refuses_misaligned_arrays(lib):
    """B5 reads seeds as 16-byte vectors: a seed pointer off that
    alignment is refused, and nothing is written."""
    seed, occ, org = _sdf_case("sparse", 32)
    err, got = _b5(lib, seed, occ, org, shift=4)
    assert err != 0
    assert bool(torch.isnan(got).all())
