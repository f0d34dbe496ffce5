"""The fused plan's pair cut's CUDA source, run on the CPU against its plain version.

Without a card the plan runs `pair_cut_counts_plain` and
`pair_cut_plain`, so the CPU tests never reach `csrc/soft_plan.cu`: a
warp a run, 32 pairs tested a vote (`__ballot_sync`), the first set bit
ending the batch, the next batch's first slot by a shuffle, the count
and write passes. Here the source is compiled with the host C++ compiler
against `tests/cuda_emulation.h` and launched through its C entry
points. Tolerance: bitwise, against the plain versions and against
voxtpu's NumPy cut (`voxtpu.ops.soft_vox_fused._cut_batches`), on
hand-made pairs (a tile of exactly tb slots and one of tb + 1, exactly
tbl pairs and tbl + 1, batches that end on a load round's edge, empty
tiles and one tile holding everything, a pair over tb) and on the pairs
of the torus's plan. The outputs start as a pattern, so an entry the
kernel does not write shows. Skips where no C++20 compiler is installed.
"""

import ctypes

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu.ops import soft_vox_fused as J
from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import soft_vox_fused as F
from voxtpu_torch.ops.soft_vox import make_soft_plan
from voxtpu_torch.utils.trace import NULL_SPAN

from tests.emulation import build_host_library

UNWRITTEN = 0x5A5A5A5A


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = build_host_library(tmp_path_factory.mktemp("pair_cut_emulated"),
                            {"soft_plan.cu": (_build.CSRC / "soft_plan.cu").read_text()},
                            ["soft_plan.cu"], "pair_cut_emulated")
    library = ctypes.CDLL(str(so))
    for name in ("vt_pair_cut_counts", "vt_pair_cut"):
        getattr(library, name).argtypes = _build.SIGNATURES[name]
    return library


def _pairs(runs):
    """Pairs of the given slot counts, run by run -> (csum, pbounds) int32
    tensors."""
    sizes = [s for run in runs for s in run]
    csum = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).astype(np.int32)
    pbounds = np.concatenate([[0], np.cumsum([len(r) for r in runs])]).astype(np.int32)
    return torch.from_numpy(csum), torch.from_numpy(pbounds)


def _counts(lib, csum, pbounds, *, tb, tbl):
    counts = torch.full((pbounds.shape[0] - 1,), UNWRITTEN, dtype=torch.int32)
    assert lib.vt_pair_cut_counts(csum.data_ptr(), pbounds.data_ptr(), counts.data_ptr(),
                                  counts.shape[0], tb, tbl, None) == 0
    return counts


def _cut(lib, csum, pbounds, *, tb, tbl):
    """Both passes through the C entries, the counts scanned between them
    as the plan scans them -> (counts, (batch_run, p0, p1))."""
    counts = _counts(lib, csum, pbounds, tb=tb, tbl=tbl)
    off = (torch.cumsum(counts, 0) - counts).int()
    out = torch.full((3, int(counts.sum())), UNWRITTEN, dtype=torch.int32)
    assert lib.vt_pair_cut(csum.data_ptr(), pbounds.data_ptr(), off.data_ptr(),
                           *(r.data_ptr() for r in out), counts.shape[0], tb, tbl,
                           None) == 0
    return counts, off, tuple(out)


def _numpy_cut(csum, pbounds, *, tb, tbl):
    """voxtpu's cut (`_cut_batches`) on slots made from the pairs (each
    pair's face its index) -> (batch_run, p0, p1)."""
    sizes = np.diff(csum.numpy())
    run_of_pair = np.repeat(np.arange(pbounds.shape[0] - 1), np.diff(pbounds.numpy()))
    faces = np.repeat(np.arange(sizes.size), sizes)
    cut = J._cut_batches(np.repeat(run_of_pair, sizes), faces, np.zeros(faces.size, np.int32),
                         tb_sub=tb // 128, tbl=tbl)
    table = cut["table_face"]
    p0 = table[:, 0]
    return (cut["batch_key"].astype(np.int32), p0.astype(np.int32),
            (p0 + (table >= 0).sum(1)).astype(np.int32))


def _check(lib, runs, *, tb, tbl):
    """The kernel's passes bitwise their plain versions and voxtpu's
    cut; returns the batches as (run, p0, p1) rows."""
    csum, pbounds = _pairs(runs)
    counts, off, got = _cut(lib, csum, pbounds, tb=tb, tbl=tbl)
    assert torch.equal(counts, F.pair_cut_counts_plain(csum, pbounds, tb=tb, tbl=tbl))
    plain = F.pair_cut_plain(csum, pbounds, off, total=int(counts.sum()), tb=tb, tbl=tbl)
    want = _numpy_cut(csum, pbounds, tb=tb, tbl=tbl)
    for a, b, c in zip(got, plain, want):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), c)
    return list(zip(*(a.tolist() for a in got)))


@pytest.mark.parametrize("tbl", [128, 64, 300])
def test_pair_cut_source_on_tiles_of_tb_and_tb_plus_one_slots(lib, tbl):
    """A tile of exactly tb slots is one batch, tb + 1 two (the last pair
    of one slot on its own), with the slots in one pair, in pairs of
    one and two slots, and in a pair that fills the batch by itself."""
    tb = 256
    runs = [[tb], [tb, 1], [2] * (tb // 2), [2] * (tb // 2) + [1], [1, tb - 1], [1, tb]]
    got = _check(lib, runs, tb=tb, tbl=tbl)
    per_run = [sum(1 for r, _, _ in got if r == t) for t in range(len(runs))]
    small = tbl < tb // 2  # the pair cap, not the slots, ends the pairs of two
    assert per_run[:2] == [1, 2]
    assert per_run[2:4] == ([2, 3] if small else [1, 2])
    assert per_run[4:] == [1, 2]


@pytest.mark.parametrize("tbl", [128, 32, 129, 256, 300])
def test_pair_cut_source_on_runs_of_tbl_and_tbl_plus_one_pairs(lib, tbl):
    """Exactly tbl pairs of one slot make one batch, tbl + 1 two; at
    tbl = 128 a batch ends where its load round ends (the next batch's
    first slot from the round's last end), above it a batch takes more
    rounds. The slot limit passed at a round's last pair and at the next
    round's first (from tbl = 129 on, the next batch's first slot from
    that round's first start)."""
    tb = 1 << 20
    runs = [[1] * tbl, [1] * (tbl + 1), [1] * (3 * tbl + 5)]
    got = _check(lib, runs, tb=tb, tbl=tbl)
    assert got[:3] == [(0, 0, tbl), (1, tbl, 2 * tbl), (1, 2 * tbl, 2 * tbl + 1)]
    for k in (127, 128):  # pair k passes the limit
        big = [[3] * k + [tb - 3 * k + 1] + [1] * 40]
        assert _check(lib, big, tb=tb, tbl=tbl)[0][1:] == (0, min(k, tbl))


@pytest.mark.parametrize("tb,tbl", [(128, 16), (512, 128), (1024, 300)])
def test_pair_cut_source_on_empty_runs_and_one_run_holding_all(lib, tb, tbl):
    """Random pair sizes: runs with no pair between busy ones, and the
    same pairs all in one run."""
    rng = np.random.default_rng(tb)
    lens = [0, 7, 0, 0, 400, 3, 0, 1, 0, 0, 0, 45, 0, 81, 2, 0]
    runs = [list(rng.integers(1, tb // 3, k)) for k in lens]
    got = _check(lib, runs, tb=tb, tbl=tbl)
    assert {r for r, _, _ in got} == {t for t, k in enumerate(lens) if k}
    one = _check(lib, [[s for r in runs for s in r]], tb=tb, tbl=tbl)
    assert one[-1][2] == sum(lens) and all(r == 0 for r, _, _ in one)
    # No pair at all (the plan makes its one empty batch without the cut).
    csum, pbounds = _pairs([[] for _ in range(9)])
    counts, _, got = _cut(lib, csum, pbounds, tb=tb, tbl=tbl)
    assert counts.tolist() == [0] * 9 and all(a.numel() == 0 for a in got)
    assert torch.equal(counts, F.pair_cut_counts_plain(csum, pbounds, tb=tb, tbl=tbl))


def test_pair_cut_source_marks_a_pair_over_tb(lib):
    """A pair of tb + 1 slots fits no batch: the count pass writes -1 for
    its run (and only its run), as the plain version does, voxtpu's cut
    raises, and so does the plan's cut."""
    tb, tbl = 128, 128
    csum, pbounds = _pairs([[5, 6], [3, tb + 1, 2], [tb]])
    counts = _counts(lib, csum, pbounds, tb=tb, tbl=tbl)
    assert counts.tolist() == [1, -1, 1]
    assert torch.equal(counts, F.pair_cut_counts_plain(csum, pbounds, tb=tb, tbl=tbl))
    with pytest.raises(AssertionError, match="pair exceeds batch capacity"):
        _numpy_cut(csum, pbounds, tb=tb, tbl=tbl)
    # The plan's keys for the same pairs: (run * num_faces + face) * tc + cell.
    tc, num_faces = 256, 6
    sizes, run = np.diff(csum.numpy()), [0, 0, 1, 1, 1, 2]
    key = np.concatenate([(r * num_faces + p) * tc + np.arange(s)
                          for p, (r, s) in enumerate(zip(run, sizes))])
    with pytest.raises(AssertionError, match="pair exceeds batch capacity"):
        F.cut_pairs(torch.from_numpy(key), num_runs=3, num_faces=num_faces, tc=tc,
                    tb_sub=tb // 128, tbl=tbl, sp=NULL_SPAN)


@pytest.mark.parametrize("tb_sub,tbl", [(4, 128), (2, 64), (1, 8)])
def test_pair_cut_source_is_bitwise_plain_on_the_torus_plan(lib, monkeypatch, tb_sub, tbl):
    """The pairs the plan hands its cut, caught on the CPU, and the
    plan's batches."""
    c, f = procedural.torus(1.0, 0.35, 48, 24)
    c = (c + np.random.default_rng(0).normal(0, 1e-3, c.shape)).astype(np.float32)
    sp = make_soft_plan(Mesh(name="t", coords=c, faces=f, faces_normals=f),
                        GridSpec.fit(c, 128), pad_window=2)
    seen = {}
    counts_fn = F.pair_cut_counts

    def catch(csum, pbounds, **kw):
        seen.update(csum=csum.clone(), pbounds=pbounds.clone(), **kw)
        return counts_fn(csum, pbounds, **kw)

    monkeypatch.setattr(F, "pair_cut_counts", catch)
    plan = F.FusedSoftPlan(sp, "cpu", tb_sub=tb_sub, tbl=tbl)
    csum, pb = seen["csum"].numpy(), seen["pbounds"].numpy()
    runs = [list(np.diff(csum[a:b + 1])) for a, b in zip(pb[:-1], pb[1:])]
    got = _check(lib, runs, tb=seen["tb"], tbl=seen["tbl"])
    assert [r for r, _, _ in got] == plan.batch_tile.tolist()
    assert len(got) == plan.num_batches > len(set(plan.batch_tile.tolist()))


def test_pair_cut_entries_refuse_bad_arguments(lib):
    """tb < 1 or tbl < 1 is refused before anything runs."""
    csum, pbounds = _pairs([[3, 4]])
    counts = torch.full((1,), UNWRITTEN, dtype=torch.int32)
    for tb, tbl in ((0, 128), (128, 0)):
        err = lib.vt_pair_cut_counts(csum.data_ptr(), pbounds.data_ptr(), counts.data_ptr(),
                                     1, tb, tbl, None)
        assert err != 0 and counts.tolist() == [UNWRITTEN]
