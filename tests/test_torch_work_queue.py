"""voxtpu_torch's work-queue voxelizer (`WorkQueueVoxPlan`, B14,
`voxelize_wq`) vs voxtpu's (`voxtpu/ops/vox_pallas_wq.py`) and the NumPy
oracle.

voxtpu's Pallas kernel runs in interpret mode on the CPU; the port's
B14 wrapper takes its plain version for CPU tensors. Tolerance: exact
(equal plan arrays, packed grids xor popcount 0). The comparisons with
voxtpu use dyadic meshes (vertices on a 1/16 lattice, voxel size 1/32,
origin 0), where voxtpu's XLA:CPU multiply-add contraction cannot move
a fragment.
"""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.ops import vox_pallas_wq as JQ
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import vox_work_queue as Q
from voxtpu_torch.ops.reference import voxelize_ref
from voxtpu_torch.ops.vox import FragmentPlan, fragments_from_plan, resolve_fragments

VS = 1.0 / 32
PLAN_ARRAYS = ("cells2d", "xs2d", "row_start", "num_chunks", "tile_id", "tile_mask")


def _dyadic(name, n):
    """A procedural mesh scaled into [0.05, 0.95] of a box of n voxels
    of 1/32, vertices rounded to multiples of 1/16; the port's and
    voxtpu's meshes and grid specs."""
    coords, faces = {"icosphere": lambda: procedural.icosphere(2),
                     "torus": lambda: procedural.torus(1.0, 0.35, 24, 12)}[name]()
    lo, hi = coords.min(0), coords.max(0)
    box = n * VS
    c = 0.05 * box + (coords - lo) / (hi - lo).max() * 0.9 * box
    c = (np.round(c * 16) / 16).astype(np.float32)
    return (Mesh(name=name, coords=c, faces=faces, faces_normals=faces),
            GridSpec(n=n, origin=(0.0, 0.0, 0.0), voxel_size=VS),
            JMesh(name=name, coords=c, faces=faces, faces_normals=faces),
            JSpec(n, (0.0, 0.0, 0.0), VS))


def _xor_popcount(a, b):
    return int(np.unpackbits((np.asarray(a, np.uint32) ^ b).view(np.uint8)).sum())


def _oracle(mesh, spec):
    return np.asarray(pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))).view(np.uint32)


@pytest.fixture(scope="module", params=["icosphere", "torus"])
def case64(request):
    """A dyadic mesh at 64^3 and voxtpu's plans for seg 64 and 32."""
    mesh, spec, jmesh, jspec = _dyadic(request.param, 64)
    return dict(mesh=mesh, spec=spec, jmesh=jmesh, jspec=jspec,
                jplans={seg: JQ.WorkQueueVoxPlan(jmesh, jspec, seg=seg) for seg in (64, 32)})


@pytest.mark.parametrize("seg", [64, 32])
def test_plan_arrays_match_voxtpu(case64, seg):
    plan = Q.WorkQueueVoxPlan(case64["mesh"], case64["spec"], "cpu", seg=seg)
    jplan = case64["jplans"][seg]
    for key in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(plan, key).numpy(),
                                      np.asarray(getattr(jplan, key)), err_msg=key)
    for key in ("num_fragments", "num_active", "num_tiles", "seg", "tc"):
        assert getattr(plan, key) == getattr(jplan, key), key
    assert plan.num_active > 1 and int(plan.num_chunks.sum()) >= plan.num_active


@pytest.mark.parametrize("seg", [64, 32])
def test_voxelize_wq_matches_voxtpu_and_oracle(case64, seg):
    mesh, spec = case64["mesh"], case64["spec"]
    want = np.asarray(JQ.voxelize_wq(case64["jmesh"], case64["jspec"],
                                     plan=case64["jplans"][seg]).words)
    plan = Q.WorkQueueVoxPlan(mesh, spec, "cpu", seg=seg)
    got = interop.words_to_numpy(Q.voxelize_wq(mesh, spec, "cpu", plan=plan).words)
    assert _xor_popcount(got, want) == 0 and got.any()
    assert _xor_popcount(got, _oracle(mesh, spec)) == 0
    assert Q.wq_fill.launches == 0


def test_wq_fill_plain_on_voxtpu_plan(case64):
    """B14's plain version on voxtpu's own plan (carried across with
    interop) against voxtpu's `_run_wq` in interpret mode."""
    jplan, spec = case64["jplans"][32], case64["spec"]
    want = np.asarray(JQ._run_wq(
        jplan.cells2d, jplan.xs2d, jplan.row_start, jplan.num_chunks, jplan.tile_id,
        jplan.tile_mask, n=64, num_tiles=jplan.num_tiles, tc=jplan.tc, seg=jplan.seg))
    plan = interop.wq_plan_from_voxtpu(jplan, device="cpu")
    assert plan.spec == spec and plan.num_fragments == jplan.num_fragments
    got = Q.wq_fill_plain(*plan.args(), n=64, tc=plan.tc)
    assert _xor_popcount(interop.words_to_numpy(got), want) == 0 and want.any()


@pytest.mark.parametrize("name,n,tc", [("icosphere", 96, 128), ("torus", 128, 64)])
def test_voxelize_wq_matches_resolve_and_oracle(name, n, tc):
    """Larger grids and another tile size, against the port's plain
    route on the same fragments and the oracle (non-dyadic: the port
    rounds term for term)."""
    c, f = {"icosphere": lambda: procedural.icosphere(3, center=(0.1, -0.2, 0.3)),
            "torus": lambda: procedural.torus(1.0, 0.35, 48, 24)}[name]()
    mesh = Mesh(name=name, coords=c, faces=f, faces_normals=f)
    spec = GridSpec.fit(c, n)
    frags = fragments_from_plan(FragmentPlan(mesh, spec, "cpu"))
    plan = Q.WorkQueueVoxPlan(mesh, spec, "cpu", fragments=frags, tc=tc)
    got = Q.voxelize_wq(mesh, spec, "cpu", plan=plan).words
    assert torch.equal(got, resolve_fragments(*frags, n=n))
    assert torch.equal(got, pack_bits(torch.from_numpy(voxelize_ref(mesh, spec))))


def test_wq_fill_plain_on_random_runs():
    """Random lanes (pads, x anywhere in [0, n)) in runs on scattered
    tiles, one masked out, against the port's resolve on the same
    fragments."""
    n, tc = 64, 128
    rng = np.random.default_rng(3)
    tiles = np.sort(rng.choice(n * n // tc, 6, replace=False)).astype(np.int32)
    chunks = rng.integers(1, 3, tiles.size).astype(np.int32)
    starts = (np.concatenate([[0], np.cumsum(chunks)])[:-1] * Q.CH_SUB).astype(np.int32)
    rows = int(chunks.sum()) * Q.CH_SUB
    cells = rng.integers(-1, tc, (rows, Q.LANE)).astype(np.int32)
    xs = rng.integers(0, n, (rows, Q.LANE)).astype(np.int32)
    mask = np.zeros(n * n // tc, bool)
    mask[tiles[1:]] = True  # the first run's tile is masked out
    args = [torch.from_numpy(a) for a in (cells, xs, starts, chunks, tiles, mask)]
    got = Q.wq_fill(*args, n=n, tc=tc)
    run = np.repeat(np.arange(tiles.size), chunks * Q.CH_SUB)
    gcell = tiles[run][:, None].astype(np.int64) * tc + cells
    keep = (cells >= 0) & (run[:, None] > 0)
    want = resolve_fragments(torch.from_numpy(np.where(keep, gcell, n * n)).view(-1),
                             torch.from_numpy(np.where(keep, xs, 0)).view(-1), n=n)
    assert torch.equal(got, want) and bool(want.ne(0).any())


def test_empty_mesh_and_refusals():
    spec = GridSpec(n=32, origin=(0.0,) * 3, voxel_size=1 / 32)
    plan = Q.WorkQueueVoxPlan(Mesh(name="empty"), spec, "cpu")
    jplan = JQ.WorkQueueVoxPlan(JMesh(name="empty"), JSpec(32, (0.0,) * 3, 1 / 32))
    for key in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(plan, key).numpy(),
                                      np.asarray(getattr(jplan, key)), err_msg=key)
    assert plan.num_active == jplan.num_active == 1 and plan.num_fragments == 0
    assert not Q.voxelize_wq(Mesh(name="empty"), spec, "cpu", plan=plan).words.any()
    with pytest.raises(ValueError, match="must divide N"):
        Q.WorkQueueVoxPlan(Mesh(name="empty"), GridSpec(n=96, origin=(0.0,) * 3,
                                                        voxel_size=1.0), "cpu", seg=64)
    with pytest.raises(ValueError, match="N % 32"):
        Q.WorkQueueVoxPlan(Mesh(name="empty"), GridSpec(n=48, origin=(0.0,) * 3,
                                                        voxel_size=1.0), "cpu")
    with pytest.raises(ValueError, match="plan was built for"):
        Q.voxelize_wq(Mesh(name="empty"), GridSpec(n=64, origin=(0.0,) * 3,
                                                   voxel_size=1 / 32), "cpu", plan=plan)
    lanes = torch.zeros((8, 128), dtype=torch.int32)
    run = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        Q.wq_fill(lanes.float(), lanes, run, run, run, torch.zeros(8, dtype=torch.bool),
                  n=32, tc=128)
    with pytest.raises(ValueError, match="shape"):
        Q.wq_fill(lanes, lanes, run, run, run, torch.zeros(9, dtype=torch.bool),
                  n=32, tc=128)
