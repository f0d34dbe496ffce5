"""voxtpu_torch's own voxelize routes vs voxtpu's: the plain route
(`FragmentPlan`, `emit_fragments`, `resolve_fragments`; voxtpu's "xla")
and the word-event route (`WordEventVoxPlan`, B12, `DeviceVoxPipeline`;
voxtpu's "pallas"), and the NumPy oracle.

voxtpu's Pallas kernels run in interpret mode on the CPU; the port's
B12 wrapper takes its plain version for CPU tensors. Tolerance: exact
everywhere (equal arrays, packed grids xor popcount 0).

Geometry: the comparisons with voxtpu use dyadic meshes (vertices on a
1/16 lattice, voxel size 1/32, origin 0), where every product and sum
of the emit is exact, so voxtpu's XLA:CPU multiply-add contraction
cannot move a fragment; the oracle is a witness on any geometry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.ops.reference import voxelize_ref as j_voxelize_ref
from voxtpu.ops.vox import FragmentPlan as JFragmentPlan
from voxtpu.ops.vox import emit_fragments as j_emit
from voxtpu.ops.vox import voxelize as j_voxelize
from voxtpu.ops import vox_pallas_we as JW
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import vox_word_event as W
from voxtpu_torch.ops.reference import voxelize_ref
from voxtpu_torch.ops.vox import (FragmentPlan, emit_fragments, fragments_from_plan,
                                  resolve_fragments, voxelize)
from voxtpu_torch.ops.vox_cuda import FLAG_FIRST, FLAG_LAST
from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

VS = 1.0 / 32
PLAN_ARRAYS = ("cells", "ws", "his", "masks", "cnts", "batch_tile", "flags",
               "tile_mask")


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
    origin = (0.0, 0.0, 0.0)
    return (Mesh(name=name, coords=c, faces=faces, faces_normals=faces),
            GridSpec(n=n, origin=origin, voxel_size=VS),
            JMesh(name=name, coords=c, faces=faces, faces_normals=faces),
            JSpec(n, origin, VS))


def _xor_popcount(a, b):
    return int(np.unpackbits((np.asarray(a, np.uint32) ^ b).view(np.uint8)).sum())


def _np_words(t):
    return interop.words_to_numpy(t)


@pytest.mark.parametrize("name", ["icosphere", "torus"])
@pytest.mark.parametrize("n", [32, 64, 96])
def test_fragment_plan_and_emit_match_voxtpu(name, n):
    mesh, spec, jmesh, jspec = _dyadic(name, n)
    plan = FragmentPlan(mesh, spec, "cpu")
    jplan = JFragmentPlan(jmesh, jspec)
    assert plan.num_fragments == jplan.num_fragments
    assert len(plan.buckets) == len(jplan.buckets) > 1
    origin, vs = spec.origin_tensor("cpu"), spec.voxel_size_tensor("cpu")
    live = 0
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert b[0] == jb[0]
        for got, want in zip(b[1:], jb[1:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        cells, xs = emit_fragments(*b[1:], window=b[0], n=n, origin=origin, vs=vs)
        jc, jx = j_emit(*jb[1:], window=jb[0], n=n, origin=jspec.origin,
                        voxel_size=jspec.voxel_size)
        np.testing.assert_array_equal(cells.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jx))
        live += int((cells < n * n).sum())
    assert live > 0


@pytest.mark.parametrize("name,n", [("icosphere", 32), ("torus", 64), ("icosphere", 96)])
def test_plain_voxelize_matches_voxtpu_xla_and_oracle(name, n):
    mesh, spec, jmesh, jspec = _dyadic(name, n)
    got = _np_words(voxelize(mesh, spec, "plain", device="cpu").words)
    want = np.asarray(j_voxelize(jmesh, jspec, backend="xla").words)
    assert _xor_popcount(got, want) == 0
    oracle = np.asarray(pack_bits(torch.from_numpy(voxelize_ref(mesh, spec))))
    assert _xor_popcount(got, oracle.view(np.uint32)) == 0
    assert got.any()


def test_resolve_follows_oracle_on_any_geometry():
    """Non-dyadic geometry: the plain route, the word-event route and
    the banded route equal the oracle (voxtpu's own oracle agrees)."""
    c, f = procedural.icosphere(3, center=(0.1, -0.2, 0.3))
    mesh = Mesh(name="ico", coords=c, faces=f, faces_normals=f)
    spec = GridSpec.fit(c, 96)
    oracle = voxelize_ref(mesh, spec)
    np.testing.assert_array_equal(oracle, j_voxelize_ref(
        JMesh(name="ico", coords=c, faces=f, faces_normals=f), JSpec.fit(c, 96)))
    want = pack_bits(torch.from_numpy(oracle))
    plan = FragmentPlan(mesh, spec, "cpu")
    assert torch.equal(resolve_fragments(*fragments_from_plan(plan), n=96), want)
    for backend in ("plain", "word_event", "cuda"):
        assert torch.equal(voxelize(mesh, spec, backend, device="cpu").words, want)


@pytest.mark.parametrize("name,n,tc,tb_sub", [
    ("icosphere", 32, 128, 4),
    ("torus", 96, 128, 4),      # G = 36: 72 tiles, lanes allow 42
    ("icosphere", 128, 128, 4),
    ("torus", 128, 64, 1),
])
def test_word_event_plan_matches_voxtpu(name, n, tc, tb_sub):
    mesh, spec, jmesh, jspec = _dyadic(name, n)
    plan = W.WordEventVoxPlan(mesh, spec, "cpu", tc=tc, tb_sub=tb_sub)
    jplan = JW.WordEventVoxPlan(jmesh, jspec, tc=tc, tb_sub=tb_sub)
    for key in PLAN_ARRAYS:
        want = np.asarray(getattr(jplan, key))
        want = want.view(np.int32) if key == "masks" else want
        np.testing.assert_array_equal(getattr(plan, key).numpy(), want, err_msg=key)
    for key in ("num_events", "num_batches", "num_fragments", "group", "num_super"):
        assert getattr(plan, key) == getattr(jplan, key), key
    assert plan.num_batches > 1 and plan.num_events > 0
    got = voxelize(mesh, spec, "word_event", device="cpu", plan=plan).words
    assert _xor_popcount(_np_words(got), np.asarray(
        j_voxelize(jmesh, jspec, backend="xla").words)) == 0


@pytest.mark.parametrize("name,n", [("icosphere", 32), ("torus", 64)])
def test_word_event_fill_plain_matches_we_words(name, n):
    """B12's plain version on voxtpu's own event panels (carried across
    with interop) against voxtpu's `_we_words` in interpret mode."""
    _, spec, jmesh, jspec = _dyadic(name, n)
    jplan = JW.WordEventVoxPlan(jmesh, jspec)
    want = np.asarray(JW._we_words(
        jplan.cells, jplan.ws, jplan.his, jplan.masks, jplan.cnts, jplan.batch_tile,
        jplan.flags, jplan.tile_mask, n=n, num_tiles=jplan.num_tiles, tc=jplan.tc,
        tb_sub=jplan.tb_sub))
    plan = interop.word_event_plan_from_voxtpu(jplan, device="cpu")
    assert plan.spec == spec
    got = W.word_event_fill_plain(plan.cells, plan.ws, plan.his, plan.masks,
                                  plan.cnts, plan.batch_tile, n=n, tc=plan.tc)
    assert _xor_popcount(_np_words(got), want) == 0 and want.any()
    assert W.word_event_fill.launches == 0


@pytest.fixture(scope="module", params=[("icosphere", 32), ("torus", 64)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pipelines(request):
    name, n = request.param
    mesh, spec, jmesh, jspec = _dyadic(name, n)
    return dict(n=n, mesh=mesh, spec=spec, jmesh=jmesh, jspec=jspec,
                pipe=W.DeviceVoxPipeline(mesh, spec, "cpu"),
                jpipe=JW.DeviceVoxPipeline(jmesh, jspec))


def test_device_pipeline_matches_voxtpu(pipelines):
    pipe, jpipe = pipelines["pipe"], pipelines["jpipe"]
    for key in ("b_max", "cap_f", "num_valid", "num_events", "num_fragments",
                "num_batches"):
        assert getattr(pipe, key) == getattr(jpipe, key), key
    words, overflow = pipe.words()
    jwords, joverflow = jpipe.words()
    assert int(overflow) == int(joverflow) == 0
    assert _xor_popcount(_np_words(words), np.asarray(jwords)) == 0
    assert torch.equal(pipe().words, words) and bool(words.ne(0).any())


def test_sorted_keys_and_overflow_match_voxtpu(pipelines):
    """The compacted, sorted keys of the per-call path equal voxtpu's
    where the capacity holds every fragment, and the overflow equals
    voxtpu's where it does not (rows of 16 slots)."""
    n, pipe = pipelines["n"], pipelines["pipe"]
    cells, xs = fragments_from_plan(pipe.frag_plan)
    jcells, jxs = (jnp.asarray(a.numpy()) for a in (cells, xs))
    for cap in (pipe.cap_f, 256 * ((pipe.num_valid // 2) // 256 + 1)):
        ckey, mask, ovf = W._sorted_keys_from_fragments(cells, xs, n=n, cap_f=cap)
        jckey, jmask, jovf = JW._sorted_keys_from_fragments(jcells, jxs, n=n, cap_f=cap)
        assert ckey.shape[0] == np.asarray(jckey).shape[0] == cap
        assert int(ovf) == int(jovf)
        if not int(ovf):
            valid = pipe.num_valid
            np.testing.assert_array_equal(ckey[:valid].numpy(), np.asarray(jckey)[:valid])
            np.testing.assert_array_equal(mask.numpy(),
                                          np.asarray(jmask).view(np.int32))
    assert int(ovf) > 0  # the second capacity is too small


def test_device_pipeline_undercapacity_matches_voxtpu(pipelines):
    pipe, jpipe = pipelines["pipe"], pipelines["jpipe"]
    b_max, cap_f = pipe.b_max, pipe.cap_f
    try:
        for p in (pipe, jpipe):
            p.b_max = max(1, b_max // 2)
        assert int(pipe.words()[1]) == int(jpipe.words()[1]) > 0
        with pytest.raises(RuntimeError, match="capacity"):
            pipe()
        for p in (pipe, jpipe):
            p.b_max, p.cap_f = b_max, 256
        assert int(pipe.words()[1]) == int(jpipe.words()[1]) > 0
    finally:
        for p in (pipe, jpipe):
            p.b_max, p.cap_f = b_max, cap_f


def test_empty_mesh():
    spec = GridSpec(n=32, origin=(0.0, 0.0, 0.0), voxel_size=1 / 32)
    pipe = W.DeviceVoxPipeline(Mesh(name="empty"), spec, "cpu")
    jpipe = JW.DeviceVoxPipeline(JMesh(name="empty"), JSpec(32, (0.0,) * 3, 1 / 32))
    assert (pipe.b_max, pipe.cap_f, pipe.num_valid) == (jpipe.b_max, jpipe.cap_f,
                                                          jpipe.num_valid)
    assert not pipe().words.any()
    assert not voxelize(Mesh(name="empty"), spec, "word_event", device="cpu").words.any()
    assert not voxelize(Mesh(name="empty"), spec, "plain", device="cpu").words.any()


def test_device_batches_overflow_guard():
    """voxtpu's own case (`tests/test_vox_pallas.py`): 2 supertiles of
    600 and 100 events, tb = 512, so 3 true batches."""
    bounds = torch.tensor([0, 600, 700])
    *_, overflow = W._device_batches(bounds, num_super=2, tb=512, b_max=2)
    assert int(overflow) == 1
    bt, flags, starts, ends, overflow = W._device_batches(bounds, num_super=2, tb=512,
                                                          b_max=4)
    assert int(overflow) == 0
    assert bt.tolist() == [0, 0, 1, 1]  # the spare revisits the last supertile
    assert flags.tolist() == [FLAG_FIRST, FLAG_LAST, FLAG_FIRST | FLAG_LAST, 0]
    assert starts.tolist() == [0, 512, 600, 0]
    assert ends.tolist() == [512, 600, 700, 0]


def test_refusals():
    for n, tc, match in ((4128, 128, "N = 4096"), (48, 128, "N % 32"),
                         (32, 100, "must divide")):
        spec = GridSpec(n=n, origin=(0.0,) * 3, voxel_size=1.0)
        with pytest.raises(ValueError, match=match):
            W.WordEventVoxPlan(Mesh(name="empty"), spec, "cpu", tc=tc)
        with pytest.raises(ValueError, match=match):
            W.DeviceVoxPipeline(Mesh(name="empty"), spec, "cpu", tc=tc)
        panel = torch.full((1, 4, 128), -1, dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            W.word_event_fill(*[panel] * 5, torch.zeros(1, dtype=torch.int32), n=n, tc=tc)
    panel = torch.zeros((1, 4, 128), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        W.word_event_fill(panel.float(), *[panel] * 4, torch.zeros(1, dtype=torch.int32),
                          n=32, tc=128)


def test_voxelize_checks_its_plan():
    mesh, spec, _, _ = _dyadic("icosphere", 32)
    fplan = FragmentPlan(mesh, spec, "cpu")
    want = voxelize(mesh, spec, "reference", device="cpu").words
    assert torch.equal(voxelize(mesh, spec, "word_event", device="cpu", plan=fplan).words,
                       want)
    with pytest.raises(TypeError, match="FragmentPlan"):
        voxelize(mesh, spec, "plain", device="cpu",
                 plan=W.WordEventVoxPlan(mesh, spec, "cpu", frag_plan=fplan))
    with pytest.raises(TypeError, match="BandedSlotVoxPipeline"):
        voxelize(mesh, spec, "cuda", device="cpu", plan=fplan)
    other = GridSpec(n=64, origin=spec.origin, voxel_size=VS)
    with pytest.raises(ValueError, match="plan was built for"):
        voxelize(mesh, other, "plain", device="cpu", plan=fplan)
    with pytest.raises(ValueError, match="plan lives on"):
        voxelize(mesh, spec, "cuda", device="meta",
                 plan=BandedSlotVoxPipeline(mesh, spec, "cpu"))
    with pytest.raises(ValueError, match="unknown backend"):
        voxelize(mesh, spec, "xla", device="cpu")
