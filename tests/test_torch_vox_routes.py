"""voxtpu's two cross-check voxelize routes in voxtpu_torch, both on
kernel B2: `SlotVoxPipeline` (every candidate a slot, whole-axis fill)
and the suffix-kernel route that an explicit `PallasVoxPlan` forces
(`voxelize(backend="word_event", plan=...)`), against voxtpu's, the
port's banded pipeline and the NumPy oracle, on the CPU.

voxtpu's Pallas kernels run in interpret mode on the CPU; the port's
B2 wrapper takes its plain version for CPU tensors. Tolerance: exact
everywhere (equal plan arrays, packed grids xor popcount 0).

Geometry: `SlotVoxPipeline` on `tests/test_torch_vox.py`'s procedural
meshes (its emit is the banded pipeline's, equal to voxtpu's there);
`PallasVoxPlan` on `tests/test_torch_word_event.py`'s dyadic meshes,
where voxtpu's XLA:CPU multiply-add contraction in `emit_fragments`
cannot move a fragment.
"""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.ops import vox_pallas as JP
from voxtpu.ops.vox_slots import SlotVoxPipeline as JSlots
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import vox_cuda
from voxtpu_torch.ops.reference import voxelize_ref
from voxtpu_torch.ops.vox import FragmentPlan, voxelize
from voxtpu_torch.ops.vox_cuda import PallasVoxPlan
from voxtpu_torch.ops.vox_slots import SlotVoxPipeline
from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

from tests.test_torch_word_event import VS, _dyadic

SLOT_CASES = [
    ("icosphere", lambda: procedural.icosphere(2, center=(0.1, -0.2, 0.3)), 32),
    ("torus", lambda: procedural.torus(1.0, 0.35, 48, 24), 64),
    ("icosahedron", procedural.icosahedron, 64),  # x-degenerate faces
]


def _xor(a, b) -> int:
    return int(np.unpackbits((np.asarray(a, np.uint32) ^ np.asarray(b, np.uint32))
                             .view(np.uint8)).sum())


def _words(t):
    return interop.words_to_numpy(t)


def _oracle_and_banded(mesh, spec):
    banded, overflow = BandedSlotVoxPipeline(mesh, spec, "cpu").words()
    assert int(overflow) == 0
    return _words(pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))), _words(banded)


@pytest.mark.parametrize("name,make,n", SLOT_CASES, ids=[c[0] for c in SLOT_CASES])
def test_slot_pipeline_matches_voxtpu_banded_and_oracle(name, make, n):
    coords, faces = make()
    mesh = Mesh(name=name, coords=coords, faces=faces, faces_normals=faces)
    spec = GridSpec.fit(coords, n)
    pipe = SlotVoxPipeline(mesh, spec, "cpu")
    ref = JSlots(JMesh(name=name, coords=coords, faces=faces, faces_normals=faces),
                 JSpec.fit(coords, n))
    assert len(pipe.rows) == len(ref.rows) == 9
    for i, (got, want) in enumerate(zip(pipe.rows, ref.rows)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"rows[{i}]")
    for key in ("local", "batch_tile", "flags", "batch_xseg", "tile_mask"):
        np.testing.assert_array_equal(getattr(pipe, key).numpy(),
                                      np.asarray(getattr(ref, key)), err_msg=key)
    for key in ("num_candidates", "num_batches", "num_slots", "num_tiles", "seg"):
        assert getattr(pipe, key) == getattr(ref, key), key
    before = vox_cuda.wide_fill.launches
    grid = pipe()
    assert vox_cuda.wide_fill.launches == before  # CPU tensors: B2's plain version
    oracle, banded = _oracle_and_banded(mesh, spec)
    got = _words(grid.words)
    assert grid.count() > 0
    assert _xor(got, np.asarray(ref.words())) == 0
    assert _xor(got, banded) == 0 and _xor(got, oracle) == 0


def test_slot_pipeline_refusals():
    coords, faces = procedural.icosahedron()
    mesh = Mesh(coords=coords, faces=faces)
    with pytest.raises(ValueError, match="whole-axis"):
        SlotVoxPipeline(mesh, GridSpec.fit(coords, 64), "cpu", seg=32)
    SlotVoxPipeline(mesh, GridSpec.fit(coords, 64), "cpu", seg=64)
    with pytest.raises(ValueError, match="N % 32"):
        SlotVoxPipeline(mesh, GridSpec.fit(coords, 48), "cpu")
    with pytest.raises(ValueError, match="must divide"):
        SlotVoxPipeline(mesh, GridSpec.fit(coords, 32), "cpu", tc=96)


def test_slot_pipeline_on_an_empty_mesh():
    mesh = Mesh(coords=np.zeros((0, 3), np.float32), faces=np.zeros((0, 3), np.int32))
    spec = GridSpec(n=32, origin=(0.0,) * 3, voxel_size=VS)
    pipe = SlotVoxPipeline(mesh, spec, "cpu")
    assert pipe.num_batches == 1 and pipe.num_candidates == 0
    assert int(pipe.flags[0]) == 3 and not pipe.tile_mask.any()
    assert pipe().count() == 0


@pytest.mark.parametrize("name,n,seg,tc,tb_sub", [
    ("icosphere", 32, None, 128, 4),
    ("icosphere", 32, 16, 128, 4),
    ("torus", 64, 64, 64, 1),
    ("torus", 64, 32, 64, 1),
])
def test_pallas_plan_matches_voxtpu_banded_and_oracle(name, n, seg, tc, tb_sub):
    mesh, spec, jmesh, jspec = _dyadic(name, n)
    plan = PallasVoxPlan(mesh, spec, "cpu", tc=tc, tb_sub=tb_sub, seg=seg)
    jplan = JP.PallasVoxPlan(jmesh, jspec, tc=tc, tb_sub=tb_sub, seg=seg)
    for key in ("local_cells", "xs", "batch_tile", "flags", "batch_xseg", "tile_mask"):
        np.testing.assert_array_equal(getattr(plan, key).numpy(),
                                      np.asarray(getattr(jplan, key)), err_msg=key)
    for key in ("num_fragments", "num_batches", "num_tiles", "seg", "tc", "tb_sub"):
        assert getattr(plan, key) == getattr(jplan, key), key
    if seg is not None and seg < n:
        assert (plan.batch_xseg.numpy() > 0).any()
    grid = voxelize(mesh, spec, "word_event", device="cpu", plan=plan)
    got = _words(grid.words)
    assert grid.count() > 0
    assert _xor(got, np.asarray(JP.voxelize_pallas(jmesh, jspec, plan=jplan).words)) == 0
    oracle, banded = _oracle_and_banded(mesh, spec)
    assert _xor(got, banded) == 0 and _xor(got, oracle) == 0
    # The port's suffix route on voxtpu's own batches gives the same grid.
    carried = interop.pallas_plan_from_voxtpu(jplan, device="cpu")
    assert _xor(_words(voxelize(mesh, spec, "word_event", device="cpu",
                                plan=carried).words), got) == 0
    # The same plan from a FragmentPlan's fragments, handed over.
    frags = PallasVoxPlan(mesh, spec, "cpu", frag_plan=FragmentPlan(mesh, spec, "cpu"),
                          tc=tc, tb_sub=tb_sub, seg=seg)
    assert torch.equal(frags.local_cells, plan.local_cells)
    assert torch.equal(frags.xs, plan.xs)


def test_pallas_plan_refusals_and_dispatch():
    mesh, spec, _, _ = _dyadic("icosphere", 32)
    with pytest.raises(ValueError, match="must divide N"):
        PallasVoxPlan(mesh, spec, "cpu", seg=12)
    with pytest.raises(ValueError, match="must be positive"):
        PallasVoxPlan(mesh, spec, "cpu", tc=96)
    plan = PallasVoxPlan(mesh, spec, "cpu", seg=64)  # clipped to N, as in voxtpu
    assert plan.seg == 32
    with pytest.raises(ValueError, match="plan was built for"):
        voxelize(mesh, GridSpec(n=64, origin=(0.0,) * 3, voxel_size=VS), "word_event",
                 device="cpu", plan=PallasVoxPlan(mesh, spec, "cpu"))
    with pytest.raises(TypeError, match="PallasVoxPlan"):
        voxelize(mesh, spec, "plain", device="cpu", plan=plan)
