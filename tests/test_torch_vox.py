"""voxtpu_torch banded voxelizer vs voxtpu's BandedSlotVoxPipeline and
the NumPy oracle.

Same procedural meshes on both sides. voxtpu's Pallas kernels run in
interpret mode on the CPU; the port's wrappers take their plain torch
versions for CPU tensors. Tolerance: exact everywhere (packed grids
xor popcount 0, emitted x and validity equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.ops.reference import voxelize_ref as j_voxelize_ref
from voxtpu.ops.vox_pallas import FLAG_FIRST, FLAG_LAST, _run_pallas
from voxtpu.ops.vox_slots import _slot_emit as j_slot_emit
from voxtpu.ops.vox_slots_banded import BandedSlotVoxPipeline as JPipe
from voxtpu.ops.vox_slots_banded import _run_banded
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.reference import voxelize_ref
from voxtpu_torch.ops.vox import voxelize
from voxtpu_torch.ops.vox_cuda import TB_LANE, tile_batches, wide_fill
from voxtpu_torch.ops.vox_slots import _slot_emit
from voxtpu_torch.ops.vox_slots_banded import (BAND, BandedSlotVoxPipeline,
                                               banded_fill)

MESHES = {
    "icosphere": lambda: procedural.icosphere(2, center=(0.1, -0.2, 0.3)),
    "torus": lambda: procedural.torus(1.0, 0.35, 48, 24),
    "icosahedron": lambda: procedural.icosahedron(),
}

# (mesh, n, band): band >= n degenerates to one whole-axis band; band < n
# exercises per-batch bases and the carry past the band; the
# icosahedron at 192 / 64 routes 14,208 candidates wide.
CASES = [
    ("icosphere", 32, BAND),
    ("icosphere", 64, BAND),
    ("torus", 32, BAND),
    ("torus", 64, BAND),
    ("torus", 64, 32),
    ("icosphere", 64, 32),
    ("icosahedron", 192, 64),
]


def _xor_popcount(a, b):
    return int(np.unpackbits((np.asarray(a, np.uint32) ^ b).view(np.uint8)).sum())


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}-b{c[2]}")
def case(request):
    name, n, band = request.param
    coords, faces = MESHES[name]()
    mesh = Mesh(name=name, coords=coords, faces=faces, faces_normals=faces)
    jmesh = JMesh(name=name, coords=coords, faces=faces, faces_normals=faces)
    spec = GridSpec.fit(coords, n)
    jspec = JSpec.fit(coords, n)
    port = BandedSlotVoxPipeline(mesh, spec, "cpu", band=band)
    ref = JPipe(jmesh, jspec, band=band)
    jwords, jover = ref.words()
    return dict(name=name, n=n, band=band, mesh=mesh, spec=spec, port=port,
                ref=ref, jspec=jspec, jwords=np.asarray(jwords),
                joverflow=int(jover))


def _jax_state(ref):
    return interop.banded_state(
        rows=[np.asarray(r) for r in ref.rows], local=np.asarray(ref.local),
        batch_tile=np.asarray(ref.batch_tile),
        batch_basew=np.asarray(ref.batch_basew),
        wide=None if ref.wide is None else [np.asarray(a) for a in ref.wide],
        device="cpu")


def test_plan_arrays_match_voxtpu(case):
    port, ref = case["port"], case["ref"]
    for attr in ("num_candidates", "num_wide", "num_batches", "num_slots",
                 "num_tiles", "band", "tc", "tb_sub", "pack"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    st = port.state
    for got, want in zip(st.rows, ref.rows):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(st.local), np.asarray(ref.local))
    np.testing.assert_array_equal(_np(st.batch_tile), np.asarray(ref.batch_tile))
    np.testing.assert_array_equal(_np(st.batch_basew), np.asarray(ref.batch_basew))
    assert (st.wide is None) == (ref.wide is None)
    if ref.wide is not None:
        w_rows, w_local, w_rtile, w_ctile, w_uidx = st.wide
        r_rows, r_local, r_rtile, r_ctile, _flags, _xseg, r_uidx = ref.wide
        for got, want in zip(w_rows, r_rows):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        for got, want in ((w_local, r_local), (w_rtile, r_rtile),
                          (w_ctile, r_ctile), (w_uidx, r_uidx)):
            np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_slot_emit_matches_voxtpu(case):
    st = _jax_state(case["ref"])
    spec, n, tc = case["spec"], case["n"], case["port"].tc
    origin = jnp.asarray(case["jspec"].origin, jnp.float32)
    vs = jnp.float32(case["jspec"].voxel_size)
    pairs = [(st.rows, st.local, st.batch_tile, case["ref"].rows,
              case["ref"].local, case["ref"].batch_tile)]
    if st.wide is not None:
        pairs.append((st.wide[0], st.wide[1], st.wide[2], case["ref"].wide[0],
                      case["ref"].wide[1], case["ref"].wide[2]))
    for rows, local, tiles, jrows, jlocal, jtiles in pairs:
        xs, lk = _slot_emit(rows, local, tiles, spec.origin_tensor("cpu"),
                            spec.voxel_size_tensor("cpu"), n=n, tc=tc)
        jxs, jlk = j_slot_emit(jrows, jlocal, jtiles, origin, vs, n=n, tc=tc)
        np.testing.assert_array_equal(_np(lk), np.asarray(jlk))
        np.testing.assert_array_equal(_np(xs), np.asarray(jxs))


def test_banded_fill_plain_matches_run_banded(case):
    """B1's plain version against voxtpu's `_run_banded` on voxtpu's own
    emitted slots, carried across with interop."""
    ref, n, band, tc = case["ref"], case["n"], case["band"], case["port"].tc
    band = min(band, n)
    origin = jnp.asarray(case["jspec"].origin, jnp.float32)
    vs = jnp.float32(case["jspec"].voxel_size)
    jxs, jlk = j_slot_emit(ref.rows, ref.local, ref.batch_tile, origin, vs,
                           n=n, tc=tc)
    base = ref.batch_basew[:, None, None] * 32
    jlk = jnp.where((jxs >= base) & (jxs < base + band), jlk, -1)
    want = np.asarray(_run_banded(jlk, jxs, ref.step_sf, ref.off, n=n,
                                  num_tiles=ref.num_tiles, tc=tc,
                                  tb_sub=ref.tb_sub, band=band, pack=ref.pack))
    st = _jax_state(ref)
    got = banded_fill(torch.from_numpy(np.array(jlk)),
                      torch.from_numpy(np.array(jxs)), st.batch_tile,
                      st.batch_basew, n=n, tc=tc, band=band)
    assert _xor_popcount(want, interop.words_to_numpy(got)) == 0
    assert banded_fill.launches == 0  # CPU tensors never launch the kernel


def test_pipeline_matches_voxtpu_and_oracle(case):
    port, spec = case["port"], case["spec"]
    words, overflow = port.words()
    assert int(overflow) == 0 == case["joverflow"]
    got = interop.words_to_numpy(words)
    assert _xor_popcount(got, case["jwords"]) == 0
    oracle = voxelize_ref(case["mesh"], spec)
    np.testing.assert_array_equal(oracle, j_voxelize_ref(
        JMesh(coords=case["mesh"].coords, faces=case["mesh"].faces),
        case["jspec"]))
    assert _xor_popcount(got, interop.words_to_numpy(
        pack_bits(torch.from_numpy(oracle)))) == 0
    if case["name"] == "icosahedron":
        assert port.num_wide == case["ref"].num_wide == 14208
        assert port.state.wide is not None
    # The port's per-call path on voxtpu's plan arrays gives the same grid.
    from voxtpu_torch.ops.vox_slots_banded import banded_total

    w2, o2 = banded_total(_jax_state(case["ref"]), spec.origin_tensor("cpu"),
                          spec.voxel_size_tensor("cpu"), n=spec.n, tc=port.tc,
                          band=port.band)
    assert int(o2) == 0 and torch.equal(w2, words)


def test_pipeline_follows_oracle_where_xla_cpu_rounds_differently():
    """icosphere(2) at 96: voxtpu on XLA:CPU contracts the emit's
    multiply-adds into FMAs and enters one fragment a voxel later than
    the term-for-term f32 oracle (74.999985 truncates to 74; voxtpu
    emits 75), so its grid differs from `voxelize_ref` in one voxel.
    The port rounds each operation on its own and follows the oracle."""
    coords, faces = MESHES["icosphere"]()
    mesh = Mesh(coords=coords, faces=faces)
    spec = GridSpec.fit(coords, 96)
    words, overflow = BandedSlotVoxPipeline(mesh, spec, "cpu", band=64).words()
    assert int(overflow) == 0
    oracle = pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))
    assert torch.equal(words, oracle)


def _random_wide_layout(n, tc, num_tiles, batches_per_tile, seed):
    """Whole-axis batches of live slots (the pipelines' wide slots are
    all x-degenerate and never valid, so this is what fills real words)."""
    rng = np.random.default_rng(seed)
    tiles = np.repeat(np.arange(num_tiles), batches_per_tile)
    b = len(tiles)
    local = rng.integers(-1, tc, (b, 4, TB_LANE)).astype(np.int32)
    xs = rng.integers(0, n, (b, 4, TB_LANE)).astype(np.int32)
    xs[local < 0] = 0
    xs[:, 0, :8] = 31        # bit 31 of word 0
    xs[:, 0, 8:16] = n - 1   # the last voxel
    first = np.r_[True, tiles[1:] != tiles[:-1]]
    last = np.r_[tiles[1:] != tiles[:-1], True]
    flags = (first * FLAG_FIRST + last * FLAG_LAST).astype(np.int32)
    return local, xs, tiles.astype(np.int32), flags


@pytest.mark.parametrize("n,tc,num_tiles,per_tile", [
    (64, 128, 3, 2),
    (192, 128, 4, 1),
    (96, 64, 5, 3),
])
def test_wide_fill_plain_matches_run_pallas(n, tc, num_tiles, per_tile):
    """B2's plain version against voxtpu's `_run_pallas` (seg=None) on
    identical live slots."""
    local, xs, tiles, flags = _random_wide_layout(n, tc, num_tiles, per_tile,
                                                  seed=n + tc)
    want = np.asarray(_run_pallas(
        jnp.asarray(local), jnp.asarray(xs), jnp.asarray(tiles),
        jnp.asarray(flags), jnp.zeros(len(tiles), jnp.int32), n=n,
        num_tiles=num_tiles, tc=tc, tb_sub=4, seg=None))
    got = wide_fill(torch.from_numpy(local), torch.from_numpy(xs),
                    torch.from_numpy(tiles), n=n, tc=tc, num_tiles=num_tiles)
    assert got.shape == (num_tiles, tc, n // 32)
    assert _xor_popcount(want, interop.words_to_numpy(got)) == 0
    assert (want != 0).any()
    assert wide_fill.launches == 0


@pytest.mark.parametrize("case", [("icosahedron", 192, 64)], indirect=True,
                         ids=["icosahedron-192-b64"])
def test_wide_fill_plain_matches_run_pallas_on_pipeline_layout(case):
    """B2 on the pipeline's own wide layout and emitted slots."""
    ref = case["ref"]
    assert ref.wide is not None
    n, tc = case["n"], case["port"].tc
    w_rows, w_local, w_rtile, w_ctile, w_flags, w_xseg, w_uidx = ref.wide
    origin = jnp.asarray(case["jspec"].origin, jnp.float32)
    jxs, jk = j_slot_emit(w_rows, w_local, w_rtile, origin,
                          jnp.float32(case["jspec"].voxel_size), n=n, tc=tc)
    want = np.asarray(_run_pallas(jk, jxs, w_ctile, w_flags, w_xseg, n=n,
                                  num_tiles=w_uidx.shape[0], tc=tc,
                                  tb_sub=ref.tb_sub, seg=None))
    got = wide_fill(torch.from_numpy(np.array(jk)),
                    torch.from_numpy(np.array(jxs)),
                    torch.from_numpy(np.array(w_ctile)), n=n, tc=tc,
                    num_tiles=w_uidx.shape[0])
    assert _xor_popcount(want, interop.words_to_numpy(got)) == 0


def test_tile_batches_matches_voxtpu():
    from voxtpu.ops.vox_pallas import tile_batches as j_tile_batches

    bounds = np.array([0, 0, 5, 1030, 1030, 2000, 2048], np.int64)
    got = tile_batches(bounds, 512)
    want = j_tile_batches(bounds, 512)
    for g, w in zip(got, (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g, w)
    empty = np.zeros(4, np.int64)
    for g, w in zip(tile_batches(empty, 512), (lambda r: (r[0], r[1], r[3]))(
            j_tile_batches(empty, 512))):
        np.testing.assert_array_equal(g, w)


def test_voxelize_dispatch_reference_equals_cuda_backend():
    coords, faces = procedural.torus(1.0, 0.3, 32, 16, center=(0.0, 0.1, -0.2))
    mesh = Mesh(coords=coords, faces=faces)
    spec = GridSpec.fit(coords, 64)
    a = voxelize(mesh, spec, "reference", device="cpu")
    b = voxelize(mesh, spec, "cuda", device="cpu")
    assert torch.equal(a.words, b.words) and a.count() > 0
    with pytest.raises(ValueError, match="unknown backend"):
        voxelize(mesh, spec, "xla", device="cpu")
    other = BandedSlotVoxPipeline(mesh, GridSpec.fit(coords, 32), "cpu")
    with pytest.raises(ValueError, match="plan was built for"):
        voxelize(mesh, spec, "cuda", device="cpu", plan=other)


def test_overflow_raises_on_drifted_coords():
    coords, faces = procedural.icosphere(2)
    mesh = Mesh(coords=coords, faces=faces)
    spec = GridSpec.fit(coords, 64)
    pipe = BandedSlotVoxPipeline(mesh, spec, "cpu", band=32)
    rows = list(pipe.state.rows)
    for i in (0, 3, 6):  # every slot's x coordinates, 40 voxels to +x
        rows[i] = rows[i] + 40 * spec.voxel_size
    pipe.state.rows = tuple(rows)
    _, overflow = pipe.words()
    assert int(overflow) > 0
    with pytest.raises(RuntimeError, match="left their baked x-bands"):
        pipe()


def test_empty_mesh_gives_empty_grid():
    mesh = Mesh(name="empty", coords=np.zeros((3, 3), np.float32),
                faces=np.zeros((0, 3), np.int32))
    spec = GridSpec(n=64, origin=(0.0, 0.0, 0.0), voxel_size=1.0)
    grid = BandedSlotVoxPipeline(mesh, spec, "cpu")()
    assert grid.words.shape == (64, 64, 2) and grid.count() == 0


def test_wrappers_reject_bad_inputs():
    local = torch.zeros((2, 4, TB_LANE), dtype=torch.int32)
    tiles = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wide_fill(local.to("meta"), local.to("meta"), tiles.to("meta"), n=64,
                  tc=128, num_tiles=1)
    with pytest.raises(TypeError, match="int32"):
        wide_fill(local.long(), local, tiles, n=64, tc=128, num_tiles=1)
    with pytest.raises(ValueError, match="shape"):
        banded_fill(local, local, tiles, torch.zeros(3, dtype=torch.int32),
                    n=64, tc=128, band=64)
    with pytest.raises(ValueError, match="band"):
        banded_fill(local, local, tiles, tiles, n=64, tc=128, band=48)
