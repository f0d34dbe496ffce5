"""voxtpu_torch host layer vs voxtpu: packed grids, GridSpec, OBJ I/O,
procedural meshes, CSG, exporters, profiling scopes.

Same numpy inputs on both sides; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.grids.voxel_grid import VoxelGrid as JGrid
from voxtpu.grids.voxel_grid import pack_bits as j_pack_bits
from voxtpu.mesh import grid_to_mesh as j_g2m
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.mesh.obj_io import export_mesh as j_export
from voxtpu.mesh.obj_io import import_mesh as j_import
from voxtpu.ops.csg import csg as j_csg
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid, pack_bits, unpack_bits
from voxtpu_torch.mesh import grid_to_mesh as t_g2m
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.mesh.obj_io import export_mesh, import_mesh
from voxtpu_torch.ops.csg import csg
from voxtpu_torch.ops.reference import csg_ref
from voxtpu_torch.utils.profiling import ProfilingScope


def _occ(n, seed, p=0.3):
    """Random occupancy with every bit-31 voxel (x % 32 == 31) of some
    rows set, so that the sign bit of the int32 words is exercised."""
    rng = np.random.default_rng(seed)
    occ = rng.random((n, n, n)) < p
    occ[::3, ::2, 31::32] = True
    return occ


@pytest.mark.parametrize("n", [32, 64])
def test_pack_unpack_match_voxtpu_with_bit31(n):
    occ = _occ(n, seed=n)
    ref = np.asarray(j_pack_bits(jnp.asarray(occ)))          # uint32
    assert (ref & np.uint32(1 << 31)).any()
    got = pack_bits(torch.from_numpy(occ))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(interop.words_to_numpy(got), ref)
    np.testing.assert_array_equal(unpack_bits(got).numpy(), occ)
    np.testing.assert_array_equal(
        unpack_bits(interop.words_to_torch(ref, device="cpu")).numpy(), occ)


def test_grid_container_matches_voxtpu():
    n = 64
    occ = _occ(n, seed=1, p=0.5)
    spec = GridSpec(n=n, origin=(0.25, -1.0, 3.0), voxel_size=0.125)
    grid = VoxelGrid.from_dense(torch.from_numpy(occ), spec)
    jgrid = JGrid.from_dense(jnp.asarray(occ), JSpec(n, spec.origin, spec.voxel_size))
    assert grid.count() == jgrid.count() == int(occ.sum())
    assert grid.n == n and grid.spec() == spec
    np.testing.assert_array_equal(grid.to_dense().numpy(), occ)
    zero = VoxelGrid.zeros(spec, "cpu")
    assert zero.words.shape == (n, n, n // 32) and zero.count() == 0
    full = VoxelGrid.from_dense(torch.ones((n, n, n), dtype=torch.bool), spec)
    assert full.count() == n ** 3
    assert (full.words == -1).all()  # 0xFFFFFFFF


def test_gridspec_fit_matches_voxtpu():
    coords, _ = procedural.torus(center=(0.3, -2.0, 5.0))
    a = GridSpec.fit(coords, 96)
    b = JSpec.fit(coords, 96)
    assert (a.n, a.origin, a.voxel_size) == (b.n, b.origin, b.voxel_size)
    with pytest.raises(ValueError, match="N % 32"):
        GridSpec(n=48, origin=(0.0,) * 3, voxel_size=1.0).num_words


def test_obj_text_and_roundtrip_match_voxtpu(tmp_path):
    coords, faces = procedural.icosphere(1, center=(0.5, -0.25, 2.0))
    rng = np.random.default_rng(3)
    colors = np.concatenate([rng.integers(0, 256, (len(coords), 3)),
                             np.full((len(coords), 1), 255)], 1)
    normals = rng.normal(size=(7, 3)).astype(np.float32)
    fn = rng.integers(0, 7, faces.shape).astype(np.int32)
    kw = dict(coords=coords, faces=faces, colors=colors, normals=normals,
              faces_normals=fn)
    export_mesh(tmp_path / "port.obj", Mesh(name="m", **kw))
    j_export(tmp_path / "jax.obj", JMesh(name="m", **kw), use_native=False)
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()

    got = import_mesh(tmp_path / "port.obj")
    ref = j_import(tmp_path / "jax.obj", use_native=False)
    for field in ("coords", "normals", "colors", "faces", "faces_normals"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    np.testing.assert_array_equal(got.faces, faces)
    np.testing.assert_array_equal(got.faces_normals, fn)


def test_obj_import_face_forms(tmp_path):
    """v, v/vt, v//vn, v/vt/vn and a file mixing them."""
    head = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nvn 0 0 1\nvn 1 0 0\n"
    forms = {
        "plain": "f 1 2 3\nf 1 3 4\n",
        "vt": "f 1/1 2/1 3/1\nf 1/1 3/1 4/1\n",
        "vn": "f 1//2 2//2 3//2\nf 1//1 3//1 4//1\n",
        "vtvn": "f 1/1/2 2/1/2 3/1/2\nf 1/1/1 3/1/1 4/1/1\n",
        "mixed": "f 1//2 2/1/2 3//2\nf 1 3 4\n",
    }
    for name, body in forms.items():
        path = tmp_path / f"{name}.obj"
        path.write_text(head + body)
        got = import_mesh(path)
        ref = j_import(path, use_native=False)
        np.testing.assert_array_equal(got.faces, ref.faces)
        np.testing.assert_array_equal(got.faces_normals, ref.faces_normals)
        np.testing.assert_array_equal(got.faces, [[0, 1, 2], [0, 2, 3]])
    with pytest.raises(ValueError, match="wrong file extension"):
        import_mesh(tmp_path / "mesh.ply")


def _closed_and_oriented(faces):
    """Every directed edge appears once and its reverse once."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    fwd = set(map(tuple, e.tolist()))
    return len(fwd) == len(e) and all((b, a) in fwd for a, b in fwd)


def _signed_volume(coords, faces):
    a, b, c = (coords[faces[:, i]].astype(np.float64) for i in range(3))
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


@pytest.mark.parametrize("make,volume", [
    (lambda: procedural.icosahedron(), 2.536),
    (lambda: procedural.icosphere(3), 4.1),            # -> 4/3 pi = 4.19
    (lambda: procedural.torus(1.0, 0.35, 64, 32), 2.4),  # 2 pi^2 R r^2 = 2.42
    (lambda: procedural.washer(0.85, 1.0, 0.16, 64), 0.139),
])
def test_procedural_meshes_closed_and_outward(make, volume):
    coords, faces = make()
    assert coords.dtype == np.float32 and faces.dtype == np.int32
    assert _closed_and_oriented(faces)
    assert _signed_volume(coords, faces) == pytest.approx(volume, rel=0.02)


@pytest.mark.parametrize("base,target", [
    (20 * 16, 4 * 320 + 100),      # one subdivision + bisection
    (20 * 16, 4 * 320 * 2 + 7),    # trisection then bisection
    (20 * 16, 16 * 320),           # subdivisions only
])
def test_subdivide_to_exact_face_counts(base, target):
    coords, faces = procedural.icosphere(2)
    assert len(faces) == base
    c2, f2 = procedural.subdivide_to(coords, faces, target)
    assert len(f2) == target
    assert f2.max() < len(c2)
    assert _signed_volume(c2, f2) == pytest.approx(_signed_volume(coords, faces),
                                                   rel=1e-5)
    c3, f3 = procedural.subdivide(coords, faces, 1)
    assert len(f3) == 4 * len(faces) and _closed_and_oriented(
        _dedup_faces(c3, f3))
    with pytest.raises(ValueError):
        procedural.subdivide_to(coords, faces, base - 1)


def _dedup_faces(coords, faces):
    """Faces re-indexed onto unique vertex positions (subdivide emits
    each edge midpoint once per face)."""
    _, inv = np.unique(coords, axis=0, return_inverse=True)
    return inv.reshape(-1)[faces]


@pytest.mark.parametrize("op", ["union", "intersection", "difference", "void"])
def test_csg_matches_oracle_and_voxtpu(op):
    n = 64
    spec = GridSpec(n=n, origin=(0.0,) * 3, voxel_size=1.0)
    a, b = _occ(n, seed=5), _occ(n, seed=6)
    ga = VoxelGrid.from_dense(torch.from_numpy(a), spec)
    gb = VoxelGrid.from_dense(torch.from_numpy(b), spec)
    got = csg(ga, gb, op)
    want = a if op == "void" else csg_ref(a, b, op)
    np.testing.assert_array_equal(got.to_dense().numpy(), want)
    jspec = JSpec(n, spec.origin, spec.voxel_size)
    jres = j_csg(JGrid.from_dense(jnp.asarray(a), jspec),
                 JGrid.from_dense(jnp.asarray(b), jspec), op)
    np.testing.assert_array_equal(interop.words_to_numpy(got.words),
                                  np.asarray(jres.words))
    with pytest.raises(ValueError, match="unknown CSG op"):
        csg(ga, gb, "xor")


def test_exporters_match_voxtpu():
    n = 32
    rng = np.random.default_rng(9)
    occ = _occ(n, seed=9, p=0.1)
    sdf = rng.normal(size=(n, n, n)).astype(np.float32)
    sdf[rng.random((n, n, n)) < 0.05] = np.inf
    spec = GridSpec(n=n, origin=(0.5, -1.0, 2.0), voxel_size=0.25)
    jspec = JSpec(n, spec.origin, spec.voxel_size)
    pairs = [
        (t_g2m.voxels_grid_to_mesh_compressed(occ, spec),
         j_g2m.voxels_grid_to_mesh_compressed(occ, jspec)),
        (t_g2m.voxels_grid_to_mesh(occ, sdf, spec),
         j_g2m.voxels_grid_to_mesh(occ, sdf, jspec)),
        (t_g2m.voxels_grid_to_point_cloud(occ, sdf, spec),
         j_g2m.voxels_grid_to_point_cloud(occ, sdf, jspec)),
    ]
    for got, ref in pairs:
        for field in ("coords", "normals", "colors", "faces", "faces_normals"):
            np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))


def test_profiling_scope_prints_label(capsys):
    with ProfilingScope("CudaVox::processing") as p:
        p.observe(torch.zeros(3))
    out = capsys.readouterr().out
    assert out.startswith("[CudaVox::processing]: ") and out.rstrip().endswith(" ms")
    assert p.elapsed_ms >= 0.0
