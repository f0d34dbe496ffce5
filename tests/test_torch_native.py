"""voxtpu_torch's native C++/OpenMP backend against voxtpu's library and
the NumPy oracle: voxelize, JFA and the three CSG ops bitwise on
procedural meshes at n = 32 and 64 (the oracle's JFA on dyadic grids,
where no FMA contraction can move a distance), the OBJ export byte for
byte, the import and its Python fallback, the no-fallback rule, and the
CLI's -t 3 exports against voxtpu's CLI -t 3."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu.grids.voxel_grid import GridSpec as JGridSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.native import native_csg as j_csg
from voxtpu.native import native_export_mesh as j_export
from voxtpu.native import native_import_mesh as j_import
from voxtpu.native import native_jfa as j_jfa
from voxtpu.native import native_voxelize as j_voxelize
from voxtpu_torch import cli, native
from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.mesh.obj_io import export_mesh, import_mesh
from voxtpu_torch.ops.csg import csg
from voxtpu_torch.ops.jfa import jfa
from voxtpu_torch.ops.reference import jfa_ref, voxelize_ref
from voxtpu_torch.ops.vox import voxelize
from voxtpu_torch.utils import logging as vlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}


def _meshes():
    shapes = {
        "icosphere": procedural.icosphere(3, center=(0.1, -0.2, 0.3)),
        "torus": procedural.torus(1.0, 0.35, 24, 12),
        "washer": procedural.washer(0.75, 1.0, 0.25, 48, center=(2.0, 2.0, 2.0)),
    }
    return {k: Mesh(name=k, coords=c, faces=f, faces_normals=f) for k, (c, f) in shapes.items()}


MESHES = _meshes()


def _jspec(spec):
    return JGridSpec(n=spec.n, origin=spec.origin, voxel_size=spec.voxel_size)


def _jmesh(m):
    return JMesh(name=m.name, coords=m.coords, faces=m.faces, faces_normals=m.faces_normals)


def _dyadic(n):
    return GridSpec(n=n, origin=(-1.5, -1.25, -1.0), voxel_size=2.0 ** -(n.bit_length() - 3))


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_native_voxelize_is_voxtpus_and_the_oracles(name, n):
    mesh = MESHES[name]
    spec = GridSpec.fit(mesh.coords, n)
    grid = voxelize(mesh, spec, "native", device="cpu")
    dense = grid.to_dense().numpy()
    assert dense.any() and not dense.all()
    np.testing.assert_array_equal(dense, j_voxelize(_jmesh(mesh), _jspec(spec)))
    np.testing.assert_array_equal(dense, voxelize_ref(mesh, spec))
    assert torch.equal(grid.words, voxelize(mesh, spec, "reference", device="cpu").words)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_native_jfa_is_voxtpus_and_the_oracles(name, n):
    """Bitwise voxtpu's library on the fitted grid; bitwise the oracle and
    voxtpu's library on a dyadic grid. Elsewhere g++ contracts the
    distance's multiply-adds (-O3 -march=native), which can settle a
    near-tie on another seed than the oracle's term-for-term float."""
    mesh = MESHES[name]
    spec = GridSpec.fit(mesh.coords, n)
    occ = voxelize(mesh, spec, "native", device="cpu").to_dense()
    sdf = jfa(occ, spec, backend="native")
    want = j_jfa(occ.numpy(), _jspec(spec))
    np.testing.assert_array_equal(sdf.numpy().view(np.int32), want.view(np.int32))
    dy = _dyadic(n)
    docc = voxelize(mesh, dy, "reference", device="cpu").to_dense()
    assert docc.any()
    got = jfa(docc, dy, backend="native").numpy()
    np.testing.assert_array_equal(got.view(np.int32), jfa_ref(docc.numpy(), dy).view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  j_jfa(docc.numpy(), _jspec(dy)).view(np.int32))


@pytest.mark.parametrize("op", ["union", "intersection", "difference"])
def test_native_csg_is_voxtpus_and_the_oracles(op):
    a, b = MESHES["icosphere"], MESHES["torus"]
    spec = GridSpec.fit(np.concatenate([a.coords, b.coords]), 64)
    ga, gb = (voxelize(m, spec, "native", device="cpu") for m in (a, b))
    got = csg(ga, gb, op, backend="native")
    w1, w2 = ga.words.numpy().view(np.uint32), gb.words.numpy().view(np.uint32)
    want = {"union": w1 | w2, "intersection": w1 & w2, "difference": w1 & ~w2}[op]
    np.testing.assert_array_equal(got.words.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got.words.numpy().view(np.uint32), j_csg(w1, w2, op))
    for backend in ("plain", "cuda", "reference"):
        assert torch.equal(csg(ga, gb, op, backend=backend).words, got.words), backend
    assert csg(ga, gb, "void", backend="native") is ga
    with pytest.raises(ValueError, match="unknown backend"):
        csg(ga, gb, op, backend="xla")


def test_native_export_is_voxtpus_byte_for_byte(tmp_path):
    mesh = MESHES["washer"]
    ours, theirs = tmp_path / "ours.obj", tmp_path / "theirs.obj"
    export_mesh(ours, mesh)  # use_native=True, voxtpu's default
    assert j_export(str(theirs), _jmesh(mesh))
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_bytes().startswith(b"# OBJ file written by voxtpu (native)")
    export_mesh(tmp_path / "py.obj", mesh, use_native=False)
    assert (tmp_path / "py.obj").read_bytes().startswith(b"# OBJ file written by voxtpu\n")


def test_native_import_is_voxtpus_and_the_python_parsers(tmp_path, capsys):
    path = tmp_path / "w.obj"
    export_mesh(path, MESHES["washer"], use_native=False)
    vlog.set_level("info")
    try:
        got = import_mesh(path)
        assert "native parser" in capsys.readouterr().err
        py = import_mesh(path, use_native=False)
        assert "Python parser" in capsys.readouterr().err
    finally:
        vlog.set_level(os.environ.get("VOXTPU_LOG", "warn"))
    want = j_import(str(path))
    for field in ("coords", "normals", "colors", "faces", "faces_normals"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
        np.testing.assert_array_equal(getattr(got, field), getattr(py, field), field)


def test_native_import_hands_bad_files_to_the_python_parser(tmp_path, capsys):
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    assert native.native_import_mesh(str(quad)) is None
    vlog.set_level("info")
    try:
        with pytest.raises(ValueError, match="4 vertices"):
            import_mesh(quad)
        assert "handed the file off; Python parser" in capsys.readouterr().err
    finally:
        vlog.set_level(os.environ.get("VOXTPU_LOG", "warn"))
    oor = tmp_path / "oor.obj"
    oor.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9\n")
    with pytest.raises(ValueError, match="out of range"):
        import_mesh(oor)


def test_native_backend_has_no_fallback(tmp_path, monkeypatch, capsys):
    """Where the library cannot be built, -t 3's entry points raise; the
    OBJ reader alone takes its Python parser, and says so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ either
    mesh = MESHES["icosphere"]
    spec = GridSpec.fit(mesh.coords, 32)
    with pytest.raises(native.NativeUnavailable):
        voxelize(mesh, spec, "native", device="cpu")
    occ = torch.zeros((32, 32, 32), dtype=torch.bool)
    with pytest.raises(native.NativeUnavailable):
        jfa(occ, spec, backend="native")
    grid = VoxelGrid.from_dense(occ, spec)
    with pytest.raises(native.NativeUnavailable):
        csg(grid, grid, "union", backend="native")
    with pytest.raises(native.NativeUnavailable):
        export_mesh(tmp_path / "x.obj", mesh)
    export_mesh(tmp_path / "x.obj", mesh, use_native=False)
    vlog.set_level("info")
    try:
        back = import_mesh(tmp_path / "x.obj")
        assert "native parser unavailable" in capsys.readouterr().err
    finally:
        vlog.set_level(os.environ.get("VOXTPU_LOG", "warn"))
    np.testing.assert_array_equal(back.faces, mesh.faces)
    argv = [str(tmp_path / "x.obj"), "-n", "32", "-t", "3", "--device", "cpu"]
    with pytest.raises(native.NativeUnavailable):
        cli.run(argv)
    assert cli.main(argv) == 1
    assert "no-such-compiler" in capsys.readouterr().err


def test_native_build_takes_g_plus_plus_where_cxx_cannot_build(tmp_path, monkeypatch):
    """A $CXX toolchain without OpenMP's libgomp does not stop the
    build: g++ on the PATH is tried next."""
    wrapper = tmp_path / "gxx"
    wrapper.write_text('#!/bin/sh\necho "g++-real: fatal error: cannot read spec file '
                       '\'libgomp.spec\'" >&2\nexit 1\n')
    wrapper.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(wrapper))
    assert native.compilers()[0] == str(wrapper) and len(native.compilers()) == 2
    mesh = MESHES["torus"]
    spec = GridSpec.fit(mesh.coords, 32)
    got = voxelize(mesh, spec, "native", device="cpu")
    assert torch.equal(got.words, voxelize(mesh, spec, "reference", device="cpu").words)


EXPORT_FLAGS = ["-n", "32", "-p", "1", "-s", "-e", "-o", "merged.obj"]
EXPORTS = ("native_ring_a.obj", "native_ring_b.obj", "csg_vox_native_merged.obj",
           "sdf_native_merged.obj", "sdf_point_cloud_native_merged.obj")


def test_cli_native_exports_are_voxtpu_clis(tmp_path):
    """`python -m voxtpu_torch.cli -t 3` exports byte for byte what
    `python -m voxtpu.cli -t 3` exports (both write through the same
    C++ code), and prints the Native* scopes."""
    paths = []
    for name, center in (("ring_a", (2.0, 2.0, 2.0)), ("ring_b", (2.5, 2.0, 2.0625))):
        c, f = procedural.washer(0.75, 1.0, 0.25, 48, center=center)
        paths.append(str(tmp_path / f"{name}.obj"))
        export_mesh(paths[-1], Mesh(name=name, coords=c, faces=f, faces_normals=f))
    runs = {}
    for pkg in ("voxtpu", "voxtpu_torch"):
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", *paths, *EXPORT_FLAGS, "-t", "3",
             "--device", "cpu", "--out-dir", str(tmp_path / pkg)],
            capture_output=True, text=True, cwd=str(tmp_path), env=ENV, timeout=600)
        assert r.returncode == 0, r.stderr
        runs[pkg] = r.stdout
    for scope in ("NativeVox(ring_a.obj)", "NativeCSG", "NativeJFA"):
        assert f"[{scope}]:" in runs["voxtpu_torch"], runs["voxtpu_torch"]
    for name in EXPORTS:
        ours = (tmp_path / "voxtpu_torch" / name).read_bytes()
        assert ours == (tmp_path / "voxtpu" / name).read_bytes(), name
        assert len(ours) > 100 or "point_cloud" in name
