"""voxtpu_torch CLI: the same exports as voxtpu's CLI, the device
contract, and a port that runs with jax blocked from import."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from voxtpu_torch import cli
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.mesh.obj_io import export_mesh, import_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}


def _write_meshes(tmp_path):
    """Two overlapping washers whose shared grid fit is dyadic (origin
    and voxel size exact in binary), so that voxtpu's XLA:CPU distances
    and the oracle's agree bit for bit."""
    paths = []
    for name, center in (("ring_a", (2.0, 2.0, 2.0)), ("ring_b", (2.5, 2.0, 2.0625))):
        coords, faces = procedural.washer(0.75, 1.0, 0.25, 48, center=center)
        path = tmp_path / f"{name}.obj"
        export_mesh(path, Mesh(name=name, coords=coords, faces=faces,
                               faces_normals=faces))
        paths.append(str(path))
    return paths


def _same_mesh(a, b):
    ma, mb = import_mesh(a), import_mesh(b)
    for field in ("coords", "normals", "colors", "faces", "faces_normals"):
        np.testing.assert_array_equal(getattr(ma, field), getattr(mb, field),
                                      err_msg=f"{a} vs {b}: {field}")
    return ma.num_faces


def test_cli_exports_match_voxtpu_cli(tmp_path, capsys):
    paths = _write_meshes(tmp_path)
    flags = ["-n", "32", "-p", "1", "-s", "-e", "-o", "merged.obj"]
    r = subprocess.run(
        [sys.executable, "-m", "voxtpu.cli", *paths, *flags, "-t", "1",
         "--device", "cpu", "--out-dir", str(tmp_path / "jax")],
        capture_output=True, text=True, cwd=str(tmp_path), env=ENV, timeout=600)
    assert r.returncode == 0, r.stderr
    assert cli.main([*paths, *flags, "-t", "2", "--device", "cpu",
                     "--out-dir", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    for label in (r"CudaVox\(ring_a\.obj\)", r"CudaVox::planning",
                  r"CudaVox::processing", r"CudaCSG", r"CudaJFA"):
        assert re.search(rf"\[{label}\]: [\d.]+ ms", out), (label, out)
    pairs = [("xla_ring_a.obj", "cuda_ring_a.obj"),
             ("xla_ring_b.obj", "cuda_ring_b.obj"),
             ("csg_vox_xla_merged.obj", "csg_vox_cuda_merged.obj"),
             ("sdf_xla_merged.obj", "sdf_cuda_merged.obj"),
             ("sdf_point_cloud_xla_merged.obj", "sdf_point_cloud_cuda_merged.obj")]
    for jname, pname in pairs:
        faces = _same_mesh(tmp_path / "jax" / jname, tmp_path / "port" / pname)
        assert faces > 0 or "point_cloud" in jname


def test_cli_reference_backend_matches_cuda_backend(tmp_path):
    paths = _write_meshes(tmp_path)
    flags = ["-n", "32", "-p", "3", "-s", "--device", "cpu"]
    ref = cli.run([*paths, *flags, "-t", "0"])
    got = cli.run([*paths, *flags, "-t", "2"])
    assert torch.equal(ref.grids[0].words, got.grids[0].words)
    assert ref.grids[0].count() > 0
    assert torch.equal(ref.sdf.view(torch.int32), got.sdf.view(torch.int32))


def test_cli_benchmark_mode(tmp_path, capsys):
    paths = _write_meshes(tmp_path)
    assert cli.main([paths[0], "-n", "32", "-m", "3", "-p", "1",
                     "--device", "cpu"]) == 0
    assert len(re.findall(r"\[CudaVox\(ring_a\.obj\)\]", capsys.readouterr().out)) == 3


def test_cli_device_cuda_without_a_card_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    paths = _write_meshes(tmp_path)
    assert cli.main([paths[0], "-n", "32"]) != 0          # --device cuda default
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("t", ["1", "3"])
def test_cli_unported_backends_exit_with_message(tmp_path, capsys, t):
    paths = _write_meshes(tmp_path)
    assert cli.main([paths[0], "-t", t, "--device", "cpu"]) != 0
    assert "not ported yet" in capsys.readouterr().err
    assert cli.main(["--device", "cpu"]) != 0             # no input file


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports neither jax nor voxtpu: run its CLI in a process
    where importing either raises."""
    paths = _write_meshes(tmp_path)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['voxtpu'] = None\n"
        "import voxtpu_torch, voxtpu_torch.cli, voxtpu_torch.interop\n"
        "import voxtpu_torch.ops.soft_vox, voxtpu_torch.ops.soft_vox_fused\n"
        "import voxtpu_torch.ops.soft_vox_cuda, voxtpu_torch.models.fit\n"
        "import voxtpu_torch.models.csg_fit, voxtpu_torch.examples.fit_vertices\n"
        "rc = voxtpu_torch.cli.main(sys.argv[1:])\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "sys.exit(rc)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, *paths, "-n", "32", "-t", "2", "-p", "1",
         "-s", "-e", "--device", "cpu", "--out-dir", str(tmp_path / "out")],
        capture_output=True, text=True, cwd=str(tmp_path), env=ENV, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "[CudaJFA]:" in r.stdout
    assert (tmp_path / "out" / "sdf_cuda_out.obj").exists()
