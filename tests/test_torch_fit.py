"""voxtpu_torch's VoxelFit and CSGFit against voxtpu's, on the CPU.

Same procedural meshes, noise and target grid (made with numpy) on both
sides; voxtpu's fit runs its xla engine, the port's its plain engine.
`torch.optim.Adam` and optax's adam compute the same update with
another rounding order, so trajectories agree to rtol 1e-5 (CSGFit's to
2e-5 absolute, see there), not bit for bit; the port against itself
(checkpoint resume) is bit for bit.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.models import csg_fit as j_csg_fit
from voxtpu.models import fit as j_fit
from voxtpu.ops import soft_vox as j_soft
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.models.csg_fit import CSGFit, CSGPart
from voxtpu_torch.models.fit import VoxelFit, auto_engine, soft_iou_loss
from voxtpu_torch.ops.reference import voxelize_ref
from voxtpu_torch.ops.soft_vox import make_soft_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
N = 32
LR = 5e-3
AUTO_512 = "seg"  # "auto"'s engine on a card for 256 <= n <= 512


def _meshes(coords, faces):
    return (Mesh(name="m", coords=coords, faces=faces, faces_normals=faces),
            JMesh(name="m", coords=coords, faces=faces, faces_normals=faces))


@pytest.fixture(scope="module")
def sphere():
    """An icosphere, its hard grid at N (the NumPy oracle) and a noisy
    start (0.01 of the size, as voxtpu's fit tests use)."""
    coords, faces = procedural.icosphere(2, center=(0.1, -0.2, 0.3))
    mesh, _ = _meshes(coords, faces)
    spec = GridSpec.fit(coords, N)
    target = voxelize_ref(mesh, spec).astype(np.float32)
    noisy = (coords + np.random.default_rng(0).normal(0, 0.01, coords.shape)
             ).astype(np.float32)
    return dict(coords=coords, faces=faces, spec=spec, target=target, noisy=noisy)


def _port_fit(s, coords=None, **kw):
    mesh, _ = _meshes(s["noisy"] if coords is None else coords, s["faces"])
    plan = make_soft_plan(mesh, s["spec"], pad_window=2)
    kw.setdefault("refresh_every", 0)
    return VoxelFit(plan, torch.from_numpy(s["target"]), learning_rate=LR, **kw)


def _voxtpu_fit(s):
    _, jmesh = _meshes(s["noisy"], s["faces"])
    spec = s["spec"]
    jspec = JSpec(n=spec.n, origin=spec.origin, voxel_size=spec.voxel_size)
    plan = j_soft.make_soft_plan(jmesh, jspec, pad_window=2)
    return j_fit.VoxelFit(plan, jnp.asarray(s["target"]), learning_rate=LR,
                          refresh_every=0, engine="xla")


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=atol)


def test_voxelfit_plain_matches_voxtpu_xla(sphere):
    fit, jfit = _port_fit(sphere), _voxtpu_fit(sphere)
    assert fit.engine == "plain"
    state, jstate = fit.init(sphere["noisy"]), jfit.init(sphere["noisy"])
    # voxtpu's eager `loss` and its jitted step differ by 1.0e-5 here
    # (XLA:CPU rounds the two programs differently); the steps below
    # agree to 2.4e-7.
    np.testing.assert_allclose(float(fit.loss(state.coords)),
                               float(jfit.loss(jstate.coords)), rtol=2e-4)
    for _ in range(3):
        state, m = fit.step(state)
        jstate, jm = jfit.step(jstate)
        _close(float(m["loss"]), float(jm["loss"]))
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        _close(state.coords.numpy(), jstate.coords)
    assert state.step == int(jstate.step) == 3


def test_port_continues_a_voxtpu_checkpoint(sphere, tmp_path):
    jfit = _voxtpu_fit(sphere)
    jstate = jfit.init(sphere["noisy"])
    for _ in range(2):
        jstate, _ = jfit.step(jstate)
    path = tmp_path / "voxtpu.npz"
    jfit.save_checkpoint(path, jstate)
    fit = _port_fit(sphere)
    state = fit.load_checkpoint(path)
    assert fit.refresh_count == 0 and state.step == 2
    np.testing.assert_array_equal(state.coords.numpy(), np.asarray(jstate.coords))
    mu, nu = jstate.opt_state[0].mu, jstate.opt_state[0].nu
    np.testing.assert_array_equal(state.opt_state["exp_avg"].numpy(), np.asarray(mu))
    np.testing.assert_array_equal(state.opt_state["exp_avg_sq"].numpy(), np.asarray(nu))
    for _ in range(2):
        state, _ = fit.step(state)
        jstate, _ = jfit.step(jstate)
        _close(state.coords.numpy(), jstate.coords)
    # and voxtpu reads the port's checkpoint back
    fit.save_checkpoint(tmp_path / "port.npz", state)
    restored = _voxtpu_fit(sphere).load_checkpoint(tmp_path / "port.npz")
    np.testing.assert_array_equal(np.asarray(restored.coords), state.coords.numpy())
    assert int(restored.step) == 4


def test_checkpoint_resumes_bit_identically(sphere, tmp_path):
    fit = _port_fit(sphere)
    state = fit.init(sphere["noisy"])
    for _ in range(3):
        state, _ = fit.step(state)
    fit.save_checkpoint(tmp_path / "fit.npz", state)
    cont = state
    for _ in range(2):
        cont, _ = fit.step(cont)
    fit2 = _port_fit(sphere)
    restored = fit2.load_checkpoint(tmp_path / "fit.npz")
    assert torch.equal(restored.coords, state.coords) and restored.step == 3
    for _ in range(2):
        restored, _ = fit2.step(restored)
    assert torch.equal(restored.coords, cont.coords)


def test_drift_past_the_pad_window_refreshes_the_plan(sphere, tmp_path):
    fit = _port_fit(sphere, refresh_every=1, engine="fused")
    state = fit.init(sphere["noisy"])
    state, _ = fit.step(state)
    assert fit.refresh_count == 0
    vs = sphere["spec"].voxel_size
    moved = type(state)(coords=state.coords + 2.0 * vs, opt_state=state.opt_state,
                        step=state.step)
    old_plan, old_engine_plan = fit.plan, fit.engine_plan
    assert float(fit.drift_voxels(moved.coords)) > fit.drift_limit_vox
    state, m = fit.step(moved)
    assert fit.refresh_count == 1
    assert fit.plan is not old_plan and fit.engine_plan is not old_engine_plan
    np.testing.assert_array_equal(fit.plan.plan_coords, moved.coords.numpy())
    assert float(m["max_drift_vox"]) < fit.drift_limit_vox
    # A checkpoint far from this fit's plan refreshes it on load.
    fit.save_checkpoint(tmp_path / "far.npz", moved)
    fit2 = _port_fit(sphere)
    fit2.load_checkpoint(tmp_path / "far.npz")
    assert fit2.refresh_count == 2  # the saved count, plus this refresh


@pytest.mark.parametrize("engine", ["fused", "cuda"])
def test_kernel_engines_descend_and_match_plain(sphere, engine):
    fit, plain = _port_fit(sphere, engine=engine), _port_fit(sphere)
    assert fit.engine == engine
    state, pstate = fit.init(sphere["noisy"]), plain.init(sphere["noisy"])
    l0 = float(fit.loss(state.coords))
    for _ in range(3):
        state, m = fit.step(state)
        pstate, pm = plain.step(pstate)
    assert float(m["loss"]) < l0
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]), rtol=1e-4)


def test_engine_choice():
    c, f = procedural.icosahedron()
    spec = GridSpec.fit(c, 16)
    plan = make_soft_plan(Mesh(coords=c, faces=f, faces_normals=f), spec)
    target = torch.zeros((16, 16, 16))
    assert VoxelFit(plan, target).engine == "plain"
    # The seg engine's plan refuses n below 256 (the panels must be
    # narrower than the grid).
    with pytest.raises(ValueError, match="segmented engine needs n >= 256"):
        VoxelFit(plan, target, engine="seg")
    with pytest.raises(ValueError, match="unknown engine"):
        VoxelFit(plan, target, engine="xla")
    cuda = torch.device("cuda")
    assert [auto_engine(n, cuda) for n in (128, 256, 320, 512, 1024)] == [
        "fused", AUTO_512, "fused", AUTO_512, "fused"]
    assert auto_engine(512, "cpu") == "plain"


def test_csgfit_matches_voxtpu_and_descends():
    parts_np = [procedural.icosphere(2, 0.8), procedural.icosahedron(0.8, (0.7, 0.1, 0.2))]
    rng = np.random.default_rng(0)
    noisy = [(c + rng.normal(0, 0.02, c.shape)).astype(np.float32) for c, _ in parts_np]
    spec = GridSpec.fit(np.concatenate([c for c, _ in parts_np]), 24)
    jspec = JSpec(n=spec.n, origin=spec.origin, voxel_size=spec.voxel_size)
    target = np.zeros((24, 24, 24), bool)
    for c, f in parts_np:
        target |= voxelize_ref(Mesh(coords=c, faces=f, faces_normals=f), spec)
    target = target.astype(np.float32)
    parts, jparts = [], []
    for (_, f), c in zip(parts_np, noisy):
        mesh, jmesh = _meshes(c, f)
        parts.append(CSGPart(make_soft_plan(mesh, spec, pad_window=2), "union"))
        jparts.append(j_csg_fit.CSGPart(j_soft.make_soft_plan(jmesh, jspec, 2), "union"))
    fit = CSGFit(parts, torch.from_numpy(target), learning_rate=LR)
    jfit = j_csg_fit.CSGFit(jparts, jnp.asarray(target), learning_rate=LR)
    coords, opt = fit.init(noisy)
    jcoords, jopt = jfit.init(noisy)
    l0 = float(fit.loss(coords))
    _close(l0, float(jfit.loss(jcoords)))
    for _ in range(3):
        coords, opt, m = fit.step(coords, opt)
        jcoords, jopt, jm = jfit.step(jcoords, jopt)
        _close(float(m["loss"]), float(jm["loss"]))
        # Measured 7.9e-6 at the third step: Adam turns the ~1e-3
        # relative gradient differences of near-zero components (float32
        # sums in another order) into update differences of that share
        # of the learning rate.
        for got, want in zip(coords, jcoords):
            _close(got.numpy(), want, atol=2e-5)
    assert float(m["loss"]) < l0
    assert float(soft_iou_loss(torch.from_numpy(target), torch.from_numpy(target))) < 1e-6


@pytest.mark.parametrize("module", ["fit_vertices", "csg_fit_parts"])
def test_examples_run(module):
    r = subprocess.run(
        [sys.executable, "-m", f"voxtpu_torch.examples.{module}", "--n", "24",
         "--steps", "5", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=ENV, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "(improved)" in r.stdout, r.stdout


@pytest.mark.parametrize("module", ["fit_vertices", "csg_fit_parts"])
def test_examples_refuse_unpacked_n_on_a_card(module, capsys):
    """On a card the target comes from the packed voxelizer only: an N
    that is not a multiple of 32 is refused before any work, never sent
    to the NumPy oracle on the host."""
    import importlib

    main = importlib.import_module(f"voxtpu_torch.examples.{module}").main
    with pytest.raises(SystemExit) as exc:
        main(["--n", "48", "--steps", "1", "--device", "cuda"])
    assert exc.value.code == 2
    assert "multiple of 32" in capsys.readouterr().err


@pytest.mark.parametrize("module", ["fit_vertices", "csg_fit_parts"])
def test_examples_refuse_to_run_without_a_card(module, capsys):
    """The examples run on the card unless --device cpu asks for the
    CPU: without a card they exit and say so, never falling back."""
    import importlib

    assert not torch.cuda.is_available()
    main = importlib.import_module(f"voxtpu_torch.examples.{module}").main
    with pytest.raises(SystemExit) as exc:
        main(["--n", "32", "--steps", "1"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("n", [128, 320])
def test_fit_vertices_seg_needs_n_256(n, capsys):
    from voxtpu_torch.examples.fit_vertices import main

    with pytest.raises(SystemExit) as exc:
        main(["--n", str(n), "--engine", "seg", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--engine seg needs --n >= 256" in capsys.readouterr().err


def test_hard_occupancy_has_no_host_route_on_a_card():
    from voxtpu_torch.examples.fit_vertices import hard_occupancy

    c, f = procedural.icosahedron()
    mesh = Mesh(coords=c, faces=f, faces_normals=f)
    spec = GridSpec.fit(c, 24)
    with pytest.raises(ValueError, match="N % 32 == 0"):
        hard_occupancy(mesh, spec, torch.device("cuda"))
    occ = hard_occupancy(mesh, spec, torch.device("cpu"))
    assert torch.equal(occ, torch.from_numpy(voxelize_ref(mesh, spec)))
