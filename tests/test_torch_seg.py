"""voxtpu_torch's seg engine (B9-B11) against voxtpu's, on the CPU.

The mesh is voxtpu's `seg_setup` (`tests/test_soft_vox_seg.py:26-52`)
built from procedural parts: a torus (24 x 12 segments, 576 faces)
subdivided once to 2,304 faces, jittered by 1e-3 (numpy seed 0), in a
256^3 grid scaled so that it spans ~96 voxels. n = 256 is the engine's
floor. voxtpu runs on the CPU: its seg engine and its fused engine in
interpret mode, the fused one with ``mode="highest"`` (f32 dots); the
port's wrappers take their kernels' plain torch versions.

Tolerances, each with its reason:
- plan arrays: exact (integers);
- occupancy: atol 1e-5 against the float64 sum of the same float32
  fragments over whole rows (the fused formula the panels decompose;
  measured 1.12e-7); atol 1e-4 against voxtpu's fused(highest), measured
  5.12e-5: at this voxel size float32 rounding of the coefficient rows
  moves both packages 3-6e-5 off exact arithmetic (the port 3.1e-5,
  voxtpu 5.7e-5, at the same cells); voxtpu's own 2e-2 against its seg
  engine (bf16_3x dots), measured 4.95e-5;
- the combine: bitwise, against both of voxtpu's combines;
- coordinate gradients: rtol 1e-3, atol 1e-4 x max|g| against voxtpu's
  fused(highest), as `test_torch_soft.py` (measured 1.3e-5 x max);
  against voxtpu's seg engine voxtpu's own quantile rule (99.9% within
  5e-3 x max; measured 100%, the largest 5.3e-4 x max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.ops import soft_vox as j_soft
from voxtpu.ops import soft_vox_fused as j_fused
from voxtpu.ops import soft_vox_seg as j_seg
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.models.fit import VoxelFit
from voxtpu_torch.ops import soft_vox, soft_vox_fused, soft_vox_seg
from voxtpu_torch.ops.soft_vox import make_soft_plan
from voxtpu_torch.ops.soft_vox_seg import (LATTICE, MARGIN, PANEL, SegSoftPlan,
                                           soft_voxelize_seg)
from voxtpu_torch.ops.vox import voxelize

N = 256


def _torus_256():
    coords, faces = procedural.subdivide(*procedural.torus(1.0, 0.35, 24, 12), 1)
    coords = (coords + np.random.default_rng(0).normal(0, 1e-3, coords.shape)
              ).astype(np.float32)
    side = float(np.ptp(coords, axis=0).max())
    spec = GridSpec(n=N, origin=tuple(float(v) for v in coords.min(axis=0)),
                    voxel_size=side / 96.0)
    return coords, faces, spec


@pytest.fixture(scope="module")
def seg():
    coords, faces, spec = _torus_256()
    mesh = Mesh(name="torus", coords=coords, faces=faces, faces_normals=faces)
    jspec = JSpec(n=N, origin=spec.origin, voxel_size=spec.voxel_size)
    sp = make_soft_plan(mesh, spec)
    jsp = j_soft.make_soft_plan(
        JMesh(name="torus", coords=coords, faces=faces, faces_normals=faces), jspec)
    probe = np.random.default_rng(1).standard_normal((N, N, N)).astype(np.float32)
    return dict(coords=coords, faces=faces, mesh=mesh, spec=spec, sp=sp, jsp=jsp,
                plan=SegSoftPlan(sp, coords, "cpu"), jplan=j_seg.SegSoftPlan(jsp, coords),
                probe=probe, voxtpu={})


def _voxtpu(seg, engine):
    """voxtpu's unclipped occupancy and the coordinate gradient of the
    probe-weighted clipped occupancy, once per engine."""
    if engine not in seg["voxtpu"]:
        c = jnp.asarray(seg["coords"])
        if engine == "seg":
            plan, fwd = seg["jplan"], j_seg.soft_voxelize_seg
        else:
            plan = j_fused.FusedSoftPlan(seg["jsp"])

            def fwd(x, p, **kw):
                return j_fused.soft_voxelize_fused(x, p, mode="highest", **kw)
        occ = np.asarray(fwd(c, plan, clip=False))
        probe = jnp.asarray(seg["probe"])
        grad = np.asarray(jax.grad(lambda x: jnp.sum(fwd(x, plan) * probe))(c))
        seg["voxtpu"][engine] = (occ, grad)
    return seg["voxtpu"][engine]


def _port_grad(plan, coords, probe):
    x = torch.from_numpy(coords).requires_grad_(True)
    (soft_voxelize_seg(x, plan) * torch.from_numpy(probe)).sum().backward()
    return x.grad.numpy()


def _target(mesh, spec):
    return voxelize(mesh, spec, "cuda", device="cpu").to_dense().float()


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", [dict(), dict(tb_sub=2, tbl=64)])
def test_seg_plan_arrays_match_voxtpu(seg, layout):
    port = SegSoftPlan(seg["sp"], seg["coords"], "cpu", **layout)
    ref = (seg["jplan"] if not layout
           else j_seg.SegSoftPlan(seg["jsp"], seg["coords"], **layout))
    for attr in ("num_batches", "num_pairs", "num_fragments", "num_faces",
                 "num_vertices", "tc", "tb_sub", "tbl", "tz"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for attr in ("batch_tile", "batch_panel", "cells_b", "tblidx_b",
                 "table_face_flat"):
        np.testing.assert_array_equal(getattr(port, attr), np.asarray(getattr(ref, attr)))
    for (cls, inv), (jcls, jinv) in (
            ((port.expand_cls, port.expand_inv), (ref.expand_cls_d, ref.expand_inv_d)),
            ((port.vert_cls, port.vert_inv), (ref.vert_cls_d, ref.vert_inv_d))):
        assert len(cls) == len(jcls)
        for got, want in zip(cls, jcls):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(inv, np.asarray(jinv))
    # Both panel families occur, on the lattice, inside the grid; each
    # (tile, panel) key is one run of batches (voxtpu's FIRST/LAST flags
    # mark the same runs).
    assert port.num_fragments > 0
    fam_b = (port.batch_panel // LATTICE) % 2 == 1
    assert fam_b.any() and (~fam_b).any()
    assert ((port.batch_panel % LATTICE == 0) & (port.batch_panel <= N - PANEL)).all()
    key = port.batch_tile.astype(np.int64) * N + port.batch_panel
    assert port.num_runs == len(np.unique(key))
    starts = port.run_start[:-1]
    np.testing.assert_array_equal((np.asarray(ref.flags) & 1) != 0,
                                  np.isin(np.arange(port.num_batches), starts))


# ---------------------------------------------------------------------------
# Forward and gradients against voxtpu
# ---------------------------------------------------------------------------


def _rows_float64(coords, sp):
    """The fused formula (each slot's profile over its whole row) on the
    port's float32 fragments, summed in float64 and not rounded."""
    fp = soft_vox_fused.FusedSoftPlan(sp, "cpu")
    tables = soft_vox_fused.tables_of(torch.from_numpy(coords), fp).detach()
    prm = fp.prm(0.25, 0.5)
    valid, gcell, *_, w, xh = soft_vox_fused._fused_slots(
        tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d, 0, fp.num_batches, n=N,
        tc=fp.tc, prm=prm)
    out = soft_vox.profile_out(N, "cpu")
    rows = torch.where(valid, gcell, N * N).reshape(-1)
    soft_vox.profile_add(out, rows, w.reshape(-1), xh.reshape(-1),
                         soft_vox.x_centers(N, prm[0], prm[3], "cpu"), prm[5])
    return out[:N * N].view(N, N, N).numpy()


def test_seg_forward_matches_float64_rows_and_voxtpu_fused(seg):
    got = soft_voxelize_seg(torch.from_numpy(seg["coords"]), seg["plan"],
                            clip=False).numpy()
    want, _ = _voxtpu(seg, "fused")
    assert got.shape == (N, N, N) and want.max() > 0.9
    np.testing.assert_allclose(got, _rows_float64(seg["coords"], seg["sp"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_seg_forward_within_voxtpu_seg_bound(seg):
    got = soft_voxelize_seg(torch.from_numpy(seg["coords"]), seg["plan"], clip=False)
    want, _ = _voxtpu(seg, "seg")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


def test_port_on_voxtpu_layout_matches_own_plan(seg):
    """The port on voxtpu's seg layout (carried across with interop)
    gives its result on its own plan bit for bit: the layouts are
    equal."""
    jp = seg["jplan"]
    plan = interop.seg_plan_from_voxtpu(seg["sp"], jp.batch_tile, jp.batch_panel,
                                        jp.cells_b, jp.tblidx_b, jp.table_face_flat,
                                        device="cpu")
    c = torch.from_numpy(seg["coords"])
    assert torch.equal(soft_voxelize_seg(c, plan), soft_voxelize_seg(c, seg["plan"]))
    np.testing.assert_array_equal(_port_grad(plan, seg["coords"], seg["probe"]),
                                  _port_grad(seg["plan"], seg["coords"], seg["probe"]))
    assert plan.xhit_drift_vox(seg["coords"]) == 0.0


def test_seg_gradients_match_voxtpu(seg):
    got = _port_grad(seg["plan"], seg["coords"], seg["probe"])
    _, want = _voxtpu(seg, "fused")
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale)
    _, want = _voxtpu(seg, "seg")
    frac = np.mean(np.abs(got - want) <= 5e-3 * np.abs(want).max())
    assert frac >= 0.999, f"only {frac:.2%} of gradient elements agree"


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combine", ["xla", "pallas"])
def test_seg_combine_plain_matches_voxtpu(monkeypatch, combine):
    """`seg_combine_plain` is bitwise voxtpu's `_seg_combine` on seeded
    random family outputs, in its XLA form and through its Pallas
    kernel in interpret mode (`test_combine_kernel_matches_xla`'s
    inputs: a large tc keeps the interpret grid small; a pad tile and
    voxtpu's trash block, which the port's arrays do not have)."""
    rng = np.random.default_rng(3)
    n, tc, tz = 256, 2048, 8
    nt, nblk = (n * n) // tc, n // PANEL
    out_a = rng.standard_normal((nt + 1, nblk + 1, tc, PANEL)).astype(np.float32)
    out_b = rng.standard_normal((nt + 1, nblk + 1, tc, PANEL)).astype(np.float32)
    carry = rng.standard_normal((nt + 1, n // LATTICE, 1, tc)).astype(np.float32)
    monkeypatch.setenv("SEG_COMBINE", combine)
    want = np.asarray(j_seg._seg_combine(jnp.asarray(out_a), jnp.asarray(out_b),
                                         jnp.asarray(carry), n=n, tc=tc, tz=tz, nt=nt))
    got = soft_vox_seg.seg_combine(torch.from_numpy(out_a[:nt, :nblk].copy()),
                                   torch.from_numpy(out_b[:nt, :nblk].copy()),
                                   torch.from_numpy(carry[:nt, :, 0].copy()),
                                   n=n, tc=tc, tz=tz)
    assert got.shape == (n, n, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_seg_bwd_plain_is_the_gradient_of_the_forward_plains(seg):
    """B11's plain version equals torch autograd through B9's and B10's
    plain versions on a random cotangent."""
    plan = seg["plan"]
    prm = plan.prm(0.5, 0.5)
    tables = soft_vox_fused.tables_of(torch.from_numpy(seg["coords"]), plan).detach()
    g = torch.from_numpy(seg["probe"])
    args = (plan.cells_d, plan.tblidx_d, plan.batch_tile_d, plan.batch_panel_d)
    kw = dict(n=N, tc=plan.tc, tz=plan.tz)
    t = tables.clone().requires_grad_(True)
    occ = soft_vox_seg.seg_combine_plain(
        *soft_vox_seg.seg_fwd_plain(t, *args, prm=prm, **kw), **kw)
    (occ * g).sum().backward()
    got = soft_vox_seg.seg_bwd_plain(tables, *args, g, soft_vox_seg.seg_gpre(g),
                                     prm=prm, **kw)
    want = t.grad
    np.testing.assert_allclose(got[..., :13].numpy(), want[..., :13].numpy(),
                               rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert not got[..., 13:].any()


def test_seg_wrappers_validate_arguments(seg):
    plan = seg["plan"]
    tables = torch.zeros((plan.num_batches, plan.tbl, 16))
    args = (plan.cells_d, plan.tblidx_d, plan.batch_tile_d, plan.batch_panel_d)
    kw = dict(n=N, tc=plan.tc, tz=plan.tz, prm=plan.prm(0.5, 0.5))
    with pytest.raises(TypeError, match="tables"):
        soft_vox_seg.seg_fwd(tables.double(), *args, plan.run_start_d, **kw)
    with pytest.raises(ValueError, match="batch_panel"):
        soft_vox_seg.seg_fwd(tables, *args[:3], plan.batch_panel_d[:1],
                             plan.run_start_d, **kw)
    with pytest.raises(ValueError, match="gpre: expected shape"):
        soft_vox_seg.seg_bwd(tables, *args, torch.zeros((N, N, N)),
                             torch.zeros((N, N, N // 32)), **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        soft_vox_seg.seg_combine(*(torch.zeros(s, device="meta") for s in (
            (512, 2, 128, 128), (512, 2, 128, 128), (512, 4, 128))), n=N, tc=128, tz=8)


# ---------------------------------------------------------------------------
# Guards and the fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [128, 320, 8192])
def test_seg_plan_refuses_n(n):
    c, f = procedural.icosahedron()
    sp = make_soft_plan(Mesh(coords=c, faces=f, faces_normals=f),
                        GridSpec(n=n, origin=(-1.0, -1.0, -1.0), voxel_size=2.0 / 64))
    with pytest.raises(ValueError, match="segmented engine"):
        SegSoftPlan(sp, c, "cpu")


def test_seg_tau_x_guard(seg):
    x = torch.from_numpy(seg["coords"])
    limit = MARGIN / 17.0
    with pytest.raises(ValueError, match="tau_x_frac"):
        soft_voxelize_seg(x, seg["plan"], tau_x_frac=limit * 1.01)
    with pytest.raises(ValueError, match="tau_x_frac"):
        VoxelFit(seg["sp"], torch.zeros((N, N, N)), engine="seg",
                 tau_x_frac=4.0).loss(x)


@pytest.mark.parametrize("move", ["none", "x2", "jitter", "rotate"])
def test_xhit_drift_matches_voxtpu(seg, move):
    c = seg["coords"].astype(np.float64)
    vs = seg["spec"].voxel_size
    if move == "x2":
        c = c + [2.0 * vs, 0.0, 0.0]
    elif move == "jitter":
        c = c + np.random.default_rng(7).normal(0, 0.3 * vs, c.shape)
    elif move == "rotate":
        t = 0.01
        c = c @ np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                          [0, 0, 1]]).T
    moved = c.astype(np.float32)
    got = seg["plan"].xhit_drift_vox(torch.from_numpy(moved))
    assert got == seg["jplan"].xhit_drift_vox(moved)
    assert (got == 0.0) == (move == "none")
    if move == "x2":
        assert got >= 2.0


def test_voxelfit_seg_refreshes_on_xhit_drift_only(seg):
    """With the vertex-drift limit out of the way, the seg fit rebuilds
    its plan when an x_hit moved past MARGIN - 17 tau_x_frac - 4 = 19.5
    voxels toward a panel edge, and not for a 12-voxel move."""
    vs = seg["spec"].voxel_size
    fit = VoxelFit(seg["sp"], _target(seg["mesh"], seg["spec"]), engine="seg",
                   refresh_every=0, drift_limit_frac=100.0)
    state = fit.init(seg["coords"])
    assert not fit.maybe_refresh_plan(state)
    near = type(state)(coords=state.coords + torch.tensor([12.0 * vs, 0.0, 0.0]),
                       opt_state=state.opt_state, step=state.step)
    assert fit.engine_plan.xhit_drift_vox(near.coords) <= 19.5
    assert not fit.maybe_refresh_plan(near) and fit.refresh_count == 0
    far = type(state)(coords=state.coords + torch.tensor([24.0 * vs, 0.0, 0.0]),
                      opt_state=state.opt_state, step=state.step)
    assert float(fit.drift_voxels(far.coords)) <= fit.drift_limit_vox
    old = fit.engine_plan
    assert fit.maybe_refresh_plan(far) and fit.refresh_count == 1
    assert fit.engine_plan is not old
    assert fit.engine_plan.xhit_drift_vox(far.coords) == 0.0
    state, m = fit.step(far)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_voxelfit_seg_first_loss_matches_fused(seg):
    target = _target(seg["mesh"], seg["spec"])
    losses = [float(VoxelFit(seg["sp"], target, engine=e, refresh_every=0)
                    .loss(seg["coords"])) for e in ("seg", "fused")]
    assert 0.0 < losses[1] < 1.0
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
