"""voxtpu_torch's soft voxelization engines against voxtpu's.

The same procedural meshes, made with a numpy seed, go through both
packages. voxtpu runs on the CPU: its xla engine, its fused engine in
interpret mode with ``mode="highest"`` (f32 dots) and its per-fragment
Pallas engine in interpret mode. The port's wrappers take their
kernels' plain torch versions for CPU tensors.

Engines, port <-> voxtpu: ``plain`` <-> ``xla`` (`soft_vox`), ``fused``
<-> ``fused`` (`soft_vox_fused`, kernels B7/B8), ``cuda`` <-> ``pallas``
(`soft_vox_pallas`, kernels B13).

Tolerances: plan arrays exact (integers). Occupancy: atol 1e-5 against
a float64 evaluation of the same formula; against voxtpu atol 2e-5, the
measured maximum being 1.34e-5 (n=32 torus, cuda engine; 1.02e-5 plain,
1.03e-5 fused). voxtpu on XLA:CPU contracts multiply-adds into FMAs
(ROADMAP C): its xla engine is 1.05e-5 from the float64 values where the
port's plain engine is 3.9e-6 (fused 5.0e-6). Coordinate gradients rtol 1e-3, atol
1e-4 * max|g|, as voxtpu's own engine-equivalence test uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.mesh.mesh import Mesh as JMesh
from voxtpu.ops import csg as j_csg
from voxtpu.ops import soft_vox as j_soft
from voxtpu.ops import soft_vox_fused as j_fused
from voxtpu.ops import soft_vox_pallas as j_pallas
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import csg, soft_vox, soft_vox_cuda, soft_vox_fused
from voxtpu_torch.ops.soft_vox import clip01, make_soft_plan, soft_voxelize
from voxtpu_torch.ops.soft_vox_cuda import SoftCudaPlan, soft_voxelize_cuda
from voxtpu_torch.ops.soft_vox_fused import FusedSoftPlan, soft_voxelize_fused

N = 32


def _jitter(coords, scale, seed=0):
    rng = np.random.default_rng(seed)
    return (coords + rng.normal(0, scale, coords.shape)).astype(np.float32)


def _meshes(coords, faces):
    return (Mesh(name="m", coords=coords, faces=faces, faces_normals=faces),
            JMesh(name="m", coords=coords, faces=faces, faces_normals=faces))


def _tet():
    coords = np.array([[0.1, 0.1, 0.1], [0.9, 0.15, 0.2], [0.2, 0.85, 0.15],
                       [0.3, 0.3, 0.9]], np.float32)
    faces = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], np.int32)
    return coords, faces


MESHES = {
    # 1e-3 jitter keeps every face clear of the x-degenerate knife edge
    # (`test_soft_vox_fused.py:36-43`).
    "torus": lambda: (lambda c, f: (_jitter(c, 1e-3), f))(
        *procedural.torus(1.0, 0.35, 24, 12)),
    "icosphere": lambda: (lambda c, f: (_jitter(c, 1e-4, 1), f))(
        *procedural.icosphere(2, center=(0.1, -0.2, 0.3))),
    "tet": _tet,
}

ENGINES = {
    "plain": (lambda sp: sp, soft_voxelize,
              lambda sp: sp, j_soft.soft_voxelize),
    "fused": (lambda sp: FusedSoftPlan(sp, "cpu"), soft_voxelize_fused,
              j_fused.FusedSoftPlan,
              lambda c, p, **kw: j_fused.soft_voxelize_fused(
                  c, p, mode="highest", **kw)),
    "cuda": (lambda sp: SoftCudaPlan(sp, "cpu"), soft_voxelize_cuda,
             j_pallas.SoftPallasPlan, j_pallas.soft_voxelize_pallas),
}


@pytest.fixture(scope="module")
def torus():
    coords, faces = MESHES["torus"]()
    mesh, jmesh = _meshes(coords, faces)
    spec = GridSpec.fit(coords, N)
    jspec = JSpec(n=spec.n, origin=spec.origin, voxel_size=spec.voxel_size)
    probe = np.random.default_rng(1).standard_normal((N, N, N)).astype(np.float32)
    sp = make_soft_plan(mesh, spec)
    return dict(coords=coords, faces=faces, mesh=mesh, spec=spec, sp=sp,
                jsp=j_soft.make_soft_plan(jmesh, jspec), probe=probe,
                f64=_occupancy_f64(coords, sp), voxtpu={})


def _occupancy_f64(coords, sp):
    """The plain engine's formula evaluated in float64 (unclipped)."""
    spec = sp.spec
    cells, w, x = soft_vox.soft_fragments(torch.from_numpy(coords).double(), sp,
                                          tau_edge_frac=0.25, tau_x_frac=0.5)
    vs, _, tau_x = soft_vox.temperatures(spec, 0.25, 0.5)
    cx = soft_vox.x_centers(N, soft_vox.f32(spec.origin[0]), vs, "cpu").double()
    out = torch.zeros((N * N + 1, N), dtype=torch.float64)
    soft_vox.profile_add(out, cells, w, x, cx, tau_x)
    return out[: N * N].view(N, N, N).numpy()


def _voxtpu(torus, engine):
    """voxtpu's unclipped occupancy and the coordinate gradient of the
    probe-weighted clipped occupancy, once per engine."""
    if engine not in torus["voxtpu"]:
        _, _, jplan, jfwd = ENGINES[engine]
        plan = jplan(torus["jsp"])
        c = jnp.asarray(torus["coords"])
        occ = np.asarray(jfwd(c, plan, clip=False))
        probe = jnp.asarray(torus["probe"])
        grad = np.asarray(jax.grad(lambda x: jnp.sum(jfwd(x, plan) * probe))(c))
        torus["voxtpu"][engine] = (plan, occ, grad)
    return torus["voxtpu"][engine]


def _port_grad(fwd, plan, coords, probe, **kw):
    x = torch.from_numpy(coords).requires_grad_(True)
    (fwd(x, plan, **kw) * torch.from_numpy(probe)).sum().backward()
    return x.grad.numpy()


# ---------------------------------------------------------------------------
# Plans: integer arrays equal voxtpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n,pad", [("torus", 32, 1), ("torus", 48, 2),
                                        ("icosphere", 32, 1), ("tet", 16, 4)])
def test_soft_plan_buckets_match_voxtpu(name, n, pad):
    coords, faces = MESHES[name]()
    mesh, jmesh = _meshes(coords, faces)
    spec = GridSpec.fit(coords, n)
    jspec = JSpec(n=spec.n, origin=spec.origin, voxel_size=spec.voxel_size)
    sp = make_soft_plan(mesh, spec, pad_window=pad)
    jsp = j_soft.make_soft_plan(jmesh, jspec, pad_window=pad)
    assert sp.num_fragments == jsp.num_fragments
    assert len(sp.buckets) == len(jsp.buckets)
    for got, want in zip(sp.buckets, jsp.buckets):
        assert got[0] == want[0]
        for k in (4, 5, 6):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(sp.plan_coords, jsp.plan_coords)
    moved = coords + np.float32(0.01)
    ref = j_soft.refresh_soft_plan(jsp, moved)
    got = soft_vox.refresh_soft_plan(sp, torch.from_numpy(moved))
    assert got.pad_window == pad and got.num_fragments == ref.num_fragments
    for g, w in zip(got.buckets, ref.buckets):
        np.testing.assert_array_equal(g[6], np.asarray(w[6]))


@pytest.mark.parametrize("layout", [dict(), dict(tb_sub=2, tbl=64)])
def test_fused_plan_arrays_match_voxtpu(torus, layout):
    port = FusedSoftPlan(torus["sp"], "cpu", **layout)
    ref = j_fused.FusedSoftPlan(torus["jsp"], **layout)
    for attr in ("num_batches", "num_pairs", "num_fragments", "num_faces",
                 "num_vertices", "tc", "tb_sub", "tbl"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for attr in ("cells_b", "tblidx_b", "batch_tile", "table_face_flat",
                 "tile_mask"):
        np.testing.assert_array_equal(getattr(port, attr), getattr(ref, attr))
    for (cls, inv), (jcls, jinv) in (
            ((port.expand_cls, port.expand_inv), (ref.expand_cls_d, ref.expand_inv_d)),
            ((port.vert_cls, port.vert_inv), (ref.vert_cls_d, ref.vert_inv_d))):
        assert len(cls) == len(jcls)
        for got, want in zip(cls, jcls):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(inv, np.asarray(jinv))
    # The forward kernels take one run of batches per tile.
    runs = port.run_start_d.numpy()
    assert len(np.unique(port.batch_tile)) == len(runs) - 1


def test_cuda_plan_arrays_match_voxtpu(torus):
    port = SoftCudaPlan(torus["sp"], "cpu")
    ref = j_pallas.SoftPallasPlan(torus["jsp"])
    assert port.num_batches == ref.num_batches
    assert port.num_fragments == ref.num_fragments
    assert port.num_fragments_total == ref.num_fragments_total
    np.testing.assert_array_equal(port.cells_b, ref.cells_b)
    np.testing.assert_array_equal(port.batch_tile, ref.batch_tile)
    # voxtpu's forward permutation (a sort by static slot rank) and the
    # port's gather index name the same source for every slot.
    total = ref.num_fragments_total
    perm = np.asarray(ref.perm_fwd)[:port.slot_src.size].astype(np.int64)
    np.testing.assert_array_equal(port.slot_src, np.where(perm < total, perm, total))


# ---------------------------------------------------------------------------
# Forward and gradients against voxtpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", list(ENGINES))
def test_forward_matches_voxtpu(torus, engine):
    make, fwd, _, _ = ENGINES[engine]
    _, want, _ = _voxtpu(torus, engine)
    got = fwd(torch.from_numpy(torus["coords"]), make(torus["sp"]), clip=False)
    assert got.shape == (N, N, N) and want.max() > 0.9
    np.testing.assert_allclose(got.numpy(), torus["f64"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("engine", ["fused", "cuda"])
def test_port_on_voxtpu_layout_matches_own_plan(torus, engine):
    """The port's per-call path on voxtpu's slot layout (carried across
    with interop) gives the port's own result bit for bit: the layouts
    are equal."""
    jplan, _, _ = _voxtpu(torus, engine)
    sp = torus["sp"]
    if engine == "fused":
        plan = interop.fused_plan_from_voxtpu(
            sp, jplan.cells_b, jplan.tblidx_b, jplan.batch_tile,
            jplan.table_face_flat, device="cpu")
        fwd, own = soft_voxelize_fused, FusedSoftPlan(sp, "cpu")
    else:
        plan = interop.soft_cuda_plan_from_voxtpu(
            sp, jplan.cells_b, jplan.batch_tile, np.asarray(jplan.perm_fwd),
            device="cpu")
        fwd, own = soft_voxelize_cuda, SoftCudaPlan(sp, "cpu")
    c = torch.from_numpy(torus["coords"])
    assert torch.equal(fwd(c, plan), fwd(c, own))
    g_layout = _port_grad(fwd, plan, torus["coords"], torus["probe"])
    g_own = _port_grad(fwd, own, torus["coords"], torus["probe"])
    np.testing.assert_array_equal(g_layout, g_own)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_gradients_match_voxtpu(torus, engine):
    make, fwd, _, _ = ENGINES[engine]
    _, _, want = _voxtpu(torus, engine)
    got = _port_grad(fwd, make(torus["sp"]), torus["coords"], torus["probe"])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_fused_gradcheck_finite_differences():
    """The fused engine's hand-derived coefficient cotangents (B8's
    plain version and the classed reductions) against central
    differences, on voxtpu's generic-position tet
    (`test_soft_vox_fused.py:68-101`)."""
    coords0, faces = _tet()
    mesh, _ = _meshes(coords0, faces)
    spec = GridSpec(n=16, origin=(0.0, 0.0, 0.0), voxel_size=1.0 / 16)
    fp = FusedSoftPlan(make_soft_plan(mesh, spec, pad_window=4), "cpu")
    probe = torch.from_numpy(
        np.random.default_rng(3).random((16, 16, 16)).astype(np.float32))

    def loss(c):
        return (soft_voxelize_fused(c, fp, tau_edge_frac=1.0, tau_x_frac=1.0,
                                    clip=False) * probe).sum()

    x = torch.from_numpy(coords0).requires_grad_(True)
    loss(x).backward()
    g = x.grad.numpy()
    eps = 1e-3
    for v, ax in [(0, 0), (1, 1), (2, 2), (3, 0), (1, 2)]:
        cp = coords0.copy()
        cp[v, ax] += eps
        cm = coords0.copy()
        cm[v, ax] -= eps
        with torch.no_grad():
            fd = (float(loss(torch.from_numpy(cp)))
                  - float(loss(torch.from_numpy(cm)))) / (2 * eps)
        assert abs(fd - g[v, ax]) <= 2e-2 * max(1.0, abs(fd)), (v, ax, fd, g[v, ax])


@pytest.mark.parametrize("engine", list(ENGINES))
def test_unreferenced_vertices_get_zero_gradient(engine):
    """Gradient rows match coordinate rows when trailing vertices are
    referenced by no face (`test_soft_vox_fused.py:142-161`)."""
    c, f = procedural.icosphere(2)
    coords = np.concatenate([_jitter(c, 1e-4), np.full((3, 3), 7.5, np.float32)])
    mesh, _ = _meshes(coords, f)
    spec = GridSpec.fit(c, 16)
    make, fwd, _, _ = ENGINES[engine]
    x = torch.from_numpy(coords).requires_grad_(True)
    (fwd(x, make(make_soft_plan(mesh, spec))) ** 2).sum().backward()
    g = x.grad.numpy()
    assert g.shape == coords.shape
    np.testing.assert_array_equal(g[-3:], 0.0)
    assert np.abs(g[:-3]).sum() > 0


def test_clip_tie_gradient_is_one_half():
    """jnp.clip's gradient at exactly 0 and 1 is 0.5 (torch.clamp gives
    1.0); empty and saturated cells sit there."""
    x = torch.tensor([0.0, 1.0, 0.5, -1.0, 2.0], requires_grad=True)
    clip01(x).sum().backward()
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(
        jnp.asarray([0.0, 1.0, 0.5, -1.0, 2.0])))
    np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.5, 0.5, 1.0, 0.0, 0.0])


@pytest.mark.parametrize("op", ["union", "intersection", "difference", "void"])
def test_soft_csg_matches_voxtpu(op):
    rng = np.random.default_rng(4)
    a = rng.random((6, 6, 6)).astype(np.float32)
    b = rng.random((6, 6, 6)).astype(np.float32)
    b[0] = a[0]  # ties split the gradient 0.5 / 0.5
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = csg.soft_csg(ta, tb, op)
    want = j_csg.soft_csg(jnp.asarray(a), jnp.asarray(b), op)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    if op == "void":
        return
    out.sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(j_csg.soft_csg(x, y, op)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ga))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(gb))


# ---------------------------------------------------------------------------
# The kernels' plain versions: backward against autograd of the forward
# ---------------------------------------------------------------------------


def test_fused_bwd_plain_is_the_gradient_of_fused_fwd_plain(torus):
    """B8's plain version equals torch autograd through B7's plain
    version (which differentiates the sigmoids itself), on random table
    cotangent probes; B7's plain version equals the fragment path."""
    fp = FusedSoftPlan(torus["sp"], "cpu")
    prm = fp.prm(0.5, 0.5)
    tables = soft_vox_fused.tables_of(torch.from_numpy(torus["coords"]), fp).detach()
    g = torch.from_numpy(torus["probe"])
    kw = dict(n=N, tc=fp.tc, prm=prm)
    t = tables.clone().requires_grad_(True)
    occ = soft_vox_fused.fused_fwd_plain(t, fp.cells_d, fp.tblidx_d,
                                         fp.batch_tile_d, **kw)
    (occ * g).sum().backward()
    got = soft_vox_fused.fused_bwd_plain(tables, fp.cells_d, fp.tblidx_d,
                                         fp.batch_tile_d, g, **kw)
    want = t.grad
    np.testing.assert_allclose(got[..., :13].numpy(), want[..., :13].numpy(),
                               rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert not got[..., 13:].any()

    cp = SoftCudaPlan(torus["sp"], "cpu")
    _, w, x = soft_vox.soft_fragments(torch.from_numpy(torus["coords"]), cp.soft_plan,
                                      tau_edge_frac=0.5, tau_x_frac=0.5)
    wb, xb = soft_vox_cuda._Permute.apply(w, x, cp)
    frag = soft_vox_cuda.fragment_fwd_plain(wb, xb, cp.cells_d, cp.batch_tile_d,
                                            n=N, tc=cp.tc, prm=(prm[0], prm[3], prm[5]))
    np.testing.assert_allclose(occ.detach().numpy(), frag.numpy(), rtol=0, atol=1e-5)


def test_fragment_bwd_plain_is_the_gradient_of_fragment_fwd_plain(torus):
    cp = SoftCudaPlan(torus["sp"], "cpu")
    rng = np.random.default_rng(5)
    wb = torch.from_numpy(rng.standard_normal(cp.cells_b.shape).astype(np.float32))
    xb = torch.from_numpy(rng.uniform(-1.5, 1.5, cp.cells_b.shape).astype(np.float32))
    g = torch.from_numpy(torus["probe"])
    prm = (soft_vox.f32(torus["spec"].origin[0]),) + soft_vox.temperatures(
        torus["spec"], 0.25, 0.5)[::2]
    kw = dict(n=N, tc=cp.tc, prm=prm)
    tw, tx = wb.clone().requires_grad_(True), xb.clone().requires_grad_(True)
    occ = soft_vox_cuda.fragment_fwd_plain(tw, tx, cp.cells_d, cp.batch_tile_d, **kw)
    (occ * g).sum().backward()
    dw, dx = soft_vox_cuda.fragment_bwd_plain(wb, xb, cp.cells_d, cp.batch_tile_d,
                                              g, **kw)
    for got, want in ((dw, tw.grad), (dx, tx.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    pad = cp.cells_b < 0
    assert not dw.numpy()[pad].any() and not dx.numpy()[pad].any()


def test_wrappers_validate_arguments(torus):
    fp = FusedSoftPlan(torus["sp"], "cpu")
    prm = fp.prm(0.5, 0.5)
    tables = torch.zeros((fp.num_batches, fp.tbl, 16))
    kw = dict(n=N, tc=fp.tc, prm=prm)
    with pytest.raises(TypeError, match="tables"):
        soft_vox_fused.fused_fwd(tables.double(), fp.cells_d, fp.tblidx_d,
                                 fp.batch_tile_d, fp.run_start_d, **kw)
    with pytest.raises(ValueError, match="tblidx_b"):
        soft_vox_fused.fused_fwd(tables, fp.cells_d, fp.tblidx_d[:1],
                                 fp.batch_tile_d, fp.run_start_d, **kw)
    with pytest.raises(ValueError, match="g: expected shape"):
        soft_vox_fused.fused_bwd(tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d,
                                 torch.zeros((N, N)), **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        soft_vox_fused.fused_fwd(tables.to("meta"), fp.cells_d.to("meta"),
                                 fp.tblidx_d.to("meta"), fp.batch_tile_d.to("meta"),
                                 fp.run_start_d.to("meta"), **kw)
    with pytest.raises(ValueError, match="not grouped by tile"):
        soft_vox_fused.tile_runs(np.array([0, 2, 1], np.int32))
