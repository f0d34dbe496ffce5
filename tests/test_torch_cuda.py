"""voxtpu_torch's CUDA kernels against their plain torch versions, on a
CUDA card. Marked `cuda`; every test skips on a machine without one.

Imports no jax, so it also runs where the port runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.models.fit import VoxelFit, soft_iou_loss
from voxtpu_torch.ops import (jfa_cuda, soft_vox, soft_vox_cuda, soft_vox_fused,
                              vox_cuda, vox_slots_banded)
from voxtpu_torch.ops.jfa import jfa, jfa_init_seed
from voxtpu_torch.ops.reference import jfa_ref, voxelize_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _mesh(make, name):
    coords, faces = make()
    return Mesh(name=name, coords=coords, faces=faces, faces_normals=faces)


@pytest.mark.parametrize("name,n,band", [("icosphere", 64, 32),
                                         ("torus", 128, 64),
                                         ("icosahedron", 192, 64)])
def test_banded_pipeline_kernels_match_plain_and_oracle(dev, name, n, band):
    make = {"icosphere": lambda: procedural.icosphere(3, center=(0.1, -0.2, 0.3)),
            "torus": lambda: procedural.torus(1.0, 0.35, 48, 24),
            "icosahedron": procedural.icosahedron}[name]
    mesh = _mesh(make, name)
    spec = GridSpec.fit(mesh.coords, n)
    pipe = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, dev, band=band)
    b1 = vox_slots_banded.banded_fill.launches
    words, overflow = pipe.words()
    assert int(overflow) == 0
    assert vox_slots_banded.banded_fill.launches == b1 + 1
    st = pipe.state
    (lk, xs), wide, _ = vox_slots_banded.emit_slots(
        st, spec.origin_tensor(dev), spec.voxel_size_tensor(dev), n=n,
        tc=pipe.tc, band=pipe.band)
    plain = vox_slots_banded.banded_fill_plain(lk, xs, st.batch_tile, st.batch_basew,
                                               n=n, tc=pipe.tc, band=pipe.band)
    if wide is None:
        assert torch.equal(words, plain)
    else:
        w_words = vox_cuda.wide_fill(*wide, st.wide[3], n=n, tc=pipe.tc,
                                     num_tiles=st.wide[4].shape[0])
        assert torch.equal(w_words, vox_cuda.wide_fill_plain(
            *wide, st.wide[3], n=n, tc=pipe.tc, num_tiles=st.wide[4].shape[0]))
        plain.view(-1, pipe.tc, n // 32)[st.wide[4]] ^= w_words
        assert torch.equal(words, plain)
    oracle = pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))
    assert torch.equal(words.cpu(), oracle)


@pytest.mark.parametrize("n,tc,tiles", [(64, 128, 3), (512, 128, 4), (4096, 128, 2)])
def test_wide_fill_kernel_matches_plain(dev, n, tc, tiles):
    g = torch.Generator().manual_seed(n)
    local = torch.randint(-1, tc, (3 * tiles, 4, 128), generator=g, dtype=torch.int32)
    xs = torch.randint(0, n, local.shape, generator=g, dtype=torch.int32)
    tile = torch.arange(tiles, dtype=torch.int32).repeat_interleave(3)
    before = vox_cuda.wide_fill.launches
    got = vox_cuda.wide_fill(local.to(dev), xs.to(dev), tile.to(dev), n=n, tc=tc,
                             num_tiles=tiles)
    assert vox_cuda.wide_fill.launches == before + 1
    want = vox_cuda.wide_fill_plain(local, xs, tile, n=n, tc=tc, num_tiles=tiles)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [32, 96])
def test_flood_kernels_match_plain_and_oracle(dev, n):
    occ = np.random.default_rng(n).random((n, n, n)) < 0.02
    spec = GridSpec(n=n, origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
    occ_d = torch.from_numpy(occ).to(dev)
    org = jfa_cuda.org_tensor(spec, dev)
    seed = jfa_init_seed(occ_d)
    k = n // 2
    while k >= 1:
        got = jfa_cuda.flood_step(seed, org, k)
        assert torch.equal(got, jfa_cuda.flood_step_plain(seed, org, k)), k
        seed = got
        k //= 2
    got = jfa_cuda.sdf_from_seed(seed, occ_d, org)
    want = jfa_cuda.sdf_from_seed_plain(seed, occ_d, org)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = torch.from_numpy(jfa_ref(occ, spec))
    assert torch.equal(jfa(occ_d, spec).cpu().view(torch.int32), ref.view(torch.int32))


def test_kernels_reject_bad_arguments(dev):
    seed = torch.zeros((8, 8, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="different devices"):
        jfa_cuda.flood_step(seed, torch.zeros(4), 1)
    # One live slot per batch, (cell 0, x 0). A batch whose tile or band
    # lies outside the output is skipped by the kernel, never written out
    # of bounds.
    local = torch.full((2, 4, 128), -1, dtype=torch.int32, device=dev)
    local[:, 0, 0] = 0
    xs = torch.zeros_like(local)
    tile = torch.tensor([5, 1], dtype=torch.int32, device=dev)
    got = vox_cuda.wide_fill(local, xs, tile, n=64, tc=128, num_tiles=2)
    want = vox_cuda.wide_fill_plain(local[1:], xs[1:], tile[1:], n=64, tc=128,
                                    num_tiles=2)
    assert torch.equal(got, want) and bool((want != 0).any())
    basew = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    tile = torch.tensor([0, 0], dtype=torch.int32, device=dev)
    got = vox_slots_banded.banded_fill(local, xs, tile, basew, n=64, tc=128,
                                       band=64)
    want = vox_slots_banded.banded_fill_plain(local[:1], xs[:1], tile[:1],
                                              basew[:1], n=64, tc=128, band=64)
    assert torch.equal(got, want) and bool((want != 0).any())


def _soft_case(n):
    """A jittered icosphere, its soft plan (pad 2) at n and a seeded
    random cotangent."""
    c, f = procedural.icosphere(3, center=(0.1, -0.2, 0.3))
    rng = np.random.default_rng(n)
    c = (c + rng.normal(0, 1e-3, c.shape)).astype(np.float32)
    mesh = Mesh(name="s", coords=c, faces=f, faces_normals=f)
    spec = GridSpec.fit(c, n)
    g = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
    return c, soft_vox.make_soft_plan(mesh, spec, pad_window=2), g


def _max_err(a, b):
    return float((a.cpu() - b.cpu()).abs().max())


# Tolerances: occupancy 1e-4 absolute; cotangents 1e-3 x max|plain| (the
# backward kernels sum in slot order, the plain versions with index_add_).
@pytest.mark.parametrize("n", [32, 128, 160])
def test_fused_kernels_match_plain(dev, n):
    c, sp, g = _soft_case(n)
    fp = soft_vox_fused.FusedSoftPlan(sp, dev)
    prm = fp.prm(0.5, 0.5)
    tables = soft_vox_fused.tables_of(torch.from_numpy(c).to(dev), fp).detach()
    args = (tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d)
    kw = dict(n=n, tc=fp.tc, prm=prm)
    b7, b8 = soft_vox_fused.fused_fwd.launches, soft_vox_fused.fused_bwd.launches
    got = soft_vox_fused.fused_fwd(*args, fp.run_start_d, **kw)
    want = soft_vox_fused.fused_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert soft_vox_fused.fused_fwd.launches == b7 + 1
    assert _max_err(got, want) <= 1e-4 and float(want.max()) > 0.5
    g = g.to(dev)
    got = soft_vox_fused.fused_bwd(*args, g, **kw)
    want = soft_vox_fused.fused_bwd_plain(*args, g, **kw)
    torch.cuda.synchronize()
    assert soft_vox_fused.fused_bwd.launches == b8 + 1
    assert _max_err(got, want) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("n", [32, 160])
def test_fragment_kernels_match_plain(dev, n):
    c, sp, g = _soft_case(n)
    cp = soft_vox_cuda.SoftCudaPlan(sp, dev)
    vs, _, tau_x = soft_vox.temperatures(sp.spec, 0.5, 0.5)
    prm = (soft_vox.f32(sp.spec.origin[0]), vs, tau_x)
    _, w, x = soft_vox.soft_fragments(torch.from_numpy(c).to(dev), sp,
                                      tau_edge_frac=0.5, tau_x_frac=0.5)
    wb, xb = soft_vox_cuda._Permute.apply(w, x, cp)
    args = (wb, xb, cp.cells_d, cp.batch_tile_d)
    kw = dict(n=n, tc=cp.tc, prm=prm)
    got = soft_vox_cuda.fragment_fwd(*args, cp.run_start_d, **kw)
    want = soft_vox_cuda.fragment_fwd_plain(*args, **kw)
    assert _max_err(got, want) <= 1e-4 and float(want.max()) > 0.5
    g = g.to(dev)
    for got, want in zip(soft_vox_cuda.fragment_bwd(*args, g, **kw),
                         soft_vox_cuda.fragment_bwd_plain(*args, g, **kw)):
        assert _max_err(got, want) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("engine", ["fused", "cuda"])
def test_engine_gradients_on_the_card_match_the_cpu(dev, engine):
    """The coordinate gradient of soft_iou_loss through an engine's
    kernels equals the same engine's plain versions on the CPU."""
    c, sp, _ = _soft_case(64)
    target = torch.from_numpy(voxelize_ref(
        Mesh(coords=c, faces=sp.faces_array, faces_normals=sp.faces_array),
        sp.spec).astype(np.float32))
    grads = []
    for device in (dev, torch.device("cpu")):
        fit = VoxelFit(sp, target.to(device), engine=engine, refresh_every=0)
        x = torch.from_numpy(c).to(device).requires_grad_(True)
        fit._loss_fn(fit._fwd(x), fit.target).backward()
        grads.append(x.grad.cpu())
    assert _max_err(*grads) <= 1e-3 * float(grads[1].abs().max())
    assert soft_iou_loss(target, target) < 1e-6


def test_forward_sums_do_not_depend_on_order(dev):
    """B13 fwd (whose accumulate B7 shares) adds a cell's terms as 64-bit
    fixed-point integers. 8192 slots in two cells whose weights cancel in
    pairs, with partial sums near 1500 on the way, come to exactly 0,
    where a float32 running sum would be ~1e-3 off; a NaN weight makes
    its cell's row NaN, as in the plain version, and leaves the rest."""
    n, tc, nb = 32, 128, 16
    u = np.random.default_rng(3).uniform(0.5, 1.0, nb * 256).astype(np.float32)
    wb = torch.from_numpy(np.concatenate([u, -u])).view(nb, 4, 128).to(dev)
    xb = torch.full_like(wb, 1e3)  # beyond the grid: every sigmoid is 1
    cells = torch.zeros(wb.shape, dtype=torch.int32, device=dev)
    cells[:, :, 1::2] = 5
    tile = torch.zeros(nb, dtype=torch.int32, device=dev)
    run_start = torch.tensor([0, nb], dtype=torch.int32, device=dev)
    kw = dict(n=n, tc=tc, prm=(0.0, 1.0 / n, 0.5 / n))
    got = soft_vox_cuda.fragment_fwd(wb, xb, cells, tile, run_start, **kw)
    want = soft_vox_cuda.fragment_fwd_plain(wb, xb, cells, tile, **kw)
    assert float(want.abs().max()) == 0.0 and float(got.abs().max()) == 0.0
    wb[3, 2, 7] = float("nan")  # an odd lane: cell 5, row (z, y) = (0, 5)
    got = soft_vox_cuda.fragment_fwd(wb, xb, cells, tile, run_start, **kw)
    want = soft_vox_cuda.fragment_fwd_plain(wb, xb, cells, tile, **kw)
    for occ in (got, want):
        assert bool(torch.isnan(occ[0, 5]).all())
        occ[0, 5] = 0.0
        assert bool(torch.isfinite(occ).all())
