"""voxtpu_torch's CUDA kernels against their plain torch versions, on a
CUDA card. Marked `cuda`; every test skips on a machine without one.

Imports no jax, so it also runs where the port runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.models.fit import VoxelFit, soft_iou_loss
from voxtpu_torch.ops import (jfa_cuda, jfa_probe, soft_vox, soft_vox_cuda,
                              soft_vox_fused, soft_vox_seg, vox_cuda, vox_slots_banded,
                              vox_word_event, vox_work_queue)
from voxtpu_torch.ops.jfa import jfa, jfa_init_seed
from voxtpu_torch.ops.reference import jfa_ref, voxelize_ref
from voxtpu_torch.ops.vox import voxelize

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
        plain.view(-1, pipe.tc, n // 32)[st.wide[4].long()] ^= w_words
        assert torch.equal(words, plain)  # the pipeline's B2 ran in place
    oracle = pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))
    assert torch.equal(words.cpu(), oracle)


def _plan_mesh(name):
    """The card plan test's meshes: an icosphere, the torus of the fit
    cells (1,348,128 faces, turned off every axis) and the washer of the
    benchmark's serving cells (1,348,128 faces; its caps route wide)."""
    if name == "icosphere":
        return _mesh(lambda: procedural.icosphere(4, center=(0.1, -0.2, 0.3)), name)
    if name == "torus":
        c, f = procedural.subdivide_to(*procedural.torus(1.0, 0.35, 48, 24), 1_348_128)
        ax, ay, az = 0.3, 0.5, 0.7
        rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
        ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
        rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
        c = (c.astype(np.float64) @ (rz @ ry @ rx).T).astype(np.float32)
        return _mesh(lambda: (c, f), name)
    return _mesh(lambda: procedural.subdivide_to(
        *procedural.washer(0.85, 1.0, 0.16, nu=64), 1_348_128), name)


def _plan_arrays(pipe) -> dict:
    st = pipe.state
    out = {f"rows{i}": r for i, r in enumerate(st.rows)}
    out.update(local=st.local, batch_tile=st.batch_tile, batch_basew=st.batch_basew)
    layouts = [("layout", st.layout)]
    if st.wide is not None:
        out.update({f"wide_rows{i}": r for i, r in enumerate(st.wide[0])})
        out.update({f"wide{i}": a for i, a in enumerate(st.wide[1:])})
        layouts.append(("wide_layout", st.wide_layout))
    for key, lay in layouts:
        out.update({f"{key}.start": lay.start, f"{key}.order": lay.order,
                    f"{key}.sizes": torch.tensor([lay.nbusy, lay.cluster])})
    out["counters"] = torch.tensor([pipe.num_candidates, pipe.num_slots, pipe.num_batches,
                                    pipe.num_wide])
    return {k: v.cpu() for k, v in out.items()}


@pytest.mark.parametrize("name,n,band", [("icosphere", 128, 64), ("torus", 512, 256),
                                         ("washer", 512, 256)])
def test_plan_on_the_card_equals_the_plan_on_the_cpu(dev, name, n, band):
    """The serving plan built on the card (torch ops and the band cut's
    kernel) equals the plan built on the CPU (the same ops and the cut's
    plain version), array for array and bit for bit; three host reads,
    the spans' CUDA events recorded, and the card's grid the CPU plan's
    grid on the card."""
    from torch.profiler import ProfilerActivity, profile

    from voxtpu_torch.utils import trace as tr

    mesh = _plan_mesh(name)
    spec = GridSpec.fit(mesh.coords, n)
    cut = (vox_slots_banded.band_cut_counts.launches, vox_slots_banded.band_cut.launches)
    tr.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        card = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, dev, band=band)
    records = [r for r in tr.recorded() if r.name.startswith("vox.plan.")]
    tr.clear()
    assert (vox_slots_banded.band_cut_counts.launches,
            vox_slots_banded.band_cut.launches) == (cut[0] + 1, cut[1] + 1)
    assert len(records) == 4 and all(r.device_ms is not None for r in records)
    assert sum(r.counts.get("syncs", 0) for r in records) == 3
    host = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, "cpu", band=band)
    got, want = _plan_arrays(card), _plan_arrays(host)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    assert (card.num_wide > 0) == (name != "torus")
    words, overflow = card.words()
    host.state = vox_slots_banded.BandedState(
        rows=tuple(r.to(dev) for r in host.state.rows), local=host.state.local.to(dev),
        batch_tile=host.state.batch_tile.to(dev), batch_basew=host.state.batch_basew.to(dev),
        wide=None if host.state.wide is None else (
            tuple(r.to(dev) for r in host.state.wide[0]),
            *(a.to(dev) for a in host.state.wide[1:])))
    host_words, host_overflow = vox_slots_banded.banded_total(
        host.state, spec.origin_tensor(dev), spec.voxel_size_tensor(dev), n=n, tc=host.tc,
        band=host.band)
    assert int(overflow) == 0 == int(host_overflow) and torch.equal(words, host_words)


def _fused_plan_arrays(plan) -> dict:
    keys = ("cells_d", "tblidx_d", "batch_tile_d", "run_start_d", "fidx_d", "faces_d",
            "expand_inv_d", "vert_inv_d")
    keys += ("batch_panel_d",) if hasattr(plan, "batch_panel_d") else ("tile_mask_d",)
    out = {k: getattr(plan, k) for k in keys}
    for key in ("expand_cls_d", "vert_cls_d"):
        out.update({f"{key}{i}": c for i, c in enumerate(getattr(plan, key))})
    out["counters"] = torch.tensor([plan.num_batches, plan.num_pairs, plan.num_fragments,
                                    plan.num_faces, plan.num_vertices])
    return {k: v.cpu() for k, v in out.items()}


def _check_fused_plan(fit):
    card = fit.engine_plan
    if fit.engine == "seg":
        host = soft_vox_seg.SegSoftPlan(card.soft_plan, fit._plan_coords.cpu(), "cpu")
    else:
        host = soft_vox_fused.FusedSoftPlan(card.soft_plan, "cpu")
    got, want = _fused_plan_arrays(card), _fused_plan_arrays(host)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("engine", ["fused", "seg"])
def test_fused_plan_on_the_card_equals_the_plan_on_the_cpu(dev, engine):
    """The fused (and the seg) engine's plan at 512^3 on the fit cells'
    torus, built on the card (torch ops and C2) at a fit's start and
    again at its drift refresh after 8 steps of the fit cells' traffic
    (lr 0.25 voxel), equals the plan built on the CPU (the same ops and
    C2's plain version), tensor for tensor and bit for bit: both passes
    of C2 once a plan, four host reads a plan, the spans' CUDA events
    recorded."""
    from torch.profiler import ProfilerActivity, profile

    from voxtpu_torch.utils import trace as tr

    mesh = _plan_mesh("torus")
    spec = GridSpec.fit(mesh.coords, 512)
    vs = spec.voxel_size
    rng = np.random.default_rng(2000000011)
    start = (mesh.coords + np.float32([0.5 * vs, 0.0, 0.0])
             + rng.normal(0, 0.1 * vs, mesh.coords.shape)).astype(np.float32)
    target = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, dev)().to_dense().float()
    plan = soft_vox.make_soft_plan(Mesh(name="start", coords=start, faces=mesh.faces,
                                        faces_normals=mesh.faces), spec)
    cut = (soft_vox_fused.pair_cut_counts.launches, soft_vox_fused.pair_cut.launches)
    tr.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fit = VoxelFit(plan, target, learning_rate=0.25 * vs, tau_edge_frac=0.5,
                       tau_x_frac=0.5, refresh_every=8, drift_limit_frac=0.5,
                       engine=engine)
    records = [r for r in tr.recorded() if r.name.startswith("soft.engine_plan.")]
    tr.clear()
    assert (soft_vox_fused.pair_cut_counts.launches,
            soft_vox_fused.pair_cut.launches) == (cut[0] + 1, cut[1] + 1)
    assert len(records) == 3 and all(r.device_ms is not None for r in records)
    assert sum(r.counts.get("syncs", 0) for r in records) == 4
    _check_fused_plan(fit)
    built = fit.engine_plan.num_fragments
    state = fit.init(start)
    for _ in range(8):
        state, _ = fit.step(state)
    assert fit.refresh_count == 1 and fit.engine_plan.num_fragments > built
    _check_fused_plan(fit)


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


def _poisoned_cache(shape, dev):
    """Leave a block of `shape` int32 filled with a pattern in the
    caching allocator, so that the next torch.empty of that shape shows
    any word a kernel does not write."""
    torch.full(shape, 0x5A5A5A5A, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,tc,band", [(128, 128, 64), (512, 128, 256), (96, 32, 64)])
def test_banded_fill_kernel_with_busy_and_empty_tiles(dev, n, tc, band):
    """B1 with 40 batches on one tile and 9 on another, every other tile
    empty: on the layout a wrapper builds without a plan and on the
    plan's (busy tiles first, zero writers) with clusters of 1, 5 and
    16."""
    g = torch.Generator().manual_seed(n + tc)
    num_tiles, nw = n * n // tc, n // 32
    tiles = torch.tensor([1] * 9 + [num_tiles // 2] * 40, dtype=torch.int32)
    local = torch.randint(-1, tc, (len(tiles), 4, 128), generator=g, dtype=torch.int32)
    basew = torch.randint(0, nw - band // 32 + 1, (len(tiles),), generator=g,
                          dtype=torch.int32)
    xs = basew.view(-1, 1, 1) * 32 + torch.randint(-8, band + 8, local.shape, generator=g,
                                                   dtype=torch.int32)
    want = vox_slots_banded.banded_fill_plain(local, xs, tiles, basew, n=n, tc=tc, band=band)
    args = [t.to(dev) for t in (local, xs, tiles, basew)]
    plan = vox_cuda.fill_layout(tiles.numpy(), num_tiles, dev, nw=nw, tc=tc)
    assert plan.nbusy == 2
    for layout in (None, *(dataclasses.replace(plan, cluster=c) for c in (1, 5, 16))):
        _poisoned_cache((n, n, nw), dev)
        before = vox_slots_banded.banded_fill.launches
        got = vox_slots_banded.banded_fill(*args, n=n, tc=tc, band=band, layout=layout)
        assert vox_slots_banded.banded_fill.launches == before + 1
        assert torch.equal(got.cpu(), want), layout
    assert bool((want != 0).any())


@pytest.mark.parametrize("n,tc,tiles", [(64, 128, 3), (512, 128, 3), (4096, 128, 2)])
def test_wide_fill_into_kernel_matches_plain_merge(dev, n, tc, tiles):
    """B2 in place: the plain fill XORed into the mapped tiles of a random
    grid, the others untouched; 300 batches on one tile."""
    g = torch.Generator().manual_seed(n)
    counts = [300] + [2] * (tiles - 1)
    tile = torch.arange(tiles, dtype=torch.int32).repeat_interleave(torch.tensor(counts))
    local = torch.randint(-1, tc, (len(tile), 4, 128), generator=g, dtype=torch.int32)
    xs = torch.randint(0, n, local.shape, generator=g, dtype=torch.int32)
    tile_map = torch.randperm(n * n // tc, generator=g)[:tiles].to(torch.int32)
    grid = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, n, n // 32), dtype=torch.int32,
                         device=dev)
    want = grid.clone()
    want.view(-1, tc, n // 32)[tile_map.long().to(dev)] ^= vox_cuda.wide_fill_plain(
        local, xs, tile, n=n, tc=tc, num_tiles=tiles).to(dev)
    plan = vox_cuda.fill_layout(tile.numpy(), tiles, dev, nw=n // 32, tc=tc)
    assert plan.cluster > 1  # the busy tile spreads over a cluster
    args = [t.to(dev) for t in (local, xs, tile, tile_map)]
    for layout in (plan, dataclasses.replace(plan, cluster=vox_cuda.CLUSTER_MAX)):
        before = vox_cuda.wide_fill.launches
        got = vox_cuda.wide_fill_into(grid, *args, n=n, tc=tc, layout=layout)
        assert got is grid and vox_cuda.wide_fill.launches == before + 1
        assert torch.equal(grid, want), layout.cluster
        want.view(-1, tc, n // 32)[tile_map.long().to(dev)] ^= vox_cuda.wide_fill_plain(
            local, xs, tile, n=n, tc=tc, num_tiles=tiles).to(dev)  # applied again next


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


# n = 128: every row starts on a 16-byte boundary; 130 and 67: rows
# that do not (n % 4 = 2, 3), whose ends B5 takes one by one.
@pytest.mark.parametrize("n,kind", [(128, "sparse"), (128, "ties"), (130, "dense"),
                                    (67, "sparse"), (67, "empty"), (67, "full")])
def test_sdf_kernel_matches_plain_and_fused_step(dev, n, kind):
    """B5 on a flood's seeds, float32 bits: its plain version and B6's
    fused k = 1 step on the same seeds (B5 after B3); "full": every voxel
    occupied and no seed, +inf everywhere. A seed grid off the 16-byte
    alignment is refused."""
    g = torch.Generator(device=dev).manual_seed(n)
    p = {"sparse": 0.01, "dense": 0.3, "ties": 0.03, "empty": 0.0, "full": 1.0}[kind]
    occ = torch.rand((n, n, n), generator=g, device=dev) < p
    spec = GridSpec(n=n, **(_DYADIC if kind == "ties" else _OTHER))
    org = jfa_cuda.org_tensor(spec, dev)
    seed = torch.full_like(occ, -1, dtype=torch.int32) if kind == "full" else jfa_init_seed(occ)
    k = n // 2
    while k >= 2:
        seed = jfa_cuda.flood_step(seed, org, k)
        k //= 2
    final = jfa_cuda.flood_step(seed, org, 1)
    before = jfa_cuda.sdf_from_seed.launches
    got = jfa_cuda.sdf_from_seed(final, occ, org)
    assert jfa_cuda.sdf_from_seed.launches == before + 1
    bits = got.view(torch.int32)
    assert torch.equal(bits, jfa_cuda.sdf_from_seed_plain(final, occ, org).view(torch.int32))
    assert torch.equal(bits, jfa_cuda.flood_step_pipe(seed, org, 1, occ).view(torch.int32))
    if kind in ("empty", "full"):
        assert torch.equal(got, torch.full_like(got, float("inf") if kind == "full"
                                                else -float("inf")))
    off = torch.empty(n ** 3 + 1, dtype=torch.int32, device=dev)[1:].view(n, n, n)
    off.copy_(final)
    with pytest.raises(RuntimeError, match="vt_sdf_from_seed"):
        jfa_cuda.sdf_from_seed(off, occ, org)


# The flood grids of the walk's tests: sparse (~1%) and dense (~30%)
# random occupancy, none, one voxel, and ~3% on a dyadic grid, where the
# distances are exact and many seeds lie exactly as far from a voxel as
# another (ties, which test the candidate order and the own seed's
# precedence). Made on the card from a seeded generator.
FLOOD_GRIDS = ["sparse", "dense", "empty", "single", "ties"]
_OTHER = dict(origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
_DYADIC = dict(origin=(0.5, -2.0, 1.25), voxel_size=0.0625)


def _flood_case(kind, n, dev):
    """(seed, org) of an n^3 flood of `kind` on `dev`."""
    if kind in ("empty", "single"):
        occ = torch.zeros((n, n, n), dtype=torch.bool, device=dev)
        if kind == "single":
            occ[n // 3, n // 2, n // 5] = True
    else:
        g = torch.Generator(device=dev).manual_seed(n)
        p = {"sparse": 0.01, "dense": 0.3, "ties": 0.03}[kind]
        occ = torch.rand((n, n, n), generator=g, device=dev) < p
    spec = GridSpec(n=n, **(_DYADIC if kind == "ties" else _OTHER))
    return jfa_init_seed(occ), jfa_cuda.org_tensor(spec, dev)


def _check_flood_end(seed, kind):
    """The flood found no seed only where there was none."""
    assert bool((seed < 0).all()) == (kind == "empty")


@pytest.mark.parametrize("kind", FLOOD_GRIDS)
@pytest.mark.parametrize("n", [96, 200, 224])
def test_flood_step_matches_plain_at_every_stride(dev, n, kind):
    """B3 (the lattice walk) against its plain version at every stride:
    n = 200 and 224 give strides that are not powers of two (100, 25, 12;
    112, 56, 28, 14, 7, 3) and rows a residue that are not either."""
    seed, org = _flood_case(kind, n, dev)
    k = n // 2
    while k >= 1:
        before = jfa_cuda.flood_step.launches
        got = jfa_cuda.flood_step(seed, org, k)
        assert jfa_cuda.flood_step.launches == before + 1
        assert torch.equal(got, jfa_cuda.flood_step_plain(seed, org, k)), k
        seed = got
        k //= 2
    _check_flood_end(seed, kind)


@pytest.mark.parametrize("kind", FLOOD_GRIDS)
@pytest.mark.parametrize("n,band", [(544, jfa_cuda.ROW_BAND), (1024, jfa_cuda.ROW_BAND),
                                    (544, 100)])
def test_flood_rows_matches_plain_and_b3_at_every_stride(dev, n, band, kind):
    """B4 against its band-wise plain version and B3 at every stride:
    n = 544 (bands of 256 and of 100 that do not divide it, strides 272,
    136, 68, 34, 17, 8, ...) and n = 1024, B4's own size."""
    seed, org = _flood_case(kind, n, dev)
    k = n // 2
    while k >= 1:
        before = jfa_cuda.flood_step_rows.launches
        got = jfa_cuda.flood_step_rows(seed, org, k, band)
        assert jfa_cuda.flood_step_rows.launches == before + 1
        assert torch.equal(got, jfa_cuda.flood_step(seed, org, k)), k
        assert torch.equal(got, jfa_cuda.flood_step_rows_plain(seed, org, k, band)), k
        seed = got
        k //= 2
    _check_flood_end(seed, kind)


def _we_args(plan):
    return (plan.cells, plan.ws, plan.his, plan.masks, plan.cnts, plan.batch_tile)


@pytest.mark.parametrize("n,tc,tb_sub", [(96, 128, 4), (128, 128, 4), (128, 64, 1),
                                         (256, 128, 4), (64, 64, 1)])
def test_word_event_kernel_matches_plain_and_oracle(dev, n, tc, tb_sub):
    """B12 on an icosphere's word-event plan (n = 96: G = 36, not a
    power of two), against its plain version and the oracle; and the
    whole per-call pipeline on the card."""
    mesh = _mesh(lambda: procedural.icosphere(4, center=(0.1, -0.2, 0.3)), "ico")
    spec = GridSpec.fit(mesh.coords, n)
    plan = vox_word_event.WordEventVoxPlan(mesh, spec, dev, tc=tc, tb_sub=tb_sub)
    before = vox_word_event.word_event_fill.launches
    got = vox_word_event.word_event_fill(*_we_args(plan), n=n, tc=tc)
    assert vox_word_event.word_event_fill.launches == before + 1
    want = vox_word_event.word_event_fill_plain(*_we_args(plan), n=n, tc=tc)
    assert torch.equal(got, want)
    oracle = pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))
    assert torch.equal(got.cpu(), oracle)
    pipe = vox_word_event.DeviceVoxPipeline(mesh, spec, dev, tc=tc, tb_sub=tb_sub)
    pipe.words()  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the per-call path never waits for the card
    try:
        words, overflow = pipe.words()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(overflow) == 0
    assert torch.equal(words.cpu(), oracle) and torch.equal(pipe().words, words)


def test_word_event_kernel_on_random_events(dev):
    """Random events, unique per (cell, word) as the plans make them,
    with sorted supertiles, several batches each and inert lanes; and
    a batch outside the supertiles, which the kernel skips."""
    n, tc = 512, 128
    nw, _, g, num_super, _ = vox_word_event._panel_geometry(n, tc)
    rng = np.random.default_rng(4)
    per, tb = 3, 512
    bt = np.repeat(rng.choice(num_super, 40, replace=False), per)
    bt.sort()
    cells = np.full((bt.size, tb), -1, np.int32)
    ws = np.zeros_like(cells)
    for s in np.unique(bt):
        rows = np.nonzero(bt == s)[0]
        pick = rng.choice(tc * g * nw, int(0.8 * per * tb), replace=False)
        flat = np.full(per * tb, -1, np.int64)
        flat[rng.choice(per * tb, pick.size, replace=False)] = pick
        live = flat >= 0
        cells[rows] = np.where(live, flat // (g * nw), -1).reshape(per, tb)
        ws[rows] = np.where(live, flat % (g * nw), 0).reshape(per, tb)
    his = (ws // nw + 1) * nw
    masks = rng.integers(-2**31, 2**31, cells.shape, dtype=np.int64).astype(np.int32)
    cnts = rng.integers(0, 2, cells.shape).astype(np.int32)
    bt = np.concatenate([bt, [num_super + 3]]).astype(np.int32)
    extra = (np.arange(tb) % tc, np.zeros(tb), np.full(tb, nw), np.full(tb, -1),
             np.ones(tb))  # live events on a supertile past the grid
    arrays = [np.concatenate([a, e[None].astype(np.int32)])
              for a, e in zip((cells, ws, his, masks, cnts), extra)]
    arrays = [torch.from_numpy(a.reshape(-1, 4, 128)) for a in arrays]
    args = (*arrays, torch.from_numpy(bt))
    got = vox_word_event.word_event_fill(*(a.to(dev) for a in args), n=n, tc=tc)
    want = vox_word_event.word_event_fill_plain(*args, n=n, tc=tc)
    assert torch.equal(got.cpu(), want) and bool((want != 0).any())


@pytest.mark.parametrize("n,band", [(128, 32), (544, jfa_cuda.ROW_BAND)])
def test_flood_rows_kernel_matches_plain_and_b3(dev, n, band):
    """B4 against its plain version and B3 at every stride (n = 544:
    a band that does not divide n, and the odd stride 17)."""
    occ = np.random.default_rng(n).random((n, n, n)) < 0.01
    spec = GridSpec(n=n, origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
    org = jfa_cuda.org_tensor(spec, dev)
    seed = jfa_init_seed(torch.from_numpy(occ).to(dev))
    k = n // 2
    while k >= 1:
        before = jfa_cuda.flood_step_rows.launches
        got = jfa_cuda.flood_step_rows(seed, org, k, band)
        assert jfa_cuda.flood_step_rows.launches == before + 1
        assert torch.equal(got, jfa_cuda.flood_step_rows_plain(seed, org, k, band)), k
        assert torch.equal(got, jfa_cuda.flood_step(seed, org, k)), k
        seed = got
        k //= 2


@pytest.mark.parametrize("n", [128, 224])
def test_flood_pipe_kernel_matches_plain_and_b3(dev, n):
    """B6 against its plain version and B3 at every stride that divides
    n, fed B3's seeds; the k = 1 step with the signed distance against
    B5 after B3; and `jfa(pipe=True)` against the B3 flood and, at 128,
    the oracle (n = 224 sends k = 3 to B3)."""
    occ = np.random.default_rng(n).random((n, n, n)) < 0.02
    spec = GridSpec(n=n, origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
    occ_d = torch.from_numpy(occ).to(dev)
    org = jfa_cuda.org_tensor(spec, dev)
    seed = jfa_init_seed(occ_d)
    k = n // 2
    while k >= 1:
        b3 = jfa_cuda.flood_step(seed, org, k)
        if n % k == 0:
            before = jfa_cuda.flood_step_pipe.launches
            got = jfa_cuda.flood_step_pipe(seed, org, k)
            assert jfa_cuda.flood_step_pipe.launches == before + 1
            assert torch.equal(got, b3), k
            assert torch.equal(got, jfa_cuda.flood_step_pipe_plain(seed, org, k)), k
        if k == 1:
            got = jfa_cuda.flood_step_pipe(seed, org, 1, occ_d)
            want = jfa_cuda.sdf_from_seed(b3, occ_d, org)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            plain = jfa_cuda.flood_step_pipe_plain(seed, org, 1, occ_d)
            assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
        seed = b3
        k //= 2
    counts = [f.launches for f in (jfa_cuda.flood_step_pipe, jfa_cuda.flood_step,
                                   jfa_cuda.sdf_from_seed)]
    got = jfa(occ_d, spec, pipe=True)
    ks = [n >> i for i in range(1, n.bit_length()) if n >> i >= 2]
    divides = sum(n % k == 0 for k in ks)
    assert [f.launches - c for f, c in zip((jfa_cuda.flood_step_pipe, jfa_cuda.flood_step,
                                            jfa_cuda.sdf_from_seed), counts)] == [
        divides + 1, len(ks) - divides, 0]
    assert divides < len(ks) or n == 128
    want = jfa(occ_d, spec, pipe=False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if n == 128:
        ref = torch.from_numpy(jfa_ref(occ, spec))
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


def _wq_case(n):
    mesh = _mesh(lambda: procedural.torus(1.0, 0.35, 48, 24), "torus")
    spec = GridSpec.fit(mesh.coords, n)
    return mesh, spec


def test_wq_kernel_matches_plain_and_oracle(dev):
    """B14 on a work-queue plan at n = 128 (seg 64: fragments over two
    segments), against its plain version, the oracle and resolve."""
    n = 128
    mesh, spec = _wq_case(n)
    plan = vox_work_queue.WorkQueueVoxPlan(mesh, spec, dev, seg=64)
    before = vox_work_queue.wq_fill.launches
    grid = vox_work_queue.voxelize_wq(mesh, spec, dev, plan=plan)
    assert vox_work_queue.wq_fill.launches == before + 1
    want = vox_work_queue.wq_fill_plain(*plan.args(), n=n, tc=plan.tc)
    assert torch.equal(grid.words, want)
    oracle = pack_bits(torch.from_numpy(voxelize_ref(mesh, spec)))
    assert torch.equal(grid.words.cpu(), oracle) and bool(oracle.ne(0).any())


@pytest.mark.parametrize("n,tc", [(512, 128), (256, 64)])
def test_wq_kernel_on_random_runs(dev, n, tc):
    """Random lanes over the whole x axis (every segment), pads, runs of
    several chunks on scattered tiles, one tile masked out."""
    rng = np.random.default_rng(n)
    num_tiles = n * n // tc
    tiles = np.sort(rng.choice(num_tiles, 40, replace=False)).astype(np.int32)
    chunks = rng.integers(1, 4, tiles.size).astype(np.int32)
    starts = (np.concatenate([[0], np.cumsum(chunks)])[:-1] * 8).astype(np.int32)
    rows = int(chunks.sum()) * 8
    cells = rng.integers(-1, tc, (rows, 128)).astype(np.int32)
    xs = rng.integers(0, n, (rows, 128)).astype(np.int32)
    mask = np.zeros(num_tiles, bool)
    mask[tiles[1:]] = True
    args = [torch.from_numpy(a) for a in (cells, xs, starts, chunks, tiles, mask)]
    got = vox_work_queue.wq_fill(*(a.to(dev) for a in args), n=n, tc=tc)
    want = vox_work_queue.wq_fill_plain(*args, n=n, tc=tc)
    assert torch.equal(got.cpu(), want) and bool(want.ne(0).any())


def test_probe_kernel_matches_plain(dev):
    """P1's variants against their plain versions at n = 64; hoist and
    hoistv equal B3."""
    n = 64
    occ = np.random.default_rng(6).random((n, n, n)) < 0.02
    spec = GridSpec(n=n, origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
    org = jfa_cuda.org_tensor(spec, dev)
    seed = jfa_init_seed(torch.from_numpy(occ).to(dev))
    for k in (32, 4, 1):
        b3 = jfa_cuda.flood_step(seed, org, k)
        for variant in jfa_probe.VARIANTS:
            before = jfa_probe.flood_probe.launches
            got = jfa_probe.flood_probe(seed, org, k, variant)
            assert jfa_probe.flood_probe.launches == before + 1
            assert torch.equal(got, jfa_probe.flood_probe_plain(seed, org, k, variant)), (
                variant, k)
            if variant in ("legacy", "hoist", "hoistv"):
                assert torch.equal(got, b3), (variant, k)


def test_new_kernels_refuse_bad_arguments(dev):
    seed = torch.full((12, 12, 12), -1, dtype=torch.int32, device=dev)
    org = torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="must divide"):
        jfa_cuda.flood_step_pipe(seed, org, 5)
    with pytest.raises(TypeError, match="int32"):
        jfa_cuda.flood_step_pipe(seed.float(), org, 1)
    with pytest.raises(TypeError, match="int32"):
        jfa_probe.flood_probe(seed.float(), org, 1, "hoist")
    with pytest.raises(ValueError, match="unknown variant"):
        jfa_probe.flood_probe(seed, org, 1, "dma")
    lanes = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    run = torch.zeros(1, dtype=torch.int32, device=dev)
    mask = torch.zeros(8, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="int32"):
        vox_work_queue.wq_fill(lanes.float(), lanes, run, run, run, mask, n=32, tc=128)
    with pytest.raises(ValueError, match="different devices"):
        vox_work_queue.wq_fill(lanes, lanes.cpu(), run, run, run, mask, n=32, tc=128)


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
    tile = torch.tensor([1, 5], dtype=torch.int32, device=dev)
    got = vox_cuda.wide_fill(local, xs, tile, n=64, tc=128, num_tiles=2)
    want = vox_cuda.wide_fill_plain(local[:1], xs[:1], tile[:1], n=64, tc=128,
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


# Seg engine: B9 within 1e-4 (fixed-point sums against float64 ones),
# B10 bitwise (adds only, in the plain version's association), B11
# within 1e-3 x max|plain| (warp sums against torch's).
@pytest.mark.parametrize("n", [256, 384])
def test_seg_kernels_match_plain(dev, n):
    c, sp, g = _soft_case(n)
    plan = soft_vox_seg.SegSoftPlan(sp, c, dev)
    prm = plan.prm(0.5, 0.5)
    tables = soft_vox_fused.tables_of(torch.from_numpy(c).to(dev), plan).detach()
    args = (tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d, plan.batch_panel_d)
    kw = dict(n=n, tc=plan.tc, tz=plan.tz)
    counts = [f.launches for f in (soft_vox_seg.seg_fwd, soft_vox_seg.seg_combine,
                                   soft_vox_seg.seg_bwd)]
    parts = soft_vox_seg.seg_fwd(*args, plan.run_start_d, prm=prm, **kw)
    want = soft_vox_seg.seg_fwd_plain(*args, prm=prm, **kw)
    torch.cuda.synchronize()
    for got, ref in zip(parts, want):
        assert _max_err(got, ref) <= 1e-4
    occ = soft_vox_seg.seg_combine(*parts, **kw)
    ref = soft_vox_seg.seg_combine_plain(*parts, **kw)
    torch.cuda.synchronize()
    assert torch.equal(occ.view(torch.int32), ref.view(torch.int32))
    assert float(ref.max()) > 0.5
    g = g.to(dev)
    gpre = soft_vox_seg.seg_gpre(g)
    got = soft_vox_seg.seg_bwd(*args, g, gpre, prm=prm, **kw)
    want = soft_vox_seg.seg_bwd_plain(*args, g, gpre, prm=prm, **kw)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 1e-3 * float(want.abs().max())
    assert [f.launches for f in (soft_vox_seg.seg_fwd, soft_vox_seg.seg_combine,
                                 soft_vox_seg.seg_bwd)] == [k + 1 for k in counts]


@pytest.mark.parametrize("n,tc,tz", [(256, 128, 8), (384, 64, 8), (512, 128, 8)])
def test_seg_combine_kernel_on_random_parts(dev, n, tc, tz):
    """B10 on seeded random out_a, out_b and carries, bitwise its plain
    version; a NaN carry puts NaN where the plain version does."""
    rng = np.random.default_rng(n + tc)
    nt = n * n // tc
    shape = (nt, n // soft_vox_seg.PANEL, tc, soft_vox_seg.PANEL)
    out_a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    out_b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    carry = rng.uniform(-1, 1, (nt, n // soft_vox_seg.LATTICE, tc)).astype(np.float32)
    carry[nt // 2, 1, tc // 3] = np.nan
    carry = torch.from_numpy(carry).to(dev)
    kw = dict(n=n, tc=tc, tz=tz)
    got = soft_vox_seg.seg_combine(out_a, out_b, carry, **kw)
    want = soft_vox_seg.seg_combine_plain(out_a, out_b, carry, **kw)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def test_seg_engine_gradient_on_the_card_matches_the_cpu(dev):
    c, sp, _ = _soft_case(256)
    mesh = Mesh(coords=c, faces=sp.faces_array, faces_normals=sp.faces_array)
    target = voxelize(mesh, sp.spec, "cuda", device=dev).to_dense().float()
    grads = []
    for device in (dev, torch.device("cpu")):
        fit = VoxelFit(sp, target.to(device), engine="seg", refresh_every=0)
        x = torch.from_numpy(c).to(device).requires_grad_(True)
        fit._loss_fn(fit._fwd(x), fit.target).backward()
        grads.append(x.grad.cpu())
    assert _max_err(*grads) <= 1e-3 * float(grads[1].abs().max())


@pytest.mark.parametrize("name,n,seg", [("torus", 128, None), ("torus", 128, 64),
                                        ("icosahedron", 192, 96)])
def test_cross_check_routes_on_b2_match_banded_and_oracle(dev, name, n, seg):
    """voxtpu's two cross-check routes on the card: `SlotVoxPipeline` and
    the suffix route of a `PallasVoxPlan` (seg = n or n/2) each launch B2
    once a call and equal the banded grid and the oracle (xor 0)."""
    make = {"torus": lambda: procedural.torus(1.0, 0.35, 48, 24),
            "icosahedron": procedural.icosahedron}[name]
    from voxtpu_torch.ops.vox_slots import SlotVoxPipeline

    mesh = _mesh(make, name)
    spec = GridSpec.fit(mesh.coords, n)
    banded, overflow = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, dev).words()
    assert int(overflow) == 0
    oracle = pack_bits(torch.from_numpy(voxelize_ref(mesh, spec))).to(dev)
    before = vox_cuda.wide_fill.launches
    slots = SlotVoxPipeline(mesh, spec, dev, seg=seg if seg == n else None).words()
    plan = vox_cuda.PallasVoxPlan(mesh, spec, dev, seg=seg)
    suffix = voxelize(mesh, spec, "word_event", device=dev, plan=plan).words
    assert vox_cuda.wide_fill.launches == before + 2
    for got in (slots, suffix):
        assert torch.equal(got, banded) and torch.equal(got, oracle)


@pytest.mark.parametrize("n", [64, 96])
def test_wide_flood_on_the_card_equals_the_cpu(dev, n):
    """The wide (hi, lo) flood in torch ops on the card, bitwise the same
    flood on the CPU (non-dyadic geometry: both round term for term); a
    small byte budget (z-chunks of 2 planes) changes nothing; on dyadic
    geometry, where every float distance is exact and orders seeds as the
    integer metric does, bitwise the packed kernels' field."""
    from voxtpu_torch.ops.jfa import jfa_wide

    g = np.random.default_rng(n)
    occ = torch.from_numpy(g.random((n, n, n)) < 0.02)
    spec = GridSpec(n=n, origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
    cpu = jfa(occ, spec, backend="plain", encoding="wide")
    got = jfa(occ.to(dev), spec, backend="plain", encoding="wide")
    assert got.is_cuda
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
    small = jfa_wide(occ.to(dev), spec, budget=2 * 16 * n * n)
    assert torch.equal(small.view(torch.int32), got.view(torch.int32))
    dyadic = GridSpec(n=n, origin=(0.5, -2.0, 1.25), voxel_size=0.0625)
    wide = jfa(occ.to(dev), dyadic, backend="plain", encoding="wide")
    packed = jfa(occ.to(dev), dyadic, backend="cuda")
    assert torch.equal(wide.view(torch.int32), packed.view(torch.int32))
