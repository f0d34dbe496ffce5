"""The port's spans (`utils/trace.py::span`) on the CPU: the gate, the
bounded store, and the phases that the grid fit, the serving plan, the
JFA, the fused and seg plans and a fit's plan refresh record under
`torch.profiler`."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch import cli
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.models.fit import VoxelFit
from voxtpu_torch.ops.jfa import jfa
from voxtpu_torch.ops.reference import voxelize_ref
from voxtpu_torch.ops.soft_vox import make_soft_plan
from voxtpu_torch.ops.soft_vox_fused import FusedSoftPlan
from voxtpu_torch.ops.soft_vox_seg import SegSoftPlan
from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline
from voxtpu_torch.utils import trace as tr

from tests.test_torch_cli import _write_meshes

N = 64
VOX_PHASES = ["vox.plan.candidates", "vox.plan.windows", "vox.plan.batches",
              "vox.plan.upload"]
ENGINE_PHASES = ["soft.engine_plan.cells", "soft.engine_plan.cut", "soft.engine_plan.tables"]


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _mesh(shape):
    if shape == "washer":
        coords, faces = procedural.washer(0.75, 1.0, 0.25, 48)
    elif shape == "icosahedron":  # faces wider than a narrow band: the whole-axis fallback
        coords, faces = procedural.icosahedron()
    else:
        coords, faces = procedural.icosphere(2, center=(0.1, -0.2, 0.3))
    return Mesh(name=shape, coords=coords, faces=faces, faces_normals=faces)


def _names(records, prefix):
    return [r.name for r in records if r.name.startswith(prefix)]


def test_span_off_is_one_null_object_and_records_nothing():
    tr.clear()
    assert not torch._C._autograd._profiler_enabled()
    spans = [tr.span("vox.plan.candidates"), tr.span("jfa.flood", device="cpu")]
    assert all(s is tr.NULL_SPAN for s in spans)
    with spans[0] as sp:
        sp.count("candidates", 5)
    assert tr.annotate("CudaVox::planning") is tr.NULL_SPAN
    pipe = BandedSlotVoxPipeline(_mesh("icosphere"), GridSpec.fit(_mesh("icosphere").coords, 32),
                                 "cpu")
    assert pipe.num_candidates > 0
    assert tr.recorded() == [] and tr.dropped() == 0


def test_span_on_records_names_parents_counts_and_times():
    tr.clear()
    with _profiled():
        t0 = time.perf_counter()
        with tr.span("outer") as outer:
            outer.count("k", 2)
            outer.count("k", 3)
            with tr.span("inner", device="cpu") as inner:
                inner.count("n", 1)
        t1 = time.perf_counter()
    inner_r, outer_r = tr.recorded()
    assert (inner_r.name, inner_r.parent, inner_r.counts) == ("inner", "outer", {"n": 1})
    assert (outer_r.name, outer_r.parent, outer_r.counts) == ("outer", None, {"k": 5})
    assert t0 <= outer_r.t0 <= inner_r.t0 <= inner_r.t1 <= outer_r.t1 <= t1
    assert inner_r.device_ms is None and outer_r.device_ms is None
    tr.clear()
    assert tr.recorded() == []


def test_store_drops_its_oldest_records_and_counts_them(monkeypatch):
    monkeypatch.setattr(tr, "_STORE", tr._Store(4))
    with _profiled():
        for i in range(6):
            with tr.span(f"s{i}"):
                pass
    assert [r.name for r in tr.recorded()] == ["s2", "s3", "s4", "s5"]
    assert tr.dropped() == 2
    tr.clear()
    assert tr.recorded() == [] and tr.dropped() == 0


def test_grid_fit_records_its_points_only_under_a_profile():
    coords = _mesh("washer").coords
    tr.clear()
    plain = GridSpec.fit(coords, N)
    assert tr.recorded() == []
    with _profiled():
        spec = GridSpec.fit(coords, N)
    (record,) = tr.recorded()
    assert (record.name, record.parent, record.counts) == ("grid.fit", None,
                                                           {"points": len(coords)})
    assert record.device_ms is None and record.t0 <= record.t1
    assert spec == plain
    tr.clear()


@pytest.mark.parametrize("shape, band", [("icosahedron", 32), ("icosphere", 256)])
def test_banded_plan_records_its_four_phases(shape, band):
    mesh = _mesh(shape)
    spec = GridSpec.fit(mesh.coords, N)
    tr.clear()
    with _profiled():
        pipe = BandedSlotVoxPipeline(mesh, spec, "cpu", band=band)
    records = [r for r in tr.recorded() if r.name.startswith("vox.plan.")]
    assert [r.name for r in records] == VOX_PHASES
    assert all(r.parent is None for r in records)
    for a, b in zip(records, records[1:]):
        assert a.t0 <= a.t1 <= b.t0 <= b.t1
    # What crosses between host and device: the mesh, the grid's three
    # scalars (24 bytes) and three reads (the candidate total; the batch
    # total with each tile's wide count; the batches' tiles and bases) on
    # the way; the layouts' tile lists and the wide batches' arrays on the
    # way down. Nothing that grows with the candidates or the slots.
    st, num_tiles = pipe.state, pipe.num_tiles
    mesh_bytes = mesh.coords.nbytes + mesh.faces.nbytes
    assert records[0].counts == {"candidates": pipe.num_candidates,
                                 "host_bytes": mesh_bytes + 24 + 8, "syncs": 1}
    assert records[1].counts == {}
    assert records[2].counts == {"batches": pipe.num_batches, "wide": pipe.num_wide,
                                 "host_bytes": 8 * (num_tiles + 1) + 8 * st.batch_tile.shape[0],
                                 "syncs": 2}

    def layout_bytes(lay):
        return lay.start.nbytes + lay.order.nbytes

    down = layout_bytes(st.layout)
    if st.wide is not None:
        w_rtile, w_ctile, w_uidx = st.wide[2:]
        down += (16 * w_ctile.shape[0] + w_rtile.nbytes + w_ctile.nbytes + w_uidx.nbytes
                 + layout_bytes(st.wide_layout))
    assert records[3].counts == {"host_bytes": down}
    assert sum(r.counts.get("syncs", 0) for r in records) == 3
    assert (pipe.num_wide > 0) == (shape == "icosahedron")
    # The spans change nothing of the plan or its grid.
    ref = BandedSlotVoxPipeline(mesh, spec, "cpu", band=band)
    for a, b in zip(pipe.state.rows + (pipe.state.local, pipe.state.batch_tile),
                    ref.state.rows + (ref.state.local, ref.state.batch_tile)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(pipe().to_dense().numpy(), voxelize_ref(mesh, spec))


@pytest.mark.parametrize("encoding", ["packed", "wide"])
def test_jfa_records_unpack_seed_init_and_flood(encoding):
    mesh = _mesh("washer")
    spec = GridSpec.fit(mesh.coords, N)
    grid = BandedSlotVoxPipeline(mesh, spec, "cpu")()
    want = jfa(grid, spec, backend="plain", encoding=encoding)
    tr.clear()
    with _profiled():
        got = jfa(grid, spec, backend="plain", encoding=encoding)
    records = tr.recorded()
    assert _names(records, "jfa.") == ["jfa.unpack", "jfa.seed_init", "jfa.flood"]
    assert all(r.device_ms is None and r.parent is None for r in records)
    assert torch.equal(got, want)


def test_fused_refresh_records_soft_plan_and_engine_plan_inside_the_step():
    coords, faces = procedural.icosphere(2, center=(0.1, -0.2, 0.3))
    spec = GridSpec.fit(coords, N)
    target = voxelize_ref(Mesh(name="t", coords=coords, faces=faces, faces_normals=faces),
                          spec).astype(np.float32)
    start = (coords + np.random.default_rng(0).normal(0, 0.01, coords.shape)).astype(np.float32)
    plan = make_soft_plan(Mesh(name="s", coords=start, faces=faces, faces_normals=faces), spec)
    fit = VoxelFit(plan, torch.from_numpy(target), learning_rate=5e-3, refresh_every=1,
                   drift_limit_frac=0.0, engine="fused")
    state, _ = fit.step(fit.init(start))  # no drift yet: no refresh
    assert fit.refresh_count == 0
    tr.clear()
    with _profiled():
        t0 = time.perf_counter()
        state, _ = fit.step(state)
        t1 = time.perf_counter()
    assert fit.refresh_count == 1
    records = [r for r in tr.recorded() if r.name.startswith("soft.")]
    assert [r.name for r in records] == ["soft.plan"] + ENGINE_PHASES + ["soft.engine_plan"]
    soft, *phases, engine = records
    assert t0 <= soft.t0 <= soft.t1 <= engine.t0 <= engine.t1 <= t1
    assert all(engine.t0 <= r.t0 <= r.t1 <= engine.t1 and r.parent == "soft.engine_plan"
               for r in phases)
    assert soft.counts == {"fragments": fit.plan.num_fragments}
    assert engine.counts == {"fragments": fit.engine_plan.num_fragments,
                             "pairs": fit.engine_plan.num_pairs}


@pytest.mark.parametrize("layout", [dict(), dict(tb_sub=2, tbl=64)])
def test_fused_plan_records_its_three_phases(layout):
    """What crosses between host and device while a fused plan is built:
    the bucket rows and the faces on the way up; four reads on the way
    back (the slot and pair totals; the batch total, the least count and
    the busy tiles; the two classed layouts' largest counts with the
    least and largest batch tile, table row and cell and the batches out
    of tile order; the layouts' histograms). Nothing that grows with the
    slots or the pairs."""
    mesh = _mesh("icosphere")
    spec = GridSpec.fit(mesh.coords, N)
    sp = make_soft_plan(mesh, spec, pad_window=2)
    tr.clear()
    with _profiled():
        plan = FusedSoftPlan(sp, "cpu", **layout)
    records = [r for r in tr.recorded() if r.name.startswith("soft.engine_plan.")]
    assert [r.name for r in records] == ENGINE_PHASES
    assert all(r.parent is None and r.device_ms is None for r in records)
    for a, b in zip(records, records[1:]):
        assert a.t0 <= a.t1 <= b.t0 <= b.t1
    rows = sum(len(b[4]) for b in sp.buckets)
    assert records[0].counts == {"host_bytes": 3 * 4 * rows + mesh.faces.size * 4}
    assert records[1].counts == {"host_bytes": 2 * 8 + 3 * 8, "syncs": 2,
                                 "batches": plan.num_batches}
    # The largest class of each layout is its largest count.
    hist = plan.expand_cls[-1].shape[0] + 1 + plan.vert_cls[-1].shape[0] + 1
    assert records[2].counts == {"host_bytes": 9 * 8 + 8 * hist, "syncs": 2}
    assert plan.num_batches > len(set(plan.batch_tile.tolist())) > 1
    # The spans change nothing of the plan.
    ref = FusedSoftPlan(sp, "cpu", **layout)
    for attr in ("cells_d", "tblidx_d", "batch_tile_d", "run_start_d", "fidx_d"):
        assert torch.equal(getattr(plan, attr), getattr(ref, attr)), attr


def test_seg_plan_records_its_three_phases():
    """The seg plan's phases are the fused plan's: the faces and one
    int64 key a slot on the way up; the same four reads on the way
    back, counted on the same spans. The spans change nothing of it."""
    mesh = _mesh("icosphere")
    side = float(np.ptp(mesh.coords, axis=0).max())
    spec = GridSpec(n=256, origin=tuple(float(v) - 0.1 * side for v in mesh.coords.min(0)),
                    voxel_size=side / 64.0)
    sp = make_soft_plan(mesh, spec)
    tr.clear()
    with _profiled():
        plan = SegSoftPlan(sp, mesh.coords, "cpu")
    records = [r for r in tr.recorded() if r.name.startswith("soft.engine_plan.")]
    assert [r.name for r in records] == ENGINE_PHASES
    assert all(r.parent is None and r.device_ms is None for r in records)
    for a, b in zip(records, records[1:]):
        assert a.t0 <= a.t1 <= b.t0 <= b.t1
    assert records[0].counts == {"host_bytes": 8 * plan.num_fragments + mesh.faces.size * 4}
    assert records[1].counts == {"host_bytes": 2 * 8 + 3 * 8, "syncs": 2,
                                 "batches": plan.num_batches}
    hist = plan.expand_cls[-1].shape[0] + 1 + plan.vert_cls[-1].shape[0] + 1
    assert records[2].counts == {"host_bytes": 9 * 8 + 8 * hist, "syncs": 2}
    assert plan.num_batches >= plan.num_runs > len(set(plan.batch_tile.tolist())) > 1
    ref = SegSoftPlan(sp, mesh.coords, "cpu")
    for attr in ("cells_d", "tblidx_d", "batch_tile_d", "batch_panel_d", "run_start_d",
                 "fidx_d"):
        assert torch.equal(getattr(plan, attr), getattr(ref, attr)), attr


def test_cli_trace_holds_the_port_phases(tmp_path, capsys):
    paths = _write_meshes(tmp_path)
    log_dir = tmp_path / "trace"
    assert cli.main([*paths, "-n", "32", "-t", "2", "-p", "1", "-s", "--device", "cpu",
                     "--trace", str(log_dir)]) == 0
    assert "[CudaJFA]:" in capsys.readouterr().out
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for phase in ["grid.fit"] + VOX_PHASES + ["jfa.unpack", "jfa.seed_init", "jfa.flood"]:
        assert tr.SPAN_PREFIX + phase in names, phase
