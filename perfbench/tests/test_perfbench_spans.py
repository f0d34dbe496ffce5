"""The readers of the program's own spans (`harness/port_spans.py` and the
metrics that use it) on a synthetic window and store: only records inside
the window's benchmark spans count, a fit's build is told from its
refreshes by the enclosing span, and nothing read gives None."""

from __future__ import annotations

import pytest

from harness import manifest as manifest_mod
from harness.record import Recorder, Span
from harness.runner import Context
from voxtpu_torch.utils import trace as tr

MANIFEST = manifest_mod.Manifest.load()
VOX = ["vox_plan_candidates_ms", "vox_plan_windows_ms", "vox_plan_batches_ms",
       "vox_plan_upload_ms"]
FIT = ["fit_build_plan_ms", "fit_build_engine_ms", "fit_refresh_plan_ms",
       "fit_refresh_engine_ms", "fit_refresh_fragments_x"]
JFA = ["jfa_unpack_ms", "jfa_init_ms", "jfa_flood_ms"]


def _ctx(spans):
    rec = Recorder()
    rec.spans = [Span(name, t0, t1) for name, t0, t1 in spans]
    return Context(setup_s=1.0, window_s=10.0, units=[], recorder=rec, trace=None, work={})


def _store(monkeypatch, records):
    """A fresh store holding `records`: (name, t0, t1, counts, device_ms)."""
    store = tr._Store(tr.STORE_SIZE)
    for name, t0, t1, counts, device_ms in records:
        store.append(tr.SpanRecord(name, t0, t1, None, counts, device_ms))
    monkeypatch.setattr(tr, "_STORE", store)


def _read(name, ctx):
    return MANIFEST.reader(name)(ctx)


def test_the_new_metrics_are_declared_in_their_cells():
    layer = {m["name"]: m for m in MANIFEST.data["per_layer"]}
    cells = {"washer1348k_512.new_mesh": VOX, "torus1348k_512.fit_fused": FIT,
             "washer1348k_512.sdf": JFA}
    for cell, names in cells.items():
        for name in names:
            assert layer[name]["workloads"] == [cell]
            assert layer[name]["better"] == "lower"


@pytest.mark.parametrize("name", VOX + FIT + JFA)
def test_no_records_read_none(name, monkeypatch):
    _store(monkeypatch, [])
    spans = [("vox.plan", 0, 1), ("fit.plan", 0, 1), ("fit.step", 1, 2), ("sdf.request", 2, 3)]
    assert _read(name, _ctx(spans)) is None


def test_vox_phases_count_only_records_inside_the_window_spans(monkeypatch):
    # Set-up's request (t < 10) is outside the window's spans; two window
    # requests hold a phase each; a third window request was not traced.
    _store(monkeypatch, [
        ("vox.plan.batches", 1.0, 3.0, {}, None),
        ("vox.plan.batches", 10.1, 10.3, {}, None),
        ("vox.plan.upload", 10.3, 10.4, {}, None),
        ("vox.plan.batches", 20.1, 20.5, {}, None),
        ("vox.plan.upload", 20.5, 20.6, {}, None),
    ])
    ctx = _ctx([("vox.plan", 10.0, 11.0), ("vox.call", 11.0, 11.1),
                ("vox.plan", 20.0, 21.0), ("vox.call", 21.0, 21.1), ("vox.plan", 30.0, 31.0)])
    assert _read("vox_plan_batches_ms", ctx) == pytest.approx(300.0)
    assert _read("vox_plan_upload_ms", ctx) == pytest.approx(100.0)
    assert _read("vox_plan_candidates_ms", ctx) is None


def test_fit_build_and_refresh_are_told_apart_by_the_enclosing_span(monkeypatch):
    # Two traced jobs: each a build in fit.plan, steps in fit.step, and a
    # refresh in one step; the first job's refresh builds twice the
    # fragments, the second's the same. A plan made at set-up (t < 10)
    # lies outside every window span.
    _store(monkeypatch, [
        ("soft.plan", 1.0, 2.0, {"fragments": 7}, None),
        ("soft.plan", 10.0, 11.0, {"fragments": 100}, None),
        ("soft.engine_plan", 11.0, 11.5, {"fragments": 90, "pairs": 5}, None),
        ("soft.plan", 14.0, 16.0, {"fragments": 200}, None),
        ("soft.engine_plan", 16.0, 17.0, {"fragments": 180, "pairs": 9}, None),
        ("soft.plan", 20.0, 21.0, {"fragments": 50}, None),
        ("soft.engine_plan", 21.0, 21.5, {}, None),
        ("soft.plan", 24.0, 26.0, {"fragments": 50}, None),
        ("soft.engine_plan", 26.0, 27.0, {}, None),
    ])
    ctx = _ctx([("fit.plan", 9.9, 11.6), ("fit.step", 12.0, 12.1), ("fit.step", 13.9, 17.1),
                ("fit.plan", 19.9, 21.6), ("fit.step", 22.0, 22.1), ("fit.step", 23.9, 27.1)])
    assert _read("fit_build_plan_ms", ctx) == pytest.approx(1000.0)
    assert _read("fit_build_engine_ms", ctx) == pytest.approx(500.0)
    assert _read("fit_refresh_plan_ms", ctx) == pytest.approx(2000.0)
    assert _read("fit_refresh_engine_ms", ctx) == pytest.approx(1000.0)
    assert _read("fit_refresh_fragments_x", ctx) == pytest.approx(1.5)


def test_fit_jobs_without_a_refresh_read_zero_refresh_time(monkeypatch):
    _store(monkeypatch, [("soft.plan", 10.0, 11.0, {"fragments": 100}, None),
                         ("soft.engine_plan", 11.0, 11.5, {}, None)])
    ctx = _ctx([("fit.plan", 9.9, 11.6), ("fit.step", 12.0, 12.1)])
    assert _read("fit_refresh_plan_ms", ctx) == 0.0
    assert _read("fit_refresh_engine_ms", ctx) == 0.0
    assert _read("fit_refresh_fragments_x", ctx) is None


def test_jfa_phases_read_the_device_time_of_window_requests(monkeypatch):
    _store(monkeypatch, [
        ("jfa.unpack", 1.0, 1.1, {}, 9.0),  # a warm-up request
        ("jfa.unpack", 10.0, 10.01, {}, 0.5),
        ("jfa.seed_init", 10.01, 10.02, {}, 10.0),
        ("jfa.flood", 10.02, 10.03, {}, 20.0),
        ("jfa.unpack", 20.0, 20.01, {}, 0.7),
        ("jfa.seed_init", 20.01, 20.02, {}, 12.0),
        ("jfa.flood", 20.02, 20.03, {}, 22.0),
    ])
    ctx = _ctx([("sdf.request", 9.99, 10.05), ("sdf.request", 19.99, 20.05),
                ("sdf.request", 29.99, 30.05)])
    assert _read("jfa_unpack_ms", ctx) == pytest.approx(0.6)
    assert _read("jfa_init_ms", ctx) == pytest.approx(11.0)
    assert _read("jfa_flood_ms", ctx) == pytest.approx(21.0)


def test_jfa_phases_off_the_card_read_none(monkeypatch):
    _store(monkeypatch, [("jfa.seed_init", 10.01, 10.02, {}, None)])
    assert _read("jfa_init_ms", _ctx([("sdf.request", 9.99, 10.05)])) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent of this change has no `recorded`: every reader gives
    None and none raises."""
    monkeypatch.delattr(tr, "recorded")
    ctx = _ctx([("vox.plan", 0, 1), ("fit.plan", 0, 1), ("fit.step", 1, 2),
                ("sdf.request", 2, 3)])
    for name in VOX + FIT + JFA:
        assert _read(name, ctx) is None, name
