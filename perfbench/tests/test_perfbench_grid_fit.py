"""The reader of the grid fit's span (`metrics/vox_plan_fit_ms.py`): the
program's `grid.fit` records inside the window's `vox.plan` spans, as
`test_perfbench_spans.py` checks the serving plan's phases."""

from __future__ import annotations

import pytest

from test_perfbench_spans import MANIFEST, _ctx, _read, _store
from voxtpu_torch.utils import trace as tr

NAME = "vox_plan_fit_ms"
WINDOW = [("vox.plan", 10.0, 11.0), ("vox.call", 11.0, 11.1),
          ("vox.plan", 20.0, 21.0), ("vox.call", 21.0, 21.1)]


def test_declared_in_the_new_mesh_cell():
    (metric,) = [m for m in MANIFEST.data["per_layer"] if m["name"] == NAME]
    assert metric["workloads"] == ["washer1348k_512.new_mesh"]
    assert (metric["layer"], metric["moves"], metric["better"], metric["source"]) == (
        "serving host plan", "vox_ms", "lower", "host_clock")


def test_set_up_fits_are_not_counted(monkeypatch):
    # Set-up's fits (t < 10: the warm requests, a cell's own grid) lie
    # outside the window's vox.plan spans; two window requests fit once each.
    _store(monkeypatch, [
        ("grid.fit", 1.0, 1.5, {"points": 8}, None),
        ("grid.fit", 10.0, 10.002, {"points": 8}, None),
        ("vox.plan.candidates", 10.002, 10.01, {}, None),
        ("grid.fit", 20.0, 20.004, {"points": 8}, None),
    ])
    assert _read(NAME, _ctx(WINDOW)) == pytest.approx(3.0)


@pytest.mark.parametrize("records", [[], [("grid.fit", 1.0, 1.5, {}, None)]],
                         ids=["none", "set_up_only"])
def test_no_window_records_read_none(records, monkeypatch):
    _store(monkeypatch, records)
    assert _read(NAME, _ctx(WINDOW)) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(tr, "recorded")
    assert _read(NAME, _ctx(WINDOW)) is None
