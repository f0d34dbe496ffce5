"""voxtpu_torch's logging and tracing (`utils/logging.py`,
`utils/trace.py`) and the CLI's `--trace`, on the CPU.

The logging tests are voxtpu's own (`tests/test_utils.py:39-62`) on the
port's module; the trace tests read the Chrome trace that
`torch.profiler` writes.
"""

import glob
import json
import os
import re

import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch import cli
from voxtpu_torch.utils import logging as vlog
from voxtpu_torch.utils.trace import annotate, trace

from tests.test_torch_cli import _write_meshes


def test_logging_levels(capsys):
    vlog.set_level("info")
    try:
        vlog.log_debug("hidden %d", 1)
        vlog.log_info("shown %s", "yes")
        vlog.log_error("boom")
    finally:
        vlog.set_level("warn")
    err = capsys.readouterr().err
    assert "hidden" not in err
    assert "[INFO]" in err and "shown yes" in err
    assert "[ERROR]" in err and "boom" in err
    # message shape: [LEVEL] [HH:MM:SS] file:line — msg
    assert re.search(r"\[INFO\] \[\d\d:\d\d:\d\d\] test_torch_trace\.py:\d+ — shown yes", err)
    vlog.set_level("off")
    try:
        vlog.log_error("silent")
    finally:
        vlog.set_level("warn")
    assert "silent" not in capsys.readouterr().err


def test_logging_check_raises():
    vlog.check(True, "fine")
    with pytest.raises(ValueError, match="bad shape"):
        vlog.check(False, "bad shape")


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_named_ranges(tmp_path):
    with trace(str(tmp_path / "tr")):
        with annotate("outer_range"):
            x = torch.ones((64, 64)).cumsum(0)
    assert float(x[-1, 0]) == 64.0
    names = {e.get("name") for e in _events(tmp_path / "tr")}
    assert "outer_range" in names


def test_trace_degrades_to_a_warning(monkeypatch, capsys, tmp_path):
    """Where profiling cannot start, the scope runs untraced and warns."""
    def refuse(self):
        raise RuntimeError("profiler refused")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    ran = []
    with trace(str(tmp_path / "none")):
        ran.append(1)
    assert ran == [1]
    assert "tracing disabled" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()


def test_cli_trace_names_its_scopes(tmp_path, capsys):
    paths = _write_meshes(tmp_path)
    log_dir = tmp_path / "trace"
    assert cli.main([*paths, "-n", "32", "-t", "2", "-p", "1", "-s", "--device", "cpu",
                     "--trace", str(log_dir)]) == 0
    assert "[CudaJFA]:" in capsys.readouterr().out
    names = {e.get("name") for e in _events(log_dir)}
    for scope in ("CudaVox(ring_a.obj)", "CudaVox(ring_b.obj)", "CudaVox::planning",
                  "CudaVox::processing", "CudaCSG", "CudaJFA"):
        assert scope in names, scope
