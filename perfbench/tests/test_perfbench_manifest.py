"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness import manifest as manifest_mod
from harness.guard import forbidden_loaded

ROOT = manifest_mod.ROOT
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = DATA["end_to_end"] + DATA["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(DATA["command"]) <= 32 and all(_line(w) for w in DATA["command"])
    assert 1 <= len(DATA["paths"]) <= 16
    for p in DATA["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for word in DATA["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in DATA["paths"])
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in DATA[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])


def test_metrics_keys_bounds_and_sources():
    e2e = {m["name"] for m in DATA["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(DATA["end_to_end"]) <= 16
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])


def test_every_cell_reports_what_the_contract_asks():
    manifest = manifest_mod.Manifest(DATA)
    for w in DATA["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_for(w["name"], trace=False)}
        layer = manifest.metrics_for(w["name"], trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_file_is_found_by_name():
    manifest = manifest_mod.Manifest.load()
    configs = [c["file"] for c in DATA["configs"]]
    assert len(configs) == len(set(configs))
    for c in DATA["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in DATA["workloads"]:
        cell = manifest.cell(w["name"])
        assert manifest_mod.generator(cell.traffic["op"]).Case
        assert set(cell.traffic["limits"]), w["name"]
    for m in METRICS:
        assert callable(manifest.reader(m["name"]))
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}


def test_a_cell_is_added_by_files_and_one_entry(tmp_path):
    """A copy of the benchmark with a new configuration file, a new
    traffic file and a new entry: the harness finds the new cell with no
    file of its own changed."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads(json.dumps(DATA))
    config = json.loads((ROOT / "perfbench/configs/washer1348k_512.json").read_text())
    config.update(name="washer1348k_1024", n=1024)
    (tmp_path / "perfbench/configs/washer1348k_1024.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "perfbench/traffic/sdf.json").read_text())
    traffic["compare"] = 1
    (tmp_path / "perfbench/traffic/sdf_one.json").write_text(json.dumps(traffic))
    data["configs"].append({"name": "washer1348k_1024", "source": config["source"],
                            "file": "perfbench/configs/washer1348k_1024.json", "reduced": [],
                            "why": "the SDF at 1024^3"})
    data["workloads"].append({"name": "washer1348k_1024.sdf_one", "config": "washer1348k_1024",
                              "traffic": "sdf_one", "chips": 1, "why": "B4's flood"})
    data["per_layer"].append({"name": "idle_share.sdf1024", "unit": "%", "better": "lower",
                              "source": "device_trace", "layer": "device", "moves": "setup_s",
                              "workloads": ["washer1348k_1024.sdf_one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    manifest = manifest_mod.Manifest.load(tmp_path)
    cell = manifest.cell("washer1348k_1024.sdf_one")
    assert cell.traffic["compare"] == 1 and cell.config["n"] == 1024
    assert [m["name"] for m in manifest.metrics_for(cell.name, trace=False)] == ["setup_s"]
    assert [m["name"] for m in manifest.metrics_for(cell.name, trace=True)] == [
        "idle_share.sdf1024"]
    assert callable(manifest.reader("idle_share.sdf1024"))


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded({"voxtpu_torch": 1, "voxtpu_torch.ops.jfa": 1, "jaxtyping": 1,
                             "flaxen": 1}) == []
    assert forbidden_loaded({"voxtpu.ops": 1, "jax": 1, "jaxlib.xla": 1,
                             "flax.linen": 1}) == ["flax", "jax", "jaxlib", "voxtpu"]


@pytest.mark.parametrize("module", ["reference.vox", "reference.jfa", "reference.soft",
                                    "harness.meshes", "harness.peaks"])
def test_yardstick_imports_nothing_of_the_program(module):
    """The references, the meshes and the peaks load neither the program
    nor JAX nor the JAX package."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'perfbench')!r}]; import {module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'voxtpu', 'voxtpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_source_files_name_no_forbidden_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|voxtpu)(\s|\.|$)", re.M)
    for path in Path(ROOT / "perfbench").rglob("*.py"):
        assert not pattern.search(path.read_text()), path
