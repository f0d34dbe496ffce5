"""`BENCHMARK.json` and the files it names, found by name.

- a cell's configuration: the `file` of its `configs` entry;
- its traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``op``
  names the generator (``perfbench/harness/ops/<op>.py``) that reads it;
- a metric's reader: ``perfbench/metrics/<name>.py``, a function
  ``read(ctx)`` that returns a number, or None where it finds nothing;
  where that file is missing, the reader of the metric's family, the
  part of its name before the first dot (``idle_share.vox`` is read by
  ``idle_share.py``).

So a cell is added with a configuration file, a traffic file and an
entry, and a metric with its reader and an entry; no file that is there
changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict


class Manifest:
    def __init__(self, data: dict, root: Path = ROOT):
        self.data = data
        self.root = Path(root)
        self.configs = {c["name"]: c for c in data["configs"]}
        self.workloads = {w["name"]: w for w in data["workloads"]}
        self.metrics = [dict(m, kind="end_to_end") for m in data["end_to_end"]] + [
            dict(m, kind="per_layer") for m in data["per_layer"]]

    @classmethod
    def load(cls, root: Path = ROOT) -> "Manifest":
        return cls(json.loads((Path(root) / "BENCHMARK.json").read_text()), root)

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {', '.join(sorted(self.workloads))})")
        w = self.workloads[name]
        config = json.loads((self.root / self.configs[w["config"]]["file"]).read_text())
        traffic = json.loads(self.traffic_path(w["traffic"]).read_text())
        return Cell(name, int(w["chips"]), config, traffic)

    def traffic_path(self, traffic: str) -> Path:
        return self.root / "perfbench" / "traffic" / f"{traffic}.json"

    def metrics_for(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: its end-to-end metrics
        with --trace 0, its per-layer metrics with --trace 1."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics
                if m["kind"] == kind and cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        folder = self.root / "perfbench" / "metrics"
        path = folder / f"{metric}.py"
        if not path.is_file():
            path = folder / f"{metric.split('.', 1)[0]}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def generator(op: str):
    """The traffic generator module of `op`."""
    return importlib.import_module(f"harness.ops.{op}")
