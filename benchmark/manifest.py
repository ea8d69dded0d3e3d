"""The benchmark as data: `BENCHMARK.json` at the root names the cells,
configurations and metrics; everything that belongs to one of them sits in
files of its own, found by name:

* a configuration `C`: `configs/C.json` (the sizes as they are run, with
  `family`, the module under `families/` that builds its program side and
  its plain reference);
* a cell `W`: `workloads/W.json` (its `driver`, the module under
  `drivers/` that runs it, and the limits of its correctness check), and
  its traffic mix `T`: `traffic/T.json` (parameters for the generator
  `traffic/<generator>.py` that the file names);
* a per-layer metric `M`: `metrics/M.py`, whose `read(ctx)` returns the
  value or None.

A new cell, configuration or metric of a kind that exists is new files and
entries, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent  # the benchmark's folder


class Manifest:
    """`BENCHMARK.json` beside the benchmark's folder (or `root`), and the
    files it names."""

    def __init__(self, root: Optional[Path] = None):
        self.bench = Path(root) if root is not None else ROOT
        with open(self.bench.parent / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.workloads = {w["name"]: w for w in self.spec["workloads"]}

    def _json(self, *parts: str) -> Dict[str, Any]:
        with open(self.bench.joinpath(*parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> Dict[str, Any]:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(self.workloads)}")
        return self.workloads[name]

    def cell(self, name: str) -> Dict[str, Any]:
        """The cell's entry, with its configuration file (`conf`), traffic
        parameters (`traffic_params`) and cell file (`cell_file`)."""
        w = self.workload(name)
        conf_entry = self.configs[w["config"]]
        return {**w,
                "conf": self._json_path(conf_entry["file"]),
                "traffic_params": self._json("traffic", f"{w['traffic']}.json"),
                "cell_file": self._json("workloads", f"{name}.json")}

    def _json_path(self, rel: str) -> Dict[str, Any]:
        with open(self.bench.parent / rel) as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.spec["per_layer"] if cell in m.get("workloads", [cell])]

    def driver(self, name: str) -> ModuleType:
        return load_module(self.bench / "drivers" / f"{name}.py", f"benchmark.drivers.{name}")

    def family(self, name: str) -> ModuleType:
        return load_module(self.bench / "families" / f"{name}.py", f"benchmark.families.{name}")

    def generator(self, name: str) -> ModuleType:
        return load_module(self.bench / "traffic" / f"{name}.py", f"benchmark.traffic.{name}")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.bench / "metrics" / f"{name}.py", f"benchmark.metrics.{name}")


def load_module(path: Path, qualname: str) -> ModuleType:
    """The module at `path` (a metric's name may hold dots, so its file is
    loaded by path, not imported by name)."""
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(qualname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
