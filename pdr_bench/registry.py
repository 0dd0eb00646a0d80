"""What ``BENCHMARK.json`` names, found by name.

Under the benchmark's folder (the manifest's first ``paths`` entry):

- ``traffic/<traffic>.json``: a cell's traffic mix, whose ``kind`` names
  the driver ``traffic/<kind>.py`` that runs it (a module with a ``Cell``
  class);
- ``metrics/<metric>.py``: one metric's reader, ``read(ctx)``;
- ``limits/<workload>.json``: the limit of each number a cell's
  correctness check compares.

A configuration's file is the one its manifest entry names.  A new
configuration, mix, driver or metric is a new file and a new entry; no
code lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, manifest_path):
        self.manifest_path = Path(manifest_path)
        self.root = self.manifest_path.parent
        with open(self.manifest_path) as f:
            self.manifest = json.load(f)
        self.home = self.root / self.manifest["paths"][0]

    def _entry(self, key: str, name: str) -> dict:
        for e in self.manifest[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.home / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def driver(self, kind: str) -> ModuleType:
        return _load_module(self.home / "traffic" / f"{kind}.py", f"pdr_bench_driver_{kind}")

    def limits(self, workload: str) -> Dict[str, float]:
        path = self.home / "limits" / f"{workload}.json"
        if not path.is_file():
            return {}
        with open(path) as f:
            return {k: float(v["limit"]) for k, v in json.load(f).items()}

    def metrics(self, workload: str, traced: bool) -> List[Tuple[dict, ModuleType]]:
        """The metric entries a run of ``workload`` reports (the end-to-end
        ones untraced, the per-layer ones traced) with their readers."""
        out = []
        for e in self.manifest["per_layer" if traced else "end_to_end"]:
            if "workloads" in e and workload not in e["workloads"]:
                continue
            reader = _load_module(self.home / "metrics" / f"{e['name']}.py",
                                  "pdr_bench_metric_" + e["name"].replace(".", "_"))
            out.append((e, reader))
        return out
