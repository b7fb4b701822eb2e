"""Find a cell's configuration, traffic, limits and per-layer readers by
the names in `BENCHMARK.json`; nothing here names a cell."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "lavbench"


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """Everything one run of cell `name` needs, read from files."""

    def __init__(self, name: str, root: Path = ROOT):
        root = Path(root)
        self.root = root
        self.bench = load(root)
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = _read(root / self.config_entry["file"])
        self.traffic = _read(root / PKG / "traffic" /
                             f"{self.workload['traffic']}.json")
        self.limits = _read(root / PKG / "limits" / f"{name}.json")
        self.chips = self.workload["chips"]

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports `metric` (an entry of end_to_end or
        per_layer): its `workloads` list names the cell, or it has none
        and the cell reports the end-to-end metric it moves."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:
            e2e = {m["name"]: m for m in self.bench["end_to_end"]}
            return self.reports(e2e[metric["moves"]])
        return True

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self.reports(m)]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"] if self.reports(m)]

    def loop(self):
        return importlib.import_module(
            f"{PKG}.loops.{self.traffic['loop']}")

    def reader(self, metric: str):
        """`read(ctx)` of `metrics/<metric>.py`."""
        path = self.root / PKG / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{PKG}_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
