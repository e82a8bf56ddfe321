"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- the cell: ``workloads[name]``;
- its configuration: the file that ``configs[cell.config].file`` names;
- its traffic mix: ``port_bench/traffic/<cell.traffic>.json``, which names
  its driver, ``port_bench/drivers/<driver>.py``;
- its metrics: the ``end_to_end`` (``--trace 0``) or ``per_layer``
  (``--trace 1``) entries whose ``workloads`` list it, or that have no such
  list, each read by ``port_bench/metrics/<metric>.py``;
- the limits of its correctness check: ``port_bench/limits/<cell>.json``.

So a later cell, mix or metric is added with files and entries alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "port_bench"


class Spec:
    def __init__(self, root=ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _json(self, rel):
        with open(self.root / rel) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return self._json(c["file"])
        raise KeyError(f"no configuration {cell['config']!r}")

    def traffic(self, cell: dict) -> dict:
        return self._json(f"{PKG}/traffic/{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return self._json(f"{PKG}/limits/{cell['name']}.json")["limits"]

    def metrics(self, cell: dict, traced: bool) -> list:
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: dict):
        """The module ``metrics/<name>.py`` of a metric entry."""
        path = self.root / PKG / "metrics" / f"{metric['name']}.py"
        mod = importlib.util.spec_from_file_location(
            f"{PKG}_metric_{metric['name'].replace('.', '_')}", path)
        module = importlib.util.module_from_spec(mod)
        mod.loader.exec_module(module)
        return module


def driver(traffic: dict):
    """The driver module a traffic mix names."""
    return importlib.import_module(f"{PKG}.drivers.{traffic['driver']}")
