"""``BENCHMARK.json`` and the files it names, found by name.

* ``benchmark/configs/<config>.json`` (the ``file`` of a configuration);
* ``benchmark/traffic/<traffic>.json``: a mix's parameters and its loop
  (``benchmark/loops/<loop>.py``);
* ``benchmark/limits/<workload>.json``: the limit of each number the check
  compares in that cell;
* ``benchmark/metrics/<metric>.py``: one reader a per-layer metric;
* ``benchmark/counts/<kernel>.py``: a kernel's bytes and operations.

A cell, a configuration, a mix or a metric is added by adding its files and
its entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    """A Python file loaded by its path (metric names hold dots, so they
    are no importable module names)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark._by_name_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with every file it needs."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = workload
        conf = [c for c in bench["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = _json(root / conf["file"])
        here = root / "benchmark"
        self.traffic = _json(here / "traffic" /
                             f"{self.workload['traffic']}.json")
        self.limits: Dict[str, float] = _json(here / "limits" /
                                              f"{workload}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _in_cell(m, workload)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _in_cell(m, workload)]
        self.chips = self.workload["chips"]
        self.run_seconds = bench["run_seconds"]
        self._root = root

    def reader(self, metric: str) -> ModuleType:
        return _module(self._root / "benchmark" / "metrics" / f"{metric}.py")


def _in_cell(metric: dict, workload: str) -> bool:
    cells: Optional[List[str]] = metric.get("workloads")
    return cells is None or workload in cells


def count(kernel: str, root: Path = ROOT) -> ModuleType:
    """``benchmark/counts/<kernel>.py``."""
    return _module(root / "benchmark" / "counts" / f"{kernel}.py")
