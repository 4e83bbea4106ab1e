"""Everything a run finds by name: the cell in ``BENCHMARK.json``, its
configuration (the file the cell's ``config`` names there), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``), the runner
the mix names (``runners/<name>.py``) and the reader of each per-layer
metric (``metrics/<name>.py``). A new cell, mix or metric is a new file.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load(os.path.join(root, conf["file"]))
    traffic = _load(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    limits = _load(os.path.join(HERE, "limits", f"{name}.json"))
    return Cell(name, entry["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def runner(traffic: dict):
    """The module that runs a traffic mix (``runners/<runner>.py``)."""
    return importlib.import_module(f"{__package__}.runners.{traffic['runner']}")


def reader(metric: str) -> Callable:
    """``read(trace_context) -> number or None`` of ``metrics/<metric>.py``."""
    importlib.import_module(f"{__package__}.metrics")
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    modname = f"{__package__}.metrics._{metric.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
