"""What a cell is made of, found by name from BENCHMARK.json.

A cell names a configuration and a traffic mix.  The configuration's
file (`configs/<config>.json`) says which scene kind builds it
(`scenes/<kind>.py`) and with what parameters; the traffic mix
(`traffic/<mix>.json`) gives the render settings, the warm-up, the
traced frames and how many frames and pixel rows the check samples; the
check's limits sit in `checks/<cell>.json`; each per-layer metric is
`metrics/<metric>.py`.  Adding a cell, a mix, a configuration or a
metric adds files and BENCHMARK.json entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{', '.join(sorted(cells))}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(HERE, "checks", f"{name}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def scene_kind(kind: str):
    """The module `scenes/<kind>.py` that builds a configuration."""
    return importlib.import_module(f"rtbench.scenes.{kind}")


def metric_reader(name: str):
    """The module `metrics/<name>.py` (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "rtbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
