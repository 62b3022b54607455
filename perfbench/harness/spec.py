"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Its configuration is the file the ``configs`` entry names; its
traffic is ``perfbench/traffic/<traffic>.json``; the limits its
comparison holds it to are ``perfbench/limits/<cell>.json``; each metric
is read by ``perfbench/metrics/<metric>.py``. A later change adds a cell,
a configuration or a metric as new files and entries, without editing
any that exist.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    reader: ModuleType


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    limits: dict          # the comparison's limits, by number compared
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The module ``perfbench/metrics/<name>.py``: its ``read(run)``
    returns the metric's value, or None where the run has nothing for it
    to read."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"{path} has no read(run)")
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(by_name)}")
    work = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[work["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{work['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{name}.json")
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"],
                  load_reader(m["name"], root))
           for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m.name for m in e2e}
    per_layer = [Metric(m["name"], m["unit"], m["better"], m["source"],
                        load_reader(m["name"], root))
                 for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    return Cell(name, int(work["chips"]), config, traffic, limits, e2e,
                per_layer)
