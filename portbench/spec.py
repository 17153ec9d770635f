"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them, each in
a file of its own, so that a new configuration, traffic mix, cell or
metric is a new file and no edit:

- ``BENCHMARK.json`` ``configs[].file``: the configuration's data;
- ``portbench/traffic/<traffic>.json``: the traffic mix (the estimator a
  cell's steps run, and its lighting);
- ``portbench/workloads/<cell>.json``: what the cell freezes: its work a
  sample (the roofline's count), the pixels its check compares and the
  limits of the numbers compared;
- ``portbench/metrics/<metric>.py``: the metric's reader, ``read(record)
  -> float or None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    config: dict       # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json
    frozen: dict       # workloads/<cell>.json
    end_to_end: list   # the end-to-end metrics the cell reports
    per_layer: list    # the per-layer metrics the cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, or those listed."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench: dict = None) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                       f"{', '.join(sorted(entries))})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / HERE.name
    return Cell(
        name=name, entry=entry,
        config=load_json(root / configs[entry["config"]]["file"]),
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        frozen=load_json(here / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
