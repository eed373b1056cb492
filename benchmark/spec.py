"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the harness reads ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (whose ``driver`` names
``benchmark/drivers/<driver>.py``) and ``benchmark/limits/<cell>.json``,
and takes each metric that ``BENCHMARK.json`` lists for the cell from
``benchmark/metrics/<metric>.py``. A new cell, configuration, traffic mix,
driver or metric is a new file and a new entry: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric names, with --trace 0
    per_layer: list  # metric names, with --trace 1
    root: Path


def _listed(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    here = root / "benchmark"
    return Cell(
        name=name, chips=w["chips"],
        config=_json(here / "configs" / f"{w['config']}.json"),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "limits" / f"{name}.json")["limits"],
        end_to_end=[m["name"] for m in bench["end_to_end"]
                    if _listed(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"] if _listed(m, name)],
        root=root)


def load_module(cell: Cell, kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` of the cell's tree, as a module."""
    path = cell.root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
