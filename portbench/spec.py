"""What a cell is, read from data: ``BENCHMARK.json`` at the checkout's
root names the cells and metrics; the files under this folder, found by
name, hold the rest.

- ``configs/<config>.json``: a configuration, its keys as it is run;
- ``traffic/<traffic>.json``: a traffic mix, the parameters the one
  generator of :mod:`portbench.serve` reads;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries, without editing one that exists.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # the entries of BENCHMARK.json it reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(entry: dict, cell: str, e2e_names: set) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or,
    with no ``workloads`` key, wherever the end-to-end metric it moves is
    reported (``e2e_names``: those of the cell)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in e2e_names if "moves" in entry else True


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    bench = load_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=w["chips"],
                config=load_json(here / "configs" / f"{w['config']}.json"),
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
