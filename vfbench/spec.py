"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (``workloads[i]``) names a configuration and a traffic mix; the
configuration's file is the one ``configs[j].file`` gives, the traffic mix
is ``vfbench/traffic/<traffic>.json`` and each per-layer metric's reader is
``vfbench/metrics/<name>.py``, or ``vfbench/metrics/<stem>.py`` for a name
``<stem>.<split>`` whose split only says which cells report it.  Adding a
cell, a mix or a metric therefore adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, parsed
    traffic: dict  # the traffic mix's file, parsed
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    with open(path) as fh:
        return json.load(fh)


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def reader_path(metric: str) -> Path:
    exact = HERE / "metrics" / f"{metric}.py"
    if exact.exists():
        return exact
    return HERE / "metrics" / f"{metric.split('.')[0]}.py"


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(root: Path, workload: str) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(Path(root) / configs[w["config"]]["file"]) as fh:
        config = json.load(fh)
    with open(traffic_path(w["traffic"])) as fh:
        traffic = json.load(fh)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def load_reader(metric: str):
    """The metric's reader module: ``read(ctx) -> float | None``."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"vfbench.metrics.{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
