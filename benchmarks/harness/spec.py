"""Everything a cell is made of, found by name: the workload in
``BENCHMARK.json``, its configuration file, its traffic file
``traffic/<traffic>.json`` and one reader ``metrics/<metric>.py`` per
metric. Adding a cell, a configuration, a traffic mix or a metric means
adding files and entries, never editing one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    metrics: list[dict]  # the entries of BENCHMARK.json this run reports
    chips: int
    root: Path = ROOT  # the checkout whose metrics/ holds the readers


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str, cells_reporting: dict[str, set]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or cell in cells_reporting.get(moves, set())


def cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "benchmarks" / "traffic" / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = bench["end_to_end"]
    names = [w["name"] for w in bench["workloads"]]
    reporting = {m["name"]: {c for c in names if _applies(m, c, {})} for m in e2e}
    chosen = bench["per_layer"] if trace else e2e
    metrics = [m for m in chosen if _applies(m, name, reporting)]
    return Cell(name, config, traffic, metrics, work["chips"], root)


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = root / "benchmarks" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
