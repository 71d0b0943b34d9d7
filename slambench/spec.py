"""Where the benchmark finds its parts, by name.

``BENCHMARK.json`` (the repository's root) lists the cells and metrics.  A
cell ``<cell>`` is ``slambench/workloads/<cell>.json`` (its configuration,
its traffic parameters, its ``why``, its correctness check); a
configuration ``<config>`` is ``slambench/configs/<config>.json``; a metric
``<metric>`` is read by ``slambench/metrics/<metric>.py``, whose
``read(run)`` returns a number or None.  Adding a cell, a configuration or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "workloads" / f"{name}.json")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def cell_entry(spec: dict, cell: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def metrics_for(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with ``trace`` on.  A metric without
    ``workloads`` belongs to every cell (a per-layer one: to every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``metrics/<name>.py``, loaded by its path."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    mod_spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def read_metrics(run, metrics: List[dict], bench_dir: Path = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} for every metric whose reader finds a number."""
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"], bench_dir).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
