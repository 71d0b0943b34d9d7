"""The benchmark is driven by data: ``BENCHMARK.json`` meets the contract,
and a cell, a configuration and a metric added as files only are found and
run."""

import json
import re
import shutil
import time

import pytest
import torch

from slambench import harness, spec
from slambench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_meets_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "slambench/run.py"] and b["paths"] == ["slambench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # A full check of 24 cells fits in its 43,200 s.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        assert spec.config(c["name"])["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    cells = [w["name"] for w in b["workloads"]]
    assert len(cells) == len(set(cells))
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        f = spec.workload(w["name"])
        assert (f["config"], f["traffic"], f["why"]) == (w["config"], w["traffic"], w["why"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {"host_clock", "device_trace"}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES and _line(m["layer"])
        assert all(c in cells and c in e2e[m["moves"]].get("workloads", cells)
                   for c in m.get("workloads", []))
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        e = [m["name"] for m in spec.metrics_for(b, c, False)]
        assert "setup_s" in e and len(e) >= 2 and spec.metrics_for(b, c, True)
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_cell_configuration_and_metric_added_as_files_run(tmp_path):
    bench_dir = tmp_path / "slambench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(spec.BENCH_DIR / sub, bench_dir / sub)
    _, cell, config = tiny.cell("fleet-b8.world")
    config["name"] = cell["config"] = "tiny-fleet"
    cell["name"] = "tiny-fleet.world"
    (bench_dir / "configs" / "tiny-fleet.json").write_text(json.dumps(config))
    (bench_dir / "workloads" / "tiny-fleet.world.json").write_text(json.dumps(cell))
    (bench_dir / "metrics" / "frames_attempted.py").write_text(
        '"""Frames handed in."""\n\n\ndef read(run):\n    return run.attempted\n')
    bench = spec.benchmark()
    bench["configs"].append(dict(name="tiny-fleet", source="tests", why="tests",
                                 file="slambench/configs/tiny-fleet.json", reduced=[]))
    bench["workloads"].append(dict(name="tiny-fleet.world", config="tiny-fleet", traffic="world",
                                   chips=1, why="tests"))
    bench["end_to_end"].append(dict(name="frames_attempted", unit="frames", better="higher",
                                    bound=0.05, source="host_clock",
                                    workloads=["tiny-fleet.world"]))
    assert [m["name"] for m in spec.metrics_for(bench, "fleet-b8.world", False)] == \
        [m["name"] for m in spec.metrics_for(spec.benchmark(), "fleet-b8.world", False)]
    result, info = harness.run_cell(bench, "tiny-fleet.world", 5, 4.0, False,
                                    torch.device("cpu"), time.perf_counter(),
                                    bench_dir=bench_dir)
    assert set(result["metrics"]) == {"frames_per_s", "setup_s", "frames_attempted"}
    assert result["metrics"]["frames_attempted"]["value"] == result["attempted"] > 0
    assert result["correct"], result["checks"]
    assert len(info["keyframe_ate_m"]) == cell["drive"]["streams"]
    # Drives of 5 frames: the window started new ones, and every frame
    # handed in (a drive's first frame too) counts.
    assert info["frames"]["drive_start"] >= 1
    assert result["attempted"] == cell["drive"]["streams"] * (
        info["frames"]["step"] + info["frames"]["drive_start"])


def test_a_missing_reader_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric", tmp_path)
