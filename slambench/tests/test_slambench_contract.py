"""The result line's contract, on a CPU run of a shrunk cell, and the
command on a machine without the cards it asks for.  The run on the card
is marked ``cuda`` and skips here."""

import json
import subprocess
import sys
import time

import pytest
import torch

from slambench import harness, spec
from slambench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_result_line_of_a_traced_cpu_run():
    bench, cell, config = tiny.cell(tiny.ONLINE)
    result, info = harness.run_cell(bench, tiny.ONLINE, 2 ** 33 + 7, 2.0, True,
                                    torch.device("cpu"), time.perf_counter(), cell=cell,
                                    config=config)
    line = json.loads(json.dumps(result))
    assert list(line) == KEYS
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        unit = next(x["unit"] for x in bench["per_layer"] if x["name"] == name)
        assert m["unit"] == unit
    assert set(line["metrics"]) <= {m["name"] for m in spec.metrics_for(bench, tiny.ONLINE, True)}
    # No operation ran on a device: the idle share's reader returns nothing, never 0.
    assert "device_idle_pct" not in line["metrics"]
    assert all(len(line["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    assert set(line["checks"]) == set(cell["check"]["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    # On the CPU the program runs its plain versions, which the frozen
    # reference copies: every number reads 0.
    assert all(v == 0.0 for v in info["numbers"].values() if v is not None)
    assert 0.0 <= info["keyframe_ate_m"] < 5.0


def test_ate_is_zero_under_a_rigid_motion():
    import numpy as np

    from slambench import trajectory

    g = np.random.default_rng(0)
    gt = g.normal(size=(20, 3)) * 10
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    assert trajectory.ate_rmse(gt @ R.T + [3.0, -1.0, 2.0], gt) < 1e-9
    T = np.tile(np.eye(4), (20, 1, 1))
    T[:, :3, :3] = R.T
    T[:, :3, 3] = -(gt @ R)  # world-to-camera of cameras at gt, rotated by R
    np.testing.assert_allclose(trajectory.centres(T), gt, atol=1e-9)


def test_untraced_metrics_are_the_cells_end_to_end_metrics():
    bench, cell, config = tiny.cell(tiny.ONLINE)
    result, _ = harness.run_cell(bench, tiny.ONLINE, 3, 1.5, False,
                                 torch.device("cpu"), time.perf_counter(), cell=cell,
                                 config=config)
    assert set(result["metrics"]) == {m["name"] for m in
                                      spec.metrics_for(bench, tiny.ONLINE, False)}
    assert "breakdown" not in result and list(result)[-1] == "checks"


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                          "fleet-b8.world", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_run_on_the_card(card):
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                          "fleet-b8.world", "--seed", "2", "--seconds", "3"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
