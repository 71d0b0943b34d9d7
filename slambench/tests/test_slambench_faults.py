"""The check catches a broken timed path: a CPU run of a shrunk cell with a
fault planted under the program's entry points (the harness's look for a
card skipped) comes out not correct, and the same run unbroken correct.
The control, the reference in the precision below, fails the BA's numbers
at this size; its TF32 half runs on the card only."""

import time

import pytest
import torch

from slambench import check, harness
from slambench.tests import tiny


def _run(name, seed=17):
    bench, cell, config = tiny.cell(name)
    return harness.run_cell(bench, name, seed, 2.5, False, torch.device("cpu"),
                            time.perf_counter(), cell=cell, config=config)


def _ba_unchanged(monkeypatch):
    from stereoslam_tpu_torch.core.graphs import BAGraph

    monkeypatch.setattr(BAGraph, "__call__", lambda self, m: m)


def _track_unchanged(monkeypatch):
    from stereoslam_tpu_torch.core import frontend

    real = frontend.track_step

    def step(fs, *a, **kw):
        out = real(fs, *a, **kw)
        return out._replace(state=out.state._replace(T_rk=fs.T_rk))

    monkeypatch.setattr(frontend, "track_step", step)


def _lk_altered(monkeypatch):
    from stereoslam_tpu_torch.core import frontend

    real = frontend.pyramidal_lk

    def lk(*a, **kw):
        r = real(*a, **kw)
        return r._replace(points=r.points + torch.tensor([0.7, -0.4]))

    monkeypatch.setattr(frontend, "pyramidal_lk", lk)


def _half_batch(monkeypatch):
    from stereoslam_tpu_torch.parallel import multiseq

    real = multiseq.batched_track_frame

    def step(left, pyr_prev, fs, *a, **kw):
        fs2, pyr, packed = real(left, pyr_prev, fs, *a, **kw)
        half = fs.T_rk.shape[0] // 2
        T = torch.cat([fs2.T_rk[:half], fs.T_rk[half:]])  # the second half left out
        return fs2._replace(T_rk=T), pyr, packed

    monkeypatch.setattr(multiseq, "batched_track_frame", step)


@pytest.mark.parametrize("name,fault", [
    (tiny.ONLINE, None),
    (tiny.ONLINE, _ba_unchanged),
    (tiny.ONLINE, _track_unchanged),
    (tiny.ONLINE, _lk_altered),
    ("fleet-b8.world", None),
    ("fleet-b8.world", _ba_unchanged),
    ("fleet-b8.world", _half_batch),
], ids=["online", "online-ba-unchanged", "online-track-unchanged", "online-lk-altered",
        "fleet", "fleet-ba-unchanged", "fleet-half-batch"])
def test_a_fault_makes_the_run_not_correct(monkeypatch, name, fault):
    if fault is not None:
        fault(monkeypatch)
    result, info = _run(name)
    assert result["correct"] is (fault is None), (result["checks"], info["numbers"])


def test_the_float32_ba_control_fails_the_ba_numbers():
    bench, cell, config = tiny.cell(tiny.ONLINE)
    run = harness.Run(cell=cell, config=config, seed=29, device=torch.device("cpu"))
    harness.execute(run, 2.5, False, time.perf_counter())
    res = check.evaluate(run, cell["check"]["limits"], control=True)
    limits = cell["check"]["limits"]
    assert res["correct"]
    assert res["control"]["ba_pose_gap_m"] > limits["ba_pose_gap_m"] or \
        res["control"]["ba_point_gap_m"] > limits["ba_point_gap_m"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_tf32_control_fails_the_tracked_frame(card):
    bench, cell, config = tiny.cell(tiny.ONLINE)
    run = harness.Run(cell=cell, config=config, seed=31, device=card)
    harness.execute(run, 2.5, False, time.perf_counter())
    run.facade = None
    res = check.evaluate(run, cell["check"]["limits"], control=True)
    limits = cell["check"]["limits"]
    assert res["correct"], res["compared"]
    assert res["control"]["track_pose_gap_m"] > limits["track_pose_gap_m"]
