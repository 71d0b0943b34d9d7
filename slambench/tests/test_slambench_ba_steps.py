"""The reader of the program's BA step counter
(``slambench/metrics/ba_lm_steps.fleet.py``) on hand-built runs: the mean
over the window's served BAs, and None, never 0, where the program records
nothing."""

import types

import pytest
import torch

from slambench import harness, spec

NAME = "ba_lm_steps.fleet"


def _run(served, ba_steps=None):
    run = harness.Run(cell={}, config={}, seed=0, device=torch.device("cpu"))
    run.spans = [harness.Span(0.0, 1.0, "drive_start")]
    run.spans += [harness.Span(float(k), k + 1.0, "step", serviced=n) for k, n in enumerate(served)]
    run.facade = types.SimpleNamespace(ba_steps=ba_steps) if ba_steps is not None else None
    return run


def _read(run):
    return spec.reader(NAME).read(run)


def test_the_reader_is_in_the_benchmark():
    m = {m["name"]: m for m in spec.benchmark()["per_layer"]}[NAME]
    assert m["better"] == "lower" and m["moves"] == "frames_per_s"
    assert m["unit"] == "steps/BA" and m["layer"] == "BA graph"
    assert m["source"] == "program_counter" and m["workloads"] == ["fleet-b8.world"]


def test_steps_a_ba_over_the_windows_served_bas():
    # The facade's list also holds BAs before the window (warm-up): the last
    # ones are the window's, 3 served in its steps.
    assert _read(_run([0, 2, 0, 1], ba_steps=[50, 50, 2, 11, 3])) == pytest.approx(16 / 3)


@pytest.mark.parametrize("run", [
    _run([0, 1, 0]),  # no facade: the parent's harness run on a program without it
    _run([0, 1], ba_steps=[]),
    _run([0, 0], ba_steps=[2, 3]),  # the window served no BA
    _run([], ba_steps=[2, 3]),  # no step in the window
    _run([2, 1], ba_steps=[2, 3]),  # fewer entries than served BAs
], ids=["no_facade", "empty_list", "none_served", "no_step", "short_list"])
def test_nothing_recorded_reads_none(run):
    assert _read(run) is None


def test_a_facade_without_ba_steps_reads_none():
    run = _run([0, 1])
    run.facade = object()
    assert _read(run) is None
