"""The reader of the program's host-read counter
(``slambench/metrics/host_syncs_per_step.fleet.py``) on hand-built runs: the
mean over the window's steps, and None, never 0, where the program records
nothing."""

import types

import pytest
import torch

from slambench import harness, spec

NAME = "host_syncs_per_step.fleet"


def _run(served, step_reads=None):
    run = harness.Run(cell={}, config={}, seed=0, device=torch.device("cpu"))
    run.spans = [harness.Span(0.0, 1.0, "drive_start")]
    run.spans += [harness.Span(float(k), k + 1.0, "step", serviced=n) for k, n in enumerate(served)]
    run.facade = types.SimpleNamespace(step_reads=step_reads) if step_reads is not None else None
    return run


def _read(run):
    return spec.reader(NAME).read(run)


def test_the_reader_is_in_the_benchmark():
    m = {m["name"]: m for m in spec.benchmark()["per_layer"]}[NAME]
    assert m["better"] == "lower" and m["moves"] == "frames_per_s"
    assert m["source"] == "program_counter" and m["workloads"] == ["fleet-b8.world"]


def test_host_reads_a_step_over_the_windows_steps():
    # The facade's list also holds steps before the window: the last ones
    # are the window's.
    assert _read(_run([0, 1, 0], step_reads=[99, 99, 1, 14, 1])) == pytest.approx(16 / 3)


@pytest.mark.parametrize("run", [
    _run([0, 1, 0]),  # no facade: the parent's harness run on a program without it
    _run([0, 1], step_reads=[]),
    _run([], step_reads=[1, 2]),  # no step in the window
    _run([0, 1, 0], step_reads=[1, 2]),  # fewer entries than steps
], ids=["no_facade", "empty_list", "no_step", "short_list"])
def test_nothing_recorded_reads_none(run):
    assert _read(run) is None


def test_a_facade_without_step_reads_reads_none():
    run = _run([0, 1])
    run.facade = object()
    assert _read(run) is None
