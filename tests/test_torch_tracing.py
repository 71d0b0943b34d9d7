"""The port's spans and host-read counter (``utils/prof.py``) on the batched
mode's fleet step (``parallel/multiseq.py``): the per-step record, the read
sites, and the ``slam.*`` events on the profiler's timeline.

The CPU tests run the small fleet of tests/test_torch_multiseq.py
(``_fleet.py``: two synthetic sequences, loop closing off) once, with the
profiler's event constructors patched to raise, so the run itself shows that
no event is opened while the profiler is off.  The tests marked ``cuda``
skip without a card; the file imports no JAX, so run them there with

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda

On the card the spans stay host events on a trace of the card, and over
30 fleet steps after the graphs' captures, the profiler off, the counter's
reads at synchronizing sites (every site but the event waits) equal the
syncs that torch's sync-debug mode reports.
"""

import traceback
import warnings
from collections import defaultdict

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import _fleet  # noqa: E402
from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.parallel import multiseq as pms  # noqa: E402
from stereoslam_tpu_torch.utils import prof  # noqa: E402

N_FRAMES = 12
KF_SPANS = ("kf.detect", "kf.stereo", "kf.insert")


def _fleet_vo(seqs, device="cpu"):
    vo = pms.MultiSeqVO(_fleet.make_cfg(pconfig, seqs[0]), batch=len(seqs), enable_loop=False,
                        device=device)
    vo.initialize(_fleet.stack(seqs, 0, "left"), _fleet.stack(seqs, 0, "right"),
                  np.zeros(len(seqs)))
    return vo


def _step(vo, seqs, t):
    """Step ``t``; on the card its (B, 2, H, W) stack staged first, as the
    benchmark's fleet hands it in.  Returns the streams it served."""
    before = vo.keyframes_serviced
    ts = np.full(len(seqs), t * 0.1)
    if vo.device.type == "cuda":
        lr = np.stack([_fleet.stack(seqs, t, "left"), _fleet.stack(seqs, t, "right")], axis=1)
        staged = torch.from_numpy(lr.astype(np.uint8)).to(vo.device)
        torch.cuda.synchronize()
        vo.process_staged(staged, ts)
    else:
        vo.process_frames(_fleet.stack(seqs, t, "left"), _fleet.stack(seqs, t, "right"), ts)
    return vo.keyframes_serviced - before


def _refuse(*args, **kw):
    raise AssertionError("a profiler event was opened while the profiler was off")


@pytest.fixture(scope="module")
def seqs():
    return _fleet.sequences(N_FRAMES)


@pytest.fixture(scope="module")
def run(seqs):
    """The fleet over the sequences, the profiler off and its event
    constructors patched to raise; each step's served count and each read
    counter's state after it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prof, "_RecordFunctionFast", _refuse)
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(torch.autograd.profiler, "record_function", _refuse)
        vo = _fleet_vo(seqs)
        served, counts = [], []
        for t in range(1, N_FRAMES):
            served.append(_step(vo, seqs, t))
            counts.append(dict(vo.reads.counts))
        vo.drain()
    return vo, served, counts


def test_no_profiler_event_while_the_profiler_is_off(run):
    vo, served, _ = run
    assert vo.steps == N_FRAMES - 1 and sum(served) > 0 and vo.alive.all()


def test_every_step_key_has_one_entry_a_step(run):
    vo, served, _ = run
    assert set(vo.stage_s) == set(pms.STEP_KEYS)
    for key in pms.STEP_KEYS:
        assert len(vo.stage_s[key]) == vo.steps, key
    assert len(vo.step_reads) == vo.steps
    for k, n in enumerate(served):
        for key in ("kf_branch", "ba_launch"):
            assert (vo.stage_s[key][k] > 0) == (n > 0), (key, k)


def test_no_device_keys_on_the_cpu(run):
    """The record holds host seconds only: a replay's device time is read
    from a trace of the card."""
    vo, _, _ = run
    assert not [key for key in vo.stage_s if "device" in key]
    assert set(vo.stage_s) == set(pms.STEP_KEYS)


def test_sub_spans_fit_in_their_stages(run):
    vo, _, _ = run
    s = vo.stage_s
    for k in range(vo.steps):
        assert s["kf_branch"][k] + s["ba_launch"][k] <= s["keyframes"][k]
        assert 0.0 <= s["host_wait"][k] <= (s["track"][k] + s["keyframes"][k] + s["retire"][k])


def test_a_step_that_serves_nothing_reads_only_its_outcome(run):
    vo, served, counts = run
    prev = {}
    plain = 0
    for k, n in enumerate(served):
        if n == 0:
            plain += 1
            assert vo.step_reads[k] == 1
            assert {site: c - prev.get(site, 0) for site, c in counts[k].items()
                    if c != prev.get(site, 0)} == {"outcome": 1}
        else:
            # The keyframe's count, its insert's rows, the BA's wait: more
            # than the outcome.
            assert vo.step_reads[k] > 1
        prev = counts[k]
    assert plain > 0


def test_site_counts_add_up_to_the_steps_reads(run):
    vo, served, _ = run
    c = vo.reads.counts
    assert sum(c.values()) == sum(vo.step_reads) == vo.reads.n
    assert vo.outcome_reads == c["outcome"] == vo.steps
    assert c["service.kf_id"] == c["kf.n_kf"] == c["insert.counts"] == sum(served)
    assert not hasattr(vo, "detect_reads")
    assert abs(sum(vo.reads.seconds.values()) - vo.reads.s) < 1e-9
    assert abs(sum(vo.stage_s["host_wait"]) - vo.reads.s) < 1e-6


def test_each_served_ba_records_its_lm_steps(run):
    """One ``ba_steps`` entry a served BA; its exit reads are one a step and
    one a round."""
    vo, served, _ = run
    s = vo.ba_steps
    assert len(s) == sum(served) == vo.keyframes_serviced
    b = vo._run_cfg.backend
    assert all(1 <= n <= b.ba_rounds * b.ba_iters for n in s)
    assert sum(s) + len(s) <= vo.reads.counts["ba.exit"] <= 2 * sum(s)


def test_spans_reach_the_profilers_timeline(seqs, run):
    """The fleet again, its first serving step under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    t = 1 + run[1].index(next(n for n in run[1] if n))
    vo = _fleet_vo(seqs)
    for k in range(1, t):
        _step(vo, seqs, k)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        assert _step(vo, seqs, t) > 0
    names = defaultdict(list)
    for e in p.profiler.kineto_results.events():
        if e.name().startswith(prof.SPAN_PREFIX):
            names[e.name()].append(e)
    want = ["track", "retire", "keyframes", "kf_branch", "ba_launch", "read.outcome",
            "read.kf.n_kf", "read.service.kf_id", *KF_SPANS]
    assert {prof.SPAN_PREFIX + n for n in want} <= set(names)
    # Function-scope events: none is a user annotation, which CUPTI would copy
    # onto the device's timeline.
    assert not any(e.is_user_annotation() for v in names.values() for e in v)
    assert len(names["slam.track"]) == 2 and len(names["slam.keyframes"]) == 1
    # The per-step record saw the same spans.
    assert len(vo.stage_s["track"]) == t and vo.stage_s["kf_branch"][-1] > 0


def test_span_adds_its_seconds_and_counter_its_reads(monkeypatch):
    clock = iter(np.arange(20) * 0.5)
    monkeypatch.setattr(prof.time, "perf_counter", lambda: float(next(clock)))
    rec = defaultdict(float)
    with prof.span("a", into=rec):
        with prof.span("b"):
            pass
    assert rec == {"a": 1.5}
    reads = prof.HostReads()
    with prof.host_read(reads, "x"):
        pass
    with prof.host_read(reads, "y", 3):
        pass
    with prof.host_read(None, "z"):  # no counter: only the trace's event
        pass
    assert dict(reads.counts) == {"x": 1, "y": 3} and reads.n == 4 and reads.s == 1.0
    assert dict(reads.seconds) == {"x": 0.5, "y": 0.5}


def test_profiler_stages_reach_the_timeline(seqs):
    """``StereoSlam``'s ``Profiler.stage`` puts its stages on the trace, its
    records unchanged."""
    from torch.profiler import ProfilerActivity, profile

    seq = seqs[0]
    slam = StereoSlam(_fleet.make_cfg(pconfig, seq), device="cpu", enable_loop=False)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for t in range(3):
            slam.process_frame(seq.left[t], seq.right[t], 0.1 * t)
    names = {e.name() for e in p.profiler.kineto_results.events()}
    assert {"slam.track", "slam.branch"} <= names
    assert slam.profiler.summary()["track"]["count"] == 2 and len(slam.profiler.frames) == 3


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_FRAMES = 48
CARD_COUNTED = 30


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and events have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_seqs(card):
    return _fleet.sequences(CARD_FRAMES)


def _warm(vo, seqs):
    """Steps until a keyframe service has run: both graphs captured."""
    t = 1
    while True:
        served = _step(vo, seqs, t)
        t += 1
        if served:
            vo.drain()
            torch.cuda.synchronize()
            return t


@pytest.mark.cuda
def test_spans_are_host_events_on_the_cards_trace(card, card_seqs):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vo = _fleet_vo(card_seqs, device="cuda")
    t = _warm(vo, card_seqs)
    served = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        while t < CARD_FRAMES and not any(served):
            served.append(_step(vo, card_seqs, t))
            t += 1
        torch.cuda.synchronize()
    assert any(served)
    events = p.profiler.kineto_results.events()
    assert any(e.name() == "slam.ba_launch" for e in events)
    assert any(e.device_type() == DeviceType.CUDA for e in events)
    # Nothing named slam.* on the device's timeline, where it would read as
    # device time.
    assert not [e.name() for e in events
                if e.device_type() == DeviceType.CUDA and e.name().startswith(prof.SPAN_PREFIX)]


@pytest.mark.cuda
def test_a_ba_callable_in_the_graphs_place_records_no_ba_launch(card, card_seqs):
    """A caller may put another BA callable in the service's place (the eager
    BA, for a comparison): the span is inside ``BAGraph``, so its steps
    record no BA launch."""
    from functools import partial

    from stereoslam_tpu_torch.core import backend

    vo = _fleet_vo(card_seqs, device="cuda")
    t = _warm(vo, card_seqs)
    vo._ba = partial(backend.optimize_active_map, intr=vo.intr, cfg=vo._run_cfg, host_exit=True)
    served = 0
    while not served and t < CARD_FRAMES:
        served = _step(vo, card_seqs, t)
        t += 1
    assert served
    assert vo.stage_s["ba_launch"][-1] == 0.0 and vo.stage_s["kf_branch"][-1] > 0


class _SyncLog:
    """The syncs that torch's sync-debug mode reports, each with the port's
    frames of its stack."""

    def __enter__(self):
        self.sites = []
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _show(self, message, *args, **kw):
        if "called a synchronizing CUDA operation" in str(message):
            self.sites.append(" <- ".join(
                f"{f.filename.rsplit('/', 2)[-2]}/{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                for f in traceback.extract_stack()[::-1] if "stereoslam_tpu_torch" in f.filename)
                [:160])

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)


@pytest.mark.cuda
def test_read_counter_equals_the_sync_debug_reports(card, card_seqs):
    vo = _fleet_vo(card_seqs, device="cuda")
    t = _warm(vo, card_seqs)
    before = dict(vo.reads.counts)
    n0 = len(vo.step_reads)
    served = 0
    lr = [torch.from_numpy(np.stack([_fleet.stack(card_seqs, k, "left"),
                                     _fleet.stack(card_seqs, k, "right")], axis=1)
                           .astype(np.uint8)).to(card) for k in range(t, t + CARD_COUNTED)]
    torch.cuda.synchronize()
    with pytest.MonkeyPatch.context() as mp, _SyncLog() as log:
        mp.setattr(prof, "_RecordFunctionFast", _refuse)
        mp.setattr(torch.profiler, "record_function", _refuse)
        for k, staged in enumerate(lr, start=t):
            before_k = vo.keyframes_serviced
            vo.process_staged(staged, np.full(len(card_seqs), k * 0.1))
            served += vo.keyframes_serviced - before_k
        torch.cuda.synchronize()
    counted = {s: c - before.get(s, 0) for s, c in vo.reads.counts.items()
               if c != before.get(s, 0)}
    sync_sites = sum(c for s, c in counted.items() if s not in pms.EVENT_READ_SITES)
    assert served > 0 and len(vo.step_reads) - n0 == CARD_COUNTED
    assert counted["outcome"] == CARD_COUNTED
    reported = defaultdict(int)
    for site in log.sites:
        reported[site] += 1
    assert sync_sites == len(log.sites), (counted, sorted(reported.items()))
