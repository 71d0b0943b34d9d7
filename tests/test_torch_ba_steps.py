"""The stepped windowed BA (``core/graphs.py`` ``SteppedBA``), which callers
that wait for the BA's result run, on its CPU runner: the same pieces as
on the card (prologue, one LM step a call, the round's end, epilogue) on
the same static buffers, without graphs.

On every problem of ``test_torch_async_ba.py``'s ``BA_CASES``, written into
a map whose active window holds its cameras, the stepped BA returns the
six BA fields bit for bit as the eager early exit
(``optimize_active_map(host_exit=True)``), the fixed steps that the
asynchronous BA's graph captures (``host_exit=False``) and ``BAGraph``'s
runner; it records as many LM steps as the early exit runs and reads one
exit test a step and one a round.  The facades choose the runner by
whether the caller waits: the inline BA and the fleet's keyframe service
step, the asynchronous BA keeps the one fixed-step graph.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch.config import SlamConfig  # noqa: E402
from stereoslam_tpu_torch.core import backend as pbackend  # noqa: E402
from stereoslam_tpu_torch.core.graphs import BAGraph, SteppedBA  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.ops import schur as pschur  # noqa: E402
from stereoslam_tpu_torch.ops.camera import Intrinsics  # noqa: E402
from stereoslam_tpu_torch.utils.prof import HostReads  # noqa: E402
from tests.test_torch_async_ba import BA_CASES, INTR  # noqa: E402
from tests.test_torch_lm_ba import _ba_problem  # noqa: E402
from tests.test_torch_system import make_cfg  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402


def _ba_map(p) -> pbackend.BAMap:
    """The problem ``p`` as a map: keyframe rows 0..W-1 are its cameras (the
    window; an invalid camera leaves its slot empty), row W lies outside the
    window and first observed the fixed landmarks, landmark row c is
    landmark c and an observation's landmark is its row."""
    W, N = p["obs_valid"].shape
    K, L = W + 1, len(p["lm_pos"])
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4))
    kf_T_cw = eye.copy()
    kf_T_cw[:W] = p["cam_T"]
    kf_feat_xy = np.zeros((K, N, 2), np.float32)
    kf_feat_xy[:W] = p["obs_px"]
    kf_feat_lm = np.full((K, N), -1, np.int32)
    kf_feat_lm[:W] = p["obs_lm"]
    kf_feat_valid = np.zeros((K, N), bool)
    kf_feat_valid[:W] = p["obs_valid"]
    obs_count = np.bincount(p["obs_lm"][p["obs_valid"]], minlength=L).astype(np.int32)
    fields = dict(
        kf_T_cw=kf_T_cw, kf_feat_xy=kf_feat_xy, kf_feat_lm=kf_feat_lm,
        kf_feat_valid=kf_feat_valid, kf_prev=np.arange(K, dtype=np.int32) - 1,
        kf_rel_prev=eye.copy(), lm_pos=p["lm_pos"], lm_valid=p["lm_valid"],
        lm_outlier=np.zeros(L, bool),
        lm_first_kf=np.where(p["lm_fixed"], W, 0).astype(np.int32), lm_obs_count=obs_count,
        active_kf=np.where(p["cam_valid"], np.arange(W), -1).astype(np.int32))
    return pbackend.BAMap(**{k: torch.from_numpy(np.array(v)) for k, v in fields.items()})


def _cfg(iters: int) -> SlamConfig:
    cfg = SlamConfig()
    return dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, ba_iters=iters))


def _equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in pbackend.BA_OUTPUTS)


@pytest.mark.parametrize("case", list(BA_CASES))
def test_stepped_ba_equals_the_early_exit_and_the_fixed_steps(rng, monkeypatch, case):
    kw, _, iters, flow = BA_CASES[case]
    p = _ba_problem(rng, **kw)
    if flow is not None:
        # JAX's damping schedule, as the case's solve-level test runs it.
        monkeypatch.setattr(pschur, "DAMPING_FLOOR", 1e-8)
    cfg, intr, m = _cfg(iters), Intrinsics.create(*INTR), _ba_map(p)
    calls = {"step": 0, "round": 0}
    step, classify = pschur._lm_step, pschur._classify

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(pschur, "_lm_step", counted("step", step))
    monkeypatch.setattr(pschur, "_classify", counted("round", classify))
    early = pbackend.optimize_active_map(m, intr, cfg, host_exit=True)
    n_steps, n_rounds = calls["step"], calls["round"]
    fixed = pbackend.optimize_active_map(m, intr, cfg, host_exit=False)
    graph = BAGraph(cfg, intr, "cpu")(m)
    reads = HostReads()
    runner = SteppedBA(cfg, intr, "cpu", reads=reads)
    got = runner(m)
    assert _equal(fixed, early) and _equal(graph, early), case
    assert _equal(got, early), case
    assert not torch.equal(got.kf_T_cw, m.kf_T_cw)  # the BA moved the window
    assert runner.steps == [n_steps]
    assert dict(reads.counts) == {"ba.exit": n_steps + n_rounds}
    if flow == "done-first":
        assert n_steps == 1 and n_rounds == 1
    elif flow == "never-done":
        assert n_steps == cfg.backend.ba_rounds * iters and n_rounds == cfg.backend.ba_rounds
    # A second call starts from its own map: the static buffers keep nothing
    # of the first solve.
    again = runner(early)
    assert _equal(again, pbackend.optimize_active_map(early, intr, cfg, host_exit=True)), case
    assert len(runner.steps) == 2


def test_the_runner_follows_whether_the_caller_waits():
    seq = generate_sequence(n_frames=2, trajectory="forward", seed=3)
    cfg = make_cfg(seq)
    assert type(StereoSlam(cfg, device="cpu", enable_loop=False)._ba) is SteppedBA
    assert type(StereoSlam(cfg, device="cpu", enable_loop=False, inline_ba=False)._ba) is BAGraph
