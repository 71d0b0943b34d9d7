"""The windowed BA with no host read and the asynchronous BA of the torch
port, on the CPU, against the JAX package on the same numpy inputs.

BA drivers (``ops/schur.py``): the fixed ``rounds x iters`` steps with the
carry frozen on the device, which the card runs, equal the host's early
exit bit for bit, and both stay within ``test_torch_lm_ba.py``'s tolerances
of JAX's ``solve_window_ba`` (poses 1e-4, landmarks seen twice 1e-3 m,
identical inlier sets).  The BA graph's CPU runner (``core/graphs.py``
``BAGraph``) equals the eager ``optimize_active_map`` bit for bit and does
not alias its results.  The asynchronous facade (``inline_ba=False``):
frames tracked while a BA is in flight read the pre-BA map, a keyframe
inserted while a BA is in flight survives the swap, two runs agree bit for
bit, the run lands within 2 keyframes and 0.05 m of keyframe ATE (aligned,
as the CLIs report it) of the JAX facade's ``inline_ba=False`` run on the
same 30 frames (JAX swaps when its result is ready, the port at fixed
points, so the runs part), and a
checkpoint saved at lag 6 with a BA in flight resumes to the uninterrupted
run's state.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.core.system import StereoSlam as JSlam  # noqa: E402
from stereoslam_tpu.ops.camera import Intrinsics as JIntr  # noqa: E402
from stereoslam_tpu.ops.schur import BAProblem as JProblem, solve_window_ba as j_solve  # noqa: E402
from stereoslam_tpu_torch.core import backend as pbackend  # noqa: E402
from stereoslam_tpu_torch.core import frontend as pfrontend  # noqa: E402
from stereoslam_tpu_torch.core.graphs import BAGraph  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.ops import schur as pschur  # noqa: E402
from stereoslam_tpu_torch.ops.camera import Intrinsics as PIntr  # noqa: E402
from stereoslam_tpu_torch.ops.svd import svd  # noqa: E402
from stereoslam_tpu_torch.utils.metrics import ate_rmse  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402
from tests.test_system_vo import make_cfg as jax_make_cfg  # noqa: E402
from tests.test_torch_lm_ba import _ba_problem  # noqa: E402
from tests.test_torch_system import make_cfg  # noqa: E402

INTR = (400.0, 400.0, 320.0, 160.0)
N_FRAMES = 30


def _solve_jax(p, x64, rounds, iters):
    with jax.enable_x64(x64):
        prob = JProblem(**{k: jnp.asarray(v.astype(np.float64) if x64 and v.dtype == np.float32
                                          else v) for k, v in p.items()})
        r = jax.jit(partial(j_solve, rounds=rounds, iters=iters))(prob, JIntr.create(*INTR))
        return type(r)(*(np.asarray(v) for v in r))


# (problem keywords, JAX under x64, iters, the control flow the case covers)
BA_CASES = {
    "fixed-landmarks": (dict(n_fixed=30), False, 10, None),
    "empty-slot": (dict(n_fixed=30, empty_slot=True), False, 10, None),
    "free-scale": (dict(n_fixed=0), True, 10, None),
    # Exact pixels, every landmark fixed, poses 1e-6 off: the first step
    # converges.
    "done-first-step": (dict(noise_px=0.0, pose_noise=1e-6, n_outliers=0, n_fixed=120), True,
                        10, "done-first"),
    # Two steps a round and most observations outliers: no step converges
    # and no ratio test passes, so every step of every round runs.
    "never-done": (dict(n_outliers=400, noise_px=2.0), True, 2, "never-done"),
    # Three steps in round 1, none converged, then the ratio test ends it.
    "ratio-ends-round-1": (dict(noise_px=1.0, pose_noise=0.02), True, 3, "ratio-round-1"),
}


@pytest.mark.parametrize("case", list(BA_CASES))
def test_fixed_steps_equal_early_exit(rng, monkeypatch, case):
    kw, x64, iters, flow = BA_CASES[case]
    p = _ba_problem(rng, **kw)
    if flow is not None:
        # JAX's damping schedule, so the truncated solves follow JAX's steps.
        monkeypatch.setattr(pschur, "DAMPING_FLOOR", 1e-8)
    prob = pschur.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    intr = PIntr.create(*INTR)
    steps, rounds = [], []  # each step's converged flag, each round's ratio test
    step, classify = pschur._lm_step, pschur._classify
    monkeypatch.setattr(pschur, "_lm_step", lambda *a: (lambda r: (steps.append(bool(r[3])), r)[1])(
        step(*a)))
    monkeypatch.setattr(pschur, "_classify", lambda *a: (lambda r: (rounds.append(bool(r[1])), r)[1])(
        classify(*a)))
    early = pschur.solve_window_ba(prob, intr, iters=iters, host_exit=True)
    steps_early, rounds_early = list(steps), list(rounds)
    fixed = pschur.solve_window_ba(prob, intr, iters=iters, host_exit=False)
    assert all(torch.equal(a, b) for a, b in zip(early, fixed)), case
    assert len(steps) == len(steps_early) + 5 * iters
    if flow == "done-first":
        assert steps_early == [True] and rounds_early == [True]
    elif flow == "never-done":
        assert steps_early == [False] * 5 * iters and rounds_early == [False] * 5
    elif flow == "ratio-round-1":
        assert steps_early == [False] * iters and rounds_early == [True]

    rj = _solve_jax(p, x64, 5, iters)
    for r in (early, fixed):
        np.testing.assert_allclose(np.asarray(rj.cam_T), r.cam_T.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(np.asarray(rj.obs_inlier), r.obs_inlier.numpy())
        n_obs = np.bincount(p["obs_lm"][np.asarray(rj.obs_inlier)], minlength=len(p["lm_pos"]))
        posed = n_obs >= 2
        np.testing.assert_allclose(np.asarray(rj.lm_pos)[posed], r.lm_pos.numpy()[posed],
                                   atol=1e-3, rtol=0)


def test_float64_svd_on_the_cpu_is_torch_linalg_svd(rng):
    for dtype in (np.float32, np.float64):
        m = torch.from_numpy(rng.normal(size=(7, 3, 3)).astype(dtype))
        for got, want in zip(svd(m), torch.linalg.svd(m)):
            assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=40, trajectory="forward", seed=3)


def _async_run(seq, trace=None):
    """StereoSlam(inline_ba=False) over N_FRAMES frames.  With ``trace`` (a
    MonkeyPatch), a log of every tracked frame's map and BA in flight, of
    every launch's map, and of every keyframe branch: (kf id, frame id,
    whether its swap found a BA in flight)."""
    slam = StereoSlam(make_cfg(seq), device="cpu", enable_loop=False, inline_ba=False)
    log = {"track": [], "launch": [], "branch": []}
    if trace is not None:
        track, launch, swap, branch = (slam.track_graph.run, slam._launch_ba, slam._swap_ba,
                                       pfrontend.run_branch)
        swapped = [False]

        def traced_track(lr, pyr, fs, map_state):
            log["track"].append((map_state, slam._pending_ba))
            return track(lr, pyr, fs, map_state)

        def traced_launch():
            launch()
            log["launch"].append(slam.map)

        def traced_swap():
            swapped[0] = slam._pending_ba is not None
            swap()

        def traced_branch(o, *a, **kw):
            fs, m, kf_id = branch(o, *a, **kw)
            if o.make_kf:
                log["branch"].append((int(kf_id), int(fs.frame_id), swapped[0]))
            return fs, m, kf_id

        slam.track_graph.run, slam._launch_ba, slam._swap_ba = traced_track, traced_launch, traced_swap
        trace.setattr(pfrontend, "run_branch", traced_branch)
    for t in range(N_FRAMES):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]), f"LOST at {t}"
    return slam, log


@pytest.fixture(scope="module")
def traced(seq):
    with pytest.MonkeyPatch.context() as mp:
        return _async_run(seq, trace=mp)


def test_ba_graph_cpu_runner_equals_eager(traced):
    slam, _ = traced
    m = slam.map
    eager = pbackend.optimize_active_map(m, slam.intr_left, slam.cfg)
    g = BAGraph(slam.cfg, slam.intr_left, "cpu")
    first = g(m)
    kept = {f: getattr(first, f).clone() for f in pbackend.BA_OUTPUTS}
    for f in pbackend.BA_OUTPUTS:
        assert torch.equal(getattr(first, f), getattr(eager, f)), f
    # A second run on another map leaves the first result as it was.
    g(eager)
    for f in pbackend.BA_OUTPUTS:
        assert torch.equal(getattr(first, f), kept[f]), f
    assert not torch.equal(eager.kf_T_cw, m.kf_T_cw)  # the BA moved the window


def test_frames_in_flight_track_the_pre_ba_map(traced):
    slam, log = traced
    stale = [(m, pending) for m, pending in log["track"] if pending is not None]
    assert stale, "no frame was tracked while a BA was in flight"
    launched = {id(m) for m in log["launch"]}
    assert all(id(m) in launched for m, _ in stale)
    assert any(not torch.equal(m.kf_T_cw, pending[1]["kf_T_cw"]) for m, pending in stale)


def test_keyframe_inserted_while_ba_in_flight_is_kept(traced):
    slam, log = traced
    inserted = [(kf, frame) for kf, frame, swapped in log["branch"] if swapped]
    assert inserted, "no keyframe was inserted while a BA was in flight"
    n_kf = int(slam.map.n_kf)
    frames = slam.map.kf_frame_id[:n_kf].numpy()
    assert n_kf == len(log["branch"]) + 1  # every branch's keyframe and the initial one
    for kf, frame in inserted:
        assert kf < n_kf and bool(slam.map.kf_valid[kf]) and frames[kf] == frame


def test_async_runs_repeat_bit_for_bit(seq, traced):
    a, _ = traced
    b, _ = _async_run(seq)
    for x, y in zip(a.keyframe_trajectory(), b.keyframe_trajectory()):
        assert np.array_equal(x, y)
    for x, y in zip(a.map, b.map):
        assert torch.equal(x, y)


def _kf_ate(kf_T_cw, frame_ids, seq):
    """Keyframe ATE as both packages' CLIs report it (aligned)."""
    gt = np.linalg.inv(seq.T_cw[frame_ids].astype(np.float64))
    return ate_rmse(np.linalg.inv(kf_T_cw.astype(np.float64)), gt, align=True)


def test_async_run_against_the_jax_facade(seq, traced):
    slam, _ = traced
    jslam = JSlam(jax_make_cfg(seq), enable_loop=False, inline_ba=False)
    for t in range(N_FRAMES):
        assert jslam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    _, _, jT = jslam.keyframe_trajectory()
    jn = int(jslam.map.n_kf)
    _, _, pT = slam.keyframe_trajectory()
    pn = int(slam.map.n_kf)
    assert abs(pn - jn) <= 2
    j_ate = _kf_ate(jT, np.asarray(jslam.map.kf_frame_id)[:jn], seq)
    p_ate = _kf_ate(pT, slam.map.kf_frame_id[:pn].numpy(), seq)
    assert abs(p_ate - j_ate) <= 0.05, (p_ate, j_ate)


def test_lagged_checkpoint_with_ba_in_flight_resumes(tmp_path, seq):
    cfg = make_cfg(seq)
    a = StereoSlam(cfg, device="cpu", enable_loop=False, inline_ba=False, readback_lag=6)
    t = 0
    while t < 2 or a._pending_ba is None or not a._inflight:
        assert a.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        t += 1
    path = str(tmp_path / "ck.npz")
    a.save_checkpoint(path)
    b = StereoSlam(cfg, device="cpu", enable_loop=False, inline_ba=False, readback_lag=6)
    b.load_checkpoint(path)
    for t in range(t, t + 8):
        assert a.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        assert b.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    a._drain()
    b._drain()
    for x, y in zip(a.map, b.map):
        assert torch.equal(x, y)
    for x, y in zip(a.keyframe_trajectory(), b.keyframe_trajectory()):
        assert np.array_equal(x, y)
    assert np.array_equal(a.current_pose(), b.current_pose())
