"""The pipelined frame loop of the torch port on the CPU: ``readback_lag``,
``process_chunk`` and the tracked frame's graph runner (run here without a
graph, on the same static buffers).

The contract of tests/test_pipeline_lag.py, held by the port against itself
on the same 40-frame ``generate_sequence(..., seed=3)``: lags 1, 3 and 10
give the keyframes of lag 0 and per-frame polled poses within 0.02 m ATE
(the device state evolves the same way whatever the lag, so they are in
fact equal); ``frame_trajectory()`` equals polled ``current_pose()`` at
lags 0 and 4 with the backend off (atol 1e-5); black frames are reported
LOST within lag + 1 frames; every logged ``ref_kf`` is a keyframe and the
newest is the frontend's.  ``process_chunk`` gives the keyframe trajectory
of per-frame ``process_staged``, bit for bit (VO only, so no retire work
changes the state).  The runner's CPU path equals plain
``frontend.frame_step`` bit for bit.  The file imports no JAX.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch import eval as peval  # noqa: E402
from stereoslam_tpu_torch.core import frontend as pfrontend  # noqa: E402
from stereoslam_tpu_torch.core.state import LOST  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.utils.metrics import ate_rmse  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402

from test_torch_system import make_cfg  # noqa: E402


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=40, trajectory="forward", seed=3)


def run_with_lag(seq, lag, n_frames=None, **kw):
    slam = StereoSlam(make_cfg(seq), device="cpu", enable_loop=False, readback_lag=lag, **kw)
    est = []
    for t in range(n_frames or len(seq.left)):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]), \
            f"lag={lag}: lost at frame {t}"
        est.append(slam.current_pose())
    slam._drain()
    return slam, np.stack(est)


@pytest.fixture(scope="module")
def sync_run(seq):
    return run_with_lag(seq, 0)


def _kf_frames(slam):
    return slam.map.kf_frame_id[:int(slam.map.n_kf)].numpy()


@pytest.mark.parametrize("lag", [1, 3, 10])
def test_lagged_run_matches_synchronous(seq, sync_run, lag):
    slam0, est0 = sync_run
    slamN, estN = run_with_lag(seq, lag)
    assert len(_kf_frames(slam0)) >= 3
    np.testing.assert_array_equal(_kf_frames(slamN), _kf_frames(slam0))
    ate = ate_rmse(np.linalg.inv(est0.astype(np.float64)), np.linalg.inv(estN.astype(np.float64)),
                   align=False)
    assert ate < 0.02, f"lag={lag} diverged from the synchronous run: ATE {ate:.4f} m"
    assert slamN.metrics == slam0.metrics
    assert slamN.outcome_reads == slam0.outcome_reads == len(seq.left) - 1


def test_frame_trajectory_matches_polled_poses(seq):
    for lag in (0, 4):
        slam = StereoSlam(make_cfg(seq), device="cpu", enable_backend=False, enable_loop=False,
                          readback_lag=lag)
        polled = []
        for t in range(24):
            assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
            polled.append(slam.current_pose())
        assert len(slam._inflight) == lag
        fids, T = slam.frame_trajectory()
        assert list(fids) == list(range(24))
        np.testing.assert_allclose(T, np.stack(polled), rtol=0, atol=1e-5)


def test_lagged_lost_is_reported_within_lag(seq):
    lag = 4
    slam = StereoSlam(make_cfg(seq), device="cpu", enable_backend=False, enable_loop=False,
                      readback_lag=lag)
    black = np.zeros_like(seq.left[0])
    assert slam.process_frame(seq.left[0], seq.right[0], 0.0)  # init (synchronous)
    for t in range(1, 4):
        assert slam.process_frame(seq.left[t], seq.right[t], 0.1 * t)
    died_at = None
    for k in range(8):
        if not slam.process_frame(black, black, 1.0 + 0.1 * k):
            died_at = k
            break
    assert died_at is not None and died_at <= lag + 1
    assert slam.status == LOST
    assert not slam.process_frame(seq.left[4], seq.right[4], 2.0)
    ids, _ = slam.frame_trajectory()  # the frames after the LOST one never retire
    assert list(ids) == [0, 1, 2, 3] and slam.status == LOST


def test_pose_log_ref_kf_is_a_keyframe(seq):
    slam = StereoSlam(make_cfg(seq), device="cpu", enable_backend=False, enable_loop=False,
                      readback_lag=3)
    for t in range(16):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    slam._drain()
    n_kf = int(slam.map.n_kf)
    assert n_kf >= 3
    assert all(0 <= ref < n_kf for _, ref in slam._pose_log.values())
    assert slam._pose_log[max(slam._pose_log)][1] == int(slam.fs.ref_kf)


def test_process_chunk_matches_per_frame(seq, sync_run):
    slam0, _ = sync_run
    slam = StereoSlam(make_cfg(seq), device="cpu", enable_loop=False)
    for t in range(2):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    for base in range(2, 40, 8):
        hi = min(base + 8, 40)
        lr = torch.from_numpy(np.stack([np.stack([seq.left[t], seq.right[t]])
                                        for t in range(base, hi)]).astype(np.uint8))
        assert slam.process_chunk(lr, seq.timestamps[base:hi])
        assert len(slam._inflight) == hi - base  # the chunk's frames stay in flight
    for a, b in zip(slam.keyframe_trajectory(), slam0.keyframe_trajectory()):
        np.testing.assert_array_equal(a, b)
    ids, T = slam.frame_trajectory()
    ids0, T0 = slam0.frame_trajectory()
    np.testing.assert_array_equal(ids, ids0)
    np.testing.assert_array_equal(T, T0)
    assert len(slam.frame_latency_ms) == 2  # frames 0 and 1: chunk frames are kept out
    fresh = StereoSlam(make_cfg(seq), device="cpu", enable_loop=False)
    with pytest.raises(RuntimeError, match="initialized tracking"):
        fresh.process_chunk(lr, seq.timestamps[:lr.shape[0]])


def test_runner_cpu_path_equals_frame_step(seq):
    """The facade's tracked frame (runner on static buffers, one outcome
    read, branch) against frontend.frame_step from the same start, frame by
    frame, over two keyframes."""
    cfg = make_cfg(seq)
    slam = StereoSlam(cfg, device="cpu", enable_loop=False)
    assert slam.process_frame(seq.left[0], seq.right[0], seq.timestamps[0])
    fs, m, pyr = slam.fs, slam.map, slam._pyr_prev
    n_kf_events = 0
    for t in range(1, 20):
        lr = torch.from_numpy(np.stack([seq.left[t], seq.right[t]]).astype(np.uint8))
        ts = torch.tensor(seq.timestamps[t], dtype=torch.float32)
        fs, m, pyr, counts = pfrontend.frame_step(
            lr[0].float(), lambda: lr[1].float(), pyr, fs, m, slam.intr_left, slam.intr_right,
            slam.baseline, ts, cfg, ba_fn=slam._ba)
        assert slam.process_staged(lr, seq.timestamps[t])
        c = counts.tolist()
        assert (slam.metrics["num_inliers"][-1], slam.metrics["num_tracked"][-1]) == tuple(c[:2])
        assert slam._pose_log[t][1] == c[4]
        np.testing.assert_array_equal(slam._pose_log[t][0], fs.T_rk.numpy())
        n_kf_events += c[3] >= 0
        for a, b in zip((*slam.fs, *slam.fs.tracks, *slam.map, *slam._pyr_prev),
                        (*fs, *fs.tracks, *m, *pyr)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
    assert n_kf_events >= 2


def test_run_world_eval_takes_readback_lag():
    slams = []
    rec = peval.run_world_eval(n_frames=12, h=120, w=188, device="cpu", vo_baseline=False,
                               descriptor="hog", readback_lag=3, on_slam=slams.append)
    assert [s.readback_lag for s in slams] == [3]
    assert rec["frames"] == 12 and rec["lost_at"] is None
    assert len(slams[0]._inflight) == 0  # drained before the record is read


def test_readback_lag_rejects_negative(seq):
    with pytest.raises(ValueError, match="readback_lag"):
        StereoSlam(make_cfg(seq), device="cpu", enable_loop=False, readback_lag=-1)
    assert StereoSlam(make_cfg(seq), device="cpu", enable_loop=False).readback_lag == 0
