"""The whole VO slice of the torch port on the CPU: ``StereoSlam`` over the
40-frame synthetic sequence of tests/test_system_vo.py, held to that test's
bounds (no LOST, ATE < 0.5 m with align=False, >= 2 keyframes, > 100
landmarks), plus the facade's init retry, LOST, export and capacity guards.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch.config import CameraConfig, FeatureConfig, MapConfig, SlamConfig  # noqa: E402
from stereoslam_tpu_torch.core.state import INITING, LOST, TRACKING_GOOD  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.utils.metrics import ate_rmse, rpe  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402
from stereoslam_tpu_torch.utils.trajectory import load_trajectory  # noqa: E402


def make_cfg(seq, max_kf=256, max_lm=20000):
    return SlamConfig(
        camera=CameraConfig(
            fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy,
            fx_right=seq.fx, fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
            bf=seq.fx * seq.baseline,
        ),
        features=FeatureConfig(
            n_init_features=200, n_new_features=100, max_features=256,
            num_features_init_good=50, num_features_tracking_good=50,
            num_features_tracking_bad=10,
        ),
        map=MapConfig(max_keyframes=max_kf, max_landmarks=max_lm),
        image_height=seq.left.shape[1],
        image_width=seq.left.shape[2],
    )


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=40, trajectory="forward", seed=3)


def run_vo(seq, n_frames=None, **kw):
    slam = StereoSlam(make_cfg(seq), device="cpu", **kw)
    est = []
    for t in range(n_frames or len(seq.left)):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]), f"LOST at {t}"
        est.append(slam.current_pose())
    return slam, np.stack(est)


@pytest.fixture(scope="module")
def full_run(seq):
    return run_vo(seq)


def test_vo_slice_tracks_forward_sequence(seq, full_run):
    slam, est_T_cw = full_run
    gt_T_wc = np.linalg.inv(seq.T_cw.astype(np.float64))
    ate = ate_rmse(np.linalg.inv(est_T_cw.astype(np.float64)), gt_T_wc, align=False)
    assert ate < 0.5, f"ATE {ate:.3f} m"
    t_rpe, r_rpe = rpe(np.linalg.inv(est_T_cw.astype(np.float64)), gt_T_wc)
    assert t_rpe < 0.05 and r_rpe < 0.01
    assert int(slam.map.n_kf) >= 2
    assert int(slam.map.n_lm) > 100
    ids, T = slam.frame_trajectory()
    assert list(ids) == list(range(len(seq.left)))
    ate_f = ate_rmse(np.linalg.inv(T.astype(np.float64)), gt_T_wc, align=False)
    assert ate_f < 0.5, f"frame-trajectory ATE {ate_f:.3f} m"
    assert slam.status == TRACKING_GOOD


def test_keyframe_trajectory_export(tmp_path, full_run):
    slam, _ = full_run
    path = tmp_path / "traj.txt"
    slam.save_trajectory(str(path))
    ids, ts, T_wc = load_trajectory(str(path))
    assert len(ids) == int(slam.map.n_kf)
    assert (np.diff(ids) > 0).all()
    kf_ids, kf_ts, T_cw = slam.keyframe_trajectory()
    np.testing.assert_allclose(T_wc, np.linalg.inv(T_cw.astype(np.float64)), atol=1e-5)
    np.testing.assert_allclose(ts, kf_ts, atol=1e-6)


@pytest.mark.parametrize("enable_backend,inline_ba", [(False, True), (True, False)])
def test_vo_without_inline_ba(seq, enable_backend, inline_ba):
    slam, est = run_vo(seq, n_frames=20, enable_backend=enable_backend, inline_ba=inline_ba)
    gt_T_wc = np.linalg.inv(seq.T_cw[:20].astype(np.float64))
    assert ate_rmse(np.linalg.inv(est.astype(np.float64)), gt_T_wc, align=False) < 0.5
    assert int(slam.map.n_kf) >= 2


def test_init_retry_and_lost_on_black_frames(seq):
    slam = StereoSlam(make_cfg(seq), device="cpu", enable_backend=False)
    black = np.zeros_like(seq.left[0])
    assert slam.process_frame(black, black, 0.0)          # init fails: stays INITING
    assert slam.status == INITING and int(slam.map.n_kf) == 0
    assert slam.process_frame(seq.left[0], seq.right[0], 0.1)
    assert slam.status == TRACKING_GOOD and int(slam.map.n_kf) == 1
    assert slam.process_frame(seq.left[1], seq.right[1], 0.2)
    assert not slam.process_frame(black, black, 0.3)      # LOST (frontend.cpp:103-108)
    assert slam.status == LOST
    assert not slam.process_frame(seq.left[2], seq.right[2], 0.4)


def test_capacity_guards(seq, caplog):
    """A full keyframe table saturates loudly and tracking goes on; landmark
    pressure above 90% compacts the table."""
    cfg = make_cfg(seq, max_kf=2, max_lm=700)
    slam = StereoSlam(cfg, device="cpu", enable_backend=False)
    for t in range(16):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    assert int(slam.map.n_kf) == 2
    assert any("keyframe table FULL" in r.message for r in caplog.records)
    # The run holds 233 landmarks after its third keyframe (frame 14) and
    # wants 250 after its fourth: a 240-row table crosses 90% at both.
    slam2 = StereoSlam(make_cfg(seq, max_lm=240), device="cpu", enable_backend=True)
    for t in range(24):
        assert slam2.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    assert slam2.compaction_count >= 1
    assert int(slam2.map.n_lm) <= 240


def test_unported_options_raise(seq):
    cfg = make_cfg(seq)
    with pytest.raises(NotImplementedError):
        StereoSlam(cfg, device="cpu", enable_loop=True)
    undist = cfg.replace(camera=dataclasses.replace(cfg.camera, need_undistortion=True, k1=-0.1))
    with pytest.raises(NotImplementedError):
        StereoSlam(undist, device="cpu")
