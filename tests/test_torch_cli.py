"""The port's CLI (``python -m stereoslam_tpu_torch.run``) on the CPU, over the
synthetic KITTI-format directory of tests/test_cli.py: its outputs, its
trajectory against the port's facade driven in-process, and its keyframes
and per-frame profiler records against the JAX package's CLI on the same
directory and flags.  Per-frame poses are not compared across the two
packages (``PARITY.json``): keyframe decisions and ATE are."""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

cv2 = pytest.importorskip("cv2")

from stereoslam_tpu import run as jax_run  # noqa: E402
from stereoslam_tpu.core import system as jax_system  # noqa: E402
from stereoslam_tpu.utils.synthetic import generate_sequence  # noqa: E402
from stereoslam_tpu_torch import run as pt_run  # noqa: E402
from stereoslam_tpu_torch.config import load_config  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.utils import kitti  # noqa: E402
from stereoslam_tpu_torch.utils.metrics import ate_rmse  # noqa: E402
from stereoslam_tpu_torch.utils.trajectory import load_trajectory  # noqa: E402

N_FRAMES = 15
MAX_KF_ATE_M = 0.5
RECORD_FIELDS = ("frame", "timestamp", "status", "keyframe_id")


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti_seq")
    seq = generate_sequence(n_frames=20, trajectory="forward", seed=3)
    (d / "image_0").mkdir()
    (d / "image_1").mkdir()
    for i in range(len(seq.left)):
        cv2.imwrite(str(d / "image_0" / f"{i:06d}.png"), seq.left[i].astype(np.uint8))
        cv2.imwrite(str(d / "image_1" / f"{i:06d}.png"), seq.right[i].astype(np.uint8))
    with open(d / "times.txt", "w") as f:
        for t in seq.timestamps:
            f.write(f"{t:.6f}\n")
    T_wc = np.linalg.inv(seq.T_cw.astype(np.float64))
    np.savetxt(d / "poses.txt", T_wc[:, :3, :].reshape(len(T_wc), 12))
    (d / "config.yaml").write_text(
        "%YAML:1.0\n"
        f"Camera.left.fx: {seq.fx}\nCamera.left.fy: {seq.fy}\n"
        f"Camera.left.cx: {seq.cx}\nCamera.left.cy: {seq.cy}\n"
        f"Camera.right.fx: {seq.fx}\nCamera.right.fy: {seq.fy}\n"
        f"Camera.right.cx: {seq.cx}\nCamera.right.cy: {seq.cy}\n"
        f"Camera.bf: {seq.fx * seq.baseline}\n"
        "numFeatures.initGood: 50\n"
        "ORBextractor.nInitFeatures: 200\n"
    )
    return d


def cli_args(kitti_dir, out_dir):
    return [str(kitti_dir / "config.yaml"), str(kitti_dir), "--output", str(out_dir),
            "--no-loop", "--max-frames", str(N_FRAMES), "--plot-every", "6",
            "--gt", str(kitti_dir / "poses.txt")]


@pytest.fixture(scope="module")
def pt_cli(kitti_dir, tmp_path_factory):
    """The port's CLI run: (rc, output dir, its StereoSlam)."""
    out = tmp_path_factory.mktemp("pt_result")
    slams = []
    rc = pt_run.main(cli_args(kitti_dir, out) + ["--device", "cpu"], on_slam=slams.append)
    return rc, out, slams[0]


@pytest.fixture(scope="module")
def jax_cli(kitti_dir, tmp_path_factory):
    """The JAX package's CLI run on the same directory and flags."""
    out = tmp_path_factory.mktemp("jax_result")
    slams = []

    class Recorded(jax_system.StereoSlam):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            slams.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_system, "StereoSlam", Recorded)
        rc = jax_run.main(cli_args(kitti_dir, out))
    return rc, out, slams[0]


def keyframe_frames(slam):
    return np.asarray(slam.map.kf_frame_id)[: int(slam.map.n_kf)].astype(np.int64)


def test_cli_writes_the_outputs(pt_cli):
    """The outputs tests/test_cli.py checks of the JAX CLI, plus the map export."""
    rc, out, slam = pt_cli
    assert rc == 0
    lines = (out / "trajectory.txt").read_text().strip().splitlines()
    assert len(lines) >= 1
    assert all(len(line.split()) == 9 for line in lines)
    assert (out / "loopEdges.txt").exists()
    assert (out / "live.png").exists()
    assert (out / "live_frame.png").exists()
    assert (out / "map.ply").exists() and (out / "map3d.png").exists()
    assert len(slam.frame_latency_ms) == N_FRAMES


def test_cli_trajectory_equals_the_facade_run(kitti_dir, pt_cli, tmp_path):
    """The same uint8 frames through kitti.frames + DeviceFeed +
    process_staged as through process_frame: byte-equal trajectories."""
    _, out, _ = pt_cli
    left_paths, right_paths, ts = kitti.load_image_paths(str(kitti_dir))
    slam = StereoSlam(load_config(str(kitti_dir / "config.yaml")), device="cpu",
                      enable_loop=False)
    for t in range(N_FRAMES):
        left = cv2.imread(left_paths[t], cv2.IMREAD_GRAYSCALE)
        right = cv2.imread(right_paths[t], cv2.IMREAD_GRAYSCALE)
        assert slam.process_frame(left, right, ts[t]), f"LOST at frame {t}"
    slam.save_trajectory(str(tmp_path / "trajectory.txt"))
    assert (tmp_path / "trajectory.txt").read_bytes() == (out / "trajectory.txt").read_bytes()


def test_cli_keyframes_agree_with_the_jax_cli(kitti_dir, pt_cli, jax_cli):
    (rc_pt, out_pt, slam_pt), (rc_jax, out_jax, slam_jax) = pt_cli, jax_cli
    assert rc_pt == rc_jax == 0
    np.testing.assert_array_equal(keyframe_frames(slam_pt), keyframe_frames(slam_jax))
    assert keyframe_frames(slam_pt).size >= 2
    for out in (out_pt, out_jax):
        assert (out / "loopEdges.txt").read_text() == ""
    gt = kitti.load_gt_poses(str(kitti_dir / "poses.txt"))
    for out, slam in ((out_pt, slam_pt), (out_jax, slam_jax)):
        _, _, T_cw = load_trajectory(str(out / "trajectory.txt"))
        ate = ate_rmse(np.linalg.inv(T_cw.astype(np.float64)), gt[keyframe_frames(slam)],
                       align=True)
        assert ate < MAX_KF_ATE_M, (out, ate)


def test_cli_profiler_records_equal_the_jax_facade(pt_cli, jax_cli):
    (_, _, slam_pt), (_, _, slam_jax) = pt_cli, jax_cli
    rec_pt = [{k: dataclasses.asdict(r)[k] for k in RECORD_FIELDS} for r in slam_pt.profiler.frames]
    rec_jax = [{k: dataclasses.asdict(r)[k] for k in RECORD_FIELDS} for r in slam_jax.profiler.frames]
    assert len(rec_pt) == N_FRAMES
    assert rec_pt == rec_jax
    kf_ids = [r["keyframe_id"] for r in rec_pt if r["keyframe_id"] >= 0]
    assert kf_ids == list(range(1, int(slam_pt.map.n_kf)))
    assert [r["frame"] for r in rec_pt if r["keyframe_id"] >= 0] == list(keyframe_frames(slam_pt)[1:])
    summary = slam_pt.profiler.summary()
    assert summary["track"]["count"] == N_FRAMES - 1


def test_cli_defaults_to_the_card(kitti_dir, tmp_path, monkeypatch):
    """With no --device the CLI runs on the card, and fails where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_run.main(cli_args(kitti_dir, tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")
