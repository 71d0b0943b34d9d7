"""The port's loop-closing slice end to end on the CPU: ``StereoSlam(cfg,
device="cpu", enable_loop=True)`` over tests/test_system_loop.py's circuit
(150 frames of a 120-frame loop at 240x376, HOG descriptor, that test's loop
thresholds), held to that test's bounds: at least one loop edge, its id gap at
least ``id_gap``, its keyframes under 4 m apart in the ground truth, ATE
under 1.0 m (align=False), and the reference's loop-edge file format.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.models.calc import DescriptorModel  # noqa: E402
from stereoslam_tpu_torch.utils.metrics import ate_rmse  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402
from tests.test_torch_loopclosing import loop_cfg  # noqa: E402


@pytest.fixture(scope="module")
def loop_run():
    seq = generate_sequence(n_frames=150, loop_frames=120, trajectory="loop", speed=0.35, seed=7,
                            n_points=900)
    cfg = loop_cfg(pconfig, seq)
    slam = StereoSlam(cfg, device="cpu", enable_loop=True, descriptor_model=DescriptorModel())
    est = []
    for t in range(len(seq.left)):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]), f"LOST at {t}"
        est.append(slam.current_pose())
    return seq, cfg, slam, np.stack(est).astype(np.float64)


def test_loop_detected_and_corrected(loop_run):
    seq, cfg, slam, est = loop_run
    assert len(slam.loop_edges) >= 1, "no loop closure detected"
    ids, _, _ = slam.keyframe_trajectory()
    fid = slam.map.kf_frame_id[: len(ids)].numpy()
    gt_wc = np.linalg.inv(seq.T_cw.astype(np.float64))
    for cur, loop in slam.loop_edges:
        assert cur - loop >= cfg.loop.id_gap
        assert np.linalg.norm(gt_wc[fid[cur]][:3, 3] - gt_wc[fid[loop]][:3, 3]) < 4.0
    ate = ate_rmse(np.linalg.inv(est), gt_wc, align=False)
    assert ate < 1.0, f"ATE {ate:.3f} m"
    # The loop state lives where the map does, at the configured size.
    M = cfg.features.max_features * cfg.features.n_levels
    assert slam.loop.orb_desc.shape == (cfg.map.max_keyframes, M, 8)
    assert slam.loop.orb_desc.dtype == torch.int32 and slam.loop.deep_db.device.type == "cpu"
    assert int(slam.loop.db_valid.sum()) > 10


def test_loop_edges_export(tmp_path, loop_run):
    _, _, slam, _ = loop_run
    path = tmp_path / "loopEdges.txt"
    slam.save_loop_edges(str(path))
    lines = open(path).read().strip().splitlines()
    # Reference format: two pose lines per loop edge (system.cpp:203-220).
    assert len(lines) == 2 * len(slam.loop_edges) >= 2
    assert all(len(line.split()) == 9 for line in lines)
    ids = [int(line.split()[0]) for line in lines]
    assert ids == [k for edge in slam.loop_edges for k in edge]


def test_profiler_records_keyframes_and_loops(loop_run):
    """The facade's per-frame records, as the JAX facade keeps them: one per
    frame, the keyframe ids of the keyframes after the init one, and each
    loop closed during a frame on the keyframe frame that resolved it."""
    seq, _, slam, _ = loop_run
    recs = slam.profiler.frames
    assert [r.frame for r in recs] == list(range(len(seq.left)))
    n_kf = int(slam.map.n_kf)
    kf = [r for r in recs if r.keyframe_id >= 0]
    assert [r.keyframe_id for r in kf] == list(range(1, n_kf))
    assert [r.frame for r in kf] == slam.map.kf_frame_id[1:n_kf].tolist()
    closed = [r for r in recs if r.loop_closed_with >= 0]
    loops = [loop for _, loop in slam.loop_edges]
    assert len(closed) >= len(loops) - 1 >= 0
    assert [r.loop_closed_with for r in closed] == loops[:len(closed)]
    assert all(r.keyframe_id >= 0 for r in closed)
